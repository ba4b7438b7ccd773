"""Token dataset: batched windows over a token file, with a prefetch
thread.

Port of the JAX package's ``data/loader.py`` (numpy path only: the
reference's native gather, ``csrc/tokenloader.cpp``, is a host library
that a later slice ports). The file format and the sampling are the
reference's, so the same file, seed and step give the same batch as the
JAX ``TokenDataset``: that is what lets a resumed job continue the very
data stream it left.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, List, Optional

import numpy as np

MAGIC = b"TOKS"
HEADER_BYTES = 8
PREFETCH = 2             # batches the producer thread keeps ready


def write_token_file(path: str, tokens: np.ndarray) -> None:
    """Write the loader's format: 'TOKS' + uint32 elem_size header, then raw
    tokens (uint16 when the vocab fits, else int32)."""
    tokens = np.asarray(tokens)
    dtype = np.uint16 if tokens.max(initial=0) < 2 ** 16 else np.int32
    with open(path, "wb") as f:
        f.write(MAGIC)
        f.write(np.uint32(np.dtype(dtype).itemsize).tobytes())
        tokens.astype(dtype).tofile(f)


def _read_header(path: str) -> Optional[int]:
    """The element size a headered file declares, or None for a raw
    (headerless, int32) file."""
    with open(path, "rb") as f:
        head = f.read(HEADER_BYTES)
    if len(head) == HEADER_BYTES and head[:4] == MAGIC:
        elem = int(np.frombuffer(head[4:], dtype=np.uint32)[0])
        if elem in (2, 4):
            return elem
    return None


class _ProducerDied:
    """Queue item carrying a prefetch producer's exception."""

    def __init__(self, exc: BaseException):
        self.exc = exc


class TokenDataset:
    """Batched sampler over a token file.

    ``sample_at(batch, seq, seed, step)`` is a pure function of (seed,
    step); ``batches(...)`` yields it for step, step + 1, ... from a
    prefetch thread. (The reference's ``shard=(i, n)`` for data
    parallelism waits for the multi-GPU slice.)
    """

    def __init__(self, path: str):
        self.path = path
        elem = _read_header(path)
        self.elem_size = elem or 4
        self._mm = np.memmap(path, dtype=np.uint16 if elem == 2 else np.int32,
                             mode="r", offset=HEADER_BYTES if elem else 0)
        self.num_tokens = int(self._mm.shape[0])
        self._closed = False
        self._stops: List[threading.Event] = []
        self._threads: List[threading.Thread] = []

    def close(self) -> None:
        """Stop every prefetch thread, then drop the file mapping."""
        self._closed = True
        for stop in self._stops:
            stop.set()
        for t in self._threads:
            t.join(timeout=5.0)
        self._mm = None

    def gather(self, offsets: np.ndarray, seqlen: int) -> np.ndarray:
        """out[b] = tokens[offsets[b]:offsets[b] + seqlen], int32."""
        if self._closed:
            raise ValueError(f"TokenDataset({self.path}) is closed")
        offsets = np.asarray(offsets, dtype=np.int64)
        out = np.empty((offsets.shape[0], seqlen), dtype=np.int32)
        for b, off in enumerate(offsets):
            if off < 0 or off + seqlen > self.num_tokens:
                raise IndexError("offset out of range")
            out[b] = self._mm[off:off + seqlen]
        return out

    def sample_at(self, batch: int, seqlen: int, seed: int,
                  step: int) -> np.ndarray:
        """Batch ``step`` of stream ``seed``: a pure function of both, so
        a job resumed at step k continues with batch k."""
        hi = self.num_tokens - seqlen
        if hi <= 0:
            raise ValueError("file shorter than one sequence")
        rng = np.random.default_rng([seed, step])
        return self.gather(rng.integers(0, hi + 1, size=batch), seqlen)

    def batches(self, batch: int, seqlen: int, seed: int = 0,
                start_step: int = 0) -> Iterator[np.ndarray]:
        """Endless batches ``sample_at(..., start_step + i)``, produced
        PREFETCH ahead by a thread. A producer's exception is raised to
        the consumer; closing the dataset ends the stream."""
        q: "queue.Queue" = queue.Queue(maxsize=PREFETCH)
        stop = threading.Event()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            step = start_step
            while not stop.is_set():
                try:
                    item = self.sample_at(batch, seqlen, seed, step)
                except Exception as exc:  # handed to the consumer below
                    put(_ProducerDied(exc))
                    return
                step += 1
                put(item)

        t = threading.Thread(target=producer, daemon=True,
                             name="tokenloader-prefetch")
        self._stops.append(stop)
        self._threads.append(t)
        t.start()
        try:
            while True:
                try:
                    item = q.get(timeout=0.5)
                except queue.Empty:
                    if stop.is_set():
                        raise RuntimeError("token stream stopped "
                                           "(TokenDataset.close())")
                    if not t.is_alive():
                        raise RuntimeError("token prefetch thread exited "
                                           "without a result")
                    continue
                if isinstance(item, _ProducerDied):
                    raise RuntimeError("token prefetch failed") from item.exc
                yield item
        finally:
            stop.set()
            t.join(timeout=5.0)
