"""Token dataset: batched windows over a token file, gathered by a native
library or numpy, with a prefetch thread.

Port of the JAX package's ``data/loader.py``. The native gather
(``csrc/tokenloader.cpp``, a copy of the reference's) memory-maps the
file and copies [batch, seq] int32 windows in one C loop, with no
per-sequence Python slicing and the interpreter lock released; it is
built with ``g++ -O3 -shared -fPIC`` at first use into the port's build
directory (``utils/paths.py:BUILD_DIR``, the file named by a hash of the
source) and loaded with ``ctypes``. The numpy path gives the same
batches. The file format and the sampling are the reference's, so the
same file, seed, step and shard give the same batch as the JAX
``TokenDataset``: that is what lets a resumed job, or a rank that joins
an elastic job, continue the very data stream it left.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import queue
import subprocess
from typing import Iterator, List, Optional, Tuple

import numpy as np

from ..utils import threads
from ..utils.paths import BUILD_DIR, CSRC_DIR

logger = logging.getLogger(__name__)

MAGIC = b"TOKS"
HEADER_BYTES = 8
PREFETCH = 2             # batches the producer thread keeps ready
CXX_FLAGS = ("-O3", "-shared", "-fPIC")

_lib_lock = threads.make_lock("tokenloader-native-compile")
_lib: Optional[ctypes.CDLL] = None


def _native_library_path():
    src = CSRC_DIR / "tokenloader.cpp"
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(CXX_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"libtokenloader-{digest[:16]}.so"


def load_native() -> ctypes.CDLL:
    """The native gather library, built on first use (once per process;
    processes that build it at once each write their own temporary file
    and publish it with an atomic rename). Raises when ``g++`` or the
    load fails."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        out = _native_library_path()
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            # building under the lock is the point: every other thread
            # waits for the library instead of racing the compiler
            proc = subprocess.run(  # lint: ignore
                ["g++", *CXX_FLAGS, "-o", str(tmp),
                 str(CSRC_DIR / "tokenloader.cpp")],
                capture_output=True, text=True)
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(f"g++ failed to build tokenloader.cpp "
                                   f"(exit {proc.returncode}):\n"
                                   f"{proc.stderr}")
            os.replace(tmp, out)
        lib = ctypes.CDLL(str(out))
        lib.tl_open.restype = ctypes.c_void_p
        lib.tl_open.argtypes = [ctypes.c_char_p, ctypes.c_int]
        lib.tl_num_tokens.restype = ctypes.c_long
        lib.tl_num_tokens.argtypes = [ctypes.c_void_p]
        lib.tl_fill_batch.restype = ctypes.c_int
        lib.tl_fill_batch.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_long), ctypes.c_int,
            ctypes.c_int, ctypes.POINTER(ctypes.c_int32)]
        lib.tl_close.restype = None
        lib.tl_close.argtypes = [ctypes.c_void_p]
        _lib = lib
        return lib


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

    ``sample_at(batch, seq, seed, step, shard)`` is a pure function of its
    arguments; ``batches(...)`` yields it for step, step + 1, ... from a
    prefetch thread. ``shard=(i, n)`` gives data-parallel rank i of n its
    own interleaved offsets.

    ``native``: None uses the native gather where it builds and numpy
    (with a warning) where it does not; True raises if it does not build;
    False uses numpy.
    """

    close_grace_s = 5.0      # how long close() waits for each producer

    def __init__(self, path: str, native: Optional[bool] = None):
        self.path = path
        self._lib = None
        if native is not False:
            try:
                self._lib = load_native()
            except (RuntimeError, OSError) as exc:
                if native:
                    raise
                logger.warning("native tokenloader unavailable (%s); "
                               "using numpy", exc)
        elem = _read_header(path)
        self.elem_size = elem or 4
        self._handle = None
        self._mm = None
        if self._lib is not None:
            # the native side reads the header itself
            self._handle = self._lib.tl_open(path.encode(), self.elem_size)
            if not self._handle:
                raise OSError(f"tl_open failed for {path}")
            self.num_tokens = int(self._lib.tl_num_tokens(self._handle))
        else:
            self._mm = np.memmap(path, mode="r",
                                 dtype=np.uint16 if elem == 2 else np.int32,
                                 offset=HEADER_BYTES if elem else 0)
            self.num_tokens = int(self._mm.shape[0])
        self._closed = False
        self._streams_lock = threads.make_lock("tokenloader-streams")
        self._streams: List[Tuple[object, object]] = []  # (stop, thread)

    @property
    def native(self) -> bool:
        return self._lib is not None

    def close(self) -> None:
        """Stop every prefetch producer first, then free the native
        handle: a producer inside ``tl_fill_batch`` must never see a freed
        mapping. A producer that does not stop within ``close_grace_s``
        keeps the handle, which is leaked rather than freed under it.
        Consumers of a stopped stream raise instead of hanging."""
        self._closed = True
        with self._streams_lock:
            streams, self._streams = self._streams, []
        for stop, _ in streams:
            stop.set()
        stuck = []
        for _, t in streams:
            t.join(timeout=self.close_grace_s)
            if t.is_alive():
                stuck.append(t.name)
        if stuck:
            logger.error("prefetch producers %s still running after "
                         "close(); leaking the token mapping rather than "
                         "freeing it under them", stuck)
            return
        if self._handle:
            self._lib.tl_close(self._handle)
            self._handle = None

    def gather(self, offsets: np.ndarray, seqlen: int) -> np.ndarray:
        """out[b] = tokens[offsets[b]:offsets[b] + seqlen], int32."""
        offsets = np.ascontiguousarray(offsets, dtype=np.int64)
        out = np.empty((offsets.shape[0], seqlen), dtype=np.int32)
        if self._closed:
            raise ValueError(f"TokenDataset({self.path}) is closed")
        if self._lib is not None:
            rc = self._lib.tl_fill_batch(
                self._handle,
                offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_long)),
                offsets.shape[0], seqlen,
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
            if rc != 0:
                raise IndexError("offset out of range in tl_fill_batch")
            return out
        for b, off in enumerate(offsets):
            if off < 0 or off + seqlen > self.num_tokens:
                raise IndexError("offset out of range")
            out[b] = self._mm[off:off + seqlen]
        return out

    def sample(self, batch: int, seqlen: int, rng: np.random.Generator,
               shard: Optional[Tuple[int, int]] = None) -> np.ndarray:
        """``batch`` windows at offsets drawn from ``rng``; with
        ``shard=(i, n)`` each offset is moved to the nearest one at or
        below it that is i mod n (clipped into the file)."""
        hi = self.num_tokens - seqlen
        if hi <= 0:
            raise ValueError("file shorter than one sequence")
        offsets = rng.integers(0, hi + 1, size=batch)
        if shard is not None:
            i, n = shard
            offsets = np.clip(offsets - offsets % n + i, 0, hi)
        return self.gather(offsets, seqlen)

    def sample_at(self, batch: int, seqlen: int, seed: int, step: int,
                  shard: Optional[Tuple[int, int]] = None) -> np.ndarray:
        """Batch ``step`` of stream ``seed``: a pure function of both, so
        a job resumed at step k continues with batch k."""
        return self.sample(batch, seqlen, np.random.default_rng([seed, step]),
                           shard)

    def batches(self, batch: int, seqlen: int, seed: int = 0,
                start_step: int = 0,
                shard: Optional[Tuple[int, int]] = None
                ) -> Iterator[np.ndarray]:
        """Endless batches ``sample_at(..., start_step + i, shard)``,
        produced PREFETCH ahead by a thread. A producer's exception (any
        ``BaseException``) is raised to the consumer as the cause of its
        RuntimeError; closing the dataset ends the stream."""
        q: "queue.Queue" = queue.Queue(maxsize=PREFETCH)
        stop = threads.make_event("tokenloader-prefetch-stop")

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
                    item = self.sample_at(batch, seqlen, seed, step, shard)
                except BaseException as exc:  # exc: allow — forwarded to the consumer queue, then exit; dying silently would hang every reader
                    put(_ProducerDied(exc))
                    return
                step += 1
                put(item)

        t = threads.spawn(f"tokenloader-prefetch-{id(q):x}", producer,
                          start=False)
        with self._streams_lock:
            self._streams.append((stop, t))
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
            try:         # a producer blocked in put() wakes at once
                while True:
                    q.get_nowait()
            except queue.Empty:
                pass
            t.join(timeout=self.close_grace_s)
            with self._streams_lock:
                if (stop, t) in self._streams:
                    self._streams.remove((stop, t))
