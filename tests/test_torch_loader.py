"""The port's token loader: the native gather (``csrc/tokenloader.cpp``,
built here with ``g++``) and the numpy path against the JAX package's
``TokenDataset``, sharded sampling, bounds, and ``close()`` while a
producer is inside the native gather."""

import logging
import threading

import numpy as np
import pytest

from k8s_operator_libs_tpu.data import loader as jloader
from k8s_operator_libs_tpu_torch.data import loader as tloader

FILES = [(512, True), (70000, True), (70000, False)]   # (vocab, header)


def _token_file(tmp_path, vocab, header):
    toks = np.random.default_rng(vocab).integers(0, vocab, size=6000)
    path = tmp_path / "tokens.bin"
    if header:
        tloader.write_token_file(str(path), toks)
    else:                                        # raw int32, no header
        toks.astype(np.int32).tofile(path)
    return str(path)


@pytest.mark.parametrize("shard", [None, (1, 3)])
@pytest.mark.parametrize("vocab,header", FILES)
def test_native_numpy_and_jax_batches_are_identical(tmp_path, vocab, header,
                                                    shard):
    path = _token_file(tmp_path, vocab, header)
    native = tloader.TokenDataset(path, native=True)
    plain = tloader.TokenDataset(path, native=False)
    ref = jloader.TokenDataset(path, native=False)
    assert native.native and not plain.native
    try:
        assert native.num_tokens == plain.num_tokens == ref.num_tokens \
            == 6000
        assert native.elem_size == ref.elem_size == (2 if vocab < 2 ** 16
                                                      else 4)
        for step in (0, 3, 41):
            want = ref.sample_at(5, 33, 7, step, shard)
            for ds in (native, plain):
                np.testing.assert_array_equal(
                    ds.sample_at(5, 33, 7, step, shard), want)
        want = ref.sample(4, 17, np.random.default_rng(2), shard)
        for ds in (native, plain):
            np.testing.assert_array_equal(
                ds.sample(4, 17, np.random.default_rng(2), shard), want)
        streams = [ds.batches(2, 65, seed=9, start_step=5, shard=shard)
                   for ds in (native, plain)]
        ref_stream = ref.batches(2, 65, seed=9, start_step=5, shard=shard)
        for _ in range(3):
            want = next(ref_stream)
            for s in streams:
                np.testing.assert_array_equal(next(s), want)
        for s in streams + [ref_stream]:
            s.close()
    finally:
        for ds in (native, plain, ref):
            ds.close()


@pytest.mark.parametrize("native", [True, False])
def test_out_of_range_offsets_raise(tmp_path, native):
    ds = tloader.TokenDataset(_token_file(tmp_path, 512, True), native=native)
    try:
        for off in (-1, ds.num_tokens - 3):
            with pytest.raises(IndexError):
                ds.gather(np.array([0, off]), 4)
        np.testing.assert_array_equal(ds.gather(np.array([10]), 4)[0],
                                      ds.gather(np.array([10, 11]), 4)[0])
    finally:
        ds.close()
    with pytest.raises(ValueError, match="closed"):
        ds.gather(np.zeros(1), 4)


def test_native_true_raises_and_none_falls_back(tmp_path, monkeypatch,
                                                caplog):
    path = _token_file(tmp_path, 512, True)

    def broken():
        raise RuntimeError("g++ failed to build tokenloader.cpp")

    monkeypatch.setattr(tloader, "load_native", broken)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        tloader.TokenDataset(path, native=True)
    with caplog.at_level(logging.WARNING, logger=tloader.__name__):
        ds = tloader.TokenDataset(path)
    assert not ds.native and "using numpy" in caplog.text
    ds.close()


def test_close_ends_a_live_native_stream(tmp_path):
    ds = tloader.TokenDataset(_token_file(tmp_path, 512, True), native=True)
    stream = ds.batches(4, 129, seed=1)
    first = next(stream)
    assert first.shape == (4, 129)
    ds.close()
    assert ds._handle is None                 # freed: no producer left
    with pytest.raises((RuntimeError, StopIteration)):
        for _ in range(10):
            next(stream)


class _HeldLibrary:
    """The native library with ``tl_fill_batch`` held at its entry until
    released, and ``tl_close`` counted."""

    def __init__(self, lib):
        self._lib = lib
        self.entered = threading.Event()
        self.release = threading.Event()
        self.closed = 0

    def __getattr__(self, name):
        return getattr(self._lib, name)

    def tl_fill_batch(self, *args):
        self.entered.set()
        self.release.wait(30)
        return self._lib.tl_fill_batch(*args)

    def tl_close(self, handle):
        self.closed += 1
        self._lib.tl_close(handle)


def test_close_leaks_the_mapping_under_a_producer_inside_the_gather(
        tmp_path):
    """The hazard the port's first loader had (its close() dropped the
    mapping after a timed join): a producer still inside the native
    gather when close() gives up waiting keeps the mapping, which is
    leaked, never freed under it; the producer then finishes safely."""
    ds = tloader.TokenDataset(_token_file(tmp_path, 512, True), native=True)
    held = ds._lib = _HeldLibrary(ds._lib)
    ds.close_grace_s = 0.2
    stream = ds.batches(2, 65, seed=3)
    seen = []

    def consume():
        try:
            next(stream)
        except RuntimeError as exc:
            seen.append(str(exc))

    consumer = threading.Thread(target=consume, daemon=True)
    consumer.start()
    assert held.entered.wait(10)
    producers = [t for _, t in ds._streams]
    ds.close()
    assert held.closed == 0 and ds._handle is not None
    held.release.set()                        # the gather completes
    for t in producers + [consumer]:
        t.join(10)
        assert not t.is_alive()
    assert held.closed == 0 and seen == [
        "token stream stopped (TokenDataset.close())"]
    held._lib.tl_close(ds._handle)            # the test's own cleanup
