"""The port's threads, locks and events carry the JAX package's names.

The port makes every thread, lock and event of its runtime through its
``utils/threads.py`` shim, under the name the reference gives the same
primitive, so that ``threads.live_threads(prefix)`` finds a leaked
stepper, uploader or prefetch thread by name and ``threads.held_locks()``
says which named locks a thread holds. Each component below is started
and stopped at the tiny configuration on the CPU under a recording
backend: while it runs, its threads are live under the reference's names
and its locks are held under them; after its stop none is left. A static
test holds the names at each site to the reference's, and another finds
no raw ``threading`` primitive in the package outside the shim (the lint
suite's THR001 guards the same closure).
"""

import ast
import threading
from pathlib import Path

import numpy as np
import pytest

# imported before any test installs its recording backend: a module's own
# primitives (the loader's and the kernel build's locks) are made at import
from k8s_operator_libs_tpu_torch import server
from k8s_operator_libs_tpu_torch.data import loader
from k8s_operator_libs_tpu_torch.models.llama import LlamaConfig, init_params
from k8s_operator_libs_tpu_torch.obs import trace
from k8s_operator_libs_tpu_torch.obs.metrics import MetricsHub
from k8s_operator_libs_tpu_torch.ops import build
from k8s_operator_libs_tpu_torch.train.uploader import CheckpointUploader
from k8s_operator_libs_tpu_torch.utils import threads
from k8s_operator_libs_tpu_torch.utils.clock import FakeClock

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "k8s_operator_libs_tpu_torch"


class _SpyLock(threads._NamedLock):
    """A named lock that logs (thread, its name, the held stack) at each
    acquisition."""

    __slots__ = ("_log",)

    def __init__(self, name, log):
        super().__init__(name, threading.Lock())
        self._log = log

    def acquire(self, blocking=True, timeout=-1):
        ok = super().acquire(blocking, timeout)
        if ok:
            self._log.append((threading.current_thread().name, self.name,
                              tuple(lk.name for lk in threads.held_locks())))
        return ok


class Recorder(threads.RealBackend):
    """The stdlib backend, recording what it makes, (kind, name), in
    ``made``, and each acquisition of the locks it made in ``held``."""

    def __init__(self):
        self.made = []
        self.held = []

    def thread(self, name, target, args, kwargs, daemon):
        self.made.append(("thread", name))
        return super().thread(name, target, args, kwargs, daemon)

    def lock(self, name):
        self.made.append(("lock", name))
        return _SpyLock(name, self.held)

    def event(self, name):
        self.made.append(("event", name))
        return super().event(name)

    def held_by(self, thread_name):
        """The lock names ``thread_name`` acquired."""
        return {lock for t, lock, _ in self.held if t == thread_name}


class _Stop(Exception):
    pass


@pytest.fixture()
def recorder():
    rec = Recorder()
    with threads.use_backend(rec):
        yield rec
    assert threads.held_locks() == ()


@pytest.fixture(autouse=True)
def _few_torch_threads():
    import torch
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def test_uploader_names_its_thread_and_events(recorder, tmp_path):
    """``train/uploader.py``: ``ckpt-uploader-stop``,
    ``ckpt-uploader-idle`` and the ``ckpt-uploader`` thread, a daemon."""
    local = tmp_path / "local"
    (local / "1").mkdir(parents=True)
    (local / "1" / "w.bin").write_text("x" * 16)
    up = CheckpointUploader(str(local), str(tmp_path / "durable"),
                            poll_seconds=0.01).start()
    try:
        live = threads.live_threads("ckpt-uploader")
        assert [t.name for t in live] == ["ckpt-uploader"]
        assert live[0].daemon
        assert up.wait_idle(timeout=60.0)
    finally:
        up.stop()
    assert recorder.made == [("event", "ckpt-uploader-stop"),
                             ("event", "ckpt-uploader-idle"),
                             ("thread", "ckpt-uploader")]
    assert threads.live_threads("ckpt-uploader") == []
    assert (tmp_path / "durable" / "1" / "w.bin").exists()


def _tiny_params():
    import torch
    cfg = LlamaConfig.tiny(dtype=torch.float32)
    return init_params(cfg, seed=0, device="cpu"), cfg


def test_serving_runtime_names_its_stepper_lock_and_events(recorder):
    """``server.py``'s ``ServingRuntime``: the ``serve-runtime`` lock,
    held by the ``serve-stepper`` thread while it steps, the
    ``serve-stepper-stop`` event and one ``serve-result-<rid>`` event per
    request; after ``stop()`` no stepper is left."""
    params, cfg = _tiny_params()
    rt = server.ServingRuntime(params, cfg, max_slots=2, capacity=64,
                               block_size=8, chunk=4)
    try:
        live = threads.live_threads("serve-stepper")
        assert [t.name for t in live] == ["serve-stepper"] and live[0].daemon
        rid, ev = rt.submit([1, 2, 3, 4], 4)
        assert ev.wait(120.0)
        assert rt.result(rid)[:4] == [1, 2, 3, 4]
    finally:
        rt.stop()
    made = set(recorder.made)
    assert {("lock", "serve-runtime"), ("event", "serve-stepper-stop"),
            ("thread", "serve-stepper"),
            ("event", f"serve-result-{rid}")} <= made
    assert "serve-runtime" in recorder.held_by("serve-stepper")
    assert threads.live_threads("serve-") == []


def test_server_sigterm_drain_thread_is_named(recorder, monkeypatch):
    """``server.py``'s SIGTERM handler drains in the ``serve-drain``
    thread; once ``main`` returns, neither it nor the stepper is left."""
    import signal
    handlers = {}
    monkeypatch.setattr(signal, "signal",
                        lambda sig, fn: handlers.__setitem__(sig, fn))
    rcs = []
    runner = threading.Thread(target=lambda: rcs.append(server.main(
        ["--model", "tiny", "--device", "cpu", "--host", "127.0.0.1",
         "--port", "0", "--max-slots", "2", "--capacity", "64",
         "--block-size", "8", "--grace", "1"])), daemon=True)
    runner.start()
    for _ in range(1200):
        if signal.SIGTERM in handlers and threads.live_threads(
                "serve-stepper"):
            break
        runner.join(0.05)
    assert signal.SIGTERM in handlers, "the server never came up"
    handlers[signal.SIGTERM](signal.SIGTERM, None)
    runner.join(60.0)
    assert rcs == [0]
    assert ("thread", "serve-drain") in recorder.made
    assert threads.join_all("serve-drain", timeout=10.0) == []
    assert threads.live_threads("serve-") == []


def test_token_loader_names_its_locks_event_and_prefetch_thread(
        recorder, tmp_path):
    """``data/loader.py``: the ``tokenloader-streams`` lock, the
    ``tokenloader-prefetch-stop`` event and a daemon
    ``tokenloader-prefetch-<id>`` thread, none left after ``close()``."""
    path = str(tmp_path / "tokens.bin")
    loader.write_token_file(path, np.arange(2048) % 500)
    ds = loader.TokenDataset(path, native=False)
    stream = ds.batches(2, 8, seed=0)
    try:
        assert next(stream).shape == (2, 8)
        live = threads.live_threads("tokenloader-prefetch")
        assert len(live) == 1 and live[0].daemon
        name = live[0].name
        assert name.startswith("tokenloader-prefetch-")
    finally:
        ds.close()
        stream.close()
    assert [m for m in recorder.made if m[1].startswith("tokenloader")] == [
        ("lock", "tokenloader-streams"),
        ("event", "tokenloader-prefetch-stop"), ("thread", name)]
    assert "tokenloader-streams" in recorder.held_by(
        threading.current_thread().name)
    assert threads.live_threads("tokenloader-") == []


def test_token_loader_compile_lock_is_named(monkeypatch):
    """The module's ``tokenloader-native-compile`` lock is held while the
    native library is found or built, and released after."""
    seen = []

    def path():
        seen.append([lk.name for lk in threads.held_locks()])
        raise _Stop()

    monkeypatch.setattr(loader, "_lib", None)
    monkeypatch.setattr(loader, "_native_library_path", path)
    with pytest.raises(_Stop):
        loader.load_native()
    assert seen == [["tokenloader-native-compile"]]
    assert threads.held_locks() == ()


def test_kernel_build_lock_is_named(monkeypatch):
    """``ops/build.py``: the ``kernel-build`` lock is held while a
    kernel's library is built, and released after."""
    seen = []

    def build_all(names):
        seen.append([lk.name for lk in threads.held_locks()])
        raise _Stop()

    monkeypatch.setattr(build, "_loaded", {})
    monkeypatch.setattr(build, "build_all", build_all)
    with pytest.raises(_Stop):
        build.load("paged_decode")
    assert seen == [["kernel-build"]]
    assert threads.held_locks() == ()


def test_metrics_hub_lock_is_named(recorder):
    """``obs/metrics.py``: the ``metrics-hub`` lock, held by a writer
    thread while it records."""
    hub = MetricsHub()

    def write():
        hub.observe("serve_ttft_seconds", 0.2)
        hub.set_gauge("serve_slots_busy", 1.0)

    writer = threads.spawn("metrics-writer", write)
    writer.join(10.0)
    assert not writer.is_alive()
    assert ("lock", "metrics-hub") in recorder.made
    assert recorder.held_by("metrics-writer") == {"metrics-hub"}
    assert "serve_ttft_seconds" in hub.render()
    assert threads.live_threads("metrics-writer") == []


def test_fake_clock_lock_is_named(recorder):
    """``utils/clock.py``: the ``FakeClock``'s ``fake-clock`` lock."""
    clock = FakeClock(10.0)
    sleeper = threads.spawn("clock-sleeper", clock.sleep, args=(5.0,))
    sleeper.join(10.0)
    assert not sleeper.is_alive() and clock.now() == 15.0
    assert recorder.made[:2] == [("lock", "fake-clock"),
                                 ("thread", "clock-sleeper")]
    assert recorder.held_by("clock-sleeper") == {"fake-clock"}


@pytest.mark.parametrize("kind, name", [("list", "trace-list-sink"),
                                        ("jsonl", "trace-jsonl-sink")])
def test_trace_sink_lock_is_named(recorder, tmp_path, kind, name):
    """``obs/trace.py``: the ``ListSink``'s ``trace-list-sink`` and the
    ``JsonlSink``'s ``trace-jsonl-sink`` lock, on the shim's held-lock
    stack while a writer thread emits a span through the sink."""
    sink = (trace.ListSink() if kind == "list"
            else trace.JsonlSink(str(tmp_path / "spans.jsonl")))
    tracer = trace.Tracer(sink, clock=FakeClock(5.0))

    def write():
        with tracer.span("serve-step", chunk=4):
            pass

    writer = threads.spawn("trace-writer", write)
    writer.join(10.0)
    assert not writer.is_alive()
    if kind == "jsonl":
        sink.close()
    assert ("lock", name) in recorder.made
    assert [stack for t, lock, stack in recorder.held
            if t == "trace-writer" and lock == name] == [(name,)]
    assert threads.live_threads("trace-writer") == []


def _shim_names(path):
    """The name expressions passed to the shim's constructors in
    ``path``, in source order."""
    names = []
    for node in ast.walk(ast.parse(path.read_text())):
        if (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and isinstance(node.func.value, ast.Name)
                and node.func.value.id == "threads"
                and node.func.attr in ("spawn", "make_lock", "make_rlock",
                                       "make_event", "make_condition")):
            names.append((node.lineno, node.func.attr,
                          ast.unparse(node.args[0])))
    return [n[1:] for n in sorted(names)]


@pytest.mark.parametrize("port, reference", [
    ("train/uploader.py", "k8s_operator_libs_tpu/train/uploader.py"),
    ("server.py", "cmd/serve.py"),
    ("data/loader.py", "k8s_operator_libs_tpu/data/loader.py"),
    ("obs/metrics.py", "k8s_operator_libs_tpu/obs/metrics.py"),
    ("utils/clock.py", "k8s_operator_libs_tpu/utils/clock.py"),
    ("obs/trace.py", "k8s_operator_libs_tpu/obs/trace.py"),
])
def test_shim_names_equal_the_reference_sites(port, reference):
    """Every thread, lock and event the module makes, with its name, in
    the order the reference's twin makes them."""
    got = _shim_names(PORT / port)
    assert got, f"{port} makes nothing through the shim"
    assert got == _shim_names(REPO / reference)


RAW = {"Thread", "Lock", "RLock", "Event", "Condition", "Timer"}
ALLOWED = {"utils/threads.py"}


def test_no_raw_threading_primitive_outside_the_shim():
    """No module of the port makes a ``threading`` Thread, Lock, RLock,
    Event, Condition or Timer (or subclasses one) except the shim
    itself."""
    found = []
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(PORT).as_posix()
        if rel in ALLOWED:
            continue
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.ImportFrom) and node.module == "threading":
                found += [f"{rel}:{node.lineno} from threading import "
                          f"{a.name}" for a in node.names if a.name in RAW]
            targets = []
            if isinstance(node, ast.Call):
                targets = [node.func]
            elif isinstance(node, ast.ClassDef):
                targets = node.bases
            for t in targets:
                if (isinstance(t, ast.Attribute) and t.attr in RAW
                        and isinstance(t.value, ast.Name)
                        and t.value.id == "threading"):
                    found.append(f"{rel}:{t.lineno} threading.{t.attr}")
    assert found == []
