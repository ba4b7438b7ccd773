"""Builds the port's CUDA sources into shared libraries and loads them.

Each ``csrc/*.cu`` file has a plain C interface and is compiled by
``nvcc`` for ``sm_90a`` at first use (or all at once, by
:func:`build_all`) into ``build/torch_kernels/`` beside the package (a
directory ``.gitignore`` lists), then loaded with ``ctypes``.
The library's file name carries a hash of the source and the flags, so an
edited source is rebuilt and never served stale.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Sequence, Tuple

from ..utils import threads
from ..utils.paths import BUILD_DIR, CSRC_DIR

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threads.make_lock("kernel-build")
_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    candidates = []
    for env in ("CUDA_HOME", "CUDA_PATH"):
        if os.environ.get(env):
            candidates.append(os.path.join(os.environ[env], "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        candidates.append(found)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for path in candidates:
        if os.path.isfile(path) and os.access(path, os.X_OK):
            return path
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the port's CUDA kernels are built from source")


def library_path(name: str) -> Path:
    src = CSRC_DIR / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build_all(names: Sequence[str]) -> Dict[str, Tuple[Path, float, str]]:
    """Compile each ``csrc/<name>.cu`` whose library is not built yet, one
    ``nvcc`` per source, all started together. Returns, per name, (library
    path, build seconds, compiler log); a library already built is reused
    with 0 seconds and an empty log."""
    done: Dict[str, Tuple[Path, float, str]] = {}
    running = {}
    t0 = time.monotonic()  # det: allow — times a real nvcc build
    for name in names:
        out = library_path(name)
        if out.exists():
            done[name] = (out, 0.0, "")
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.Popen([nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
                                 str(CSRC_DIR / f"{name}.cu")],
                                stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running[name] = (out, tmp, proc)
    failed = []
    for name, (out, tmp, proc) in running.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"nvcc failed to build {name}.cu "
                          f"(exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)      # atomic: a reader never sees half a file
        done[name] = (out, time.monotonic() - t0, log)  # det: allow — times a real nvcc build
    if failed:
        raise RuntimeError("\n".join(failed))
    return {name: done[name] for name in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            # one lock across nvcc is the point (LCK004 hatch): a second
            # thread waits for the library instead of building it into
            # the same temporary file
            path, _, _ = build_all([name])[name]  # lint: ignore
            lib = _loaded[name] = ctypes.CDLL(str(path))
        return lib
