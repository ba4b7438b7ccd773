"""Where the port's native sources live and where their builds go.

The CUDA kernels (``ops/build.py``) and the token loader's C++ reader
(``data/loader.py``) both compile from ``csrc/`` inside the package into
``build/torch_kernels/`` beside it (a directory ``.gitignore`` lists).
"""

from __future__ import annotations

from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "torch_kernels"
