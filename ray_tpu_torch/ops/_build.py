"""Build the port's CUDA kernels at first use and load them with ctypes.

Each ``ray_tpu_torch/csrc/<name>.cu`` compiles with ``nvcc`` for Hopper
(``sm_90a``) into a shared library with a plain C interface, under
``ray_tpu_torch/_build/`` (git-ignored).  The library's file name carries
a hash of its source and of every header in ``csrc/`` (``*.cuh``), so a
library is rebuilt only when its source or a header changes, and a stale
one is never loaded.  ``build`` compiles several
sources at once, one nvcc each.  Building needs the CUDA toolkit;
nothing here runs when the module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Dict

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}
# name -> (seconds the nvcc run took, or 0.0 when the library was
# already built; nvcc's output, including -Xptxas -v register counts)
build_log: Dict[str, tuple] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("CUDA toolkit not found: the port's kernels are "
                           "built with nvcc at first use")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def library_path(name: str) -> Path:
    """The library of ``csrc/<name>.cu``, named by a hash of that source
    and of every ``csrc/*.cuh`` header (names and contents)."""
    h = hashlib.sha256((SRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(SRC_DIR.glob("*.cuh")):
        h.update(header.name.encode())
        h.update(header.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names) -> None:
    """Build every library of ``names`` whose source changed since its
    last build: one nvcc process per source, all started together."""
    with _lock:
        procs = {}
        for name in names:
            if name in _loaded:
                continue
            so = library_path(name)
            if so.exists():
                build_log.setdefault(name, (0.0, ""))
                continue
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            # build under a temporary name, then rename: a concurrent or
            # interrupted build never leaves a half-written library
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            procs[name] = (so, tmp, time.perf_counter(), subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-o", tmp,
                 str(SRC_DIR / f"{name}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        failed = []
        for name, (so, tmp, t0, proc) in procs.items():
            out, _ = proc.communicate()
            build_log[name] = (time.perf_counter() - t0, out)
            if proc.returncode == 0:
                os.replace(tmp, so)
            else:
                failed.append(f"nvcc failed to build {name}.cu:\n{out}")
            if os.path.exists(tmp):
                os.unlink(tmp)
        if failed:
            raise RuntimeError("\n".join(failed))


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<name>.cu``, building it if
    its source changed since the last build."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    build([name])
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = _loaded[name] = ctypes.CDLL(str(library_path(name)))
        return lib
