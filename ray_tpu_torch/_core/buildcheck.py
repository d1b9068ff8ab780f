"""Build the port's native runtime libraries at first use.

``ray_tpu_torch/csrc/shmstore.cc`` (the shared-memory object store) and
``ray_tpu_torch/csrc/scheduler.cc`` (the cluster scheduler) compile with
``g++`` into ``ray_tpu_torch/_build/`` (git-ignored), with the flags of
``csrc/Makefile``.  A library's file name carries a hash of its source and
of the compile command, so a library is rebuilt only when either changes
and a stale one is never loaded (the scheme of ``ops/_build.py`` for the
CUDA kernels).  The port ships no prebuilt binary and never writes into
``ray_tpu/_core/``.

Several processes of one cluster (the GCS, the raylet, every worker) may
ask for a library at once: a file lock in the build directory serialises
the builds across processes, and each build writes a temporary file that
is renamed into place, so no process ever loads a half-written library.
"""

from __future__ import annotations

import fcntl
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
CXX = "g++"
CXXFLAGS = ("-O2", "-fPIC", "-Wall", "-Wextra", "-std=c++17", "-shared",
            "-pthread")

_lock = threading.Lock()


def library_path(name: str) -> Path:
    """Where the library of ``csrc/<name>.cc`` lives once built."""
    h = hashlib.sha256((SRC_DIR / f"{name}.cc").read_bytes())
    h.update(" ".join((CXX,) + CXXFLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def ensure_built(name: str) -> str:
    """The path of the built library of ``csrc/<name>.cc``, building it
    first if its source or flags changed since the last build.  Raises
    ``RuntimeError`` with the compiler's output when the build fails."""
    so = library_path(name)
    if so.exists():
        return str(so)
    with _lock:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        with open(BUILD_DIR / ".native_build_lock", "w") as lockf:
            fcntl.flock(lockf, fcntl.LOCK_EX)
            # another process may have built it while we waited
            if so.exists():
                return str(so)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            try:
                proc = subprocess.run(
                    [CXX, *CXXFLAGS, "-o", tmp, str(SRC_DIR / f"{name}.cc")],
                    capture_output=True, text=True, timeout=600)
                if proc.returncode != 0:
                    raise RuntimeError(f"{CXX} failed to build {name}.cc:\n"
                                       f"{proc.stdout}{proc.stderr}")
                os.replace(tmp, so)
            finally:
                if os.path.exists(tmp):
                    os.unlink(tmp)
    return str(so)
