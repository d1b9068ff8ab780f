"""Runtime-env package handling: zip local code, content-address it in the
GCS KV store, unpack once per node.

Analog of /root/reference/python/ray/_private/runtime_env/packaging.py
(URI packaging + cache) — the store is the GCS internal KV (the reference
uploads there too for small packages) and unpack is rename-atomic so many
workers racing on one node do the work once.
"""

from __future__ import annotations

import hashlib
import io
import os
import shutil
import tempfile
import zipfile
from typing import List, Optional

_KV_PREFIX = "rtenv_pkg:"
_EXCLUDE_DIRS = {"__pycache__", ".git", ".venv", "node_modules"}
MAX_PACKAGE_BYTES = 512 * 1024 * 1024


def tree_fingerprint(path: str) -> str:
    """Cheap change detector: hash of (relpath, mtime_ns, size) for every
    file — used to invalidate the driver's prepare cache without zipping."""
    h = hashlib.sha256()
    if os.path.isfile(path):
        st = os.stat(path)
        h.update(f"{path}:{st.st_mtime_ns}:{st.st_size}".encode())
    else:
        for root, dirs, files in os.walk(path):
            dirs[:] = sorted(d for d in dirs if d not in _EXCLUDE_DIRS)
            for f in sorted(files):
                full = os.path.join(root, f)
                try:
                    st = os.stat(full)
                except OSError:
                    continue
                rel = os.path.relpath(full, path)
                h.update(f"{rel}:{st.st_mtime_ns}:{st.st_size}".encode())
    return h.hexdigest()[:16]


def zip_directory(path: str) -> bytes:
    """Deterministic zip of a directory tree (or a single .py file)."""
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED) as zf:
        if os.path.isfile(path):
            zf.write(path, os.path.basename(path))
        else:
            entries = []
            for root, dirs, files in os.walk(path):
                dirs[:] = sorted(d for d in dirs if d not in _EXCLUDE_DIRS)
                for f in sorted(files):
                    full = os.path.join(root, f)
                    entries.append((full, os.path.relpath(full, path)))
            for full, rel in entries:
                zf.write(full, rel)
    blob = buf.getvalue()
    if len(blob) > MAX_PACKAGE_BYTES:
        raise ValueError(
            f"runtime_env package {path!r} is {len(blob)} bytes "
            f"(limit {MAX_PACKAGE_BYTES}); ship big data via the object "
            "store or a filesystem, not runtime_env")
    return blob


def package_uri(blob: bytes) -> str:
    return "pkg://" + hashlib.sha256(blob).hexdigest()[:32]


def upload_package(gcs, path: str) -> str:
    """Zip + upload to the GCS KV; returns the content-addressed URI."""
    blob = zip_directory(path)
    uri = package_uri(blob)
    gcs.kv_put(_KV_PREFIX + uri, blob, overwrite=False)
    return uri


def ensure_local(gcs, uri: str, base_dir: str) -> str:
    """Download+unpack `uri` under base_dir (idempotent, rename-atomic)."""
    dest = os.path.join(base_dir, uri.replace("pkg://", ""))
    if os.path.isdir(dest):
        return dest
    blob = gcs.kv_get(_KV_PREFIX + uri)
    if blob is None:
        raise FileNotFoundError(f"runtime_env package {uri} not in GCS")
    os.makedirs(base_dir, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=base_dir, prefix=".unpack-")
    try:
        with zipfile.ZipFile(io.BytesIO(blob)) as zf:
            zf.extractall(tmp)
        try:
            os.rename(tmp, dest)
        except OSError:
            if not os.path.isdir(dest):  # lost a benign unpack race?
                raise
            shutil.rmtree(tmp, ignore_errors=True)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return dest
