"""Pluggable URI storage layer — one seam, three consumers.

The reference scatters remote-storage access across
``air/_internal/remote_storage.py:177/195`` (upload_to_uri/download_from_uri
over pyarrow filesystems), ``tune/syncer.py:185`` (checkpoint sync), and
``_private/external_storage.py:72`` (object spilling to S3/disk).  Here all
three consumers — Tune/AIR checkpoint sync, ``data.read_*``/``write_*``, and
raylet spill targets — go through this module, keyed by URI scheme:

- ``file://`` (or a bare path): the local filesystem.
- ``mock://``: an in-process memory store for tests, with optional
  deterministic fault injection (``external_storage.py:587/608``
  UnstableFileStorage/SlowFileStorage analog via :class:`FlakyStorage`).
- ``gs://``: Google Cloud Storage, behind an optional import (not in the
  hermetic image; raises a clear error if unavailable).

Everything is byte-oriented: small API (read/write/delete/exists/list), no
filesystem handles leak across the seam, so a backend can be swapped under
spilling without touching raylet logic.
"""
from __future__ import annotations

import io
import os
import threading
import time
from typing import Dict, List, Optional, Tuple

__all__ = [
    "is_uri", "parse_uri", "join_uri", "get_storage", "register_storage",
    "read_bytes", "write_bytes", "delete_uri", "exists", "list_prefix",
    "upload_dir", "download_dir", "Storage", "FileStorage", "MemoryStorage",
    "FlakyStorage",
]


def is_uri(path: str) -> bool:
    return "://" in path


def parse_uri(uri: str) -> Tuple[str, str]:
    """-> (scheme, key). A bare path is the ``file`` scheme."""
    if "://" not in uri:
        return "file", uri
    scheme, _, rest = uri.partition("://")
    return scheme, rest


def join_uri(base: str, *parts: str) -> str:
    out = base.rstrip("/")
    for p in parts:
        out += "/" + str(p).strip("/")
    return out


class Storage:
    """Byte-level storage under one URI scheme.

    ``key`` arguments are the URI with the scheme stripped
    (``parse_uri(uri)[1]``); helpers at module level accept full URIs.
    """

    def write_bytes(self, key: str, data) -> None:
        """Atomic: a concurrent read sees the old value or the new one,
        never a torn write. ``data`` is bytes or any buffer-protocol
        object (spilling passes shm memoryviews to avoid heap copies)."""
        raise NotImplementedError

    def read_bytes(self, key: str, offset: int = 0,
                   length: Optional[int] = None) -> bytes:
        """Raises FileNotFoundError when absent."""
        raise NotImplementedError

    def delete(self, key: str, missing_ok: bool = True) -> bool:
        raise NotImplementedError

    def exists(self, key: str) -> bool:
        raise NotImplementedError

    def list_prefix(self, key: str) -> List[str]:
        """All keys under a directory-like prefix, relative to it."""
        raise NotImplementedError


class FileStorage(Storage):
    def write_bytes(self, key: str, data: bytes) -> None:
        d = os.path.dirname(key)
        if d:
            os.makedirs(d, exist_ok=True)
        tmp = f"{key}.tmp.{os.getpid()}.{threading.get_ident()}"
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, key)

    def read_bytes(self, key: str, offset: int = 0,
                   length: Optional[int] = None) -> bytes:
        with open(key, "rb") as f:
            if offset:
                f.seek(offset)
            return f.read(-1 if length is None else length)

    def delete(self, key: str, missing_ok: bool = True) -> bool:
        try:
            os.unlink(key)
            return True
        except FileNotFoundError:
            if not missing_ok:
                raise
            return False

    def exists(self, key: str) -> bool:
        return os.path.exists(key)

    def list_prefix(self, key: str) -> List[str]:
        root = key.rstrip("/")
        out = []
        for dirpath, _dirs, files in os.walk(root):
            for fn in files:
                full = os.path.join(dirpath, fn)
                out.append(os.path.relpath(full, root))
        return sorted(out)


class MemoryStorage(Storage):
    """In-process ``mock://`` store; per-process global namespace so a
    writer and reader in the same process (the common test shape: one
    driver, or spilling inside one raylet) share state."""

    _data: Dict[str, bytes] = {}
    _lock = threading.Lock()

    def write_bytes(self, key: str, data: bytes) -> None:
        with MemoryStorage._lock:
            MemoryStorage._data[key] = bytes(data)

    def read_bytes(self, key: str, offset: int = 0,
                   length: Optional[int] = None) -> bytes:
        with MemoryStorage._lock:
            try:
                blob = MemoryStorage._data[key]
            except KeyError:
                raise FileNotFoundError(f"mock://{key}") from None
        end = None if length is None else offset + length
        return blob[offset:end]

    def delete(self, key: str, missing_ok: bool = True) -> bool:
        with MemoryStorage._lock:
            if key in MemoryStorage._data:
                del MemoryStorage._data[key]
                return True
        if not missing_ok:
            raise FileNotFoundError(f"mock://{key}")
        return False

    def exists(self, key: str) -> bool:
        with MemoryStorage._lock:
            return key in MemoryStorage._data

    def list_prefix(self, key: str) -> List[str]:
        pre = key.rstrip("/") + "/"
        with MemoryStorage._lock:
            return sorted(k[len(pre):] for k in MemoryStorage._data
                          if k.startswith(pre))

    @classmethod
    def clear(cls) -> None:
        with cls._lock:
            cls._data.clear()


class FlakyStorage(Storage):
    """Deterministic fault-injection wrapper (reference
    UnstableFileStorage / SlowFileStorage, external_storage.py:587/608).

    ``failure_rate`` fails exactly that fraction of writes (error-diffusion
    accumulator, no RNG: reproducible under pytest). ``slow_ms`` sleeps on
    every operation."""

    def __init__(self, inner: Storage, failure_rate: float = 0.0,
                 slow_ms: float = 0.0, fail_reads: bool = False):
        self.inner = inner
        self.failure_rate = failure_rate
        self.slow_ms = slow_ms
        self.fail_reads = fail_reads
        self._ops = 0
        self._fails = 0
        self._lock = threading.Lock()

    def _maybe_fail(self, what: str) -> None:
        if self.slow_ms:
            time.sleep(self.slow_ms / 1000.0)
        with self._lock:
            self._ops += 1
            if self._ops * self.failure_rate - self._fails >= 1.0:
                self._fails += 1
                raise OSError(f"injected storage fault ({what})")

    def write_bytes(self, key, data):
        self._maybe_fail("write")
        return self.inner.write_bytes(key, data)

    def read_bytes(self, key, offset=0, length=None):
        if self.fail_reads:
            self._maybe_fail("read")
        elif self.slow_ms:
            time.sleep(self.slow_ms / 1000.0)
        return self.inner.read_bytes(key, offset, length)

    def delete(self, key, missing_ok=True):
        return self.inner.delete(key, missing_ok)

    def exists(self, key):
        return self.inner.exists(key)

    def list_prefix(self, key):
        return self.inner.list_prefix(key)


class _GcsStorage(Storage):
    """gs:// behind an optional import; the hermetic TPU image has no
    cloud SDK, so on most boxes construction raises a clear error. With
    the SDK present, keys are ``bucket/path`` and ops map to blob
    upload/download; SDK errors surface as OSError so consumers' retry
    paths (spill scan, syncer) treat them as transient IO."""

    def __init__(self):
        try:
            from google.cloud import storage as gcs
        except ImportError:
            raise ImportError(
                "gs:// URIs need the google-cloud-storage package, which "
                "is not in this image; use file:// or mock://, or install "
                "it in your own environment") from None
        self._client = gcs.Client()

    def _blob(self, key: str):
        bucket, _, path = key.partition("/")
        return self._client.bucket(bucket).blob(path)

    def write_bytes(self, key: str, data) -> None:
        try:
            self._blob(key).upload_from_string(bytes(data))
        except Exception as e:
            raise OSError(f"gs write failed for {key}: {e}") from e

    def read_bytes(self, key: str, offset: int = 0,
                   length: Optional[int] = None) -> bytes:
        end = None if length is None else offset + length - 1
        try:
            return self._blob(key).download_as_bytes(
                start=offset or None, end=end)
        except Exception as e:
            if getattr(e, "code", None) == 404:
                raise FileNotFoundError(f"gs://{key}") from None
            raise OSError(f"gs read failed for {key}: {e}") from e

    def delete(self, key: str, missing_ok: bool = True) -> bool:
        try:
            self._blob(key).delete()
            return True
        except Exception as e:
            if getattr(e, "code", None) == 404:
                if not missing_ok:
                    raise FileNotFoundError(f"gs://{key}") from None
                return False
            raise OSError(f"gs delete failed for {key}: {e}") from e

    def exists(self, key: str) -> bool:
        try:
            return self._blob(key).exists()
        except Exception as e:
            raise OSError(f"gs exists failed for {key}: {e}") from e

    def list_prefix(self, key: str) -> List[str]:
        bucket, _, path = key.partition("/")
        pre = path.rstrip("/") + "/"
        try:
            blobs = self._client.list_blobs(bucket, prefix=pre)
            return sorted(b.name[len(pre):] for b in blobs)
        except Exception as e:
            raise OSError(f"gs list failed for {key}: {e}") from e


_REGISTRY: Dict[str, Storage] = {}
_REGISTRY_LOCK = threading.Lock()
_FACTORIES = {
    "file": FileStorage,
    "local": FileStorage,
    "mock": MemoryStorage,
    "memory": MemoryStorage,
    "gs": _GcsStorage,
}


def register_storage(scheme: str, storage: Storage) -> None:
    """Install a backend (or a wrapped one, e.g. FlakyStorage) for a
    scheme; tests use this to inject faults under real consumers."""
    with _REGISTRY_LOCK:
        _REGISTRY[scheme] = storage


def get_storage(uri: str) -> Tuple[Storage, str]:
    scheme, key = parse_uri(uri)
    with _REGISTRY_LOCK:
        st = _REGISTRY.get(scheme)
        if st is None:
            factory = _FACTORIES.get(scheme)
            if factory is None:
                raise ValueError(
                    f"unsupported storage scheme {scheme!r} in {uri!r} "
                    f"(known: {sorted(_FACTORIES)})")
            st = _REGISTRY[scheme] = factory()
    return st, key


# ----------------------------------------------------------- URI helpers
def read_bytes(uri: str, offset: int = 0,
               length: Optional[int] = None) -> bytes:
    st, key = get_storage(uri)
    return st.read_bytes(key, offset, length)


def write_bytes(uri: str, data: bytes) -> None:
    st, key = get_storage(uri)
    st.write_bytes(key, data)


def delete_uri(uri: str, missing_ok: bool = True) -> bool:
    st, key = get_storage(uri)
    return st.delete(key, missing_ok)


def exists(uri: str) -> bool:
    st, key = get_storage(uri)
    return st.exists(key)


def list_prefix(uri: str) -> List[str]:
    st, key = get_storage(uri)
    return st.list_prefix(key)


def open_reader(uri: str) -> io.BytesIO:
    """Whole-object reader for pandas/pyarrow-style consumers."""
    return io.BytesIO(read_bytes(uri))


def upload_dir(local_dir: str, uri: str) -> int:
    """Mirror a local directory tree under a URI prefix; returns file
    count (reference upload_to_uri, remote_storage.py:195)."""
    st, key = get_storage(uri)
    n = 0
    for dirpath, _dirs, files in os.walk(local_dir):
        for fn in files:
            full = os.path.join(dirpath, fn)
            rel = os.path.relpath(full, local_dir)
            with open(full, "rb") as f:
                st.write_bytes(join_uri(key, *rel.split(os.sep)), f.read())
            n += 1
    return n


def download_dir(uri: str, local_dir: str) -> int:
    """Materialize a URI prefix as a local directory tree (reference
    download_from_uri, remote_storage.py:177)."""
    st, key = get_storage(uri)
    os.makedirs(local_dir, exist_ok=True)
    n = 0
    for rel in st.list_prefix(key):
        dest = os.path.join(local_dir, *rel.split("/"))
        os.makedirs(os.path.dirname(dest), exist_ok=True)
        with open(dest, "wb") as f:
            f.write(st.read_bytes(join_uri(key, *rel.split("/"))))
        n += 1
    return n
