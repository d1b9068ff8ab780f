"""Python client for the native shared-memory object store.

Wraps ``ray_tpu_torch/csrc/shmstore.cc`` (built with g++ at first use into
``ray_tpu_torch/_build/`` by ``_core/buildcheck.py``) via ctypes — the
binding role the reference's ``_raylet.pyx`` Cython layer plays for plasma
(/root/reference/python/ray/_raylet.pyx,
src/ray/object_manager/plasma/client.h).  Every local process maps the same
shm segment, so a ``get`` yields a zero-copy memoryview into shared memory
that ``serialization.deserialize`` turns into numpy views without copying.
"""

from __future__ import annotations

import ctypes
import mmap
import os
import threading
import time
from typing import Optional, Tuple

from ray_tpu_torch._private.ids import ObjectID
from ray_tpu_torch.exceptions import ObjectStoreFullError


_DEFAULT_TABLE = 65536
_DEFAULT_FREELIST = 32768


def _load_lib() -> ctypes.CDLL:
    from ray_tpu_torch._core.buildcheck import ensure_built
    lib = ctypes.CDLL(ensure_built("shmstore"))
    lib.store_segment_size.restype = ctypes.c_uint64
    lib.store_segment_size.argtypes = [ctypes.c_uint64, ctypes.c_uint32,
                                       ctypes.c_uint32]
    lib.store_init.restype = ctypes.c_int
    lib.store_init.argtypes = [ctypes.c_void_p, ctypes.c_uint64,
                               ctypes.c_uint32, ctypes.c_uint32]
    lib.store_validate.restype = ctypes.c_int
    lib.store_validate.argtypes = [ctypes.c_void_p]
    lib.store_create.restype = ctypes.c_longlong
    lib.store_create.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                 ctypes.c_uint64, ctypes.c_uint64,
                                 ctypes.c_int]
    for name in ("store_seal", "store_release", "store_contains",
                 "store_delete", "store_abort"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.store_get.restype = ctypes.c_int
    lib.store_get.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                              ctypes.POINTER(ctypes.c_uint64)]
    lib.store_seal_count.restype = ctypes.c_uint64
    lib.store_seal_count.argtypes = [ctypes.c_void_p]
    lib.store_stats.restype = None
    lib.store_stats.argtypes = [ctypes.c_void_p,
                                ctypes.POINTER(ctypes.c_uint64)]
    lib.store_list.restype = ctypes.c_uint32
    lib.store_list.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                               ctypes.c_uint32]
    return lib


_lib: Optional[ctypes.CDLL] = None


def get_lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        _lib = _load_lib()
    return _lib


class SharedMemoryStore:
    """One per node.  ``create_segment`` (daemon) / ``attach`` (clients)."""

    def __init__(self, path: str, mm: mmap.mmap, created: bool):
        self._path = path
        self._mm = mm
        self._buf = memoryview(mm)
        self._base = ctypes.addressof(ctypes.c_char.from_buffer(mm))
        self._lib = get_lib()
        self._created = created
        self._prefault_stop = threading.Event()
        self._prefault_thread: Optional[threading.Thread] = None

    def prefault_async(self, chunk_bytes: int = 32 * 1024 * 1024,
                       duty: float = 0.33,
                       initial_delay: float = 3.0) -> None:
        """Touch every segment page from a background thread.

        On VMs with on-demand memory paging (this box: ~28 us per 4 KiB
        first-touch fault, ~0.15 GiB/s) a cold multi-GiB put is fault-
        bound, not memcpy-bound (warm writes run at ~4.5 GiB/s).  The
        kernel can't populate faster either (MADV_POPULATE_WRITE measures
        the same), so the only win is moving the faults OFF the put
        critical path.

        The walk is deliberately polite: it starts after `initial_delay`
        (daemon startup is the worst moment to steal the core on a
        1-core host) and holds a `duty` CPU duty cycle by sleeping
        proportionally to each chunk's measured fault time — the old
        fixed 2 ms yield ran at ~99% duty and cost the foreground
        plasma paths ~40% of their ops/s while it walked."""
        if self._prefault_thread is not None:
            return

        def run():
            try:
                libc = ctypes.CDLL("libc.so.6", use_errno=True)
            except OSError:
                return
            MADV_POPULATE_WRITE = 23
            total = len(self._mm)
            off = 0
            if self._prefault_stop.wait(initial_delay):
                return
            while off < total and not self._prefault_stop.is_set():
                n = min(chunk_bytes, total - off)
                t0 = time.monotonic()
                rc = libc.madvise(ctypes.c_void_p(self._base + off),
                                  ctypes.c_size_t(n),
                                  MADV_POPULATE_WRITE)
                if rc != 0:      # old kernel / unsupported mapping: stop
                    return
                off += n
                busy = time.monotonic() - t0
                # already-resident chunks return in ~us; don't sleep for
                # those, only pay the duty cycle on real fault work
                if busy > 0.001:
                    self._prefault_stop.wait(busy * (1.0 - duty) / duty)

        self._prefault_thread = threading.Thread(
            target=run, name="store-prefault", daemon=True)
        self._prefault_thread.start()

    # ------------------------------------------------------------ lifecycle
    @classmethod
    def create_segment(cls, path: str, capacity: int,
                       table_size: int = _DEFAULT_TABLE,
                       freelist: int = _DEFAULT_FREELIST) -> "SharedMemoryStore":
        lib = get_lib()
        total = lib.store_segment_size(capacity, table_size, freelist)
        fd = os.open(path, os.O_CREAT | os.O_RDWR | os.O_TRUNC, 0o600)
        try:
            os.ftruncate(fd, total)
            mm = mmap.mmap(fd, total)
        finally:
            os.close(fd)
        store = cls(path, mm, created=True)
        rc = lib.store_init(store._base, capacity, table_size, freelist)
        if rc != 0:
            raise OSError(f"store_init failed: {rc}")
        return store

    @classmethod
    def attach(cls, path: str, timeout: float = 10.0) -> "SharedMemoryStore":
        lib = get_lib()
        deadline = time.monotonic() + timeout
        while True:
            try:
                fd = os.open(path, os.O_RDWR)
                size = os.fstat(fd).st_size
                if size > 0:
                    mm = mmap.mmap(fd, size)
                    os.close(fd)
                    store = cls(path, mm, created=False)
                    if lib.store_validate(store._base) == 0:
                        return store
                    store.close()
                else:
                    os.close(fd)
            except FileNotFoundError:
                pass
            if time.monotonic() > deadline:
                raise TimeoutError(f"object store segment not ready: {path}")
            time.sleep(0.02)

    def close(self) -> None:
        self._prefault_stop.set()
        if self._prefault_thread is not None:
            self._prefault_thread.join(timeout=5)
        self._buf.release()
        try:
            self._mm.close()
        except BufferError:
            pass  # outstanding zero-copy views; leave mapping to process exit

    def unlink(self) -> None:
        try:
            os.unlink(self._path)
        except FileNotFoundError:
            pass

    # ------------------------------------------------------------- objects
    def create(self, object_id: ObjectID, size: int, meta: int = 0,
               allow_evict: bool = True) -> memoryview:
        rc = self._lib.store_create(self._base, object_id.binary(), size,
                                    meta, 1 if allow_evict else 0)
        if rc == -1:
            raise FileExistsError(f"object exists: {object_id}")
        if rc in (-2, -3):
            raise ObjectStoreFullError(
                f"cannot allocate {size} bytes (rc={rc})")
        if rc < 0:
            raise OSError(f"store_create failed: {rc}")
        off = int(rc)
        return self._buf[off:off + size]

    def seal(self, object_id: ObjectID) -> None:
        rc = self._lib.store_seal(self._base, object_id.binary())
        if rc != 0:
            raise KeyError(f"seal failed for {object_id}: {rc}")

    def abort(self, object_id: ObjectID) -> None:
        self._lib.store_abort(self._base, object_id.binary())

    def get(self, object_id: ObjectID,
            timeout: Optional[float] = 0.0) -> Optional[Tuple[memoryview, int]]:
        """Returns (buffer, meta) pinning the object, or None if absent.

        ``timeout``: 0 -> non-blocking; None -> wait forever; else seconds.
        """
        out = (ctypes.c_uint64 * 3)()
        deadline = None if timeout is None else time.monotonic() + timeout
        delay = 0.0005
        while True:
            rc = self._lib.store_get(self._base, object_id.binary(), out)
            if rc == 0:
                off, size, meta = out[0], out[1], out[2]
                return self._buf[off:off + size], int(meta)
            if deadline is not None and time.monotonic() >= deadline:
                return None
            time.sleep(delay)
            delay = min(delay * 2, 0.01)

    def release(self, object_id: ObjectID) -> None:
        self._lib.store_release(self._base, object_id.binary())

    def contains(self, object_id: ObjectID) -> bool:
        return self._lib.store_contains(self._base, object_id.binary()) == 1

    def delete(self, object_id: ObjectID) -> bool:
        return self._lib.store_delete(self._base, object_id.binary()) == 0

    def list_objects(self, max_entries: int = 65536) -> list:
        """Sealed objects as (ObjectID, size, lru_tick, pins) tuples — the
        spill manager's victim-selection view (cf. reference eviction-policy
        LRU walk feeding LocalObjectManager::SpillObjectsOfSize)."""
        buf = ctypes.create_string_buffer(40 * max_entries)
        n = self._lib.store_list(self._base, buf, max_entries)
        out = []
        raw = buf.raw
        for i in range(n):
            rec = raw[i * 40:(i + 1) * 40]
            out.append((ObjectID(rec[:20]),
                        int.from_bytes(rec[20:28], "little"),
                        int.from_bytes(rec[28:36], "little"),
                        int.from_bytes(rec[36:40], "little", signed=True)))
        return out

    def stats(self) -> dict:
        out = (ctypes.c_uint64 * 5)()
        self._lib.store_stats(self._base, out)
        return {"capacity": out[0], "bytes_in_use": out[1],
                "num_objects": out[2], "free_blocks": out[3],
                "leaked_bytes": out[4]}

    # --------------------------------------------------------- put helpers
    def put_serialized(self, object_id: ObjectID, head_payload: bytes,
                       views, error: bool = False,
                       allow_evict: bool = True) -> None:
        from ray_tpu_torch._private import serialization as ser
        total = ser.serialized_size(head_payload, views)
        buf = self.create(object_id, total, meta=1 if error else 0,
                          allow_evict=allow_evict)
        try:
            ser.write_into(buf, head_payload, views)
        except BaseException:
            buf.release()
            self.abort(object_id)
            raise
        buf.release()
        self.seal(object_id)

    def get_deserialized(self, object_id: ObjectID,
                         timeout: Optional[float] = 0.0):
        """Returns (found, value). Zero-copy for numpy payloads: the
        object stays pinned while the value may hold views into the
        segment (release on GC is the caller's concern).  Payloads with
        NO out-of-band buffers (plain pickled python objects) are fully
        copied out by deserialization, so their pin is released here —
        a long stream of consumed generator items must not keep every
        item pinned in shm."""
        res = self.get(object_id, timeout)
        if res is None:
            return False, None
        buf, _meta = res
        from ray_tpu_torch._private import serialization as ser
        try:
            value, holds_views = ser.deserialize_with_viewinfo(buf)
        except BaseException:
            buf.release()
            self.release(object_id)
            raise
        if not holds_views:
            buf.release()
            self.release(object_id)
        return True, value
