"""Preallocated single-writer/multi-reader shm channels for compiled DAGs.

A ``Channel`` is ONE object in the node's ``SharedMemoryStore`` segment,
created once at compile time and then mutated in place: a fixed ring of
``nslots`` payload slots plus a small header and one 8-byte ack counter
per reader.  Every process on the node maps the same segment, so a
write is a memcpy into shared memory and a read is a poll on the slot's
sequence word — **zero per-item allocation, zero RPCs, zero task
submissions** (docs/compiled_dag.md).  This is the transport the
reference's accelerated/compiled DAGs build on plasma-backed
IntraProcessChannel/shm channels; here the ring lives directly on the
store segment from runtime/object_store.py.

Layout (little endian, offsets from the start of the channel object)::

    0   u32  magic
    4   u32  layout version
    8   u32  nslots
    12  u32  nreaders
    16  u64  per-slot payload capacity
    24  u64  poison code (0 = live)
    32  ...  reserved to 64
    64  u64  acks[nreaders]   -- acks[r] = items reader r consumed
    ..  slots: [u64 seq | u64 len | u64 flags | payload] * nslots

Protocol (seqlock-flavored, no cross-process atomics needed):

* the single writer publishes item ``k`` into slot ``k % nslots`` by
  writing payload, then ``len``/``flags``, then ``seq = k + 1`` LAST;
  it may only do so once ``min(acks) > k - nslots`` (every reader has
  released the slot's previous tenant) — that wait IS the ring's
  backpressure.
* reader ``r`` waits for ``slot.seq == k + 1``, copies the payload out,
  then publishes ``acks[r] = k + 1``.  Each ack word has exactly one
  writer, so no counter is ever contended.

Correctness leans on x86-TSO store ordering (stores become visible in
program order) and on 8-byte aligned copies being effectively atomic —
the same assumptions every shm seqlock makes; aarch64 would need
barriers this pure-Python layer cannot express, so compiled DAGs are
gated to the x86 hosts this repo targets.

Error propagation: ``flags`` bit 0 marks the payload as a serialized
exception (written via ``serialize(err, error_type=...)``), so
``deserialize`` on the consumer raises it — a failed stage forwards the
raw error payload downstream and the driver's ``get()`` re-raises.

Poisoning: any participant may stamp the header's poison word; every
blocked wait polls it and unwinds with ``ChannelClosedError``, which is
how worker death and ``teardown()`` wake the whole graph.
"""

from __future__ import annotations

import struct
import threading
import time
from typing import List, Optional, Tuple

from ray_tpu_torch._private import runtime_metrics as rtm
from ray_tpu_torch._private import serialization as ser
from ray_tpu_torch._private.analysis import channel_check
from ray_tpu_torch._private.ids import ObjectID
from ray_tpu_torch.exceptions import ChannelClosedError, ChannelTimeoutError

_MAGIC = 0x52435448          # "RCTH"
_LAYOUT_VERSION = 1
_HEADER_BYTES = 64
_SLOT_HEADER = 24            # u64 seq | u64 len | u64 flags
_U32 = struct.Struct("<I")
_U64 = struct.Struct("<Q")

# payload flag bits
FLAG_ERROR = 1               # payload is a serialized exception

# poison codes
POISON_TEARDOWN = 1
POISON_WORKER_DIED = 2

# wait loop: a short yield-spin keeps the hot pipelined case off the
# sleep quantum entirely, then a two-tier exponential backoff — short
# sleeps (<= 0.5 ms) while the wait is young so an active graph's stage
# handoffs stay sub-millisecond, escalating to 5 ms polls once a wait
# has been parked past _PARK_AFTER_S so resident actor loops idling
# between executions cost ~0.1% CPU instead of ~1%
_SPIN_YIELDS = 256
_SLEEP_MIN_S = 0.00005
_SLEEP_MAX_S = 0.0005
_SLEEP_PARKED_S = 0.005
_PARK_AFTER_S = 0.05
_EVERY_POISON_CHECK = 8      # poll poison every N sleeps, not every spin

# channel-path telemetry (docs/compiled_dag.md / docs/observability.md)
_M_WRITE_WAIT = rtm.histogram(
    "ray_tpu_dag_channel_write_wait_ms",
    "time a compiled-DAG channel writer blocked on ring credit")
_M_READ_WAIT = rtm.histogram(
    "ray_tpu_dag_channel_read_wait_ms",
    "time a compiled-DAG channel reader blocked for the next item")


def channel_object_id(seed: bytes) -> ObjectID:
    """Deterministic 20-byte store id for a channel (compile stamps the
    DAG id + role into ``seed`` so driver and actors derive the same)."""
    import hashlib
    return ObjectID(hashlib.sha1(b"dagchan:" + seed).digest()[:20])


def channel_size(nslots: int, nreaders: int, capacity: int) -> int:
    return _HEADER_BYTES + 8 * nreaders + nslots * (_SLOT_HEADER + capacity)


class Channel:
    """Attached view over one channel object (see module docstring).

    The instance holds the store pin for the mapped object; ``close()``
    releases it.  One process may attach the same channel once and share
    the instance between its writer/readers — attach is idempotent at
    the compiled-DAG layer, not here.
    """

    def __init__(self, store, oid: ObjectID, view: memoryview):
        self._store = store
        self.oid = oid
        self._view = view
        magic, version = _U32.unpack_from(view, 0)[0], _U32.unpack_from(view, 4)[0]
        if magic != _MAGIC:
            raise ChannelClosedError(
                f"object {oid.hex()[:12]} is not a channel (bad magic)")
        if version != _LAYOUT_VERSION:
            raise ChannelClosedError(
                f"channel {oid.hex()[:12]} layout v{version} != "
                f"v{_LAYOUT_VERSION}")
        self.nslots = _U32.unpack_from(view, 8)[0]
        self.nreaders = _U32.unpack_from(view, 12)[0]
        self.capacity = _U64.unpack_from(view, 16)[0]
        self._acks_off = _HEADER_BYTES
        self._slots_off = self._acks_off + 8 * self.nreaders
        self._slot_stride = _SLOT_HEADER + self.capacity
        self._closed = False
        self._close_lock = threading.Lock()
        # yield-spin budget before the sleep backoff: compiled DAGs
        # keep the aggressive default (latency-critical, usually more
        # cores than spinners); participants with MANY channels per
        # core (collective rings, docs/collective.md) turn it down —
        # N ranks yield-spinning on fewer cores starve the one rank
        # that has real work, inverting the latency win
        self.spin_yields = _SPIN_YIELDS
        # protocol sanitizer gate, resolved per attach so suites can
        # flip RAY_TPU_TORCH_DEBUG_CHANNELS without reimporting this module
        self._debug = channel_check.enabled()

    # ------------------------------------------------------------ lifecycle
    @classmethod
    def create(cls, store, oid: ObjectID, *, nslots: int, nreaders: int,
               capacity: int) -> "Channel":
        """Allocate + seal the channel object and return an attached
        (pinned) view.  Only the compiling driver calls this."""
        if nslots < 1 or nreaders < 1 or capacity < 1:
            raise ValueError("nslots, nreaders and capacity must be >= 1")
        # the slot stride is _SLOT_HEADER + capacity: round capacity up
        # so every slot's u64 seq/len/flags words stay 8-byte aligned —
        # the protocol's effectively-atomic-store assumption does not
        # hold for a misaligned word
        capacity = (capacity + 7) & ~7
        total = channel_size(nslots, nreaders, capacity)
        buf = store.create(oid, total, meta=0, allow_evict=True)
        try:
            # zero the control words (segment memory may be recycled);
            # payload areas don't need it
            buf[:_HEADER_BYTES + 8 * nreaders] = \
                bytes(_HEADER_BYTES + 8 * nreaders)
            _U32.pack_into(buf, 0, _MAGIC)
            _U32.pack_into(buf, 4, _LAYOUT_VERSION)
            _U32.pack_into(buf, 8, nslots)
            _U32.pack_into(buf, 12, nreaders)
            _U64.pack_into(buf, 16, capacity)
            stride = _SLOT_HEADER + capacity
            base = _HEADER_BYTES + 8 * nreaders
            for i in range(nslots):
                buf[base + i * stride:base + i * stride + _SLOT_HEADER] = \
                    bytes(_SLOT_HEADER)
        except BaseException:
            buf.release()
            store.abort(oid)
            raise
        buf.release()
        store.seal(oid)
        return cls.attach(store, oid, timeout=5.0)

    @classmethod
    def attach(cls, store, oid: ObjectID,
               timeout: Optional[float] = 10.0) -> "Channel":
        """Map an existing channel; pins it until ``close()``.  Raises
        ChannelTimeoutError when the object never appears — on a
        compiled DAG that means the actor lives on a different node
        than the driver's segment (docs/compiled_dag.md limits)."""
        res = store.get(oid, timeout=timeout)
        if res is None:
            raise ChannelTimeoutError(
                f"channel object {oid.hex()[:12]} not present in the local "
                f"shared-memory segment (compiled DAGs require all "
                f"participants on the driver's node)")
        view, _meta = res
        try:
            return cls(store, oid, view)
        except BaseException:
            view.release()
            store.release(oid)
            raise

    def close(self) -> None:
        """Release this process's pin (idempotent)."""
        with self._close_lock:
            if self._closed:
                return
            self._closed = True
        self._view.release()
        try:
            self._store.release(self.oid)
        except Exception:
            pass

    def delete(self) -> bool:
        """Best-effort removal of the backing object (driver teardown,
        after every participant released its pin)."""
        try:
            return self._store.delete(self.oid)
        except Exception:
            return False

    # ------------------------------------------------------------ poisoning
    def poison(self, code: int = POISON_TEARDOWN) -> None:
        _U64.pack_into(self._view, 24, code)

    def poison_code(self) -> int:
        return _U64.unpack_from(self._view, 24)[0]

    # ------------------------------------------------------------ internals
    def _slot_off(self, k: int) -> int:
        return self._slots_off + (k % self.nslots) * self._slot_stride

    def _min_acks(self) -> int:
        v = self._view
        off = self._acks_off
        lo = _U64.unpack_from(v, off)[0]
        for r in range(1, self.nreaders):
            a = _U64.unpack_from(v, off + 8 * r)[0]
            if a < lo:
                lo = a
        return lo

    def _wait(self, ready, deadline: Optional[float],
              stop: Optional[threading.Event], what: str) -> None:
        """Poll ``ready()`` with yield-spin then backoff; raises on
        poison / stop / timeout.  Shared by reader and writer."""
        for _ in range(self.spin_yields):
            if ready():
                return
            time.sleep(0)
        delay = _SLEEP_MIN_S
        ticks = 0
        start = time.monotonic()
        while True:
            if ready():
                return
            ticks += 1
            if ticks % _EVERY_POISON_CHECK == 0 or delay >= _SLEEP_MAX_S:
                code = self.poison_code()
                if code:
                    raise ChannelClosedError(
                        f"channel {self.oid.hex()[:12]} poisoned "
                        f"(code={code}) while waiting to {what}")
                if stop is not None and stop.is_set():
                    raise ChannelClosedError(
                        f"channel {self.oid.hex()[:12]}: local stop while "
                        f"waiting to {what}")
            now = time.monotonic()
            if deadline is not None and now >= deadline:
                raise ChannelTimeoutError(
                    f"timed out waiting to {what} on channel "
                    f"{self.oid.hex()[:12]}")
            time.sleep(delay)
            cap = (_SLEEP_MAX_S if now - start < _PARK_AFTER_S
                   else _SLEEP_PARKED_S)
            delay = min(delay * 2, cap)


class ChannelWriter:
    """The channel's single writer; tracks its own publish cursor."""

    def __init__(self, channel: Channel):
        self.channel = channel
        self.seq = 0                   # items published so far
        # debug-mode writer identity: claims the ring's header claim
        # word on first publish so a second writer instance trips the
        # single-writer check (analysis/channel_check.py)
        self._wid = channel_check.writer_id() if channel._debug else 0

    def writable(self) -> bool:
        """True when the ring has a free slot, i.e. the next write will
        not block on ring credit.  Callers that must never block (the
        collective segment outbox, docs/collective.md) poll this and
        queue locally instead."""
        return self.channel._min_acks() > self.seq - self.channel.nslots

    def write_payload(self, head: bytes, views: List[memoryview],
                      flags: int = 0, timeout: Optional[float] = None,
                      stop: Optional[threading.Event] = None) -> None:
        """Publish one serialized item ((head, out-of-band views) as
        produced by ``serialization.serialize``) directly into the ring
        slot — no intermediate flat-bytes copy."""
        ch = self.channel
        size = ser.serialized_size(head, views)
        if size > ch.capacity:
            raise ValueError(
                f"serialized item ({size} B) exceeds the channel's "
                f"per-slot capacity ({ch.capacity} B); recompile with a "
                f"larger buffer_size_bytes")
        k = self.seq
        floor = k - ch.nslots          # min acks needed to reuse the slot
        if ch._min_acks() <= floor:    # fast-path check before stamping t0
            t0 = rtm.now()
            deadline = None if timeout is None \
                else time.monotonic() + timeout
            ch._wait(lambda: ch._min_acks() > floor, deadline, stop,
                     "write")
            _M_WRITE_WAIT.observe_since(t0)
        if ch._debug:
            channel_check.check_publish(ch, k, self._wid)
        off = ch._slot_off(k)
        payload = ch._view[off + _SLOT_HEADER:off + _SLOT_HEADER + size]
        try:
            ser.write_into(payload, head, views)
        finally:
            payload.release()
        _U64.pack_into(ch._view, off + 8, size)
        _U64.pack_into(ch._view, off + 16, flags)
        # seq is published LAST (x86-TSO keeps the payload stores ahead)
        _U64.pack_into(ch._view, off, k + 1)
        self.seq = k + 1

    def write_raw(self, payload: bytes, flags: int,
                  timeout: Optional[float] = None,
                  stop: Optional[threading.Event] = None) -> None:
        """Publish pre-serialized bytes (error forwarding path)."""
        self.write_payload(payload, [], flags=flags, timeout=timeout,
                           stop=stop)

    def write(self, value, timeout: Optional[float] = None,
              stop: Optional[threading.Event] = None) -> None:
        head, views = ser.serialize(value)
        self.write_payload(head, views, flags=0, timeout=timeout, stop=stop)

    def write_error(self, error: BaseException,
                    timeout: Optional[float] = None,
                    stop: Optional[threading.Event] = None) -> None:
        head, views = ser.serialize(error, error_type=ser.ERROR_TASK)
        self.write_payload(head, views, flags=FLAG_ERROR, timeout=timeout,
                           stop=stop)


class ChannelReader:
    """One registered reader (``idx`` is its compile-assigned ack slot);
    tracks its own consume cursor."""

    def __init__(self, channel: Channel, idx: int):
        if not 0 <= idx < channel.nreaders:
            raise ValueError(f"reader index {idx} out of range "
                             f"(nreaders={channel.nreaders})")
        self.channel = channel
        self.idx = idx
        self.seq = 0                   # items consumed so far

    def read_zc(self, timeout: Optional[float] = None,
                stop: Optional[threading.Event] = None):
        """Zero-copy blocking read: returns ``(payload_view, flags,
        ack)``.  The view maps the ring slot DIRECTLY — consume it
        (deserialize / reduce / copy out), then call ``ack()`` exactly
        once to release the slot; the view is invalid afterwards.  Acks
        must fire in read order (each ack publishes its own cumulative
        counter, so acking item k+1 before k would release k's slot
        early).  The collective shm transport reduces straight out of
        the ring through this (docs/collective.md)."""
        ch = self.channel
        k = self.seq
        off = ch._slot_off(k)
        view = ch._view
        want = k + 1
        if _U64.unpack_from(view, off)[0] != want:
            t0 = rtm.now()
            deadline = None if timeout is None \
                else time.monotonic() + timeout
            ch._wait(lambda: _U64.unpack_from(view, off)[0] == want,
                     deadline, stop, "read")
            _M_READ_WAIT.observe_since(t0)
        size = _U64.unpack_from(view, off + 8)[0]
        flags = _U64.unpack_from(view, off + 16)[0]
        if ch._debug:
            channel_check.check_read(ch, k, size)
        payload = view[off + _SLOT_HEADER:off + _SLOT_HEADER + size]

        def ack(_view=view, _ch=ch, _idx=self.idx, _want=want):
            if _ch._debug:
                channel_check.check_ack(_ch, _idx, _want)
            try:
                _U64.pack_into(_view, _ch._acks_off + 8 * _idx, _want)
            except ValueError:
                pass  # channel closed underneath a late ack

        self.seq = want
        return payload, flags, ack

    def read_raw(self, timeout: Optional[float] = None,
                 stop: Optional[threading.Event] = None
                 ) -> Tuple[bytes, int]:
        """Blocking next item as (payload bytes, flags).  The payload is
        copied out of the ring before acking, so the returned bytes stay
        valid across slot reuse."""
        view, flags, ack = self.read_zc(timeout=timeout, stop=stop)
        payload = bytes(view)
        # ack AFTER the copy: the writer may reuse the slot immediately
        ack()
        return payload, flags

    def read(self, timeout: Optional[float] = None,
             stop: Optional[threading.Event] = None):
        """Blocking next value; raises the carried exception for error
        items (their serialized payload re-raises on deserialize)."""
        payload, _flags = self.read_raw(timeout=timeout, stop=stop)
        return ser.deserialize(payload)
