"""Segment transports for the DCN collective data plane (the port's copy
of ray_tpu/util/collective/transport.py).

Two ways a pair of ranks exchanges tensor segments
(docs/collective.md):

* **TCP pull links** — receiver-driven: the consumer issues a ``take``
  request on a pooled duplex connection (``rpc.call_async``) carrying a
  buffer sink, so the reply's out-of-band payload is ``recv_into``-ed
  straight into the consumer's accumulator/staging/output buffer.  The
  producer side parks unfulfilled takes as :class:`rpc.Deferred`\\ s on a
  :class:`ServeBoard`; ``publish()`` resolves them with **stable**
  pickle-5 out-of-band frames (zero defensive copy; the ``on_sent``
  hook tracks drain so an op never returns while a peer could still
  read its buffers off the wire).
* **shm links** — same-node ranks exchange segments over
  single-writer/single-reader ring channels
  (:mod:`ray_tpu_torch.experimental.channel`) on the node's shared-memory
  store segment: a send is one memcpy into the ring (queued on a local
  outbox when the ring is full — writes never block the op thread),
  and a recv deserializes ZERO-COPY straight out of the ring slot
  (ack deferred until the view is consumed).

Both present the same three-verb interface to the algorithms in
``collective.py``::

    link.publish(tag, arr, deadline)       # make a segment available
    h = link.request(tag, dest)            # announce intent to consume
    arr, in_place = link.wait(h, deadline) # blocking segment arrival

``in_place`` is True when the payload already landed in ``dest``
(TCP buffer-sink hit); shm reads return a ring-slot view the caller
consumes (reduces / copies into place) before the next link op.

:class:`ShmArena` is the third plane: single-node groups allreduce
through persistent store slabs with no per-segment protocol at all
(docs/collective.md).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ray_tpu_torch._private import rpc
from ray_tpu_torch._private import runtime_metrics as rtm
from ray_tpu_torch._private import serialization as ser
from ray_tpu_torch._private.config import CONFIG
from ray_tpu_torch._private.logging_utils import get_logger

logger = get_logger("collective")

# data-plane telemetry (docs/collective.md / docs/observability.md).
# The tcp/shm byte counters are the transport-selection ground truth:
# a same-node-only group must leave the TCP counter at exactly zero.
# hot-path kill-switch binding, the rpc.py idiom: one enabled() read at
# import; record sites whose ARGUMENT computation isn't free guard on
# this instead of paying an env read + config lock per segment
_TELEMETRY = rtm.enabled()
_M_TCP_BYTES = rtm.counter(
    "ray_tpu_collective_tcp_bytes_total",
    "collective segment payload bytes moved over TCP links")
_M_SHM_BYTES = rtm.counter(
    "ray_tpu_collective_shm_bytes_total",
    "collective segment payload bytes moved over same-node shm channels")
_M_STALL = rtm.gauge(
    "ray_tpu_collective_ring_stall_ms",
    "high-water time a collective op blocked waiting for one segment "
    "since the last flush (ring stall)", watermark=True)
_M_STALL_H = rtm.histogram(
    "ray_tpu_collective_seg_wait_ms",
    "per-segment blocking wait inside a collective op (ms)")
# codec-tagged wire accounting (docs/collective.md): every segment the
# ring engines publish increments wire_bytes under its codec label
# ("fp32" for the unquantized plane), and quantized segments credit the
# fp32-equivalent-minus-wire difference to bytes_saved — the counters
# the MICROBENCH 2x claim and metrics_summary's Collective block read.
_M_WIRE_BYTES = rtm.counter_family(
    "ray_tpu_collective_wire_bytes",
    "collective ring segment bytes published, by wire codec",
    tag_keys=("codec",))
_M_BYTES_SAVED = rtm.counter(
    "ray_tpu_collective_bytes_saved_total",
    "wire bytes saved by collective quantization (fp32-equivalent "
    "payload minus encoded payload)")


def count_wire(codec_name: str, wire_nbytes: int,
               raw_nbytes: int) -> None:
    """Wire-accounting hook for the ring engines (one call per
    published segment).  When ``collective_sim_dcn_mbps`` > 0 it also
    paces the publisher to that bandwidth — a debug/benchmark knob (the
    ``object_spill_slow_ms`` injection precedent) that models a
    bytes-limited DCN link on boxes whose loopback "wire" is really
    CPU: the sleep is proportional to the ENCODED bytes, so a wire
    codec's saving shows up as exactly the wall time a real
    bandwidth-limited link would give back."""
    mbps = CONFIG.collective_sim_dcn_mbps
    if mbps > 0:
        time.sleep(wire_nbytes / (mbps * 2**20))
    if not _TELEMETRY:
        return
    _M_WIRE_BYTES.inc((codec_name,), wire_nbytes)
    if raw_nbytes > wire_nbytes:
        _M_BYTES_SAVED.inc(raw_nbytes - wire_nbytes)

# a single-segment wait past this emits a COLLECTIVE_RING_STALL cluster
# event (docs/observability.md) — well above healthy segment times, far
# below the op timeout, so the event fires while the op can still be
# saved (or at least explains the timeout that follows)
_RING_STALL_EVENT_MS = 5000.0


def tag_seq(tag: str) -> Optional[int]:
    """Op sequence number embedded in a collective tag (``"<seq>:..."``);
    None for unsequenced tags (p2p)."""
    head, _, _ = tag.partition(":")
    try:
        return int(head)
    except ValueError:
        return None


def _remaining(deadline: Optional[float]) -> Optional[float]:
    if deadline is None:
        return None
    return max(0.001, deadline - time.monotonic())


class ServeBoard:
    """Rank-local registry of outgoing segments awaiting peer take
    requests (the producer half of a TCP pull link).

    ``publish`` and ``take`` meet in either order: an early take parks a
    :class:`rpc.Deferred` the publish resolves; an early publish stores
    the array for the take to collect.  Entries are keyed by
    ``(taker_rank, tag)``.  Resolutions ride **stable** frames — the
    published array must stay immutable until its frame drains to the
    socket, which :meth:`wait_clear` enforces before the op returns.

    Hygiene mirrors the mailbox fix (ISSUE 6): ``sweep_below`` drops
    entries of finished ops and *fails* parked takes for them, so a peer
    that timed out mid-op gets an error instead of a forever-parked
    request poisoning the next op that reuses the tag space.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._entries: Dict[Tuple[int, str], np.ndarray] = {}
        self._parked: Dict[Tuple[int, str], rpc.Deferred] = {}
        self._undrained = 0
        self._closed = False

    def _sent_one(self) -> None:
        with self._cv:
            self._undrained -= 1
            if self._undrained <= 0:
                self._cv.notify_all()

    def _resolve(self, d: rpc.Deferred, arr: np.ndarray) -> None:
        """Never called with the board lock held: resolving sends the
        reply frame, and a full socket may block that send — blocking
        while holding the lock would wedge every other taker/publisher
        (including the RPC readers servicing this very socket)."""
        d.resolve(arr, stable=True, on_sent=self._sent_one)
        if _TELEMETRY:
            _M_TCP_BYTES.inc(arr.nbytes)

    def publish(self, dst: int, tag: str, arr: np.ndarray) -> None:
        key = (dst, tag)
        with self._cv:
            if self._closed:
                raise RuntimeError("collective group destroyed")
            d = self._parked.pop(key, None)
            if d is not None:
                self._undrained += 1
            else:
                self._entries[key] = arr
                return
        self._resolve(d, arr)

    def take(self, src: int, tag: str) -> rpc.Deferred:
        """Server-handler side: returns the Deferred carrying the reply.
        Runs on the dispatch pool, NOT inline on the connection reader —
        an immediate resolution's reply send may block on a saturated
        socket, and a blocked reader would deadlock the full-duplex
        ring."""
        key = (src, tag)
        d = rpc.Deferred()
        old = None
        with self._cv:
            if self._closed:
                arr = None
                fail = rpc.RpcError("collective group destroyed")
            else:
                fail = None
                arr = self._entries.pop(key, None)
                if arr is not None:
                    self._undrained += 1
                else:
                    # one outstanding take per (src, tag): a duplicate
                    # (peer retry after timeout) supersedes the old
                    # parked request
                    old = self._parked.pop(key, None)
                    self._parked[key] = d
        if fail is not None:
            d.fail(fail)
        elif arr is not None:
            self._resolve(d, arr)
        if old is not None:
            old.fail(rpc.RpcError(f"take {tag!r} superseded"))
        return d

    def sweep_below(self, seq_floor: int) -> None:
        """Drop entries and fail parked takes whose tag belongs to an op
        older than ``seq_floor`` (the group's current op sequence)."""
        with self._cv:
            for key in [k for k in self._entries
                        if (tag_seq(k[1]) or seq_floor) < seq_floor]:
                del self._entries[key]
            stale = [k for k in self._parked
                     if (tag_seq(k[1]) or seq_floor) < seq_floor]
            parked = [self._parked.pop(k) for k in stale]
        for d in parked:
            d.fail(rpc.RpcError("stale collective take (op expired)"))

    def wait_clear(self, deadline: Optional[float]) -> None:
        """Block until every published entry has been taken AND every
        resolved reply frame has drained to the socket — after this the
        caller may mutate (or free) the buffers it published.  Raises
        TimeoutError if a peer never collects (it died mid-op)."""
        with self._cv:
            while self._entries or self._undrained > 0:
                t = _remaining(deadline)
                if t is not None and t <= 0:
                    raise TimeoutError(
                        f"collective op end: {len(self._entries)} "
                        f"published segments never taken and "
                        f"{self._undrained} reply frames undrained "
                        f"(peer dead or wedged)")
                self._cv.wait(min(t, 0.5) if t is not None else 0.5)

    def close(self) -> None:
        with self._cv:
            self._closed = True
            self._entries.clear()
            parked = list(self._parked.values())
            self._parked.clear()
            self._undrained = 0
            self._cv.notify_all()
        for d in parked:
            d.fail(rpc.RpcError("collective group destroyed"))


class TcpLink:
    """Pull link to one peer over a pooled duplex connection.

    ``publish`` lands on the *local* board (the peer pulls from us);
    ``request``/``wait`` pull from the peer's board, landing payloads
    through a buffer sink when a destination view is supplied.
    """

    kind = "tcp"

    def __init__(self, group, peer: int):
        self._group = group
        self._peer = peer

    def publish(self, tag: str, arr: np.ndarray,
                deadline: Optional[float] = None) -> None:
        self._group._board.publish(self._peer, tag, arr)

    @staticmethod
    def _make_sink(dest: memoryview, used: list):
        def sink(lens):
            if len(lens) == 1 and lens[0] == len(dest):
                used.append(lens[0])
                return [dest]
            return None  # unexpected shape: fresh storage fallback
        return sink

    def request(self, tag: str, dest: Optional[np.ndarray] = None):
        conn = self._group._conn_to(self._peer)
        payload = {"src": self._group.rank, "tag": tag}
        used: List[int] = []
        sink = None
        if dest is not None and dest.nbytes:
            sink = self._make_sink(dest.data.cast("B"), used)
        fut = conn.call_async("take", payload, buffer_sink=sink)
        return (fut, used)

    def wait(self, handle, deadline: Optional[float]
             ) -> Tuple[np.ndarray, bool]:
        fut, used = handle
        t0 = rtm.now()
        try:
            arr = fut.result(_remaining(deadline))
        except rpc.RemoteError as e:
            raise RuntimeError(
                f"collective take from rank {self._peer} failed: "
                f"{e}") from e
        except ConnectionError as e:
            # hard rank death detected at the transport: emit before
            # unwinding so the event table explains the op failure
            from ray_tpu_torch._private import cluster_events as cev
            cev.emit(cev.COLLECTIVE_RANK_DEATH,
                     f"collective peer rank {self._peer} connection "
                     f"lost mid-op: {e}", severity="ERROR",
                     peer_rank=self._peer)
            raise ConnectionError(
                f"collective peer rank {self._peer} connection lost "
                f"mid-op: {e}") from e
        except Exception as e:
            raise TimeoutError(
                f"collective take from rank {self._peer} timed out "
                f"({e!r})") from e
        ms = (rtm.now() - t0) * 1000.0
        _M_STALL_H.observe(ms)
        _M_STALL.set_max(ms)
        if ms >= _RING_STALL_EVENT_MS:
            # a segment wait this long means the ring is limping (a
            # rank is starved or its link is saturated): one WARNING
            # event per offending wait, next to the stall watermark
            from ray_tpu_torch._private import cluster_events as cev
            cev.emit(cev.COLLECTIVE_RING_STALL,
                     f"waited {ms:.0f}ms on a segment from rank "
                     f"{self._peer}", severity="WARNING",
                     peer_rank=self._peer, stall_ms=round(ms, 1))
        if not isinstance(arr, np.ndarray):
            raise RuntimeError(
                f"collective take from rank {self._peer} returned "
                f"{type(arr).__name__}")
        if _TELEMETRY:
            _M_TCP_BYTES.inc(arr.nbytes)
        return arr, bool(used)

    def finish_op(self, deadline: Optional[float] = None) -> None:
        pass  # reply-frame drain is tracked by the ServeBoard

    def close(self) -> None:
        pass  # pooled conns are owned by the group


class ShmLink:
    """Same-node pair transport over two single-writer/single-reader
    ring channels on the node's shared-memory store segment.

    The outgoing channel is created lazily on first ``publish`` (this
    rank is its single writer); the incoming one is attached lazily on
    first ``wait`` (created by the peer).  Channel object ids derive
    deterministically from (group, incarnation nonce, src, dst), so
    both sides rendezvous without any extra control traffic and a
    re-created group can never collide with a dead incarnation's rings.

    Reads are ZERO-COPY: ``wait`` deserializes straight out of the ring
    slot and defers the slot ack until the view has been consumed (the
    returned array is valid only until the next operation on this
    link — callers that retain it must copy).  A small stash reorders
    out-of-order tags (the ring is FIFO in the *writer's* publish
    order, which pipelining may interleave differently from the
    reader's wait order).

    Writes NEVER block the algorithm thread: a publish that finds the
    ring full queues the segment on a local outbox, which is pumped
    opportunistically during waits and drained (blocking) by
    ``finish_op``.  This is what makes the self-clocked pipelined ring
    deadlock-free — a rank blocked on ring credit would stop *reading*,
    and a cycle of such ranks wedges the whole group (observed at
    64 MiB / 1 MiB segments / 4 ranks before the outbox).
    """

    kind = "shm"

    def __init__(self, store, group_name: str, nonce: str, my_rank: int,
                 peer: int, *, capacity: int, nslots: int,
                 pump_all=None):
        from ray_tpu_torch.experimental import channel as ch
        self._ch = ch
        self._store = store
        self._nonce = nonce
        self._group_name = group_name
        # pump EVERY shm link of the group, not just this one: the ring
        # publishes to the NEXT link while waits park on the PREV link,
        # so a wait that only pumped its own outbox would leave the
        # next-link's queued segments stranded (observed wedge: rank 3
        # parked on its prev with 21 segments outboxed to its next)
        self._pump_all = pump_all if pump_all is not None \
            else (lambda: self._pump_outbox())
        self.rank = my_rank
        self.peer = peer
        self._capacity = capacity
        self._nslots = nslots
        self._writer = None          # ChannelWriter (lazy create)
        self._reader = None          # ChannelReader (lazy attach)
        self._wchan = None
        self._rchan = None
        # out-of-order arrivals, FIFO per tag (p2p reuses tags); owned
        # copies, never ring views
        self._stash: Dict[str, deque] = {}
        self._outbox: deque = deque()    # (tag, arr) awaiting ring credit
        self._pending_ack = None         # deferred ack of the last wait
        self._lock = threading.Lock()

    def _oid(self, src: int, dst: int):
        seed = (f"collective:{self._group_name}:{self._nonce}:"
                f"{src}->{dst}").encode()
        return self._ch.channel_object_id(seed)

    def _ensure_writer(self):
        if self._writer is None:
            chan = self._ch.Channel.create(
                self._store, self._oid(self.rank, self.peer),
                nslots=self._nslots, nreaders=1, capacity=self._capacity)
            chan.spin_yields = 8  # see Channel.spin_yields: N ranks
            self._wchan = chan    # spinning starve the producing rank
            self._writer = self._ch.ChannelWriter(chan)
        return self._writer

    def _ensure_reader(self, deadline: Optional[float]):
        if self._reader is None:
            t = _remaining(deadline)
            chan = self._ch.Channel.attach(
                self._store, self._oid(self.peer, self.rank),
                timeout=t if t is not None else 30.0)
            chan.spin_yields = 8
            self._rchan = chan
            self._reader = self._ch.ChannelReader(chan, 0)
        return self._reader

    def _fire_ack(self) -> None:
        ack, self._pending_ack = self._pending_ack, None
        if ack is not None:
            ack()

    def _write_one(self, tag: str, arr: np.ndarray,
                   timeout: Optional[float]) -> None:
        self._writer.write((tag, arr), timeout=timeout)
        if _TELEMETRY:
            _M_SHM_BYTES.inc(arr.nbytes)

    def _pump_outbox(self) -> None:
        """Move queued segments into the ring while credit lasts; never
        blocks."""
        w = self._writer
        while self._outbox and w is not None and w.writable():
            tag, arr = self._outbox.popleft()
            self._write_one(tag, arr, timeout=0.001)

    def publish(self, tag: str, arr: np.ndarray,
                deadline: Optional[float] = None) -> None:
        """Non-blocking: a full ring queues the segment on the outbox
        (see class docstring — blocking here deadlocks the ring).  The
        caller promises ``arr`` stays valid until ``finish_op``."""
        self._ensure_writer()
        self._pump_outbox()
        if not self._outbox and self._writer.writable():
            self._write_one(tag, arr, timeout=0.001)
        else:
            self._outbox.append((tag, arr))

    def finish_op(self, deadline: Optional[float]) -> None:
        """Op-end drain: release the last read slot and push every
        outboxed segment.  Drains via the group-wide pump (a peer
        parked on one of our OTHER outboxes is what frees this ring,
        transitively) with short sleeps instead of one blocking write;
        a peer that consumed everything it needs leaves nothing here,
        so this converges unless the peer died — then the deadline
        fires."""
        with self._lock:
            self._fire_ack()
            while self._outbox:
                self._pump_all()
                if not self._outbox:
                    break
                t = _remaining(deadline)
                if t is not None and t <= 0.001:
                    raise TimeoutError(
                        f"collective shm drain to rank {self.peer} "
                        f"timed out with {len(self._outbox)} segments "
                        f"queued (peer dead or wedged)")
                time.sleep(0.002)

    def request(self, tag: str, dest: Optional[np.ndarray] = None):
        return tag  # shm reads are ordered pulls; nothing to pre-issue

    def wait(self, handle, deadline: Optional[float]
             ) -> Tuple[np.ndarray, bool]:
        """Returns (array, False).  The array may VIEW the ring slot:
        it is valid only until the next operation on this link — every
        caller consumes (reduces / copies) before touching the link
        again."""
        tag = handle
        with self._lock:
            self._fire_ack()
            self._pump_outbox()
            q = self._stash.get(tag)
            if q:
                arr = q.popleft()
                if not q:
                    del self._stash[tag]
                return arr, False
            r = self._ensure_reader(deadline)
            t0 = rtm.now()
            while True:
                # short read slices so the outbox keeps pumping while we
                # are parked: the peer may be waiting on a segment that
                # is sitting in OUR outbox
                t = _remaining(deadline)
                slice_t = 0.05 if t is None else min(0.05, t)
                try:
                    view, _flags, ack = r.read_zc(timeout=slice_t)
                except self._ch.ChannelTimeoutError:
                    self._pump_all()
                    if t is not None and t <= slice_t:
                        raise TimeoutError(
                            f"collective shm recv of {tag!r} from rank "
                            f"{self.peer} timed out")
                    continue
                got_tag, arr = ser.deserialize(view)
                if got_tag == tag:
                    self._pending_ack = ack
                    break
                # out-of-order: own the payload, release the slot
                self._stash.setdefault(got_tag, deque()).append(
                    np.array(arr, copy=True))
                ack()
            ms = (rtm.now() - t0) * 1000.0
        _M_STALL_H.observe(ms)
        _M_STALL.set_max(ms)
        return arr, False

    def consume_next(self, wanted, deadline: Optional[float]):
        """Arrival-order variant of ``wait``: returns ``(tag, arr)`` for
        the NEXT message whose tag is in ``wanted`` — zero-copy, no
        reorder-stash memcpy for in-window run-ahead.  Same view
        validity contract as ``wait``."""
        with self._lock:
            self._fire_ack()
            self._pump_outbox()
            for t in wanted:
                q = self._stash.get(t)
                if q:
                    arr = q.popleft()
                    if not q:
                        del self._stash[t]
                    return t, arr
            r = self._ensure_reader(deadline)
            t0 = rtm.now()
            while True:
                rem = _remaining(deadline)
                slice_t = 0.05 if rem is None else min(0.05, rem)
                try:
                    view, _flags, ack = r.read_zc(timeout=slice_t)
                except self._ch.ChannelTimeoutError:
                    self._pump_all()
                    if rem is not None and rem <= slice_t:
                        raise TimeoutError(
                            f"collective shm recv (any of "
                            f"{len(wanted)} tags) from rank "
                            f"{self.peer} timed out")
                    continue
                got_tag, arr = ser.deserialize(view)
                if got_tag in wanted:
                    self._pending_ack = ack
                    break
                # beyond-window run-ahead or p2p interleave: own it
                self._stash.setdefault(got_tag, deque()).append(
                    np.array(arr, copy=True))
                ack()
            ms = (rtm.now() - t0) * 1000.0
        _M_STALL_H.observe(ms)
        _M_STALL.set_max(ms)
        return got_tag, arr

    def drop_stashed_below(self, seq_floor: int) -> None:
        """Mailbox-style hygiene for the reorder stash."""
        with self._lock:
            self._fire_ack()
            for t in [t for t in self._stash
                      if (tag_seq(t) or seq_floor) < seq_floor]:
                del self._stash[t]

    def close(self) -> None:
        # poison FIRST, without the lock: a parked wait holds the lock
        # for its whole blocking loop, and the poison stamp is exactly
        # what makes it unwind — taking the lock first would block
        # destroy behind the op deadline
        for chan in (self._wchan, self._rchan):
            if chan is not None:
                try:
                    chan.poison(self._ch.POISON_TEARDOWN)
                except Exception:
                    pass
        with self._lock:   # waits out the unwinding parked op
            self._pending_ack = None
            self._outbox.clear()
            wchan, self._wchan = self._wchan, None
            rchan, self._rchan = self._rchan, None
            self._writer = self._reader = None
        for chan in (wchan, rchan):
            if chan is not None:
                try:
                    chan.close()
                except Exception:
                    pass
        if wchan is not None:
            wchan.delete()  # creator removes its own ring object


class ShmArena:
    """Node-local flat allreduce plane: when EVERY rank of a group
    lives on one node, the segmented ring is pure overhead — each rank
    instead writes its flat input ONCE into its persistent shared-
    memory slab, reduces its own chunk directly from all peers' mapped
    slabs into a shared result slab (single writer per region,
    channel-style sealed-then-mutated), and copies the finished result
    out.  Per-rank data movement is one input write + one chunk reduce
    + one result read, all at memory bandwidth with no per-segment
    protocol, which beats the shm ring ~2x on CPU-starved hosts
    (docs/collective.md).

    Slabs are PERSISTENT and reused across ops (keyed by rank and a
    power-of-two size bucket every rank derives identically from the
    tensor size): on this class of VM a first-touch tmpfs page fault
    runs ~80x slower than a warm write (the object_store_prefault
    rationale), so per-op object churn would pay cold faults on every
    single op.

    Synchronization rides a tiny control object (u64 poison + per-rank
    u64 input-ready / reduced / copied-out words, one writer each,
    x86-TSO publication ordering exactly like experimental/channel.py),
    counted by an ARENA-LOCAL op number (the group's op sequence also
    advances on non-arena ops).  The copied-out word is load-bearing:
    before touching any slab for op N, a rank waits until every peer
    copied op N-1's result out — without it, a fast rank's next input/
    region write races a lagging rank's result read (silent
    corruption; no test with driver-side barriers between ops would
    catch it, but back-to-back sync_gradients calls would hit it).
    """

    def __init__(self, store, group_name: str, nonce: str, rank: int,
                 ranks: List[int]):
        self._store = store
        self._group = group_name
        self._nonce = nonce
        self.rank = rank
        self._ranks = sorted(ranks)
        self._idx = self._ranks.index(rank)
        self._leader = self._ranks[0]
        self._ctl = None             # pinned memoryview of the control obj
        self._slabs: Dict[Tuple[int, int], Tuple[Any, memoryview]] = {}
        self._pending_delete: List[Any] = []
        self._op = 0                 # arena-local op number (all ranks
        self._closed = False         # call arena ops in the same order)

    def _oid(self, kind: str, a: int = 0, b: int = 0):
        from ray_tpu_torch.experimental.channel import channel_object_id
        seed = (f"colarena:{self._group}:{self._nonce}:"
                f"{kind}:{a}:{b}").encode()
        return channel_object_id(seed)

    def _ensure_ctl(self, deadline: Optional[float]):
        if self._ctl is not None:
            return self._ctl
        oid = self._oid("ctl")
        size = 8 + 24 * len(self._ranks)
        if self.rank == self._leader:
            buf = self._store.create(oid, size, meta=0, allow_evict=False)
            buf[:size] = bytes(size)
            buf.release()
            self._store.seal(oid)
        t = _remaining(deadline)
        res = self._store.get(oid, timeout=t if t is not None else 30.0)
        if res is None:
            raise TimeoutError("collective shm arena: control object "
                               "never appeared (leader dead?)")
        self._ctl = res[0]
        return self._ctl

    def _slab(self, kind: str, r: int, bucket: int,
              deadline: Optional[float]) -> memoryview:
        """Attach (or create, if it is ours) the persistent slab for
        ``(kind, r, bucket)``; cached pinned view."""
        key_r = r if kind == "in" else -1
        cached = self._slabs.get((key_r, bucket))
        if cached is not None:
            return cached[1]
        oid = self._oid(kind, r, bucket)
        mine = (kind == "in" and r == self.rank) or \
               (kind == "res" and self.rank == self._leader)
        if mine:
            try:
                buf = self._store.create(oid, bucket, meta=0,
                                         allow_evict=False)
                buf.release()
                self._store.seal(oid)
            except FileExistsError:
                pass  # survived from an earlier attach cycle
            except Exception:
                # store too full for a slab (the capacity gate is
                # deterministic across ranks but blind to occupancy):
                # poison so PEERS parked on our words unwind in
                # seconds, not the op deadline; the group marks the
                # arena broken and falls back to the ring path
                self.poison()
                raise
            self._pending_delete_on_close(oid)
        t = _remaining(deadline)
        res = self._store.get(oid, timeout=t if t is not None else 60.0)
        if res is None:
            raise TimeoutError(
                f"collective shm arena: slab of rank {r} never "
                f"appeared (peer dead or its store create failed)")
        self._slabs[(key_r, bucket)] = (oid, res[0])
        return res[0]

    def _pending_delete_on_close(self, oid) -> None:
        if oid not in self._pending_delete:
            self._pending_delete.append(oid)

    def poison(self) -> None:
        """Stamp the control word so every parked arena wait unwinds
        promptly (destroy, or a rank's slab allocation failing)."""
        import struct
        if self._ctl is not None:
            try:
                struct.pack_into("<Q", self._ctl, 0, 1)
            except ValueError:
                pass

    def _poisoned(self) -> bool:
        import struct
        return (self._ctl is not None
                and struct.unpack_from("<Q", self._ctl, 0)[0] != 0)

    def _wait_word(self, word: int, seq: int,
                   deadline: Optional[float], what: str) -> None:
        import struct
        delay = 2e-5
        while struct.unpack_from("<Q", self._ctl, word)[0] < seq:
            if self._poisoned():
                raise RuntimeError(
                    "collective shm arena poisoned (group destroyed or "
                    "a rank's slab allocation failed) mid-op")
            t = _remaining(deadline)
            if t is not None and t <= 0.001:
                raise TimeoutError(
                    f"collective shm arena: {what} never ready for op "
                    f"{seq} (peer dead or wedged)")
            time.sleep(delay)
            delay = min(delay * 2, 0.002)

    def _in_word(self, idx: int) -> int:
        return 8 + 24 * idx

    def _red_word(self, idx: int) -> int:
        return 8 + 24 * idx + 8

    def _out_word(self, idx: int) -> int:
        return 8 + 24 * idx + 16

    @staticmethod
    def bucket_of(nbytes: int) -> int:
        b = 1 << 16
        while b < nbytes:
            b <<= 1
        return b

    def allreduce(self, src: np.ndarray, out: np.ndarray, reducer,
                  deadline: Optional[float]) -> None:
        """``src``: this rank's flat contiguous input (read only — no
        private working copy needed, saving one full heap copy per op);
        ``out``: flat destination the finished result lands in."""
        import struct
        ctl = self._ensure_ctl(deadline)
        m = len(self._ranks)
        self._op += 1
        seq = self._op
        bucket = self.bucket_of(src.nbytes)
        # 0. cross-op gate (see class docstring): every peer must have
        # finished COPYING the previous result out before any slab of
        # this op may be written — a peer's out-word implies its red
        # and in words, so this one wait covers input-slab reuse too
        for i in range(m):
            self._wait_word(self._out_word(i), seq - 1, deadline,
                            f"rank {self._ranks[i]} prev-op copy-out")
        # 1. write my input into my persistent slab, publish via seq word
        mine = self._slab("in", self.rank, bucket, deadline)
        np.copyto(np.frombuffer(mine, np.uint8, count=src.nbytes),
                  src.view(np.uint8))
        struct.pack_into("<Q", ctl, self._in_word(self._idx), seq)
        if _TELEMETRY:
            _M_SHM_BYTES.inc(src.nbytes)
        # 2. reduce MY chunk from every peer slab straight into the
        # shared result slab (single writer per region)
        res_np = np.frombuffer(self._slab("res", 0, bucket, deadline),
                               dtype=src.dtype, count=src.size)
        bounds = _chunk_bounds(src.size, m)
        a, b = bounds[self._idx]
        if b > a:
            np.copyto(res_np[a:b], src[a:b])
        t0 = rtm.now()
        for i, r in enumerate(self._ranks):
            if r == self.rank or b <= a:
                continue
            self._wait_word(self._in_word(i), seq, deadline,
                            f"rank {r} input")
            arr = np.frombuffer(self._slab("in", r, bucket, deadline),
                                dtype=src.dtype, count=src.size)
            reducer(res_np[a:b], arr[a:b], out=res_np[a:b])
        # 3. stamp my reduced word LAST (x86-TSO publication), then
        # copy each region out the moment its producer stamps — the
        # copy of early chunks overlaps the stragglers' reduces
        struct.pack_into("<Q", ctl, self._red_word(self._idx), seq)
        for i in range(m):
            self._wait_word(self._red_word(i), seq, deadline,
                            f"rank {self._ranks[i]} chunk")
            ca, cb = bounds[i]
            if cb > ca:
                np.copyto(out[ca:cb], res_np[ca:cb])
        # copied out: the slabs may be reused by the next op
        struct.pack_into("<Q", ctl, self._out_word(self._idx), seq)
        _M_STALL_H.observe((rtm.now() - t0) * 1000.0)

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self.poison()  # parked waiters unwind
        for oid, view in self._slabs.values():
            try:
                view.release()
                self._store.release(oid)
            except Exception:
                pass
        self._slabs.clear()
        if self._ctl is not None:
            try:
                self._ctl.release()
                self._store.release(self._oid("ctl"))
            except Exception:
                pass
            self._ctl = None
        if self.rank == self._leader:
            self._pending_delete_on_close(self._oid("ctl"))
        # best-effort: pinned-elsewhere slabs are freed when the last
        # participant closes (delete refuses while pinned)
        for oid in self._pending_delete:
            try:
                self._store.delete(oid)
            except Exception:
                pass
        self._pending_delete = []


def _chunk_bounds(nelem: int, m: int) -> List[Tuple[int, int]]:
    """np.array_split boundaries: m contiguous ranges covering nelem
    (identical on every rank; empty ranges when m > nelem).  The ONE
    definition both endpoints of every link segment by."""
    base, rem = divmod(nelem, m)
    bounds, off = [], 0
    for k in range(m):
        sz = base + (1 if k < rem else 0)
        bounds.append((off, off + sz))
        off += sz
    return bounds


class Window:
    """Sliding-window executor over ordered segment receives.

    ``push`` issues one request; once ``depth`` are outstanding it
    completes one (wait -> completion callback) before issuing more.
    Completion callbacks run on the calling thread — the per-segment
    chaining (reduce + publish of the next ring step) the pipelined
    ring is built from.

    TCP items complete in issue order (their replies land concurrently
    via the connection reader regardless, so head-blocking loses
    nothing, and the staging-slot rotation relies on it).  shm items
    complete in ARRIVAL order within their link: the ring is FIFO in
    the producer's publish order, which pipelining interleaves
    differently from our issue order — dispatching whatever arrives
    next consumes every message zero-copy instead of paying a
    reorder-stash memcpy per out-of-order segment.
    """

    def __init__(self, depth: int, deadline: Optional[float]):
        self.depth = max(1, depth)
        self.deadline = deadline
        self._tcp: deque = deque()       # (link, handle, done) FIFO
        self._shm: Dict[Any, Dict[str, Any]] = {}  # link -> {tag: done}
        self._order: deque = deque()     # None = tcp head, else shm link
        self._outstanding = 0

    def push(self, link, tag: str, dest: Optional[np.ndarray],
             done) -> None:
        while self._outstanding >= self.depth:
            self._complete_one()
        if isinstance(link, ShmLink):
            self._shm.setdefault(link, {})[tag] = done
            self._order.append(link)
        else:
            h = link.request(tag, dest)
            self._tcp.append((link, h, done))
            self._order.append(None)
        self._outstanding += 1

    def drain(self) -> None:
        while self._outstanding:
            self._complete_one()

    def _complete_one(self) -> None:
        ent = self._order.popleft()
        if ent is None:
            link, h, done = self._tcp.popleft()
            arr, in_place = link.wait(h, self.deadline)
            done(arr, in_place)
        else:
            cbs = self._shm[ent]
            tag, arr = ent.consume_next(cbs.keys(), self.deadline)
            done = cbs.pop(tag)
            done(arr, False)
        self._outstanding -= 1
