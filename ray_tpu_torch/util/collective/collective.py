"""Host-level (DCN) collective groups: a zero-copy pipelined data plane
(the port's copy of ray_tpu/util/collective/collective.py).

Design notes (vs the reference's NCCL/Gloo groups, Ray's
python/ray/util/collective/collective_group/):

- Rendezvous rides the GCS KV (the reference uses a named actor store):
  rank 0 publishes a per-incarnation **nonce** that namespaces every
  address key (``collective/<group>/<nonce>/<rank>``), so re-creating a
  group with a previously-used name can never rendezvous against a dead
  incarnation's stale address; each rank publishes its listening
  address + node id and polls for the full ring.
- allreduce/reducescatter/allgather use the bandwidth-optimal ring
  algorithm (2*(N-1) steps, each moving 1/N of the data), the same
  schedule NCCL uses — **pipelined**: tensors are segmented into
  ``collective_chunk_bytes`` pieces chained per segment, so step k+1's
  send overlaps step k's recv+reduce (docs/collective.md).
- Transports (ray_tpu/util/collective/transport.py): same-node ranks
  exchange segments over shared-memory ring channels; cross-node pairs
  use receiver-driven TCP pull links whose replies land via
  ``recv_into`` buffer sinks directly in the consumer's accumulator /
  output buffer (zero-copy, docs/rpc_fastpath.md).
- Small tensors (<= ``collective_small_max_bytes``) take a latency-
  optimal recursive-doubling path; colocated ranks take a hierarchical
  two-level path (intra-node shm reduce -> inter-node leader ring ->
  intra-node shm broadcast); large ``broadcast()`` payloads ride the
  multi-source object-transfer plane (docs/object_transfer.md), every
  completed rank becoming an additional source.
- Tensors are numpy arrays (torch tensors, on the CPU or the card, are
  copied to the host on the way in and returned as numpy).  ray_tpu's
  in-graph mesh path (``ici.py``, ``register_ici_mesh``) waits for
  multi-device training (``MULTI_DEVICE``).
"""

from __future__ import annotations

import json
import pickle
import queue
import sys
import threading
import time
import uuid
from collections import deque
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ray_tpu_torch._private import rpc
from ray_tpu_torch._private import runtime_metrics as rtm
from ray_tpu_torch._private.config import CONFIG
from ray_tpu_torch.air.config import MULTI_DEVICE
from ray_tpu_torch.runtime.core_worker import get_global_worker
from ray_tpu_torch.util.collective import quant as _quant
from ray_tpu_torch.util.collective.transport import (_M_TCP_BYTES, ServeBoard,
                                               ShmArena, ShmLink, TcpLink,
                                               Window, _chunk_bounds,
                                               _remaining, count_wire,
                                               tag_seq)


class ReduceOp:
    SUM = "sum"
    PRODUCT = "product"
    MIN = "min"
    MAX = "max"


_REDUCERS = {
    ReduceOp.SUM: np.add,
    ReduceOp.PRODUCT: np.multiply,
    ReduceOp.MIN: np.minimum,
    ReduceOp.MAX: np.maximum,
}

_groups: Dict[str, Any] = {}
_groups_lock = threading.Lock()
# slot sentinel held while a _Group is under construction: the duplicate-
# name check and the insert form one atomic claim, so two racing
# init_collective_group calls can never both construct (and leak) a group
_PENDING = object()

# per-op/per-algorithm telemetry (docs/collective.md)
_BYTES_BOUNDARIES = tuple(float(1 << s) for s in range(10, 31, 2))
_M_OP_MS = rtm.histogram_family(
    "ray_tpu_collective_op_ms",
    "collective op latency by op/algorithm (ms)", tag_key="op")
_M_OP_BYTES = rtm.histogram_family(
    "ray_tpu_collective_op_bytes",
    "collective op tensor payload bytes by op/algorithm", tag_key="op",
    boundaries=_BYTES_BOUNDARIES)
_M_BCAST_STORE = rtm.counter(
    "ray_tpu_collective_bcast_store_total",
    "broadcasts routed over the multi-source object-transfer plane")
# backward-overlap accounting (docs/collective.md): per async op, how
# long the wire work ran vs how long the caller actually blocked in
# ``result()`` — the difference is comm time hidden behind compute
_M_OVERLAP_HIDDEN = rtm.histogram(
    "ray_tpu_collective_overlap_hidden_ms",
    "per async collective op: comm time hidden behind caller compute "
    "(op wall time minus time blocked in result())")
_M_OVERLAP_WAIT = rtm.histogram(
    "ray_tpu_collective_overlap_wait_ms",
    "per async collective op: time the caller blocked in result()")

# COLLECTIVE timeline slices: cap per group so chatty training loops
# can't grow the GCS task table without bound (same rationale as the
# 256-instants-per-stream cap, docs/observability.md)
_TIMELINE_OPS_CAP = 256


def _as_numpy(tensor: Any) -> np.ndarray:
    """numpy as it is; a torch tensor (CPU or card) copied to the host,
    bf16 as fp32 (numpy has no bfloat16)."""
    if isinstance(tensor, np.ndarray):
        return tensor
    torch = sys.modules.get("torch")
    if torch is not None and torch.is_tensor(tensor):
        t = tensor.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy()
    return np.asarray(tensor)


# _remaining / _chunk_bounds come from transport.py: both endpoints of
# every link must derive identical segmentation, so there is exactly
# one definition




class AsyncWork:
    """Completion handle for a collective op enqueued with
    ``allreduce_async`` (the chained-completion API backward-overlapped
    gradient sync rides, docs/collective.md).

    ``result()`` blocks until the op ran on the group's async worker
    thread and returns (or re-raises) its outcome.  The first
    ``result()`` call also settles the overlap telemetry: the op's wall
    time minus the time actually spent blocked here is comm that was
    hidden behind the caller's compute."""

    def __init__(self):
        self._ev = threading.Event()
        self._res: Any = None
        self._exc: Optional[BaseException] = None
        self._t0 = rtm.now()          # enqueue time
        self._t_done = 0.0
        self._observed = False

    def done(self) -> bool:
        return self._ev.is_set()

    def comm_ms(self) -> Optional[float]:
        """Enqueue-to-completion wall time; None while in flight."""
        if not self._ev.is_set():
            return None
        return (self._t_done - self._t0) * 1000.0

    def result(self, timeout: Optional[float] = None) -> Any:
        t0 = rtm.now()
        if not self._ev.wait(timeout):
            raise TimeoutError("collective async op result timed out")
        if not self._observed:
            self._observed = True
            wait_ms = (rtm.now() - t0) * 1000.0
            _M_OVERLAP_WAIT.observe(wait_ms)
            _M_OVERLAP_HIDDEN.observe(
                max(0.0, (self.comm_ms() or 0.0) - wait_ms))
        if self._exc is not None:
            raise self._exc
        return self._res

    def _finish(self, res: Any, exc: Optional[BaseException]) -> None:
        self._res, self._exc = res, exc
        self._t_done = rtm.now()
        self._ev.set()


class _StagingPool:
    """``depth`` reusable receive buffers for in-flight reduce segments.

    Slot rotation is safe because the Window processes completions in
    issue order: slot j is handed out again only after item j-depth has
    been fully consumed."""

    def __init__(self, depth: int, seg_elems: int, dtype):
        self._bufs = [np.empty(seg_elems, dtype) for _ in range(depth)]
        self._i = 0

    def take(self, elems: int) -> np.ndarray:
        buf = self._bufs[self._i % len(self._bufs)]
        self._i += 1
        return buf[:elems]


class _Mailbox:
    """Incoming push messages keyed by (src_rank, tag).

    Hygiene (ISSUE 6): queues are deques (O(1) pop), and messages whose
    tag belongs to an op older than the group's current op sequence are
    dropped on arrival — a recv that timed out can no longer leave its
    late-arriving message queued forever to poison the next op that
    reuses the (src, tag) slot.  Unsequenced tags (p2p) are exempt."""

    def __init__(self, group: str = "", rank: int = -1):
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._msgs: Dict[Tuple[int, str], deque] = {}
        self._floor = 0
        self._closed = False
        self._group = group
        self._rank = rank

    def put(self, src: int, tag: str, payload: Any) -> None:
        seq = tag_seq(tag)
        with self._cv:
            if self._closed:
                return
            if seq is not None and seq < self._floor:
                return  # stale: its op already finished or timed out
            self._msgs.setdefault((src, tag), deque()).append(payload)
            self._cv.notify_all()

    def get(self, src: int, tag: str, timeout: float) -> Any:
        deadline = time.monotonic() + timeout
        with self._cv:
            while True:
                if self._closed:
                    raise RuntimeError("collective group destroyed")
                q = self._msgs.get((src, tag))
                if q:
                    msg = q.popleft()
                    if not q:
                        del self._msgs[(src, tag)]
                    return msg
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    # the likeliest cause is ``src`` dying mid-op: emit
                    # the rank-death event before unwinding so the
                    # cluster event table explains the op failure
                    # (docs/observability.md)
                    from ray_tpu_torch._private import cluster_events as cev
                    cev.emit(cev.COLLECTIVE_RANK_DEATH,
                             f"group {self._group!r} rank {self._rank}: "
                             f"recv from rank {src} timed out "
                             f"(tag={tag}) — peer dead or stalled",
                             severity="ERROR", group=self._group,
                             rank=self._rank, src_rank=src)
                    raise TimeoutError(
                        f"collective recv (src={src}, tag={tag}) timed out")
                self._cv.wait(remaining)

    def expire_below(self, seq_floor: int) -> None:
        with self._cv:
            self._floor = seq_floor
            for key in [k for k in self._msgs
                        if (tag_seq(k[1]) or seq_floor) < seq_floor]:
                del self._msgs[key]

    def close(self) -> None:
        with self._cv:
            self._closed = True
            self._msgs.clear()
            self._cv.notify_all()


class _Group:
    def __init__(self, name: str, world_size: int, rank: int,
                 timeout: float = 60.0):
        self.name = name
        self.world_size = world_size
        self.rank = rank
        self.timeout = timeout
        worker = get_global_worker()
        self._worker = worker
        self._store = getattr(worker, "store", None)
        self._node = getattr(worker, "node_id", "")
        self._mailbox = _Mailbox(name, rank)
        self._board = ServeBoard()
        # "msg" never blocks (mailbox append): inline on the reader.
        # "take" stays POOLED: an already-published entry resolves its
        # reply inside the handler, and that send can block on a
        # saturated socket — blocking the reader thread would deadlock
        # a full-duplex ring under load.
        self._server = rpc.Server(self._handle,
                                  fast_methods=("msg", "rdv"))
        self._conns: Dict[int, rpc.Connection] = {}
        self._conns_lock = threading.Lock()
        self._links: Dict[int, Any] = {}
        self._links_lock = threading.Lock()
        self._seq = 0
        self._op_lock = threading.Lock()
        self._op_count = 0
        self._destroyed = threading.Event()
        # backward-overlap engine: ops enqueued with allreduce_async run
        # FIFO on one worker thread (started lazily), so every rank
        # executes async ops in enqueue order — the cross-rank op-order
        # agreement the tag protocol requires
        self._async_q: Optional[queue.Queue] = None
        self._async_thread: Optional[threading.Thread] = None
        self._async_lock = threading.Lock()
        # intra-slice in-graph reduction hook (register_ici_mesh): when
        # set, the topology schedule reduces SUM ops across the slice
        # inside a compiled program instead of over host links
        self._ici_reduce = None
        try:
            self._rendezvous()
        except BaseException:
            self._server.stop()
            raise

    # ------------------------------------------------------------ plumbing
    def _handle(self, conn: rpc.Connection, method: str, p: Any) -> Any:
        if method == "msg":
            self._mailbox.put(p["src"], p["tag"], p["data"])
            return True
        if method == "take":
            return self._board.take(p["src"], p["tag"])
        if method == "rdv":
            # rendezvous confirmation: a joiner accepts a collected
            # address set only after rank 0 (always part of the live
            # incarnation) acknowledges the nonce — a dead
            # incarnation's complete key set can't satisfy this (its
            # rank 0 is gone or answers with a different nonce)
            return p.get("nonce") == self.nonce
        raise rpc.RpcError(f"collective: unknown method {method}")

    def _rendezvous(self) -> None:
        gcs = self._worker.gcs
        base = f"collective/{self.name}"
        deadline = time.monotonic() + self.timeout
        if self.rank == 0:
            # fresh incarnation: sweep every key of prior incarnations
            # FIRST (their addresses may belong to dead ranks), then
            # publish the nonce that namespaces this one's keys
            try:
                for k in gcs.kv_keys(base + "/"):
                    gcs.kv_del(k)
            except Exception:
                pass
            self.nonce = uuid.uuid4().hex[:12]
            gcs.kv_put(f"{base}/nonce", self.nonce.encode())
        else:
            self.nonce = self._poll_nonce(gcs, base, deadline)
        # each rank publishes its slice label alongside the address: the
        # topology scheduler groups ranks by slice without extra control
        # traffic (the label mirrors the raylet's "slice" node label,
        # docs/collective.md)
        me = json.dumps([self._server.address[0],
                         int(self._server.address[1]), self._node,
                         CONFIG.tpu_slice_name])
        gcs.kv_put(f"{base}/{self.nonce}/{self.rank}", me.encode())
        self._addrs: Dict[int, Tuple[str, int]] = {}
        self._nodes: Dict[int, str] = {}
        self._slices: Dict[int, str] = {}
        while len(self._addrs) < self.world_size:
            for r in range(self.world_size):
                if r in self._addrs:
                    continue
                raw = gcs.kv_get(f"{base}/{self.nonce}/{r}")
                if raw is not None:
                    vals = json.loads(raw.decode())
                    host, port, node = vals[0], vals[1], vals[2]
                    self._addrs[r] = (host, int(port))
                    self._nodes[r] = node
                    self._slices[r] = vals[3] if len(vals) > 3 else ""
            if len(self._addrs) == self.world_size:
                if self.rank == 0 or self._confirm_rank0():
                    break
                # a complete-looking key set under a dead incarnation's
                # nonce: rank 0 never confirmed it — rejoin below
                self._addrs.clear()
                self._nodes.clear()
                self._slices.clear()
            if self.rank != 0:
                # a rank that read a dead incarnation's leftover nonce
                # migrates the moment rank 0 publishes the fresh one
                raw = gcs.kv_get(f"{base}/nonce")
                cur = raw.decode() if raw is not None else None
                if cur is not None and cur != self.nonce:
                    gcs.kv_del(f"{base}/{self.nonce}/{self.rank}")
                    self.nonce = cur
                    gcs.kv_put(f"{base}/{cur}/{self.rank}", me.encode())
                    self._addrs.clear()
                    self._nodes.clear()
                    self._slices.clear()
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"collective group {self.name!r}: only "
                    f"{len(self._addrs)}/{self.world_size} ranks showed")
            time.sleep(0.05)

    def _confirm_rank0(self) -> bool:
        """Joiner-side rendezvous confirmation (see the ``rdv``
        handler): True only when the rank-0 address we collected
        answers AND acknowledges our nonce."""
        try:
            conn = rpc.connect(self._addrs[0], timeout=2.0)
        except (OSError, ConnectionError):
            return False
        try:
            return bool(conn.call("rdv", {"nonce": self.nonce},
                                  timeout=5.0))
        except Exception:
            return False
        finally:
            conn.close()

    def _poll_nonce(self, gcs, base: str, deadline: float) -> str:
        while True:
            raw = gcs.kv_get(f"{base}/nonce")
            if raw is not None:
                return raw.decode()
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"collective group {self.name!r}: rank 0 never "
                    f"published the rendezvous nonce")
            time.sleep(0.05)

    def _conn_to(self, peer: int) -> rpc.Connection:
        with self._conns_lock:
            conn = self._conns.get(peer)
            if conn is None or conn.closed:
                conn = rpc.connect(self._addrs[peer])
                self._conns[peer] = conn
            return conn

    def _link(self, peer: int):
        with self._links_lock:
            ln = self._links.get(peer)
            if ln is None:
                win = max(1, CONFIG.collective_inflight_segments)
                if (CONFIG.collective_shm_enabled
                        and self._store is not None
                        and self._nodes.get(peer) == self._node):
                    ln = ShmLink(
                        self._store, self.name, self.nonce, self.rank,
                        peer,
                        capacity=self._seg_bytes() + 4096,
                        nslots=max(CONFIG.collective_shm_slots, win + 2),
                        # waits pump EVERY shm outbox of the group: the
                        # segment a parked peer needs may be queued on a
                        # different link than the one being waited on
                        pump_all=self._pump_shm_outboxes)
                else:
                    ln = TcpLink(self, peer)
                self._links[peer] = ln
            return ln

    def _pump_shm_outboxes(self) -> None:
        """Non-blocking: move queued segments of EVERY shm link into
        their rings while credit lasts (called from wait slices and the
        op-end drain; single op thread, so no cross-link locking)."""
        with self._links_lock:
            links = list(self._links.values())
        for ln in links:
            if isinstance(ln, ShmLink):
                ln._pump_outbox()

    # ------------------------------------------------------- op lifecycle
    def _begin(self) -> Tuple[int, float, float]:
        if self._destroyed.is_set():
            raise RuntimeError(
                f"collective group {self.name!r} is destroyed")
        self._seq += 1
        seq = self._seq
        # hygiene: anything still parked/queued for older ops belongs to
        # a peer that timed out — fail/drop it instead of letting it
        # poison this op's tag space
        self._mailbox.expire_below(seq)
        self._board.sweep_below(seq)
        with self._links_lock:
            links = list(self._links.values())
        for ln in links:
            if isinstance(ln, ShmLink):
                ln.drop_stashed_below(seq)
        deadline = time.monotonic() + CONFIG.collective_op_timeout_s
        return seq, deadline, rtm.now()

    def _end(self, op: str, algo: str, nbytes: int, deadline: float,
             t0: float) -> None:
        # shm links: release the last read slot and drain outboxed
        # segments peers are still parked on
        with self._links_lock:
            links = list(self._links.values())
        for ln in links:
            ln.finish_op(deadline)
        # published stable frames reference this op's buffers: wait for
        # every peer to collect AND for the frames to drain to the
        # socket before the caller may mutate/free them
        self._board.wait_clear(deadline)
        label = f"{op}/{algo}"
        _M_OP_MS.observe_since(label, t0)
        _M_OP_BYTES.observe(label, float(nbytes))
        self._timeline(op, algo, nbytes, t0)

    def _timeline(self, op: str, algo: str, nbytes: int,
                  t0: float) -> None:
        if self._op_count >= _TIMELINE_OPS_CAP:
            return
        self._op_count += 1
        events = getattr(self._worker, "events", None)
        if events is None:
            return
        try:
            events.record(
                f"col-{self.name}-r{self.rank}", "COLLECTIVE",
                name=f"collective:{self.name}",
                dur_ms=round((rtm.now() - t0) * 1000.0, 3),
                bytes=int(nbytes), op=op, algo=algo,
                world=self.world_size, node_id=self._node,
                worker_id=self._worker.worker_id.hex())
        except Exception:
            pass

    def _seg_bytes(self) -> int:
        """Segment size for this group's ops: the configured chunk,
        capped at the shm slot size when any ranks are colocated (shm
        ring slots are sized for the cap, and both endpoints of every
        pair must derive the same segmentation)."""
        chunk = CONFIG.collective_chunk_bytes
        if (CONFIG.collective_shm_enabled and self._store is not None
                and len(set(self._nodes.values())) < self.world_size):
            return min(chunk, CONFIG.collective_shm_slot_bytes)
        return chunk

    def _seg_elems_of(self, itemsize: int) -> int:
        return max(1, self._seg_bytes() // max(1, itemsize))

    def _arena(self) -> ShmArena:
        if getattr(self, "_arena_inst", None) is None:
            self._arena_inst = ShmArena(
                self._store, self.name, self.nonce, self.rank,
                list(range(self.world_size)))
        return self._arena_inst

    def _flat_shm_ok(self, nbytes: int) -> bool:
        """Deterministic across ranks: config + topology + the shared
        segment's fixed capacity (identical on every local rank), never
        current occupancy.  Occupancy blindness is backstopped at slab
        allocation: a failing rank poisons the arena (peers unwind in
        seconds) and every rank flips to the ring for later ops."""
        if getattr(self, "_arena_broken", False):
            return False
        if not (CONFIG.collective_shm_enabled and CONFIG.collective_flat_shm
                and self._store is not None
                and len(set(self._nodes.values())) == 1):
            return False
        try:
            cap = self._store.stats()["capacity"]
        except Exception:
            return False
        return (self.world_size + 1) * nbytes * 2.5 <= cap

    def _hier_worthwhile(self, reducer=None) -> bool:
        """Hierarchy only pays when the topology collapses ranks:
        several groups AND colocated ranks cut DCN traffic, or a
        registered in-graph (ICI) reducer can absorb a multi-rank slice
        entirely (SUM ops; ``register_ici_mesh`` must run on every rank
        of the group so all ranks reach the same verdict).  A flat
        single-node group is better off on the ring — funneling every
        byte through one leader process serializes the reduction work
        the ring spreads across ranks."""
        groups = self._topo_groups()
        if (self._ici_reduce is not None and reducer is np.add
                and bool(CONFIG.collective_topology)
                and len(groups) < self.world_size):
            return True
        return 1 < len(groups) < self.world_size

    def _topo_engaged(self) -> bool:
        """True when the slice-aware schedule actually differs from the
        2-level node grouping (slice labels collapse nodes, or an ICI
        reducer is registered)."""
        if not CONFIG.collective_topology:
            return False
        if self._ici_reduce is not None:
            return True
        return len(self._topo_groups()) != len(set(self._nodes.values()))

    # ------------------------------------------------- small-tensor plane
    def _small_send(self, peer: int, tag: str, arr: np.ndarray,
                    deadline: float) -> None:
        ln = self._link(peer)
        if isinstance(ln, ShmLink):
            ln.publish(tag, arr, deadline)
            return
        conn = self._conn_to(peer)
        conn.call_async("msg",
                        {"src": self.rank, "tag": tag, "data": arr})
        _M_TCP_BYTES.inc(arr.nbytes)

    def _small_recv(self, peer: int, tag: str,
                    deadline: float) -> np.ndarray:
        ln = self._link(peer)
        if isinstance(ln, ShmLink):
            arr, _ = ln.wait(tag, deadline)
            # shm wait returns a ring-slot view valid only until the
            # next link op; small-path values are retained (rd
            # accumulators, headers) so own them here
            return np.array(arr, copy=True)
        data = self._mailbox.get(peer, tag, _remaining(deadline))
        arr = _as_numpy(data)
        _M_TCP_BYTES.inc(arr.nbytes)
        return arr

    # ------------------------------------------------------- ring engines
    # NOTE: the windowed pipelined-ring pattern below (segs helper, lazy
    # init deque, done closures, drain) recurs with schedule-offset
    # variations in reducescatter/allgather/_ring_broadcast_recv.  The
    # offsets differ subtly per op (see each docstring); factoring one
    # parameterized engine is deliberate future work — change the
    # pump/publish discipline in ALL FOUR places or in none.
    def _ring_allreduce(self, flat: np.ndarray, participants: List[int],
                        reducer, seq: int, deadline: float,
                        codec=None) -> None:
        """Pipelined ring allreduce over ``participants``, in place on
        ``flat``: reduce-scatter then allgather, each chunk segmented
        into ``collective_chunk_bytes`` pieces chained per segment —
        receiving segment (k, s) immediately reduces and publishes
        segment (k+1, s), so successive ring steps overlap (the NCCL
        schedule, full duplex).

        With a ``codec`` (quantize="int8"), every segment is encoded
        before the wire and decoded into the fp32 master accumulator
        ``flat`` on arrival: reduce-scatter hops re-encode the running
        partial sum (one bounded rounding error per hop), allgather
        hops forward the encoded bytes verbatim (zero added error) —
        see quant.py for the numerics contract."""
        m = len(participants)
        if m == 1 or flat.size == 0:
            return
        i = participants.index(self.rank)
        plink = self._link(participants[(i - 1) % m])
        nlink = self._link(participants[(i + 1) % m])
        bounds = _chunk_bounds(flat.size, m)
        se = self._seg_elems_of(flat.itemsize)
        win = Window(CONFIG.collective_inflight_segments, deadline)
        max_seg = min(se, max(1, flat.size))
        if codec is None:
            staging = _StagingPool(win.depth, max_seg, flat.dtype)
        else:
            # staging receives WIRE bytes; decode owns the payload, so
            # slot rotation stays safe under the same issue-order rule
            staging = _StagingPool(win.depth, codec.wire_nbytes(max_seg),
                                   np.uint8)

        def segs(c):
            a, b = bounds[c]
            return [(s, min(s + se, b)) for s in range(a, b, se)]

        def pub(tag, rng):
            if codec is None:
                count_wire("fp32", rng.nbytes, rng.nbytes)
                nlink.publish(tag, rng, deadline)
            else:
                wire = codec.encode(rng)
                count_wire(codec.name, wire.nbytes, rng.nbytes)
                nlink.publish(tag, wire, deadline)

        def dest_of(a, b):
            if codec is None:
                return staging.take(b - a)
            return staging.take(codec.wire_nbytes(b - a))

        # own chunk's initial publishes go out lazily, one per request
        # issued below, so a bounded shm ring can never absorb a whole
        # chunk's burst before its reader starts consuming
        init = deque((f"{seq}:rs0:{a}", flat[a:b]) for a, b in segs(i))

        def pump_init():
            if init:
                tag, arr = init.popleft()
                pub(tag, arr)

        last = m - 2

        def rs_done(k, a, b):
            def done(arr, in_place):
                rng = flat[a:b]
                if codec is not None:
                    arr = codec.decode(arr, b - a, flat.dtype)
                reducer(rng, arr, out=rng)
                if k < last:
                    pub(f"{seq}:rs{k + 1}:{a}", rng)
                else:
                    pub(f"{seq}:ag0:{a}", rng)
            return done

        def ag_done(k, a, b):
            def done(arr, in_place):
                rng = flat[a:b]
                if codec is not None:
                    if k < last:
                        # forward the encoded bytes verbatim: the copy
                        # owns them (arr may view a rotating staging
                        # slot or a shm ring slot) and no re-encode
                        # means allgather adds no per-hop error
                        fwd = np.array(arr, copy=True)
                        count_wire(codec.name, fwd.nbytes, rng.nbytes)
                        nlink.publish(f"{seq}:ag{k + 1}:{a}", fwd,
                                      deadline)
                    codec.decode(arr, b - a, flat.dtype, out=rng)
                    return
                if not in_place:
                    np.copyto(rng, arr)
                if k < last:
                    pub(f"{seq}:ag{k + 1}:{a}", rng)
            return done

        for k in range(m - 1):
            for a, b in segs((i - k - 1) % m):
                pump_init()
                win.push(plink, f"{seq}:rs{k}:{a}", dest_of(a, b),
                         rs_done(k, a, b))
        for k in range(m - 1):
            for a, b in segs((i - k) % m):
                pump_init()
                # fp32 allgather segments land straight in their final
                # position in the output buffer (recv_into zero-copy);
                # quantized ones land in wire staging and decode out
                win.push(plink, f"{seq}:ag{k}:{a}",
                         flat[a:b] if codec is None else dest_of(a, b),
                         ag_done(k, a, b))
        while init:
            pump_init()
        win.drain()

    def _topo_groups(self) -> Dict[str, List[int]]:
        """Topology grouping for this group's ranks, computed per op:
        ranks carrying a slice label (published at rendezvous) group by
        slice when ``collective_topology`` is on; unlabeled ranks group
        by node id, so an unlabeled cluster degenerates to the classic
        node-boundary grouping."""
        topo = bool(CONFIG.collective_topology)
        by: Dict[str, List[int]] = {}
        for r in range(self.world_size):
            s = self._slices.get(r, "") if topo else ""
            key = ("s:" + s) if s else ("n:" + self._nodes.get(r, ""))
            by.setdefault(key, []).append(r)
        return by

    def _hier_allreduce(self, flat: np.ndarray, reducer, seq: int,
                        deadline: float, codec=None) -> np.ndarray:
        """Topology-scheduled hierarchical allreduce
        (docs/collective.md).  Three levels, each engaged only where
        the topology collapses ranks:

        1. intra-node reduce to a per-node leader (shm links);
        2. intra-slice allreduce among the slice's node leaders — via
           the registered in-graph (ICI) reducer when one exists (SUM
           ops reduce across the whole slice inside a compiled program
           and level 1 is skipped entirely), else a host-link ring;
        3. a DCN ring among slice leaders only;

        then the result fans back out (slice leader -> node leaders ->
        node members).  Unlabeled clusters run exactly the former
        2-level node-boundary schedule (every node is its own slice,
        level 2 is empty)."""
        by_slice = self._topo_groups()
        my_slice: List[int] = []
        for rs in by_slice.values():
            if self.rank in rs:
                my_slice = sorted(rs)
                break
        slice_leaders = sorted(min(rs) for rs in by_slice.values())
        slice_leader = my_slice[0]
        by_node: Dict[str, List[int]] = {}
        for r in my_slice:
            by_node.setdefault(self._nodes.get(r, ""), []).append(r)
        local = sorted(by_node[self._nodes.get(self.rank, "")])
        leader = local[0]
        node_leaders = sorted(min(rs) for rs in by_node.values())
        use_ici = (self._ici_reduce is not None and reducer is np.add
                   and len(my_slice) > 1
                   and bool(CONFIG.collective_topology))
        se = self._seg_elems_of(flat.itemsize)
        segs = [(a, min(a + se, flat.size))
                for a in range(0, flat.size, se)]
        max_seg = min(se, max(1, flat.size))

        def pool(depth):
            if codec is None:
                return _StagingPool(depth, max_seg, flat.dtype)
            return _StagingPool(depth, codec.wire_nbytes(max_seg),
                                np.uint8)

        def fan_out(tag_fn, targets):
            """Publish every segment to every target; quantized
            payloads are encoded ONCE per segment and the same wire
            array rides every link."""
            if not targets:
                return
            links = [self._link(t) for t in targets]
            for a, b in segs:
                rng = flat[a:b]
                payload = rng if codec is None else codec.encode(rng)
                name = "fp32" if codec is None else codec.name
                for ln in links:
                    count_wire(name, payload.nbytes, rng.nbytes)
                    ln.publish(tag_fn(a), payload, deadline)

        def recv_into(win, ln, tag, a, b, staging):
            """Window-push a receive that lands (decoded) in
            ``flat[a:b]``."""
            if codec is None:
                def done(arr, in_place, a=a, b=b):
                    if not in_place:
                        np.copyto(flat[a:b], arr)
                win.push(ln, tag, flat[a:b], done)
            else:
                def done(arr, in_place, a=a, b=b):
                    codec.decode(arr, b - a, flat.dtype, out=flat[a:b])
                win.push(ln, tag, staging.take(codec.wire_nbytes(b - a)),
                         done)

        def recv_reduce(win, ln, tag, a, b, staging):
            if codec is None:
                def done(arr, in_place, a=a, b=b):
                    rng = flat[a:b]
                    reducer(rng, arr, out=rng)
                win.push(ln, tag, staging.take(b - a), done)
            else:
                def done(arr, in_place, a=a, b=b):
                    rng = flat[a:b]
                    reducer(rng, codec.decode(arr, b - a, flat.dtype),
                            out=rng)
                win.push(ln, tag, staging.take(codec.wire_nbytes(b - a)),
                         done)

        if use_ici:
            # level 1+2 collapse into one in-graph reduction: every
            # slice rank contributes and receives the slice sum with
            # zero host-link bytes
            reduced = self._ici_reduce(flat)
            np.copyto(flat, np.asarray(reduced,
                                       dtype=flat.dtype).reshape(-1))
            if len(slice_leaders) > 1:
                if self.rank == slice_leader:
                    self._ring_allreduce(flat, slice_leaders, reducer,
                                         seq, deadline, codec)
                    fan_out(lambda a: f"{seq}:hb:{a}",
                            [r for r in my_slice if r != self.rank])
                else:
                    win = Window(CONFIG.collective_inflight_segments,
                                 deadline)
                    staging = pool(win.depth)
                    ln = self._link(slice_leader)
                    for a, b in segs:
                        recv_into(win, ln, f"{seq}:hb:{a}", a, b,
                                  staging)
                    win.drain()
            return flat

        if self.rank != leader:
            # node member: contribute to my node leader, receive the
            # finished result back
            ln = self._link(leader)
            fan_out(lambda a: f"{seq}:hr{self.rank}:{a}", [leader])
            win = Window(CONFIG.collective_inflight_segments, deadline)
            staging = pool(win.depth)
            for a, b in segs:
                recv_into(win, ln, f"{seq}:hb:{a}", a, b, staging)
            win.drain()
            return flat
        # level 1: star-reduce my node's members
        if local[1:]:
            win = Window(CONFIG.collective_inflight_segments, deadline)
            staging = pool(win.depth)
            for a, b in segs:
                for mr in local[1:]:
                    recv_reduce(win, self._link(mr),
                                f"{seq}:hr{mr}:{a}", a, b, staging)
            win.drain()
        # level 2: intra-slice ring among this slice's node leaders
        # (host links; disjoint from the DCN ring's link set, so the
        # shared per-op tag space cannot collide)
        if len(node_leaders) > 1:
            self._ring_allreduce(flat, node_leaders, reducer, seq,
                                 deadline, codec)
        # level 3: DCN ring among slice leaders only
        if self.rank == slice_leader and len(slice_leaders) > 1:
            self._ring_allreduce(flat, slice_leaders, reducer, seq,
                                 deadline, codec)
        # fan back out: slice leader -> other node leaders of my slice
        if len(slice_leaders) > 1 and len(node_leaders) > 1:
            if self.rank == slice_leader:
                fan_out(lambda a: f"{seq}:hs:{a}",
                        [r for r in node_leaders if r != self.rank])
            else:
                win = Window(CONFIG.collective_inflight_segments,
                             deadline)
                staging = pool(win.depth)
                ln = self._link(slice_leader)
                for a, b in segs:
                    recv_into(win, ln, f"{seq}:hs:{a}", a, b, staging)
                win.drain()
        # node leader -> node members
        fan_out(lambda a: f"{seq}:hb:{a}", local[1:])
        return flat

    def _rd_allreduce(self, flat: np.ndarray, reducer, seq: int,
                      deadline: float) -> np.ndarray:
        """Latency-optimal recursive doubling for small tensors:
        log2(N) whole-tensor exchange rounds (non-power-of-2 handled by
        folding the extra ranks into the power-of-2 core first)."""
        n, r = self.world_size, self.rank
        p = 1 << (n.bit_length() - 1)
        extra = n - p
        acc = flat
        if r >= p:
            self._small_send(r - p, f"{seq}:rdi", acc, deadline)
            return self._small_recv(r - p, f"{seq}:rdo", deadline)
        if r < extra:
            inc = self._small_recv(r + p, f"{seq}:rdi", deadline)
            acc = reducer(acc, inc)
        k = 1
        while k < p:
            partner = r ^ k
            self._small_send(partner, f"{seq}:rdx{k}", acc, deadline)
            inc = self._small_recv(partner, f"{seq}:rdx{k}", deadline)
            acc = reducer(acc, inc)
            k <<= 1
        if r < extra:
            self._small_send(r + p, f"{seq}:rdo", acc, deadline)
        return acc

    # ---------------------------------------------------------- primitives
    def allreduce(self, tensor: Any, op: str = ReduceOp.SUM,
                  quantize: Optional[str] = None) -> np.ndarray:
        x = _as_numpy(tensor)
        # resolve the codec FIRST so an unknown name fails loudly even
        # on sizes that would bypass quantization
        codec = _quant.get_codec(quantize, CONFIG.collective_quant_block)
        if codec is not None and not np.issubdtype(x.dtype, np.floating):
            raise ValueError(
                f"quantize={quantize!r} requires a floating dtype, "
                f"got {x.dtype} (integer reductions must stay exact)")
        if self.world_size == 1:
            return x.copy()
        if codec is not None and x.nbytes <= max(
                CONFIG.collective_quant_min_bytes,
                CONFIG.collective_small_max_bytes):
            # too small to amortize encode + scale overhead; the
            # threshold is config + tensor size, so every rank nulls
            # the codec identically (callers must pass the same
            # quantize= on every rank, like op=)
            codec = None
        reducer = _REDUCERS[op]
        with self._op_lock:
            seq, deadline, t0 = self._begin()
            if codec is None \
                    and x.nbytes > CONFIG.collective_small_max_bytes \
                    and self._flat_shm_ok(x.nbytes):
                # the arena reads the input slab-side: no private
                # working copy needed
                algo = "flatshm"
                src = np.ascontiguousarray(x).reshape(-1)
                out = np.empty_like(src)
                try:
                    self._arena().allreduce(src, out, reducer, deadline)
                except Exception:
                    # slab allocation failure / poison: THIS op fails on
                    # every rank (the poison propagates), later ops take
                    # the ring — all ranks converge on the same verdict
                    self._arena_broken = True
                    raise
                self._end("allreduce", algo, x.nbytes, deadline, t0)
                return out.reshape(x.shape)
            flat = np.array(x, copy=True).reshape(-1)
            if flat.nbytes <= CONFIG.collective_small_max_bytes:
                algo = "rd"  # codec is always None here (size gate)
                out = self._rd_allreduce(flat, reducer, seq, deadline)
            elif CONFIG.collective_hierarchical \
                    and self._hier_worthwhile(reducer):
                algo = "topo" if self._topo_engaged() else "hier"
                out = self._hier_allreduce(flat, reducer, seq, deadline,
                                           codec)
            else:
                algo = "ring"
                self._ring_allreduce(flat, list(range(self.world_size)),
                                     reducer, seq, deadline, codec)
                out = flat
            if codec is not None:
                algo = f"{algo}-{codec.name}"
            self._end("allreduce", algo, x.nbytes, deadline, t0)
        if not out.flags.writeable:
            out = out.copy()
        return out.reshape(x.shape)

    def reducescatter(self, tensor: Any,
                      op: str = ReduceOp.SUM) -> np.ndarray:
        """Each rank gets its reduced 1/N shard (pipelined ring
        reduce-scatter; schedule offset -1 vs allreduce's so rank r
        finishes owning chunk r, matching allgather's index==rank
        convention)."""
        x = _as_numpy(tensor)
        n, i = self.world_size, self.rank
        if n == 1:
            return x.copy()
        reducer = _REDUCERS[op]
        with self._op_lock:
            seq, deadline, t0 = self._begin()
            flat = np.array(x, copy=True).reshape(-1)
            bounds = _chunk_bounds(flat.size, n)
            se = self._seg_elems_of(flat.itemsize)
            plink = self._link((i - 1) % n)
            nlink = self._link((i + 1) % n)
            win = Window(CONFIG.collective_inflight_segments, deadline)
            staging = _StagingPool(win.depth, min(se, max(1, flat.size)),
                                   flat.dtype)

            def segs(c):
                a, b = bounds[c]
                return [(s, min(s + se, b)) for s in range(a, b, se)]

            init = deque((f"{seq}:rs0:{a}", flat[a:b])
                         for a, b in segs((i - 1) % n))
            last = n - 2

            def rs_done(k, a, b):
                def done(arr, in_place):
                    rng = flat[a:b]
                    reducer(rng, arr, out=rng)
                    if k < last:
                        nlink.publish(f"{seq}:rs{k + 1}:{a}", rng,
                                      deadline)
                return done

            for k in range(n - 1):
                for a, b in segs((i - k - 2) % n):
                    if init:
                        tag, arr = init.popleft()
                        nlink.publish(tag, arr, deadline)
                    win.push(plink, f"{seq}:rs{k}:{a}",
                             staging.take(b - a), rs_done(k, a, b))
            while init:
                tag, arr = init.popleft()
                nlink.publish(tag, arr, deadline)
            win.drain()
            a, b = bounds[i]
            out = flat[a:b].copy()
            self._end("reducescatter", "ring", x.nbytes, deadline, t0)
        return out

    def allgather(self, tensor: Any) -> List[np.ndarray]:
        x = _as_numpy(tensor)
        n, i = self.world_size, self.rank
        if n == 1:
            return [x.copy()]
        with self._op_lock:
            seq, deadline, t0 = self._begin()
            flat = np.ascontiguousarray(x).reshape(-1)
            sz = flat.size
            out = np.empty(n * sz, flat.dtype)
            np.copyto(out[i * sz:(i + 1) * sz], flat)
            se = self._seg_elems_of(flat.itemsize)
            plink = self._link((i - 1) % n)
            nlink = self._link((i + 1) % n)
            win = Window(CONFIG.collective_inflight_segments, deadline)

            def segs(c):
                a, b = c * sz, (c + 1) * sz
                return [(s, min(s + se, b)) for s in range(a, b, se)]

            init = deque((f"{seq}:ag0:{a}", out[a:b])
                         for a, b in segs(i))
            last = n - 2

            def ag_done(k, a, b):
                def done(arr, in_place):
                    rng = out[a:b]
                    if not in_place:
                        np.copyto(rng, arr)
                    if k < last:
                        nlink.publish(f"{seq}:ag{k + 1}:{a}", rng,
                                      deadline)
                return done

            for k in range(n - 1):
                for a, b in segs((i - k - 1) % n):
                    if init:
                        tag, arr = init.popleft()
                        nlink.publish(tag, arr, deadline)
                    win.push(plink, f"{seq}:ag{k}:{a}", out[a:b],
                             ag_done(k, a, b))
            while init:
                tag, arr = init.popleft()
                nlink.publish(tag, arr, deadline)
            win.drain()
            self._end("allgather", "ring", x.nbytes, deadline, t0)
        return [out[k * sz:(k + 1) * sz].reshape(x.shape)
                for k in range(n)]

    def broadcast(self, tensor: Any, src: int) -> np.ndarray:
        x = _as_numpy(tensor)
        if self.world_size == 1:
            return x
        with self._op_lock:
            seq, deadline, t0 = self._begin()
            # the source decides the route and ships it (with shape/
            # dtype, and the ObjectRef on the store route) down a chain
            # of small header messages
            n, pos = self.world_size, (self.rank - src) % self.world_size
            nxt = (self.rank + 1) % n
            prv = (self.rank - 1) % n
            if self.rank == src:
                # the store route pays off when ranks are on OTHER
                # nodes (multi-source striped pulls, every completed
                # rank another source); a same-node-only group is
                # faster on the pipelined shm ring chain
                use_store = (
                    x.nbytes >= CONFIG.collective_bcast_store_min_bytes
                    and len(set(self._nodes.values())) > 1)
                ref = None
                if use_store:
                    import ray_tpu_torch
                    ref = ray_tpu_torch.put(np.ascontiguousarray(x))
                meta = (list(x.shape), x.dtype.str,
                        "store" if use_store else "ring",
                        pickle.dumps(ref) if use_store else b"")
                hdr = np.frombuffer(pickle.dumps(meta), np.uint8)
                self._small_send(nxt, f"{seq}:bch", hdr, deadline)
                algo = "store" if use_store else "ring"
                if use_store:
                    _M_BCAST_STORE.inc()
                    out = x
                else:
                    flat = np.ascontiguousarray(x).reshape(-1)
                    self._ring_broadcast_src(flat, seq, deadline)
                    out = x
            else:
                hdr = self._small_recv(prv, f"{seq}:bch", deadline)
                shape, dtype_str, route, refb = pickle.loads(
                    bytes(hdr))
                if nxt != src:
                    self._small_send(nxt, f"{seq}:bch", hdr, deadline)
                algo = route
                if route == "store":
                    _M_BCAST_STORE.inc()
                    out = self._bcast_pull(refb, shape, dtype_str,
                                           deadline)
                else:
                    size = int(np.prod(shape)) if shape else 1
                    flat = np.empty(size, np.dtype(dtype_str))
                    self._ring_broadcast_recv(flat, pos, seq, deadline)
                    out = flat.reshape(shape)
            if algo == "store":
                # keep the source's ref alive until every rank pulled
                # (each completed rank becomes an additional source for
                # the stripers behind it)
                self._rd_allreduce(np.zeros(1, np.float32), np.add, seq,
                                   deadline)
            self._end("broadcast", algo, x.nbytes, deadline, t0)
        return out

    def _bcast_pull(self, refb: bytes, shape, dtype_str,
                    deadline: float) -> np.ndarray:
        import ray_tpu_torch
        ref = pickle.loads(refb)
        val = ray_tpu_torch.get(ref, timeout=_remaining(deadline))
        out = np.array(val, copy=True)
        del val, ref
        return out.reshape(shape)

    def _ring_broadcast_src(self, flat: np.ndarray, seq: int,
                            deadline: float) -> None:
        nlink = self._link((self.rank + 1) % self.world_size)
        se = self._seg_elems_of(flat.itemsize)
        for a in range(0, flat.size, se):
            b = min(a + se, flat.size)
            nlink.publish(f"{seq}:bc:{a}", flat[a:b], deadline)

    def _ring_broadcast_recv(self, flat: np.ndarray, pos: int, seq: int,
                             deadline: float) -> None:
        """Pipelined chain forward: each landed segment is immediately
        republished to the next hop while later segments are still in
        flight."""
        n = self.world_size
        plink = self._link((self.rank - 1) % n)
        forward = pos < n - 1
        nlink = self._link((self.rank + 1) % n) if forward else None
        se = self._seg_elems_of(flat.itemsize)
        win = Window(CONFIG.collective_inflight_segments, deadline)
        for a in range(0, flat.size, se):
            b = min(a + se, flat.size)

            def done(arr, in_place, a=a, b=b):
                rng = flat[a:b]
                if not in_place:
                    np.copyto(rng, arr)
                if forward:
                    nlink.publish(f"{seq}:bc:{a}", rng, deadline)
            win.push(plink, f"{seq}:bc:{a}", flat[a:b], done)
        win.drain()

    def reduce(self, tensor: Any, dst: int,
               op: str = ReduceOp.SUM) -> np.ndarray:
        """Reduce to ``dst`` (windowed chunked star gather)."""
        x = _as_numpy(tensor)
        if self.world_size == 1:
            return x.copy()
        reducer = _REDUCERS[op]
        with self._op_lock:
            seq, deadline, t0 = self._begin()
            flat = np.ascontiguousarray(x).reshape(-1)
            se = self._seg_elems_of(flat.itemsize)
            segs = [(a, min(a + se, flat.size))
                    for a in range(0, flat.size, se)]
            if self.rank != dst:
                ln = self._link(dst)
                for a, b in segs:
                    ln.publish(f"{seq}:red{self.rank}:{a}", flat[a:b],
                               deadline)
                self._end("reduce", "gather", x.nbytes, deadline, t0)
                return x
            acc = np.array(flat, copy=True)
            win = Window(CONFIG.collective_inflight_segments, deadline)
            staging = _StagingPool(win.depth,
                                   min(se, max(1, flat.size)), flat.dtype)
            for a, b in segs:
                for r in range(self.world_size):
                    if r == dst:
                        continue

                    def done(arr, in_place, a=a, b=b):
                        rng = acc[a:b]
                        reducer(rng, arr, out=rng)
                    win.push(self._link(r), f"{seq}:red{r}:{a}",
                             staging.take(b - a), done)
            win.drain()
            self._end("reduce", "gather", x.nbytes, deadline, t0)
        return acc.reshape(x.shape)

    def send(self, tensor: Any, dst: int, tag: str = "p2p") -> None:
        # p2p deliberately stays on the push/mailbox path even for
        # same-node peers: it may run CONCURRENTLY with collectives
        # (no _op_lock), and the shm links' single-writer rings and
        # lock-free outbox pump are only safe under the op lock's
        # serialization.  The conn/mailbox path is thread-safe.
        x = _as_numpy(tensor)
        self._conn_to(dst).call(
            "msg", {"src": self.rank, "tag": tag, "data": x},
            timeout=CONFIG.collective_op_timeout_s)
        _M_TCP_BYTES.inc(x.nbytes)

    def recv(self, src: int, tag: str = "p2p") -> np.ndarray:
        data = self._mailbox.get(src, tag,
                                 CONFIG.collective_op_timeout_s)
        arr = _as_numpy(data)
        _M_TCP_BYTES.inc(arr.nbytes)
        return arr

    def barrier(self) -> None:
        self.allreduce(np.zeros(1, np.float32))

    # -------------------------------------------------- async (overlap)
    def allreduce_async(self, tensor: Any, op: str = ReduceOp.SUM,
                        quantize: Optional[str] = None) -> AsyncWork:
        """Enqueue an allreduce and return immediately with an
        :class:`AsyncWork` handle — the chained-completion API that
        lets a training step kick gradient sync for early buckets while
        later gradients are still being computed.

        Ops run on a single per-group worker thread in enqueue order,
        so every rank executes async collectives in the same sequence
        (the tag protocol requires cross-rank op-order agreement).
        Corollary: do NOT issue sync collectives on this group while
        async ops are in flight — fence with ``wait_all`` first.  The
        caller must not mutate ``tensor`` until the handle resolves."""
        h = AsyncWork()
        with self._async_lock:
            if self._destroyed.is_set():
                raise RuntimeError(f"group {self.name!r} destroyed")
            if self._async_q is None:
                self._async_q = queue.Queue()
                self._async_thread = threading.Thread(
                    target=self._async_main,
                    name=f"col-async-{self.name}", daemon=True)
                self._async_thread.start()
            self._async_q.put((tensor, op, quantize, h))
        return h

    def _async_main(self) -> None:
        while True:
            item = self._async_q.get()
            if item is None:
                return
            tensor, op, quantize, h = item
            try:
                h._finish(self.allreduce(tensor, op, quantize=quantize),
                          None)
            except BaseException as e:  # handle owns delivery
                h._finish(None, e)

    def destroy(self) -> None:
        self._destroyed.set()
        with self._async_lock:
            q, t = self._async_q, self._async_thread
            self._async_q = self._async_thread = None
        if q is not None:
            q.put(None)
            if t is not None:
                t.join(timeout=5.0)
            # fail anything still queued behind the sentinel so no
            # waiter blocks forever on a dead group
            while True:
                try:
                    item = q.get_nowait()
                except queue.Empty:
                    break
                if item is not None:
                    item[3]._finish(None, RuntimeError(
                        f"group {self.name!r} destroyed"))
        try:
            gcs = self._worker.gcs
            base = f"collective/{self.name}"
            gcs.kv_del(f"{base}/{self.nonce}/{self.rank}")
            if self.rank == 0:
                # sweep the incarnation's remaining keys so a future
                # same-name group can't even see them — but only delete
                # the nonce key if it is still OURS: a newer same-name
                # incarnation may already have published its own, and
                # deleting that would wedge its joiners' nonce poll
                raw = gcs.kv_get(f"{base}/nonce")
                if raw is not None and raw.decode() == self.nonce:
                    gcs.kv_del(f"{base}/nonce")
                for k in gcs.kv_keys(f"{base}/{self.nonce}/"):
                    gcs.kv_del(k)
        except Exception:
            pass
        self._board.close()
        self._mailbox.close()
        if getattr(self, "_arena_inst", None) is not None:
            try:
                self._arena_inst.close()
            except Exception:
                pass
            self._arena_inst = None
        with self._links_lock:
            links, self._links = list(self._links.values()), {}
        for ln in links:
            try:
                ln.close()  # poisons shm rings: blocked peers unwind
            except Exception:
                pass
        with self._conns_lock:
            for conn in self._conns.values():
                try:
                    conn.close()
                except Exception:
                    pass
            self._conns.clear()
        self._server.stop()


# -------------------------------------------------------------- public API
def init_collective_group(world_size: int, rank: int,
                          backend: str = "dcn",
                          group_name: str = "default",
                          timeout: Optional[float] = None) -> None:
    """Join a collective group. Every participating process calls this with
    its own rank; returns once the full ring has rendezvoused.

    ``timeout`` bounds the rendezvous; None takes
    ``CONFIG.collective_rendezvous_timeout_s`` (a timeout_scale-scaled
    flag, so loaded CI boxes stretch the patience without per-call
    plumbing)."""
    if timeout is None:
        timeout = CONFIG.collective_rendezvous_timeout_s
    if backend not in ("dcn", "gloo", "ring"):
        raise ValueError(
            f"backend {backend!r} not supported on the host data plane; "
            f"{MULTI_DEVICE}")
    if not (0 <= rank < world_size):
        raise ValueError(f"rank {rank} out of range [0, {world_size})")
    with _groups_lock:
        if group_name in _groups:
            raise RuntimeError(f"group {group_name!r} already initialized")
        _groups[group_name] = _PENDING  # claim the slot atomically
    try:
        g = _Group(group_name, world_size, rank, timeout)
    except BaseException:
        with _groups_lock:
            if _groups.get(group_name) is _PENDING:
                del _groups[group_name]
        raise
    with _groups_lock:
        _groups[group_name] = g


def _get(group_name: str) -> _Group:
    with _groups_lock:
        g = _groups.get(group_name)
    if g is None or g is _PENDING:
        raise RuntimeError(
            f"collective group {group_name!r} is not initialized")
    return g


def is_group_initialized(group_name: str = "default") -> bool:
    with _groups_lock:
        g = _groups.get(group_name)
    return g is not None and g is not _PENDING


def destroy_collective_group(group_name: str = "default") -> None:
    with _groups_lock:
        g = _groups.get(group_name)
        if g is None or g is _PENDING:
            return
        del _groups[group_name]
    g.destroy()


def get_rank(group_name: str = "default") -> int:
    return _get(group_name).rank


def get_collective_group_size(group_name: str = "default") -> int:
    return _get(group_name).world_size


def allreduce(tensor: Any, group_name: str = "default",
              op: str = ReduceOp.SUM,
              quantize: Optional[str] = None) -> np.ndarray:
    return _get(group_name).allreduce(tensor, op, quantize=quantize)


def allreduce_async(tensor: Any, group_name: str = "default",
                    op: str = ReduceOp.SUM,
                    quantize: Optional[str] = None) -> AsyncWork:
    """Non-blocking allreduce; see :meth:`_Group.allreduce_async`."""
    return _get(group_name).allreduce_async(tensor, op,
                                            quantize=quantize)


def wait_all(handles: Sequence[AsyncWork],
             timeout: Optional[float] = None) -> List[np.ndarray]:
    """Fence: block until every handle resolves, returning results in
    order.  The first failed op raises (after all have settled or the
    per-handle timeout lapses)."""
    return [h.result(timeout=timeout) for h in handles]


def register_ici_mesh(mesh, axis: str = "data",
                      group_name: str = "default") -> None:
    """ray_tpu folds the intra-slice stage of a hierarchical allreduce
    into one compiled psum over a registered jax Mesh.  The port's
    counterpart waits for multi-device training: registering a mesh
    raises; ``mesh=None`` (deregister) leaves the host schedule."""
    g = _get(group_name)
    if mesh is not None:
        raise NotImplementedError(f"register_ici_mesh: {MULTI_DEVICE}")
    g._ici_reduce = None


def reduce(tensor: Any, dst_rank: int = 0, group_name: str = "default",
           op: str = ReduceOp.SUM) -> np.ndarray:
    return _get(group_name).reduce(tensor, dst_rank, op)


def broadcast(tensor: Any, src_rank: int = 0,
              group_name: str = "default") -> np.ndarray:
    return _get(group_name).broadcast(tensor, src_rank)


def allgather(tensor: Any, group_name: str = "default") -> List[np.ndarray]:
    return _get(group_name).allgather(tensor)


def reducescatter(tensor: Any, group_name: str = "default",
                  op: str = ReduceOp.SUM) -> np.ndarray:
    return _get(group_name).reducescatter(tensor, op)


def send(tensor: Any, dst_rank: int, group_name: str = "default") -> None:
    _get(group_name).send(tensor, dst_rank)


def recv(src_rank: int, group_name: str = "default") -> np.ndarray:
    return _get(group_name).recv(src_rank)


def barrier(group_name: str = "default") -> None:
    _get(group_name).barrier()
