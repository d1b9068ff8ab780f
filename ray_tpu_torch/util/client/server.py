"""Client server: hosts remote drivers over the control-plane RPC layer.

Analog of the reference's Ray Client server (/root/reference/python/ray/util/
client/server/, proxier.py; wire protocol ray_client.proto:324
``RayletDriver``): a thin process inside the cluster that executes
put/get/wait/task/actor calls on behalf of drivers connecting from outside
(laptops, notebooks).  One shared embedded driver serves every client
connection; per-SESSION registries pin ObjectRefs/actor handles.  A clean
``bye`` releases everything immediately; an abrupt connection loss keeps
the session alive for ``reconnect_grace_s`` so the client can reconnect
and keep its refs (reference client reconnect, test_client_reconnect.py),
and a per-session request-id reply cache makes retried RPCs exactly-once
across the reconnect.

Run standalone:  ``python -m ray_tpu_torch.util.client.server --port 10001``
(connects to the latest local session, or pass ``--address host:port``).
"""

from __future__ import annotations

from ray_tpu_torch import cloudpickle
import pickle
import threading
import uuid
from collections import deque
from typing import Any, Dict, Optional, Tuple

from ray_tpu_torch._private import rpc


class _Ref:
    """Wire tag for a client-held object ref inside pickled args."""

    def __init__(self, ref_id: str):
        self.ref_id = ref_id

    def __reduce__(self):
        return (_Ref, (self.ref_id,))


class _ActorRef:
    """Wire tag for a client-held actor handle inside pickled args."""

    def __init__(self, actor_id: str):
        self.actor_id = actor_id

    def __reduce__(self):
        return (_ActorRef, (self.actor_id,))


def _map_structure(value, fn):
    """Resolve wire tags recursively through plain containers (tags buried
    inside arbitrary user objects are not found — same as the reference)."""
    if isinstance(value, (_Ref, _ActorRef)):
        return fn(value)
    if isinstance(value, (list, tuple)):
        return type(value)(_map_structure(v, fn) for v in value)
    if isinstance(value, dict):
        return {k: _map_structure(v, fn) for k, v in value.items()}
    return value


class ClientServer:
    """Serves client drivers; embeds (or joins) a cluster as their proxy."""

    def __init__(self, address: Optional[str] = None, host: str = "0.0.0.0",
                 port: int = 10001, reconnect_grace_s: float = 30.0,
                 **init_kwargs):
        import ray_tpu_torch
        if not ray_tpu_torch.is_initialized():
            ray_tpu_torch.init(address=address, **init_kwargs)
        self._lock = threading.Lock()
        self.reconnect_grace_s = reconnect_grace_s
        # session_id -> {refs, actors, replies, reply_order, conn, timer}
        self._sessions: Dict[str, Dict[str, Any]] = {}
        self._conn_session: Dict[rpc.Connection, str] = {}
        self._server = rpc.Server(self._handle, host=host, port=port,
                                  on_disconnect=self._disconnected)
        self.address: Tuple[str, int] = self._server.address

    # ------------------------------------------------------------- sessions
    def _session(self, conn) -> Dict[str, Any]:
        with self._lock:
            sid = self._conn_session.get(conn)
            if sid is None:
                # pre-hello caller (or a legacy client): anonymous
                # session fate-shared with this one connection
                sid = f"anon-{id(conn):x}"
                self._conn_session[conn] = sid
            return self._ensure_session(sid, conn)

    def _ensure_session(self, sid: str, conn) -> Dict[str, Any]:
        # _lock held
        sess = self._sessions.get(sid)
        if sess is None:
            sess = {"refs": {}, "actors": {}, "replies": {},
                    "reply_order": deque(),
                    "conn": conn, "timer": None}
            self._sessions[sid] = sess
        return sess

    def _conn_refs(self, conn) -> Dict[str, Any]:
        return self._session(conn)["refs"]

    def _register(self, conn, ref) -> str:
        rid = uuid.uuid4().hex
        self._conn_refs(conn)[rid] = ref
        return rid

    def _resolve(self, conn, value):
        refs = self._conn_refs(conn)

        def one(tag):
            if isinstance(tag, _ActorRef):
                return self._actor(conn, tag.actor_id)
            try:
                return refs[tag.ref_id]
            except KeyError:
                raise rpc.RpcError(f"unknown ref {tag.ref_id[:8]}")
        return _map_structure(value, one)

    def _drop_session(self, sid: str) -> None:
        with self._lock:
            sess = self._sessions.get(sid)
            if sess is None or sess["conn"] is not None:
                return  # reconnected during the grace window
            del self._sessions[sid]
            self._forget_conns(sid)

    def _forget_conns(self, sid: str) -> None:
        # _lock held: drop dead conn->sid bindings of this session
        for c in [c for c, s in self._conn_session.items() if s == sid]:
            del self._conn_session[c]

    def _disconnected(self, conn) -> None:
        # NOTE: the conn->sid binding is kept — a handler still running
        # on this connection must keep resolving to the right session
        # (registering into a fresh anonymous one would strand the refs
        # its cached reply hands back). Bindings drop with the session.
        with self._lock:
            sid = self._conn_session.get(conn)
            sess = self._sessions.get(sid) if sid else None
            if sess is None or sess["conn"] is not conn:
                return
            sess["conn"] = None
            if sid.startswith("anon-"):
                # legacy connection-scoped session: no reconnect identity
                del self._sessions[sid]
                self._forget_conns(sid)
                return
            # keep refs/actors for the grace window so a reconnecting
            # client finds them again
            t = threading.Timer(self.reconnect_grace_s,
                                self._drop_session, args=(sid,))
            t.daemon = True
            sess["timer"] = t
            t.start()

    # ------------------------------------------------------------- handlers
    _REPLY_CACHE_MAX_BYTES = 256 * 1024

    @staticmethod
    def _reply_size(out: Any) -> int:
        if isinstance(out, dict):
            return sum(len(v) for v in out.values()
                       if isinstance(v, (bytes, bytearray)))
        return 0

    def _handle(self, conn, method: str, p: Any) -> Any:
        p = p or {}
        req = p.get("_req")
        if req is None:
            return getattr(self, f"_rpc_{method}")(conn, p)
        sess = self._session(conn)
        while True:
            with self._lock:
                prior = sess["replies"].get(req)
                if prior is None:
                    # mark in flight so a retry racing this execution waits
                    # instead of re-executing (exactly-once when the
                    # original completes; see absent-entry case below)
                    inflight = threading.Event()
                    sess["replies"][req] = inflight
                    break
            if not isinstance(prior, threading.Event):
                return prior
            prior.wait(timeout=120)
            with self._lock:
                done = sess["replies"].get(req)
            if done is None:
                # entry vanished: the original raised (its error went to a
                # connection that is gone) or its reply was too big to pin
                # (only the idempotent get) — re-execute rather than hand
                # the client a bogus None reply
                continue
            if not isinstance(done, threading.Event):
                return done
            raise rpc.RpcError("retried request still executing")
        try:
            out = getattr(self, f"_rpc_{method}")(conn, p)
        except BaseException:
            with self._lock:
                sess["replies"].pop(req, None)
            inflight.set()
            raise
        with self._lock:
            # huge replies (multi-MB gets) are not worth pinning; the
            # only RPC with big replies is the idempotent get
            if self._reply_size(out) <= self._REPLY_CACHE_MAX_BYTES:
                sess["replies"][req] = out
                sess["reply_order"].append(req)
                while len(sess["reply_order"]) > 512:
                    sess["replies"].pop(sess["reply_order"].popleft(),
                                        None)
            else:
                sess["replies"].pop(req, None)
        inflight.set()
        return out

    def _rpc_hello(self, conn, p):
        """Bind this connection to a client session (new or resumed)."""
        sid = p["session_id"]
        with self._lock:
            # a reconnecting session's previous conns are dead: drop their
            # bindings now (not at session end) or each reconnect leaks one
            for c in [c for c, s in self._conn_session.items()
                      if s == sid and c is not conn and c.closed]:
                del self._conn_session[c]
            self._conn_session[conn] = sid
            sess = self._ensure_session(sid, conn)
            sess["conn"] = conn
            if sess["timer"] is not None:
                sess["timer"].cancel()
                sess["timer"] = None
        return {"ok": True}

    def _rpc_bye(self, conn, p):
        """Clean disconnect: release the session's refs immediately."""
        with self._lock:
            sid = self._conn_session.get(conn)
            if sid:
                self._sessions.pop(sid, None)
                self._forget_conns(sid)
        return {"ok": True}

    def _rpc_put(self, conn, p):
        import ray_tpu_torch
        ref = ray_tpu_torch.put(pickle.loads(p["data"]))
        return {"ref_id": self._register(conn, ref)}

    def _rpc_get(self, conn, p):
        import ray_tpu_torch
        refs = [self._resolve(conn, _Ref(r)) for r in p["ref_ids"]]
        values = ray_tpu_torch.get(refs, timeout=p.get("timeout"))
        values = [self._wrap_value(conn, v) for v in values]
        return {"data": cloudpickle.dumps(values)}

    def _wrap_value(self, conn, value):
        """Dynamic-return generators carry server-side ObjectRefs the client
        cannot resolve; register each and ship a marker of client ref ids."""
        from ray_tpu_torch.runtime.core_worker import ObjectRefGenerator
        if isinstance(value, ObjectRefGenerator):
            return {"__client_ref_generator__":
                    [self._register(conn, r) for r in value]}
        return value

    def _rpc_wait(self, conn, p):
        import ray_tpu_torch
        id_of = {id(v): rid for rid, v in self._conn_refs(conn).items()}
        refs = [self._resolve(conn, _Ref(r)) for r in p["ref_ids"]]
        ready, pending = ray_tpu_torch.wait(refs,
                                      num_returns=p.get("num_returns", 1),
                                      timeout=p.get("timeout"))
        return {"ready": [id_of[id(r)] for r in ready],
                "pending": [id_of[id(r)] for r in pending]}

    def _rpc_task(self, conn, p):
        import ray_tpu_torch
        fn = pickle.loads(p["func"])
        args = self._resolve(conn, pickle.loads(p["args"]))
        kwargs = self._resolve(conn, pickle.loads(p["kwargs"]))
        remote_fn = ray_tpu_torch.remote(fn)
        if p.get("options"):
            remote_fn = remote_fn.options(**p["options"])
        out = remote_fn.remote(*args, **kwargs)
        refs = out if isinstance(out, list) else [out]
        return {"ref_ids": [self._register(conn, r) for r in refs]}

    def _rpc_create_actor(self, conn, p):
        import ray_tpu_torch
        cls = pickle.loads(p["cls"])
        args = self._resolve(conn, pickle.loads(p["args"]))
        kwargs = self._resolve(conn, pickle.loads(p["kwargs"]))
        actor_cls = ray_tpu_torch.remote(cls)
        if p.get("options"):
            actor_cls = actor_cls.options(**p["options"])
        handle = actor_cls.remote(*args, **kwargs)
        aid = uuid.uuid4().hex
        self._session(conn)["actors"][aid] = handle
        return {"actor_id": aid}

    def _actor(self, conn, aid):
        handle = self._session(conn)["actors"].get(aid)
        if handle is None:
            raise rpc.RpcError(f"unknown actor {aid[:8]}")
        return handle

    def _rpc_actor_call(self, conn, p):
        handle = self._actor(conn, p["actor_id"])
        args = self._resolve(conn, pickle.loads(p["args"]))
        kwargs = self._resolve(conn, pickle.loads(p["kwargs"]))
        ref = getattr(handle, p["method"]).remote(*args, **kwargs)
        return {"ref_id": self._register(conn, ref)}

    def _rpc_kill_actor(self, conn, p):
        import ray_tpu_torch
        ray_tpu_torch.kill(self._actor(conn, p["actor_id"]))
        self._session(conn)["actors"].pop(p["actor_id"], None)
        return {}

    def _rpc_nodes(self, conn, p):
        import ray_tpu_torch
        return {"nodes": ray_tpu_torch.nodes()}

    def _rpc_cluster_info(self, conn, p):
        import ray_tpu_torch
        return {"nodes": len(ray_tpu_torch.nodes()),
                "resources": ray_tpu_torch.cluster_resources()}

    def stop(self) -> None:
        self._server.stop()


def main() -> None:
    import argparse
    import time
    parser = argparse.ArgumentParser(description="ray_tpu_torch client server")
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=10001)
    parser.add_argument("--address", default="auto",
                        help="cluster GCS address (default: latest session)")
    args = parser.parse_args()
    server = ClientServer(address=args.address, host=args.host,
                          port=args.port)
    print(f"client server listening on {server.address[0]}:{server.address[1]}",
          flush=True)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        server.stop()


if __name__ == "__main__":
    main()
