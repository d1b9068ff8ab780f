"""Ray-Client-style remote driver: drive a cluster from outside it.

Analog of /root/reference/python/ray/util/client (``ray://`` protocol,
ray_client.proto:324, client worker.py): ``ray_tpu_torch.init(address=
"client://host:port")`` routes the public API — remote functions, actors,
put/get/wait — through a thin RPC connection to a ClientServer running inside
the cluster (ray_tpu_torch/util/client/server.py), so laptops and notebooks can
drive TPU clusters without being cluster nodes themselves.

Object refs on this side are ``ClientObjectRef`` handles (ids into the
server's per-connection registry); passing one back into a task/actor call
re-resolves it server-side, so data never round-trips through the client.
"""

from __future__ import annotations

from ray_tpu_torch import cloudpickle
import pickle
import threading
from typing import Any, Optional, Sequence, Tuple, Union

from ray_tpu_torch._private import rpc
from ray_tpu_torch.util.client.server import (ClientServer,  # noqa: F401
                                        _ActorRef, _Ref)

_lock = threading.Lock()
_ctx: Optional["ClientContext"] = None


class ClientObjectRef:
    def __init__(self, ctx: "ClientContext", ref_id: str):
        self._ctx = ctx
        self.ref_id = ref_id

    def __repr__(self):
        return f"ClientObjectRef({self.ref_id[:8]})"

    def __reduce__(self):
        # pickles into the wire tag the server resolves to the real ref
        return (_Ref, (self.ref_id,))


class ClientObjectRefGenerator:
    """Client-side view of a num_returns="dynamic" result."""

    def __init__(self, ctx: "ClientContext", ref_ids):
        self._refs = [ClientObjectRef(ctx, rid) for rid in ref_ids]

    def __iter__(self):
        return iter(self._refs)

    def __len__(self):
        return len(self._refs)

    def __getitem__(self, i):
        return self._refs[i]

    def __repr__(self):
        return f"ClientObjectRefGenerator({len(self._refs)} refs)"


class ClientActorMethod:
    def __init__(self, handle: "ClientActorHandle", name: str):
        self._handle = handle
        self._name = name

    def remote(self, *args, **kwargs) -> ClientObjectRef:
        ctx = self._handle._ctx
        r = ctx._call("actor_call", {
            "actor_id": self._handle._actor_id, "method": self._name,
            "args": ctx._dumps(args), "kwargs": ctx._dumps(kwargs)})
        return ClientObjectRef(ctx, r["ref_id"])


class ClientActorHandle:
    def __init__(self, ctx: "ClientContext", actor_id: str):
        self._ctx = ctx
        self._actor_id = actor_id

    def __reduce__(self):
        # ships as a wire tag the server resolves to the real handle, so
        # client actor handles can be passed into tasks/actor calls
        return (_ActorRef, (self._actor_id,))

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        return ClientActorMethod(self, name)


class ClientRemoteFunction:
    def __init__(self, ctx: "ClientContext", func, options: Optional[dict] = None):
        self._ctx = ctx
        self._func = func
        self._options = dict(options or {})

    def remote(self, *args, **kwargs):
        r = self._ctx._call("task", {
            "func": cloudpickle.dumps(self._func),
            "args": self._ctx._dumps(args),
            "kwargs": self._ctx._dumps(kwargs),
            "options": self._options})
        refs = [ClientObjectRef(self._ctx, rid) for rid in r["ref_ids"]]
        return refs[0] if len(refs) == 1 else refs

    def options(self, **opts) -> "ClientRemoteFunction":
        return ClientRemoteFunction(self._ctx, self._func,
                                    {**self._options, **opts})


class ClientActorClass:
    def __init__(self, ctx: "ClientContext", cls, options: Optional[dict] = None):
        self._ctx = ctx
        self._cls = cls
        self._options = dict(options or {})

    def remote(self, *args, **kwargs) -> ClientActorHandle:
        r = self._ctx._call("create_actor", {
            "cls": cloudpickle.dumps(self._cls),
            "args": self._ctx._dumps(args),
            "kwargs": self._ctx._dumps(kwargs),
            "options": self._options})
        return ClientActorHandle(self._ctx, r["actor_id"])

    def options(self, **opts) -> "ClientActorClass":
        return ClientActorClass(self._ctx, self._cls,
                                {**self._options, **opts})


class ClientContext:
    """One connection to a ClientServer; the client-mode API surface.

    Survives connection drops: the context holds a session id, the
    server keeps the session's refs for a reconnect grace window, and
    ``_call`` transparently reconnects and retries — each RPC carries a
    request id the server dedups, so retries are exactly-once
    (reference client reconnect + reply caching, dataclient.py)."""

    def __init__(self, address: Tuple[str, int],
                 reconnect_grace_s: float = 30.0):
        import uuid as _uuid
        self.address = address
        self.session_id = _uuid.uuid4().hex
        self.reconnect_grace_s = reconnect_grace_s
        self._conn_lock = threading.Lock()
        self._conn = self._connect()

    def _connect(self) -> rpc.Connection:
        conn = rpc.connect(self.address)
        conn.call("hello", {"session_id": self.session_id}, timeout=10)
        return conn

    def _call(self, method: str, payload: dict) -> Any:
        import time as _time
        import uuid as _uuid
        payload = dict(payload, _req=_uuid.uuid4().hex)
        deadline = _time.monotonic() + self.reconnect_grace_s
        while True:
            conn = self._conn
            try:
                if conn.closed:
                    raise ConnectionError("client connection closed")
                return conn.call(method, payload)
            except (ConnectionError, OSError):
                if _time.monotonic() >= deadline:
                    raise
                try:
                    conn.close()
                except Exception:
                    pass
                with self._conn_lock:
                    stale = self._conn is conn or self._conn.closed
                if not stale:
                    continue   # another thread already reconnected
                # dial OUTSIDE the lock: other threads' calls must not
                # queue behind this thread's connect timeout
                try:
                    fresh = self._connect()
                except (ConnectionError, OSError):
                    _time.sleep(0.5)
                    continue
                with self._conn_lock:
                    if self._conn is conn or self._conn.closed:
                        self._conn = fresh
                    else:
                        try:
                            fresh.close()
                        except Exception:
                            pass

    @staticmethod
    def _dumps(value: Any) -> bytes:
        # ClientObjectRef.__reduce__ turns embedded refs into wire tags
        return cloudpickle.dumps(value)

    # ---------------------------------------------------------- public API
    def remote(self, obj, **options):
        if isinstance(obj, type):
            return ClientActorClass(self, obj, options)
        return ClientRemoteFunction(self, obj, options)

    def put(self, value: Any) -> ClientObjectRef:
        r = self._call("put", {"data": cloudpickle.dumps(value)})
        return ClientObjectRef(self, r["ref_id"])

    def get(self, refs: Union[ClientObjectRef, Sequence[ClientObjectRef]],
            timeout: Optional[float] = None) -> Any:
        single = isinstance(refs, ClientObjectRef)
        ref_list = [refs] if single else list(refs)
        r = self._call("get", {"ref_ids": [x.ref_id for x in ref_list],
                               "timeout": timeout})
        values = [self._unwrap(v) for v in pickle.loads(r["data"])]
        return values[0] if single else values

    def _unwrap(self, value):
        if isinstance(value, dict) and "__client_ref_generator__" in value:
            return ClientObjectRefGenerator(
                self, value["__client_ref_generator__"])
        return value

    def wait(self, refs: Sequence[ClientObjectRef], *, num_returns: int = 1,
             timeout: Optional[float] = None):
        by_id = {x.ref_id: x for x in refs}
        if len(by_id) != len(list(refs)):
            raise ValueError("wait() requires a list of unique object refs")
        r = self._call("wait", {"ref_ids": list(by_id),
                                "num_returns": num_returns,
                                "timeout": timeout})
        return ([by_id[i] for i in r["ready"]],
                [by_id[i] for i in r["pending"]])

    def kill(self, actor: ClientActorHandle) -> None:
        self._call("kill_actor", {"actor_id": actor._actor_id})

    def nodes(self) -> list:
        return self._call("nodes", {})["nodes"]

    def cluster_info(self) -> dict:
        return self._call("cluster_info", {})

    def disconnect(self) -> None:
        try:
            # clean goodbye: the server releases our refs immediately
            # instead of waiting out the reconnect grace window
            self._conn.call("bye", {}, timeout=5)
        except Exception:
            pass
        self._conn.close()


def connect(address: Union[str, Tuple[str, int]]) -> ClientContext:
    """Connect to a ClientServer.  Accepts "host:port", "client://host:port",
    or a (host, port) tuple; installs the context as the active client so the
    top-level ``ray_tpu_torch.get/put/wait/remote`` delegate to it."""
    global _ctx
    if isinstance(address, str):
        address = address.removeprefix("client://").removeprefix("ray://")
        host, _, port = address.rpartition(":")
        address = (host or "127.0.0.1", int(port))
    with _lock:
        if _ctx is not None:
            raise RuntimeError("client already connected; disconnect() first")
        _ctx = ClientContext(tuple(address))
    return _ctx


def current() -> Optional[ClientContext]:
    return _ctx


def disconnect() -> None:
    global _ctx
    with _lock:
        if _ctx is not None:
            _ctx.disconnect()
            _ctx = None
