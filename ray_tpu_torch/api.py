"""Public core API: init/shutdown, remote, get/put/wait, actors.

Analog of /root/reference/python/ray/_private/worker.py (init :1031,
get :2222, put :2335, wait :2391, remote :2715, shutdown :1581).
"""

from __future__ import annotations

import inspect
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

from ray_tpu_torch._private.config import CONFIG
from ray_tpu_torch._private.ids import JobID
from ray_tpu_torch.actor import ActorClass, get_actor, kill  # noqa: F401
from ray_tpu_torch.remote_function import RemoteFunction
from ray_tpu_torch.runtime import core_worker as cw
from ray_tpu_torch.runtime.core_worker import (ObjectRef,  # noqa: F401
                                          ObjectRefGenerator,
                                          StreamingObjectRefGenerator)
from ray_tpu_torch.runtime.node import NodeProcesses, new_session_dir

_init_lock = threading.Lock()
_node: Optional[NodeProcesses] = None
_pre_init_config: Optional[Dict[str, Any]] = None


def is_initialized() -> bool:
    if cw._global_worker is not None:
        return True
    from ray_tpu_torch.util import client as client_mod
    return client_mod.current() is not None


def init(address: Optional[str] = None, *,
         num_cpus: Optional[float] = None,
         num_gpus: Optional[float] = None,
         resources: Optional[Dict[str, float]] = None,
         object_store_memory: Optional[int] = None,
         system_config: Optional[Dict[str, Any]] = None,
         runtime_env: Optional[Dict[str, Any]] = None,
         namespace: str = "") -> Dict[str, Any]:
    """Start (or connect to) a cluster and attach this process as a driver.

    ``address=None`` starts a head node (GCS + raylet) owned by this driver;
    ``address="host:port"`` connects to an existing GCS.
    """
    global _node
    if address and (address.startswith("client://")
                    or address.startswith("ray://")):
        # remote-driver mode: everything proxies through the client server
        # (cf. reference ray://, python/ray/util/client/client_builder.py)
        from ray_tpu_torch._private.logging_utils import get_logger
        from ray_tpu_torch.util import client as client_mod
        ignored = {"num_cpus": num_cpus, "num_gpus": num_gpus,
                   "resources": resources,
                   "object_store_memory": object_store_memory,
                   "system_config": system_config,
                   "runtime_env": runtime_env,
                   "namespace": namespace or None}
        ignored = [k for k, v in ignored.items() if v]
        if ignored:
            get_logger("client").warning(
                "init(address=%r) ignores %s in remote-driver mode; "
                "configure them on the cluster / client server instead",
                address, ignored)
        ctx = client_mod.current()
        if ctx is None:
            ctx = client_mod.connect(address)
        return {"address": address, "client": ctx}
    with _init_lock:
        if is_initialized():
            return context()
        if system_config:
            # scoped to this cluster's lifetime: shutdown() restores the
            # pre-init overrides so back-to-back init/shutdown cycles (the
            # test pattern) don't leak one cluster's knobs into the next
            global _pre_init_config
            _pre_init_config = CONFIG.copy_overrides()
            CONFIG.update(system_config)

        if address is None:
            # submitted job drivers inherit their cluster from the
            # supervisor (reference RAY_ADDRESS semantics)
            import os as _os
            address = _os.environ.get("RAY_TPU_TORCH_ADDRESS") or None
        if address == "auto":
            from ray_tpu_torch.job_submission.job_manager import \
                latest_session_address
            address = latest_session_address()

        if address is None:
            session_dir = new_session_dir()
            node = NodeProcesses(session_dir)
            gcs_addr = node.start_gcs()
            res = dict(resources or {})
            if num_cpus is not None:
                res["CPU"] = float(num_cpus)
            if num_gpus is not None:
                res["GPU"] = float(num_gpus)
            node.start_raylet(gcs_addr, resources=res or None,
                              object_store_memory=object_store_memory)
            _node = node
            raylet_addr = node.raylet_address
            node_id = node.node_id
            store_path = node.store_path
        else:
            host, port = address.rsplit(":", 1)
            gcs_addr = (host, int(port))
            # join an existing cluster: attach to a raylet on THIS host —
            # identified by its shm store segment existing locally
            import os
            from ray_tpu_torch.runtime.gcs import GcsClient
            probe = GcsClient(gcs_addr)
            try:
                alive = [n for n in probe.call("list_nodes") if n["alive"]]
            finally:
                probe.close()
            if not alive:
                raise RuntimeError("no alive nodes in cluster")
            local = next((n for n in alive
                          if n.get("store_path")
                          and os.path.exists(n["store_path"])), None)
            if local is None:
                raise RuntimeError(
                    "no raylet running on this host; start one with "
                    "cluster.add_node() or `ray_tpu_torch start --address=...`")
            raylet_addr = tuple(local["address"])
            node_id = local["node_id"]
            store_path = local["store_path"]
            session_dir = ""

        job_id = JobID.from_random()
        worker = cw.CoreWorker(
            mode="driver",
            gcs_address=gcs_addr,
            raylet_address=raylet_addr,
            store_path=store_path,
            node_id=node_id,
            job_id=job_id,
            session_dir=session_dir,
        )
        worker.namespace = namespace
        if CONFIG.log_to_driver:
            from ray_tpu_torch._private.log_monitor import (LOG_CHANNEL,
                                                      print_to_driver)
            import functools as _functools
            try:
                worker.gcs.subscribe(
                    LOG_CHANNEL,
                    _functools.partial(print_to_driver,
                                       job_id=worker.job_id.hex()))
            except Exception:
                pass  # observability only; never fail init over it
        if runtime_env:
            # job-level default env, inherited by every task/actor that
            # doesn't set its own (reference job_config.runtime_env)
            worker.job_runtime_env = worker.prepare_runtime_env(runtime_env)
        job_payload = {
            "job_id": job_id.hex(),
            "driver_address": list(worker.address),
            "entrypoint": " ".join(__import__("sys").argv[:2]),
        }
        worker.gcs.call("register_job", job_payload)
        # a restarted GCS restores the job table but the fresh connection
        # has no peer identity; re-registering is idempotent and restores
        # the conn->job binding that drives job cleanup on driver exit
        worker.gcs.on_reconnect = lambda client: client.call(
            "register_job", job_payload, timeout=5)
        cw.set_global_worker(worker)
        return context()


def context() -> Dict[str, Any]:
    worker = cw.get_global_worker()
    return {
        "gcs_address": ":".join(map(str, worker.gcs._conn._sock.getpeername())),
        "node_id": worker.node_id,
        "job_id": worker.job_id.hex(),
        "session_dir": worker.session_dir,
    }


class RuntimeContext:
    """Where-am-I API for driver/task/actor code (reference
    runtime_context.py:13 ``RuntimeContext``: get_node_id/get_job_id/
    get_task_id/get_actor_id + the dict form via .get())."""

    def __init__(self, worker):
        self._worker = worker

    def get(self) -> Dict[str, Any]:
        out = {"node_id": self.node_id, "job_id": self.job_id}
        if self.task_id is not None:
            out["task_id"] = self.task_id
        if self.actor_id is not None:
            out["actor_id"] = self.actor_id
        return out

    @property
    def node_id(self) -> str:
        return self._worker.node_id

    @property
    def job_id(self) -> str:
        return self._worker.job_id.hex()

    @property
    def task_id(self) -> Optional[str]:
        tid = getattr(self._worker, "current_task_id", None)
        return tid.hex() if tid is not None else None

    @property
    def actor_id(self) -> Optional[str]:
        aid = getattr(self._worker, "current_actor_id", None)
        return aid if isinstance(aid, (str, type(None))) else aid.hex()

    # reference get_* accessors
    def get_node_id(self) -> str:
        return self.node_id

    def get_job_id(self) -> str:
        return self.job_id

    def get_task_id(self) -> Optional[str]:
        return self.task_id

    def get_actor_id(self) -> Optional[str]:
        return self.actor_id


def get_runtime_context() -> RuntimeContext:
    return RuntimeContext(cw.get_global_worker())


def _client():
    """Active remote-driver context, if init was called with client://."""
    from ray_tpu_torch.util import client as client_mod
    return client_mod.current()


def shutdown() -> None:
    global _node, _pre_init_config
    from ray_tpu_torch.util import client as client_mod
    if client_mod.current() is not None:
        client_mod.disconnect()
        return
    with _init_lock:
        worker = cw._global_worker
        if worker is not None:
            try:
                worker.gcs.call("finish_job", {"job_id": worker.job_id.hex()},
                                timeout=5)
            except Exception:
                pass
            worker.shutdown()
            cw.set_global_worker(None)
        if _node is not None:
            _node.stop()
            _node = None
        if _pre_init_config is not None:
            CONFIG.set_overrides(_pre_init_config)
            _pre_init_config = None


def remote(*args, **kwargs):
    """``@remote`` / ``@remote(num_cpus=..., num_gpus=...)`` decorator."""
    def decorate(target):
        if inspect.isclass(target):
            return ActorClass(
                target,
                num_cpus=kwargs.get("num_cpus", 1.0),
                num_gpus=kwargs.get("num_gpus", 0.0),
                resources=kwargs.get("resources"),
                max_restarts=kwargs.get("max_restarts", 0),
                name=kwargs.get("name"),
                namespace=kwargs.get("namespace", ""),
                lifetime=kwargs.get("lifetime"),
                max_concurrency=kwargs.get("max_concurrency"),
                concurrency_groups=kwargs.get("concurrency_groups"),
                scheduling_strategy=kwargs.get("scheduling_strategy"),
                runtime_env=kwargs.get("runtime_env"))
        return RemoteFunction(
            target,
            num_returns=kwargs.get("num_returns", 1),
            num_cpus=kwargs.get("num_cpus", 1.0),
            num_gpus=kwargs.get("num_gpus", 0.0),
            resources=kwargs.get("resources"),
            max_retries=kwargs.get("max_retries", 3),
            scheduling_strategy=kwargs.get("scheduling_strategy"),
            runtime_env=kwargs.get("runtime_env"))

    if len(args) == 1 and not kwargs and callable(args[0]):
        return decorate(args[0])
    if args:
        raise TypeError("@remote takes keyword arguments only")
    return decorate


def put(value: Any) -> ObjectRef:
    ctx = _client()
    if ctx is not None:
        return ctx.put(value)
    return cw.get_global_worker().put(value)


def get(refs: Union[ObjectRef, Sequence[ObjectRef]],
        *, timeout: Optional[float] = None) -> Any:
    ctx = _client()
    if ctx is not None:
        return ctx.get(refs, timeout=timeout)
    worker = cw.get_global_worker()
    if isinstance(refs, ObjectRef):
        return worker.get([refs], timeout=timeout)[0]
    return worker.get(list(refs), timeout=timeout)


def wait(refs: Sequence[ObjectRef], *, num_returns: int = 1,
         timeout: Optional[float] = None,
         fetch_local: bool = True) -> Tuple[List[ObjectRef], List[ObjectRef]]:
    ctx = _client()
    if ctx is not None:
        return ctx.wait(refs, num_returns=num_returns, timeout=timeout)
    return cw.get_global_worker().wait(
        list(refs), num_returns=num_returns, timeout=timeout,
        fetch_local=fetch_local)


def nodes() -> List[dict]:
    ctx = _client()
    if ctx is not None:
        return ctx.nodes()
    return cw.get_global_worker().gcs.call("list_nodes")


def cluster_resources() -> Dict[str, float]:
    total: Dict[str, float] = {}
    for n in nodes():
        if n["alive"]:
            for r, v in n["resources"].items():
                total[r] = total.get(r, 0) + v
    return total


def available_resources() -> Dict[str, float]:
    total: Dict[str, float] = {}
    for n in nodes():
        if n["alive"]:
            for r, v in n["available"].items():
                total[r] = total.get(r, 0) + v
    return total
