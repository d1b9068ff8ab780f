"""WorkerGroup: a gang of trainer actors (the port's copy of
ray_tpu/train/worker_group.py).

Analog of Ray's python/ray/train/_internal/worker_group.py:92 and
backend_executor.py:42.  On the port a worker whose bundle leases a GPU
(``ScalingConfig(use_gpu=True)``) sees only its cards
(``CUDA_VISIBLE_DEVICES``, set by the raylet) and runs its loop on
``cuda``; CUDA starts in the loop's thread, never at import or in the
zygote that forked the worker.  A worker without a GPU lease sees
``CUDA_VISIBLE_DEVICES=""`` and never starts CUDA.  ray_tpu's
``jax.distributed`` rendezvous is a ``torch.distributed`` process group
over gloo here (``setup_jax_distributed`` keeps its name): NCCL refuses
two ranks on one card, and the gradient sync rides the host collective
(``util/collective``) anyway.
"""

from __future__ import annotations

import os
import socket
import threading
import traceback
import uuid
from typing import Any, Callable, Dict, List, Optional

from ray_tpu_torch.air import session as air_session

# queued after a loop's last report, so a waiting poll returns at once
_LOOP_ENDED = ("loop ended", None)

# the device the train loop of this process runs on, set in the loop's
# thread before the loop starts (get_device)
_loop_device = None


def get_device():
    """Inside a train loop: the worker's card (``cuda``) when its lease
    holds a GPU, else the CPU (Ray's ``ray.train.torch.get_device``)."""
    import torch
    return _loop_device if _loop_device is not None else torch.device("cpu")


class TrainWorker:
    """Actor body: runs the user train loop in a thread with an AIR session
    installed, and exposes a poll-based result channel to the driver."""

    def __init__(self, world_rank: int, world_size: int,
                 local_rank: int = 0, local_world_size: int = 1,
                 node_rank: int = 0, use_gpu: bool = False):
        self.use_gpu = use_gpu
        self.world_rank = world_rank
        self.world_size = world_size
        self.local_rank = local_rank
        self.local_world_size = local_world_size
        self.node_rank = node_rank
        self._thread: Optional[threading.Thread] = None
        self._session: Optional[air_session._Session] = None
        self._final: Any = None
        self._error: Optional[str] = None
        self._done = threading.Event()

    # -- rendezvous helpers ------------------------------------------------
    def get_node_ip(self) -> str:
        """The address this worker's RPC server listens on (the node's
        address in the runtime); ray_tpu asks the routing table with a
        UDP connect to a public address, which the port never makes."""
        try:
            from ray_tpu_torch.runtime import core_worker as cw
            return cw.get_global_worker().address[0]
        except Exception:
            return "127.0.0.1"

    def find_free_port(self) -> int:
        s = socket.socket()
        s.bind(("", 0))
        port = s.getsockname()[1]
        s.close()
        return port

    def set_env(self, env: Dict[str, str]) -> None:
        os.environ.update(env)

    def setup_jax_distributed(self, coordinator: str) -> int:
        """Join the gang's ``torch.distributed`` process group (gloo) at
        ``coordinator`` (``host:port``) over TCP, in place of ray_tpu's
        ``jax.distributed`` service: the reference's torch.distributed
        TCP rendezvous (train/torch/config.py:29).  Returns the devices
        this worker's loop uses: its cards, or 1 (the CPU)."""
        import datetime

        import torch.distributed as dist
        if self.world_size > 1 and not dist.is_initialized():
            dist.init_process_group(
                backend="gloo", init_method=f"tcp://{coordinator}",
                world_size=self.world_size, rank=self.world_rank,
                timeout=datetime.timedelta(seconds=120))
        return self.device_count()

    def device_count(self) -> int:
        """The cards this worker's lease shows it (never starting CUDA),
        or 1 (the CPU) without a GPU lease."""
        visible = os.environ.get("CUDA_VISIBLE_DEVICES", "")
        cards = [c for c in visible.split(",") if c.strip()]
        return len(cards) if self.use_gpu else 1

    def get_runtime_node_id(self) -> str:
        """The runtime node hosting this rank: the driver's gang watch
        matches NODE_PREEMPTING/NODE_DEAD events against these ids
        (docs/fault_tolerance.md)."""
        try:
            from ray_tpu_torch.runtime import core_worker as cw
            return cw.get_global_worker().node_id
        except Exception:
            return ""

    # -- host (DCN) collectives -------------------------------------------
    def init_host_collective(self, world_size: int,
                             group_name: str) -> None:
        """Join the gang's host-collective group (docs/collective.md):
        the DCN plane gradient sync / weight broadcast ride when the
        reduction isn't compiled into the step (cross-runtime workers,
        cross-slice sync).  The group name is exported so
        :func:`ray_tpu_torch.train.sync_gradients` finds it from inside the
        user train loop."""
        from ray_tpu_torch.util import collective as col
        col.init_collective_group(world_size, self.world_rank,
                                  group_name=group_name)
        os.environ["RAY_TPU_TORCH_TRAIN_COLLECTIVE_GROUP"] = group_name

    def destroy_host_collective(self, group_name: str) -> None:
        from ray_tpu_torch.util import collective as col
        try:
            col.destroy_collective_group(group_name)
        finally:
            os.environ.pop("RAY_TPU_TORCH_TRAIN_COLLECTIVE_GROUP", None)

    def host_allreduce(self, arr, op: str = "sum", quantize=None):
        """Debug/test hook: one allreduce on the gang's host group."""
        from ray_tpu_torch.util import collective as col
        return col.allreduce(
            arr, os.environ["RAY_TPU_TORCH_TRAIN_COLLECTIVE_GROUP"], op,
            quantize=quantize)

    # -- train loop lifecycle ---------------------------------------------
    def start_training(self, train_fn: Callable, config: Dict[str, Any],
                       *, trial_name: str = "", trial_id: str = "",
                       trial_dir: str = "",
                       experiment_name: str = "",
                       checkpoint=None,
                       dataset_shard=None) -> None:
        if self._thread is not None and self._thread.is_alive():
            raise RuntimeError("training already running on this worker")
        self._done.clear()
        self._error = None
        self._final = None
        shards = {"train": dataset_shard} if dataset_shard is not None else {}
        self._session = air_session.init_session(
            world_rank=self.world_rank, world_size=self.world_size,
            local_rank=self.local_rank,
            local_world_size=self.local_world_size,
            node_rank=self.node_rank,
            trial_name=trial_name, trial_id=trial_id, trial_dir=trial_dir,
            experiment_name=experiment_name,
            dataset_shards=shards, checkpoint=checkpoint)
        # init_session registered under THIS (actor RPC) thread; the runner
        # thread re-registers under its own id below — drop this entry so the
        # process holds exactly one session and get_session()'s any-thread
        # fallback works for user helper threads
        with air_session._session_lock:
            air_session._sessions.pop(threading.get_ident(), None)
        sess = self._session
        run_id = trial_id or uuid.uuid4().hex[:8]
        self._run_id = run_id

        def runner():
            from ray_tpu_torch._private import step_stats
            with air_session._session_lock:
                air_session._sessions[threading.get_ident()] = sess
            try:
                run = self._start_step_stats(run_id, experiment_name)
            except Exception:
                run = None   # observability must never fail the loop
            try:
                self._start_device()
                takes_config = True
                try:
                    import inspect
                    takes_config = len(
                        inspect.signature(train_fn).parameters) > 0
                except (TypeError, ValueError):
                    pass
                self._final = train_fn(config) if takes_config else train_fn()
            except StopIteration:
                pass
            except BaseException:
                self._error = traceback.format_exc()
            finally:
                try:
                    step_stats.end_run(run)
                except Exception:
                    pass
                self._done.set()
                # wake a next_result waiting on the queue: the loop has
                # reported its last item (ray_tpu's worker waits out the
                # driver's 10 s poll when the poll comes first)
                sess.result_queue.put(_LOOP_ENDED)
                with air_session._session_lock:
                    air_session._sessions.pop(threading.get_ident(), None)

        self._thread = threading.Thread(target=runner, daemon=True,
                                        name=f"train_loop_r{self.world_rank}")
        self._thread.start()

    def _start_device(self) -> None:
        """In the loop's thread: a GPU lease starts CUDA on the card the
        raylet handed this worker, and raises without one (no training
        on the CPU in its place); a CPU worker leaves CUDA alone."""
        global _loop_device
        if not self.use_gpu:
            _loop_device = None
            return
        import torch

        from ray_tpu_torch._private.device import resolve_device
        dev = resolve_device(None)
        torch.cuda.set_device(dev)
        _loop_device = dev

    def _start_step_stats(self, run_id: str, experiment_name: str):
        """Open this rank's training-performance-plane run context
        (docs/observability.md): per-step phase clocks + goodput ledger,
        reports riding the worker's GCS client into the cluster step
        table.  The rank metadata (worker id + RPC address) lets
        ``ray-tpu profile --group`` gang-fan-out to every rank."""
        from ray_tpu_torch._private import step_stats
        group = os.environ.get("RAY_TPU_TORCH_TRAIN_COLLECTIVE_GROUP", "") \
            or experiment_name
        sink = None
        meta = {"world": self.world_size, "pid": os.getpid()}
        try:
            from ray_tpu_torch.runtime import core_worker as cw
            worker = cw.get_global_worker()
        except Exception:
            worker = None
        if worker is not None:
            gcs = worker.gcs
            meta.update(worker_id=worker.worker_id.hex(),
                        node_id=worker.node_id,
                        address=list(worker.address))

            def sink(reports):
                gcs.call("report_step_stats", {"reports": reports},
                         timeout=5)
        return step_stats.start_run(
            run_id, group=group, rank=self.world_rank,
            world=self.world_size, sink=sink, meta=meta)

    def training_run_id(self) -> Optional[str]:
        return getattr(self, "_run_id", None)

    def next_result(self, timeout: float = 2.0):
        """Poll one reported (metrics, checkpoint) item, or status sentinels:
        ("done", final_return) / ("error", traceback) / ("timeout",)."""
        sess = self._session
        if sess is not None:
            item = sess.next_result(timeout=0 if self._done.is_set()
                                    else timeout)
            if item is not None and item is not _LOOP_ENDED:
                metrics, ckpt = item
                return ("result", metrics, ckpt)
        if self._done.is_set():
            if self._error is not None:
                return ("error", self._error)
            return ("done", self._final)
        return ("timeout",)

    def request_stop(self) -> None:
        if self._session is not None:
            self._session.stop_requested.set()
            # unblock a report() waiting for consumption
            self._session._consumed.set()

    def is_done(self) -> bool:
        return self._done.is_set()

    def health_check(self) -> bool:
        return True

    def shutdown_jax_distributed(self) -> None:
        """Leave the gang's process group (ray_tpu's name kept)."""
        try:
            import torch.distributed as dist
            if dist.is_initialized():
                dist.destroy_process_group()
        except Exception:
            pass


class WorkerGroup:
    """Driver-side handle to N TrainWorker actors placed one-per-bundle in a
    placement group."""

    def __init__(self, num_workers: int,
                 resources_per_worker: Optional[Dict[str, float]] = None,
                 placement_strategy: str = "PACK"):
        """``resources_per_worker`` may hold ``"GPU"`` (a fraction shares
        one card): each worker then leases it and trains on it."""
        import ray_tpu_torch
        from ray_tpu_torch.util.placement_group import placement_group
        from ray_tpu_torch.util.scheduling_strategies import \
            PlacementGroupSchedulingStrategy

        import time as _time
        self.num_workers = num_workers
        self.created_ts = _time.time()   # gang-watch event horizon
        res = dict(resources_per_worker or {"CPU": 1.0})
        self.pg = placement_group([dict(res) for _ in range(num_workers)],
                                  strategy=placement_strategy)
        if not self.pg.wait(timeout_seconds=60):
            raise TimeoutError(
                f"placement group for {num_workers} train workers "
                f"({res}) not placed in 60s — cluster too small?")
        cpus = res.pop("CPU", 1.0)
        gpus = res.pop("GPU", 0.0)
        cls = ray_tpu_torch.remote(num_cpus=cpus, num_gpus=gpus,
                                   resources=res or None)(TrainWorker)
        self.workers = []
        for rank in range(num_workers):
            strategy = PlacementGroupSchedulingStrategy(
                placement_group=self.pg, placement_group_bundle_index=rank)
            self.workers.append(
                cls.options(scheduling_strategy=strategy).remote(
                    world_rank=rank, world_size=num_workers,
                    node_rank=rank, use_gpu=gpus > 0))

    def execute(self, method: str, *args, **kwargs) -> List[Any]:
        """Call ``method`` on every worker, gather results in rank order."""
        import ray_tpu_torch
        refs = [getattr(w, method).remote(*args, **kwargs)
                for w in self.workers]
        return ray_tpu_torch.get(refs)

    def node_ids(self) -> List[str]:
        """Runtime node ids hosting the gang, in rank order (cached:
        the gang never migrates within one incarnation)."""
        if not getattr(self, "_node_ids", None):
            self._node_ids = self.execute("get_runtime_node_id")
        return list(self._node_ids)

    def execute_single(self, rank: int, method: str, *args, **kwargs) -> Any:
        import ray_tpu_torch
        return ray_tpu_torch.get(
            getattr(self.workers[rank], method).remote(*args, **kwargs))

    def shutdown(self) -> None:
        import ray_tpu_torch
        from ray_tpu_torch.util.placement_group import remove_placement_group
        for w in self.workers:
            try:
                ray_tpu_torch.kill(w)
            except Exception:
                pass
        try:
            remove_placement_group(self.pg)
        except Exception:
            pass
        self.workers = []
