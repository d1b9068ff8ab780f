"""JaxTrainer: the port's flagship trainer (its name kept from
ray_tpu/train/jax_trainer.py, of which this is the port's copy).

The analog of the reference's TorchTrainer (Ray's
python/ray/train/torch/torch_trainer.py + torch/config.py:29).  In
ray_tpu, JaxConfig rendezvouses ``jax.distributed`` across the workers
and the parallelism lives in the mesh compiled into the step.  On the
port each worker trains on its own card with ``train.step.make_train``;
JaxConfig joins the gang's ``torch.distributed`` process group (gloo)
and its host collective group, over which :func:`sync_gradients`
averages the gradients.  Meshes of more than one device, and ray_tpu's
``get_mesh`` / ``set_loop_mesh_shape``, wait for multi-device training
(ROADMAP.md, Queue 1, item 4, multi-device).
"""

from __future__ import annotations

import os
import uuid
from typing import Any, Callable, Dict, List, Optional, Tuple

from ray_tpu_torch.air.config import RunConfig, ScalingConfig
from ray_tpu_torch.train.base_trainer import (BackendConfig,
                                              DataParallelTrainer,
                                              WorkerGroup)


class JaxConfig(BackendConfig):
    """Sets up the gang's process group and host collective.

    ``init_distributed``: multi-worker gangs join one ``torch.distributed``
    process group over gloo at rank 0's address (``TrainWorker.
    setup_jax_distributed``).  ``host_collective`` (default on for
    multi-worker gangs) rendezvouses a DCN collective group over the
    workers (docs/collective.md), through which
    :func:`ray_tpu_torch.train.sync_gradients` reduces gradients.
    ray_tpu's ``platform`` (a ``JAX_PLATFORMS`` pin) has no counterpart:
    a worker's device follows its lease.
    """

    def __init__(self, init_distributed: bool = True,
                 host_collective: bool = True):
        self.init_distributed = init_distributed
        self.host_collective = host_collective
        self._group_name: Optional[str] = None

    def on_start(self, worker_group: WorkerGroup,
                 scaling: ScalingConfig) -> None:
        if scaling.num_workers > 1 and self.host_collective:
            # unique name per run: the nonce-namespaced rendezvous makes
            # even name reuse safe, but a fresh name keeps concurrent
            # trainers in one cluster from colliding at all
            self._group_name = f"train-{uuid.uuid4().hex[:8]}"
            worker_group.execute("init_host_collective",
                                 scaling.num_workers, self._group_name)
        if not self.init_distributed or scaling.num_workers <= 1:
            return
        ip = worker_group.execute_single(0, "get_node_ip")
        port = worker_group.execute_single(0, "find_free_port")
        worker_group.execute("setup_jax_distributed", f"{ip}:{port}")

    def on_shutdown(self, worker_group: WorkerGroup) -> None:
        if self._group_name is not None:
            try:
                worker_group.execute("destroy_host_collective",
                                     self._group_name)
            except Exception:
                pass
            self._group_name = None
        try:
            worker_group.execute("shutdown_jax_distributed")
        except Exception:
            pass


class JaxTrainer(DataParallelTrainer):
    """``JaxTrainer(loop, scaling_config=ScalingConfig(num_workers=1,
    use_gpu=True))``; inside the loop use ``train.get_device()``,
    ``train.sync_gradients`` and the ``air.session`` APIs."""

    backend_config_cls = JaxConfig

    def __init__(self, train_loop_per_worker: Callable, *,
                 train_loop_config: Optional[Dict[str, Any]] = None,
                 jax_config: Optional[JaxConfig] = None,
                 scaling_config: Optional[ScalingConfig] = None,
                 run_config: Optional[RunConfig] = None,
                 datasets: Optional[Dict[str, Any]] = None,
                 resume_from_checkpoint=None):
        super().__init__(
            train_loop_per_worker,
            train_loop_config=dict(train_loop_config or {}),
            backend_config=jax_config or JaxConfig(),
            scaling_config=scaling_config or ScalingConfig(),
            run_config=run_config,
            datasets=datasets,
            resume_from_checkpoint=resume_from_checkpoint)


class PendingSync:
    """An in-flight gradient sync from ``sync_gradients(...,
    async_op=True)``: the bucketed allreduces run on the collective
    group's async worker while the caller keeps computing (the rest of
    backward, optimizer prep).  :meth:`wait` is the fence — it blocks
    until every bucket resolves and assembles the reduced tree; the
    collective telemetry records how much ring time the overlap hid
    (``ray_tpu_collective_overlap_hidden_ms``)."""

    def __init__(self, assemble, handles, record: bool):
        self._assemble = assemble
        self._handles = handles
        self._record = record
        self._result = None
        self._resolved = handles is None

    @classmethod
    def ready(cls, tree) -> "PendingSync":
        """A pre-resolved sync (no group / single worker)."""
        p = cls(None, None, False)
        p._result = tree
        return p

    def done(self) -> bool:
        return self._resolved or all(h.done() for h in self._handles)

    def wait(self, timeout: Optional[float] = None) -> Any:
        if self._resolved:
            return self._result
        if self._record:
            from ray_tpu_torch._private import runtime_metrics as rtm
            from ray_tpu_torch._private import step_stats
            t0 = rtm.now()
            try:
                self._result = self._assemble(timeout)
            finally:
                # only the BLOCKED time lands in the step phase — the
                # hidden portion already paid for itself
                step_stats.record_phase("grad_allreduce",
                                        (rtm.now() - t0) * 1000.0)
        else:
            self._result = self._assemble(timeout)
        self._resolved = True
        self._assemble = self._handles = None
        return self._result


def sync_gradients(tree: Any, *, group_name: Optional[str] = None,
                   op: str = "sum", average: bool = True,
                   quantize: Optional[str] = None,
                   async_op: bool = False) -> Any:
    """Gradient sync over the gang's host (DCN) collective group.

    ``tree`` is nested dicts, lists and tuples of torch tensors (CPU or
    card) or numpy arrays.  The leaves are bucketed per (dtype, device)
    into contiguous buffers of at most ``CONFIG.collective_bucket_bytes``
    apiece (concatenated where they live, then copied to the host once
    per bucket), reduced through
    :func:`ray_tpu_torch.util.collective.allreduce` (pipelined ring /
    hierarchical / shm-arena data plane, docs/collective.md) and put
    back: each result is a tensor on its input's device in its dtype
    (bf16 reduces in fp32), a numpy leaf comes back as numpy.
    ``average=True`` divides float results by the world size.

    ``quantize="int8"`` ships each bucket over the wire as block-scaled
    int8 (docs/collective.md).  ``async_op=True`` returns a
    :class:`PendingSync` at once; ``.wait()`` is the fence that
    assembles the reduced tree.

    Inside a :class:`JaxTrainer` loop the group set up by ``JaxConfig``
    (``host_collective=True``) is found automatically; with no group
    named at all (a single-worker run) the tree comes back as it is.  A
    named group that is not initialised, or an allreduce that fails,
    raises: the local gradients never stand in for the reduced ones.
    """
    from ray_tpu_torch._private import runtime_metrics as rtm
    from ray_tpu_torch._private import step_stats
    from ray_tpu_torch.util import collective as col

    group_name = group_name or os.environ.get(
        "RAY_TPU_TORCH_TRAIN_COLLECTIVE_GROUP", "")
    if not group_name:
        return PendingSync.ready(tree) if async_op else tree
    if not col.is_group_initialized(group_name):
        raise RuntimeError(
            f"sync_gradients: collective group {group_name!r} is not "
            f"initialized in this process")
    world = col.get_collective_group_size(group_name)
    if world <= 1:
        return PendingSync.ready(tree) if async_op else tree
    # training performance plane: the reduction is one step phase — if
    # the loop's StepClock has a step open this lands inside it, else
    # in the run ledger's out-of-step totals (docs/observability.md)
    _t0 = rtm.now()
    pending = _sync_gradients_issue(tree, group_name, op, average,
                                    world, quantize, async_op, col)
    if async_op:
        # issue cost rides the caller's compute; wait() records the
        # blocked remainder as the step's grad_allreduce phase
        return pending
    try:
        return pending.wait()
    finally:
        step_stats.record_phase("grad_allreduce",
                                (rtm.now() - _t0) * 1000.0)


def _flatten(tree: Any) -> Tuple[List[Any], Callable[[List[Any]], Any]]:
    """The leaves of nested dicts / lists / tuples, in order, and a
    function that rebuilds the tree from new leaves."""
    leaves: List[Any] = []

    def walk(x):
        if isinstance(x, dict):
            keys = list(x)
            subs = [walk(x[k]) for k in keys]
            return lambda it: type(x)(
                (k, sub(it)) for k, sub in zip(keys, subs))
        if isinstance(x, (list, tuple)):
            subs = [walk(v) for v in x]
            return lambda it: type(x)(sub(it) for sub in subs)
        leaves.append(x)
        return lambda it: next(it)

    build = walk(tree)
    return leaves, lambda new: build(iter(new))


def _sync_gradients_issue(tree, group_name, op, average, world, quantize,
                          async_op, col):
    import numpy as np
    import torch

    from ray_tpu_torch._private.config import CONFIG

    leaves, rebuild = _flatten(tree)
    is_np = [not torch.is_tensor(leaf) for leaf in leaves]
    ts = [torch.from_numpy(np.ascontiguousarray(leaf)) if n
          else leaf.detach() for leaf, n in zip(leaves, is_np)]
    by_key: Dict[Any, list] = {}
    for idx, t in enumerate(ts):
        by_key.setdefault((t.dtype, t.device), []).append(idx)
    max_b = max(1, int(CONFIG.collective_bucket_bytes))
    plans = []  # (dtype, device, leaf-idx subset, AsyncWork) per bucket
    for (dtype, device), idxs in by_key.items():
        # split each key's leaves into sub-buckets of at most
        # collective_bucket_bytes: every sub-bucket is one async op, so
        # the first bucket's ring traffic starts while later buckets
        # are still being gathered (and, with async_op, while the
        # caller is still computing)
        groups: list = []
        cur, cur_bytes = [], 0
        for i in idxs:
            nbytes = ts[i].numel() * ts[i].element_size()
            if cur and cur_bytes + nbytes > max_b:
                groups.append(cur)
                cur, cur_bytes = [], 0
            cur.append(i)
            cur_bytes += nbytes
        if cur:
            groups.append(cur)
        for g in groups:
            flat = (torch.cat([ts[i].reshape(-1) for i in g]) if len(g) > 1
                    else ts[g[0]].reshape(-1))
            if dtype == torch.bfloat16:
                flat = flat.float()      # numpy has no bfloat16
            bucket = flat.cpu().numpy()
            view = (len(g) == 1 and dtype != torch.bfloat16
                    and device.type == "cpu")
            if async_op and view:
                # the async worker reads the buffer after this call
                # returns — own the bytes in case the caller reuses its
                # gradient storage mid-flight (the sync path: allreduce
                # never mutates its input)
                bucket = bucket.copy()
            h = col.allreduce_async(bucket, group_name, op,
                                    quantize=quantize)
            plans.append((dtype, device, g, h))

    def assemble(timeout):
        col.wait_all([h for *_, h in plans], timeout=timeout)
        out = list(leaves)
        for dtype, device, g, h in plans:
            reduced = h.result()
            if average and op == "sum" and dtype.is_floating_point:
                reduced = reduced / world
            back = torch.from_numpy(np.ascontiguousarray(reduced)).to(
                device=device, dtype=dtype)
            parts = torch.split(back, [ts[i].numel() for i in g])
            for i, part in zip(g, parts):
                part = part.view(ts[i].shape)
                out[i] = part.numpy() if is_np[i] else part
        return rebuild(out)

    return PendingSync(assemble, [h for *_, h in plans], record=async_op)
