"""TorchTrainer: torch.distributed data-parallel training with DDP (the
port's copy of ray_tpu/train/torch_trainer.py).

Parity analog of Ray's python/ray/train/torch/torch_trainer.py +
config.py:29 (TCP rendezvous -> init_process_group) +
train_loop_utils.py (prepare_model/prepare_data_loader): DDP over gloo
on the workers' host memory.  The port's flagship is JaxTrainer (its
name kept from ray_tpu), whose loops run on the card and sync gradients
over the host collective.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

from ray_tpu_torch.air.config import RunConfig, ScalingConfig
from ray_tpu_torch.train.base_trainer import (BackendConfig,
                                              DataParallelTrainer,
                                              WorkerGroup)


class TorchConfig(BackendConfig):
    def __init__(self, backend: str = "gloo", timeout_s: float = 120.0):
        self.backend = backend
        self.timeout_s = timeout_s

    def on_start(self, worker_group: WorkerGroup,
                 scaling: ScalingConfig) -> None:
        if scaling.num_workers <= 1:
            return
        ip = worker_group.execute_single(0, "get_node_ip")
        port = worker_group.execute_single(0, "find_free_port")
        # the process group itself is initialized lazily inside the loop by
        # prepare_model() → _maybe_init_process_group(), rendezvousing on
        # these env vars
        worker_group.execute("set_env", {
            "MASTER_ADDR": ip, "MASTER_PORT": str(port),
            "RAY_TPU_TORCH_TORCH_BACKEND": self.backend,
            "RAY_TPU_TORCH_TORCH_TIMEOUT_S": str(self.timeout_s)})

    def on_shutdown(self, worker_group: WorkerGroup) -> None:
        pass


def _maybe_init_process_group() -> None:
    import os
    from ray_tpu_torch.air import session
    s = session.get_session()
    if s is None or s.world_size <= 1:
        return
    import datetime
    import torch.distributed as dist
    if dist.is_initialized():
        return
    dist.init_process_group(
        backend=os.environ.get("RAY_TPU_TORCH_TORCH_BACKEND", "gloo"),
        rank=s.world_rank, world_size=s.world_size,
        timeout=datetime.timedelta(seconds=float(
            os.environ.get("RAY_TPU_TORCH_TORCH_TIMEOUT_S", "120"))),
        init_method=f"tcp://{os.environ['MASTER_ADDR']}:"
                    f"{os.environ['MASTER_PORT']}")


def prepare_model(model):
    """Wrap an nn.Module in DDP when world_size > 1 (cf. reference
    train/torch/train_loop_utils.py prepare_model)."""
    from ray_tpu_torch.air import session
    _maybe_init_process_group()
    s = session.get_session()
    if s is not None and s.world_size > 1:
        from torch.nn.parallel import DistributedDataParallel
        model = DistributedDataParallel(model)
    return model


def prepare_data_loader(loader):
    """Shard a DataLoader across workers with DistributedSampler."""
    from ray_tpu_torch.air import session
    s = session.get_session()
    if s is None or s.world_size <= 1:
        return loader
    import torch.utils.data as tud
    sampler = tud.distributed.DistributedSampler(
        loader.dataset, num_replicas=s.world_size, rank=s.world_rank)
    return tud.DataLoader(loader.dataset, batch_size=loader.batch_size,
                          sampler=sampler, num_workers=0,
                          collate_fn=loader.collate_fn,
                          drop_last=loader.drop_last)


class TorchTrainer(DataParallelTrainer):
    backend_config_cls = TorchConfig

    def __init__(self, train_loop_per_worker: Callable, *,
                 train_loop_config: Optional[Dict[str, Any]] = None,
                 torch_config: Optional[TorchConfig] = None,
                 scaling_config: Optional[ScalingConfig] = None,
                 run_config: Optional[RunConfig] = None,
                 datasets: Optional[Dict[str, Any]] = None,
                 resume_from_checkpoint=None):
        super().__init__(
            train_loop_per_worker,
            train_loop_config=train_loop_config,
            backend_config=torch_config or TorchConfig(),
            scaling_config=scaling_config,
            run_config=run_config,
            datasets=datasets,
            resume_from_checkpoint=resume_from_checkpoint)
