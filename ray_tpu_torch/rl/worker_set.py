"""WorkerSet: fault-tolerant gang of rollout actors (counterpart of
ray_tpu/rl/worker_set.py) on the port's runtime.

Analog of RLlib's rllib/evaluation/worker_set.py with the restart
behavior of FaultTolerantActorManager (rllib/utils/actor_manager.py):
dead rollout workers are replaced in-place and the round continues with
the survivors' samples.  Each worker is an actor of ``num_cpus=1`` that
leases no GPU, so its process sees ``CUDA_VISIBLE_DEVICES=""``.
"""

from __future__ import annotations

from typing import Any, List

from ray_tpu_torch.rl.rollout_worker import RolloutWorker


class WorkerSet:
    def __init__(self, env_spec, *, num_workers: int, worker_kwargs: dict,
                 recreate_failed_workers: bool = True):
        import ray_tpu_torch as rt
        self._env_spec = env_spec
        self._kwargs = dict(worker_kwargs)
        self._recreate = recreate_failed_workers
        self._cls = rt.remote(num_cpus=1)(RolloutWorker)
        self.workers = [
            self._make(i) for i in range(num_workers)]
        self.num_restarts = 0

    def _make(self, index: int):
        return self._cls.remote(self._env_spec, worker_index=index,
                                **self._kwargs)

    def foreach_worker(self, method: str, *args,
                       timeout: float = 120.0, **kwargs) -> List[Any]:
        """Call ``method`` on all workers; replace any that died (their
        result is dropped this round)."""
        import ray_tpu_torch as rt
        refs = [(i, getattr(w, method).remote(*args, **kwargs))
                for i, w in enumerate(self.workers)]
        out = []
        for i, ref in refs:
            try:
                out.append(rt.get(ref, timeout=timeout))
            except Exception:
                if not self._recreate:
                    raise
                self.workers[i] = self._make(i)
                self.num_restarts += 1
        return out

    def restart_worker(self, index: int, weights=None) -> bool:
        """Replace a dead worker in place (honors recreate_failed_workers;
        returns False and raises if recreation is disabled). Pushes
        ``weights`` to the replacement so its first fragment is on-policy.
        """
        if not self._recreate:
            raise RuntimeError(
                f"rollout worker {index} died and "
                "recreate_failed_workers=False")
        self.workers[index] = self._make(index)
        self.num_restarts += 1
        if weights is not None:
            try:
                self.workers[index].set_weights.remote(weights)
            except Exception:
                pass
        return True

    def sync_weights(self, weights) -> None:
        import ray_tpu_torch as rt
        wref = rt.put(weights)
        self.foreach_worker("set_weights", wref)

    def stop(self) -> None:
        import ray_tpu_torch as rt
        for w in self.workers:
            try:
                rt.kill(w)
            except Exception:
                pass
        self.workers = []
