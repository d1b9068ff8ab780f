"""Ape-X DQN: distributed prioritized experience replay (counterpart of
ray_tpu/rl/apex_dqn.py).

Analog of RLlib's rllib/algorithms/apex_dqn/apex_dqn.py (Horgan et al.):
many rollout workers free-run with a per-worker epsilon ladder (worker i
explores at eps^(1 + i alpha / (N - 1))), transitions stream
asynchronously into a prioritized replay buffer, and the learner makes
TD updates continuously — no sampling/learning barrier.  It is the DQN
learner (double-Q, dueling, PER) with IMPALA-style asynchronous
collection (``ray_tpu_torch.wait``); one object-store ``put`` of the
weights serves every worker whose fragment landed.
"""

from __future__ import annotations

from typing import Any, Dict, List

from ray_tpu_torch.rl.dqn import DQN, DQN_KEYS, DQNConfig
from ray_tpu_torch.rl.replay_buffer import PrioritizedReplayBuffer


class ApexDQNConfig(DQNConfig):
    def __init__(self):
        super().__init__()
        self.algo_class = ApexDQN
        self.prioritized_replay = True
        self.num_rollout_workers = 4
        self.epsilon_base = 0.4         # Ape-X ladder: eps^(1+i*alpha/(N-1))
        self.epsilon_alpha = 7.0
        self.n_updates_per_iter = 64
        self.learning_starts = 1000
        self.rollout_fragment_length = 50
        self.max_pending_per_worker = 1


def epsilon_ladder(n: int, base: float, alpha: float) -> List[float]:
    """Each of ``n`` workers' fixed epsilon (Horgan et al. eq. 1)."""
    return [base ** (1.0 + (i * alpha) / max(n - 1, 1)) for i in range(n)]


class ApexDQN(DQN):
    def setup_learner(self) -> None:
        super().setup_learner()
        assert isinstance(self.buffer, PrioritizedReplayBuffer)
        cfg: ApexDQNConfig = self.config
        self._inflight: Dict[Any, int] = {}
        # the WorkerSet starts max(num_rollout_workers, 1) workers
        self._epsilons = epsilon_ladder(max(cfg.num_rollout_workers, 1),
                                        cfg.epsilon_base, cfg.epsilon_alpha)

    def _submit(self, idx: int) -> None:
        ref = self.workers.workers[idx].sample_transitions.remote()
        self._inflight[ref] = idx

    def training_step(self) -> Dict[str, Any]:
        import ray_tpu_torch as rt
        cfg: ApexDQNConfig = self.config
        # keep every worker busy at its ladder epsilon
        live = set(self._inflight.values())
        for i in range(len(self.workers.workers)):
            if i not in live:
                self.workers.workers[i].set_epsilon.remote(self._epsilons[i])
                self._submit(i)
        # drain whatever has landed (no waiting on stragglers)
        ready, _ = rt.wait(list(self._inflight.keys()),
                           num_returns=len(self._inflight), timeout=2.0)
        wref = rt.put(self.get_weights()) if ready else None
        for ref in ready:
            idx = self._inflight.pop(ref)
            try:
                batch = rt.get(ref, timeout=30.0)
            except Exception:
                # the replacement needs its ladder epsilon back, or it
                # would explore at QPolicy's default epsilon=1.0 forever
                self.workers.restart_worker(idx, self.get_weights())
                self.workers.workers[idx].set_epsilon.remote(
                    self._epsilons[idx])
                self._submit(idx)
                continue
            self._add(batch, batch.count)
            # fresh weights only to the producer (asynchronous, no
            # barrier); one shared object-store put serves every ready
            # worker
            try:
                self.workers.workers[idx].set_weights.remote(wref)
            except Exception:
                pass
            self._submit(idx)
        info: Dict[str, Any] = {"buffer_size": len(self.buffer),
                                "batches_received": len(ready),
                                "epsilons": self._epsilons}
        if len(self.buffer) < cfg.learning_starts:
            return {"info": info}
        self._replay_updates(DQN_KEYS, info)
        return {"info": info}

    def stop(self) -> None:
        self._inflight.clear()
        super().stop()
