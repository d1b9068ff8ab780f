"""A2C / A3C: (a)synchronous advantage actor-critic (counterpart of
ray_tpu/rl/a2c.py).

Analog of RLlib's rllib/algorithms/a2c/a2c.py and a3c/a3c.py
(a3c_torch_policy.py loss: pg + 0.5 vf - entropy, one pass per batch,
``rl/pg.py``'s step without the advantage normalisation) with
``optax.chain(clip_by_global_norm(grad_clip), rmsprop(lr, decay=0.99))``
(``rl/impala.py`` ``RMSProp``).  A2C is the synchronous variant: one
on-policy batch from all workers, one update.  A3C keeps RLlib's
semantics as the JAX package does: instead of lock-free HogWild
gradient application, each worker's fragment is applied on the learner
the moment it arrives (``wait`` / ``get`` with timeouts on the port's
runtime, a dead worker replaced through ``WorkerSet.restart_worker``),
and the fresh weights go back to the producing worker only.
"""

from __future__ import annotations

from typing import Any, Dict

from ray_tpu_torch.rl.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rl.impala import RMSProp
from ray_tpu_torch.rl.pg import PG_KEYS, make_pg_sgd_step
from ray_tpu_torch.rl.sample_batch import SampleBatch


class A2CConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.algo_class = A2C
        self.lr = 1e-3
        self.vf_loss_coeff = 0.5
        self.entropy_coeff = 0.01
        self.train_batch_size = 500
        self.rollout_fragment_length = 50


def make_a2c_optimizer(cfg) -> RMSProp:
    """``optax.chain(clip_by_global_norm(grad_clip), rmsprop(lr,
    decay=0.99))``."""
    lr = cfg.lr
    return RMSProp(lambda count: lr, decay=0.99, grad_clip=cfg.grad_clip)


class A2C(Algorithm):
    def setup_learner(self) -> None:
        cfg: A2CConfig = self.config
        self.model, _, logp_fn, ent_fn = self.init_actor_critic()
        self.tx = make_a2c_optimizer(cfg)
        self.opt_state = self.tx.init(self.params)
        self._sgd_step = make_pg_sgd_step(self.model, logp_fn, ent_fn,
                                          self.tx, cfg,
                                          normalize_advantages=False)

    def _apply_batch(self, batch: SampleBatch) -> Dict[str, Any]:
        n = self.round_minibatch(batch.count)
        self.opt_state, aux = self._sgd_step(
            self.opt_state, self.stage_batch(batch.slice(0, n), PG_KEYS))
        return aux

    def training_step(self) -> Dict[str, Any]:
        cfg: A2CConfig = self.config
        train_batch = self.gather_on_policy_batch(cfg.train_batch_size)
        aux = self._apply_batch(train_batch)
        self.workers.sync_weights(self.get_weights())
        info = {k: float(v) for k, v in aux.items()}
        info["train_batch_size"] = train_batch.count
        return {"info": info}


class A3CConfig(A2CConfig):
    def __init__(self):
        super().__init__()
        self.algo_class = A3C
        self.batches_per_step = 8


class A3C(A2C):
    """Asynchronous variant: per-worker fragments applied as they
    arrive, fresh weights pushed back to the producing worker only (no
    global barrier): the async-update semantics of a3c.py without
    HogWild races."""

    def setup_learner(self) -> None:
        super().setup_learner()
        self._inflight: Dict[Any, int] = {}   # ref -> worker index

    def _submit(self, idx: int) -> None:
        ref = self.workers.workers[idx].sample.remote()
        self._inflight[ref] = idx

    def training_step(self) -> Dict[str, Any]:
        import ray_tpu_torch as rt
        cfg: A3CConfig = self.config
        live = set(self._inflight.values())
        for i in range(len(self.workers.workers)):
            if i not in live:
                self._submit(i)
        aux_last: Dict[str, Any] = {}
        processed = 0
        while processed < cfg.batches_per_step:
            ready, _ = rt.wait(list(self._inflight.keys()),
                               num_returns=1, timeout=60.0)
            if not ready:
                break
            ref = ready[0]
            idx = self._inflight.pop(ref)
            try:
                fragment = rt.get(ref, timeout=30.0)
            except Exception:
                # push the current weights to the replacement before it
                # samples (A3C has no importance correction)
                self.workers.restart_worker(idx, self.get_weights())
                self._submit(idx)
                continue
            aux_last = self._apply_batch(fragment)
            self._timesteps_total += fragment.count
            processed += 1
            try:
                self.workers.workers[idx].set_weights.remote(
                    self.get_weights())
            except Exception:
                pass
            self._submit(idx)
        info = {k: float(v) for k, v in aux_last.items()}
        info["batches_processed"] = processed
        return {"info": info}

    def stop(self) -> None:
        getattr(self, "_inflight", {}).clear()
        super().stop()
