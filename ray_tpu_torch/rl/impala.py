"""IMPALA: async actor-learner training with V-trace (counterpart of
ray_tpu/rl/impala.py).

Analog of RLlib's rllib/algorithms/impala/impala.py (training_step: an
async rollout queue feeding the learner) with the V-trace correction of
vtrace_torch.py (Espeholt et al. 2018).  Rollout actors free-run with
stale weights; each completed fragment triggers one learner step and a
weight push back to that actor only — no global sync barrier.  One
fragment per worker is in flight (``ray_tpu_torch.wait``).

``vtrace`` runs its backward recursion as a reverse loop over the
fragment's T steps (``lax.scan(reverse=True)`` in the JAX package).  The
optimizer is optax's ``rmsprop(lr, decay=0.99)`` after the global-norm
clip (``RMSProp``): ``eps`` inside the square root and the second moment
starting at 0, which ``torch.optim.RMSprop`` (``eps`` outside) is not.
"""

from __future__ import annotations

from typing import Any, Callable, Dict

import torch

from ray_tpu_torch.rl import sample_batch as SB
from ray_tpu_torch.rl.algorithm import (Algorithm, AlgorithmConfig,
                                        to_device)
from ray_tpu_torch.train.step import _clip_scale

Params = Dict[str, torch.Tensor]


@torch.no_grad()
def vtrace(target_logp, behavior_logp, rewards, values, bootstrap_value,
           discounts, rho_bar: float = 1.0, c_bar: float = 1.0):
    """V-trace targets/advantages over a [T, B] fragment (time-major).

    discounts: gamma * (1 - done) per step. Returns (vs, pg_advantages),
    both without gradient."""
    target_logp, values, bootstrap_value = (
        t.detach() for t in (target_logp, values, bootstrap_value))
    rhos = torch.exp(target_logp - behavior_logp)
    clipped_rhos = rhos.clamp(max=rho_bar)
    cs = rhos.clamp(max=c_bar)
    values_t_plus_1 = torch.cat([values[1:], bootstrap_value[None]], 0)
    deltas = clipped_rhos * (rewards + discounts * values_t_plus_1 - values)
    vs_minus_v = torch.empty_like(deltas)
    acc = torch.zeros_like(bootstrap_value)
    for t in range(deltas.shape[0] - 1, -1, -1):
        acc = deltas[t] + discounts[t] * cs[t] * acc
        vs_minus_v[t] = acc
    vs = vs_minus_v + values
    vs_t_plus_1 = torch.cat([vs[1:], bootstrap_value[None]], 0)
    pg_adv = clipped_rhos * (rewards + discounts * vs_t_plus_1 - values)
    return vs, pg_adv


class ImpalaConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.lr = 5e-4
        self.vf_loss_coeff = 0.5
        self.entropy_coeff = 0.01
        self.vtrace_rho_bar = 1.0
        self.vtrace_c_bar = 1.0
        self.batches_per_step = 8
        self.rollout_fragment_length = 50
        self.algo_class = Impala


class RMSProp:
    """``optax.chain(clip_by_global_norm(grad_clip), rmsprop(lr, decay,
    eps))`` over named parameters, applied in place: ``nu = decay * nu +
    (1 - decay) * g^2`` from ``nu = 0``, then ``p -= lr * g / sqrt(nu +
    eps)``."""

    def __init__(self, lr: Callable[[int], float], *, decay: float,
                 grad_clip: float, eps: float = 1e-8):
        self.lr, self.decay, self.eps = lr, decay, eps
        self.grad_clip = grad_clip

    def init(self, params: Params) -> Dict[str, Any]:
        return {"count": 0,
                "nu": {n: torch.zeros_like(p, dtype=torch.float32)
                       for n, p in params.items()}}

    @torch.no_grad()
    def update(self, params: Params, grads: Params,
               state: Dict[str, Any]) -> Dict[str, Any]:
        names = list(params)
        gs = [grads[n].float() for n in names]
        gs = torch._foreach_mul(gs, _clip_scale(gs, self.grad_clip))
        nu = [state["nu"][n] for n in names]
        torch._foreach_mul_(nu, self.decay)
        torch._foreach_addcmul_(nu, gs, gs, value=1 - self.decay)
        denom = torch._foreach_sqrt(torch._foreach_add(nu, self.eps))
        torch._foreach_div_(gs, denom)
        torch._foreach_add_([params[n] for n in names], gs,
                            alpha=-self.lr(state["count"]))
        return {"count": state["count"] + 1, "nu": state["nu"]}


def make_impala_optimizer(cfg) -> RMSProp:
    lr = cfg.lr
    return RMSProp(lambda count: lr, decay=0.99, grad_clip=cfg.grad_clip)


def make_impala_sgd_step(model, logp_fn, ent_fn, tx: RMSProp, cfg):
    """``sgd_step(opt_state, batch) -> (opt_state, aux)``: the V-trace
    learner step over a [T, B] time-major fragment, updating ``model`` in
    place; ``aux`` holds 0-d tensors."""
    gamma = cfg.gamma
    vf_coeff, ent_coeff = cfg.vf_loss_coeff, cfg.entropy_coeff
    rho_bar, c_bar = cfg.vtrace_rho_bar, cfg.vtrace_c_bar

    def loss_fn(batch):
        T, B = batch[SB.REWARDS].shape
        obs = batch[SB.OBS]
        logits, values = model(obs.reshape((T * B,) + obs.shape[2:]))
        logits = logits.reshape((T, B) + logits.shape[1:])
        values = values.reshape(T, B)
        _, boot_value = model(batch["bootstrap_obs"])
        target_logp = logp_fn(logits, batch[SB.ACTIONS])
        discounts = gamma * (1.0 - batch[SB.TERMINATEDS].float())
        vs, pg_adv = vtrace(target_logp, batch[SB.ACTION_LOGP],
                            batch[SB.REWARDS], values, boot_value,
                            discounts, rho_bar, c_bar)
        pg_loss = -(target_logp * pg_adv).mean()
        vf_loss = 0.5 * (vs - values).square().mean()
        entropy = ent_fn(logits).mean()
        total = pg_loss + vf_coeff * vf_loss - ent_coeff * entropy
        return total, {"policy_loss": pg_loss, "vf_loss": vf_loss,
                       "entropy": entropy}

    def sgd_step(opt_state, batch):
        params = dict(model.named_parameters())
        loss, aux = loss_fn(batch)
        grads = dict(zip(params, torch.autograd.grad(loss,
                                                     list(params.values()))))
        aux = {k: v.detach() for k, v in aux.items()}
        aux["total_loss"] = loss.detach()
        return tx.update(params, grads, opt_state), aux

    return sgd_step


class Impala(Algorithm):
    podracer_algo = "impala"

    def setup_learner(self) -> None:
        cfg: ImpalaConfig = self.config
        self.model, _, logp_fn, ent_fn = self.init_actor_critic()
        self.tx = make_impala_optimizer(cfg)
        self.opt_state = self.tx.init(self.params)
        self._inflight: Dict[Any, int] = {}   # ref -> worker index
        self._sgd_step = make_impala_sgd_step(
            self.model, logp_fn, ent_fn, self.tx, cfg)

    def _submit(self, idx: int) -> None:
        ref = self.workers.workers[idx].sample_time_major.remote()
        self._inflight[ref] = idx

    def training_step(self) -> Dict[str, Any]:
        import ray_tpu_torch as rt
        cfg: ImpalaConfig = self.config
        # keep one fragment in flight per worker
        live = set(self._inflight.values())
        for i in range(len(self.workers.workers)):
            if i not in live:
                self._submit(i)
        aux_last: Dict[str, Any] = {}
        processed = 0
        steps = 0
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
                # worker died mid-fragment: replace it and move on
                self.workers.restart_worker(idx, self.get_weights())
                self._submit(idx)
                continue
            batch = to_device(fragment, self.device)
            self.opt_state, aux = self._sgd_step(self.opt_state, batch)
            aux_last = aux
            steps += fragment[SB.REWARDS].size
            processed += 1
            # push fresh weights only to the actor we just consumed
            try:
                self.workers.workers[idx].set_weights.remote(
                    self.get_weights())
            except Exception:
                pass
            self._submit(idx)
        self._timesteps_total += steps
        info = {k: float(v) for k, v in aux_last.items()}
        info["batches_processed"] = processed
        return {"info": info}

    def stop(self) -> None:
        getattr(self, "_inflight", {}).clear()
        super().stop()
