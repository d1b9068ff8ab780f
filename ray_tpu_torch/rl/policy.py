"""JaxPolicy: action computation in rollout workers (counterpart of
ray_tpu/rl/policy.py; the name is kept, as the port keeps
``JaxTrainer`` and ``JaxPredictor``).

The policy owns an ``ActorCritic`` (``rl/models.py``) on the device it
was built on and a ``torch.Generator`` there for its samples.  Rollout
workers build it on the CPU (``device="cpu"``); the learner updates its
own copy of the network on the card and sends the weights back as a
dict of numpy arrays keyed by state-dict name (``get_weights`` /
``set_weights``), so no CUDA tensor ever reaches a CPU-only actor.

``QPolicy``, ``R2D2Policy``, ``DDPGPolicy`` and ``SACPolicy`` come with
their algorithms (ROADMAP.md, Queue 1, item 4, RL); until then they
raise ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from ray_tpu_torch._private.device import resolve_device
from ray_tpu_torch.rl import models as M
from ray_tpu_torch.rl.env import Box

Weights = Dict[str, np.ndarray]


def module_weights(module: torch.nn.Module) -> Weights:
    """A module's state dict as host numpy arrays (copies)."""
    return {n: t.detach().cpu().numpy().copy()
            for n, t in module.state_dict().items()}


@torch.no_grad()
def load_weights(module: torch.nn.Module, weights: Weights) -> None:
    """Copy numpy (or tensor) weights into a module, in place, on the
    module's own device."""
    sd = module.state_dict()
    missing = set(sd) ^ set(weights)
    if missing:
        raise KeyError(f"weights and module disagree on {sorted(missing)}")
    for n, t in sd.items():
        t.copy_(torch.as_tensor(np.asarray(weights[n])))


def action_dims(observation_space, action_space) -> Tuple[int, int, bool]:
    """(obs_dim, act_dim, continuous) of a pair of spaces."""
    continuous = isinstance(action_space, Box)
    act_dim = (int(np.prod(action_space.shape)) if continuous
               else action_space.n)
    return int(np.prod(observation_space.shape)), act_dim, continuous


class JaxPolicy:
    """``compute_actions(obs, explore=)`` -> (actions, logp, vf_preds) as
    numpy, on the device the policy was built on (default the card)."""

    def __init__(self, observation_space, action_space,
                 hidden=(256, 256), seed: int = 0, *, device=None):
        self.observation_space = observation_space
        self.action_space = action_space
        self.device = resolve_device(device)
        obs_dim, act_dim, self.continuous = action_dims(observation_space,
                                                        action_space)
        self.model = M.init_params(M.ActorCritic(
            obs_dim, act_dim, tuple(hidden), self.continuous,
            device=self.device), seed)
        self.model.eval()
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        if self.continuous:
            self._sample, self._logp = (M.diag_gaussian_sample,
                                        M.diag_gaussian_logp)
        else:
            self._sample, self._logp = (M.categorical_sample,
                                        M.categorical_logp)

    @torch.inference_mode()
    def compute_actions(self, obs: np.ndarray, *, explore: bool = True
                        ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """returns (actions, logp, vf_preds) as numpy."""
        obs = torch.as_tensor(np.asarray(obs, np.float32),
                              device=self.device)
        logits, value = self.model(obs)
        if explore:
            a = self._sample(self._gen, logits)
            logp = self._logp(logits, a)
        elif self.continuous:
            a = logits.chunk(2, dim=-1)[0]
            logp = torch.zeros(a.shape[0])
        else:
            a = torch.argmax(logits, dim=-1)
            logp = torch.zeros(a.shape[0])
        if not self.continuous:
            a = a.int()          # JAX's categorical actions are int32
        return a.cpu().numpy(), logp.cpu().numpy(), value.cpu().numpy()

    def get_weights(self) -> Weights:
        return module_weights(self.model)

    def set_weights(self, weights: Weights) -> None:
        load_weights(self.model, weights)


def _later(name: str, algos: str):
    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            f"{name} comes with {algos} (ROADMAP.md, Queue 1, item 4, RL)")
    return type(name, (), {"__init__": __init__,
                           "__doc__": f"Not ported yet: see {algos}."})


QPolicy = _later("QPolicy", "DQN, SimpleQ and Ape-X")
R2D2Policy = _later("R2D2Policy", "R2D2")
DDPGPolicy = _later("DDPGPolicy", "DDPG/TD3")
SACPolicy = _later("SACPolicy", "SAC")
