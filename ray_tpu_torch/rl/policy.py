"""JaxPolicy: action computation in rollout workers (counterpart of
ray_tpu/rl/policy.py; the name is kept, as the port keeps
``JaxTrainer`` and ``JaxPredictor``).

The policy owns an ``ActorCritic`` (``rl/models.py``) on the device it
was built on and a ``torch.Generator`` there for its samples.  Rollout
workers build it on the CPU (``device="cpu"``); the learner updates its
own copy of the network on the card and sends the weights back as a
dict of numpy arrays keyed by state-dict name (``get_weights`` /
``set_weights``), so no CUDA tensor ever reaches a CPU-only actor.

``QPolicy`` (DQN, SimpleQ, Ape-X) and ``R2D2Policy`` are epsilon-greedy
over a ``QNetwork`` / ``RecurrentQNetwork``; ``SACPolicy`` samples a
tanh-squashed Gaussian and ``DDPGPolicy`` adds Gaussian noise to a
deterministic actor, both rescaled to the Box bounds.  Their exploration
draws come from the policy's ``torch.Generator``, so they agree with
JAX's only in distribution, while the greedy actions and Q-values, and
the deterministic continuous actions, agree numerically.
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
        w = weights[n]
        if isinstance(w, np.ndarray) and not w.flags.writeable:
            w = w.copy()            # a read-only view of the store
        t.copy_(torch.as_tensor(w))


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


def _epsilon_greedy(gen: torch.Generator, greedy: torch.Tensor,
                    n_actions: int, epsilon: float) -> torch.Tensor:
    """Each row's greedy action, or with probability ``epsilon`` one of
    ``n_actions`` drawn uniformly (the JAX package's mix-in)."""
    n = greedy.shape[0]
    randoms = torch.randint(0, n_actions, (n,), generator=gen,
                            device=greedy.device)
    flip = torch.rand(n, generator=gen, device=greedy.device) < epsilon
    return torch.where(flip, randoms, greedy)


class QPolicy:
    """Epsilon-greedy policy over a ``QNetwork`` (DQN-family rollouts).

    The same ``compute_actions`` triple as JaxPolicy, so RolloutWorker
    drives either: logp is zeros (no likelihoods) and the value column
    carries max-Q (for metrics only).  ``dueling`` must match the
    learner's network, or the weight sync's names disagree."""

    def __init__(self, observation_space, action_space,
                 hidden=(256, 256), seed: int = 0, epsilon: float = 1.0,
                 dueling: bool = True, *, device=None):
        if isinstance(action_space, Box):
            raise ValueError("QPolicy requires a discrete action space")
        self.observation_space = observation_space
        self.action_space = action_space
        self.epsilon = epsilon
        self.device = resolve_device(device)
        obs_dim, act_dim, _ = action_dims(observation_space, action_space)
        self.model = M.init_params(M.QNetwork(
            obs_dim, act_dim, tuple(hidden), dueling, device=self.device),
            seed)
        self.model.eval()
        self._gen = torch.Generator(device=self.device).manual_seed(seed)

    def set_epsilon(self, epsilon: float) -> None:
        self.epsilon = float(epsilon)

    def _act(self, q: torch.Tensor, explore: bool):
        greedy = torch.argmax(q, dim=-1)
        if explore and self.epsilon > 0.0:
            actions = _epsilon_greedy(self._gen, greedy,
                                      self.action_space.n, self.epsilon)
        else:
            actions = greedy
        # JAX's argmax actions are int32
        return (actions.int().cpu().numpy(), np.zeros(actions.shape[0]),
                q.max(-1).values.cpu().numpy())

    @torch.inference_mode()
    def compute_actions(self, obs: np.ndarray, *, explore: bool = True
                        ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        obs = torch.as_tensor(np.asarray(obs, np.float32),
                              device=self.device)
        return self._act(self.model(obs), explore)

    def get_weights(self) -> Weights:
        return module_weights(self.model)

    def set_weights(self, weights: Weights) -> None:
        load_weights(self.model, weights)


class R2D2Policy(QPolicy):
    """Recurrent epsilon-greedy policy (R2D2 rollouts): an LSTM carry
    (c, h) per env, stepped one timestep at a time; ``reset_carry`` zeroes
    the rows of envs whose episode ended.  ``carry`` reads as numpy."""

    def __init__(self, observation_space, action_space,
                 hidden=(64,), seed: int = 0, epsilon: float = 1.0,
                 lstm_size: int = 64, num_envs: int = 1, *, device=None):
        if isinstance(action_space, Box):
            raise ValueError("R2D2Policy requires a discrete action space")
        self.observation_space = observation_space
        self.action_space = action_space
        self.epsilon = epsilon
        self.num_envs = num_envs
        self.device = resolve_device(device)
        obs_dim, act_dim, _ = action_dims(observation_space, action_space)
        self.model = M.init_params(M.RecurrentQNetwork(
            obs_dim, act_dim, tuple(hidden), lstm_size, device=self.device),
            seed)
        self.model.eval()
        self._carry = self.model.initial_state(num_envs)
        self._gen = torch.Generator(device=self.device).manual_seed(seed)

    @property
    def carry(self) -> Tuple[np.ndarray, np.ndarray]:
        """The (c, h) carry, [num_envs, lstm_size] each, as numpy."""
        return tuple(t.cpu().numpy() for t in self._carry)

    def reset_carry(self, done_mask: np.ndarray) -> None:
        """Zero the carry for envs whose episode just ended."""
        keep = 1.0 - torch.as_tensor(np.asarray(done_mask, np.float32),
                                     device=self.device)[:, None]
        self._carry = tuple(c * keep for c in self._carry)

    @torch.inference_mode()
    def compute_actions(self, obs: np.ndarray, *, explore: bool = True
                        ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        obs = torch.as_tensor(np.asarray(obs, np.float32),
                              device=self.device)
        q, self._carry = self.model(obs[:, None, :], self._carry)
        return self._act(q[:, 0], explore)


class _ContinuousPolicy:
    """Shared by the continuous-control rollout policies: a Box action
    space, an actor network on ``device`` with its generator, and the
    JAX package's rescale of [-1, 1] actions to the bounds."""

    def __init__(self, name, observation_space, action_space, actor,
                 hidden, seed, device):
        if not isinstance(action_space, Box):
            raise ValueError(f"{name} requires a continuous action space")
        self.observation_space = observation_space
        self.action_space = action_space
        self.device = resolve_device(device)
        obs_dim, act_dim, _ = action_dims(observation_space, action_space)
        self.model = M.init_params(actor(obs_dim, act_dim, tuple(hidden),
                                         device=self.device), seed)
        self.model.eval()
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        # actions are flattened to (B, prod(shape)); bounds follow suit
        self._low = np.asarray(action_space.low, np.float32).reshape(-1)
        self._high = np.asarray(action_space.high, np.float32).reshape(-1)

    def _rescale(self, act: torch.Tensor) -> np.ndarray:
        return self._low + (act.cpu().numpy() + 1.0) * 0.5 * \
            (self._high - self._low)

    def get_weights(self) -> Weights:
        return module_weights(self.model)

    def set_weights(self, weights: Weights) -> None:
        load_weights(self.model, weights)


class DDPGPolicy(_ContinuousPolicy):
    """Deterministic actor plus Gaussian exploration noise of scale
    ``exploration_noise`` in tanh space, clipped to [-1, 1] (DDPG/TD3
    rollouts); logp and the value column are zeros."""

    def __init__(self, observation_space, action_space,
                 hidden=(256, 256), seed: int = 0,
                 exploration_noise: float = 0.1, *, device=None):
        super().__init__("DDPGPolicy", observation_space, action_space,
                         M.DeterministicActor, hidden, seed, device)
        self.noise_scale = float(exploration_noise)

    def set_noise_scale(self, scale: float) -> None:
        self.noise_scale = float(scale)

    @torch.inference_mode()
    def compute_actions(self, obs: np.ndarray, *, explore: bool = True
                        ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        act = self.model(torch.as_tensor(np.asarray(obs, np.float32),
                                         device=self.device))
        if explore and self.noise_scale > 0.0:
            noise = torch.randn(act.shape, generator=self._gen,
                                device=self.device)
            act = (act + self.noise_scale * noise).clamp(-1.0, 1.0)
        zeros = np.zeros(act.shape[0], np.float32)
        return self._rescale(act), zeros, zeros.copy()


class SACPolicy(_ContinuousPolicy):
    """Stochastic squashed-Gaussian policy for SAC rollouts: actions
    tanh(N(mean, std)) rescaled to the Box bounds with the logp of the
    squashed sample, or tanh(mean) with zeros when ``explore=False``;
    the value column is zeros (SAC's critics live on the learner)."""

    def __init__(self, observation_space, action_space,
                 hidden=(256, 256), seed: int = 0, *, device=None):
        super().__init__("SACPolicy", observation_space, action_space,
                         M.SquashedGaussianActor, hidden, seed, device)

    @torch.inference_mode()
    def compute_actions(self, obs: np.ndarray, *, explore: bool = True
                        ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        mean, log_std = self.model(torch.as_tensor(
            np.asarray(obs, np.float32), device=self.device))
        if explore:
            act, logp = M.squashed_sample_logp(self._gen, mean, log_std)
            logp = logp.cpu().numpy()
        else:
            act = torch.tanh(mean)
            logp = np.zeros(act.shape[0], np.float32)
        return (self._rescale(act), logp,
                np.zeros(act.shape[0], np.float32))
