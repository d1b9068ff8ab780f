"""Environment API + in-repo classic-control envs (counterpart of
ray_tpu/rl/env.py; numpy only, so a copy).

RLlib rides gym (rllib/env/); the port ships no gym, so the env
interface here is gymnasium-compatible (reset()->(obs, info),
step()->(obs, reward, terminated, truncated, info)) and user-supplied gym
envs plug in unchanged. CartPole's dynamics follow the classic Barto-
Sutton-Anderson formulation (the same one gym implements) so reference
tuned targets (reward 150 within 100k steps, rllib/tuned_examples/ppo/
cartpole-ppo.yaml) are comparable.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np


class Space:
    def sample(self, rng: np.random.Generator):
        raise NotImplementedError


class Discrete(Space):
    def __init__(self, n: int):
        self.n = n
        self.shape = ()
        self.dtype = np.int32

    def sample(self, rng):
        return int(rng.integers(self.n))

    def __repr__(self):
        return f"Discrete({self.n})"


class Box(Space):
    def __init__(self, low, high, shape=None, dtype=np.float32):
        self.low = np.broadcast_to(np.asarray(low, dtype),
                                   shape or np.shape(low)).copy()
        self.high = np.broadcast_to(np.asarray(high, dtype),
                                    shape or np.shape(high)).copy()
        self.shape = self.low.shape
        self.dtype = dtype

    def sample(self, rng):
        return rng.uniform(self.low, self.high).astype(self.dtype)

    def __repr__(self):
        return f"Box{self.shape}"


class Env:
    observation_space: Space
    action_space: Space

    def reset(self, *, seed: Optional[int] = None) -> Tuple[Any, dict]:
        raise NotImplementedError

    def step(self, action) -> Tuple[Any, float, bool, bool, dict]:
        raise NotImplementedError

    def close(self) -> None:
        pass


class CartPoleEnv(Env):
    """Pole balancing; solved ≈ mean reward 475 (v1 caps at 500)."""

    def __init__(self, max_steps: int = 500):
        self.gravity = 9.8
        self.masscart, self.masspole = 1.0, 0.1
        self.total_mass = self.masscart + self.masspole
        self.length = 0.5
        self.polemass_length = self.masspole * self.length
        self.force_mag = 10.0
        self.tau = 0.02
        self.theta_threshold = 12 * 2 * np.pi / 360
        self.x_threshold = 2.4
        self.max_steps = max_steps
        high = np.array([self.x_threshold * 2, np.inf,
                         self.theta_threshold * 2, np.inf], np.float32)
        self.observation_space = Box(-high, high)
        self.action_space = Discrete(2)
        self._rng = np.random.default_rng()
        self._state = None
        self._steps = 0

    def reset(self, *, seed: Optional[int] = None):
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self._state = self._rng.uniform(-0.05, 0.05, size=4)
        self._steps = 0
        return self._state.astype(np.float32), {}

    def step(self, action):
        x, x_dot, theta, theta_dot = self._state
        force = self.force_mag if action == 1 else -self.force_mag
        costheta, sintheta = np.cos(theta), np.sin(theta)
        temp = (force + self.polemass_length * theta_dot ** 2 * sintheta) \
            / self.total_mass
        thetaacc = (self.gravity * sintheta - costheta * temp) / (
            self.length * (4.0 / 3.0
                           - self.masspole * costheta ** 2 / self.total_mass))
        xacc = temp - self.polemass_length * thetaacc * costheta \
            / self.total_mass
        x = x + self.tau * x_dot
        x_dot = x_dot + self.tau * xacc
        theta = theta + self.tau * theta_dot
        theta_dot = theta_dot + self.tau * thetaacc
        self._state = np.array([x, x_dot, theta, theta_dot])
        self._steps += 1
        terminated = bool(abs(x) > self.x_threshold
                          or abs(theta) > self.theta_threshold)
        truncated = self._steps >= self.max_steps
        return (self._state.astype(np.float32), 1.0, terminated, truncated,
                {})


class PendulumEnv(Env):
    """Continuous-action swing-up (gym Pendulum-v1 dynamics)."""

    def __init__(self, max_steps: int = 200):
        self.max_speed = 8.0
        self.max_torque = 2.0
        self.dt = 0.05
        self.g, self.m, self.length = 10.0, 1.0, 1.0
        self.max_steps = max_steps
        high = np.array([1.0, 1.0, self.max_speed], np.float32)
        self.observation_space = Box(-high, high)
        self.action_space = Box(-self.max_torque, self.max_torque, (1,))
        self._rng = np.random.default_rng()
        self._steps = 0

    def reset(self, *, seed: Optional[int] = None):
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self._th = self._rng.uniform(-np.pi, np.pi)
        self._thdot = self._rng.uniform(-1.0, 1.0)
        self._steps = 0
        return self._obs(), {}

    def _obs(self):
        return np.array([np.cos(self._th), np.sin(self._th), self._thdot],
                        np.float32)

    def step(self, action):
        u = float(np.clip(np.asarray(action).reshape(-1)[0],
                          -self.max_torque, self.max_torque))
        th, thdot = self._th, self._thdot
        norm_th = ((th + np.pi) % (2 * np.pi)) - np.pi
        cost = norm_th ** 2 + 0.1 * thdot ** 2 + 0.001 * u ** 2
        thdot = thdot + (3 * self.g / (2 * self.length) * np.sin(th)
                         + 3.0 / (self.m * self.length ** 2) * u) * self.dt
        thdot = np.clip(thdot, -self.max_speed, self.max_speed)
        self._th = th + thdot * self.dt
        self._thdot = thdot
        self._steps += 1
        return self._obs(), -cost, False, self._steps >= self.max_steps, {}


_REGISTRY: Dict[str, Callable[[], Env]] = {
    "CartPole-v1": CartPoleEnv,
    "Pendulum-v1": PendulumEnv,
}


def register_env(name: str, creator: Callable[[], Env]) -> None:
    """cf. ray.tune.registry.register_env."""
    _REGISTRY[name] = creator


def make_env(spec) -> Env:
    if isinstance(spec, Env):
        return spec
    if callable(spec):
        return spec()
    if isinstance(spec, str):
        if spec not in _REGISTRY:
            raise ValueError(
                f"unknown env {spec!r}; register_env() it first "
                f"(known: {sorted(_REGISTRY)})")
        return _REGISTRY[spec]()
    raise TypeError(f"bad env spec {spec!r}")


class VectorEnv:
    """N synchronous env copies with auto-reset (cf. rllib VectorEnv)."""

    def __init__(self, spec, num_envs: int, seed: Optional[int] = None):
        self.envs: List[Env] = [make_env(spec) for _ in range(num_envs)]
        self.num_envs = num_envs
        self.observation_space = self.envs[0].observation_space
        self.action_space = self.envs[0].action_space
        self._seed = seed

    def reset(self) -> np.ndarray:
        obs = []
        for i, e in enumerate(self.envs):
            seed = None if self._seed is None else self._seed + i
            o, _ = e.reset(seed=seed)
            obs.append(o)
        return np.stack(obs)

    def step(self, actions) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                     np.ndarray, List[dict]]:
        obs, rews, terms, truncs, infos = [], [], [], [], []
        for e, a in zip(self.envs, actions):
            o, r, term, trunc, info = e.step(a)
            if term or trunc:
                info = dict(info, terminal_observation=o)
                o, _ = e.reset()
            obs.append(o)
            rews.append(r)
            terms.append(term)
            truncs.append(trunc)
            infos.append(info)
        return (np.stack(obs), np.asarray(rews, np.float32),
                np.asarray(terms), np.asarray(truncs), infos)
