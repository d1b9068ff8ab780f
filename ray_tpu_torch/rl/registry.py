"""Algorithm registry: name -> (Algorithm, AlgorithmConfig) (counterpart
of ray_tpu/rl/registry.py).

Analog of RLlib's rllib/algorithms/registry.py (get_algorithm_class) —
the string lookup used by the CLI, Tune experiment specs, and tests.
The port resolves the algorithms it has: PPO, IMPALA, APPO, PG, A2C,
A3C, DQN, SimpleQ, Ape-X, R2D2, SAC, DDPG, TD3, BC, MARWIL, CQL, CRR and
DT.  Every other name of the JAX package's registry raises
``NotImplementedError`` naming the ROADMAP item that brings it.
"""

from __future__ import annotations

from typing import Dict, Tuple


def get_algorithm_class(name: str, return_config: bool = False):
    """Look up an algorithm by its registry name (case-insensitive)."""
    key = name.lower().replace("-", "").replace("_", "")
    if key in _LATER:
        raise NotImplementedError(
            f"algorithm {name!r} is not ported yet: it comes with "
            f"{_LATER[key]} (ROADMAP.md, Queue 1, item 4, RL)")
    try:
        algo_cls, cfg_cls = _REGISTRY[key]()
    except KeyError:
        raise ValueError(
            f"unknown algorithm {name!r}; known: {sorted(POLICIES)}")
    if return_config:
        return algo_cls, cfg_cls
    return algo_cls


def _ppo():
    from ray_tpu_torch.rl.ppo import PPO, PPOConfig
    return PPO, PPOConfig


def _impala():
    from ray_tpu_torch.rl.impala import Impala, ImpalaConfig
    return Impala, ImpalaConfig


def _appo():
    from ray_tpu_torch.rl.appo import APPO, APPOConfig
    return APPO, APPOConfig


def _dqn():
    from ray_tpu_torch.rl.dqn import DQN, DQNConfig
    return DQN, DQNConfig


def _simple_q():
    from ray_tpu_torch.rl.simple_q import SimpleQ, SimpleQConfig
    return SimpleQ, SimpleQConfig


def _apex_dqn():
    from ray_tpu_torch.rl.apex_dqn import ApexDQN, ApexDQNConfig
    return ApexDQN, ApexDQNConfig


def _r2d2():
    from ray_tpu_torch.rl.r2d2 import R2D2, R2D2Config
    return R2D2, R2D2Config


def _pg():
    from ray_tpu_torch.rl.pg import PG, PGConfig
    return PG, PGConfig


def _a2c():
    from ray_tpu_torch.rl.a2c import A2C, A2CConfig
    return A2C, A2CConfig


def _a3c():
    from ray_tpu_torch.rl.a2c import A3C, A3CConfig
    return A3C, A3CConfig


def _sac():
    from ray_tpu_torch.rl.sac import SAC, SACConfig
    return SAC, SACConfig


def _ddpg():
    from ray_tpu_torch.rl.ddpg import DDPG, DDPGConfig
    return DDPG, DDPGConfig


def _td3():
    from ray_tpu_torch.rl.ddpg import TD3, TD3Config
    return TD3, TD3Config


def _cql():
    from ray_tpu_torch.rl.cql import CQL, CQLConfig
    return CQL, CQLConfig


def _crr():
    from ray_tpu_torch.rl.crr import CRR, CRRConfig
    return CRR, CRRConfig


def _bc():
    from ray_tpu_torch.rl.offline import BC, BCConfig
    return BC, BCConfig


def _marwil():
    from ray_tpu_torch.rl.offline import MARWIL, MARWILConfig
    return MARWIL, MARWILConfig


def _dt():
    from ray_tpu_torch.rl.dt import DT, DTConfig
    return DT, DTConfig


_REGISTRY = {
    "ppo": _ppo,
    "impala": _impala,
    "appo": _appo,
    "pg": _pg,
    "a2c": _a2c,
    "a3c": _a3c,
    "dqn": _dqn,
    "simpleq": _simple_q,
    "apexdqn": _apex_dqn,
    "r2d2": _r2d2,
    "sac": _sac,
    "ddpg": _ddpg,
    "td3": _td3,
    "bc": _bc,
    "marwil": _marwil,
    "cql": _cql,
    "crr": _crr,
    "dt": _dt,
}

# the rest of the JAX package's registry, by the slice that ports it
_SLICES = (
    ("multi_agent, MADDPG and QMIX", ("maddpg", "qmix")),
    ("the model-based and search families",
     ("dreamer", "mbmpo", "maml", "alphazero", "alphastar", "slateq",
      "es", "ars", "banditlinucb", "banditlints")),
)
_LATER: Dict[str, str] = {key: slice_ for slice_, keys in _SLICES
                          for key in keys}

POLICIES: Tuple[str, ...] = tuple(sorted(list(_REGISTRY) + list(_LATER)))
