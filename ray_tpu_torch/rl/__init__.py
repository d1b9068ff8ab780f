"""ray_tpu_torch.rl: reinforcement learning — CPU rollout actors on the
port's runtime and a learner on the card (counterpart of ray_tpu/rl/).

Ported so far: the fluent AlgorithmConfig, the Algorithm training
loop (with ``as_trainable`` for Tune and the podracer executor behind
``.podracer()``), the WorkerSet of fault-tolerant rollout actors, the
on-policy family (PG, A2C, A3C, PPO, IMPALA with V-trace, APPO), the
replay family (DQN, SimpleQ, Ape-X, R2D2 over uniform and prioritized
replay buffers), continuous control (SAC, DDPG, TD3), the offline path
(JSON I/O, BC, MARWIL, CQL, CRR, IS/WIS estimators) and the Decision
Transformer, with the in-repo gymnasium-compatible envs and the name
registry.  The other algorithms come in later slices (ROADMAP.md, Queue
1, item 4, RL); ``get_algorithm_class`` names the slice of each.
"""

from ray_tpu_torch.rl.a2c import A2C, A2CConfig, A3C, A3CConfig  # noqa: F401
from ray_tpu_torch.rl.algorithm import Algorithm, AlgorithmConfig  # noqa: F401
from ray_tpu_torch.rl.apex_dqn import ApexDQN, ApexDQNConfig  # noqa: F401
from ray_tpu_torch.rl.appo import APPO, APPOConfig  # noqa: F401
from ray_tpu_torch.rl.cql import CQL, CQLConfig  # noqa: F401
from ray_tpu_torch.rl.crr import CRR, CRRConfig  # noqa: F401
from ray_tpu_torch.rl.ddpg import DDPG, DDPGConfig, TD3, TD3Config  # noqa: F401
from ray_tpu_torch.rl.dqn import DQN, DQNConfig  # noqa: F401
from ray_tpu_torch.rl.dt import DT, DTConfig  # noqa: F401
from ray_tpu_torch.rl.env import (Box, CartPoleEnv, Discrete,  # noqa: F401
                                  Env, PendulumEnv, VectorEnv, make_env,
                                  register_env)
from ray_tpu_torch.rl.impala import Impala, ImpalaConfig, vtrace  # noqa: F401
from ray_tpu_torch.rl.offline import (BC, BCConfig, MARWIL,  # noqa: F401
                                      MARWILConfig, JsonReader, JsonWriter,
                                      collect_dataset,
                                      importance_sampling_estimate)
from ray_tpu_torch.rl.pg import PG, PGConfig  # noqa: F401
from ray_tpu_torch.rl.policy import (DDPGPolicy, JaxPolicy,  # noqa: F401
                                     QPolicy, R2D2Policy, SACPolicy)
from ray_tpu_torch.rl.ppo import PPO, PPOConfig  # noqa: F401
from ray_tpu_torch.rl.r2d2 import R2D2, R2D2Config  # noqa: F401
from ray_tpu_torch.rl.registry import get_algorithm_class  # noqa: F401
from ray_tpu_torch.rl.replay_buffer import (  # noqa: F401
    PrioritizedReplayBuffer, ReplayBuffer)
from ray_tpu_torch.rl.rollout_worker import RolloutWorker  # noqa: F401
from ray_tpu_torch.rl.sac import SAC, SACConfig  # noqa: F401
from ray_tpu_torch.rl.sample_batch import SampleBatch, compute_gae  # noqa: F401
from ray_tpu_torch.rl.simple_q import SimpleQ, SimpleQConfig  # noqa: F401
from ray_tpu_torch.rl.worker_set import WorkerSet  # noqa: F401

__all__ = [
    "Algorithm", "AlgorithmConfig", "PPO", "PPOConfig", "Impala",
    "ImpalaConfig", "vtrace", "APPO", "APPOConfig", "DQN", "DQNConfig",
    "SimpleQ", "SimpleQConfig", "ApexDQN", "ApexDQNConfig", "R2D2",
    "R2D2Config", "ReplayBuffer", "PrioritizedReplayBuffer",
    "RolloutWorker", "WorkerSet", "JaxPolicy", "QPolicy", "R2D2Policy",
    "DDPGPolicy", "SACPolicy", "SAC", "SACConfig", "DDPG", "DDPGConfig",
    "TD3", "TD3Config", "PG", "PGConfig", "A2C", "A2CConfig", "A3C",
    "A3CConfig", "CQL", "CQLConfig", "CRR", "CRRConfig",
    "BC", "BCConfig", "MARWIL", "MARWILConfig", "JsonReader", "JsonWriter",
    "collect_dataset", "importance_sampling_estimate", "DT", "DTConfig",
    "get_algorithm_class", "SampleBatch", "compute_gae", "Env", "Box",
    "Discrete", "CartPoleEnv", "PendulumEnv", "VectorEnv", "make_env",
    "register_env",
]
