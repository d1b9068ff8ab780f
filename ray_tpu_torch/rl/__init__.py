"""ray_tpu_torch.rl: reinforcement learning — CPU rollout actors on the
port's runtime and a learner on the card (counterpart of ray_tpu/rl/).

Ported so far: the fluent AlgorithmConfig, the Algorithm training
loop, the WorkerSet of fault-tolerant rollout actors, PPO,
IMPALA (V-trace), the offline path (JSON I/O, BC, MARWIL, IS/WIS
estimators) and the Decision Transformer, with the in-repo
gymnasium-compatible envs and the name registry.  The other algorithms
come in later slices (ROADMAP.md, Queue 1, item 4, RL);
``get_algorithm_class`` names the slice of each.
"""

from ray_tpu_torch.rl.algorithm import Algorithm, AlgorithmConfig  # noqa: F401
from ray_tpu_torch.rl.dt import DT, DTConfig  # noqa: F401
from ray_tpu_torch.rl.env import (Box, CartPoleEnv, Discrete,  # noqa: F401
                                  Env, PendulumEnv, VectorEnv, make_env,
                                  register_env)
from ray_tpu_torch.rl.impala import Impala, ImpalaConfig, vtrace  # noqa: F401
from ray_tpu_torch.rl.offline import (BC, BCConfig, MARWIL,  # noqa: F401
                                      MARWILConfig, JsonReader, JsonWriter,
                                      collect_dataset,
                                      importance_sampling_estimate)
from ray_tpu_torch.rl.policy import JaxPolicy  # noqa: F401
from ray_tpu_torch.rl.ppo import PPO, PPOConfig  # noqa: F401
from ray_tpu_torch.rl.registry import get_algorithm_class  # noqa: F401
from ray_tpu_torch.rl.rollout_worker import RolloutWorker  # noqa: F401
from ray_tpu_torch.rl.sample_batch import SampleBatch, compute_gae  # noqa: F401
from ray_tpu_torch.rl.worker_set import WorkerSet  # noqa: F401

__all__ = [
    "Algorithm", "AlgorithmConfig", "PPO", "PPOConfig", "Impala",
    "ImpalaConfig", "vtrace", "RolloutWorker", "WorkerSet", "JaxPolicy",
    "BC", "BCConfig", "MARWIL", "MARWILConfig", "JsonReader", "JsonWriter",
    "collect_dataset", "importance_sampling_estimate", "DT", "DTConfig",
    "get_algorithm_class", "SampleBatch", "compute_gae", "Env", "Box",
    "Discrete", "CartPoleEnv", "PendulumEnv", "VectorEnv", "make_env",
    "register_env",
]
