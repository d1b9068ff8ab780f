"""SimpleQ: the minimal DQN variant — no double-Q, no dueling, no PER
(counterpart of ray_tpu/rl/simple_q.py).

Analog of RLlib's rllib/algorithms/simple_q/simple_q.py, kept as a
distinct entry point because RLlib treats it as the baseline the full
DQN is measured against.  It is the DQN learner with the extensions
switched off.
"""

from __future__ import annotations

from ray_tpu_torch.rl.dqn import DQN, DQNConfig


class SimpleQConfig(DQNConfig):
    def __init__(self):
        super().__init__()
        self.algo_class = SimpleQ
        self.double_q = False
        self.dueling = False
        self.prioritized_replay = False
        self.target_update_freq = 500


class SimpleQ(DQN):
    pass
