"""Replay buffers: uniform + prioritized (counterpart of
ray_tpu/rl/replay_buffer.py).

Analog of RLlib's rllib/utils/replay_buffers/ (replay_buffer.py,
prioritized_replay_buffer.py with sum-tree sampling).  Host numpy, as in
the JAX package: the same seed and the same adds give the same indices
and importance weights.  The learner stages each sampled batch on its
device (``Algorithm.stage_batch``).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from ray_tpu_torch.rl.sample_batch import SampleBatch


class ReplayBuffer:
    """Uniform ring buffer over rows."""

    def __init__(self, capacity: int, seed: Optional[int] = None):
        self.capacity = capacity
        self._cols: Optional[Dict[str, np.ndarray]] = None
        self._size = 0
        self._next = 0
        self._rng = np.random.default_rng(seed)

    def __len__(self):
        return self._size

    def add(self, batch: SampleBatch) -> None:
        n = batch.count
        if self._cols is None:
            self._cols = {
                k: np.zeros((self.capacity,) + v.shape[1:], v.dtype)
                for k, v in batch.items()}
        for start in range(0, n, self.capacity):
            chunk = batch.slice(start, min(start + self.capacity, n))
            c = chunk.count
            end = self._next + c
            for k, v in chunk.items():
                if end <= self.capacity:
                    self._cols[k][self._next:end] = v
                else:
                    split = self.capacity - self._next
                    self._cols[k][self._next:] = v[:split]
                    self._cols[k][:end % self.capacity] = v[split:]
            self._next = end % self.capacity
            self._size = min(self._size + c, self.capacity)

    def sample(self, num_items: int) -> SampleBatch:
        idx = self._rng.integers(0, self._size, num_items)
        return SampleBatch({k: v[idx] for k, v in self._cols.items()})


class PrioritizedReplayBuffer(ReplayBuffer):
    """Proportional prioritization (sum-tree) with importance weights."""

    def __init__(self, capacity: int, alpha: float = 0.6,
                 seed: Optional[int] = None):
        super().__init__(capacity, seed)
        self.alpha = alpha
        # sum tree over capacity leaves
        self._tree_size = 1
        while self._tree_size < capacity:
            self._tree_size *= 2
        self._tree = np.zeros(2 * self._tree_size)
        self._max_priority = 1.0

    def _set_priority(self, idx: int, priority: float) -> None:
        pos = self._tree_size + idx
        delta = priority - self._tree[pos]
        while pos >= 1:
            self._tree[pos] += delta
            pos //= 2

    def add(self, batch: SampleBatch) -> None:
        start = self._next
        n = batch.count
        super().add(batch)
        p = self._max_priority ** self.alpha
        for i in range(n):
            self._set_priority((start + i) % self.capacity, p)

    def sample(self, num_items: int, beta: float = 0.4) -> SampleBatch:
        total = self._tree[1]
        targets = self._rng.uniform(0, total, num_items)
        idx = np.empty(num_items, np.int64)
        for j, t in enumerate(targets):
            pos = 1
            while pos < self._tree_size:
                left = 2 * pos
                if self._tree[left] >= t:
                    pos = left
                else:
                    t -= self._tree[left]
                    pos = left + 1
            idx[j] = min(pos - self._tree_size, self._size - 1)
        probs = self._tree[self._tree_size + idx] / max(total, 1e-9)
        weights = (self._size * probs) ** (-beta)
        weights = weights / weights.max()
        out = SampleBatch({k: v[idx] for k, v in self._cols.items()})
        out["batch_indexes"] = idx
        out["weights"] = weights.astype(np.float32)
        return out

    def update_priorities(self, idx: np.ndarray,
                          priorities: np.ndarray) -> None:
        for i, p in zip(idx, priorities):
            p = float(abs(p)) + 1e-6
            self._max_priority = max(self._max_priority, p)
            self._set_priority(int(i), p ** self.alpha)
