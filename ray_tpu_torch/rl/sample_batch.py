"""SampleBatch: columnar rollout data (counterpart of
ray_tpu/rl/sample_batch.py; numpy only, so a copy).

Analog of RLlib's rllib/policy/sample_batch.py — a dict of aligned numpy
arrays with the concat/slice/shuffle/minibatch machinery training needs.
Kept numpy-only on the rollout side; the learner copies the batch to
its device once (``rl/algorithm.py`` ``to_device``) and takes each
minibatch's rows there (``minibatch_indices``).  ``minibatches(seed=)``
draws the same numpy permutations as the JAX package, so a seed gives
the same minibatches in both.
"""

from __future__ import annotations

from typing import Iterator, List, Optional

import numpy as np

OBS = "obs"
ACTIONS = "actions"
REWARDS = "rewards"
TERMINATEDS = "terminateds"
TRUNCATEDS = "truncateds"
NEXT_OBS = "next_obs"
VF_PREDS = "vf_preds"
ACTION_LOGP = "action_logp"
ADVANTAGES = "advantages"
VALUE_TARGETS = "value_targets"
EPS_ID = "eps_id"


class SampleBatch(dict):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        for k, v in list(self.items()):
            if not isinstance(v, np.ndarray):
                v = np.asarray(v)
            # columns must be C-contiguous: the serializer only ships
            # contiguous buffers out-of-band (pickle-5), so a strided
            # view (e.g. a [:, i] env slice) would silently fall back
            # to an in-band row-wise copy on every fragment hop
            if not v.flags.c_contiguous:
                v = np.ascontiguousarray(v)
            self[k] = v

    @property
    def count(self) -> int:
        if dict.__len__(self) == 0:
            return 0
        return len(next(iter(self.values())))

    def __len__(self) -> int:  # number of rows, not keys
        return self.count

    @staticmethod
    def concat_samples(batches: List["SampleBatch"]) -> "SampleBatch":
        batches = [b for b in batches if b and b.count]
        if not batches:
            return SampleBatch()
        keys = batches[0].keys()
        return SampleBatch({
            k: np.concatenate([b[k] for b in batches]) for k in keys})

    def slice(self, start: int, end: int) -> "SampleBatch":
        return SampleBatch({k: v[start:end] for k, v in self.items()})

    def shuffle(self, seed: Optional[int] = None) -> "SampleBatch":
        rng = np.random.default_rng(seed)
        perm = rng.permutation(self.count)
        return SampleBatch({k: v[perm] for k, v in self.items()})

    def minibatches(self, size: int,
                    epochs: int = 1,
                    seed: Optional[int] = None) -> Iterator["SampleBatch"]:
        for idx in self.minibatch_indices(size, epochs, seed):
            yield SampleBatch({k: v[idx] for k, v in self.items()})

    def minibatch_indices(self, size: int, epochs: int = 1,
                          seed: Optional[int] = None
                          ) -> Iterator[np.ndarray]:
        """The row indices of each of ``minibatches(size, epochs, seed)``,
        so a learner that holds the batch on its device takes the same
        rows without copying each minibatch from the host."""
        for ep in range(epochs):
            rng = np.random.default_rng(None if seed is None else seed + ep)
            perm = rng.permutation(self.count)
            for start in range(0, self.count - size + 1, size):
                yield perm[start:start + size]

    def split_by_episode(self) -> List["SampleBatch"]:
        if EPS_ID not in self:
            return [self]
        out = []
        ids = self[EPS_ID]
        boundaries = np.where(ids[1:] != ids[:-1])[0] + 1
        start = 0
        for b in list(boundaries) + [len(ids)]:
            out.append(self.slice(start, b))
            start = b
        return out


def compute_gae(batch: SampleBatch, *, gamma: float = 0.99,
                lam: float = 0.95,
                last_value: float = 0.0) -> SampleBatch:
    """Generalized advantage estimation over a (time-ordered) rollout
    fragment (cf. rllib/evaluation/postprocessing.py compute_advantages).
    ``terminateds`` cuts bootstrapping; truncation bootstraps from vf."""
    rewards = batch[REWARDS]
    values = batch[VF_PREDS]
    terms = batch[TERMINATEDS].astype(np.float32)
    n = len(rewards)
    adv = np.zeros(n, np.float32)
    next_value = last_value
    next_adv = 0.0
    for t in range(n - 1, -1, -1):
        nonterminal = 1.0 - terms[t]
        delta = rewards[t] + gamma * next_value * nonterminal - values[t]
        next_adv = delta + gamma * lam * nonterminal * next_adv
        adv[t] = next_adv
        next_value = values[t]
    batch[ADVANTAGES] = adv
    batch[VALUE_TARGETS] = adv + values
    return batch
