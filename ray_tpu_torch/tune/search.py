"""Search algorithms: suggest configs for new trials (the port's copy of
ray_tpu/tune/search.py).

Analog of Ray's python/ray/tune/search/ (BasicVariantGenerator
basic_variant.py, Searcher searcher.py, ConcurrencyLimiter).
"""

from __future__ import annotations

import random
from typing import Any, Dict, List, Optional

from ray_tpu_torch.tune.sample import Domain, SampleFrom, generate_variants


class Searcher:
    """Suggest/observe interface (cf. reference search/searcher.py)."""

    def __init__(self, metric: Optional[str] = None, mode: str = "max"):
        self.metric = metric
        self.mode = mode

    def set_search_properties(self, metric: Optional[str], mode: str,
                              config: Dict[str, Any]) -> bool:
        if metric:
            self.metric = metric
        if mode:
            self.mode = mode
        return True

    def suggest(self, trial_id: str) -> Optional[Dict[str, Any]]:
        raise NotImplementedError

    def on_trial_result(self, trial_id: str,
                        result: Dict[str, Any]) -> None:
        pass

    def on_trial_complete(self, trial_id: str,
                          result: Optional[Dict[str, Any]] = None,
                          error: bool = False) -> None:
        pass

    def advance_restored(self, trial_id: str, live: bool) -> None:
        """Experiment restore: advance a deterministic searcher past a
        config that was already handed out before the restart (the stored
        config is reused; the suggestion is discarded)."""
        self.suggest(trial_id)


class BasicVariantGenerator(Searcher):
    """Grid × random expansion of the param space, computed up front."""

    def __init__(self, space: Optional[Dict[str, Any]] = None,
                 num_samples: int = 1, seed: Optional[int] = None):
        super().__init__()
        self._space = space or {}
        self._num_samples = num_samples
        self._rng = random.Random(seed)
        self._variants: Optional[List[Dict[str, Any]]] = None
        self._idx = 0

    def set_search_properties(self, metric, mode, config) -> bool:
        if config:
            self._space = config
            self._variants = None
        return super().set_search_properties(metric, mode, config)

    def _ensure(self):
        if self._variants is None:
            self._variants = generate_variants(
                self._space, self._rng, self._num_samples)

    @property
    def total_trials(self) -> int:
        self._ensure()
        return len(self._variants)

    def suggest(self, trial_id: str) -> Optional[Dict[str, Any]]:
        self._ensure()
        if self._idx >= len(self._variants):
            return None
        cfg = self._variants[self._idx]
        self._idx += 1
        return cfg


class RandomSearch(Searcher):
    """Endless random sampling (``num_samples`` enforced by the Tuner)."""

    def __init__(self, space: Dict[str, Any], seed: Optional[int] = None):
        super().__init__()
        self._space = space
        self._rng = random.Random(seed)

    def suggest(self, trial_id: str) -> Optional[Dict[str, Any]]:
        return generate_variants(self._space, self._rng, 1)[0]


class ConcurrencyLimiter(Searcher):
    """Cap in-flight suggestions (cf. reference ConcurrencyLimiter)."""

    def __init__(self, searcher: Searcher, max_concurrent: int):
        super().__init__(searcher.metric, searcher.mode)
        self.searcher = searcher
        self.max_concurrent = max_concurrent
        self._live: set = set()

    def set_search_properties(self, metric, mode, config) -> bool:
        super().set_search_properties(metric, mode, config)
        return self.searcher.set_search_properties(metric, mode, config)

    def suggest(self, trial_id: str) -> Optional[Dict[str, Any]]:
        if len(self._live) >= self.max_concurrent:
            return None   # back off; runner retries later
        cfg = self.searcher.suggest(trial_id)
        if cfg is not None:
            self._live.add(trial_id)
        return cfg

    def on_trial_result(self, trial_id, result):
        self.searcher.on_trial_result(trial_id, result)

    def on_trial_complete(self, trial_id, result=None, error=False):
        self._live.discard(trial_id)
        self.searcher.on_trial_complete(trial_id, result, error)

    def advance_restored(self, trial_id, live):
        # bypass the cap (restored trials already exist) but keep the
        # in-flight ledger honest for the ones about to run again
        self.searcher.advance_restored(trial_id, live)
        if live:
            self._live.add(trial_id)


def _gridless(space: Dict[str, Any]) -> Dict[str, Any]:
    """Replace grid_search leaves with Choice so per-trial sampling covers
    every grid value (grid expansion is a BasicVariant concept; model-based
    searchers draw one config at a time)."""
    from ray_tpu_torch.tune.sample import Choice, _grid_values, _is_grid
    out = {}
    for k, v in space.items():
        if _is_grid(v):
            out[k] = Choice(_grid_values(v))
        elif isinstance(v, dict):
            out[k] = _gridless(v)
        else:
            out[k] = v
    return out


class TPESearcher(Searcher):
    """Tree-structured Parzen Estimator (the algorithm behind the
    reference's hyperopt/optuna integrations — search/hyperopt/,
    search/optuna/ — implemented natively so no external package is
    needed). Observations are split into good/bad sets at quantile
    ``gamma``; numeric dims get Gaussian Parzen windows, categorical dims
    get smoothed count ratios; candidates maximize l(x)/g(x).
    """

    def __init__(self, space: Dict[str, Any], metric: Optional[str] = None,
                 mode: str = "max", n_initial: int = 10,
                 n_candidates: int = 24, gamma: float = 0.25,
                 seed: Optional[int] = None):
        super().__init__(metric, mode)
        self._space = _gridless(space)
        self._rng = random.Random(seed)
        self._n_initial = n_initial
        self._n_candidates = n_candidates
        self._gamma = gamma
        self._observations: List[Any] = []   # (config, score)
        self._pending: Dict[str, Dict[str, Any]] = {}

    def set_search_properties(self, metric, mode, config) -> bool:
        if config and not self._space:
            self._space = _gridless(config)
        return super().set_search_properties(metric, mode, config)

    def suggest(self, trial_id: str) -> Optional[Dict[str, Any]]:
        if len(self._observations) < self._n_initial:
            cfg = generate_variants(self._space, self._rng, 1)[0]
        else:
            # the good/bad split and per-key value lists depend only on
            # the observations: build once, score all candidates with it
            good, bad = self._split()
            values = {key: ([cfg.get(key) for cfg, _ in good],
                            [cfg.get(key) for cfg, _ in bad])
                      for key in self._space
                      if isinstance(self._space[key], Domain)}
            cands = [generate_variants(self._space, self._rng, 1)[0]
                     for _ in range(self._n_candidates)]
            cfg = max(cands, key=lambda c: self._ei_score(c, values))
        self._pending[trial_id] = cfg
        return cfg

    def _split(self):
        obs = sorted(self._observations, key=lambda o: o[1],
                     reverse=self.mode == "max")
        k = max(1, int(len(obs) * self._gamma))
        return obs[:k], obs[k:]

    def _ei_score(self, cand: Dict[str, Any],
                  values: Dict[str, Any]) -> float:
        """log l(x) - log g(x) under per-dimension Parzen estimators."""
        import math as _m

        def log_density(value, obs_values):
            nums = [v for v in obs_values
                    if isinstance(v, (int, float)) and not isinstance(v, bool)]
            if isinstance(value, (int, float)) and not isinstance(value, bool) \
                    and nums:
                lo, hi = min(nums), max(nums)
                bw = max((hi - lo) / max(len(nums) ** 0.5, 1.0),
                         abs(value) * 1e-3, 1e-12)
                dens = sum(_m.exp(-0.5 * ((value - m) / bw) ** 2)
                           for m in nums) / (len(nums) * bw)
                return _m.log(dens + 1e-300)
            # categorical: smoothed frequency
            count = sum(1 for v in obs_values if v == value)
            return _m.log((count + 1.0) / (len(obs_values) + 2.0))

        score = 0.0
        for key, (gv, bv) in values.items():
            if not gv or not bv:
                continue
            score += log_density(cand.get(key), gv) \
                - log_density(cand.get(key), bv)
        return score

    def on_trial_complete(self, trial_id, result=None, error=False):
        cfg = self._pending.pop(trial_id, None)
        if cfg is not None and result and self.metric in result and not error:
            self._observations.append((cfg, result[self.metric]))


# BOHB pairs the TPE model with the HyperBand scheduler
# (ray_tpu_torch.tune.schedulers.HyperBandScheduler), mirroring the reference's
# TuneBOHB searcher + HyperBandForBOHB pairing (search/bohb/).
TuneBOHB = TPESearcher


class HyperOptStyleSearch(Searcher):
    """A dependency-free TPE-flavored searcher: explores randomly for
    ``n_initial`` trials, then samples candidates and picks the one closest
    (in normalized param space) to the best-quartile trials and farthest
    from the worst — a cheap stand-in for the reference's hyperopt/optuna
    integrations (which need external packages).
    """

    def __init__(self, space: Dict[str, Any], metric: str, mode: str = "max",
                 n_initial: int = 10, n_candidates: int = 24,
                 seed: Optional[int] = None):
        super().__init__(metric, mode)
        self._space = _gridless(space)
        self._rng = random.Random(seed)
        self._n_initial = n_initial
        self._n_candidates = n_candidates
        self._observations: List[Any] = []   # (config, score)
        self._pending: Dict[str, Dict[str, Any]] = {}

    def suggest(self, trial_id: str) -> Optional[Dict[str, Any]]:
        if len(self._observations) < self._n_initial:
            cfg = generate_variants(self._space, self._rng, 1)[0]
        else:
            cands = [generate_variants(self._space, self._rng, 1)[0]
                     for _ in range(self._n_candidates)]
            cfg = max(cands, key=self._score_candidate)
        self._pending[trial_id] = cfg
        return cfg

    def _numeric_keys(self):
        return [k for k, v in self._space.items()
                if isinstance(v, Domain) and not isinstance(v, SampleFrom)]

    def _score_candidate(self, cand: Dict[str, Any]) -> float:
        obs = sorted(self._observations, key=lambda o: o[1],
                     reverse=self.mode == "max")
        k = max(1, len(obs) // 4)
        good, bad = obs[:k], obs[-k:]
        keys = self._numeric_keys()

        def dist(a, b):
            d = 0.0
            for key in keys:
                va, vb = a.get(key), b.get(key)
                if isinstance(va, (int, float)) and isinstance(vb,
                                                               (int, float)):
                    scale = abs(va) + abs(vb) + 1e-9
                    d += ((va - vb) / scale) ** 2
                elif va != vb:
                    d += 1.0
            return d ** 0.5

        good_d = min(dist(cand, g) for g, _ in good)
        bad_d = min(dist(cand, b) for b, _ in bad)
        return bad_d - good_d

    def on_trial_complete(self, trial_id, result=None, error=False):
        cfg = self._pending.pop(trial_id, None)
        if cfg is not None and result and self.metric in result \
                and not error:
            self._observations.append((cfg, result[self.metric]))
