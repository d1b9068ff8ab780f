"""Trial schedulers: early stopping / pausing / exploit-explore
(the port's copy of ray_tpu/tune/schedulers.py).

Analog of Ray's python/ray/tune/schedulers/
(ASHA async_hyperband.py, PBT pbt.py, MedianStoppingRule
median_stopping_rule.py, HyperBandScheduler hyperband.py).
"""

from __future__ import annotations

import math
import random
from typing import Any, Dict, List, Optional


class TrialScheduler:
    CONTINUE = "CONTINUE"
    PAUSE = "PAUSE"
    STOP = "STOP"

    def __init__(self, metric: Optional[str] = None, mode: str = "max"):
        self.metric = metric
        self.mode = mode

    def set_search_properties(self, metric: Optional[str],
                              mode: Optional[str]) -> bool:
        if metric:
            self.metric = metric
        if mode:
            self.mode = mode
        return True

    def on_trial_add(self, runner, trial) -> None:
        """Called when the runner creates a trial (before it starts)."""

    def on_trial_result(self, runner, trial,
                        result: Dict[str, Any]) -> str:
        return self.CONTINUE

    def on_trial_complete(self, runner, trial,
                          result: Optional[Dict[str, Any]]) -> None:
        pass

    def choose_trial_to_run(self, runner):
        for t in runner.trials:
            if t.status == "PAUSED":
                return t
        return None


class FIFOScheduler(TrialScheduler):
    pass


class ASHAScheduler(TrialScheduler):
    """Asynchronous successive halving (cf. reference async_hyperband.py).

    At each rung (time_attr crossing ``grace_period * reduction_factor^k``),
    a trial is stopped unless its metric is in the top ``1/reduction_factor``
    of completed rung entries.
    """

    def __init__(self, metric: Optional[str] = None, mode: str = "max",
                 time_attr: str = "training_iteration",
                 max_t: int = 100, grace_period: int = 1,
                 reduction_factor: float = 4):
        super().__init__(metric, mode)
        self.time_attr = time_attr
        self.max_t = max_t
        self.grace_period = grace_period
        self.rf = reduction_factor
        # rung milestone -> list of recorded metric values
        self._rungs: Dict[float, List[float]] = {}
        self._milestones = []
        t = grace_period
        while t < max_t:
            self._milestones.append(t)
            t = math.ceil(t * reduction_factor)

    def on_trial_result(self, runner, trial, result) -> str:
        t = result.get(self.time_attr, 0)
        value = result.get(self.metric)
        if value is None:
            return self.CONTINUE
        if t >= self.max_t:
            return self.STOP
        decision = self.CONTINUE
        for milestone in self._milestones:
            if t < milestone:
                break
            rung = self._rungs.setdefault(milestone, [])
            key = (trial.trial_id, milestone)
            if key in getattr(trial, "_asha_recorded", set()):
                continue
            trial._asha_recorded = getattr(trial, "_asha_recorded", set())
            trial._asha_recorded.add(key)
            rung.append(value)
            if len(rung) >= self.rf:
                cutoff = self._cutoff(rung)
                keep = value >= cutoff if self.mode == "max" \
                    else value <= cutoff
                if not keep:
                    decision = self.STOP
        return decision

    def _cutoff(self, rung: List[float]) -> float:
        ordered = sorted(rung, reverse=self.mode == "max")
        k = max(1, int(len(ordered) / self.rf))
        return ordered[k - 1]


class _Bracket:
    """One successive-halving bracket: members climb rung milestones; at
    each full rung the top 1/eta are promoted, the rest stopped."""

    def __init__(self, milestones: List[int], eta: float):
        self.milestones = milestones
        self.eta = eta
        self.members: List[str] = []                # trial ids
        self.rung_of: Dict[str, int] = {}           # trial id -> rung idx
        self.recorded: Dict[int, Dict[str, float]] = {}  # rung -> id -> val
        self.done: set = set()                      # ids out of the bracket
        self.promoted: set = set()                  # ids cleared to resume
        self.closed = False                         # no new members
        self.completed: set = set()                 # rungs already promoted

    def add(self, trial_id: str) -> None:
        self.members.append(trial_id)
        self.rung_of[trial_id] = 0

    def pending(self, rung: int) -> List[str]:
        rec = self.recorded.get(rung, {})
        return [m for m in self.members
                if m not in rec and m not in self.done
                and self.rung_of.get(m, 0) == rung]

    def record(self, trial_id: str, rung: int, value: float,
               mode: str) -> Optional[List[str]]:
        """Record a rung entry, then try to complete the rung."""
        self.recorded.setdefault(rung, {})[trial_id] = value
        return self.maybe_complete(rung, mode)

    def maybe_complete(self, rung: int, mode: str) -> Optional[List[str]]:
        """Promote the rung's top 1/eta exactly once, when every live
        member has recorded it. Single path for both the result and the
        early-completion (trial left the bracket) triggers."""
        rec = self.recorded.get(rung, {})
        if rung in self.completed or not rec or self.pending(rung):
            return None
        self.completed.add(rung)
        self.closed = True
        ordered = sorted(rec, key=rec.get, reverse=mode == "max")
        k = max(1, int(math.ceil(len(ordered) / self.eta)))
        winners = [m for m in ordered[:k] if m not in self.done]
        for m in rec:
            if m in winners:
                self.rung_of[m] = rung + 1
                self.promoted.add(m)
            elif m not in self.done:
                self.done.add(m)
        return winners


class HyperBandScheduler(TrialScheduler):
    """Synchronous HyperBand / successive halving (cf. reference
    tune/schedulers/hyperband.py; with TuneBOHB as the searcher this is
    the reference's BOHB pairing, HyperBandForBOHB).

    Trials join the open bracket until its first rung completes. At each
    milestone (grace * eta^k) a trial pauses; when every live bracket
    member has reported the rung, the top 1/eta resume and the rest stop.
    """

    def __init__(self, metric: Optional[str] = None, mode: str = "max",
                 time_attr: str = "training_iteration",
                 max_t: int = 81, grace_period: int = 1,
                 reduction_factor: float = 3):
        super().__init__(metric, mode)
        self.time_attr = time_attr
        self.max_t = max_t
        self.eta = reduction_factor
        self.milestones: List[int] = []
        t = grace_period
        while t < max_t:
            self.milestones.append(int(t))
            t = math.ceil(t * reduction_factor)
        self.brackets: List[_Bracket] = []
        self._bracket_of: Dict[str, _Bracket] = {}

    def on_trial_add(self, runner, trial) -> None:
        self._assign(trial.trial_id)

    def _assign(self, trial_id: str) -> _Bracket:
        b = self._bracket_of.get(trial_id)
        if b is not None:
            return b
        for b in self.brackets:
            if not b.closed:
                break
        else:
            b = _Bracket(self.milestones, self.eta)
            self.brackets.append(b)
        b.add(trial_id)
        self._bracket_of[trial_id] = b
        return b

    def on_trial_result(self, runner, trial, result) -> str:
        value = result.get(self.metric)
        t = result.get(self.time_attr, 0)
        if value is None:
            return self.CONTINUE
        if t >= self.max_t:
            return self.STOP
        b = self._assign(trial.trial_id)
        rung = b.rung_of.get(trial.trial_id, 0)
        if rung >= len(b.milestones):
            return self.CONTINUE
        if t < b.milestones[rung]:
            return self.CONTINUE
        winners = b.record(trial.trial_id, rung, value, self.mode)
        if winners is None:
            return self.PAUSE          # wait for bracket peers
        # rung complete: this trial either advances now or stops now; its
        # paused peers are resolved in choose_trial_to_run
        if trial.trial_id in b.promoted:
            b.promoted.discard(trial.trial_id)
            return self.CONTINUE
        return self.STOP

    def on_trial_complete(self, runner, trial, result) -> None:
        b = self._bracket_of.get(trial.trial_id)
        if b is None:
            return
        b.done.add(trial.trial_id)
        b.promoted.discard(trial.trial_id)
        # the departure may complete the current rung for the others
        b.maybe_complete(b.rung_of.get(trial.trial_id, 0), self.mode)

    def choose_trial_to_run(self, runner):
        for t in runner.trials:
            if t.status != "PAUSED":
                continue
            b = self._bracket_of.get(t.trial_id)
            if b is None:
                return t
            if t.trial_id in b.promoted:
                b.promoted.discard(t.trial_id)
                return t
            if t.trial_id in b.done:
                # lost its rung while paused: terminate instead of resume
                runner._stop_trial(t, "TERMINATED")
        return None


class MedianStoppingRule(TrialScheduler):
    """Stop a trial whose running-average is below the median of other
    trials' averages at the same step (cf. reference
    median_stopping_rule.py)."""

    def __init__(self, metric: Optional[str] = None, mode: str = "max",
                 time_attr: str = "training_iteration",
                 grace_period: int = 5, min_samples_required: int = 3):
        super().__init__(metric, mode)
        self.time_attr = time_attr
        self.grace_period = grace_period
        self.min_samples = min_samples_required
        self._histories: Dict[str, List[float]] = {}

    def on_trial_result(self, runner, trial, result) -> str:
        value = result.get(self.metric)
        t = result.get(self.time_attr, 0)
        if value is None:
            return self.CONTINUE
        hist = self._histories.setdefault(trial.trial_id, [])
        hist.append(value)
        if t < self.grace_period:
            return self.CONTINUE
        means = [sum(h) / len(h) for tid, h in self._histories.items()
                 if tid != trial.trial_id and h]
        if len(means) < self.min_samples:
            return self.CONTINUE
        means.sort()
        median = means[len(means) // 2]
        mean = sum(hist) / len(hist)
        worse = mean < median if self.mode == "max" else mean > median
        return self.STOP if worse else self.CONTINUE


class PopulationBasedTraining(TrialScheduler):
    """PBT (cf. reference pbt.py): at each ``perturbation_interval``, a
    bottom-quantile trial exploits a top-quantile trial's checkpoint+config
    and explores by resampling/perturbing hyperparams. The runner applies
    the returned exploit decision (restore checkpoint, swap config).
    """

    def __init__(self, metric: Optional[str] = None, mode: str = "max",
                 time_attr: str = "training_iteration",
                 perturbation_interval: int = 5,
                 hyperparam_mutations: Optional[Dict[str, Any]] = None,
                 quantile_fraction: float = 0.25,
                 resample_probability: float = 0.25,
                 seed: Optional[int] = None):
        super().__init__(metric, mode)
        self.time_attr = time_attr
        self.interval = perturbation_interval
        self.mutations = hyperparam_mutations or {}
        self.quantile = quantile_fraction
        self.resample_p = resample_probability
        self._rng = random.Random(seed)
        self._last_perturb: Dict[str, float] = {}
        self._scores: Dict[str, float] = {}

    def on_trial_result(self, runner, trial, result) -> str:
        value = result.get(self.metric)
        t = result.get(self.time_attr, 0)
        if value is None:
            return self.CONTINUE
        self._scores[trial.trial_id] = value
        last = self._last_perturb.get(trial.trial_id, 0)
        if t - last < self.interval:
            return self.CONTINUE
        self._last_perturb[trial.trial_id] = t
        live = [tr for tr in runner.trials
                if tr.trial_id in self._scores
                and tr.status in ("RUNNING", "PAUSED")]
        if len(live) < 2:
            return self.CONTINUE
        ordered = sorted(live, key=lambda tr: self._scores[tr.trial_id],
                         reverse=self.mode == "max")
        k = max(1, int(len(ordered) * self.quantile))
        top, bottom = ordered[:k], ordered[-k:]
        if trial in bottom and trial not in top:
            donor = self._rng.choice(top)
            if donor.checkpoint is not None:
                new_cfg = self._explore(dict(donor.config))
                runner.request_exploit(trial, donor, new_cfg)
        return self.CONTINUE

    def _explore(self, config: Dict[str, Any]) -> Dict[str, Any]:
        from ray_tpu_torch.tune.sample import Domain
        for key, spec in self.mutations.items():
            if self._rng.random() < self.resample_p or key not in config:
                if isinstance(spec, Domain):
                    config[key] = spec.sample(self._rng)
                elif isinstance(spec, list):
                    config[key] = self._rng.choice(spec)
                elif callable(spec):
                    config[key] = spec()
            elif isinstance(config[key], (int, float)):
                factor = self._rng.choice([0.8, 1.2])
                config[key] = type(config[key])(config[key] * factor)
        return config
