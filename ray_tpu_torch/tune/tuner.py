"""Tuner + TrialRunner: the experiment event loop (the port's copy of
ray_tpu/tune/tuner.py).

Analog of Ray's python/ray/tune/tuner.py:249 (Tuner.fit) and
tune/execution/trial_runner.py:320/962 (TrialRunner.step): trials run as
actors (the Train worker actor doubles as the function-trainable runner),
the runner polls results, consults the scheduler (ASHA/PBT/median) for
stop/exploit decisions and the searcher for new configs, and persists
per-trial JSONL + experiment CSV.
"""

from __future__ import annotations

import csv
import json
import os
import time
from typing import Any, Callable, Dict, List, Optional

from ray_tpu_torch.air.checkpoint import Checkpoint
from ray_tpu_torch.air.config import RunConfig
from ray_tpu_torch.air.result import Result
from ray_tpu_torch.tune.sample import generate_variants  # noqa: F401
from ray_tpu_torch.tune.schedulers import FIFOScheduler, TrialScheduler
from ray_tpu_torch.tune.search import (BasicVariantGenerator, ConcurrencyLimiter,
                                       Searcher)
from ray_tpu_torch.tune.trial import (ERROR, PAUSED, PENDING, RUNNING, TERMINATED,
                                      Trial)


class TuneError(RuntimeError):
    pass


class TuneConfig:
    def __init__(self, *, metric: Optional[str] = None, mode: str = "max",
                 num_samples: int = 1,
                 max_concurrent_trials: Optional[int] = None,
                 search_alg: Optional[Searcher] = None,
                 scheduler: Optional[TrialScheduler] = None,
                 trial_resources: Optional[Dict[str, float]] = None,
                 seed: Optional[int] = None):
        if mode not in ("max", "min"):
            raise ValueError("mode must be 'max' or 'min'")
        self.metric = metric
        self.mode = mode
        self.num_samples = num_samples
        self.max_concurrent_trials = max_concurrent_trials
        self.search_alg = search_alg
        self.scheduler = scheduler
        self.trial_resources = trial_resources
        self.seed = seed


class ResultGrid:
    def __init__(self, results: List[Result], trials: List[Trial],
                 metric: Optional[str], mode: str):
        self._results = results
        self._trials = trials
        self._metric = metric
        self._mode = mode

    def __len__(self):
        return len(self._results)

    def __getitem__(self, i) -> Result:
        return self._results[i]

    @property
    def errors(self) -> List[Exception]:
        return [r.error for r in self._results if r.error is not None]

    def get_best_result(self, metric: Optional[str] = None,
                        mode: Optional[str] = None) -> Result:
        metric = metric or self._metric
        mode = mode or self._mode
        if metric is None:
            raise TuneError("no metric given to get_best_result")
        scored = [r for r in self._results if metric in (r.metrics or {})]
        if not scored:
            raise TuneError(f"no trial reported metric {metric!r}")
        return (max if mode == "max" else min)(
            scored, key=lambda r: r.metrics[metric])

    def get_dataframe(self):
        try:
            import pandas as pd
        except ImportError:
            return None
        return pd.DataFrame([r.metrics for r in self._results])


class TrialRunner:
    """Drives all trials of one experiment to completion."""

    def __init__(self, trainable: Callable, param_space: Dict[str, Any],
                 tune_config: TuneConfig, run_config: RunConfig,
                 restore_path: Optional[str] = None,
                 resume_errored: bool = False):
        import tempfile
        import ray_tpu_torch
        from ray_tpu_torch.tune.syncer import Syncer, resolve_storage
        self.trainable = trainable
        self.tune_config = tune_config
        self.run_config = run_config
        self._resume_errored = resume_errored
        staging = os.path.join(tempfile.gettempdir(), "ray_tpu_torch_tune_staging")
        if restore_path is not None:
            self._init_restore(restore_path, staging)
        else:
            name = run_config.name \
                or f"tune_{time.strftime('%Y%m%d_%H%M%S')}"
            self.experiment_dir, self._sync_uri = resolve_storage(
                run_config.storage_path, name, staging)
        os.makedirs(self.experiment_dir, exist_ok=True)
        self._syncer = Syncer(self.experiment_dir, self._sync_uri) \
            if self._sync_uri else None

        self.searcher = tune_config.search_alg or BasicVariantGenerator(
            param_space, num_samples=tune_config.num_samples,
            seed=tune_config.seed)
        self.searcher.set_search_properties(
            tune_config.metric, tune_config.mode, param_space)
        self.scheduler = tune_config.scheduler or FIFOScheduler()
        self.scheduler.set_search_properties(
            tune_config.metric, tune_config.mode)

        if isinstance(self.searcher, BasicVariantGenerator):
            self._target_trials = self.searcher.total_trials
        else:
            self._target_trials = tune_config.num_samples
        self.trials: List[Trial] = []
        self._suggest_exhausted = False

        if tune_config.max_concurrent_trials:
            self.max_concurrent = tune_config.max_concurrent_trials
        else:
            try:
                cpus = ray_tpu_torch.cluster_resources().get("CPU", 2.0)
            except Exception:
                cpus = 2.0
            per_trial = (tune_config.trial_resources or {}).get("CPU", 1.0)
            self.max_concurrent = max(1, int(cpus // max(per_trial, 0.5)))

        self._csv_path = os.path.join(self.experiment_dir, "progress.csv")
        self._csv_fields: Optional[List[str]] = None
        self.callbacks = list(run_config.callbacks or [])
        self._iteration = 0
        if restore_path is not None:
            self._apply_restore_state()

    # -- experiment persistence / restore ---------------------------------
    # (reference tune resume: experiment_state-*.json written by the
    # TrialRunner checkpointer, trial_runner.py:962 checkpoint(); here one
    # experiment_state.json + per-trial checkpoint.pkl, synced via Syncer)
    def _init_restore(self, restore_path: str, staging: str) -> None:
        from ray_tpu_torch._private import storage as _storage
        if _storage.is_uri(restore_path):
            import shutil
            name = restore_path.rstrip("/").rsplit("/", 1)[-1]
            self.experiment_dir = os.path.join(staging, name)
            self._sync_uri = restore_path
            # the mirror is the source of truth: stale staging files from
            # a crashed run (written after its last sync) must not merge
            # with the older synced state
            shutil.rmtree(self.experiment_dir, ignore_errors=True)
            _storage.download_dir(restore_path, self.experiment_dir)
        else:
            self.experiment_dir = restore_path
            self._sync_uri = None
        state_path = os.path.join(self.experiment_dir,
                                  "experiment_state.json")
        if not os.path.exists(state_path):
            raise TuneError(f"no experiment_state.json under "
                            f"{restore_path!r}; nothing to restore")
        with open(state_path) as f:
            self._restore_state = json.load(f)

    def _apply_restore_state(self) -> None:
        state = self._restore_state
        # append to the prior run's progress.csv instead of truncating it
        if os.path.exists(self._csv_path):
            with open(self._csv_path) as f:
                header = f.readline().strip()
            if header:
                self._csv_fields = header.split(",")
        for ts in state.get("trials", []):
            t = Trial(ts["config"], self.experiment_dir,
                      resources=self.tune_config.trial_resources,
                      trial_id=ts["trial_id"])
            t.last_result = ts.get("last_result", {})
            if t.last_result:
                t.results.append(t.last_result)
            t.num_failures = ts.get("num_failures", 0)
            t.error = ts.get("error")
            status = ts["status"]
            # a trial that was mid-flight resumes from its checkpoint
            terminal = (TERMINATED,) if self._resume_errored \
                else (TERMINATED, ERROR)
            t.status = status if status in terminal else PENDING
            if status == ERROR and t.status == PENDING:
                t.error = None
                t.num_failures = 0
            ckpt_path = os.path.join(t.logdir, "checkpoint.pkl")
            if os.path.exists(ckpt_path):
                with open(ckpt_path, "rb") as f:
                    t.checkpoint = Checkpoint.from_bytes(f.read())
            self.trials.append(t)
            # deterministic searchers re-derive their sequence: advance
            # them past configs already handed out before the restart
            try:
                self.searcher.advance_restored(t.trial_id,
                                               t.status == PENDING)
            except Exception:
                pass
            self.scheduler.on_trial_add(self, t)
            if t.status in (TERMINATED, ERROR):
                self.searcher.on_trial_complete(
                    t.trial_id, t.last_result or None,
                    error=t.status == ERROR)
        self._iteration = state.get("iteration", 0)

    def _save_experiment_state(self) -> None:
        trials = []
        for t in self.trials:
            trials.append({
                "trial_id": t.trial_id, "config": t.config,
                "status": t.status, "last_result": t.last_result,
                "num_failures": t.num_failures, "error": t.error,
            })
            if t.checkpoint is not None \
                    and getattr(t, "_saved_ckpt", None) is not t.checkpoint:
                try:
                    blob = t.checkpoint.to_bytes()
                except Exception:
                    continue
                tmp = os.path.join(t.logdir, ".checkpoint.tmp")
                with open(tmp, "wb") as f:
                    f.write(blob)
                os.replace(tmp, os.path.join(t.logdir, "checkpoint.pkl"))
                t._saved_ckpt = t.checkpoint
        state = {"name": os.path.basename(self.experiment_dir),
                 "iteration": self._iteration, "trials": trials}
        tmp = os.path.join(self.experiment_dir, ".experiment_state.tmp")
        with open(tmp, "w") as f:
            json.dump(state, f, default=str)
        os.replace(tmp, os.path.join(self.experiment_dir,
                                     "experiment_state.json"))

    # -- trial lifecycle ---------------------------------------------------
    def _make_trial(self) -> Optional[Trial]:
        if len(self.trials) >= self._target_trials or self._suggest_exhausted:
            return None
        t = Trial({}, self.experiment_dir,
                  resources=self.tune_config.trial_resources)
        cfg = self.searcher.suggest(t.trial_id)
        if cfg is None:
            if not isinstance(self.searcher, ConcurrencyLimiter):
                self._suggest_exhausted = True
            return None
        t.config = cfg
        self.trials.append(t)
        self.scheduler.on_trial_add(self, t)
        return t

    def _start_trial(self, trial: Trial,
                     checkpoint: Optional[Checkpoint] = None) -> None:
        import ray_tpu_torch
        from ray_tpu_torch.train.worker_group import TrainWorker
        res = dict(trial.resources)
        cpus = res.pop("CPU", 1.0)
        # ray_tpu leases "TPU"; the port's card is "GPU" (a trainer's
        # own workers lease theirs inside the trial, as_trainable)
        gpus = res.pop("GPU", 0.0)
        cls = ray_tpu_torch.remote(num_cpus=cpus, num_gpus=gpus,
                                   resources=res or None)(TrainWorker)
        trial.actor = cls.remote(world_rank=0, world_size=1)
        trial.actor.start_training.remote(
            self.trainable, trial.config,
            trial_name=f"trial_{trial.trial_id}",
            trial_id=trial.trial_id, trial_dir=trial.logdir,
            experiment_name=os.path.basename(self.experiment_dir),
            checkpoint=checkpoint if checkpoint is not None
            else trial.checkpoint)
        trial.status = RUNNING
        for cb in self.callbacks:
            cb.on_trial_start(self._iteration, self.trials, trial)

    def _stop_trial(self, trial: Trial, status: str,
                    error: Optional[str] = None) -> None:
        import ray_tpu_torch
        trial.status = status
        trial.error = error
        if trial.actor is not None:
            try:
                trial.actor.request_stop.remote()
                ray_tpu_torch.kill(trial.actor)
            except Exception:
                pass
            trial.actor = None
        done_result = trial.last_result if not error else None
        self.searcher.on_trial_complete(trial.trial_id, done_result,
                                        error=bool(error))
        self.scheduler.on_trial_complete(self, trial, done_result)
        for cb in self.callbacks:
            if error:
                cb.on_trial_error(self._iteration, self.trials, trial)
            else:
                cb.on_trial_complete(self._iteration, self.trials, trial)

    def request_exploit(self, trial: Trial, donor: Trial,
                        new_config: Dict[str, Any]) -> None:
        """PBT: restart ``trial`` from ``donor``'s checkpoint with mutated
        config at the next poll."""
        trial.pending_exploit = (donor.checkpoint, new_config)

    # -- event loop --------------------------------------------------------
    def step(self) -> bool:
        """One scheduling round; returns False when the experiment is done."""
        import ray_tpu_torch

        # launch new/paused trials up to the concurrency cap; restored
        # PENDING trials (restart-from-checkpoint) go first
        live = [t for t in self.trials if t.status == RUNNING]
        while len(live) < self.max_concurrent:
            restored = next((t for t in self.trials
                             if t.status == PENDING and t.actor is None),
                            None)
            if restored is not None:
                self._start_trial(restored)
                live.append(restored)
                continue
            paused = self.scheduler.choose_trial_to_run(self)
            if paused is not None:
                self._start_trial(paused)
                live.append(paused)
                continue
            t = self._make_trial()
            if t is None:
                break
            self._start_trial(t)
            live.append(t)

        if not live:
            return any(t.status in (PENDING, PAUSED) for t in self.trials) \
                or (len(self.trials) < self._target_trials
                    and not self._suggest_exhausted)

        # poll every live trial
        for trial in live:
            try:
                item = ray_tpu_torch.get(
                    trial.actor.next_result.remote(timeout=1.0),
                    timeout=60.0)
            except Exception as e:
                self._on_trial_error(trial, f"actor died: {e}")
                continue
            if item[0] == "timeout":
                pass
            elif item[0] == "error":
                self._on_trial_error(trial, item[1])
            elif item[0] == "done":
                self._stop_trial(trial, TERMINATED)
            elif item[0] == "result":
                self._on_trial_result(trial, item[1], item[2])
            # apply a pending PBT exploit outside of result handling so it
            # also covers trials that just crossed the interval
            if trial.status == RUNNING and trial.pending_exploit:
                donor_ckpt, new_cfg = trial.pending_exploit
                trial.pending_exploit = None
                import copy
                self._stop_trial_actor_only(trial)
                trial.config = new_cfg
                trial.checkpoint = donor_ckpt
                self._start_trial(trial, checkpoint=donor_ckpt)
        return True

    def _stop_trial_actor_only(self, trial: Trial) -> None:
        import ray_tpu_torch
        if trial.actor is not None:
            try:
                trial.actor.request_stop.remote()
                ray_tpu_torch.kill(trial.actor)
            except Exception:
                pass
            trial.actor = None

    def _on_trial_result(self, trial: Trial, metrics: Dict[str, Any],
                         ckpt: Optional[Checkpoint]) -> None:
        metrics = dict(metrics)
        metrics["trial_id"] = trial.trial_id
        metrics["config"] = trial.config
        trial.last_result = metrics
        trial.results.append(metrics)
        if ckpt is not None:
            trial.checkpoint = ckpt
        self._log_result(trial, metrics)
        for cb in self.callbacks:
            cb.on_trial_result(self._iteration, self.trials, trial, metrics)
        self.searcher.on_trial_result(trial.trial_id, metrics)
        decision = self.scheduler.on_trial_result(self, trial, metrics)
        if self._hit_stop_criteria(metrics):
            decision = TrialScheduler.STOP
        if decision == TrialScheduler.STOP:
            self._stop_trial(trial, TERMINATED)
        elif decision == TrialScheduler.PAUSE:
            self._stop_trial_actor_only(trial)
            trial.status = PAUSED

    def _hit_stop_criteria(self, metrics: Dict[str, Any]) -> bool:
        stop = self.run_config.stop
        if not stop:
            return False
        return any(k in metrics and metrics[k] >= v for k, v in stop.items())

    def _on_trial_error(self, trial: Trial, err: str) -> None:
        trial.num_failures += 1
        max_failures = self.run_config.failure_config.max_failures
        if max_failures < 0 or trial.num_failures <= max_failures:
            self._stop_trial_actor_only(trial)
            trial.status = PENDING
            self._start_trial(trial)     # restart from last checkpoint
            trial.status = RUNNING
            return
        self._stop_trial(trial, ERROR, error=err)
        if self.run_config.failure_config.fail_fast:
            raise TuneError(f"trial {trial.trial_id} failed:\n{err}")

    # -- logging -----------------------------------------------------------
    def _log_result(self, trial: Trial, metrics: Dict[str, Any]) -> None:
        with open(os.path.join(trial.logdir, "result.json"), "a") as f:
            f.write(json.dumps(metrics, default=str) + "\n")
        flat = {k: v for k, v in metrics.items()
                if isinstance(v, (int, float, str, bool))}
        flat["trial_id"] = trial.trial_id
        if self._csv_fields is None:
            self._csv_fields = sorted(flat.keys())
            with open(self._csv_path, "w", newline="") as f:
                csv.DictWriter(f, self._csv_fields).writeheader()
        with open(self._csv_path, "a", newline="") as f:
            csv.DictWriter(f, self._csv_fields,
                           extrasaction="ignore").writerow(flat)

    # -- results -----------------------------------------------------------
    def run(self) -> List[Result]:
        while self.step():
            self._iteration += 1
            self._save_experiment_state()
            if self._syncer is not None:
                self._syncer.sync_up()
        self._save_experiment_state()
        if self._syncer is not None:
            self._syncer.sync_up(force=True)
        for cb in self.callbacks:
            cb.on_experiment_end(self.trials)
        out = []
        for t in self.trials:
            out.append(Result(
                metrics=t.last_result, checkpoint=t.checkpoint,
                error=TuneError(t.error) if t.error else None,
                log_dir=t.logdir))
        return out


class Tuner:
    """``Tuner(trainable, param_space=..., tune_config=..., run_config=...)
    .fit()`` (cf. reference tuner.py:249)."""

    def __init__(self, trainable: Callable, *,
                 param_space: Optional[Dict[str, Any]] = None,
                 tune_config: Optional[TuneConfig] = None,
                 run_config: Optional[RunConfig] = None):
        if hasattr(trainable, "as_trainable"):
            trainable = trainable.as_trainable()
        self.trainable = trainable
        self.param_space = param_space or {}
        self.tune_config = tune_config or TuneConfig()
        self.run_config = run_config or RunConfig()
        self._restore_path: Optional[str] = None

    @classmethod
    def restore(cls, path: str, trainable: Callable, *,
                param_space: Optional[Dict[str, Any]] = None,
                tune_config: Optional[TuneConfig] = None,
                run_config: Optional[RunConfig] = None,
                resume_errored: bool = False) -> "Tuner":
        """Resume an experiment from a local dir or storage URI (reference
        tuner.py Tuner.restore): finished trials keep their results,
        interrupted ones restart from their last synced checkpoint;
        ``resume_errored`` also restarts trials that had failed."""
        tuner = cls(trainable, param_space=param_space,
                    tune_config=tune_config, run_config=run_config)
        tuner._restore_path = path
        tuner._resume_errored = resume_errored
        return tuner

    def fit(self) -> ResultGrid:
        runner = TrialRunner(self.trainable, self.param_space,
                             self.tune_config, self.run_config,
                             restore_path=self._restore_path,
                             resume_errored=getattr(
                                 self, "_resume_errored", False))
        results = runner.run()
        return ResultGrid(results, runner.trials,
                          self.tune_config.metric, self.tune_config.mode)
