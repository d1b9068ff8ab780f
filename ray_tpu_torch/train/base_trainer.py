"""BaseTrainer / DataParallelTrainer: the fit() driver loop (the port's
copy of ray_tpu/train/base_trainer.py).

Analog of Ray's python/ray/train/base_trainer.py:339 (fit) and
data_parallel_trainer.py:329 (training_loop). The reference routes fit()
through Tune's TrialRunner even for a single run; here fit() drives the
WorkerGroup directly and ``as_trainable()`` exposes the same run to the
Tuner for sweeps — one mechanism, two entry points.
"""

from __future__ import annotations

import os
import time
import uuid
from typing import Any, Callable, Dict, List, Optional

from ray_tpu_torch.air.checkpoint import Checkpoint
from ray_tpu_torch.air.config import CheckpointConfig, RunConfig, ScalingConfig
from ray_tpu_torch.air.result import Result
from ray_tpu_torch.train.worker_group import WorkerGroup


class TrainingFailedError(RuntimeError):
    pass


class BackendConfig:
    """Per-framework worker-group setup hooks (cf. reference
    train/backend_config.py)."""

    def on_start(self, worker_group: WorkerGroup,
                 scaling: ScalingConfig) -> None:
        pass

    def on_shutdown(self, worker_group: WorkerGroup) -> None:
        pass


class _GangWatch:
    """Event-plane rank-death detector for one gang incarnation
    (docs/fault_tolerance.md): polls the GCS cluster-event table (rate
    limited to ~1/s) for NODE_PREEMPTING/NODE_DEAD events naming a node
    that hosts a gang rank, raising TrainingFailedError so the driver
    fails over proactively — a graceful preemption notice triggers the
    restart DURING the grace window instead of after the node's
    heartbeats lapse.  Everything here is best effort: a broken watch
    degrades to the poll-RPC failure path, never to a wedged driver."""

    WATCHED = ("NODE_PREEMPTING", "NODE_DEAD")

    def __init__(self, group: WorkerGroup):
        self._start_ts = getattr(group, "created_ts", time.time())
        self._nodes: set = set()
        self._gcs = None
        self._last = 0.0
        try:
            self._nodes = {n for n in group.node_ids() if n}
            from ray_tpu_torch.runtime.core_worker import get_global_worker
            self._gcs = get_global_worker().gcs
        except Exception:
            self._gcs = None

    def check(self) -> None:
        now = time.monotonic()
        if self._gcs is None or not self._nodes or now - self._last < 1.0:
            return
        self._last = now
        for etype in self.WATCHED:
            try:
                events = self._gcs.call(
                    "list_cluster_events",
                    {"type": etype, "limit": 200}, timeout=5)
            except Exception:
                return
            for ev in events or ():
                # 5s skew allowance: event ts is the emitting host's
                # wall clock.  Safe to widen — a pre-incarnation event
                # can only name a node placement already excluded from
                # THIS gang (draining/dead nodes host no new ranks).
                if ev.get("node_id") in self._nodes and \
                        ev.get("ts", 0) >= self._start_ts - 5.0:
                    raise TrainingFailedError(
                        f"gang node {str(ev.get('node_id'))[:12]} "
                        f"{etype} (event plane): {ev.get('message', '')}")


class BaseTrainer:
    def __init__(self, *,
                 scaling_config: Optional[ScalingConfig] = None,
                 run_config: Optional[RunConfig] = None,
                 datasets: Optional[Dict[str, Any]] = None,
                 resume_from_checkpoint: Optional[Checkpoint] = None):
        self.scaling_config = scaling_config or ScalingConfig()
        self.run_config = run_config or RunConfig()
        self.datasets = datasets or {}
        self.resume_from_checkpoint = resume_from_checkpoint

    def training_loop(self) -> None:
        raise NotImplementedError

    def fit(self) -> Result:
        raise NotImplementedError

    def as_trainable(self):
        """A Tune function-trainable that runs this trainer once per trial;
        the trial config is merged into the train loop config."""
        trainer = self

        def _trainable(config: Dict[str, Any]):
            from ray_tpu_torch.air import session
            import copy
            t = copy.copy(trainer)
            overrides = dict(config)
            t._apply_trial_config(overrides)
            for metrics, ckpt in t._iter_results():
                session.report(metrics, checkpoint=ckpt)

        _trainable.__name__ = type(self).__name__
        return _trainable

    def _apply_trial_config(self, config: Dict[str, Any]) -> None:
        pass

    def _iter_results(self):
        raise NotImplementedError


class DataParallelTrainer(BaseTrainer):
    """Runs ``train_loop_per_worker`` on a WorkerGroup, streaming reported
    results back; rank-0's metrics are the canonical series."""

    backend_config_cls = BackendConfig

    def __init__(self, train_loop_per_worker: Callable, *,
                 train_loop_config: Optional[Dict[str, Any]] = None,
                 backend_config: Optional[BackendConfig] = None,
                 scaling_config: Optional[ScalingConfig] = None,
                 run_config: Optional[RunConfig] = None,
                 datasets: Optional[Dict[str, Any]] = None,
                 resume_from_checkpoint: Optional[Checkpoint] = None):
        super().__init__(scaling_config=scaling_config,
                         run_config=run_config, datasets=datasets,
                         resume_from_checkpoint=resume_from_checkpoint)
        self.train_loop_per_worker = train_loop_per_worker
        self.train_loop_config = train_loop_config or {}
        self.backend_config = backend_config or self.backend_config_cls()
        # elastic recovery state (docs/fault_tolerance.md): the newest
        # checkpoint any report carried — a gang restart resumes from
        # it, bounding lost work to one checkpoint interval
        self._latest_checkpoint: Optional[Checkpoint] = None
        self._last_failure: str = ""
        # last "step" any rank reported: with the checkpoint's resume
        # step this prices a failover in re-executed steps — the lost
        # work the recovery auditor (metrics_history.py) ledgers
        self._last_step: Optional[int] = None

    def _apply_trial_config(self, config: Dict[str, Any]) -> None:
        merged = dict(self.train_loop_config)
        merged.update(config.get("train_loop_config", config))
        self.train_loop_config = merged

    # -- driver loop -------------------------------------------------------
    def _start_group(self, experiment_name: str) -> WorkerGroup:
        sc = self.scaling_config
        group = WorkerGroup(
            num_workers=sc.num_workers,
            resources_per_worker=sc.worker_resources(),
            placement_strategy=sc.placement_strategy)
        self.backend_config.on_start(group, sc)
        shards = self._split_dataset(sc.num_workers)
        trial_id = uuid.uuid4().hex[:8]
        # keep the refs: a failed start_training (bad loop pickle, dead
        # rank) must surface as TrainingFailedError in _poll_group, not
        # livelock the poll loop on eternal ("timeout",) results
        group._start_refs = [
            w.start_training.remote(
                self.train_loop_per_worker, self.train_loop_config,
                experiment_name=experiment_name,
                trial_id=trial_id,
                checkpoint=self.resume_from_checkpoint,
                dataset_shard=shards[rank])
            for rank, w in enumerate(group.workers)]
        return group

    def _split_dataset(self, n: int) -> List[Any]:
        ds = self.datasets.get("train")
        if ds is None:
            return [None] * n
        if hasattr(ds, "split"):
            try:
                return ds.split(n, equal=True)
            except TypeError:
                return ds.split(n)
        return [ds] * n

    def _iter_results(self):
        """Yield (metrics, checkpoint) pairs as workers report, with
        FailureConfig-driven whole-group restarts on rank/node death.

        Gang recovery (docs/fault_tolerance.md): rank death is detected
        both by the poll RPCs failing and — earlier — by the event
        plane (NODE_PREEMPTING/NODE_DEAD naming a gang node, via
        _GangWatch).  On failure the group is torn down, a fresh gang
        is spawned on a new placement group (re-reserved on surviving /
        replacement nodes; a fresh collective incarnation nonce comes
        with the backend's on_start), and the loop resumes from the
        LATEST checkpoint any report carried — lost work is bounded by
        the checkpoint interval, not the run length."""
        failure = self.run_config.failure_config
        retries_left = failure.max_failures
        name = self.run_config.name or type(self).__name__.lower()
        attempt = 0
        t_failed = None
        while True:
            group = None
            try:
                group = self._start_group(name)
                if attempt:
                    self._emit_recovery(name, attempt, t_failed)
                for metrics, ckpt in self._poll_group(group):
                    if ckpt is not None:
                        self._latest_checkpoint = ckpt
                    if isinstance(metrics, dict) and \
                            isinstance(metrics.get("step"), int):
                        self._last_step = metrics["step"]
                    yield metrics, ckpt
                return
            except TrainingFailedError as e:
                if retries_left == 0:
                    raise
                if retries_left > 0:
                    retries_left -= 1
                self._last_failure = str(e)
                t_failed = time.monotonic()
                if self._latest_checkpoint is not None:
                    self.resume_from_checkpoint = self._latest_checkpoint
                attempt += 1
                time.sleep(1.0)
            except Exception as e:
                # gang RE-formation failed (pg reservation timeout while
                # the replacement slice still provisions, rendezvous
                # error): retryable like a rank death.  A first-attempt
                # failure stays fatal — that is a configuration error,
                # not a failover.
                if attempt == 0 or retries_left == 0:
                    raise
                if retries_left > 0:
                    retries_left -= 1
                self._last_failure = f"gang re-formation failed: {e}"
                attempt += 1
                time.sleep(5.0)
            finally:
                if group is not None:
                    self.backend_config.on_shutdown(group)
                    group.shutdown()

    def _emit_recovery(self, name: str, attempt: int,
                       t_failed: Optional[float]) -> None:
        """TRAIN_GANG_RECOVERY into the event plane once the replacement
        gang is spawned: the chaos gate's time-to-failover referee."""
        try:
            from ray_tpu_torch._private import cluster_events as cev
            # price the failover in re-executed steps: everything past
            # the checkpoint the gang resumes from, up to the last step
            # any rank reported, runs again
            resume_step = None
            if self.resume_from_checkpoint is not None:
                try:
                    raw = self.resume_from_checkpoint.to_dict() \
                        .get("step")
                    resume_step = raw if isinstance(raw, int) else None
                except Exception:
                    resume_step = None
            lost = None
            if resume_step is not None and self._last_step is not None:
                lost = max(0, self._last_step - resume_step)
            elif self._last_step is not None and \
                    self.resume_from_checkpoint is None:
                lost = self._last_step + 1   # from-scratch restart
            cev.emit(
                cev.TRAIN_GANG_RECOVERY,
                f"gang for {name!r} re-formed (attempt {attempt}): "
                f"{self._last_failure[:200]}",
                severity="WARNING", experiment=name, attempt=attempt,
                reason=self._last_failure[:500],
                downtime_s=(round(time.monotonic() - t_failed, 3)
                            if t_failed else None),
                resumed_from_checkpoint=self.resume_from_checkpoint
                is not None, resume_step=resume_step,
                last_step=self._last_step, lost_steps=lost)
        except Exception:
            pass    # observability must never fail the loop

    def _poll_group(self, group: WorkerGroup):
        import ray_tpu_torch
        done: List[Any] = [None] * len(group.workers)
        watch = _GangWatch(group)
        start_refs = list(getattr(group, "_start_refs", ()))
        while True:
            round_items: List[Any] = []
            try:
                if start_refs:
                    ready, start_refs = ray_tpu_torch.wait(
                        start_refs, num_returns=len(start_refs), timeout=0)
                    try:
                        ray_tpu_torch.get(ready)
                    except Exception as e:
                        raise TrainingFailedError(
                            f"start_training failed: {e}") from e
                for rank, w in enumerate(group.workers):
                    if done[rank] is not None:
                        continue
                    watch.check()
                    try:
                        item = ray_tpu_torch.get(
                            w.next_result.remote(timeout=10.0),
                            timeout=120.0)
                    except Exception as e:
                        raise TrainingFailedError(
                            f"worker {rank} died: {e}") from e
                    if item[0] == "error":
                        raise TrainingFailedError(
                            f"train loop failed on worker {rank}:\n"
                            f"{item[1]}")
                    if item[0] == "done":
                        done[rank] = ("done", item[1])
                    elif item[0] == "result":
                        round_items.append((rank, item[1], item[2]))
            except TrainingFailedError:
                # a mid-round failure must not discard state the gang
                # already handed over: first the items consumed THIS
                # round, then a sweep of results reported but not yet
                # consumed (session.report parks the rank until
                # consumption) — during a graceful preemption the
                # draining ranks are still alive, and a dropped
                # checkpoint here is a whole checkpoint interval of
                # lost work
                for rank, metrics, ckpt in round_items:
                    if rank == 0:
                        yield metrics, ckpt
                yield from self._final_harvest(group, done)
                raise
            if all(d is not None for d in done):
                return
            for rank, metrics, ckpt in round_items:
                if rank == 0:
                    yield metrics, ckpt

    @staticmethod
    def _final_harvest(group: WorkerGroup, done: List[Any]):
        """Best-effort drain of pending rank reports on the failover
        path; yields rank-0 (metrics, checkpoint) pairs like the normal
        poll (dead ranks fail the RPC fast and are skipped)."""
        import ray_tpu_torch
        for rank, w in enumerate(group.workers):
            if done[rank] is not None:
                continue
            for _ in range(8):   # bounded: this is a teardown path
                try:
                    item = ray_tpu_torch.get(w.next_result.remote(timeout=0.1),
                                       timeout=15.0)
                except Exception:
                    break
                if item[0] != "result":
                    break
                if rank == 0:
                    yield item[1], item[2]

    def fit(self) -> Result:
        ckpt_cfg = self.run_config.checkpoint_config or CheckpointConfig()
        exp_dir = os.path.join(
            self.run_config.storage_path,
            self.run_config.name or f"{type(self).__name__}_"
                                    f"{time.strftime('%Y%m%d_%H%M%S')}")
        os.makedirs(exp_dir, exist_ok=True)
        last_metrics: Dict[str, Any] = {}
        kept: List[Any] = []   # (score, Checkpoint, metrics)
        error: Optional[Exception] = None
        try:
            for metrics, ckpt in self._iter_results():
                last_metrics = metrics
                if ckpt is not None:
                    kept.append((self._score(metrics, ckpt_cfg), ckpt,
                                 metrics))
                    kept = self._prune(kept, ckpt_cfg)
                if self._should_stop(metrics):
                    break
        except TrainingFailedError as e:
            error = e
        best = kept[-1][1] if kept else None
        if kept and ckpt_cfg.checkpoint_score_attribute:
            ordered = sorted(kept, key=lambda t: t[0],
                             reverse=ckpt_cfg.checkpoint_score_order == "max")
            best = ordered[0][1]
        # training failures come back on the Result (Tune-style); callers
        # that want an exception check result.error
        return Result(metrics=last_metrics, checkpoint=best, error=error,
                      log_dir=exp_dir,
                      best_checkpoints=[(c, m) for _, c, m in kept])

    def _score(self, metrics: Dict[str, Any], cfg: CheckpointConfig):
        attr = cfg.checkpoint_score_attribute
        if attr and attr in metrics:
            return metrics[attr]
        return metrics.get("training_iteration", 0)

    def _prune(self, kept: List[Any], cfg: CheckpointConfig) -> List[Any]:
        if cfg.num_to_keep is None or len(kept) <= cfg.num_to_keep:
            return kept
        if cfg.checkpoint_score_attribute:
            kept = sorted(kept, key=lambda t: t[0],
                          reverse=cfg.checkpoint_score_order == "max")
            return kept[:cfg.num_to_keep]
        return kept[-cfg.num_to_keep:]

    def _should_stop(self, metrics: Dict[str, Any]) -> bool:
        stop = self.run_config.stop
        if not stop:
            return False
        for k, v in stop.items():
            if k in metrics and metrics[k] >= v:
                return True
        return False
