"""PodracerExecutor: streaming ingest + compiled-DAG learner + elastic fleet
(counterpart of ray_tpu/rl/podracer/executor.py).

Data plane (docs/rl_podracer.md):

    rollout actor --stream()--> per-yield ObjectRefs --ingest thread-->
    bounded prefetch queue --main loop--> compiled DAG execute/get
                                             |
                                             +--> weight put() + KV bump
    rollout actor <--striped multi-source pull-- (between fragments)

* Each rollout actor runs ONE ``num_returns="streaming"`` generator for
  its whole lifetime; ``podracer_backpressure_fragments`` is stamped
  into the stream at submit time, bounding per-actor staleness.
* One ingest thread per actor drains item refs into a
  ``podracer_prefetch_depth``-bounded queue, overlapping fragment
  download/deserialization with the learner step.  A full queue blocks
  the thread, which stops acking the stream, which pauses the producer:
  backpressure propagates end to end with no polling.
* The learner step is a compiled DAG op (``inp -> learner.step``) on
  the ``LearnerActor``, which leases the card and steps there; the
  steady-state loop performs ZERO classic task submissions, asserted
  against ``ray_tpu_actor_tasks_submitted_total`` exactly like the
  MPMD pipeline runner.
* The fleet is elastic: a dead stream emits RL_ACTOR_LOST and a
  replacement rendezvous (pull current weights multi-source, new
  stream) runs on a side thread — the learner keeps consuming the
  survivors' fragments and never stalls beyond one backpressure
  window.  RL_ACTOR_JOINED closes the recovery-auditor episode.
"""

from __future__ import annotations

import queue
import threading
import time
import uuid
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

import ray_tpu_torch
from ray_tpu_torch._private import runtime_metrics as rtm
from ray_tpu_torch._private import step_stats
from ray_tpu_torch._private.cluster_events import (RL_ACTOR_JOINED,
                                             RL_ACTOR_LOST, emit)
from ray_tpu_torch._private.config import CONFIG
from ray_tpu_torch.dag.dag_node import InputNode

_SUBMIT_METRIC = "ray_tpu_actor_tasks_submitted_total"

_M_FRAGMENTS = rtm.counter(
    "ray_tpu_rl_fragments_consumed_total",
    "Rollout fragments the podracer learner consumed.")
_M_FRAMES = rtm.counter(
    "ray_tpu_rl_env_frames_total",
    "Env frames (timesteps) trained on by podracer learners.")
_M_ADOPTION_S = rtm.histogram(
    "ray_tpu_rl_weight_adoption_s",
    "Weight version publish -> adopted by the whole live fleet (s): "
    "the end-to-end multi-source broadcast latency the bench tables.")
_M_REPLACEMENTS = rtm.counter(
    "ray_tpu_rl_actor_replacements_total",
    "Rollout actors replaced after stream loss (elastic fleet).")


def _actor_submit_count() -> Optional[float]:
    """Owner-process total of classic actor-task submissions, or None
    when runtime metrics are disabled (the zero-submission assert then
    degrades to unchecked)."""
    snap = rtm.snapshot().get(_SUBMIT_METRIC)
    if not snap:
        return None
    return float(sum((snap.get("values") or {}).values()))


def _fragment_nbytes(fragment) -> int:
    return sum(int(np.asarray(v).nbytes) for v in fragment.values())


class PodracerExecutor:
    """Sebulba-style learner–actor executor for IMPALA and PPO."""

    def __init__(self, algo: str, config, *,
                 strict_zero_submit: bool = True):
        from ray_tpu_torch.rl.podracer.learner import learner_actor_class
        from ray_tpu_torch.rl.podracer.rollout import podracer_actor_class
        self.algo = algo
        self.config = config
        self.run_id = f"podracer-{algo}-{uuid.uuid4().hex[:6]}"
        self.weights_name = self.run_id
        self._mode = "time_major" if algo == "impala" else "gae"
        self._strict_zero_submit = strict_zero_submit
        self._stopping = False
        self._lock = threading.Lock()
        self._replacing = 0     # in-flight replacement rendezvous

        depth = max(1, int(CONFIG.podracer_prefetch_depth))
        self._queue: "queue.Queue" = queue.Queue(maxsize=depth)
        self._window = int(CONFIG.podracer_backpressure_fragments)

        # --- learner -----------------------------------------------------
        # the learner actor leases the card unless the config asks for
        # the CPU; the driver itself starts no CUDA
        device = getattr(config, "device", None)
        on_card = device is None or torch.device(device).type == "cuda"
        self._learner_cls = learner_actor_class(num_gpus=1 if on_card
                                                else 0)
        self.learner = self._learner_cls.remote(
            algo, config, self.weights_name)
        ray_tpu_torch.get(self.learner.ready.remote(), timeout=300.0)
        # version 1 exists before any actor rendezvous
        ray_tpu_torch.get(self.learner.publish_now.remote(),
                          timeout=300.0)
        self._publish_wall: Dict[int, float] = {1: time.time()}

        # --- fleet -------------------------------------------------------
        self._actor_cls = podracer_actor_class()
        self.num_actors = max(1, config.num_rollout_workers)
        self._slots: List[Dict[str, Any]] = [
            {"actor": None, "thread": None, "version": 0, "gen": None}
            for _ in range(self.num_actors)]
        for slot in range(self.num_actors):
            self._start_slot(slot)

        # --- telemetry ---------------------------------------------------
        self.telemetry: Dict[str, Any] = {
            "fragments": 0, "frames": 0, "learner_steps": 0,
            "replacements": 0, "versions_published": 1,
            "classic_submits_steady": 0.0 if _actor_submit_count()
            is not None else None,
            "weight_adoption_s": [],
            "weight_publish_ms": [], "weight_pull_ms": [],
        }
        self._episode_history: List[Dict[str, float]] = []
        self._dag = None
        self._pending: List[Tuple[Any, dict]] = []
        self._run = step_stats.start_run(
            self.run_id, group=f"podracer-{algo}",
            meta={"algo": algo, "actors": self.num_actors})
        self._clock = step_stats.step_clock()

    # ------------------------------------------------------------ fleet
    def _make_actor(self, slot: int):
        cfg = self.config
        return self._actor_cls.remote(
            cfg.env_spec, worker_index=slot,
            num_envs=cfg.num_envs_per_worker,
            rollout_fragment_length=cfg.rollout_fragment_length,
            gamma=cfg.gamma, lam=cfg.lam, hidden=cfg.hidden,
            seed=cfg.seed)

    def _start_slot(self, slot: int, *, rejoin: bool = False) -> dict:
        """Spawn the slot's actor, rendezvous (multi-source weight
        pull), and open its fragment stream."""
        actor = self._make_actor(slot)
        report = ray_tpu_torch.get(
            actor.pull_weights.remote(self.weights_name), timeout=300.0)
        # the OWNER's config is stamped into the stream at submit time:
        # scope the override to this submission
        prev = CONFIG.generator_backpressure_num_objects
        CONFIG.set("generator_backpressure_num_objects",
                   self._window if self._window > 0 else -1)
        try:
            gen = actor.stream.options(num_returns="streaming").remote(
                self.weights_name, mode=self._mode)
        finally:
            CONFIG.set("generator_backpressure_num_objects", prev)
        st = self._slots[slot]
        st["actor"], st["gen"] = actor, gen
        st["version"] = int(report.get("weight_version", 0))
        thread = threading.Thread(
            target=self._ingest, args=(slot, gen),
            name=f"podracer-ingest-{slot}", daemon=True)
        st["thread"] = thread
        thread.start()
        if rejoin:
            emit(RL_ACTOR_JOINED,
                 f"rollout actor rejoined slot {slot}",
                 run_id=self.run_id, slot=slot,
                 weight_version=report.get("weight_version"),
                 weight_pull_ms=report.get("weight_pull_ms"))
        return report

    def _ingest(self, slot: int, gen) -> None:
        """Per-actor drain loop: stream item ref -> fragment -> queue.
        Runs until the stream ends (bounded runs), the executor stops,
        or the actor dies (-> loss marker; a replacement thread takes
        over the slot)."""
        try:
            for item_ref in gen:
                if not self._put(("frag", slot,
                                  ray_tpu_torch.get(item_ref))):
                    return
            self._put(("end", slot, None))
        except Exception as e:  # stream died: actor lost
            if not self._stopping:
                self._put(("lost", slot, repr(e)))

    def _put(self, item) -> bool:
        """Bounded put that gives up when the executor is stopping (so
        ingest threads never deadlock against a gone consumer)."""
        while not self._stopping:
            try:
                self._queue.put(item, timeout=0.25)
                return True
            except queue.Full:
                continue
        return False

    def _replace_slot(self, slot: int) -> None:
        """Side-thread replacement: the learner keeps consuming other
        actors' fragments while the replacement rendezvous runs."""
        try:
            old = self._slots[slot]["actor"]
            if old is not None:
                try:
                    ray_tpu_torch.kill(old)
                except Exception:
                    pass
            self._start_slot(slot, rejoin=True)
            with self._lock:
                self.telemetry["replacements"] += 1
                self._replacing -= 1
            _M_REPLACEMENTS.inc()
        except Exception:
            if not self._stopping:
                # retry once after a beat; a dead cluster stops anyway
                time.sleep(1.0)
                if not self._stopping:
                    self._replace_slot(slot)
                    return
            with self._lock:
                self._replacing -= 1

    # --------------------------------------------------------- ingestion
    def _next_fragment(self, timeout: float = 120.0):
        """(slot, fragment, meta) from the prefetch queue, transparently
        folding loss markers into replacement kicks."""
        deadline = time.monotonic() + timeout
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise TimeoutError(
                    f"no fragment within {timeout}s "
                    f"(live actors: {self._live_actors()})")
            try:
                kind, slot, value = self._queue.get(timeout=min(
                    remaining, 1.0))
            except queue.Empty:
                continue
            if kind == "frag":
                frag, meta = value
                return slot, frag, meta
            if kind == "lost":
                emit(RL_ACTOR_LOST,
                     f"rollout stream {slot} died: {value}",
                     severity="WARNING", run_id=self.run_id,
                     slot=slot, reason=str(value)[:200])
                with self._lock:
                    self._replacing += 1
                threading.Thread(
                    target=self._replace_slot, args=(slot,),
                    name=f"podracer-replace-{slot}",
                    daemon=True).start()
                continue
            # "end": a bounded stream finished; nothing to do

    def _live_actors(self) -> int:
        return sum(1 for s in self._slots if s["actor"] is not None)

    # ---------------------------------------------------------- learner
    def _compile(self, payload) -> None:
        frag_bytes = _fragment_nbytes(payload[0])
        buf = max(1 << 16, 2 * frag_bytes + 16384)
        with InputNode() as inp:
            node = self.learner.step.bind(inp)
        self._dag = node.experimental_compile(
            max_inflight=2, buffer_size_bytes=buf,
            name=f"podracer-{self.algo}")

    def _observe_result(self, out: dict, meta: dict) -> None:
        t = self.telemetry
        t["learner_steps"] = out["step"]
        t["fragments"] += 1
        t["frames"] += out["frames"]
        _M_FRAGMENTS.inc()
        _M_FRAMES.inc(out["frames"])
        v = int(out.get("published_version") or 0)
        if v:
            t["versions_published"] = v
            self._publish_wall[v] = time.time()
            t["weight_publish_ms"].append(out["publish_ms"])
        if meta.get("weight_sync_ms"):
            t["weight_pull_ms"].append(meta["weight_sync_ms"])
        # fleet-wide adoption: version v is adopted when every live
        # slot's newest meta reports >= v
        slot = int(meta.get("worker_index", 0))
        if 0 <= slot < len(self._slots):
            self._slots[slot]["version"] = max(
                self._slots[slot]["version"],
                int(meta.get("weight_version", 0)))
        floor = min((s["version"] for s in self._slots
                     if s["actor"] is not None), default=0)
        for pv in sorted(self._publish_wall):
            if pv <= floor:
                lat = time.time() - self._publish_wall.pop(pv)
                t["weight_adoption_s"].append(lat)
                _M_ADOPTION_S.observe(lat)
        for ep in meta.get("episodes") or []:
            self._episode_history.append(ep)
        self._episode_history = self._episode_history[-100:]

    def train_iteration(self, num_steps: Optional[int] = None,
                        timeout: float = 120.0) -> Dict[str, Any]:
        """Consume ``num_steps`` fragments through the compiled learner.

        A two-deep software pipeline (matching the DAG's max_inflight)
        keeps one execute in flight while the previous result is
        fetched, so device upload overlaps the next dequeue."""
        n = num_steps or getattr(self.config, "batches_per_step", None)
        if not n:
            # PPO-style configs budget by frames, not fragments: consume
            # the same env-frame budget per iteration as the classic
            # executor's train_batch_size gather
            tb = getattr(self.config, "train_batch_size", 0)
            fl = getattr(self.config, "rollout_fragment_length", 0) or 1
            n = max(1, tb // fl) if tb else 4
        aux_last: Dict[str, Any] = {}
        inflight: List[Tuple[Any, dict]] = []
        c0 = c1 = None
        repl0 = self.telemetry["replacements"]
        for i in range(n):
            self._clock.begin()
            with self._clock.phase("dequeue_wait"):
                slot, frag, meta = self._next_fragment(timeout)
            if self._dag is None:
                self._compile((frag, meta))
            if i == 0:
                # steady-state window starts after compile (compile and
                # replacements legitimately submit classic tasks)
                c0 = _actor_submit_count()
            with self._clock.phase("learner_step"):
                inflight.append((self._dag.execute((frag, meta)), meta))
                if len(inflight) >= 2:
                    ref, m = inflight.pop(0)
                    out = ref.get(timeout=timeout)
                    aux_last = out["aux"]
                    self._observe_result(out, m)
            self._clock.end(tokens=int(np.asarray(frag["rewards"]).size))
        with self._clock.phase("learner_step"):
            for ref, m in inflight:
                out = ref.get(timeout=timeout)
                aux_last = out["aux"]
                self._observe_result(out, m)
        c1 = _actor_submit_count()
        with self._lock:
            replaced = (self.telemetry["replacements"] - repl0
                        + self._replacing)
        if c0 is not None and c1 is not None and not replaced:
            delta = c1 - c0
            self.telemetry["classic_submits_steady"] += delta
            if delta and self._strict_zero_submit:
                raise RuntimeError(
                    f"podracer steady-state loop issued {delta} classic "
                    "task submissions; the zero-submission contract is "
                    "broken (docs/rl_podracer.md)")
        info = dict(aux_last)
        info["batches_processed"] = n
        info["weight_version"] = self.telemetry["versions_published"]
        info["replacements"] = self.telemetry["replacements"]
        return {"info": info,
                "timesteps_this_iter": int(self.telemetry["frames"])}

    # ----------------------------------------------------------- driver
    def collect_episode_metrics(self) -> List[Dict[str, float]]:
        out = list(self._episode_history)
        return out

    def get_weights(self):
        return ray_tpu_torch.get(self.learner.get_weights.remote(),
                                 timeout=120.0)

    def set_weights(self, weights) -> None:
        ray_tpu_torch.get(self.learner.set_weights.remote(weights),
                          timeout=120.0)

    def get_full_state(self):
        return ray_tpu_torch.get(self.learner.get_state.remote(),
                                 timeout=120.0)

    def set_full_state(self, state) -> None:
        # the set_state publish bump makes every actor adopt the
        # restored weights at its next fragment boundary
        ray_tpu_torch.get(self.learner.set_state.remote(state),
                          timeout=120.0)

    def learner_stats(self) -> dict:
        return ray_tpu_torch.get(self.learner.stats.remote(), timeout=120.0)

    def goodput_summary(self) -> Optional[dict]:
        run = self._run
        if run is None:
            return None
        return run.ledger.summary()

    def stop(self) -> None:
        self._stopping = True
        for st in self._slots:
            gen = st.get("gen")
            if gen is not None:
                try:
                    gen.close()
                except Exception:
                    pass
            if st["actor"] is not None:
                try:
                    ray_tpu_torch.kill(st["actor"])
                except Exception:
                    pass
                st["actor"] = None
        if self._dag is not None:
            try:
                self._dag.teardown()
            except Exception:
                pass
            self._dag = None
        try:
            ray_tpu_torch.kill(self.learner)
        except Exception:
            pass
        for st in self._slots:
            t = st.get("thread")
            if t is not None and t.is_alive():
                t.join(timeout=2.0)
        step_stats.end_run(self._run)
        self._run = None
