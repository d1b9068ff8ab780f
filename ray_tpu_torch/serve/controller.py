"""ServeController: detached actor owning all deployment state.

Analog of Ray's python/ray/serve/controller.py (ServeController
:61) + _private/deployment_state.py (DeploymentState/DeploymentStateManager
:958/:1767): a reconcile loop drives each deployment's replica set toward
its target (rolling updates via version stamps, health checks, autoscaling
from replica queue metrics).

Config propagation: the reference pushes via LongPollHost
(_private/long_poll.py:185). ray_tpu_torch actors execute methods from one
ordered queue, so a blocking long-poll would starve the controller;
handles/proxies instead short-poll ``get_targets`` with a version stamp
(cheap dict compare server-side) — same eventual-consistency contract.
"""

from __future__ import annotations

import math
import threading
import time
import uuid
from typing import Any, Dict, Optional

from ray_tpu_torch._private.config import CONFIG

CONTROLLER_NAME = "SERVE_CONTROLLER"
SERVE_NAMESPACE = "serve"
REPLICA_PREFIX = "SERVE_REPLICA::"


class ServeController:
    def __init__(self):
        # deployment name -> state dict
        self._deployments: Dict[str, Dict[str, Any]] = {}
        self._lock = threading.RLock()
        self._global_version = 0
        self._shutdown = False
        # SLO-driven elastic re-roling (docs/serve_frontdoor.md): at
        # most ONE replica moves between a disagg pair's pools at a
        # time; the pending move + the last per-route violation
        # snapshot live here
        self._rerole: Optional[Dict[str, Any]] = None
        self._last_rerole_done = 0.0
        self._last_rerole_check = 0.0
        self._slo_last: Dict[str, tuple] = {}
        self._reconcile_thread = threading.Thread(
            target=self._reconcile_loop, daemon=True)
        self._reconcile_thread.start()

    # ----------------------------------------------------------- public API
    def deploy(self, name: str, serialized_init: bytes,
               config: Dict[str, Any]) -> None:
        with self._lock:
            state = self._deployments.get(name)
            version = (state["version"] + 1) if state else 1
            auto = config.get("autoscaling_config")
            target = config.get("num_replicas", 1)
            if auto:
                target = max(auto["min_replicas"],
                             min(target, auto["max_replicas"]))
            self._deployments[name] = {
                "name": name,
                "version": version,
                # routing_version bumps on ANY replica-set change (scale,
                # crash retirement, rolling update) so handles always see
                # fresh tables; "version" stamps the code/config rollout.
                "routing_version": (state["routing_version"] + 1) if state
                                   else 1,
                "serialized_init": serialized_init,
                "config": config,
                "target_replicas": target,
                "replicas": dict(state["replicas"]) if state else {},
                # replica_tag -> {"name", "version", "healthy"}
                "status": "UPDATING",
                "last_scale_up": 0.0,
                "last_scale_down": 0.0,
                "ongoing_history": [],
            }
            self._global_version += 1

    def delete_deployment(self, name: str) -> None:
        with self._lock:
            state = self._deployments.pop(name, None)
            self._global_version += 1
        if state:
            for info in state["replicas"].values():
                self._kill_replica(info["name"])

    def get_targets(self, name: str,
                    known_version: int = -1) -> Optional[Dict[str, Any]]:
        """Replica routing table for one deployment; handles poll this.

        ``loads`` (replica name -> last health-checked load signal) and
        ``nodes`` (replica name -> node id) ride EVERY reply, including
        version-unchanged ones: loads cover traffic other handles sent
        (handle-local in-flight counts can't see it — power-of-two
        choices on stale or handle-local-only depth hotspots a decode
        pool under skewed stream lengths), and they change every
        health-check pass without bumping routing_version."""
        with self._lock:
            state = self._deployments.get(name)
            if state is None:
                return None
            loads = {i["name"]: i.get("last_load", 0.0)
                     for i in state["replicas"].values()
                     if i["healthy"] and not i.get("draining")}
            # prefix-digest advertisements ride every reply like loads
            # (docs/serve_frontdoor.md): they change each health-check
            # pass without bumping routing_version, and handles rebuild
            # their affinity index from the full current set.  Absent
            # entirely (not empty) when no replica advertises, so
            # non-LLM handles never materialize an index.
            prefixes = {i["name"]: i["last_prefixes"]
                        for i in state["replicas"].values()
                        if i["healthy"] and not i.get("draining")
                        and i.get("last_prefixes")}
            if state["routing_version"] == known_version:
                out = {"version": known_version, "unchanged": True,
                       "loads": loads}
            else:
                out = {
                    "version": state["routing_version"],
                    "replicas": [i["name"]
                                 for i in state["replicas"].values()
                                 if i["healthy"] and not i.get("draining")
                                 and i["version"] == state["version"]],
                    "nodes": {i["name"]: i.get("node_id", "")
                              for i in state["replicas"].values()},
                    "loads": loads,
                    "max_concurrent_queries":
                        state["config"].get("max_concurrent_queries", 8),
                }
            if prefixes:
                out["prefixes"] = prefixes
            return out

    def list_deployments(self):
        with self._lock:
            return sorted(self._deployments)

    def status(self) -> Dict[str, Any]:
        with self._lock:
            return {
                name: {
                    "status": s["status"],
                    "version": s["version"],
                    "target_replicas": s["target_replicas"],
                    "running_replicas": sum(
                        1 for i in s["replicas"].values()
                        if i["healthy"] and not i.get("draining")
                        and i["version"] == s["version"]),
                    "replicas": [tag for tag, i in s["replicas"].items()
                                 if i["healthy"] and not i.get("draining")
                                 and i["version"] == s["version"]],
                }
                for name, s in self._deployments.items()
            }

    def shutdown_serve(self) -> None:
        with self._lock:
            self._shutdown = True
            deployments = list(self._deployments.values())
            self._deployments.clear()
        try:
            from ray_tpu_torch.experimental import internal_kv
            internal_kv._internal_kv_del("serve:status")
        except Exception:
            pass  # dashboard may briefly show stale status
        for state in deployments:
            for info in state["replicas"].values():
                self._kill_replica(info["name"])

    def ping(self) -> bool:
        return True

    # ------------------------------------------------------------ re-roling
    def request_rerole(self, src: str, dst: str, *,
                       reason: str = "manual",
                       slo_kind: Optional[str] = None,
                       trace_id: Optional[str] = None) -> bool:
        """Move one replica's worth of capacity from deployment ``src``
        to ``dst`` (docs/serve_frontdoor.md re-roling control loop):
        the lowest-load ``src`` replica starts draining immediately
        (it leaves the routing table this instant, finishes its
        in-flight streams, then retires), ``dst``'s target rises by
        one, and the reconcile loop converges both pools.  Emits
        SERVE_REROLE now and SERVE_REROLE_DONE when both pools reach
        their new targets — the pair the recovery auditor folds into a
        ``rerole`` episode (kind, ``recovery_slo_rerole_s``).

        Refused (returns False) while another re-role is in flight, for
        unknown deployments, or when ``src`` cannot give up a replica
        without emptying (its target must stay >= 1)."""
        from ray_tpu_torch._private import cluster_events as cev

        with self._lock:
            s = self._deployments.get(src)
            d = self._deployments.get(dst)
            if s is None or d is None or self._rerole is not None:
                return False
            if s["target_replicas"] < 2:
                return False
            # the donor: lowest-load healthy replica — the cheapest
            # drain, and under prefix-affinity skew also the one whose
            # resident pages the router will miss least
            cand = [(i.get("last_load", 0.0), tag)
                    for tag, i in s["replicas"].items()
                    if i["healthy"] and not i.get("draining")]
            if not cand:
                return False
            donor = min(cand)[1]
            s["target_replicas"] -= 1
            d["target_replicas"] += 1
            # drain the chosen donor NOW (reconcile sees excess 0 and
            # drains nothing else); routing_version bumps so handles
            # polling "unchanged" drop it from their tables
            s["replicas"][donor]["draining"] = time.monotonic()
            s["routing_version"] += 1
            self._rerole = {
                "src": src, "dst": dst, "replica": donor,
                "src_target": s["target_replicas"],
                "dst_target": d["target_replicas"],
                "started": time.monotonic(),
            }
        cev.emit(cev.SERVE_REROLE,
                 f"re-roling one replica {src} -> {dst}: drain {donor} "
                 f"({reason})",
                 src=src, dst=dst, replica=donor, reason=reason,
                 slo_kind=slo_kind, trace_id=trace_id)
        return True

    def _check_rerole_done(self) -> None:
        """Close the pending re-role once both pools converged: the
        donor retired from ``src`` and ``dst`` runs at its raised
        target.  Emits SERVE_REROLE_DONE (the auditor's episode
        close)."""
        r = self._rerole
        if r is None:
            return
        with self._lock:
            s = self._deployments.get(r["src"])
            d = self._deployments.get(r["dst"])
            if s is None or d is None:
                # a redeploy/teardown raced the move: abandon it (the
                # episode stays open in the auditor, which is the
                # truthful record — convergence never happened)
                self._rerole = None
                return

            def _running(st):
                return sum(1 for i in st["replicas"].values()
                           if i["healthy"] and not i.get("draining")
                           and i["version"] == st["version"])

            src_n, dst_n = _running(s), _running(d)
            done = (dst_n >= r["dst_target"]
                    and r["replica"] not in s["replicas"])
        if not done:
            return
        from ray_tpu_torch._private import cluster_events as cev
        cev.emit(cev.SERVE_REROLE_DONE,
                 f"re-role {r['src']} -> {r['dst']} complete: "
                 f"{src_n} / {dst_n} replicas",
                 src=r["src"], dst=r["dst"], replica=r["replica"],
                 src_replicas=src_n, dst_replicas=dst_n)
        self._rerole = None
        self._last_rerole_done = time.monotonic()

    def _maybe_rerole(self) -> None:
        """The SLO policy half of re-roling: every
        ``serve_rerole_interval_s`` read the ingress SLO route index
        (tracing_helper GcsSpanTable ``slo_by_route``) and, for each
        disagg pool pair, compare the interval's NEW ttft vs tpot
        violations on the pair's route.  TTFT burning -> the prefill
        pool is starved -> decode donates a replica; TPOT burning ->
        decode is starved -> prefill donates.  A tie or a trickle
        (under ``serve_rerole_min_violations``) moves nothing, and
        ``serve_rerole_cooldown_s`` spaces moves so a pool settles
        (drain + engine warmup) before the next reading acts."""
        if not CONFIG.serve_rerole_enabled or self._rerole is not None:
            return
        now = time.monotonic()
        if now - self._last_rerole_check < CONFIG.serve_rerole_interval_s:
            return
        self._last_rerole_check = now
        with self._lock:
            names = set(self._deployments)
        pairs = [n[:-len("-decode")] for n in names
                 if n.endswith("-decode")
                 and n[:-len("-decode")] + "-prefill" in names]
        if not pairs:
            return
        try:
            from ray_tpu_torch.experimental.state.api import trace_stats
            slo = trace_stats().get("slo_by_route") or {}
        except Exception:
            return      # span table unreachable: no signal, no move
        in_cooldown = now - self._last_rerole_done \
            < CONFIG.serve_rerole_cooldown_s
        for base in pairs:
            decode, prefill = base + "-decode", base + "-prefill"
            slot = slo.get(decode)
            if not slot:
                continue
            cur = (int(slot.get("ttft_violation", 0)),
                   int(slot.get("tpot_violation", 0)))
            prev = self._slo_last.get(decode, (0, 0))
            # the snapshot always advances: violations burned during a
            # cooldown are consumed, not banked for a later move
            self._slo_last[decode] = cur
            if in_cooldown:
                continue
            d_ttft, d_tpot = cur[0] - prev[0], cur[1] - prev[1]
            if max(d_ttft, d_tpot) < CONFIG.serve_rerole_min_violations \
                    or d_ttft == d_tpot:
                continue
            exemplars = slot.get("exemplars") or []
            trace_id = exemplars[0].get("trace_id") if exemplars else None
            if d_ttft > d_tpot:
                self.request_rerole(
                    decode, prefill,
                    reason=f"{d_ttft} ttft violations on {decode} "
                           f"this interval (tpot: {d_tpot})",
                    slo_kind="ttft", trace_id=trace_id)
            else:
                self.request_rerole(
                    prefill, decode,
                    reason=f"{d_tpot} tpot violations on {decode} "
                           f"this interval (ttft: {d_ttft})",
                    slo_kind="tpot", trace_id=trace_id)
            return      # one move per reading across all pairs

    # ------------------------------------------------------- reconciliation
    def _reconcile_loop(self):
        while not self._shutdown:
            try:
                self._maybe_rerole()
                self._reconcile_once()
                self._check_rerole_done()
                self._publish_status()
            except Exception:  # noqa: BLE001 - loop must survive
                import traceback
                traceback.print_exc()
            time.sleep(max(0.01, CONFIG.serve_controller_loop_ms / 1000.0))

    def _publish_status(self):
        """Snapshot status into GCS internal KV so non-driver processes
        (dashboard REST, `ray serve status`) can read it — the role of the
        reference controller's GCS-KV checkpoints (serve controller.py:61
        'owns state in GCS KV')."""
        import json

        from ray_tpu_torch.experimental import internal_kv
        snap = json.dumps(self.status(), sort_keys=True)
        if snap != getattr(self, "_last_status_snap", None):
            # put first: a failed put must retry next pass, not wait for
            # the next status transition
            internal_kv._internal_kv_put("serve:status", snap.encode())
            self._last_status_snap = snap

    def _reconcile_once(self):
        import ray_tpu_torch
        from ray_tpu_torch.serve.replica import ReplicaActor

        with self._lock:
            deployments = list(self._deployments.keys())
        for name in deployments:
            with self._lock:
                state = self._deployments.get(name)
                if state is None:
                    continue
                version = state["version"]
                target = state["target_replicas"]
                config = state["config"]
                replicas = dict(state["replicas"])

            # health checks + metrics; a replica is dead only after
            # HEALTH_CHECK_FAILURE_THRESHOLD consecutive failures (cf.
            # reference deployment_state ReplicaState STARTING vs RUNNING:
            # freshly created replicas get a startup grace period)
            healthy_current = []
            total_ongoing = 0.0
            metrics_partial = False
            for tag, info in list(replicas.items()):
                try:
                    handle = ray_tpu_torch.get_actor(info["name"],
                                               namespace=SERVE_NAMESPACE)
                    metrics = ray_tpu_torch.get(handle.get_metrics.remote(),
                                          timeout=config.get(
                                              "health_check_period_s", 2.0))
                    info["healthy"] = True
                    info["fails"] = 0
                    info["ever_healthy"] = True
                    info["last_ongoing"] = metrics["num_ongoing"]
                    # the autoscaling signal: the replica's custom load
                    # (per-pool queue depth / slot pressure) when its
                    # callable publishes one, else == num_ongoing
                    info["last_load"] = metrics.get(
                        "load", metrics["num_ongoing"])
                    info["last_prefixes"] = metrics.get("prefixes")
                    if metrics.get("node_id"):
                        info["node_id"] = metrics["node_id"]
                    total_ongoing += metrics["num_ongoing"]
                except Exception:
                    metrics_partial = True
                    info.pop("last_ongoing", None)
                    info.pop("last_load", None)
                    info.pop("last_prefixes", None)
                    info["fails"] = info.get("fails", 0) + 1
                    grace_s = config.get("health_check_grace_period_s", 120.0)
                    grace = (time.monotonic() - info.get("created_at", 0.0)
                             < grace_s)
                    # the startup grace shields a replica still LOADING
                    # (big model + first compile) from being shot before
                    # it ever answered; a replica that already served a
                    # health check and then went dark is DEAD — keeping
                    # it routable for the rest of the grace window would
                    # bounce every p2c pick that lands on it
                    if info["fails"] >= 3 and (info.get("ever_healthy")
                                               or not grace):
                        info["healthy"] = False
                if info["healthy"] and info["version"] == version:
                    healthy_current.append(tag)

            # autoscaling decision — when any replica's metrics read
            # failed this pass, the partial total_ongoing is a LOWER
            # bound on demand: upscaling on it is safe (e.g. a new
            # replica still compiling must not freeze a burst response),
            # but a phantom downscale would kill real work — suppressed.
            # The policy sees ONLY non-draining replicas (count and
            # ongoing): draining replicas take no new traffic, so their
            # near-zero ongoing would dilute the per-replica average and
            # suppress a needed upscale, while their finishing tails
            # would inflate demand and flap a scale-down back up.
            auto = config.get("autoscaling_config")
            if auto and healthy_current:
                serving = [t for t in healthy_current
                           if not replicas[t].get("draining")]
                # the policy consumes each replica's LOAD signal (custom
                # per-pool metric when published, == ongoing otherwise);
                # the non-draining denominator contract is unchanged and
                # holds per pool — each deployment reconciles alone
                serving_ongoing = sum(
                    replicas[t].get("last_load", 0.0) for t in serving)
                new_target = self._autoscale(name, auto, serving_ongoing,
                                             len(serving), target)
                if new_target > target or not metrics_partial:
                    if new_target != target:
                        # autoscale decision: one event per target
                        # change, with the inputs that drove it
                        # (docs/observability.md)
                        from ray_tpu_torch._private import cluster_events \
                            as cev
                        cev.emit(
                            cev.AUTOSCALE,
                            f"deployment {name!r}: target "
                            f"{target} -> {new_target} "
                            f"(load={serving_ongoing:.1f} over "
                            f"{len(serving)} serving)",
                            deployment=name, old_target=target,
                            new_target=new_target,
                            load=round(serving_ongoing, 2))
                    target = new_target

            # a rising target revives draining replicas before spawning
            # new ones (their engine/caches are warm)
            active = [t for t in healthy_current
                      if not replicas[t].get("draining")]
            for tag in healthy_current:
                if len(active) >= target:
                    break
                if replicas[tag].get("draining"):
                    replicas[tag].pop("draining", None)
                    active.append(tag)

            # scale up: start missing replicas at the current version
            missing = target - len(active)
            for _ in range(max(0, missing)):
                tag = f"{name}#{uuid.uuid4().hex[:8]}"
                actor_name = REPLICA_PREFIX + tag
                opts = dict(config.get("ray_actor_options") or {})
                max_cq = config.get("max_concurrent_queries", 8)
                try:
                    ray_tpu_torch.remote(ReplicaActor).options(
                        name=actor_name,
                        namespace=SERVE_NAMESPACE,
                        lifetime="detached",
                        max_concurrency=max_cq + 2,
                        num_cpus=opts.get("num_cpus", 0.1),
                        num_gpus=opts.get("num_gpus", 0.0),
                        resources=opts.get("resources"),
                    ).remote(state["serialized_init"], name, tag,
                             config.get("user_config"), max_cq)
                    replicas[tag] = {"name": actor_name, "version": version,
                                     "healthy": True, "fails": 0,
                                     "created_at": time.monotonic()}
                except Exception:
                    import traceback
                    traceback.print_exc()

            # scale down / retire old-version or unhealthy replicas.
            # Healthy excess replicas DRAIN instead of dying mid-request:
            # a draining replica leaves the routing table immediately
            # (get_targets filters on "draining") but is killed only once
            # its ongoing count hits zero or the drain grace expires —
            # cf. reference deployment_state graceful_shutdown_wait_loop_s.
            to_kill = []
            excess = len(active) - target
            drain_grace = config.get("graceful_shutdown_timeout_s", 30.0)
            now = time.monotonic()
            for tag, info in list(replicas.items()):
                if info["version"] != version or not info["healthy"]:
                    to_kill.append(tag)       # broken: no point draining
                elif excess > 0 and not info.get("draining"):
                    info["draining"] = now
                    excess -= 1
            # handles refresh their routing table at most every
            # _REFRESH_INTERVAL_S (1.0 s): a drained-empty replica must
            # outlive that window or a stale-table handle can land a
            # request in the instant between the idle check and the kill
            min_drain_s = 2.0
            for tag, info in list(replicas.items()):
                if tag in to_kill or not info.get("draining"):
                    continue
                # last_ongoing was fetched by the health loop THIS pass;
                # a failed read means unreachable != idle — keep
                # draining until the grace expires rather than shooting
                # a busy replica mid-request
                ongoing = info.get("last_ongoing")
                age = now - info["draining"]
                if (ongoing == 0 and age > min_drain_s) \
                        or age > drain_grace:
                    to_kill.append(tag)
            for tag in to_kill:
                info = replicas.pop(tag)
                from ray_tpu_torch._private import cluster_events as cev
                why = ("unhealthy" if not info.get("healthy")
                       else "old version"
                       if info.get("version") != version
                       else "scaled down (drained)")
                cev.emit(cev.REPLICA_RETIRED,
                         f"deployment {name!r} replica {tag}: {why}",
                         severity="WARNING" if why == "unhealthy"
                         else "INFO",
                         deployment=name, replica=tag, reason=why)
                self._kill_replica(info["name"])

            with self._lock:
                cur = self._deployments.get(name)
                if cur is None:
                    # deployment deleted mid-pass: kill replicas we created
                    orphans = [i["name"] for i in replicas.values()]
                elif cur["version"] != version:
                    # deploy() raced us: keep every replica tracked so the
                    # next pass retires old-version ones (nothing orphaned)
                    orphans = []
                    for tag, info in replicas.items():
                        cur["replicas"].setdefault(tag, info)
                    cur["routing_version"] += 1
                else:
                    orphans = []
                    if (set(replicas) != set(cur["replicas"])
                            or any((replicas[t]["healthy"],
                                    bool(replicas[t].get("draining")))
                                   != (cur["replicas"][t]["healthy"],
                                       bool(cur["replicas"][t]
                                            .get("draining")))
                                   for t in replicas
                                   if t in cur["replicas"])):
                        cur["routing_version"] += 1
                    cur["replicas"] = replicas
                    cur["target_replicas"] = target
                    running = sum(1 for i in replicas.values()
                                  if i["healthy"] and not i.get("draining")
                                  and i["version"] == version)
                    cur["status"] = ("HEALTHY" if running >= target
                                     else "UPDATING")
            for actor_name in orphans:
                self._kill_replica(actor_name)

    def _autoscale(self, name: str, auto: Dict[str, Any], total_ongoing:
                   float, num_replicas: int, target: int) -> int:
        """Queue-depth policy, cf. reference
        serve/_private/autoscaling_policy.py (calculate_desired_num_replicas):
        ``desired = num_replicas * (avg_ongoing / target_per_replica)``.

        ``num_replicas`` and ``total_ongoing`` MUST cover the same set —
        the NON-draining replicas (the caller filters) — or the average
        is diluted/inflated by replicas that take no new traffic.
        """
        desired = math.ceil(
            total_ongoing /
            max(auto["target_num_ongoing_requests_per_replica"], 1e-6))
        desired = max(auto["min_replicas"],
                      min(auto["max_replicas"], desired))
        now = time.monotonic()
        with self._lock:
            state = self._deployments.get(name)
            if state is None:
                return target
            if desired > target:
                if state["last_scale_up"] == 0.0:
                    state["last_scale_up"] = now
                if now - state["last_scale_up"] >= auto["upscale_delay_s"]:
                    state["last_scale_up"] = 0.0
                    state["last_scale_down"] = 0.0
                    return desired
            elif desired < target:
                if state["last_scale_down"] == 0.0:
                    state["last_scale_down"] = now
                if now - state["last_scale_down"] >= auto["downscale_delay_s"]:
                    state["last_scale_up"] = 0.0
                    state["last_scale_down"] = 0.0
                    return desired
            else:
                state["last_scale_up"] = 0.0
                state["last_scale_down"] = 0.0
        return target

    def _kill_replica(self, actor_name: str) -> None:
        import ray_tpu_torch
        try:
            handle = ray_tpu_torch.get_actor(actor_name,
                                       namespace=SERVE_NAMESPACE)
            try:
                ray_tpu_torch.get(handle.prepare_for_shutdown.remote(), timeout=6)
            except Exception:
                pass
            ray_tpu_torch.kill(handle)
        except Exception:
            pass
