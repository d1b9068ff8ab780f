"""Central flag table for ray_tpu_torch.

Analog of the reference's ``RAY_CONFIG`` macro system
(/root/reference/src/ray/common/ray_config_def.h: 188 flags, overridable via
``RAY_<NAME>`` env vars or ``ray.init(_system_config=...)``).  Here the table is
a single Python dataclass-of-record: every knob is declared once with a type and
default, is overridable via ``RAY_TPU_TORCH_<NAME>`` environment variables, and can be
bulk-overridden at ``init(system_config={...})`` time (the dict is serialized to
every spawned daemon/worker process through its environment).
"""

from __future__ import annotations

import copy
import json
import os
import threading
from typing import Any, Dict

_ENV_PREFIX = "RAY_TPU_TORCH_"
_SYSTEM_CONFIG_ENV = "RAY_TPU_TORCH_SYSTEM_CONFIG"


class _Flag:
    __slots__ = ("name", "type", "default", "doc")

    def __init__(self, name: str, type_: type, default: Any, doc: str = ""):
        self.name = name
        self.type = type_
        self.default = default
        self.doc = doc

    def parse(self, raw: str) -> Any:
        if self.type is bool:
            return raw.lower() in ("1", "true", "yes", "on")
        if self.type in (dict, list):
            return json.loads(raw)
        return self.type(raw)


_FLAG_TABLE: Dict[str, _Flag] = {}


def _declare(name: str, type_: type, default: Any, doc: str = "") -> None:
    _FLAG_TABLE[name] = _Flag(name, type_, default, doc)


# --------------------------------------------------------------------------- #
# Core runtime                                                                #
# --------------------------------------------------------------------------- #
_declare("inline_object_max_bytes", int, 100 * 1024,
         "Objects at most this size are inlined in RPC replies / the in-process "
         "memory store instead of the shared-memory store.")
_declare("object_store_memory_bytes", int, 2 * 1024**3,
         "Default per-node shared-memory object store capacity.")
_declare("object_store_fallback_dir", str, "",
         "Directory holding spilled-object files; empty means a spill_<node> "
         "dir inside the session dir (removed at raylet shutdown).")
_declare("object_store_dir", str, "/dev/shm",
         "Directory holding the shared-memory store segment (plasma "
         "convention: tmpfs, so big writes never hit disk writeback). "
         "Falls back to the session dir when missing or too small.")
_declare("object_store_prefault", bool, True,
         "Pre-touch the store segment's pages from a background thread at "
         "raylet start.  First-touch faults can be an order of magnitude "
         "slower than warm writes (VM memory ballooning / on-demand "
         "paging); prefaulting moves that cost off the put critical path.")
_declare("object_spill_threshold", float, 0.8,
         "Fraction of store capacity above which primary copies spill to disk.")
_declare("object_spill_fault", str, "",
         "Fault-injection seam for spill IO: 'unstable' fails every other "
         "spill write, 'slow' adds latency per spill (reference unstable/"
         "slow external-storage fakes, external_storage.py:587/608).")
_declare("object_spill_uri", str, "",
         "Storage URI objects spill to (file:// dir, mock:// for tests); "
         "empty means the local spill dir. Fallback-allocated primaries "
         "always stay on local disk, as in reference plasma "
         "(external_storage.py:72 ExternalStorage seam).")
_declare("object_spill_failure_rate", float, 0.0,
         "Deterministic fraction of spill writes that fail (storage-layer "
         "FlakyStorage; spilling retries on the next scan).")
_declare("object_spill_slow_ms", float, 0.0,
         "Injected latency per spill-storage operation in milliseconds.")
_declare("local_fs_capacity_threshold", float, 0.95,
         "Disk-usage fraction above which spill/fallback writes fail "
         "gracefully instead of filling the disk (reference "
         "local_fs_capacity_threshold, file_system_monitor.h).")
_declare("fs_monitor_test_usage_path", str, "",
         "Fault-injection seam: path of a file holding a float disk-usage "
         "fraction the filesystem monitor reads instead of statvfs.")
_declare("runtime_env_cache_dir", str, "",
         "Directory caching per-requirement-set pip venvs; empty means "
         "ray_tpu_torch_runtime_envs_<uid> under the temporary directory "
         "(reference URI cache, uri_cache.py).")
_declare("runtime_env_pip_find_links", str, "",
         "Local wheelhouse for pip runtime envs: installs run with "
         "--no-index --find-links here (zero-egress seam; unset uses the "
         "normal package index).")
_declare("object_transfer_chunk_bytes", int, 8 * 1024 * 1024,
         "Inter-node object pushes move in chunks of this size (bounds "
         "per-message memory; cf. reference object_manager chunked Push).")
_declare("scheduler_spill_threshold", float, 0.5,
         "Hybrid scheduling: local/packing preference holds until a node's "
         "critical-resource utilization crosses this fraction (cf. reference "
         "scheduler_spread_threshold, ray_config_def.h).")
_declare("worker_pool_max_idle", int, 8,
         "Max idle workers kept alive per node for lease reuse.")
_declare("worker_start_timeout_s", float, 30.0, "Worker process start timeout.")
_declare("worker_prefork", bool, True,
         "Fork python workers from a warm zygote process (one heavy "
         "interpreter+torch import per raylet instead of per worker). "
         "Venv-interpreter and cpp workers always exec.")
_declare("worker_lease_timeout_s", float, 30.0, "Worker lease RPC timeout.")
_declare("task_retry_delay_ms", int, 0,
         "Delay before resubmitting a task whose worker died (crash-loop "
         "backoff); 0 (default) resubmits immediately.")
_declare("max_direct_call_args_bytes", int, 100 * 1024,
         "Args bigger than this are put into the object store before submit.")
_declare("heartbeat_period_ms", int, 250,
         "Node daemon -> GCS resource/liveness report period.")
_declare("health_check_failure_threshold", int, 8,
         "Missed heartbeats before the GCS marks a node dead.")
_declare("rpc_fuzz_ms", float, 0.0,
         "Schedule fuzzing: jitter every RPC dispatch by up to this many "
         "milliseconds (uniform).  Race tooling — perturbs message "
         "interleavings the way TSAN-style schedule stressing does for "
         "threads; see tests/test_sched_fuzz.py.  0 disables.")
_declare("rpc_dispatch_threads", int, 256,
         "Size of the process-wide RPC dispatch pool (replaces thread-"
         "per-request).  Handlers that block (task pushes waiting on the "
         "executor FIFO, buffered actor seqs, parked lease grants) each "
         "hold one pool thread; the cap bounds runaway thread growth "
         "while staying far above any realistic in-flight handler "
         "count.  Values far below the default risk starving blocking "
         "handlers that wait on other pooled RPCs.")
_declare("rpc_inline_return_max_bytes", int, -1,
         "Task/actor returns at most this size travel inline in the "
         "push_tasks/actor_task reply instead of through the shared-"
         "memory store + location round trip.  -1 (default) follows "
         "inline_object_max_bytes.")
_declare("generator_backpressure_num_objects", int, -1,
         "num_returns=\"streaming\" backpressure: a generator task may "
         "have at most this many reported-but-unconsumed items in "
         "flight; past it the producing worker pauses until the "
         "consumer's next() acks consumption (the owner withholds item-"
         "report replies).  <= 0 disables (unbounded stream).  Stamped "
         "into each spec at submit time, so the OWNER's config governs "
         "the stream it consumes.")
_declare("task_submit_batch_max", int, 8,
         "Max task specs coalesced into one push_tasks frame per leased "
         "worker.  Specs carrying ObjectRef args always travel alone "
         "(their worker-side dependency resolution must observe earlier "
         "per-task acks).")
_declare("lease_keepalive_ms", int, 200,
         "How long a leased worker is held after its scheduling key's "
         "queue drains before the lease is returned to the raylet.  "
         "Back-to-back synchronous submissions reuse the warm lease and "
         "connection instead of paying lease_worker + connect + "
         "return_worker per task.  0 restores return-on-idle.")
_declare("timeout_scale", float, 1.0,
         "Multiplier applied to liveness/startup timeouts at resolution "
         "time (the _SCALED flags below).  Loaded hosts — CI sharing one "
         "core with the cluster under test — starve heartbeat threads "
         "for seconds at a time; scaling the patience beats tuning each "
         "timeout per box.  Set RAY_TPU_TORCH_TIMEOUT_SCALE=4 in test envs.")
_declare("gcs_rpc_timeout_s", float, 30.0, "Client->GCS RPC timeout.")
_declare("gcs_snapshot_interval_s", float, 0.2,
         "Period of the GCS full-snapshot compaction tick (the WAL makes "
         "each mutation durable immediately; the snapshot only bounds "
         "replay length).")
_declare("gcs_wal_enabled", bool, True,
         "Per-mutation write-ahead journal next to the GCS snapshot "
         "(reference writes through to the Redis store client per "
         "mutation, store_client/redis_store_client.h:28).")
_declare("gcs_wal_fsync", bool, False,
         "fsync the GCS WAL after every record: survives host power loss "
         "at control-plane-latency cost; off, records survive process "
         "death but not kernel crash (matches Redis appendfsync "
         "everysec-style tradeoff).")
_declare("raylet_rpc_timeout_s", float, 30.0, "Client->node-daemon RPC timeout.")
_declare("cpp_worker_binary", str, "",
         "Path of the C++ worker binary spawned for language=cpp leases.  "
         "The port has no stock build yet: empty refuses cpp leases.  "
         "Point it at a binary (csrc/cpp_functions.h "
         "RAY_TPU_CPP_FUNCTION) to expose custom C++ tasks.")
_declare("actor_creation_timeout_s", float, 60.0, "Actor __init__ readiness timeout.")
_declare("memory_monitor_refresh_ms", int, 250,
         "Period of the per-node host-memory monitor; 0 disables it.")
_declare("memory_usage_threshold", float, 0.95,
         "Host-memory fraction above which the worker-killing policy engages.")
_declare("memory_monitor_test_usage_path", str, "",
         "Fault-injection seam: path of a file holding a float usage "
         "fraction the memory monitor reads instead of kernel counters.")
_declare("task_oom_retries", int, 15,
         "Separate retry budget for tasks whose worker was OOM-killed "
         "(reference task_oom_retries, ray_config_def.h:104-111); regular "
         "max_retries is not consumed by OOM kills.")
_declare("fetch_fail_timeout_s", float, 60.0,
         "Grace window for transient fetch failures (unreachable raylet on "
         "an alive node) before an owned object is declared lost and lineage "
         "reconstruction kicks in (cf. reference "
         "fetch_fail_timeout_milliseconds).")
_declare("lineage_max_bytes", int, 64 * 1024**2,
         "Cap on pinned lineage (task specs kept for object reconstruction).")
_declare("free_objects_period_ms", int, 100,
         "Batching period for releasing store objects whose refcount hit zero.")
_declare("pull_memory_cap_bytes", int, 512 * 1024**2,
         "Admission cap on the total bytes of concurrently in-flight remote "
         "object pulls per process (reference PullManager's bounded pull "
         "quota, pull_manager.h:52); pulls beyond it queue FIFO.")
_declare("object_pull_window", int, 8,
         "Pipelined pull depth: chunk requests kept in flight per source "
         "(a striped pull keeps up to window * nsources in flight).  1 "
         "restores one-chunk-per-RTT serial pulls (the A/B baseline in "
         "benchmarks/object_transfer_perf.py); docs/object_transfer.md.")
_declare("object_pull_max_sources", int, 4,
         "Max nodes a single pull stripes chunk ranges across when the "
         "location set holds multiple live copies.  1 disables striping.")
_declare("locality_aware_scheduling", bool, True,
         "Weigh argument bytes already local when placing leases: a "
         "lease request carrying argument locations may be redirected to "
         "the feasible node holding the most argument bytes (reference "
         "locality-aware lease policy, locality_data_provider).")
_declare("locality_min_arg_bytes", int, 1024 * 1024,
         "Arguments at least this size participate in locality-aware "
         "placement and raylet-side prefetch; below it transfer cost is "
         "noise next to lease latency.")
_declare("object_prefetch_enabled", bool, True,
         "Raylet-side argument prefetch: a granted lease request's "
         "missing large arguments start pulling into local shm "
         "concurrently with worker lease/startup, so transfer overlaps "
         "scheduling instead of serializing after it.")
_declare("prefetch_pin_ttl_s", float, 60.0,
         "Safety-net lifetime of raylet prefetch pins: pins not released "
         "by their lease's return (e.g. the lease request timed out or "
         "the task was cancelled before dispatch) drop after this long.")
_declare("drain_grace_s", float, 30.0,
         "Default grace window of a drain_node request (spot/preemption "
         "notice): the draining raylet stops granting leases, waits this "
         "long for in-flight task leases to finish, then evacuates "
         "primary object copies to surviving nodes "
         "(docs/fault_tolerance.md).")
_declare("evacuation_enabled", bool, True,
         "Drain-time object evacuation: a draining raylet ships its "
         "sealed store + spilled objects to surviving nodes over the "
         "transfer plane so a graceful preemption loses zero objects.")
_declare("evac_pin_ttl_s", float, 300.0,
         "Lifetime of the receiving raylet's pin on an evacuated copy: "
         "long enough for owners to learn the new location (first fetch "
         "after the source dies), bounded so orphaned copies whose "
         "owners never come back stop occupying shm.")
_declare("gcs_max_evacuated_objects", int, 8192,
         "Cap on the GCS evacuated-object location table (oldest "
         "entries rotate out; an expired hint degrades to lineage "
         "reconstruction, never to a wrong answer).")
_declare("gcs_evac_ttl_s", float, 600.0,
         "Expiry of evacuated-object location hints: owners that "
         "haven't consulted a hint within this window fall back to "
         "reconstruction.")
_declare("object_reconstruct_max_attempts", int, 10,
         "Per-object budget on lineage reconstruction resubmits, on top "
         "of the task's own max_retries: a flapping node repeatedly "
         "losing the same object must converge to ObjectLostError "
         "instead of resubmitting forever.")
_declare("log_to_driver", bool, True, "Forward worker stdout/stderr to the driver.")
_declare("task_events_buffer_size", int, 10000,
         "Ring-buffer capacity of per-worker task state-transition events.")
_declare("task_events_flush_interval_ms", int, 500,
         "Period at which workers flush task events to the GCS task table.")
_declare("gcs_max_task_events", int, 100000,
         "Max per-task records the GCS task table keeps before GC.")
_declare("telemetry_enabled", bool, True,
         "Always-on runtime telemetry (_private/runtime_metrics.py): "
         "hot-path counters/histograms in every daemon and worker plus "
         "the per-process flusher publishing them to the GCS KV "
         "metrics/ namespace.  Also overridable as RAY_TPU_TORCH_TELEMETRY=0 "
         "(the bench kill-switch); disabling swaps instruments for "
         "no-op stubs at binding time, so it must be off before the "
         "process imports the instrumented modules.")
_declare("telemetry_flush_interval_ms", int, 2000,
         "Period of the runtime-metrics flusher pushing per-process "
         "snapshots to the GCS KV (dashboard /metrics, list_metrics); "
         "only metrics that changed since the last flush are re-sent.")
_declare("events_enabled", bool, True,
         "Cluster event plane (_private/cluster_events.py): typed "
         "lifecycle events from every daemon/worker into the GCS event "
         "table, plus the per-process flight-recorder ring feeding "
         "crash dossiers.  Also overridable as RAY_TPU_TORCH_EVENTS=0 (the "
         "bench kill switch, mirroring RAY_TPU_TORCH_TELEMETRY); disabling "
         "drops emits after one global read and never starts the "
         "flusher.")
_declare("event_ring_size", int, 512,
         "Per-process flight-recorder ring capacity: the last N events "
         "(lifecycle + ring-only task breadcrumbs) kept in memory and "
         "dumped atomically to the per-worker flight file each flush, "
         "so a crash dossier can show what the process was doing.")
_declare("events_flush_interval_ms", int, 500,
         "Period of the cluster-events flusher batching this process's "
         "events to the GCS table and rewriting its flight file.")
_declare("gcs_max_cluster_events", int, 20000,
         "Max events the GCS cluster event table retains (sharded "
         "rotation, oldest dropped first).")
_declare("gcs_events_max_bytes", int, 4 * 1024 * 1024,
         "Byte budget of the GCS cluster event table (JSON-serialized "
         "record sizes); the hard retention gate — oldest events are "
         "evicted across shards until the table fits.")
_declare("gcs_max_dossiers", int, 128,
         "Max crash dossiers the GCS retains (FIFO eviction).")
_declare("dossier_log_tail_bytes", int, 16384,
         "Bytes of worker stdout/stderr tail harvested into a crash "
         "dossier.")
_declare("node_unhealthy_mem_frac", float, 0.92,
         "Host-memory fraction in a raylet health snapshot above which "
         "the GCS emits a NODE_UNHEALTHY event for the node.")
_declare("node_unhealthy_store_frac", float, 0.95,
         "Object-store occupancy fraction above which a node is "
         "reported unhealthy.")
_declare("node_unhealthy_lag_ms", float, 2000.0,
         "Raylet heartbeat-loop event-loop lag above which a node is "
         "reported unhealthy (a starved daemon thread: the node may "
         "miss liveness deadlines soon).")
_declare("daemon_connect_retry_s", float, 10.0,
         "Bounded retry window for a freshly spawned daemon's FIRST "
         "connection to its GCS (backoff 50ms doubling to 1s; daemon "
         "call sites only — raylet/dashboard/monitor pass "
         "connect_retry=True, interactive clients stay fail-fast).  "
         "Under heavy box load the GCS subprocess can publish its "
         "address file before its accept loop keeps up with the "
         "connection burst; one refused connect must not kill the "
         "raylet (the load-dependent startup-race flake).  Scaled by "
         "timeout_scale.")
_declare("step_stats_enabled", bool, True,
         "Training performance plane (_private/step_stats.py): per-step "
         "phase clocks, the cross-rank GCS step table + straggler "
         "detection, and the goodput ledger.  Also overridable as "
         "RAY_TPU_TORCH_STEP_STATS=0 (the bench kill switch, mirroring "
         "RAY_TPU_TORCH_TELEMETRY / RAY_TPU_TORCH_EVENTS); disabling hands train "
         "loops a shared no-op clock.")
_declare("step_stats_flush_interval_ms", int, 500,
         "Period of the per-rank step-stats flusher batching step "
         "reports to the GCS step table (never an RPC on the step "
         "path).")
_declare("step_stats_timeline_steps", int, 256,
         "Per-run cap on STEP timeline slices recorded into the GCS "
         "task table (the STREAM_ITEM cap discipline: first N steps "
         "per run per rank).")
_declare("gcs_step_stats_max_steps", int, 512,
         "Per-run step retention in the GCS step table (oldest steps "
         "rotate out first).")
_declare("gcs_max_step_runs", int, 16,
         "Max training runs the GCS step table retains "
         "(oldest-touched evicted first).")
_declare("straggler_mad_k", float, 4.0,
         "Straggler detection: a rank whose step time exceeds the "
         "cross-rank median + k * MAD (by at least straggler_min_ms) "
         "edge-triggers a TRAIN_STRAGGLER event.")
_declare("straggler_min_ms", float, 20.0,
         "Absolute floor on the straggler overshoot: ms-scale steps "
         "jitter by scheduler noise, and median + k*MAD alone would "
         "fire on microsecond skew in a tight gang.")
_declare("tracing_enabled", bool, True,
         "Distributed request tracing plane (util/tracing/"
         "tracing_helper.py): trace roots at every serve ingress, "
         "sampled roots at task/actor submission, cross-process span "
         "propagation and the GCS span table.  Also overridable as "
         "RAY_TPU_TORCH_TRACING=0 (the bench kill switch, mirroring "
         "RAY_TPU_TORCH_TELEMETRY / RAY_TPU_TORCH_EVENTS); disabling makes every "
         "root/span call a no-op after one cached flag read.")
_declare("trace_sample_rate", float, 0.1,
         "Fraction of traces whose spans are recorded, decided by a "
         "deterministic hash of the trace id (every process reaches "
         "the same verdict for the same id with no coordination).  "
         "Serve ingresses always open a root context for SLO "
         "accounting; this rate gates span recording and task/actor "
         "submission roots.  1.0 records everything, 0 disables "
         "recording while keeping SLO counters.")
_declare("trace_flush_interval_ms", int, 500,
         "Period of the per-process span-buffer flusher batching "
         "finished spans to the GCS span table (never an RPC on the "
         "request path).")
_declare("trace_buffer_size", int, 2048,
         "Per-process bound on buffered-but-unflushed spans; past it "
         "new spans are dropped (counted) rather than growing memory "
         "behind a dead GCS.")
_declare("trace_stream_span_items", int, 16,
         "Per-stream cap on per-yield item marker spans recorded into "
         "a sampled trace (the STREAM_ITEM cap discipline, scaled down "
         "— tracing wants the pacing shape, not every token).")
_declare("gcs_max_traces", int, 512,
         "Max traces the GCS span table retains (sharded rotation, "
         "oldest dropped first).")
_declare("gcs_traces_max_bytes", int, 8 * 1024 * 1024,
         "Byte budget of the GCS span table (JSON-serialized span "
         "sizes); the hard retention gate alongside the trace count.")
_declare("gcs_trace_max_spans", int, 256,
         "Per-trace span cap in the GCS span table (first and last "
         "halves survive, like the task table's per-record event cap).")
_declare("serve_slo_ttft_ms", float, 2000.0,
         "Serve SLO target: time-to-first-token budget per request "
         "(ms).  Completed requests are classified against it into "
         "ray_tpu_serve_slo_good/violation{pool,slo=ttft} counters "
         "with exemplar trace ids on the slowest requests; <= 0 "
         "disables the dimension.")
_declare("debug_locks", bool, False,
         "Lock-order sanitizer (analysis/lock_sanitizer.py): swap "
         "threading.Lock/RLock created by instrumented runtime modules "
         "for wrappers that record the per-thread acquisition-order "
         "graph and raise at the FIRST A->B/B->A inversion.  Debug "
         "tool (set RAY_TPU_TORCH_DEBUG_LOCKS=1); the chaos and compiled-DAG "
         "suites run under it.")
_declare("debug_channels", bool, False,
         "Shm-ring protocol checker (analysis/channel_check.py): "
         "assert single-writer / seq-word-last / cumulative-ack "
         "discipline on every experimental/channel.py publish and "
         "ack.  Debug tool (set RAY_TPU_TORCH_DEBUG_CHANNELS=1); enabled in "
         "the chaos and compiled-DAG suites.")
_declare("serve_slo_tpot_ms", float, 200.0,
         "Serve SLO target: inter-token latency budget (ms/token past "
         "the first) for streaming requests; <= 0 disables the "
         "dimension.")
_declare("metrics_history_enabled", bool, True,
         "Metrics-history plane kill switch (RAY_TPU_TORCH_METRICS_HISTORY "
         "env wins): the GCS folds every metrics KV write into the "
         "bounded multi-resolution history table and runs the "
         "recovery-SLO auditor over the event stream.  Off, the GCS "
         "keeps only latest-snapshot metrics (pre-history behavior).")
_declare("metrics_history_resolutions", str, "1:120,10:180,60:120",
         "History retention geometry: comma-separated res_s:slots "
         "rings per series.  The default keeps 2 min at 1 s, 30 min "
         "at 10 s and 2 h at 60 s; within a bucket the newest flusher "
         "snapshot wins (snapshots are cumulative, so last-write IS "
         "the downsample).")
_declare("gcs_metrics_history_max_series", int, 512,
         "Max metric series (distinct metrics/{name}/{ident} keys) the "
         "history table retains; the longest-idle series is evicted "
         "first, like the metrics KV staleness sweep.")
_declare("gcs_metrics_history_max_bytes", int, 8 * 1024 * 1024,
         "Byte budget of the metrics history table (raw payload bytes "
         "across all rings); the hard retention gate alongside the "
         "series cap — oldest point dropped first.")
_declare("gcs_max_recovery_episodes", int, 256,
         "Max closed recovery episodes the auditor retains (drain / "
         "failover / heal); per-kind totals and violation counters "
         "survive rotation like the event table's counts_by_type.")
_declare("gcs_recovery_max_bytes", int, 512 * 1024,
         "Byte budget of the recovery-episode table (JSON-serialized "
         "episode sizes), alongside the episode count cap.")
_declare("recovery_slo_drain_s", float, 0.0,
         "Drain SLO: budget for NODE_PREEMPTING -> NODE_DRAINED per "
         "episode (s).  <= 0 uses each episode's advertised grace "
         "window — the budget the raylet promised to finish inside.")
_declare("recovery_slo_failover_s", float, 120.0,
         "Failover SLO: budget from the first failure event "
         "(NODE_PREEMPTING/NODE_DEAD) to TRAIN_GANG_RECOVERY (s); "
         "<= 0 disables classification.")
_declare("recovery_slo_heal_s", float, 90.0,
         "Pool-heal SLO: budget from REPLICA_RETIRED to the next "
         "AUTOSCALE target change for that deployment (s); <= 0 "
         "disables classification.")

# --------------------------------------------------------------------------- #
# TPU / device model                                                          #
# --------------------------------------------------------------------------- #
_declare("gpus_per_host", int, 0,
         "Override the detected GPU count for the node resource report "
         "(else CUDA_VISIBLE_DEVICES, else `nvidia-smi --list-gpus`).")
_declare("tpu_slice_name", str, "",
         "Pod-slice identifier this host belongs to (e.g. 'v5e-16/abc'). Hosts "
         "of one slice form an atomic scheduling bundle.")
_declare("mesh_default_axes", dict, {"data": -1},
         "Default mesh axis layout used by JaxTrainer when none is given.")

# --------------------------------------------------------------------------- #
# Collectives                                                                 #
# --------------------------------------------------------------------------- #
_declare("collective_rendezvous_timeout_s", float, 60.0,
         "Timeout for host-collective group rendezvous via the GCS KV store.")
_declare("collective_op_timeout_s", float, 120.0, "Host collective op timeout.")
_declare("collective_chunk_bytes", int, 8 * 1024 * 1024,
         "Ring-collective segment size: tensors are segmented into pieces "
         "of this size that pipeline through the ring (step k+1's send "
         "overlaps step k's recv+reduce) and bound per-message memory; "
         "also the shm-channel slot payload size, so each same-node link "
         "maps nslots * this many bytes of the store segment "
         "(docs/collective.md).")
_declare("collective_inflight_segments", int, 4,
         "Pipelined take-request depth per collective link: how many "
         "segment requests a rank keeps in flight to its ring "
         "predecessor (each needs one staging buffer of "
         "collective_chunk_bytes during reduce phases).")
_declare("collective_small_max_bytes", int, 32 * 1024,
         "Tensors at most this size use the latency-optimal recursive-"
         "doubling allreduce (log2(N) rounds of whole-tensor exchanges) "
         "instead of the bandwidth-optimal segmented ring.")
_declare("collective_shm_enabled", bool, True,
         "Exchange collective segments between same-node ranks over "
         "shared-memory ring channels (experimental/channel.py) instead "
         "of TCP loopback.")
_declare("collective_shm_slot_bytes", int, 1024 * 1024,
         "Slot payload size of same-node collective shm ring channels; "
         "groups with colocated ranks segment by "
         "min(collective_chunk_bytes, this), so a link costs "
         "~slots * this of store segment instead of slots * chunk "
         "(8 MiB chunks would charge ~50 MB per link).")
_declare("collective_shm_slots", int, 6,
         "Ring-slot count of each same-node collective shm channel "
         "(per-directed-pair buffering; >= inflight window + 2 keeps "
         "the pipelined ring from blocking on ring credit).")
_declare("collective_flat_shm", bool, True,
         "Single-node groups allreduce through the flat shared-memory "
         "arena (each rank publishes its input once into the node store "
         "and reduces its own chunk from all peers' mapped views) "
         "instead of the segmented ring, when ~2.5x the group's tensor "
         "footprint fits the store (docs/collective.md).")
_declare("collective_hierarchical", bool, True,
         "Two-level collectives when ranks are colocated: intra-node "
         "reduce over shm to a per-node leader, inter-node ring among "
         "leaders, intra-node broadcast of the result.")
_declare("collective_quant_block", int, 256,
         "Elements per fp32 scale block of the int8 wire codec "
         "(quantize='int8'): wire bytes per fp32 segment are "
         "n + 4*ceil(n/block), so larger blocks compress harder at the "
         "cost of coarser per-block dynamic range (docs/collective.md).")
_declare("collective_quant_min_bytes", int, 64 * 1024,
         "Tensors at most this size skip wire quantization even when "
         "quantize= is requested: small ops are latency-bound, and the "
         "encode/decode passes cost more than the bytes they save.")
_declare("collective_bucket_bytes", int, 32 * 1024 * 1024,
         "sync_gradients splits each per-dtype gradient bucket into "
         "sub-buckets of at most this size, each its own allreduce: "
         "with async_op=True early buckets reduce while the caller is "
         "still computing later gradients (backward overlap), and even "
         "the barrier path pipelines bucket k+1's encode behind bucket "
         "k's ring (docs/collective.md).")
_declare("collective_topology", bool, True,
         "Slice-aware collective scheduling: ranks carrying a "
         "tpu_slice_name label are grouped by slice, reduced "
         "intra-slice first (ICI shard_map collectives when a mesh is "
         "registered, host links otherwise), and only slice leaders "
         "ring over DCN (docs/collective.md).")
_declare("collective_sim_dcn_mbps", float, 0.0,
         "Debug/benchmark: pace every published collective segment to "
         "this bandwidth (MiB/s of ENCODED bytes; 0 = off).  Models a "
         "bytes-limited DCN link on boxes whose loopback wire is "
         "really CPU, so the quantized-allreduce A/B measures the "
         "regime the codec targets (the object_spill_slow_ms "
         "injection precedent; benchmarks/collective_perf.py --quant).")
_declare("collective_bcast_store_min_bytes", int, 4 * 1024 * 1024,
         "broadcast() payloads at least this size move over the object-"
         "transfer data plane instead of the ring — when the group spans "
         "more than one node: the source puts the tensor once and every "
         "rank pulls it multi-source-striped, each completed rank "
         "becoming an additional source (docs/object_transfer.md).  "
         "Same-node-only groups always use the shm ring chain.")

# --------------------------------------------------------------------------- #
# Libraries                                                                   #
# --------------------------------------------------------------------------- #
_declare("sharded_ckpt_keep", int, 2,
         "Sharded-checkpoint fallback chain depth "
         "(ray_tpu_torch/train/sharded/executor.py): each gang checkpoint "
         "embeds pointers to this many predecessors, so a restore whose "
         "newest shards were lost with an ungracefully killed node "
         "walks back one interval per lost checkpoint instead of "
         "failing the run (docs/train_sharded.md).")
_declare("sharded_ckpt_pull_timeout_s", float, 30.0,
         "Per-shard pull timeout on sharded-checkpoint restore: how "
         "long a fresh gang rank waits for its parameter shard to "
         "stripe in from the object-transfer plane before the restore "
         "falls back to the previous checkpoint in the chain.")
_declare("serve_http_host", str, "127.0.0.1",
         "Default serve proxy bind host (HTTPOptions overrides per app).")
_declare("serve_http_port", int, 8000,
         "Default serve proxy bind port (HTTPOptions overrides per app).")
_declare("serve_controller_loop_ms", int, 250,
         "Serve controller reconcile period (replica set convergence "
         "and autoscaling cadence).")
_declare("serve_handoff_quantize", bool, False,
         "Encode cross-host PrefillHandoff KV with the block-scaled "
         "int8 wire codec (util/collective/quant.py) before "
         "ray_tpu_torch.put: ~3.9x fewer handoff bytes on the wire at the "
         "cost of one encode/decode pass per handoff.  Greedy decode "
         "must stay token-exact (the disagg smoke test gates it).")
_declare("serve_prefix_cache_pages", int, 0,
         "KV pages each paged LLM engine may retain as a shared prompt-"
         "prefix cache after prefill (docs/serve_frontdoor.md).  A new "
         "prompt whose page-aligned prefix digest-chain matches a "
         "retained run skips re-prefilling those pages (suffix-only "
         "prefill over borrowed read-only pages).  0 disables "
         "retention; refcounted LRU eviction keeps the budget.")
_declare("serve_prefix_index_max", int, 4096,
         "Router-side prefix index bound (frontdoor/prefix.py): max "
         "digest -> replica entries a DeploymentHandle keeps from the "
         "controller's load-publish path; LRU past it.")
_declare("serve_rerole_enabled", bool, False,
         "SLO-driven elastic re-roling: the serve controller watches "
         "per-pool ttft/tpot SLO violation deltas (trace plane) for "
         "<base>-prefill/<base>-decode pairs and re-roles one replica "
         "from the healthy pool into the burning one (drain -> "
         "re-role -> rejoin).  Off by default; request_rerole() still "
         "works for forced episodes.")
_declare("serve_rerole_interval_s", float, 30.0,
         "How often the controller evaluates the re-roling policy "
         "(seconds between trace_stats polls).")
_declare("serve_rerole_cooldown_s", float, 120.0,
         "Minimum time between re-roling episodes per deployment pair: "
         "the pool must re-stabilize (and the SLO counters re-baseline) "
         "before the policy may move another replica.")
_declare("serve_rerole_min_violations", int, 20,
         "New SLO violations (since the last poll, on the dominant "
         "dimension) required before a re-role triggers — below it the "
         "signal is noise, not a burning pool.")
_declare("recovery_slo_rerole_s", float, 60.0,
         "Re-role SLO: budget from SERVE_REROLE to SERVE_REROLE_DONE "
         "(donor drained + receiver pool healthy again, s); <= 0 "
         "disables classification.")

# --------------------------------------------------------------------------- #
# RL podracer executor (docs/rl_podracer.md)                                  #
# --------------------------------------------------------------------------- #
_declare("podracer_backpressure_fragments", int, 2,
         "Per-rollout-actor staleness bound for the podracer streaming "
         "ingest: at most this many yielded-but-unconsumed fragments may "
         "be in flight per actor (stamped into "
         "generator_backpressure_num_objects at stream submit time). "
         "<= 0 leaves the stream unbounded — free-running actors whose "
         "fragments can be arbitrarily stale.")
_declare("podracer_prefetch_depth", int, 4,
         "Depth of the learner-side host prefetch queue that overlaps "
         "fragment download/deserialization with the compiled learner "
         "step.  A full queue blocks the per-actor ingest threads, which "
         "stops acking the streams and lets generator backpressure pause "
         "the producers — queue depth + per-actor window together bound "
         "end-to-end staleness.")
_declare("podracer_weight_quantize", bool, False,
         "Publish podracer weight versions int8 block-quantized over the "
         "wire (the PR 16 Int8Codec; block size collective_quant_block). "
         "~4x fewer broadcast bytes per sync at a bounded blockmax/254 "
         "round-trip error; actors dequantize on pull.")
_declare("podracer_weight_keep_versions", int, 2,
         "Published weight versions the learner keeps alive (object-store "
         "refs) beyond the newest.  Older refs are dropped so the store "
         "reclaims them; actors that poll past a dropped version jump "
         "straight to the newest (the version-skip rule).")
_declare("podracer_sync_every_steps", int, 1,
         "Learner steps between weight-version publishes.  1 publishes "
         "after every optimizer step (lowest staleness, most broadcast "
         "traffic); larger values amortize the put() + KV bump.")
_declare("recovery_slo_rl_actor_s", float, 60.0,
         "RL actor-replacement SLO: budget from RL_ACTOR_LOST to the "
         "replacement's RL_ACTOR_JOINED for that fleet slot (s); <= 0 "
         "disables classification.")


class Config:
    """Process-wide resolved flag values.

    Resolution order (highest wins):
      1. explicit ``set()`` calls / ``init(system_config=...)``
      2. ``RAY_TPU_TORCH_<NAME>`` environment variables
      3. the JSON blob in ``RAY_TPU_TORCH_SYSTEM_CONFIG`` (how daemons inherit the
         driver's overrides)
      4. declared defaults
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._overrides: Dict[str, Any] = {}
        # bumped on every override mutation: hot paths cache resolved flag
        # values keyed on this (rpc._maybe_fuzz) instead of re-resolving
        # through the lock + env lookup per call
        self._gen = 0
        blob = os.environ.get(_SYSTEM_CONFIG_ENV)
        if blob:
            try:
                for k, v in json.loads(blob).items():
                    if k in _FLAG_TABLE:
                        self._overrides[k] = v
            except (ValueError, TypeError):
                pass

    def __getattr__(self, name: str) -> Any:
        flag = _FLAG_TABLE.get(name)
        if flag is None:
            raise AttributeError(f"unknown ray_tpu_torch config flag: {name!r}")
        value = None
        found = False
        with self._lock:
            if name in self._overrides:
                value = self._overrides[name]
                found = True
        if not found:
            raw = os.environ.get(_ENV_PREFIX + name.upper())
            if raw is not None:
                try:
                    value = flag.parse(raw)
                    found = True
                except (ValueError, TypeError):
                    pass
        if not found:
            value = flag.default
        if name in _SCALED_FLAGS:
            scale = self.timeout_scale
            if scale != 1.0:
                value = flag.type(value * scale)
        return copy.deepcopy(value) if isinstance(value, (dict, list)) \
            else value

    def generation(self) -> int:
        """Monotonic override-mutation counter (see __init__)."""
        return self._gen

    def set(self, name: str, value: Any) -> None:
        if name not in _FLAG_TABLE:
            raise KeyError(f"unknown ray_tpu_torch config flag: {name!r}")
        with self._lock:
            self._overrides[name] = value
            self._gen += 1

    def update(self, overrides: Dict[str, Any]) -> None:
        for k, v in (overrides or {}).items():
            self.set(k, v)

    def copy_overrides(self) -> Dict[str, Any]:
        with self._lock:
            return dict(self._overrides)

    def set_overrides(self, overrides: Dict[str, Any]) -> None:
        with self._lock:
            self._overrides = dict(overrides)
            self._gen += 1

    def overrides_env_blob(self) -> str:
        """Serialized overrides to pass to child processes via env."""
        with self._lock:
            return json.dumps(self._overrides)

    def snapshot(self) -> Dict[str, Any]:
        return {name: getattr(self, name) for name in _FLAG_TABLE}


# liveness/startup patience flags timeout_scale multiplies (NOT data-
# plane semantics like spill thresholds or batch waits)
_SCALED_FLAGS = frozenset({
    "health_check_failure_threshold",
    "daemon_connect_retry_s",
    "worker_start_timeout_s",
    "worker_lease_timeout_s",
    "actor_creation_timeout_s",
    "gcs_rpc_timeout_s",
    "raylet_rpc_timeout_s",
    "fetch_fail_timeout_s",
    "collective_rendezvous_timeout_s",
    "collective_op_timeout_s",
})

CONFIG = Config()


def flag_docs() -> Dict[str, str]:
    return {f.name: f.doc for f in _FLAG_TABLE.values()}
