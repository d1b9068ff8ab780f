"""Cluster state introspection: list/summarize tasks, actors, objects, ...

Analog of Ray's python/ray/experimental/state/ (api.py,
state_manager.py) + dashboard/state_aggregator.py:132 (StateAPIManager).
"""

from ray_tpu_torch.experimental.state.api import (  # noqa: F401
    collect_debug_bundle, doctor_report, doctor_report_text,
    get_dossier, list_actors, list_cluster_events, list_dossiers,
    list_jobs, list_metrics, list_metrics_history, list_nodes,
    list_objects, list_placement_groups, list_recovery_episodes,
    list_step_stats, list_tasks, list_traces,
    list_workers, get_trace, memory_summary, metrics_history_stats,
    metrics_summary, recovery_stats,
    summarize_actors, summarize_objects, summarize_tasks, timeline,
    trace_stats, trace_timeline, trace_tree_text, training_summary,
    training_summary_text)

__all__ = [
    "list_tasks", "list_actors", "list_nodes", "list_jobs", "list_objects",
    "list_workers", "list_placement_groups", "list_metrics",
    "list_cluster_events", "get_dossier", "list_dossiers",
    "list_step_stats", "training_summary", "training_summary_text",
    "summarize_tasks", "summarize_actors", "summarize_objects",
    "memory_summary", "metrics_summary", "timeline",
    "list_traces", "get_trace", "trace_stats", "trace_timeline",
    "trace_tree_text",
    "list_metrics_history", "metrics_history_stats",
    "list_recovery_episodes", "recovery_stats",
    "doctor_report", "doctor_report_text", "collect_debug_bundle",
]
