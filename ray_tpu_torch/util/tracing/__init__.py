"""Distributed request tracing plane (docs/observability.md)."""

from ray_tpu_torch.util.tracing.tracing_helper import (  # noqa: F401
    span, get_trace_context, propagate_trace_context, open_span,
    serve_ingress_root, finish_request, sampled, enabled)

__all__ = ["span", "get_trace_context", "propagate_trace_context",
           "open_span", "serve_ingress_root", "finish_request",
           "sampled", "enabled"]
