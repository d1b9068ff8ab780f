"""Serving of the port: the continuous-batching LLM engine (dense and
paged modes, prefix cache, prefill handoffs)."""
