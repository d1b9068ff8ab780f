"""Serving of the port: the paged continuous-batching LLM engine."""
