"""HTTP-native serving front door (the port's copy of
ray_tpu/serve/frontdoor; docs/serve_frontdoor.md).

Planes, each importable on its own so lightweight processes pull only
what they use:

- ``prefix``: prompt-prefix digest chain + the router-side affinity
  index (no torch — runs in proxies, handles and the engine).
- ``sse``: server-sent-events framing and the async bridge from a
  token generator to the proxy's chunked HTTP response (no torch).
- re-roling lives in the serve controller (serve/controller.py).

Submodules are lazy: ``frontdoor.sse`` pulls tracing helpers the
engine-side ``prefix`` import must not pay for.
"""

from __future__ import annotations

_SUBMODULES = ("prefix", "sse")


def __getattr__(name):
    if name in _SUBMODULES:
        import importlib
        mod = importlib.import_module(f"{__name__}.{name}")
        globals()[name] = mod
        return mod
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(list(globals()) + list(_SUBMODULES))
