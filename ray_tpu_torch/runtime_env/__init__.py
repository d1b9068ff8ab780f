"""Runtime environments (SURVEY.md §2.3 runtime_env row).

Analog of /root/reference/python/ray/runtime_env/ (RuntimeEnv :515) +
_private/runtime_env/ (packaging, uri_cache, plugins).
"""

from ray_tpu_torch.runtime_env.runtime_env import (  # noqa: F401
    RuntimeEnv, prepare_runtime_env, setup_runtime_env)

__all__ = ["RuntimeEnv", "prepare_runtime_env", "setup_runtime_env"]
