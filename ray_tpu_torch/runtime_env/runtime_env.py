"""RuntimeEnv: per-job/task/actor execution environment.

Analog of /root/reference/python/ray/runtime_env/runtime_env.py (RuntimeEnv
class) + _private/runtime_env/ plugins. TPU-native scope: env_vars,
working_dir, and py_modules ship code/config through the GCS KV; ``pip``
gives CPU-side workers per-env dependency isolation via cached local
venvs (runtime_env/pip.py — TPU-pod images should still bake heavy deps);
``conda`` environment.yml specs fold into the same venv path (their
dependencies become pip requirements; no conda binary in hermetic
images, so named envs are rejected).
"""

from __future__ import annotations

import hashlib
import json
import os
import sys
from typing import Any, Dict, List, Optional

from ray_tpu_torch.runtime_env import packaging

_ALLOWED = {"env_vars", "working_dir", "py_modules", "pip", "conda",
            "container", "config"}


class RuntimeEnv(dict):
    """Validated dict describing a worker environment.

    >>> RuntimeEnv(env_vars={"TOKENIZERS_PARALLELISM": "false"},
    ...            working_dir="./src")
    """

    def __init__(self, *, env_vars: Optional[Dict[str, str]] = None,
                 working_dir: Optional[str] = None,
                 py_modules: Optional[List[str]] = None,
                 pip: Any = None, conda: Any = None,
                 container: Optional[Dict[str, Any]] = None,
                 config: Optional[Dict[str, Any]] = None):
        super().__init__()
        if env_vars:
            if not all(isinstance(k, str) and isinstance(v, str)
                       for k, v in env_vars.items()):
                raise TypeError("env_vars must be Dict[str, str]")
            self["env_vars"] = dict(env_vars)
        if working_dir:
            if not os.path.exists(working_dir):
                raise ValueError(f"working_dir {working_dir!r} not found")
            self["working_dir"] = working_dir
        if py_modules:
            for m in py_modules:
                if not os.path.exists(m):
                    raise ValueError(f"py_module {m!r} not found")
            self["py_modules"] = list(py_modules)
        if pip:
            from ray_tpu_torch.runtime_env.pip import normalize_pip_field
            self["pip"] = normalize_pip_field(pip)
        if container:
            from ray_tpu_torch.runtime_env.container import validate
            self["container"] = validate(container)
        if conda:
            # conda specs fold into the same venv isolation path as pip:
            # the environment.yml's dependencies become requirements (the
            # image's interpreter replaces conda's python solver)
            from ray_tpu_torch.runtime_env.pip import normalize_conda_field
            merged = sorted(set(self.get("pip", []))
                            | set(normalize_conda_field(conda)))
            if merged:
                self["pip"] = merged
        if config:
            self["config"] = dict(config)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "RuntimeEnv":
        unknown = set(d) - _ALLOWED
        if unknown:
            raise ValueError(f"unknown runtime_env field(s): {sorted(unknown)}")
        return cls(**{k: v for k, v in d.items()})

    def to_dict(self) -> Dict[str, Any]:
        return dict(self)


def prepare_runtime_env(raw: Optional[Dict[str, Any]], gcs
                        ) -> Optional[Dict[str, Any]]:
    """Driver side: package+upload local paths; returns the wire descriptor
    sent with lease requests / actor specs (the reference's serialized
    RuntimeEnvInfo)."""
    if not raw:
        return None
    env = raw if isinstance(raw, RuntimeEnv) else RuntimeEnv.from_dict(raw)
    desc: Dict[str, Any] = {}
    if env.get("env_vars"):
        desc["env_vars"] = dict(env["env_vars"])
    if env.get("working_dir"):
        desc["working_dir"] = packaging.upload_package(
            gcs, env["working_dir"])
    if env.get("py_modules"):
        desc["py_modules"] = [packaging.upload_package(gcs, m)
                              for m in env["py_modules"]]
    if env.get("pip"):
        desc["pip"] = list(env["pip"])
    if env.get("container"):
        desc["container"] = dict(env["container"])
    if env.get("config"):
        desc["config"] = dict(env["config"])
    if not desc:
        return None
    desc["hash"] = hashlib.sha256(
        json.dumps(desc, sort_keys=True).encode()).hexdigest()[:16]
    return desc


def setup_runtime_env(desc: Dict[str, Any], gcs, session_dir: str) -> None:
    """Worker side: apply a descriptor before running any user code."""
    base = os.path.join(session_dir or ".", "runtime_env")
    for uri in desc.get("py_modules", []):
        path = packaging.ensure_local(gcs, uri, base)
        if path not in sys.path:
            sys.path.insert(0, path)
    if desc.get("working_dir"):
        path = packaging.ensure_local(gcs, desc["working_dir"], base)
        os.chdir(path)
        if path not in sys.path:
            sys.path.insert(0, path)
    for k, v in desc.get("env_vars", {}).items():
        os.environ[k] = v
