"""Container runtime_env: run workers inside a container image.

Analog of /root/reference/python/ray/_private/runtime_env/container.py
(ContainerManager.setup): the descriptor
``runtime_env={"container": {"image": ..., "run_options": [...],
"driver": "podman"}}`` turns a worker spawn command into
``podman run <mounts/namespaces> --entrypoint python <image> <args>``.
The container shares the host's network/pid/ipc namespaces and mounts
the session dir and the shm store segment, so the containerized worker
speaks to the raylet and maps the object store exactly like a host
worker — isolation covers the filesystem/interpreter, not the cluster
fabric (the reference's model).

This image ships no podman/docker, so end-to-end tests drive a
recording fake driver (tests/test_runtime_env.py); command construction
is pure and fully covered either way.  Containerized workers always
exec (a fork off the warm zygote cannot enter an image).
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Dict, List, Optional


class ContainerError(ValueError):
    pass


def validate(container: dict) -> dict:
    if not isinstance(container, dict) or not container.get("image"):
        raise ContainerError(
            'runtime_env["container"] needs an "image"; got '
            f"{container!r}")
    driver = container.get("driver", "podman")
    opts = container.get("run_options", [])
    if not isinstance(opts, (list, tuple)) or \
            not all(isinstance(o, str) for o in opts):
        raise ContainerError("container run_options must be a list of "
                             "strings")
    return {"image": container["image"], "driver": driver,
            "run_options": list(opts)}


def driver_path(container: dict) -> Optional[str]:
    """Resolved container runtime executable, or None if absent."""
    d = validate(container)["driver"]
    if os.path.sep in d:
        return d if os.access(d, os.X_OK) else None
    return shutil.which(d)


def wrap_worker_command(container: dict, cmd: List[str], *,
                        session_dir: str, store_path: str,
                        env: Dict[str, str]) -> List[str]:
    """[driver run ... --entrypoint python image <worker args>].

    ``cmd`` is the host spawn command ([python, -m, module, flags...]);
    inside the image the interpreter is whatever ``python`` resolves to
    there.  Mounts: the session dir (logs, sockets, spill) and the shm
    store segment's directory (the worker mmaps the segment by path).
    Critical env rides as explicit --env so it works across drivers
    (podman's --env-host would leak the whole host env; the reference
    uses it, we pass the system allowlist plus the user's runtime_env
    env_vars keys)."""
    c = validate(container)
    drv = driver_path(c)
    if drv is None:
        raise ContainerError(
            f"container runtime {c['driver']!r} not found on this host "
            "(install podman/docker or point 'driver' at an executable)")
    store_dir = os.path.dirname(store_path) or "/"
    out = [drv, "run", "--rm",
           "-v", f"{session_dir}:{session_dir}",
           "-v", f"{store_dir}:{store_dir}",
           "--network=host", "--pid=host", "--ipc=host"]
    forward = ["PYTHONPATH", "RAY_TPU_TORCH_SYSTEM_CONFIG",
               "RAY_TPU_TORCH_RUNTIME_ENV",
               "RAY_TPU_TORCH_INLINE_OBJECT_MAX_BYTES",
               "CUDA_VISIBLE_DEVICES"]
    # user env_vars from the runtime_env descriptor ride along too —
    # the raylet merged them into `env`, and the descriptor JSON names
    # which keys are the user's (the reference forwards the entire host
    # env via --env-host; we forward system allowlist + user keys)
    user_keys: set = set()
    renv_json = env.get("RAY_TPU_TORCH_RUNTIME_ENV")
    if renv_json:
        try:
            user_keys = set(json.loads(renv_json).get("env_vars") or {})
            forward += [k for k in user_keys if k not in forward]
        except ValueError:
            pass
    for key in forward:
        # user keys forward even when empty (blanking an image-baked
        # var is a legitimate override); system keys only when set
        if key in user_keys and key in env:
            out += ["--env", f"{key}={env[key]}"]
        elif key not in user_keys and env.get(key):
            out += ["--env", f"{key}={env[key]}"]
    out += list(c["run_options"])
    out += ["--entrypoint", "python", c["image"]]
    out += cmd[1:]                       # drop the host interpreter path
    return out
