"""Per-runtime-env pip isolation: one cached venv per requirement set.

Analog of /root/reference/python/ray/_private/runtime_env/pip.py:75
(``PipProcessor``) + the URI cache (uri_cache.py): a runtime env with
``pip: [...]`` gets a virtualenv keyed by the hash of its sorted
requirements; the raylet launches that env's workers with the venv's
interpreter, so two tasks can hold conflicting package versions
concurrently.  Venvs are created with ``--system-site-packages`` (the
worker still sees the baked image: torch, numpy, ray_tpu_torch via
PYTHONPATH)
and reused across workers/jobs until the cache dir is cleared.

Zero-egress seam: ``runtime_env_pip_find_links`` points pip at a local
wheelhouse with ``--no-index`` — the test builds tiny wheels by hand —
while production hosts with egress just leave it unset.
"""

from __future__ import annotations

import fcntl
import hashlib
import logging
import os
import re
import subprocess
import sys
import tempfile
from typing import List

from ray_tpu_torch._private.config import CONFIG

logger = logging.getLogger(__name__)


def env_key(requirements: List[str]) -> str:
    """Cache key: requirements + the wheelhouse + the base interpreter —
    changing any of them must produce a fresh venv, not reuse a stale
    one built against different inputs."""
    blob = "\n".join(sorted(requirements)
                     + [f"find_links={CONFIG.runtime_env_pip_find_links}",
                        f"base={sys.executable}"]).encode()
    return hashlib.sha256(blob).hexdigest()[:16]


def _cache_dir() -> str:
    if CONFIG.runtime_env_cache_dir:
        return CONFIG.runtime_env_cache_dir
    # per-uid dir, created 0700: a shared /tmp cache would let another
    # local user pre-plant an interpreter for a predictable key
    return os.path.join(tempfile.gettempdir(),
                        f"ray_tpu_torch_runtime_envs_{os.getuid()}")


def venv_site_packages(python: str) -> str:
    """Site-packages dir of a venv given its interpreter path."""
    root = os.path.dirname(os.path.dirname(python))
    return os.path.join(
        root, "lib",
        f"python{sys.version_info[0]}.{sys.version_info[1]}",
        "site-packages")


def ensure_pip_env(requirements: List[str],
                   timeout_s: float = 300.0) -> str:
    """Create (or reuse) the venv for these requirements; returns the
    path of its python interpreter.  Safe under concurrent callers from
    multiple raylet processes (file lock + ready marker)."""
    key = env_key(requirements)
    root = os.path.join(_cache_dir(), f"pip_{key}")
    py = os.path.join(root, "bin", "python")
    ready = os.path.join(root, ".ready")
    if os.path.exists(ready):
        return py
    os.makedirs(_cache_dir(), mode=0o700, exist_ok=True)
    lock_path = os.path.join(_cache_dir(), f"pip_{key}.lock")
    with open(lock_path, "w") as lock_f:
        fcntl.flock(lock_f, fcntl.LOCK_EX)
        try:
            if os.path.exists(ready):   # lost the race: someone built it
                return py
            logger.info("creating pip runtime env %s: %s",
                        key, requirements)
            subprocess.run(
                [sys.executable, "-m", "venv", "--system-site-packages",
                 root],
                check=True, capture_output=True, timeout=timeout_s)
            # When this process itself runs inside a venv (the baked
            # image ships one), --system-site-packages points at the
            # BASE python, not our venv — chain our site-packages via a
            # .pth so workers still see torch/numpy.  Installed
            # requirement dirs sort before the .pth's appended paths, so
            # pinned versions still shadow the parent's copies.
            import site
            parent_sites = [p for p in site.getsitepackages()
                            if os.path.isdir(p)]
            vs = venv_site_packages(py)
            with open(os.path.join(vs, "_parent_site.pth"), "w") as f:
                f.write("\n".join(p for p in parent_sites
                                  if os.path.abspath(p)
                                  != os.path.abspath(vs)) + "\n")
            cmd = [py, "-m", "pip", "install", "--quiet",
                   "--disable-pip-version-check"]
            find_links = CONFIG.runtime_env_pip_find_links
            if find_links:
                cmd += ["--no-index", "--find-links", find_links]
            cmd += list(requirements)
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=timeout_s)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"pip install failed for runtime env "
                    f"{requirements}:\n{proc.stderr[-2000:]}")
            with open(ready, "w") as f:
                f.write("\n".join(sorted(requirements)))
            return py
        finally:
            fcntl.flock(lock_f, fcntl.LOCK_UN)


def normalize_conda_field(conda) -> List[str]:
    """Translate a conda runtime env into pip requirements for the venv
    machinery (reference conda plugin: _private/runtime_env/conda.py).

    Hermetic TPU images ship no conda binary, so instead of a solver we
    honor the *declarative content* of the common shapes:

    * dict (environment.yml content): ``dependencies`` entries become
      pip requirements — ``name=ver`` → ``name==ver``, the nested
      ``{"pip": [...]}`` block passes through; ``python=...``/``pip``
      entries are skipped (the interpreter is the image's own).
    * path to an ``environment.yml``: parsed the same way.
    * named conda env (bare string): rejected — there is no conda
      installation to look it up in.
    """
    if isinstance(conda, str):
        if conda.endswith((".yml", ".yaml")):
            import yaml
            with open(conda) as f:
                conda = yaml.safe_load(f) or {}
        else:
            raise ValueError(
                f"conda env by name ({conda!r}) is not supported: images "
                "are hermetic (no conda installation to resolve it). "
                "Pass the environment.yml content (dict or path) — its "
                "dependencies run in an isolated venv — or use 'pip'.")
    if not isinstance(conda, dict):
        raise TypeError("runtime_env 'conda' must be an environment.yml "
                        "dict, a path to one, or a named env")
    reqs: List[str] = []
    for dep in conda.get("dependencies", []):
        if isinstance(dep, dict):
            reqs.extend(dep.get("pip", []))
            continue
        if not isinstance(dep, str):
            raise TypeError(f"bad conda dependency: {dep!r}")
        dep = dep.strip()
        name = re.split(r"[=<>!~ ]", dep, maxsplit=1)[0]
        if name in ("python", "pip"):
            continue  # interpreter/installer come from the image
        # conda-only pin forms → pip:
        #   name=1.2           -> name==1.2
        #   name=1.2=py39h...  -> name==1.2  (conda env export emits
        #                         build strings pip cannot parse)
        m = re.fullmatch(r"([A-Za-z0-9_.\-]+)=([^=<>!~]+)(=[^=]+)?", dep)
        if m:
            dep = f"{m.group(1)}=={m.group(2)}"
        reqs.append(dep)
    return sorted(reqs)


def normalize_pip_field(pip) -> List[str]:
    """Accept the reference's shapes: list of requirement strings or
    {"packages": [...]} (pip.py RuntimeEnvPlugin validation)."""
    if isinstance(pip, dict):
        pip = pip.get("packages", [])
    if not isinstance(pip, (list, tuple)) or \
            not all(isinstance(r, str) for r in pip):
        raise TypeError(
            "runtime_env 'pip' must be a list of requirement strings "
            "or {'packages': [...]}")
    return sorted(pip)
