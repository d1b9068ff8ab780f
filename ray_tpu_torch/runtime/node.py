"""Node/process orchestration: spawning GCS and raylet daemons.

Analog of /root/reference/python/ray/_private/node.py (start_head_processes
:1045, start_ray_processes :1083) and services.py (start_gcs_server :1200,
start_raylet :1273): the head starts a GCS subprocess then a raylet
subprocess; worker nodes start just a raylet pointed at the head's GCS.
"""

from __future__ import annotations

import atexit
import itertools
import json
import os
import subprocess
import sys
import tempfile
import time
from typing import Dict, Optional, Tuple

from ray_tpu_torch._private.config import CONFIG
from ray_tpu_torch._private.logging_utils import get_logger

logger = get_logger("node")


_session_seq = itertools.count()


def session_base() -> str:
    """Where sessions and ``latest.json`` live: under the temporary
    directory (``TMPDIR``, else /tmp), so a process with a TMPDIR of its
    own neither writes nor attaches to another's sessions."""
    return os.path.join(tempfile.gettempdir(), "ray_tpu_torch_sessions")


def new_session_dir() -> str:
    """Unique per call, even for back-to-back init()s in one process
    within one wall second.  Two clusters sharing a dir was the
    daemon-spawn startup-race flake: the second ``start_gcs`` read the
    FIRST (dead) GCS's leftover ``gcs_address.json`` and pointed its
    raylet at a dead port (connection refused at spawn), and the second
    GCS replayed the first's snapshot/WAL as its own state.  The
    raylet address files already carried a microsecond suffix for
    exactly this collision — the session dir itself needed it too."""
    base = session_base()
    os.makedirs(base, exist_ok=True)
    session = os.path.join(
        base, f"session_{time.strftime('%Y%m%d-%H%M%S')}_{os.getpid()}"
              f"_{next(_session_seq)}")
    os.makedirs(os.path.join(session, "logs"), exist_ok=True)
    return session


def _wait_address_file(path: str, proc: subprocess.Popen,
                       timeout: float = 30.0) -> dict:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if os.path.exists(path):
            try:
                with open(path) as f:
                    return json.load(f)
            except (ValueError, OSError):
                pass
        if proc.poll() is not None:
            raise RuntimeError(
                f"daemon exited with code {proc.returncode} before "
                f"publishing {path}")
        time.sleep(0.02)
    raise TimeoutError(f"daemon did not publish {path}")


def package_pythonpath() -> str:
    """PYTHONPATH that makes ray_tpu_torch importable in child processes."""
    import ray_tpu_torch
    pkg_root = os.path.dirname(os.path.dirname(os.path.abspath(
        ray_tpu_torch.__file__)))
    existing = os.environ.get("PYTHONPATH", "")
    if pkg_root in existing.split(os.pathsep):
        return existing
    return pkg_root + (os.pathsep + existing if existing else "")


def _spawn(cmd, session_dir: str, name: str,
           env_overrides: Optional[Dict[str, str]] = None) -> subprocess.Popen:
    env = dict(os.environ)
    env["RAY_TPU_TORCH_SYSTEM_CONFIG"] = CONFIG.overrides_env_blob()
    env["PYTHONPATH"] = package_pythonpath()
    env.update(env_overrides or {})
    log_prefix = os.path.join(session_dir, "logs", name)
    out_f = open(log_prefix + ".out", "ab")
    err_f = open(log_prefix + ".err", "ab")
    try:
        return subprocess.Popen(cmd, env=env, stdout=out_f, stderr=err_f)
    finally:
        out_f.close()
        err_f.close()


class NodeProcesses:
    """Daemons started by this process (head or worker node)."""

    def __init__(self, session_dir: str):
        self.session_dir = session_dir
        self.gcs_proc: Optional[subprocess.Popen] = None
        self.raylet_proc: Optional[subprocess.Popen] = None
        self.gcs_address: Optional[Tuple[str, int]] = None
        self.raylet_address: Optional[Tuple[str, int]] = None
        self.node_id: Optional[str] = None
        self.store_path: Optional[str] = None
        atexit.register(self.stop)

    def start_gcs(self, port: int = 0) -> Tuple[str, int]:
        addr_file = os.path.join(self.session_dir, "gcs_address.json")
        # belt-and-braces vs the stale-address-file race: a leftover
        # file from an earlier GCS in this dir must never satisfy
        # _wait_address_file before the fresh daemon publishes its own
        try:
            os.remove(addr_file)
        except FileNotFoundError:
            pass
        self.gcs_proc = _spawn(
            [sys.executable, "-m", "ray_tpu_torch.runtime.gcs",
             "--port", str(port),
             "--session-dir", self.session_dir,
             "--address-file", addr_file],
            self.session_dir, "gcs_server")
        info = _wait_address_file(addr_file, self.gcs_proc)
        self.gcs_address = (info["host"], info["port"])
        # advertise the most recent local session for address auto-discovery
        # (reference: session_latest symlink + RAY_ADDRESS resolution)
        try:
            latest = os.path.join(session_base(), "latest.json")
            tmp = latest + f".tmp{os.getpid()}"
            with open(tmp, "w") as f:
                json.dump({"gcs_host": info["host"],
                           "gcs_port": info["port"],
                           "session_dir": self.session_dir}, f)
            os.replace(tmp, latest)
        except OSError:
            pass
        return self.gcs_address

    def start_raylet(self, gcs_address: Tuple[str, int],
                     resources: Optional[Dict[str, float]] = None,
                     object_store_memory: Optional[int] = None
                     ) -> Tuple[str, int]:
        addr_file = os.path.join(
            self.session_dir, f"raylet_address_{os.getpid()}_"
                              f"{int(time.time()*1e6)}.json")
        cmd = [sys.executable, "-m", "ray_tpu_torch.runtime.raylet",
               "--gcs-host", gcs_address[0],
               "--gcs-port", str(gcs_address[1]),
               "--session-dir", self.session_dir,
               "--address-file", addr_file]
        if resources:
            cmd += ["--resources", json.dumps(resources)]
        if object_store_memory:
            cmd += ["--object-store-memory", str(object_store_memory)]
        self.raylet_proc = _spawn(cmd, self.session_dir, "raylet")
        info = _wait_address_file(addr_file, self.raylet_proc)
        self.raylet_address = (info["host"], info["port"])
        self.node_id = info["node_id"]
        self.store_path = info["store_path"]
        return self.raylet_address

    def stop(self) -> None:
        for proc in (self.raylet_proc, self.gcs_proc):
            if proc is not None and proc.poll() is None:
                proc.terminate()
        for proc in (self.raylet_proc, self.gcs_proc):
            if proc is not None:
                try:
                    proc.wait(timeout=3)
                except subprocess.TimeoutExpired:
                    proc.kill()
        self.raylet_proc = self.gcs_proc = None
