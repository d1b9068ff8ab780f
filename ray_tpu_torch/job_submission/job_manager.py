"""JobSupervisor actor + JobSubmissionClient SDK.

Cite: /root/reference/python/ray/dashboard/modules/job/job_manager.py
(JobManager.submit_job :431 -> JobSupervisor actor :133 runs the driver as
a subprocess) and python/ray/job_submission/sdk.py. Differences: state
lives in the GCS KV (the reference also persists JobInfo in the GCS KV);
log tailing returns the KV-buffered output instead of a REST stream.
"""

from __future__ import annotations

import json
import os
import subprocess
import threading
import time
import uuid
from dataclasses import asdict, dataclass, field
from typing import Any, Dict, List, Optional

import ray_tpu_torch

_KV_PREFIX = "job_submission:"
_LOG_PREFIX = "job_logs:"
_STOP_PREFIX = "job_stop:"
_MAX_LOG_BYTES = 4 * 1024 * 1024


class JobStatus:
    PENDING = "PENDING"
    RUNNING = "RUNNING"
    SUCCEEDED = "SUCCEEDED"
    FAILED = "FAILED"
    STOPPED = "STOPPED"

    TERMINAL = (SUCCEEDED, FAILED, STOPPED)


@dataclass
class JobInfo:
    submission_id: str
    entrypoint: str
    status: str = JobStatus.PENDING
    message: str = ""
    start_time: float = 0.0
    end_time: float = 0.0
    metadata: Dict[str, str] = field(default_factory=dict)
    runtime_env: Optional[dict] = None
    driver_exit_code: Optional[int] = None


def _kv():
    from ray_tpu_torch.runtime.core_worker import get_global_worker
    return get_global_worker().gcs


def _save(info: JobInfo) -> None:
    _kv().kv_put(_KV_PREFIX + info.submission_id,
                 json.dumps(asdict(info)).encode())


def _load(submission_id: str) -> Optional[JobInfo]:
    raw = _kv().kv_get(_KV_PREFIX + submission_id)
    return JobInfo(**json.loads(raw)) if raw else None


class JobSupervisor:
    """Detached actor that shepherds one job's driver subprocess.

    Runs on any cluster node; holds zero CPUs so it never competes with
    the job's own tasks (reference JobSupervisor does the same).
    """

    def __init__(self, submission_id: str, entrypoint: str,
                 metadata: Dict[str, str],
                 runtime_env: Optional[dict] = None):
        self.info = JobInfo(submission_id=submission_id,
                            entrypoint=entrypoint, metadata=metadata,
                            runtime_env=runtime_env)
        _save(self.info)

    def ping(self) -> bool:
        return True

    def run(self) -> str:
        from ray_tpu_torch.runtime.core_worker import get_global_worker
        worker = get_global_worker()
        gcs_host, gcs_port = worker.gcs._conn._sock.getpeername()

        self.info.status = JobStatus.RUNNING
        self.info.start_time = time.time()
        _save(self.info)

        env = dict(os.environ)
        env["RAY_TPU_TORCH_ADDRESS"] = f"{gcs_host}:{gcs_port}"
        env["RAY_TPU_TORCH_JOB_SUBMISSION_ID"] = self.info.submission_id
        if self.info.runtime_env and self.info.runtime_env.get("env_vars"):
            env.update(self.info.runtime_env["env_vars"])

        proc = subprocess.Popen(
            self.info.entrypoint, shell=True, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True, bufsize=1)
        buf: List[str] = []
        buf_bytes = 0
        lock = threading.Lock()

        def _pump():
            nonlocal buf_bytes
            for line in proc.stdout:
                with lock:
                    buf.append(line)
                    buf_bytes += len(line)
                    while buf_bytes > _MAX_LOG_BYTES and len(buf) > 1:
                        buf_bytes -= len(buf.pop(0))

        pump = threading.Thread(target=_pump, daemon=True)
        pump.start()

        stopped = False
        while proc.poll() is None:
            if _kv().kv_get(_STOP_PREFIX + self.info.submission_id):
                proc.terminate()
                try:
                    proc.wait(timeout=5)
                except subprocess.TimeoutExpired:
                    proc.kill()
                stopped = True
                break
            with lock:
                _kv().kv_put(_LOG_PREFIX + self.info.submission_id,
                             "".join(buf).encode())
            time.sleep(0.5)
        pump.join(timeout=5)
        with lock:
            _kv().kv_put(_LOG_PREFIX + self.info.submission_id,
                         "".join(buf).encode())

        code = proc.returncode
        self.info.driver_exit_code = code
        self.info.end_time = time.time()
        if stopped:
            self.info.status = JobStatus.STOPPED
            self.info.message = "stopped by user"
        elif code == 0:
            self.info.status = JobStatus.SUCCEEDED
        else:
            self.info.status = JobStatus.FAILED
            self.info.message = f"driver exited with code {code}"
        _save(self.info)
        return self.info.status


class JobSubmissionClient:
    """SDK + CLI backend. `address` is the GCS host:port (or None to use
    the already-initialized driver / the latest local session)."""

    def __init__(self, address: Optional[str] = None):
        if not ray_tpu_torch.is_initialized():
            if address is None:
                address = os.environ.get("RAY_TPU_TORCH_ADDRESS") or \
                    latest_session_address()
            ray_tpu_torch.init(address=address)

    def submit_job(self, *, entrypoint: str,
                   submission_id: Optional[str] = None,
                   metadata: Optional[Dict[str, str]] = None,
                   runtime_env: Optional[dict] = None) -> str:
        submission_id = submission_id or \
            "raysubmit_" + uuid.uuid4().hex[:16]
        if _load(submission_id) is not None:
            raise ValueError(f"job {submission_id} already exists")
        supervisor = ray_tpu_torch.remote(JobSupervisor).options(
            num_cpus=0, name=f"_job_supervisor:{submission_id}",
            lifetime="detached").remote(
                submission_id, entrypoint, metadata or {}, runtime_env)
        ray_tpu_torch.get(supervisor.ping.remote())  # surface creation errors
        supervisor.run.remote()  # fire and forget
        self._hold_supervisor(submission_id, supervisor)
        return submission_id

    # keep handles so the driver doesn't GC the fire-and-forget result ref
    _held: Dict[str, Any] = {}

    def _hold_supervisor(self, sid: str, handle) -> None:
        JobSubmissionClient._held[sid] = handle

    def get_job_info(self, submission_id: str) -> JobInfo:
        info = _load(submission_id)
        if info is None:
            raise ValueError(f"job {submission_id} not found")
        return info

    def get_job_status(self, submission_id: str) -> str:
        return self.get_job_info(submission_id).status

    def get_job_logs(self, submission_id: str) -> str:
        raw = _kv().kv_get(_LOG_PREFIX + submission_id)
        return raw.decode("utf-8", "replace") if raw else ""

    def list_jobs(self) -> List[JobInfo]:
        out = []
        for key in _kv().kv_keys(_KV_PREFIX):
            raw = _kv().kv_get(key)
            if raw:
                out.append(JobInfo(**json.loads(raw)))
        return sorted(out, key=lambda i: i.start_time)

    def stop_job(self, submission_id: str) -> bool:
        info = _load(submission_id)
        if info is None or info.status in JobStatus.TERMINAL:
            return False
        _kv().kv_put(_STOP_PREFIX + submission_id, b"1")
        return True

    def delete_job(self, submission_id: str) -> bool:
        info = _load(submission_id)
        if info is None:
            return False
        if info.status not in JobStatus.TERMINAL:
            raise RuntimeError("stop the job before deleting it")
        _kv().kv_del(_KV_PREFIX + submission_id)
        _kv().kv_del(_LOG_PREFIX + submission_id)
        _kv().kv_del(_STOP_PREFIX + submission_id)
        return True

    def wait_until_finished(self, submission_id: str,
                            timeout: float = 300.0) -> str:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            status = self.get_job_status(submission_id)
            if status in JobStatus.TERMINAL:
                return status
            time.sleep(0.5)
        raise TimeoutError(
            f"job {submission_id} not finished after {timeout}s")


def latest_session_address() -> str:
    """GCS address of the most recent local session (see node.py)."""
    from ray_tpu_torch.runtime.node import session_base
    path = os.path.join(session_base(), "latest.json")
    try:
        with open(path) as f:
            info = json.load(f)
        return f"{info['gcs_host']}:{info['gcs_port']}"
    except (OSError, ValueError, KeyError):
        raise ConnectionError(
            "no running cluster found: pass address=, set RAY_TPU_TORCH_ADDRESS, "
            "or start one with `python -m ray_tpu_torch.scripts start --head`")
