"""Training-loop session: the channel between user train code and the
framework driving it (the port's copy of ray_tpu/air/session.py).

Analog of Ray's python/ray/air/session.py (report :41,
get_dataset_shard :345) + train/_internal/session.py. The trainer (or Tune
function-trainable runner) installs a ``_Session`` in the worker before
calling the user loop; ``report`` hands (metrics, checkpoint) to it and
blocks until the driver has consumed the result — the same
producer/consumer handshake the reference builds with a result queue.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Dict, Optional

from ray_tpu_torch.air.checkpoint import Checkpoint


class _Session:
    def __init__(self, *, world_rank: int = 0, world_size: int = 1,
                 local_rank: int = 0, local_world_size: int = 1,
                 node_rank: int = 0,
                 trial_name: str = "", trial_id: str = "",
                 trial_dir: str = "", experiment_name: str = "",
                 dataset_shards: Optional[Dict[str, Any]] = None,
                 checkpoint: Optional[Checkpoint] = None,
                 synchronous: bool = True):
        self.world_rank = world_rank
        self.world_size = world_size
        self.local_rank = local_rank
        self.local_world_size = local_world_size
        self.node_rank = node_rank
        self.trial_name = trial_name
        self.trial_id = trial_id
        self.trial_dir = trial_dir
        self.experiment_name = experiment_name
        self.dataset_shards = dataset_shards or {}
        self.loaded_checkpoint = checkpoint
        self.synchronous = synchronous
        self.result_queue: "queue.Queue" = queue.Queue()
        self._consumed = threading.Event()
        self._consumed.set()
        self.stop_requested = threading.Event()
        self.iteration = 0

    def report(self, metrics: Dict[str, Any],
               checkpoint: Optional[Checkpoint] = None) -> None:
        if self.stop_requested.is_set():
            raise StopIteration("trial stop requested")
        self.iteration += 1
        metrics = dict(metrics)
        metrics.setdefault("training_iteration", self.iteration)
        if self.synchronous:
            self._consumed.clear()
        self.result_queue.put((metrics, checkpoint))
        if self.synchronous:
            # back-pressure: wait until the driver polls this result so a fast
            # loop can't flood the queue (reference session does the same)
            self._consumed.wait()

    def next_result(self, timeout: Optional[float] = None):
        try:
            item = self.result_queue.get(timeout=timeout)
        except queue.Empty:
            return None
        self._consumed.set()
        return item


_session_lock = threading.Lock()
_sessions: Dict[int, _Session] = {}   # thread id -> session


def init_session(**kwargs) -> _Session:
    s = _Session(**kwargs)
    with _session_lock:
        _sessions[threading.get_ident()] = s
    return s


def shutdown_session() -> None:
    with _session_lock:
        _sessions.pop(threading.get_ident(), None)


def get_session() -> Optional[_Session]:
    with _session_lock:
        s = _sessions.get(threading.get_ident())
        if s is None and len(_sessions) == 1:
            # single-session process (worker actor): any thread may ask
            s = next(iter(_sessions.values()))
        return s


def _require_session() -> _Session:
    s = get_session()
    if s is None:
        raise RuntimeError(
            "no training session active; session.* APIs only work inside a "
            "train loop launched by a Trainer or Tuner")
    return s


# -- public API -------------------------------------------------------------

def report(metrics: Dict[str, Any],
           checkpoint: Optional[Checkpoint] = None) -> None:
    if checkpoint is None:
        _require_session().report(metrics, checkpoint)
        return
    # training performance plane: handing a checkpoint to the driver
    # (serialization + the consumption handshake) is time the chip is
    # not stepping — attribute it to the ``checkpoint`` phase of the
    # open step, or the run ledger's out-of-step totals
    import time as _time
    from ray_tpu_torch._private import step_stats
    t0 = _time.monotonic()
    try:
        _require_session().report(metrics, checkpoint)
    finally:
        step_stats.record_phase(
            "checkpoint", (_time.monotonic() - t0) * 1000.0)


def get_checkpoint() -> Optional[Checkpoint]:
    return _require_session().loaded_checkpoint


def get_dataset_shard(name: str = "train"):
    return _require_session().dataset_shards.get(name)


def get_world_rank() -> int:
    return _require_session().world_rank


def get_world_size() -> int:
    return _require_session().world_size


def get_local_rank() -> int:
    return _require_session().local_rank


def get_local_world_size() -> int:
    return _require_session().local_world_size


def get_node_rank() -> int:
    return _require_session().node_rank


def get_trial_name() -> str:
    return _require_session().trial_name


def get_trial_id() -> str:
    return _require_session().trial_id


def get_trial_dir() -> str:
    return _require_session().trial_dir


def get_experiment_name() -> str:
    return _require_session().experiment_name
