"""Logging setup shared by drivers, daemons, and workers.

Analog of the reference's spdlog wrapper + per-session log dir layout
(/root/reference/python/ray/_private/ray_logging.py, src/ray/util/logging.cc):
every process logs to ``<session_dir>/logs/<component>-<pid>.log`` and,
for workers, optionally mirrors stdout/stderr there so the driver-side log
monitor can tail and forward them.
"""

from __future__ import annotations

import logging
import os
import sys

_FORMAT = "%(asctime)s %(levelname)s %(name)s:%(lineno)d -- %(message)s"


def get_logger(name: str) -> logging.Logger:
    return logging.getLogger(f"ray_tpu_torch.{name}")


def enable_stack_dumps(session_dir: str | None) -> None:
    """SIGUSR1 -> dump every thread's Python stack to the session log dir
    (py-spy/`ray stack` analog, cf. reference python/ray/scripts `ray
    stack`): `ray-tpu stack` signals all session processes and collects
    the files. The dump file is kept open for the process's lifetime —
    faulthandler requires a stable fd."""
    if not session_dir:
        return
    import faulthandler
    import signal

    try:
        log_dir = os.path.join(session_dir, "logs")
        os.makedirs(log_dir, exist_ok=True)
        f = open(os.path.join(log_dir, f"stack_{os.getpid()}.txt"), "w")
        faulthandler.register(signal.SIGUSR1, file=f, all_threads=True)
    except (OSError, ValueError, AttributeError):
        pass  # debugging aid only; never fail startup over it


def setup_component_logging(component: str, session_dir: str | None = None,
                            level: int = logging.INFO) -> str | None:
    """Configure the root ray_tpu_torch logger; returns the log file path if any."""
    logger = logging.getLogger("ray_tpu_torch")
    logger.setLevel(level)
    logger.propagate = False
    for h in list(logger.handlers):
        logger.removeHandler(h)
    path = None
    if session_dir:
        log_dir = os.path.join(session_dir, "logs")
        os.makedirs(log_dir, exist_ok=True)
        path = os.path.join(log_dir, f"{component}-{os.getpid()}.log")
        handler: logging.Handler = logging.FileHandler(path)
    else:
        handler = logging.StreamHandler(sys.stderr)
    handler.setFormatter(logging.Formatter(_FORMAT))
    logger.addHandler(handler)
    return path


def redirect_stdio_to(path_prefix: str) -> None:
    """Redirect this process's stdout/stderr to files (worker processes)."""
    parent = os.path.dirname(path_prefix)
    if parent:
        os.makedirs(parent, exist_ok=True)
    out = open(path_prefix + ".out", "a", buffering=1)
    err = open(path_prefix + ".err", "a", buffering=1)
    os.dup2(out.fileno(), sys.stdout.fileno())
    os.dup2(err.fileno(), sys.stderr.fileno())
