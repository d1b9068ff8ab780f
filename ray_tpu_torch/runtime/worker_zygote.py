"""Prefork worker zygote: fork warm worker processes in milliseconds.

Worker startup is dominated by imports: torch alone takes seconds.  The
reference amortizes worker startup with a prestarted pool
(worker_pool.cc); the zygote goes further: ONE process per raylet pays
the import cost, then every python worker is an ``os.fork()`` away
(~10 ms), giving reference-like actor/task worker density.

The zygote imports torch but runs no op on it and never touches
``torch.cuda``: an OpenMP pool or a CUDA context in the zygote would be
inherited broken by every fork.  Each child applies its env, including
``CUDA_VISIBLE_DEVICES`` (empty for a worker that leases no GPU), before
anything in it can start CUDA.

Mechanics:
  - The raylet launches ``python -m ray_tpu_torch.runtime.worker_zygote
    --socket <path>`` once (eagerly, so it warms while the cluster
    boots) and sends framed spawn requests over the unix socket.
  - Each request is ONE fork: the parent replies with the child pid
    immediately (it knows it from fork()), and SIGCHLD is set to
    SIG_IGN so exited workers auto-reap — no zombies, no waitpid, no
    intermediate process.  (The first design double-forked so workers
    reparented to init; that cost two page-table copies of a torch-laden
    process plus a blocking waitpid PER SPAWN, serializing mass actor
    creation at ~80 ms/fork.  The worker resets SIGCHLD to SIG_DFL so
    user subprocess code sees normal child semantics.)
  - The worker child starts a new session, points stdio at its log
    files, swaps env/argv/config, closes inherited sockets, and calls
    ``worker_main.main()`` exactly as an exec'd worker would.

Workers that need a different interpreter (pip runtime envs) or
language (cpp) keep the exec path — the raylet falls back automatically.
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import socket
import struct
import sys

_FRAME = struct.Struct("<I")


def send_msg(sock: socket.socket, obj) -> None:
    payload = pickle.dumps(obj)
    sock.sendall(_FRAME.pack(len(payload)) + payload)


def recv_msg(sock: socket.socket):
    head = _recv_exact(sock, _FRAME.size)
    if head is None:
        return None
    (n,) = _FRAME.unpack(head)
    body = _recv_exact(sock, n)
    return None if body is None else pickle.loads(body)


def _recv_exact(sock: socket.socket, n: int):
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            return None
        buf += chunk
    return buf


def _become_worker(req: dict) -> None:
    """Runs in the forked child: turn this fork into a real worker."""
    import signal
    signal.signal(signal.SIGCHLD, signal.SIG_DFL)
    os.setsid()
    try:
        # forked children keep the zygote's cmdline in ps; at least fix
        # the comm name so `ps -C`/top distinguish workers from the
        # zygote (15-char kernel limit)
        with open("/proc/self/comm", "w") as f:
            f.write("ray_tpu_torch_w")
    except OSError:
        pass
    devnull = os.open(os.devnull, os.O_RDONLY)
    out = os.open(req["stdout"], os.O_WRONLY | os.O_CREAT | os.O_APPEND,
                  0o644)
    err = os.open(req["stderr"], os.O_WRONLY | os.O_CREAT | os.O_APPEND,
                  0o644)
    os.dup2(devnull, 0)
    os.dup2(out, 1)
    os.dup2(err, 2)
    for fd in (devnull, out, err):
        if fd > 2:
            os.close(fd)
    os.chdir(req["cwd"])
    os.environ.clear()
    os.environ.update(req["env"])
    # the zygote's CONFIG was resolved from ITS env; re-resolve from the
    # worker's blob (same raylet -> normally identical, but exact is free)
    from ray_tpu_torch._private.config import CONFIG
    blob = req["env"].get("RAY_TPU_TORCH_SYSTEM_CONFIG", "")
    try:
        CONFIG.set_overrides(json.loads(blob) if blob else {})
    except (ValueError, TypeError):
        pass
    sys.argv = req["argv"]
    from ray_tpu_torch.runtime import worker_main
    # os._exit (not sys.exit) everywhere: a forked worker must never run
    # the zygote's atexit/teardown.  But a crash has to be visible —
    # traceback to the redirected stderr (.err log) and a nonzero status.
    try:
        worker_main.main()
    except SystemExit as e:
        code = e.code if isinstance(e.code, int) else (0 if e.code is None
                                                       else 1)
        if code != 0:
            import traceback
            traceback.print_exc()
            sys.stderr.flush()
        os._exit(code)
    except BaseException:
        import traceback
        traceback.print_exc()
        sys.stderr.flush()
        os._exit(1)
    os._exit(0)


def _handle_conn(conn: socket.socket, listener: socket.socket) -> None:
    while True:
        req = recv_msg(conn)
        if req is None:
            return
        sys.stdout.flush()
        sys.stderr.flush()
        pid = os.fork()
        if pid == 0:
            listener.close()
            conn.close()
            _become_worker(req)         # never returns
            os._exit(1)
        send_msg(conn, {"pid": pid})


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--socket", required=True)
    args = ap.parse_args()

    import signal as _signal

    # exited workers auto-reap (children of the zygote under the
    # single-fork protocol); _become_worker resets SIG_DFL in workers
    _signal.signal(_signal.SIGCHLD, _signal.SIG_IGN)
    # die with the raylet: a SIGKILLed raylet must not orphan a warm
    # torch-loaded process forever (PR_SET_PDEATHSIG is cleared on fork,
    # so spawned workers don't inherit the tie)
    try:
        import ctypes
        libc = ctypes.CDLL("libc.so.6", use_errno=True)
        PR_SET_PDEATHSIG = 1
        libc.prctl(PR_SET_PDEATHSIG, _signal.SIGKILL)
        if os.getppid() == 1:          # raylet already gone
            return
    except OSError:
        pass

    # the expensive part, paid exactly once per raylet: torch (imported
    # only: no op runs here, and torch.cuda is never touched) and the
    # runtime
    import torch                                        # noqa: F401

    from ray_tpu_torch.runtime import worker_main       # noqa: F401

    try:
        os.unlink(args.socket)
    except FileNotFoundError:
        pass
    listener = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    listener.bind(args.socket)
    listener.listen(8)
    while True:
        conn, _ = listener.accept()
        try:
            _handle_conn(conn, listener)
        except OSError:
            pass
        finally:
            conn.close()


if __name__ == "__main__":
    main()
