"""Debug-mode lock-order sanitizer (``RAY_TPU_TORCH_DEBUG_LOCKS=1``).

Lock-order inversions (thread 1 holds A wanting B, thread 2 holds B
wanting A) only deadlock when the two acquisition windows actually
overlap — which makes them the canonical one-in-a-thousand bug: the
raylet ``_kill_worker`` TOCTOU shipped and survived chaos runs because
the colliding window was microseconds wide.  A lockdep-style sanitizer
removes the probability from the bug class: it records the ORDER in
which lock classes are acquired, and the first time any thread ever
acquires B while holding A after some thread acquired A while holding
B — overlapping or not — it raises with both acquisition sites.

Mechanism (a pure-Python cousin of the kernel's lockdep):

* ``install()`` monkeypatches ``threading.Lock``/``threading.RLock``
  with factories.  A lock constructed by an *instrumented module*
  (creation frame under ``ray_tpu_torch/``, excluding this file) gets a
  wrapper; everything else (stdlib internals, user code, torch) gets the
  real primitive untouched.
* locks are classed by their CREATION SITE (``file:line``), like
  lockdep classes — the raylet's thousand per-connection locks form one
  class, so an inversion between two *instances* is caught the first
  time the pattern appears anywhere.  Same-class pairs (A1 vs A2 from
  one site) are deliberately NOT edges: hand-over-hand between
  same-class instances is a legitimate pattern and instance-level
  cycles on one class cannot be distinguished statically from it.
* each successful acquire appends to a ``threading.local`` held-stack
  and records ``held-class -> new-class`` edges into a process-global
  graph; a new edge triggers a DFS for a path back, and a cycle raises
  ``LockOrderError`` naming every edge's acquire site (file:line of
  both sides — the test contract).
* ``Condition.wait`` works unmodified: it releases/re-acquires through
  the wrapper (the RLock wrapper forwards ``_release_save`` /
  ``_acquire_restore`` / ``_is_owned`` so recursion counts survive the
  wait), so the held-stack stays truthful across waits.

The wrappers add roughly a guarded list append per acquire on
instrumented locks — debug-mode cost, which is why this is an opt-in
sanitizer wired into the chaos and compiled-DAG suites rather than an
always-on layer.  Cross-thread release of a plain Lock (the
completion-gate pattern, legal for Lock) is handled: the release drops
the entry from the RECORDING thread's stack, so no phantom entries
haunt the acquirer.
"""

from __future__ import annotations

import os
import sys
import threading
from typing import Dict, List, Optional, Set, Tuple

from ray_tpu_torch._private.config import CONFIG

__all__ = ["LockOrderError", "install", "installed", "maybe_install",
           "enabled", "reset", "edges"]


class LockOrderError(RuntimeError):
    """A lock acquisition-order cycle: the chain names, for every edge,
    where the second lock was acquired while the first was held."""


def enabled() -> bool:
    """Debug gate: RAY_TPU_TORCH_DEBUG_LOCKS env wins, then the config flag
    (declared as ``debug_locks``, so both spellings resolve here)."""
    return CONFIG.debug_locks


# creation-frame filename prefixes that get instrumented wrappers; the
# concurrency-heavy runtime core, not the whole world — wrapping every
# library lock would tax untargeted suites and drown the graph
_SELF = os.path.abspath(os.path.dirname(__file__))
_DEFAULT_PREFIXES = tuple(
    os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "..", p))
    for p in (
        os.path.join("_private", "rpc.py"),
        os.path.join("_private", "transfer.py"),
        "runtime",
        os.path.join("util", "collective"),
        os.path.join("dag", ""),
        os.path.join("experimental", "channel.py"),
        "serve",
    ))

_real_lock = threading.Lock
_real_rlock = threading.RLock
_installed = False
_prefixes: Tuple[str, ...] = _DEFAULT_PREFIXES

# The sanitizer's own two locks mark their holder busy.  Any allocation
# made while one is held may start a garbage collection on this thread,
# whose finalizers (``ObjectRef.__del__``) take instrumented locks; their
# bookkeeping would wait on the guard this very thread holds, forever.
# A lock taken while its thread is busy is acquired for real and left
# out of the held stacks and the graph.
_busy = threading.local()


class _Guard:
    """A plain lock that marks its holder's thread busy while held (set
    before the acquire: the thread-local's first store may allocate)."""

    __slots__ = ("_lock",)

    def __init__(self):
        self._lock = _real_lock()

    def __enter__(self) -> None:
        _busy.on = True
        self._lock.acquire()

    def __exit__(self, *exc) -> None:
        self._lock.release()
        _busy.on = False


def _is_busy() -> bool:
    return getattr(_busy, "on", False)


# acquisition-order graph over lock classes (creation sites):
# (a_site, b_site) -> (a_acquire_site, b_acquire_site) of the FIRST
# observation — kept so a later inverse edge can name both windows
_graph_lock = _Guard()
_edges: Dict[Tuple[str, str], Tuple[str, str]] = {}
_succ: Dict[str, Set[str]] = {}

# held stacks keyed by recording thread id (NOT threading.local): a
# plain Lock may legally be released by a different thread than its
# acquirer (completion-gate pattern), and the release must drop the
# entry from the RECORDING thread's stack or it haunts that thread as
# a phantom, spraying false order edges.  _held_guard serializes stack
# mutation; empty stacks are pruned so dead threads don't accumulate.
_held_guard = _Guard()
_held_by_tid: Dict[int, List[Tuple[str, str, object]]] = {}


def _held_snapshot(tid: Optional[int] = None
                   ) -> List[Tuple[str, str, object]]:
    """Copy of a thread's held stack (default: the calling thread)."""
    t = tid if tid is not None else threading.get_ident()
    with _held_guard:
        return list(_held_by_tid.get(t, ()))


def _caller_site(depth: int = 2) -> str:
    f = sys._getframe(depth)
    while f is not None and os.path.abspath(
            f.f_code.co_filename).startswith(_SELF):
        f = f.f_back
    if f is None:  # pragma: no cover - only if called from this module
        return "<unknown>"
    return f"{f.f_code.co_filename}:{f.f_lineno}"


def _find_path(src: str, dst: str) -> Optional[List[str]]:
    """DFS path src -> ... -> dst over _succ (graph lock held)."""
    stack = [(src, [src])]
    seen = {src}
    while stack:
        node, path = stack.pop()
        if node == dst:
            return path
        for nxt in _succ.get(node, ()):
            if nxt not in seen:
                seen.add(nxt)
                stack.append((nxt, path + [nxt]))
    return None


def _record_edges(new_site: str, acquire_site: str) -> None:
    held = _held_snapshot()
    if not held:
        return
    for held_site, held_acq, _lock in held:
        if held_site == new_site:
            continue  # same class: hand-over-hand, not an order edge
        key = (held_site, new_site)
        with _graph_lock:
            if key in _edges:
                continue
            # would this edge close a cycle?  path new -> ... -> held
            path = _find_path(new_site, held_site)
            if path is None:
                _edges[key] = (held_acq, acquire_site)
                _succ.setdefault(held_site, set()).add(new_site)
                continue
            lines = [
                f"lock-order inversion: acquiring {new_site} (at "
                f"{acquire_site}) while holding {held_site} (acquired "
                f"at {held_acq}), but the inverse order is already on "
                f"record:"]
            for a, b in zip(path, path[1:]):
                ea = _edges.get((a, b))
                where = f" (at {ea[1]}, holding since {ea[0]})" \
                    if ea else ""
                lines.append(f"  {a} -> {b}{where}")
        raise LockOrderError("\n".join(lines))


def _on_acquired(site: str, lock: object, first: bool) -> None:
    if not first:
        return  # RLock recursion: already on the stack
    if _is_busy():
        lock._held_tid = None  # a finalizer run under a guard: unrecorded
        return
    acq = _caller_site(3)
    _record_edges(site, acq)
    tid = threading.get_ident()
    lock._held_tid = tid
    with _held_guard:
        _held_by_tid.setdefault(tid, []).append((site, acq, lock))


def _on_released(lock: object) -> None:
    # drop the entry from the stack of the thread that RECORDED it —
    # which, for a plain Lock handed across threads, may not be the
    # releasing thread
    tid = getattr(lock, "_held_tid", None)
    if tid is None or _is_busy():
        return
    with _held_guard:
        held = _held_by_tid.get(tid)
        if held is None:
            return
        for i in range(len(held) - 1, -1, -1):
            if held[i][2] is lock:
                del held[i]
                break
        if not held:
            del _held_by_tid[tid]


class _DebugLock:
    """threading.Lock wrapper recording acquisition order."""

    __slots__ = ("_lock", "_site", "_held_tid")

    def __init__(self, site: str):
        self._lock = _real_lock()
        self._site = site
        self._held_tid: Optional[int] = None

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        ok = self._lock.acquire(blocking, timeout)
        if ok:
            try:
                _on_acquired(self._site, self, True)
            except LockOrderError:
                # report the inversion WITHOUT converting it into the
                # very hang it diagnoses: a caller that survives the
                # exception must not leave the lock held forever
                self._lock.release()
                raise
        return ok

    def release(self) -> None:
        self._lock.release()
        _on_released(self)

    def locked(self) -> bool:
        return self._lock.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self) -> str:
        return f"<DebugLock {self._site} {self._lock!r}>"


class _DebugRLock:
    """threading.RLock wrapper; forwards the Condition protocol so
    ``Condition.wait`` saves/restores recursion counts correctly."""

    __slots__ = ("_lock", "_site", "_count", "_held_tid")

    def __init__(self, site: str):
        self._lock = _real_rlock()
        self._site = site
        self._held_tid: Optional[int] = None
        self._count = 0  # this-thread recursion depth is what matters;
        # cross-thread reads of the int are benign (only the owner
        # mutates it between acquire/release pairs)

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        ok = self._lock.acquire(blocking, timeout)
        if ok:
            self._count += 1
            try:
                _on_acquired(self._site, self, self._count == 1)
            except LockOrderError:
                self._count -= 1
                self._lock.release()
                raise
        return ok

    def release(self) -> None:
        # bookkeeping BEFORE the inner release: once the real lock is
        # free another thread may acquire the wrapper immediately, and
        # a late decrement here would corrupt the shared count (phantom
        # held-stack entries -> bogus order edges).  Only the owner may
        # legitimately release, so mutating first is safe; a non-owner
        # falls through to the inner release's RuntimeError untouched.
        if self._count > 0 and self._lock._is_owned():
            self._count -= 1
            if self._count == 0:
                _on_released(self)
        self._lock.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    # --- Condition protocol (delegate; keep held-stack truthful) ----
    def _is_owned(self) -> bool:
        return self._lock._is_owned()

    def _release_save(self):
        # same ordering rule as release(): zero the shared count before
        # the inner lock actually frees, or a waiter's first acquire
        # races the stale count
        saved = self._count
        self._count = 0
        _on_released(self)
        state = self._lock._release_save()
        return (state, saved)

    def _acquire_restore(self, state) -> None:
        inner, saved = state
        self._lock._acquire_restore(inner)
        self._count = saved
        _on_acquired(self._site, self, True)

    def __repr__(self) -> str:
        return f"<DebugRLock {self._site} {self._lock!r}>"


def _should_wrap(filename: str) -> bool:
    path = os.path.abspath(filename)
    if path.startswith(_SELF):
        return False
    return any(path.startswith(p) for p in _prefixes)


def _lock_factory():
    if enabled():
        f = sys._getframe(1)
        if _should_wrap(f.f_code.co_filename):
            return _DebugLock(f"{f.f_code.co_filename}:{f.f_lineno}")
    return _real_lock()


def _rlock_factory():
    if enabled():
        f = sys._getframe(1)
        if _should_wrap(f.f_code.co_filename):
            return _DebugRLock(f"{f.f_code.co_filename}:{f.f_lineno}")
    return _real_rlock()


def install(prefixes: Optional[Tuple[str, ...]] = None) -> None:
    """Patch ``threading.Lock``/``RLock`` with the gating factories.
    Idempotent; with the gate off the factories hand out real locks, so
    installing is cheap even when debugging is disabled (the tier-1
    chaos/compiled-DAG fixtures rely on that: install once, gate via
    env per suite)."""
    global _installed, _prefixes
    if prefixes:
        _prefixes = tuple(os.path.abspath(p) for p in prefixes)
    if _installed:
        return
    threading.Lock = _lock_factory
    threading.RLock = _rlock_factory
    _installed = True


def installed() -> bool:
    return _installed


def maybe_install() -> None:
    """Install when the debug gate is on (called from ray_tpu_torch.__init__
    so spawned daemons self-instrument off the inherited env)."""
    if enabled():
        install()


def reset() -> None:
    """Drop the recorded graph and held stacks (test isolation)."""
    with _graph_lock:
        _edges.clear()
        _succ.clear()
    with _held_guard:
        _held_by_tid.clear()


def edges() -> Dict[Tuple[str, str], Tuple[str, str]]:
    with _graph_lock:
        return dict(_edges)
