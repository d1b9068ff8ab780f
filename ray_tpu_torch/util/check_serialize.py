"""Serializability inspector.

Analog of /root/reference/python/ray/util/check_serialize.py
(inspect_serializability): walks an object's closure/attributes to pinpoint
which inner object actually fails to pickle, instead of one opaque error.
"""

from __future__ import annotations

import inspect
from typing import Any, Optional, Set, Tuple

from ray_tpu_torch import cloudpickle

_printer_indent = 0


def _check(obj: Any, name: str, depth: int, failures: Set[str],
           seen: Set[int]) -> bool:
    if id(obj) in seen:
        return True
    seen.add(id(obj))
    try:
        cloudpickle.dumps(obj)
        return True
    except Exception as e:  # noqa: BLE001 - any pickling error counts
        if depth <= 0:
            failures.add(f"{name}: {type(obj).__name__} ({e})")
            return False
    found_inner = False
    # closures
    if inspect.isfunction(obj):
        closure = obj.__closure__ or ()
        names = obj.__code__.co_freevars
        for var, cell in zip(names, closure):
            try:
                inner = cell.cell_contents
            except ValueError:
                continue
            if not _check(inner, f"{name}.<closure>.{var}", depth - 1,
                          failures, seen):
                found_inner = True
        for var, val in (obj.__globals__ or {}).items():
            if var in obj.__code__.co_names and \
                    not inspect.ismodule(val) and _is_suspect(val):
                if not _check(val, f"{name}.<global>.{var}", depth - 1,
                              failures, seen):
                    found_inner = True
    # instance attributes
    elif hasattr(obj, "__dict__"):
        for attr, val in vars(obj).items():
            if not _check(val, f"{name}.{attr}", depth - 1, failures, seen):
                found_inner = True
    elif isinstance(obj, (list, tuple, set)):
        for i, val in enumerate(obj):
            if not _check(val, f"{name}[{i}]", depth - 1, failures, seen):
                found_inner = True
    elif isinstance(obj, dict):
        for k, val in obj.items():
            if not _check(val, f"{name}[{k!r}]", depth - 1, failures, seen):
                found_inner = True
    if not found_inner:
        failures.add(f"{name}: {type(obj).__name__}")
    return False


def _is_suspect(val: Any) -> bool:
    import threading
    return isinstance(val, (threading.Lock().__class__,
                            threading.RLock().__class__)) or \
        inspect.isgenerator(val) or hasattr(val, "fileno")


def inspect_serializability(obj: Any, name: Optional[str] = None,
                            depth: int = 3,
                            print_file=None) -> Tuple[bool, Set[str]]:
    """Returns (serializable, failure descriptions)."""
    name = name or getattr(obj, "__name__", type(obj).__name__)
    failures: Set[str] = set()
    ok = _check(obj, name, depth, failures, set())
    if not ok and print_file is not None:
        print(f"{name} is NOT serializable:", file=print_file)
        for f in sorted(failures):
            print(f"  - {f}", file=print_file)
    return ok, failures
