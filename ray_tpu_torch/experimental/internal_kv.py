"""Thin client over the GCS internal key-value store.

Analog of Ray's python/ray/experimental/internal_kv.py — the
cluster-wide KV used for function exports, named resources, and library
metadata (Serve config, collective rendezvous, ...).
"""

from __future__ import annotations

from typing import List, Optional

from ray_tpu_torch.runtime import core_worker as cw


def _gcs():
    return cw.get_global_worker().gcs


def _internal_kv_initialized() -> bool:
    return cw._global_worker is not None


def _internal_kv_put(key: str, value: bytes, overwrite: bool = True) -> bool:
    """Returns True iff the key already existed (reference semantics)."""
    if isinstance(value, str):
        value = value.encode()
    return _gcs().kv_put(key, value, overwrite=overwrite)


def _internal_kv_get(key: str) -> Optional[bytes]:
    return _gcs().kv_get(key)


def _internal_kv_exists(key: str) -> bool:
    return bool(_gcs().call("kv_exists", {"key": key}))


def _internal_kv_del(key: str) -> bool:
    return _gcs().kv_del(key)


def _internal_kv_list(prefix: str) -> List[str]:
    return list(_gcs().call("kv_keys", {"prefix": prefix}))
