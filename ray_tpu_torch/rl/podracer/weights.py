"""Weight-version protocol: multi-source striped broadcast + KV pointer
(counterpart of ray_tpu/rl/podracer/weights.py).

The learner publishes each fresh weight version exactly once —
``ray_tpu_torch.put()`` of the (optionally int8-quantized) leaf payload —
and bumps a tiny pointer record in the internal KV
(``podracer/<name>/weights`` -> pickled ``{version, ref, ...}``).
Rollout actors poll the pointer at fragment boundaries (one cheap GCS
RPC) and, on a version bump, ``ray_tpu_torch.get()`` the ref: the transfer
plane stripes the pull across every process already holding the object
(the owner reports each completed puller as a new source — the
store-routed broadcast), so sync latency grows sub-linearly
with actor count instead of multiplying the learner's egress.

Version-skip rule: the KV pointer only ever names the NEWEST version,
so a slow actor that missed versions N..N+k jumps straight to N+k+1 —
it never replays intermediate versions.  The publisher keeps the last
``podracer_weight_keep_versions`` refs pinned (an in-flight pull of a
just-superseded version still completes); older refs drop and the
store reclaims them.

Wire format: params trees are flattened to ``(path, leaf)`` pairs by
sorted key walk (nested dicts — the flax params layout; the port's
weights are one flat dict of state-dict names, whose dots stay inside
one path component, so ``_unflatten`` gives the same flat dict back for
``load_weights``).  With ``podracer_weight_quantize`` each float leaf
ships as an Int8Codec wire buffer (util/collective/quant.py: ~4x fewer
bytes, blockmax/254 round-trip error); non-float leaves always ship
raw.
"""

from __future__ import annotations

import pickle
import time
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ray_tpu_torch._private import runtime_metrics as rtm
from ray_tpu_torch._private.config import CONFIG
from ray_tpu_torch.util.collective.quant import Int8Codec

_M_PUBLISH_MS = rtm.histogram(
    "ray_tpu_rl_weight_publish_ms",
    "Learner-side weight-version publish latency (flatten + encode + "
    "put + KV bump, ms).")
_M_PULL_MS = rtm.histogram(
    "ray_tpu_rl_weight_pull_ms",
    "Actor-side weight pull latency (striped get + decode, ms).")
_M_VERSIONS = rtm.counter(
    "ray_tpu_rl_weight_versions_total",
    "Weight versions published by podracer learners.")
_M_SKIPPED = rtm.counter(
    "ray_tpu_rl_weight_versions_skipped_total",
    "Weight versions a follower jumped past (the version-skip rule): "
    "slow actors adopt the newest version, never replaying missed ones.")


def _kv_key(name: str) -> str:
    return f"podracer/{name}/weights"


def _flatten(tree: Any, prefix: str = "") -> List[Tuple[str, np.ndarray]]:
    """Nested dict -> sorted (path, array) leaves; deterministic order so
    publisher and follower agree without shipping a treedef object."""
    if isinstance(tree, dict):
        out: List[Tuple[str, np.ndarray]] = []
        for k in sorted(tree):
            out.extend(_flatten(tree[k], f"{prefix}/{k}"))
        return out
    return [(prefix, np.asarray(tree))]


def _unflatten(leaves: List[Tuple[str, np.ndarray]]) -> Dict[str, Any]:
    root: Dict[str, Any] = {}
    for path, arr in leaves:
        parts = path.strip("/").split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = arr
    return root


def encode_weights(params: Any, *, quantize: Optional[bool] = None,
                   block: Optional[int] = None) -> Dict[str, Any]:
    """Params tree -> the payload dict a weight version stores."""
    if quantize is None:
        quantize = CONFIG.podracer_weight_quantize
    block = int(block or CONFIG.collective_quant_block)
    leaves = _flatten(params)
    if not quantize:
        return {"codec": None,
                "leaves": [(p, np.ascontiguousarray(a))
                           for p, a in leaves]}
    codec = Int8Codec(block)
    enc = []
    for path, arr in leaves:
        if arr.dtype.kind != "f":
            enc.append((path, None, arr.shape, arr.dtype.str,
                        np.ascontiguousarray(arr)))
            continue
        enc.append((path, "int8", arr.shape, arr.dtype.str,
                    codec.encode(arr.reshape(-1))))
    return {"codec": "int8", "block": block, "leaves": enc}


def decode_weights(payload: Dict[str, Any]) -> Dict[str, Any]:
    """Payload dict -> params tree (fresh arrays, never payload views)."""
    if payload.get("codec") is None:
        return _unflatten(payload["leaves"])
    codec = Int8Codec(int(payload["block"]))
    leaves = []
    for path, kind, shape, dtype, wire in payload["leaves"]:
        if kind is None:
            leaves.append((path, wire))
            continue
        nelem = int(np.prod(shape)) if shape else 1
        arr = codec.decode(wire, nelem, np.dtype(dtype)).reshape(shape)
        leaves.append((path, arr))
    return _unflatten(leaves)


def payload_nbytes(payload: Dict[str, Any]) -> int:
    """Broadcast bytes of one version (the bench's wire-savings row)."""
    total = 0
    for leaf in payload["leaves"]:
        total += int(np.asarray(leaf[-1]).nbytes)
    return total


class WeightPublisher:
    """Learner side: one put() + one KV bump per version."""

    def __init__(self, name: str, *, quantize: Optional[bool] = None,
                 block: Optional[int] = None,
                 keep_versions: Optional[int] = None):
        self.name = name
        self._quantize = (CONFIG.podracer_weight_quantize
                          if quantize is None else bool(quantize))
        self._block = int(block or CONFIG.collective_quant_block)
        keep = (CONFIG.podracer_weight_keep_versions
                if keep_versions is None else keep_versions)
        self._keep = max(1, int(keep))
        # version -> ref: holding the ref pins the object; dropping it
        # releases the store copy (version-skip makes that safe)
        self._refs: "OrderedDict[int, Any]" = OrderedDict()
        self.version = 0
        self.last_payload_nbytes = 0

    def publish(self, params: Any) -> int:
        import ray_tpu_torch
        from ray_tpu_torch.experimental.internal_kv import _internal_kv_put
        t0 = time.perf_counter()
        payload = encode_weights(params, quantize=self._quantize,
                                 block=self._block)
        self.last_payload_nbytes = payload_nbytes(payload)
        ref = ray_tpu_torch.put(payload)
        self.version += 1
        self._refs[self.version] = ref
        while len(self._refs) > self._keep:
            self._refs.popitem(last=False)
        record = {"version": self.version, "ref": ref,
                  "nbytes": self.last_payload_nbytes,
                  "published_ts": time.time()}
        _internal_kv_put(_kv_key(self.name), pickle.dumps(record))
        _M_PUBLISH_MS.observe((time.perf_counter() - t0) * 1000.0)
        _M_VERSIONS.inc()
        return self.version

    def clear(self) -> None:
        from ray_tpu_torch.experimental.internal_kv import _internal_kv_del
        self._refs.clear()
        try:
            _internal_kv_del(_kv_key(self.name))
        except Exception:
            pass


class WeightFollower:
    """Actor side: poll the KV pointer, pull striped on a version bump."""

    def __init__(self, name: str, *, pull_timeout_s: float = 60.0):
        self.name = name
        self.version = 0
        self.versions_skipped = 0
        self.last_pull_ms = 0.0
        self._pull_timeout_s = float(pull_timeout_s)

    def poll(self) -> Optional[Tuple[Dict[str, Any], int]]:
        """(params, version) when a newer version exists, else None."""
        import ray_tpu_torch
        from ray_tpu_torch.experimental.internal_kv import _internal_kv_get
        raw = _internal_kv_get(_kv_key(self.name))
        if not raw:
            return None
        record = pickle.loads(raw)
        version = int(record["version"])
        if version <= self.version:
            return None
        t0 = time.perf_counter()
        payload = ray_tpu_torch.get(record["ref"],
                                    timeout=self._pull_timeout_s)
        params = decode_weights(payload)
        self.last_pull_ms = (time.perf_counter() - t0) * 1000.0
        _M_PULL_MS.observe(self.last_pull_ms)
        if self.version > 0 and version > self.version + 1:
            skipped = version - self.version - 1
            self.versions_skipped += skipped
            _M_SKIPPED.inc(skipped)
        self.version = version
        return params, version
