"""Prompt-prefix digests and the router-side prefix-affinity index.

Two cooperating halves share the digest contract defined here
(docs/serve_frontdoor.md):

- the paged LLM engine (serve/llm_engine.py) retains full prompt pages
  after prefill keyed by the CHAINED per-page digest of the tokens they
  hold, and advertises the resident boundary digests on the controller
  load-publish path;
- routers (serve/handle.py DisaggHandle, and through it the HTTP front
  door) compute the same chain over an incoming prompt, walk it
  deepest-first against the advertised index, and pin the prefill hop
  to a replica that can skip re-prefilling the shared prefix.

The chain is ``d_0 = H(tok[0:ps])``, ``d_i = H(d_{i-1} || tok[i*ps :
(i+1)*ps])`` over FULL pages only — a boundary digest therefore names
the page-aligned token prefix exactly, and matching ``d_i`` anywhere
implies the whole prefix up to page ``i`` matches.  No jax imports:
this module runs in proxies and driver handles.
"""

from __future__ import annotations

import hashlib
import threading
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Set

from ray_tpu_torch._private import runtime_metrics as rtm

_M_PREFIX_HIT = rtm.counter_family(
    "ray_tpu_serve_prefix_hit",
    "Router prefix-affinity lookups by outcome: hit (pinned to an "
    "advertising replica), miss (no advertised prefix), evicted (the "
    "index knew the digest but no advertising replica remains).",
    tag_keys=("outcome",))

_DIGEST_BYTES = 16


def page_digests(tokens: Sequence[int], page_size: int) -> List[str]:
    """Chained per-page digest boundaries of ``tokens`` (hex), full
    pages only.  ``page_digests(t, ps)[i]`` names ``t[:(i+1)*ps]``."""
    if page_size <= 0:
        return []
    out: List[str] = []
    prev = b""
    for i in range(len(tokens) // page_size):
        m = hashlib.blake2b(prev, digest_size=_DIGEST_BYTES)
        for t in tokens[i * page_size:(i + 1) * page_size]:
            m.update(int(t).to_bytes(8, "little", signed=True))
        prev = m.digest()
        out.append(prev.hex())
    return out


def record_outcome(outcome: str) -> None:
    """Count a lookup outcome on ray_tpu_serve_prefix_hit{outcome}."""
    _M_PREFIX_HIT.inc(outcome)


class PrefixIndex:
    """Bounded digest -> replica-set map fed from published targets.

    ``update(deployment_prefixes)`` replaces each replica's advertised
    digest set (the controller publishes the full current set every
    reply, like loads); ``lookup(chain, live)`` walks a prompt's chain
    deepest-first and returns the advertising replica still in the
    live routing set.  LRU-bounded at ``max_entries`` digests — the
    advertisement path is already bounded per replica, this caps the
    union across a large pool."""

    def __init__(self, max_entries: int = 4096):
        self.max_entries = max(1, int(max_entries))
        self._lock = threading.Lock()
        # digest -> {replica_tag, ...}; OrderedDict for LRU rotation
        self._index: "OrderedDict[str, Set[str]]" = OrderedDict()
        self._by_replica: Dict[str, Set[str]] = {}

    def update(self, replica: str, digests: Sequence[str]) -> None:
        new = set(digests or ())
        with self._lock:
            old = self._by_replica.get(replica, set())
            for d in old - new:
                holders = self._index.get(d)
                if holders is not None:
                    holders.discard(replica)
                    if not holders:
                        self._index.pop(d, None)
            for d in new - old:
                holders = self._index.get(d)
                if holders is None:
                    holders = self._index[d] = set()
                holders.add(replica)
            if new:
                self._by_replica[replica] = new
            else:
                self._by_replica.pop(replica, None)
            while len(self._index) > self.max_entries:
                d, holders = self._index.popitem(last=False)
                for r in holders:
                    owned = self._by_replica.get(r)
                    if owned is not None:
                        owned.discard(d)

    def drop_replica(self, replica: str) -> None:
        self.update(replica, ())

    def lookup(self, chain: Sequence[str],
               live: Optional[Set[str]] = None) -> Optional[str]:
        """Deepest advertising replica for ``chain``, restricted to
        ``live`` replica tags when given.  Counts the outcome on the
        ray_tpu_serve_prefix_hit metric family: ``evicted`` means the
        digest was known but every advertising replica has left the
        routing set — the affinity decayed under churn, not a miss."""
        known_dead = False
        with self._lock:
            for d in reversed(chain or ()):
                holders = self._index.get(d)
                if not holders:
                    continue
                pick = None
                for r in holders:
                    if live is None or r in live:
                        pick = r
                        break
                if pick is not None:
                    self._index.move_to_end(d)
                    record_outcome("hit")
                    return pick
                known_dead = True
        record_outcome("evicted" if known_dead else "miss")
        return None

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"digests": len(self._index),
                    "replicas": len(self._by_replica)}
