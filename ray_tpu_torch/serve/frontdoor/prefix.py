"""Prompt-prefix digests (a copy of ``page_digests`` from
ray_tpu/serve/frontdoor/prefix.py).

The paged engine retains full prompt pages keyed by the CHAINED per-page
digest of the tokens they hold, and routers compute the same chain over
an incoming prompt, so the digests must equal the JAX package's byte for
byte.  The chain is ``d_0 = H(tok[0:ps])``, ``d_i = H(d_{i-1} ||
tok[i*ps:(i+1)*ps])`` over FULL pages only, with H blake2b of 16 bytes
and each token as 8 little-endian signed bytes: a boundary digest names
the page-aligned token prefix exactly.
"""

from __future__ import annotations

import hashlib
from typing import List, Sequence

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
