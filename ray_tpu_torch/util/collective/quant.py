"""Wire codecs for the DCN collective plane (docs/collective.md).

EQuARX-style block-scaled int8 quantization (arXiv:2506.17615): each
wire segment is encoded as one int8 value per element plus one fp32
scale per ``block`` elements, cutting ring traffic ~4x for fp32
tensors (wire = n + 4*ceil(n/block) bytes vs 4n).  Accumulation stays
in the caller's fp32 master buffer — the codec only touches bytes that
cross a link, so numerics degrade by a bounded per-hop rounding error
instead of drifting with tensor magnitude.

Numerics contract (the bound the tier-1 gate asserts): one
encode/decode round trip perturbs each element by at most
``blockmax / 254`` (symmetric round-to-nearest over 255 int8 steps,
``blockmax`` = max |x| over the element's block).  A ring allreduce
re-encodes each partial sum once per reduce-scatter hop and encodes
the final value once for allgather (forwarded hops ship the encoded
bytes verbatim), so the end-to-end absolute error per element is
bounded by ``world_size * max_running_blockmax / 254`` — relative to
the reduced block max, roughly ``world_size / 254``.

The wire layout is self-describing to both endpoints WITHOUT a header:
every link pair derives identical segmentation (`_chunk_bounds` +
segment size), so the element count and dtype are known at decode time.

    [ fp32 scales: 4 * nblocks bytes | int8 payload: nelem bytes ]
"""

from __future__ import annotations

from typing import Optional

import numpy as np


class Int8Codec:
    """Block-scaled symmetric int8 wire codec for float tensors."""

    name = "int8"

    def __init__(self, block: int = 256):
        self.block = max(1, int(block))

    def nblocks(self, nelem: int) -> int:
        return -(-nelem // self.block)

    def wire_nbytes(self, nelem: int) -> int:
        """Encoded size of an ``nelem``-element segment — deterministic,
        so the receiver can pre-size its staging buffer (TCP recv_into
        needs an exact-length sink)."""
        return 4 * self.nblocks(nelem) + nelem

    def encode(self, arr: np.ndarray) -> np.ndarray:
        """fp32/fp64 segment -> uint8 wire buffer (fresh array)."""
        n = arr.size
        nb = self.nblocks(n)
        pad = nb * self.block - n
        x = np.asarray(arr, np.float32).reshape(-1)
        if pad:
            x = np.concatenate([x, np.zeros(pad, np.float32)])
        blocks = x.reshape(nb, self.block)
        scale = np.max(np.abs(blocks), axis=1) / 127.0
        # all-zero blocks: scale 1.0 encodes/decodes exact zeros
        safe = np.where(scale > 0.0, scale, np.float32(1.0))
        q = np.rint(blocks / safe[:, None]).astype(np.int8)
        wire = np.empty(4 * nb + n, np.uint8)
        wire[:4 * nb] = safe.astype(np.float32).view(np.uint8)
        wire[4 * nb:] = q.reshape(-1)[:n].view(np.uint8)
        return wire

    def decode(self, wire: np.ndarray, nelem: int,
               dtype=np.float32,
               out: Optional[np.ndarray] = None) -> np.ndarray:
        """uint8 wire buffer -> ``nelem`` decoded elements.  ``wire``
        may view transport storage (shm ring slot / staging buffer):
        the result is always fresh (or ``out``), never a view."""
        nb = self.nblocks(nelem)
        w = np.asarray(wire, np.uint8).reshape(-1)
        scale = w[:4 * nb].view(np.float32)
        q = w[4 * nb:4 * nb + nelem].view(np.int8)
        pad = nb * self.block - nelem
        if pad:
            q = np.concatenate([q, np.zeros(pad, np.int8)])
        vals = (q.reshape(nb, self.block).astype(np.float32)
                * scale[:, None]).reshape(-1)[:nelem]
        if out is not None:
            np.copyto(out, vals.astype(dtype, copy=False))
            return out
        return vals.astype(dtype, copy=False)


_CODECS = {"int8": Int8Codec}


def get_codec(quantize: Optional[str], block: int):
    """Resolve a ``quantize=`` argument to a codec instance (None passes
    through — the fp32 plane is untouched)."""
    if quantize is None:
        return None
    cls = _CODECS.get(quantize)
    if cls is None:
        raise ValueError(
            f"unknown collective wire codec {quantize!r} "
            f"(supported: {sorted(_CODECS)})")
    return cls(block)
