"""Debug-mode shm-ring protocol checker (``RAY_TPU_TORCH_DEBUG_CHANNELS=1``).

The ``experimental/channel.py`` rings are correct only under three
disciplines that nothing enforces at runtime:

* **single writer** — exactly one ``ChannelWriter`` instance ever
  publishes into a given ring (per-slot seq words have one writer);
* **seq-word-last** — the writer publishes payload, then ``len`` /
  ``flags``, then ``seq`` LAST, so a reader that observes ``seq ==
  k+1`` sees a complete item (x86-TSO store ordering);
* **cumulative in-order acks** — reader ``r`` publishes ``acks[r] =
  k+1`` exactly once per item, in consume order (acking ``k+1`` before
  ``k`` would release ``k``'s slot early).

A violation of any of these corrupts items *silently* — the consumer
deserializes garbage long after the racing write retired.  With the
debug gate on, ``channel.py`` calls the checks below on every publish
and ack and the FIRST protocol break raises ``ChannelProtocolError``
naming the slot and the expected/observed control words.

The writer claim rides the channel header's reserved word at offset 32:
each ``ChannelWriter`` instance mints a random nonzero 64-bit identity
and stamps it on first publish; a different instance (same process or
not — the header is shared memory) publishing later trips the check.
"""

from __future__ import annotations

import os
import random
import struct

from ray_tpu_torch._private.config import CONFIG

# module-local RNG reseeded after fork (the tracing_helper idiom):
# zygote-forked prefork workers share the global MT state, and two
# forked writers minting IDENTICAL ids would make the single-writer
# claim check vacuously pass for the exact cross-process bug it exists
# to catch.  The pid is mixed in as a belt-and-suspenders layer.
_id_rng = random.Random()
if hasattr(os, "register_at_fork"):  # pragma: no branch
    os.register_at_fork(after_in_child=_id_rng.seed)

_U64 = struct.Struct("<Q")
# header offset of the debug writer-claim word (reserved range 32..64
# in the channel layout; zero = unclaimed, matching create()'s zeroing)
CLAIM_OFF = 32

__all__ = ["ChannelProtocolError", "enabled", "writer_id",
           "check_publish", "check_ack"]


class ChannelProtocolError(RuntimeError):
    """Single-writer / seq-word / ack discipline violated on a ring."""


def enabled() -> bool:
    """Debug gate: RAY_TPU_TORCH_DEBUG_CHANNELS env wins via the config
    resolution of the ``debug_channels`` flag."""
    return CONFIG.debug_channels


def writer_id() -> int:
    """A fresh nonzero 64-bit writer identity (per ChannelWriter)."""
    return ((_id_rng.getrandbits(63) ^ (os.getpid() << 32)) & (2**63 - 1)) | 1


def check_publish(ch, k: int, wid: int) -> None:
    """Before writer publishes item ``k``: claim the ring and verify
    the slot's previous tenant is exactly the item the protocol says it
    must be."""
    view = ch._view
    claimed = _U64.unpack_from(view, CLAIM_OFF)[0]
    if claimed == 0:
        _U64.pack_into(view, CLAIM_OFF, wid)
    elif claimed != wid:
        raise ChannelProtocolError(
            f"channel {ch.oid.hex()[:12]}: second writer (claim word "
            f"{claimed:#x} != this writer {wid:#x}) — a ring has "
            f"exactly ONE ChannelWriter for its lifetime")
    off = ch._slot_off(k)
    seq = _U64.unpack_from(view, off)[0]
    expect = k + 1 - ch.nslots if k >= ch.nslots else 0
    if seq != expect:
        raise ChannelProtocolError(
            f"channel {ch.oid.hex()[:12]} slot {k % ch.nslots}: seq "
            f"word is {seq} before publishing item {k} (expected "
            f"{expect}) — concurrent writer or seq reuse")


def check_read(ch, k: int, size: int) -> None:
    """When a reader observes ``seq == k+1``: a len word past the slot
    capacity means the writer stamped seq before the payload metadata
    (seq-word-last violated) or the write tore."""
    if size > ch.capacity:
        raise ChannelProtocolError(
            f"channel {ch.oid.hex()[:12]} slot {k % ch.nslots}: len "
            f"{size} exceeds capacity {ch.capacity} under seq {k + 1} "
            f"— seq published before len (seq-word-last violated) or "
            f"torn write")


def check_ack(ch, idx: int, want: int) -> None:
    """Before reader ``idx`` publishes ``acks[idx] = want``: the
    previous value must be exactly ``want - 1`` (cumulative, in-order,
    exactly-once)."""
    cur = _U64.unpack_from(ch._view, ch._acks_off + 8 * idx)[0]
    if cur != want - 1:
        raise ChannelProtocolError(
            f"channel {ch.oid.hex()[:12]} reader {idx}: acking item "
            f"{want} but ack word is {cur} (expected {want - 1}) — "
            f"out-of-order or double ack")
