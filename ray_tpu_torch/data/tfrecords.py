"""TFRecord datasource: read/write tf.train.Example without TensorFlow
(the port's copy of ray_tpu/data/tfrecords.py).

Analog of Ray's python/ray/data/datasource/tfrecords_datasource.py
— but that one calls into tensorflow/pyarrow readers; this image has no
tensorflow, so both layers are implemented directly:

  - TFRecord framing: ``u64 length | u32 masked-crc32c(length) | payload
    | u32 masked-crc32c(payload)`` per record.
  - tf.train.Example: a fixed, tiny protobuf schema
    (Example -> Features -> map<string, Feature> ->
    bytes_list|float_list|int64_list), decoded/encoded with a minimal
    wire-format codec below — the fixed shape needs varints, length-
    delimited fields, and little-endian floats, nothing more.

Rows decode to {feature_name: scalar-or-list} dicts; singleton lists
unwrap to scalars (the reference's behavior).
"""

from __future__ import annotations

import struct
from typing import Any, Dict, Iterator, List

import numpy as np

# ----------------------------------------------------------------- crc32c
_CRC_TABLE = []


def _crc_table():
    global _CRC_TABLE
    if not _CRC_TABLE:
        poly = 0x82F63B78            # Castagnoli, reflected
        table = []
        for n in range(256):
            c = n
            for _ in range(8):
                c = (c >> 1) ^ poly if c & 1 else c >> 1
            table.append(c)
        _CRC_TABLE = table
    return _CRC_TABLE


def crc32c(data: bytes) -> int:
    table = _crc_table()
    crc = 0xFFFFFFFF
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return ((crc >> 15 | crc << 17) + 0xA282EAD8) & 0xFFFFFFFF


# ------------------------------------------------- protobuf wire helpers
def _read_varint(buf: bytes, pos: int):
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _write_varint(out: bytearray, value: int) -> None:
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def _iter_fields(buf: bytes) -> Iterator[tuple]:
    """(field_number, wire_type, value) over one message's bytes."""
    pos = 0
    n = len(buf)
    while pos < n:
        key, pos = _read_varint(buf, pos)
        field, wt = key >> 3, key & 7
        if wt == 0:                      # varint
            val, pos = _read_varint(buf, pos)
        elif wt == 1:                    # fixed64
            val = buf[pos:pos + 8]
            pos += 8
        elif wt == 2:                    # length-delimited
            ln, pos = _read_varint(buf, pos)
            val = buf[pos:pos + ln]
            pos += ln
        elif wt == 5:                    # fixed32
            val = buf[pos:pos + 4]
            pos += 4
        else:
            raise ValueError(f"unsupported protobuf wire type {wt}")
        yield field, wt, val


def _ld(field: int, payload: bytes) -> bytes:
    out = bytearray()
    _write_varint(out, field << 3 | 2)
    _write_varint(out, len(payload))
    return bytes(out) + payload


# ------------------------------------------------------ Example codec
def decode_example(buf: bytes) -> Dict[str, Any]:
    features = b""
    for field, _wt, val in _iter_fields(buf):      # Example
        if field == 1:
            features = val
    out: Dict[str, Any] = {}
    for field, _wt, entry in _iter_fields(features):   # Features.feature
        if field != 1:
            continue
        name = b""
        feat = b""
        for f2, _w2, v2 in _iter_fields(entry):        # map entry
            if f2 == 1:
                name = v2
            elif f2 == 2:
                feat = v2
        out[name.decode()] = _decode_feature(feat)
    return out


def _decode_feature(buf: bytes):
    for field, _wt, val in _iter_fields(buf):          # Feature oneof
        if field == 1:                                 # BytesList
            items = [v for f, _w, v in _iter_fields(val) if f == 1]
            return items[0] if len(items) == 1 else items
        if field == 2:                                 # FloatList
            floats: List[float] = []
            for f, w, v in _iter_fields(val):
                if f != 1:
                    continue
                if w == 2:                             # packed
                    floats.extend(struct.unpack(
                        f"<{len(v) // 4}f", v))
                else:                                  # unpacked fixed32
                    floats.append(struct.unpack("<f", v)[0])
            return floats[0] if len(floats) == 1 else floats
        if field == 3:                                 # Int64List
            ints: List[int] = []
            for f, w, v in _iter_fields(val):
                if f != 1:
                    continue
                if w == 2:                             # packed varints
                    pos = 0
                    while pos < len(v):
                        x, pos = _read_varint(v, pos)
                        ints.append(_signed64(x))
                else:
                    ints.append(_signed64(v))
            return ints[0] if len(ints) == 1 else ints
    return None


def _signed64(x: int) -> int:
    return x - (1 << 64) if x >= (1 << 63) else x


def encode_example(row: Dict[str, Any]) -> bytes:
    entries = b""
    for name, value in row.items():
        feat = _encode_feature(value)
        entry = _ld(1, name.encode()) + _ld(2, feat)
        entries += _ld(1, entry)
    return _ld(1, entries)                             # Example.features


def _encode_feature(value) -> bytes:
    if isinstance(value, np.ndarray):
        value = value.tolist()
    items = value if isinstance(value, (list, tuple)) else [value]
    if not items:
        return _ld(3, b"")                             # empty Int64List
    first = items[0]
    if isinstance(first, bytes):
        payload = b"".join(_ld(1, b) for b in items)
        return _ld(1, payload)                         # BytesList
    if isinstance(first, str):
        payload = b"".join(_ld(1, s.encode()) for s in items)
        return _ld(1, payload)
    if isinstance(first, (bool, int, np.integer)):
        packed = bytearray()
        for i in items:
            _write_varint(packed, int(i) & ((1 << 64) - 1))
        return _ld(3, _ld(1, bytes(packed)))           # Int64List packed
    if isinstance(first, (float, np.floating)):
        packed = struct.pack(f"<{len(items)}f",
                             *[float(f) for f in items])
        return _ld(2, _ld(1, packed))                  # FloatList packed
    raise TypeError(
        f"tf.train.Example features hold bytes/str/int/float "
        f"(lists thereof); got {type(first).__name__}")


# -------------------------------------------------------- file framing
def read_tfrecord_file(path_or_file) -> List[Dict[str, Any]]:
    close = False
    f = path_or_file
    if isinstance(path_or_file, str):
        f = open(path_or_file, "rb")
        close = True
    rows = []
    try:
        while True:
            head = f.read(12)
            if len(head) < 12:
                break
            (length,) = struct.unpack("<Q", head[:8])
            (crc,) = struct.unpack("<I", head[8:])
            if crc != _masked_crc(head[:8]):
                raise ValueError("tfrecord length crc mismatch "
                                 "(corrupt or not a TFRecord file)")
            payload = f.read(length)
            (pcrc,) = struct.unpack("<I", f.read(4))
            if pcrc != _masked_crc(payload):
                raise ValueError("tfrecord payload crc mismatch")
            rows.append(decode_example(payload))
    finally:
        if close:
            f.close()
    return rows


def _write_tfrecord_stream(f, rows) -> int:
    n = 0
    for row in rows:
        payload = encode_example(row)
        head = struct.pack("<Q", len(payload))
        f.write(head)
        f.write(struct.pack("<I", _masked_crc(head)))
        f.write(payload)
        f.write(struct.pack("<I", _masked_crc(payload)))
        n += 1
    return n


def write_tfrecord_file(path: str, rows) -> int:
    with open(path, "wb") as f:
        return _write_tfrecord_stream(f, rows)


# ----------------------------------------------------------- datasource
def tfrecord_tasks(paths, partitioning=None, partition_filter=None):
    from ray_tpu_torch.data.datasource import (ReadTask, _expand_paths,
                                               _is_remote, _open)
    from ray_tpu_torch.data.partitioning import (add_partition_columns,
                                                 apply_partitioning)
    # accept both .tfrecord and .tfrecords file extensions
    files = [f for f in _expand_paths(paths)
             if ".tfrecord" in f or f in (paths if isinstance(paths, list)
                                          else [paths])]
    files, values = apply_partitioning(files, partitioning,
                                       partition_filter)

    def read_one(path: str, vals):
        rows = read_tfrecord_file(
            _open(path) if _is_remote(path) else path)
        if vals:
            rows = [dict(r, **{k: v for k, v in vals.items()
                               if k not in r}) for r in rows]
        return rows

    return [ReadTask(lambda p=f, v=(values[i] if values else None):
                     read_one(p, v), input_files=[f])
            for i, f in enumerate(files)]


def write_tfrecords_block(block, path: str, idx: int) -> str:
    import io

    from ray_tpu_torch.data.block import BlockAccessor
    from ray_tpu_torch.data.datasource import _out_target, _storage
    local, uri = _out_target(path, f"part-{idx:05d}.tfrecords")
    rows = (_rowdict(r) for r in BlockAccessor.for_block(block).iter_rows())
    if local is not None:
        write_tfrecord_file(local, rows)
        return local
    buf = io.BytesIO()
    _write_tfrecord_stream(buf, rows)
    _storage.write_bytes(uri, buf.getvalue())
    return uri


def _rowdict(row) -> Dict[str, Any]:
    if isinstance(row, dict):
        return row
    if hasattr(row, "_asdict"):
        return row._asdict()
    if hasattr(row, "to_dict"):
        return row.to_dict()
    raise TypeError(
        f"tfrecords need dict-like rows, got {type(row).__name__}")
