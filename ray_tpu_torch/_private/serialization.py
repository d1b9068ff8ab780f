"""Object serialization: pickle-5 with out-of-band buffers.

Analog of the reference's SerializationContext
(/root/reference/python/ray/_private/serialization.py:92; out-of-band buffer
handling at :191-204).  Wire format of a serialized object:

    [u32 meta_len][meta: u32 nbuf, u64 plen, u32 err, u64 lens[nbuf]]
    [pickled payload] [buf0][buf1]...

Large contiguous buffers (numpy arrays, bytes, tensors) are carried
out-of-band via ``pickle.protocol=5`` buffer callbacks, so a store ``get``
can reconstruct numpy arrays and CPU tensors as zero-copy views over shared
memory.  A ``torch.Tensor`` on any device arrives as a CPU tensor with the
same dtype, shape and bits (device tensors never transit the object store
as device memory: the receiver moves it where it needs it).  Dtypes numpy
lacks (bf16, the fp8 types) travel as their same-width integer view and are
viewed back on arrival.
"""

from __future__ import annotations

import pickle
import struct
from typing import Any, List, Tuple

from ray_tpu_torch import cloudpickle

_HEADER = struct.Struct("<I")
# the meta block's fixed part: buffer count, payload length, error type;
# the buffers' lengths follow as u64s
_META = struct.Struct("<IQI")

# Error sentinel types stored as object payloads (cf. reference RayError
# hierarchy, python/ray/exceptions.py).
ERROR_TASK = 1
ERROR_ACTOR_DIED = 2
ERROR_WORKER_DIED = 3
ERROR_OBJECT_LOST = 4
ERROR_TASK_CANCELLED = 5
ERROR_OOM = 6


# numpy dtypes a tensor converts to as it is; any other dtype (bf16, the
# fp8 types, complex32) travels as the integer view of its width
_NUMPY_DTYPES = ("float64", "float32", "float16", "int64", "int32", "int16",
                 "int8", "uint8", "bool", "complex64", "complex128")
_RAW_VIEW = {1: "uint8", 2: "int16", 4: "int32", 8: "int64"}


def _tensor_from_array(arr, dtype: str, shape, parameter: bool,
                       requires_grad: bool):
    import torch
    if not arr.flags.writeable:
        # inline or transferred bytes: torch has no read-only tensors
        arr = arr.copy()
    t = torch.from_numpy(arr)
    if dtype not in _NUMPY_DTYPES:
        t = t.view(getattr(torch, dtype))
    t = t.view(shape)
    if parameter:
        return torch.nn.Parameter(t, requires_grad=requires_grad)
    return t


def _reduce_tensor(t):
    """A strided tensor -> its bytes as a flat numpy array (out of band)."""
    import torch
    if t.layout != torch.strided or t.is_quantized:
        return NotImplemented
    dtype = str(t.dtype).removeprefix("torch.")
    flat = t.detach().to("cpu").contiguous().reshape(-1)
    if dtype not in _NUMPY_DTYPES:
        raw = _RAW_VIEW.get(flat.element_size())
        if raw is None:
            return NotImplemented
        flat = flat.view(getattr(torch, raw))
    return (_tensor_from_array,
            (flat.numpy(), dtype, tuple(t.shape),
             isinstance(t, torch.nn.Parameter), t.requires_grad))


class _Pickler(cloudpickle.CloudPickler):
    def __init__(self, file, buffers: List[pickle.PickleBuffer]):
        super().__init__(file, protocol=5,
                         buffer_callback=lambda b: buffers.append(b) or False)

    def reducer_override(self, obj):
        # Tensors -> host numpy before pickling.  The numpy array is
        # handed back to *this* pickler so its buffer rides out-of-band.
        tn = type(obj).__module__
        if tn == "torch" or tn.startswith("torch."):
            import torch
            if isinstance(obj, torch.Tensor):
                return _reduce_tensor(obj)
        # cloudpickle's own override pickles dynamic functions and
        # classes by value
        return super().reducer_override(obj)


def serialize(value: Any, error_type: int = 0) -> Tuple[bytes, List[memoryview]]:
    """Returns (header_and_payload, out_of_band_buffers)."""
    import io
    buffers: List[pickle.PickleBuffer] = []
    f = io.BytesIO()
    _Pickler(f, buffers).dump(value)
    payload = f.getvalue()
    views = [b.raw() for b in buffers]
    lens = [len(v) for v in views]
    meta = _META.pack(len(views), len(payload), error_type) + \
        struct.pack(f"<{len(lens)}Q", *lens)
    head = _HEADER.pack(len(meta)) + meta
    return head + payload, views


def serialized_size(head_payload: bytes, views: List[memoryview]) -> int:
    return len(head_payload) + sum(len(v) for v in views)


def to_flat_bytes(head_payload: bytes, views: List[memoryview]) -> bytes:
    out = bytearray(head_payload)
    for v in views:
        out += v
    return bytes(out)


def write_into(buf: memoryview, head_payload: bytes, views: List[memoryview]) -> int:
    """Write the full serialized object into a preallocated buffer."""
    off = len(head_payload)
    buf[:off] = head_payload
    for v in views:
        n = len(v)
        buf[off:off + n] = v
        off += n
    return off


def deserialize(buf: memoryview | bytes) -> Any:
    """Reconstruct from one contiguous buffer; numpy views stay zero-copy."""
    return deserialize_with_viewinfo(buf)[0]


def deserialize_with_viewinfo(buf: memoryview | bytes) -> Tuple[Any, bool]:
    """Reconstruct from one contiguous buffer; returns (value,
    holds_views).  ``holds_views`` is True when the payload carried
    out-of-band buffers — the deserialized value (numpy arrays etc.) may
    hold zero-copy views into ``buf``, so a shared-memory caller must
    keep the segment pinned; when False the value is self-contained and
    the pin can be released immediately."""
    buf = memoryview(buf)
    (meta_len,) = _HEADER.unpack(bytes(buf[:_HEADER.size]))
    off = _HEADER.size
    nbuf, plen, err = _META.unpack_from(buf, off)
    lens = struct.unpack_from(f"<{nbuf}Q", buf, off + _META.size)
    off += meta_len
    payload = buf[off:off + plen]
    off += plen
    oob = []
    for n in lens:
        oob.append(buf[off:off + n])
        off += n
    value = pickle.loads(payload, buffers=oob)
    if err:
        raise value
    return value, bool(lens)


def error_type_of(buf: memoryview | bytes) -> int:
    return _META.unpack_from(memoryview(buf), _HEADER.size)[2]
