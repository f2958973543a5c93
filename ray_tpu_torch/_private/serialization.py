"""Serialization: cloudpickle in-band + pickle-5 out-of-band zero-copy buffers.

Equivalent of the reference's ``python/ray/_private/serialization.py``
(``SerializationContext``): values are cloudpickled with protocol 5 so large
contiguous buffers (numpy arrays, torch tensors, bytes) are emitted
out-of-band and can live in shared memory without a copy on the read side.
ObjectRefs and ActorHandles found inside a value are swapped for lightweight
descriptors at pickle time and rehydrated at unpickle time, and the set of
contained refs is recorded so the owner can keep them alive (the reference's
contained-ref tracking, ``serialization.py:183-192``).

Torch tensors (port of ``ray_tpu/_private/serialization.py``, which has
no tensor path of its own): a strided ``torch.Tensor`` or ``nn.Parameter``
on the CPU or on a CUDA device crosses as its raw bytes in ONE out-of-band
buffer (so a large one lands in shared memory like a numpy array), with
its dtype by name (bfloat16 included, which numpy lacks), shape, device
type and ``requires_grad``. A CUDA tensor comes back on the reader's
current CUDA device; a reader without CUDA gets an error naming the
device, never a CPU tensor (torch's own unpickling rule). A CPU tensor
comes back as a contiguous tensor that owns its memory.

Each tensor object crosses as its own copy, as torch's own pickling (which
JAX's runtime uses for the same values) gives: the same tensor object
twice in one value comes back as one object, but two views of one
storage, or tied weights that are distinct tensor objects, come back as
tensors that share no memory. Sparse, quantized, conjugate- or
negative-bit tensors and tensors of other devices take torch's own
pickling. torch is imported only where a value is a tensor, so a process
that never meets one never imports it.
"""

from __future__ import annotations

import io
import pickle
import struct
import sys
import warnings
from typing import Any, Callable, List, Tuple

import cloudpickle

# Header layout of a serialized payload:
#   u32 metadata_len | metadata(pickled in-band bytes) | u32 nbuffers |
#   [u64 buffer_len | buffer bytes] * nbuffers
_U32 = struct.Struct("<I")
_U64 = struct.Struct("<Q")


class SerializedObject:
    """A serialized value: in-band pickle bytes + out-of-band buffers."""

    __slots__ = ("inband", "buffers", "contained_refs")

    def __init__(self, inband: bytes, buffers: List[memoryview], contained_refs):
        self.inband = inband
        self.buffers = buffers
        self.contained_refs = contained_refs

    def total_bytes(self) -> int:
        return (
            _U32.size * 2
            + len(self.inband)
            + sum(_U64.size + len(b) for b in self.buffers)
        )

    def write_to(self, buf: memoryview) -> int:
        """Pack into a contiguous writable buffer; returns bytes written."""
        off = 0
        buf[off : off + 4] = _U32.pack(len(self.inband)); off += 4
        buf[off : off + len(self.inband)] = self.inband; off += len(self.inband)
        buf[off : off + 4] = _U32.pack(len(self.buffers)); off += 4
        for b in self.buffers:
            n = len(b)
            buf[off : off + 8] = _U64.pack(n); off += 8
            buf[off : off + n] = b; off += n
        return off

    def to_bytes(self) -> bytes:
        out = bytearray(self.total_bytes())
        self.write_to(memoryview(out))
        return bytes(out)


def unpack_payload(buf: memoryview) -> Tuple[bytes, List[memoryview]]:
    """Split a packed payload back into (inband, buffers) with zero copies."""
    off = 0
    (n_inband,) = _U32.unpack(buf[off : off + 4]); off += 4
    inband = bytes(buf[off : off + n_inband]); off += n_inband
    (nbuf,) = _U32.unpack(buf[off : off + 4]); off += 4
    buffers: List[memoryview] = []
    for _ in range(nbuf):
        (n,) = _U64.unpack(buf[off : off + 8]); off += 8
        buffers.append(buf[off : off + n]); off += n
    return inband, buffers


_TENSOR_DEVICES = ("cpu", "cuda")


def _reduce_tensor(t):
    """Reducer of a CPU or CUDA tensor: its bytes out-of-band."""
    import torch

    host = t.detach()
    if host.device.type != "cpu":
        host = host.cpu()
    host = host.contiguous()
    raw = host.reshape(-1).view(torch.uint8).numpy() if host.numel() else b""
    return (_rebuild_tensor,
            (pickle.PickleBuffer(raw), str(t.dtype).split(".")[-1],
             tuple(t.shape), t.device.type, t.requires_grad,
             isinstance(t, torch.nn.Parameter)))


def _rebuild_tensor(buf, dtype_name: str, shape, device_type: str,
                    requires_grad: bool, is_parameter: bool):
    import torch

    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"a tensor of shape {tuple(shape)} was put on a CUDA device, and "
            f"this process has no CUDA device to read it onto")
    dtype = getattr(torch, dtype_name)
    view = memoryview(buf)
    if view.nbytes:
        with warnings.catch_warnings():
            # the buffer may be a read-only shared-memory mapping: the
            # tensor over it is only read, then copied
            warnings.simplefilter("ignore", UserWarning)
            flat = torch.frombuffer(view, dtype=torch.uint8)
        t = flat.view(dtype).reshape(shape)
    else:
        t = torch.empty(shape, dtype=dtype)
    if device_type == "cuda":
        t = t.to(torch.device("cuda", torch.cuda.current_device()))
    else:
        t = t.clone()
    if is_parameter:
        return torch.nn.Parameter(t, requires_grad=requires_grad)
    return t.requires_grad_(requires_grad)


def _is_plain_tensor(obj) -> bool:
    """A tensor whose elements are its strided bytes, on the CPU or CUDA."""
    torch = sys.modules.get("torch")
    return (torch is not None
            and type(obj) in (torch.Tensor, torch.nn.Parameter)
            and obj.layout == torch.strided
            and obj.device.type in _TENSOR_DEVICES
            and not (obj.is_quantized or obj.is_conj() or obj.is_neg()))


class SerializationContext:
    """Per-worker serializer with ref/handle reducers.

    ``ref_reducer`` / ``ref_reconstructor`` are installed by the worker so that
    ObjectRefs and ActorHandles survive crossing process boundaries while the
    set of contained refs is captured for ownership accounting.
    """

    def __init__(self):
        self._custom_reducers: dict[type, Callable] = {}

    def register_reducer(self, typ: type, reducer: Callable) -> None:
        self._custom_reducers[typ] = reducer

    def serialize(self, value: Any) -> SerializedObject:
        buffers: List[memoryview] = []
        contained_refs: list = []

        # Import here to avoid a cycle at module load.
        from ray_tpu_torch.core.object_ref import ObjectRef
        from ray_tpu_torch.core.actor import ActorHandle

        class _Pickler(cloudpickle.Pickler):
            def reducer_override(self, obj):
                if isinstance(obj, ObjectRef):
                    contained_refs.append(obj)
                    return (ObjectRef._rehydrate, (obj._descriptor(),))
                if isinstance(obj, ActorHandle):
                    return (ActorHandle._rehydrate, (obj._descriptor(),))
                if _is_plain_tensor(obj):
                    return _reduce_tensor(obj)
                for typ, red in self_ctx._custom_reducers.items():
                    if isinstance(obj, typ):
                        return red(obj)
                # Delegate to cloudpickle's own handling (closures, lambdas,
                # locally-defined classes).
                return super().reducer_override(obj)

        self_ctx = self
        sink = io.BytesIO()
        pickler = _Pickler(sink, protocol=5, buffer_callback=lambda b: buffers.append(b.raw()))
        pickler.dump(value)
        return SerializedObject(sink.getvalue(), buffers, contained_refs)

    def deserialize(self, inband: bytes, buffers: List[memoryview]) -> Any:
        return pickle.loads(inband, buffers=buffers)

    def deserialize_payload(self, payload: memoryview) -> Any:
        inband, buffers = unpack_payload(payload)
        return self.deserialize(inband, buffers)
