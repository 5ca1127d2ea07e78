"""Wire format for cross-process actor payloads (the port of the JAX
package's ``core/wire.py``).

The process transports (``core/actors.py``) host executors in spawned
children, so every payload that crosses an actor boundary -- rollout
batches, scored completions, versioned weights, RPC arguments -- must
survive a byte stream.  Tensor and array bytes move untouched (bit for
bit, bf16, fp8 and int8 included) and only the structure goes through
pickle.

Layout of ``serialize(obj)``, the reference's::

    [8-byte big-endian manifest length]
    [pickle((entries, body))]            # per-leaf headers + structure
    [leaf 0 raw bytes][leaf 1 raw bytes]...

``body`` is ``obj`` pickled with every tensor and array swapped for its
index into ``entries`` (a pickle ``persistent_id``), so dataclasses,
``RolloutJob``, dict states and NamedTuples need no registry.
``entries[i]`` is one of::

    ("tensor", dtype_name, shape, nbytes, device_type)  # a torch.Tensor
    ("narr", dtype_token, shape, nbytes)                # a numpy ndarray

Where a leaf lands: a tensor that left a CUDA device comes back on the
receiving process's CUDA device (the reference's ``jnp.asarray`` onto the
default device); a CPU tensor stays on the CPU.  A CUDA leaf reaching a
process without CUDA raises -- it is never kept on the CPU instead.

``plan(obj)`` computes the manifest and total size once; nothing is
copied yet.  ``serialize_into(planned, buf)`` then writes the layout
straight into a caller's writable buffer (a shared-memory ring slot, or a
frame with a tag byte in front), each leaf copied exactly once into its
final position: a CUDA leaf by one device-to-host copy, a contiguous CPU
leaf by one memcpy.  ``deserialize`` never keeps a view into its buffer:
a CPU leaf is copied out, a CUDA leaf copied to the device, so a shm slot
can be recycled the moment it returns.
"""
from __future__ import annotations

import io
import pickle
import struct
from typing import Any, List, NamedTuple

import numpy as np
import torch

_LEN = struct.Struct(">Q")


def _dtype_token(dtype: np.dtype) -> str:
    """A string that rebuilds a numpy ``dtype`` exactly: ``dtype.str``
    where it round-trips (it keeps byte order and itemsize), else the
    name."""
    try:
        if np.dtype(dtype.str) == dtype:
            return dtype.str
    except TypeError:
        pass
    return dtype.name


def _is_leaf(x) -> bool:
    return isinstance(x, torch.Tensor) or (
        isinstance(x, np.ndarray) and not x.dtype.hasobject)


class Planned(NamedTuple):
    """One pass over the payload, reusable by ``serialize`` /
    ``serialize_into``: the pickled manifest, the leaves in order, and the
    exact size of the serialized blob (what a shm slot must hold)."""
    manifest: bytes
    leaves: List[Any]
    size: int


class _LeafPickler(pickle.Pickler):
    def __init__(self, f):
        super().__init__(f, protocol=pickle.HIGHEST_PROTOCOL)
        self.entries: List[tuple] = []
        self.leaves: List[Any] = []

    def persistent_id(self, obj):
        if not _is_leaf(obj):
            return None
        if isinstance(obj, torch.Tensor):
            t = obj.detach()
            self.entries.append(("tensor", str(t.dtype)[len("torch."):],
                                 tuple(t.shape),
                                 t.numel() * t.element_size(),
                                 t.device.type))
        else:
            t = obj
            self.entries.append(("narr", _dtype_token(t.dtype), t.shape,
                                 t.nbytes))
        self.leaves.append(t)
        return len(self.leaves) - 1


class _LeafUnpickler(pickle.Unpickler):
    def __init__(self, f, leaves):
        super().__init__(f)
        self._leaves = leaves

    def persistent_load(self, pid):
        return self._leaves[pid]


def plan(obj: Any) -> Planned:
    """Structure + header pass: no leaf byte is copied."""
    f = io.BytesIO()
    p = _LeafPickler(f)
    p.dump(obj)
    manifest = pickle.dumps((p.entries, f.getvalue()),
                            protocol=pickle.HIGHEST_PROTOCOL)
    total = sum(e[3] for e in p.entries)
    return Planned(manifest, p.leaves, _LEN.size + len(manifest) + total)


def _leaf_bytes(t: torch.Tensor) -> torch.Tensor:
    """The leaf's bytes as a flat uint8 tensor on its own device (a view
    when the leaf is contiguous)."""
    return t.contiguous().reshape(-1).view(torch.uint8)


def serialize_into(planned: Planned, buf) -> int:
    """Scatter a planned payload into ``buf`` (writable, at least
    ``planned.size`` bytes); returns the bytes written.  Each leaf is
    copied once, straight into its final position."""
    mv = memoryview(buf).cast("B")
    if len(mv) < planned.size:
        raise ValueError(f"buffer of {len(mv)} bytes cannot hold "
                         f"{planned.size}")
    _LEN.pack_into(mv, 0, len(planned.manifest))
    offset = _LEN.size
    mv[offset:offset + len(planned.manifest)] = planned.manifest
    offset += len(planned.manifest)
    for leaf in planned.leaves:
        if isinstance(leaf, torch.Tensor):
            n = leaf.numel() * leaf.element_size()
            if n:
                dst = torch.frombuffer(mv, dtype=torch.uint8, count=n,
                                       offset=offset)
                dst.copy_(_leaf_bytes(leaf))
        else:
            n = leaf.nbytes
            if n:
                np.copyto(np.ndarray(leaf.shape, leaf.dtype, buffer=mv,
                                     offset=offset), leaf)
        offset += n
    return planned.size


def serialize(obj: Any) -> bytearray:
    """Payload -> bytes: manifest + concatenated leaf buffers."""
    planned = obj if isinstance(obj, Planned) else plan(obj)
    out = bytearray(planned.size)
    serialize_into(planned, out)
    return out


def _restore_tensor(mv: memoryview, offset: int, entry) -> torch.Tensor:
    _, dtype_name, shape, nbytes, device_type = entry
    dtype = getattr(torch, dtype_name)
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"a CUDA {dtype_name} tensor of shape {list(shape)} reached "
                "a process without CUDA; it is not kept on the CPU instead")
        device = torch.device("cuda")
    else:
        device = torch.device(device_type)
    if nbytes == 0:
        return torch.empty(shape, dtype=dtype, device=device)
    if mv.readonly:
        # frombuffer would alias a read-only buffer: copy it out first
        raw = torch.from_numpy(np.frombuffer(mv, np.uint8, nbytes,
                                             offset).copy())
        owned = True
    else:
        raw = torch.frombuffer(mv, dtype=torch.uint8, count=nbytes,
                               offset=offset)
        owned = False
    if device.type == "cpu":
        if not owned:
            raw = raw.clone()
    else:
        # a synchronous host-to-device copy: the buffer is free on return
        raw = raw.to(device)
    return raw.view(dtype).reshape(shape)


def deserialize(data) -> Any:
    """Buffer -> payload, every leaf restored with its exact bytes.

    ``data`` may be bytes or any buffer (a memoryview of a shm slot).  No
    leaf keeps a view into it: a shm slot is reused once it is acked."""
    mv = memoryview(data).cast("B")
    (n,) = _LEN.unpack_from(mv, 0)
    entries, body = pickle.loads(mv[_LEN.size:_LEN.size + n])
    offset = _LEN.size + n
    leaves = []
    for entry in entries:
        if entry[0] == "tensor":
            leaves.append(_restore_tensor(mv, offset, entry))
        else:
            _, token, shape, nbytes = entry
            dtype = np.dtype(token)
            leaves.append(
                np.frombuffer(mv, dtype=dtype, count=nbytes // dtype.itemsize,
                              offset=offset).reshape(shape).copy()
                if nbytes else np.empty(shape, dtype))
        offset += entry[3]
    return _LeafUnpickler(io.BytesIO(body), leaves).load()
