"""DDMA: direct device-to-device weight synchronization (paper Sec. 5.2;
the port of the JAX package's ``core/ddma.py``).

``ddma_weight_sync`` moves every leaf straight to the target device; on
the trainer's own device that is the same tensor, with no copy.  That is
safe because the optimizer never writes a param in place
(``train/optimizer.py``): a delivered snapshot cannot change under the
generator.  ``ps_weight_sync`` is the parameter-server baseline the paper
contrasts against: every leaf goes through host memory and back.

The target may be a ``DeviceMesh``: every leaf is then replicated over
it, a DTensor with ``Replicate()`` on each mesh dim (the reference's
``NamedSharding(mesh, P())``), each rank holding its own whole copy.
Across meshes (``launch/mesh.trainer_generator_submeshes``) the weights
are broadcast from one rank of the source mesh (``src``) to the target
mesh's ranks.

The target may be ``sharding.Shardings`` (a mesh and a tree of
``Spec``), the reference's ``ddma_weight_sync(params, target_shardings)``
and the paper's hop from the trainer's FSDP shards to the generator's
tensor-parallel shards (``sharding.tp_plan``): each rank keeps its own
block of each leaf as a plain tensor on its device, cut from a whole
leaf (a slice, copied on the device) or redistributed from a DTensor of
the same mesh (the trainer's shards, gathered over ``data`` only where
the target replicates), with no host round trip on a card.

``quantize_dequant`` gives the generator its low-precision weights (the
paper uses fp8; this is the reference's int8 symmetric per-channel
fake-quantization, applied once at weight sync, with no int8 kernel).
"""
from __future__ import annotations

import statistics
import time
from typing import Any, Callable, Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate

from repro_torch.models.sharding import Shardings, rank_device, tp_shard
from repro_torch.train.optimizer import tree_leaves, tree_map


def whole(x):
    """``x`` whole on this rank: every DTensor in nested dicts, lists and
    tuples gathered over its mesh (a collective of that mesh's ranks; a
    replicated one is its local tensor), anything else as it is."""
    if isinstance(x, DTensor):
        return x.full_tensor()
    if isinstance(x, dict):
        return {k: whole(v) for k, v in x.items()}
    if type(x) in (list, tuple):
        return type(x)(whole(v) for v in x)
    return x


def _replicated(x, mesh: DeviceMesh):
    if isinstance(x, DTensor):
        if x.device_mesh != mesh:
            raise ValueError("a DTensor of another mesh crosses meshes only "
                             "with src=")
        return x.redistribute(mesh, [Replicate()] * mesh.ndim)
    return DTensor.from_local(x.to(rank_device(mesh.device_type),
                                   non_blocking=True),
                              mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


class _LeafDesc:
    """A leaf's shape and dtype, for the ranks that receive it."""

    __slots__ = ("shape", "dtype")

    def __init__(self, t: torch.Tensor):
        self.shape, self.dtype = tuple(t.shape), t.dtype


def _carry(params, mesh: DeviceMesh, src: int):
    """Broadcast the whole leaves of ``params`` from global rank ``src``
    over the world's group; the ranks of ``mesh`` keep them replicated.
    Every rank of the world calls: the source mesh's ranks with their
    params (a DTensor leaf is gathered whole on its mesh first), the
    others with None, who learn the tree's shapes from ``src``."""
    rank = dist.get_rank()
    held = whole(params)
    desc = [tree_map(_LeafDesc, held) if rank == src else None]
    dist.broadcast_object_list(desc, src=src)
    mine = rank in mesh.mesh.flatten().tolist()
    dev = rank_device("cuda" if dist.get_backend() == "nccl" else "cpu")

    def move(d: _LeafDesc, t=None):
        buf = t.to(dev).contiguous() if t is not None else \
            torch.empty(d.shape, dtype=d.dtype, device=dev)
        # as bytes: the backend then carries any dtype bit for bit
        dist.broadcast(buf.reshape(-1).view(torch.uint8), src=src)
        return buf

    out = tree_map(move, desc[0], held) if rank == src \
        else tree_map(move, desc[0])
    if not mine:
        return None
    return tree_map(lambda t: _replicated(t, mesh), out)


def ddma_weight_sync(params, target, *, src: Optional[int] = None) -> Any:
    """Direct device-to-device transfer of every leaf to ``target``: a
    device, a ``DeviceMesh`` over which every leaf is replicated, or
    ``sharding.Shardings``, of which each rank keeps its own blocks
    (``sharding.tp_shard``; a collective of the mesh where a leaf is a
    DTensor).
    With ``src`` (a global rank of the source mesh) the weights cross
    meshes: every rank of the world calls, and the ranks outside
    ``target`` get None (``_carry``)."""
    if isinstance(target, Shardings):
        return tp_shard(params, target.mesh, target.specs)
    if isinstance(target, DeviceMesh):
        if src is not None:
            return _carry(params, target, src)
        return tree_map(lambda x: _replicated(x, target), params)
    return tree_map(lambda x: x.to(target, non_blocking=True), params)


def ps_weight_sync(params, target) -> Any:
    """Parameter-server-style baseline: host gather, then host scatter
    (onto a device, or replicated over a ``DeviceMesh``)."""
    host = tree_map(lambda x: x.to("cpu", copy=True), whole(params))
    if isinstance(target, DeviceMesh):
        return ddma_weight_sync(host, target)
    return tree_map(lambda x: x.to(target), host)


def _sync(tree) -> None:
    devices = {x.device for x in tree_leaves(tree)
               if isinstance(x, torch.Tensor)}
    for d in devices:
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def timed_sync(fn: Callable, params, device, repeats: int = 3,
               warmup: int = 1):
    """Median wall-clock of a sync path, after ``warmup`` untimed calls;
    the device is synchronized before the clock starts and before it
    stops.  Returns (seconds, the last result)."""
    _sync(params)
    out = None
    for _ in range(max(0, warmup)):
        out = fn(params, device)
        _sync(out)
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        out = fn(params, device)
        _sync(out)
        times.append(time.perf_counter() - t0)
    return float(statistics.median(times)), out


# -------------------------------------------------- generator quantization -

def quantize_int8(w: torch.Tensor):
    """Symmetric per-output-channel int8 quantization of a 2-D weight."""
    wf = w.float()
    scale = wf.abs().amax(dim=0, keepdim=True)
    scale = torch.clamp(scale, min=1e-8) / 127.0
    q = torch.clamp(torch.round(wf / scale), -127, 127)
    return q.to(torch.int8), scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor,
                    dtype=torch.bfloat16):
    return (q.float() * scale).to(dtype)


def quantize_dequant(params, min_size: int = 1 << 16, dtype=None):
    """Fake-quantize every large matmul weight (fp8-generator analogue):
    same shapes and dtypes, values through int8.  This is how the
    generator's policy mu ends up numerically different from the learner's
    pi -- one of the off-policy sources AIPO corrects for."""
    def qd(x):
        if x.dim() >= 2 and x.numel() >= min_size and x.is_floating_point():
            mat = x.reshape(-1, x.shape[-1])
            q, s = quantize_int8(mat)
            return dequantize_int8(q, s, dtype or x.dtype).reshape(x.shape)
        return x
    return tree_map(qd, params)
