"""Device meshes on ``torch.distributed.device_mesh`` (the port of the JAX
package's ``launch/mesh.py``).

Functions, not module constants: importing this module touches no
process group.  Every mesh function is collective, called by every rank
of the world with the same arguments, after ``join`` (or the caller's own
``init_process_group``); each takes an explicit ``device_type``, ``cuda``
unless the caller asks for ``cpu``.  Mesh coordinates follow rank order,
as the reference's meshes follow ``jax.devices()``.
"""
from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.device import resolve


def join(init_method: str, rank: int, world_size: int, *,
         device_type: str = "cuda", timeout_s: float = 120.0) -> None:
    """Join the world's process group: NCCL on ``cuda`` (this rank on its
    card, rank modulo the cards it sees), gloo on ``cpu``.
    ``init_method`` is the rendezvous, e.g. ``file:///path`` or
    ``tcp://localhost:<port>``.  A rank that cannot join raises."""
    dev = resolve(device_type)
    if dev.type == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(
        "nccl" if dev.type == "cuda" else "gloo", init_method=init_method,
        rank=rank, world_size=world_size,
        timeout=datetime.timedelta(seconds=timeout_s))


def _world(device_type: str) -> int:
    resolve(device_type)            # cuda without CUDA raises
    if not dist.is_initialized():
        raise RuntimeError("a device mesh needs the world's process group: "
                           "call mesh.join (or init_process_group) first")
    return dist.get_world_size()


def _mesh(device_type: str, ranks, shape, names) -> DeviceMesh:
    return DeviceMesh(device_type, torch.as_tensor(ranks).reshape(shape),
                      mesh_dim_names=names)


def make_mesh(shape, axes=("data", "model"), *,
              device_type: str = "cuda") -> DeviceMesh:
    """A mesh of ``shape`` named ``axes`` over every rank of the world,
    which must hold exactly that many (``jax.make_mesh``'s twin)."""
    n = 1
    for s in shape:
        n *= s
    world = _world(device_type)
    if world != n:
        raise ValueError(f"a mesh {tuple(shape)} needs {n} ranks; the world "
                         f"has {world}")
    return _mesh(device_type, list(range(n)), tuple(shape), tuple(axes))


def join_world_of_one(device_type: str = "cuda") -> None:
    """Join a world of one rank (this process), its ``file://``
    rendezvous in a directory of its own, removed at exit."""
    import atexit
    import shutil
    import tempfile
    d = tempfile.mkdtemp(prefix="repro-world-")
    atexit.register(shutil.rmtree, d, True)
    join("file://" + os.path.join(d, "rendezvous"), 0, 1,
         device_type=device_type)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda") -> DeviceMesh:
    """Single pod: (data=16, model=16) = 256 ranks.  Multi-pod:
    (pod=2, data=16, model=16) = 512 ranks.  The world must have exactly
    that many ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = 1
    for s in shape:
        n *= s
    world = _world(device_type)
    if world != n:
        raise ValueError(f"the production mesh {shape} needs {n} ranks; "
                         f"the world has {world}")
    return _mesh(device_type, list(range(n)), shape, axes)


def make_dev_mesh(n_devices: int = 0, *,
                  device_type: str = "cuda") -> DeviceMesh:
    """(data=1, model=n) over the world's first n ranks (all of them with
    ``n_devices=0``)."""
    world = _world(device_type)
    n = n_devices or world
    if n > world:
        raise ValueError(f"a mesh of {n} ranks in a world of {world}")
    return _mesh(device_type, list(range(n)), (1, n), ("data", "model"))


def trainer_generator_submeshes(theta: float = 0.5, *,
                                device_type: str = "cuda"):
    """Disjoint trainer and generator meshes, each (data=1, model=n_i),
    over the world's ranks split by the reference's rule (paper Def.
    7.4's theta fraction): the first ``max(1, int(n * theta))`` train,
    clamped so the generator keeps at least one.  Needs >= 2 ranks.  A
    rank reads its own mesh's coordinate; in the other it has none."""
    n = _world(device_type)
    if n < 2:
        raise ValueError(f"trainer and generator submeshes need >= 2 "
                         f"ranks, not {n}")
    n_train = max(1, int(n * theta))
    if n - n_train < 1:
        n_train = n - 1
    return (_mesh(device_type, list(range(n_train)), (1, n_train),
                  ("data", "model")),
            _mesh(device_type, list(range(n_train, n)), (1, n - n_train),
                  ("data", "model")))
