"""The executors of tests/test_torch_child_mesh.py, built where the actor
lives: in a spawned child and in each rank of its own mesh.  They import
torch and the port only, so a spawned rank starts without JAX, and run
on one thread, so every process computes the same bits."""
import os

import torch
import torch.distributed as dist

from repro_torch.core import ddma
from repro_torch.core.ddma import whole
from repro_torch.core.executor import GeneratorExecutor, TrainerExecutor


def _gathered(obj):
    """Every rank's ``obj``, in rank order (a collective of the world)."""
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out


class MeshProbe:
    """Endpoints every meshed test executor has."""

    def mesh_info(self):
        return {"shape": list(self.mesh.shape),
                "axes": list(self.mesh.mesh_dim_names),
                "device_type": self.mesh.device_type,
                "pids": _gathered(os.getpid())}


class MeshTrainer(MeshProbe, TrainerExecutor):
    def __init__(self, *args, **kwargs):
        torch.set_num_threads(1)
        super().__init__(*args, **kwargs)

    def state_whole(self):
        """Params, m and v gathered whole, and the Adam step."""
        return {"params": whole(self.state.params),
                "m": whole(self.state.opt.m), "v": whole(self.state.opt.v),
                "step": self.state.opt.step}

    def ddma_checks(self):
        """DDMA on this world of two ranks: the params replicated onto
        the trainer's own mesh, then a version made on rank 0 alone
        carried across ``trainer_generator_submeshes`` to rank 1, a leaf
        in bf16 among them; each rank reports what it holds against what
        it expects, bit for bit."""
        from torch.distributed.tensor import DTensor, Replicate
        from repro_torch.launch.mesh import trainer_generator_submeshes
        from repro_torch.train.optimizer import tree_leaves, tree_map
        params = self.get_model()
        rep = ddma.ddma_weight_sync(params, self.mesh)
        on_mesh = all(
            isinstance(d, DTensor) and d.device_mesh == self.mesh
            and all(isinstance(p, Replicate) for p in d.placements)
            and torch.equal(d.to_local(), t)
            for d, t in zip(tree_leaves(rep), tree_leaves(params)))
        tm, gm = trainer_generator_submeshes(device_type="cpu")
        version = {"w": tree_map(lambda t: t * 3 + 1, params),
                   "half": params["embed"].to(torch.bfloat16) * 7}
        rank = dist.get_rank()
        in_trainer = rank in tm.mesh.flatten().tolist()
        got = ddma.ddma_weight_sync(version if in_trainer else None, gm,
                                    src=int(tm.mesh.flatten()[0]))
        if got is None:
            carried = None
        else:
            carried = all(
                isinstance(d, DTensor) and d.device_mesh == gm
                and d.dtype == t.dtype
                and torch.equal(d.to_local().view(torch.uint8),
                                t.view(torch.uint8))
                for d, t in zip(tree_leaves(got), tree_leaves(version)))
        return _gathered({"rank": rank, "on_mesh": on_mesh,
                          "in_trainer": in_trainer, "carried": carried,
                          "submeshes": [tm.mesh.flatten().tolist(),
                                        gm.mesh.flatten().tolist()]})


class MeshGenerator(MeshProbe, GeneratorExecutor):
    def __init__(self, *args, **kwargs):
        torch.set_num_threads(1)
        super().__init__(*args, **kwargs)

    def placement_checks(self, batch):
        """``InprocTransport.prepare`` onto this mesh: a ``SCATTER``
        payload split on dim 0 over the first axis, a ``BROADCAST`` one
        and a weight payload replicated; the executor takes each whole."""
        from torch.distributed.tensor import DTensor, Replicate, Shard
        from repro_torch.core.actors import InprocTransport
        from repro_torch.core.channels import CommType
        tr = InprocTransport(self)
        sc = tr.prepare(batch, CommType.SCATTER)
        bc = tr.prepare(batch, CommType.BROADCAST)
        wt = tr.prepare({"w": batch["x"]}, CommType.DDMA_WEIGHTS_UPDATE)
        i = self.mesh.get_local_rank(self.mesh.mesh_dim_names[0])
        n = self.mesh.size(0)
        rows = batch["x"].shape[0] // n
        self.put_input("scattered", sc)
        out = {
            "scatter": [[type(p).__name__, getattr(p, "dim", None)]
                        for p in sc["x"].placements],
            "scatter_local": torch.equal(
                sc["x"].to_local(), batch["x"][i * rows:(i + 1) * rows]),
            "broadcast": all(isinstance(p, Replicate)
                             for p in bc["x"].placements),
            "weights": isinstance(wt["w"], DTensor) and all(
                isinstance(p, Replicate) for p in wt["w"].placements),
            "scalar": isinstance(sc["n"], DTensor)
            and not any(isinstance(p, Shard) for p in sc["n"].placements),
            "whole_input": torch.equal(self.get_input("scattered")["x"],
                                       batch["x"]),
        }
        return _gathered(out)
