"""The rank side of tests/test_torch_sharded.py: what each gloo rank of
a spawned mesh runs.  It imports torch and the port only, so a spawned
rank starts without JAX."""
import json
import weakref

import numpy as np
import torch

LR, STEPS = 1e-3, 2
MOE_ARCHS = ("llama4-scout-17b-a16e", "deepseek-v3-671b")
# the cases that also run with remat_layers on every mesh
REMAT = ("llama", "dsv3")


def paths(tree, prefix=()):
    """{path: leaf} of nested dicts and lists, as ``_path_str`` joins."""
    if isinstance(tree, dict):
        return {k: v for key in tree
                for k, v in paths(tree[key], prefix + (key,)).items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, x in enumerate(tree)
                for k, v in paths(x, prefix + (i,)).items()}
    return {"/".join(map(str, prefix)): tree}


def _expected_shard(full, spec, mesh):
    """The slice of ``full`` that ``spec`` gives this rank, computed from
    the mesh coordinates alone (major axis first within a tuple)."""
    idx = []
    for d, ax in enumerate(spec):
        if ax is None:
            idx.append(slice(None))
            continue
        axes = ax if isinstance(ax, tuple) else (ax,)
        i, n = 0, 1
        for a in axes:
            size = mesh.size(mesh.mesh_dim_names.index(a))
            i, n = i * size + mesh.get_local_rank(a), n * size
        w = full.shape[d] // n
        idx.append(slice(i * w, (i + 1) * w))
    return full[tuple(idx)]


def _gathers(way) -> bool:
    """Whether ``way`` (a ``MeshWay``) moves anything: a placement it
    gathers over a mesh dim of more than one rank."""
    return any(p != g and way.mesh.size(i) > 1 for i, (p, g) in enumerate(
        zip(way.placements, way.gathered)))


def _over_model(way) -> bool:
    """Whether ``way`` gathers its leaf over the ``model`` axis."""
    i = way.mesh.mesh_dim_names.index("model")
    return way.mesh.size(i) > 1 and way.placements[i] != way.gathered[i]


class _LayerMeter:
    """While entered, counts the sharded step's gathers: the one-layer
    gathers (``MeshWay.layer()``'s ways) -- how many, the most bytes of
    gathered layer slices alive at once in the forward and over the whole
    step, and the most bytes of gathered layer gradients alive at once as
    the backward hands them to the reductions, each followed from its
    storage's allocation to its release -- and the paths of the leaves
    gathered over the ``model`` axis (``model_paths``).  ``names`` are
    the state's leaf paths in ``tree_leaves`` order."""

    def __init__(self, names):
        self.names = names
        self.n = self.live = self.fwd_peak = self.peak = 0
        self.grad_live = self.grad_peak = 0
        self.model_paths = set()

    def _hold(self, t, attr, peaks):
        n = t.untyped_storage().nbytes()
        setattr(self, attr, getattr(self, attr) + n)
        for p in peaks:
            setattr(self, p, max(getattr(self, p), getattr(self, attr)))
        weakref.finalize(t.untyped_storage(), lambda: setattr(
            self, attr, getattr(self, attr) - n))

    def __enter__(self):
        from repro_torch.train import sharded
        meter, self._real = self, sharded.mesh_ways

        class Counted(sharded.MeshWay):
            path, is_layer = "", False

            def gather(self, local):
                out = super().gather(local)
                if _over_model(self):
                    meter.model_paths.add(self.path)
                if self.is_layer and out.data_ptr() != local.data_ptr():
                    meter.n += 1
                    fwd = torch._C._current_graph_task_id() == -1
                    meter._hold(out, "live", ("peak", "fwd_peak") if fwd
                                else ("peak",))
                return out

            def reduce(self, grad):
                if self.is_layer and _gathers(self):
                    meter._hold(grad, "grad_live", ("grad_peak",))
                return super().reduce(grad)

            def layer(self):
                one = super().layer()
                out = Counted(one.mesh, one.placements, one.split,
                              one.role)
                out.path, out.is_layer = self.path, True
                return out

        def ways(*args, **kwargs):
            out = []
            for w, path in zip(meter._real(*args, **kwargs), meter.names):
                c = Counted(w.mesh, w.placements, w.split, w.role)
                c.path = path
                out.append(c)
            return out

        sharded.mesh_ways = ways
        return self

    def __exit__(self, *exc):
        from repro_torch.train import sharded
        sharded.mesh_ways = self._real

    def summary(self) -> dict:
        out = {k: getattr(self, k) for k in
               ("n", "fwd_peak", "peak", "grad_peak")}
        out["model_paths"] = sorted(self.model_paths)
        return out


def _layer_bytes(state, cfg, mesh) -> int:
    """The most bytes one layer's stacked leaves take as the step gathers
    them (each leaf whose gather moves anything): whole, or, on a
    tensor-parallel step (``tp.train_roles``), a split leaf's ``model``
    slice; 0 where no stacked leaf is gathered (each is this rank's TP
    slice and the data axis is one rank)."""
    from repro_torch.models.sharding import stacked_leaves
    from repro_torch.models.tp import tp_rank, train_roles
    from repro_torch.train.optimizer import tree_leaves
    from repro_torch.train.sharded import mesh_ways
    roles = train_roles(cfg, mesh, state.params) \
        if tp_rank(cfg, mesh) is not None else None
    leaves = tree_leaves(state.params)
    ways = mesh_ways(mesh, [t.placements for t in leaves], True, roles)
    per = {}
    for key, t, w, st in zip(paths(state.params), leaves, ways,
                             stacked_leaves(state.params)):
        if not st or not _gathers(w):
            continue
        n = t.numel() * t.element_size() // t.shape[0]
        for i, g in enumerate(w.gathered):
            if g.is_shard():
                n //= mesh.size(i)
        stack = key.split("/")[0]
        per[stack] = per.get(stack, 0) + n
    return max(per.values(), default=0)


def _moe_checks(mesh, arch, ref, out):
    """ep and ep_shmap against gathered on an installed mesh: logits,
    moe_aux and every gradient (an expert leaf's rows summed over
    ``model``, each rank holding its own experts'); the EP path ran."""
    from repro_torch import configs, convert
    from repro_torch.models import ffn, forward_train
    from repro_torch.models.sharding import activation_sharding
    from repro_torch.train.optimizer import tree_leaves, tree_unflatten
    cfg = configs.get_smoke(arch)
    params = convert.from_jax_numpy(ref["params"], device="cpu")
    names = list(paths(params))
    calls = []
    real = ffn.moe_forward_shmap
    ffn.moe_forward_shmap = lambda *a: calls.append(1) or real(*a)
    got = {}
    try:
        for mode in ("gathered", "ep", "ep_shmap", "ep_shmap_remat"):
            leaves = [t.detach().requires_grad_()
                      for t in tree_leaves(params)]
            c = cfg.replace(moe_mode=mode.removesuffix("_remat"),
                            remat_layers=mode.endswith("_remat"))
            with activation_sharding(mesh):
                lg, aux = forward_train(tree_unflatten(params, leaves), c,
                                        {"tokens": torch.as_tensor(
                                            ref["tokens"])})
                loss = lg.square().mean() + aux["moe_aux"]
                g = list(torch.autograd.grad(
                    loss, leaves, allow_unused=True, materialize_grads=True))
            if mode != "gathered":
                for i, p in enumerate(names):
                    if p.split("/")[-2:] in (["moe", "w_gate"],
                                             ["moe", "w_up"],
                                             ["moe", "w_down"]):
                        torch.distributed.all_reduce(
                            g[i], group=mesh.get_group("model"))
            got[mode] = (lg.detach(), float(aux["moe_aux"].detach()), g)
    finally:
        ffn.moe_forward_shmap = real
    base = got["gathered"]
    res = {"ep_calls": len(calls),
           "want_calls": 4 * (cfg.n_layers - cfg.moe.first_k_dense),
           "jax_logits": float(np.max(np.abs(base[0].numpy()
                                             - ref["logits"]))),
           "jax_aux": abs(base[1] - ref["moe_aux"]),
           "logit_scale": float(np.max(np.abs(ref["logits"])))}
    for mode in ("ep", "ep_shmap", "ep_shmap_remat"):
        lg, aux, g = got[mode]
        res[mode] = {
            "logits": (lg - base[0]).abs().max().item(),
            "aux": abs(aux - base[1]),
            "grad": max(((a - b).abs().max() / b.abs().max().clamp(
                min=1e-30)).item() for a, b in zip(g, base[2]))}
    out[arch] = res


def _mesh_checks(mesh, name, cases, runs, ckpt, out):
    """On ``mesh``: the sharded state's shards, each of a case's two steps
    from the JAX state before it, a sharded restore, the expert-parallel
    checks.  Returns the full tensors after each step, by
    ``mesh|case|step|part|path``."""
    import torch.distributed as dist

    from repro_torch import configs, convert
    from repro_torch.configs.llama_paper import smoke
    from repro_torch.models.sharding import params_shardings
    from repro_torch.train import checkpoint as ck
    from repro_torch.train.optimizer import AdamState
    from repro_torch.train.sharded import make_sharded_train_step, \
        shard_state
    from repro_torch.train.trainstep import TrainState
    res = out[name] = {"mesh": [list(mesh.shape), list(mesh.mesh_dim_names)],
                       "steps": {}}
    shards_ok, arrays = [], {}
    for base, arch, B, accum, kl in cases:
        run = runs[base]
        for remat in (False, True) if base in REMAT else (False,):
            case = base + "_remat" * remat
            cfg = smoke() if arch == "llama31-8b" \
                else configs.get_smoke(arch)
            cfg = cfg.replace(remat_layers=remat)
            batch = {k: torch.as_tensor(v) for k, v in run["batch"].items()}
            step = make_sharded_train_step(cfg, mesh, lr=LR, kl_coef=kl,
                                           accum_steps=accum)
            res["steps"][case] = []
            for k, trees in enumerate(run["states"][:STEPS]):
                params, m, v = (convert.from_jax_numpy(t, device="cpu")
                                for t in trees)
                state = shard_state(TrainState(params, AdamState(k, m, v)),
                                    mesh)
                specs = paths(params_shardings(params, mesh, "train"))
                for full, tree in ((params, state.params), (m, state.opt.m),
                                   (v, state.opt.v)):
                    full = paths(full)
                    for p, t in paths(tree).items():
                        shards_ok.append(torch.equal(
                            t.to_local(),
                            _expected_shard(full[p], specs[p], mesh)))
                layer_bytes = _layer_bytes(state, cfg, mesh)
                if k == 0:
                    meter = _LayerMeter(list(paths(state.params)))
                with meter:
                    state, metrics = step(state, batch)
                res["steps"][case].append(
                    [{n: float(x) for n, x in metrics.items()},
                     state.opt.step])
                for part, tree in (("params", state.params),
                                   ("m", state.opt.m), ("v", state.opt.v)):
                    for p, t in paths(tree).items():
                        arrays[f"{name}|{case}|{k}|{part}|{p}"] = \
                            t.full_tensor().numpy()
            res.setdefault("layers", {})[case] = dict(
                meter.summary(), layer_bytes=layer_bytes)
    # the first case's init, saved by rank 0 and restored onto the mesh
    # by every rank, fp32 and bf16, bit for bit
    params = paths(convert.from_jax_numpy(runs[cases[0][0]]["states"][0][0],
                                          device="cpu"))
    for dt in (torch.float32, torch.bfloat16):
        tree = {k: v.to(dt) for k, v in params.items()}
        path = f"{ckpt}_{name}_{str(dt)[6:]}"
        if dist.get_rank() == 0:
            ck.save_checkpoint(path, tree)
        dist.barrier()
        sh = params_shardings(tree, mesh, "train")
        got = ck.restore_checkpoint(path, tree, sh, mesh=mesh)
        for p, t in got.items():
            shards_ok.append(t.dtype == dt and torch.equal(
                t.to_local(), _expected_shard(tree[p], sh[p], mesh)))
    res["shards_ok"] = [len(shards_ok), all(shards_ok)]
    for arch in MOE_ARCHS:
        _moe_checks(mesh, arch, runs[arch], res)
    return arrays


def rank_main(rank, world, rdv, meshes, runs_path, ckpt, out_path):
    """One rank of the world: for each (name, shape, cases) of
    ``meshes``, a (data, model) mesh of that shape over the world's ranks
    and its checks; the (1, world) mesh comes from ``make_dev_mesh``,
    with the submeshes and the production mesh's refusal.  The JAX runs
    come in a pickle at ``runs_path``, which the parent writes (and
    renames into place) while the ranks start; rank 0 writes what the
    parent compares."""
    import os
    import pickle
    import time

    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.launch import mesh as meshmod
    torch.set_num_threads(1)
    meshmod.join(rdv, rank, world, device_type="cpu")
    # the parent makes the JAX runs while the ranks start
    deadline = time.monotonic() + 600
    while not os.path.exists(runs_path):
        if time.monotonic() > deadline:
            raise TimeoutError(f"no JAX runs at {runs_path}")
        time.sleep(0.05)
    with open(runs_path, "rb") as f:
        runs = pickle.load(f)
    out, arrays = {}, {}
    for name, shape, cases in meshes:
        if shape == (1, world):
            mesh = meshmod.make_dev_mesh(device_type="cpu")
            t, g = meshmod.trainer_generator_submeshes(0.5,
                                                       device_type="cpu")
            out["submeshes"] = [t.mesh.tolist(), g.mesh.tolist(),
                                (t if rank < 2 else g).get_local_rank(
                                    "model")]
            try:
                meshmod.make_production_mesh(device_type="cpu")
            except ValueError as e:
                out["production"] = str(e)
        else:
            mesh = DeviceMesh("cpu", torch.arange(world).reshape(shape),
                              mesh_dim_names=("data", "model"))
        arrays.update(_mesh_checks(mesh, name, cases, runs, ckpt, out))
    if rank == 0:
        np.savez(out_path + ".npz", **arrays)
        with open(out_path + ".json", "w") as f:
            json.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()
