"""The rank side of tests/test_torch_tp.py: what each gloo rank of a
spawned world runs, llama31's smoke and the MoE family's two.  It imports
torch and the port only, so a spawned rank starts without JAX."""
import json

import numpy as np
import torch

from _sharded_ranks import _expected_shard, paths

# (name, mesh shape, the ranks of each mesh of that shape in the world of
# four): the (1, 2) meshes run on ranks 0-1 and 2-3 at once
MESHES = [("model2", (1, 2), [[0, 1], [2, 3]]),
          ("model4", (1, 4), [[0, 1, 2, 3]]),
          ("data2_model2", (2, 2), [[0, 1, 2, 3]])]
B, PROMPT, CACHE, MAX_NEW, TEMP = 4, 8, 24, 6, 0.8
# the MoE family's smokes, run on every mesh beside llama31's
MOE_ARCHS = ("llama4-scout-17b-a16e", "deepseek-v3-671b")
# their published capacity factor, at which the smokes' prefills and
# scoring drop choices (their own 4.0 drops none)
DROP_CF = 1.25


def drop_cfg(cfg):
    """``cfg`` (a config of either package) at DROP_CF."""
    import dataclasses
    return cfg.replace(moe=dataclasses.replace(cfg.moe,
                                               capacity_factor=DROP_CF))


def _whole(x, tp, B_):
    """A rank's [rows, V/m] (or [rows, V]) gathered over the model group
    (when the vocabulary splits) and over the data axes."""
    import torch.distributed as dist
    if tp.vocab:
        parts = [torch.empty_like(x) for _ in range(tp.size)]
        dist.all_gather(parts, x.contiguous(), group=tp.group)
        x = torch.cat(parts, dim=-1)
    return tp.gather_rows(x, B_)


def _mesh_checks(mesh, ref):
    """On ``mesh``: the shards and cache against the plan, prefill and
    decode logits and a rollout, as numpy for the parent to hold to the
    JAX package."""
    from repro_torch import convert
    from repro_torch.configs.llama_paper import smoke
    from repro_torch.core.ddma import ddma_weight_sync
    from repro_torch.models import decode_step, prefill
    from repro_torch.models.sharding import Shardings, distribute, \
        params_shardings, tp_plan, tp_shard
    from repro_torch.models.tp import tp_rank
    from repro_torch.rl import prng
    from repro_torch.rl.rollout import generate
    cfg = smoke()
    params = convert.from_jax_numpy(ref["params"], device="cpu")
    plan = tp_plan(cfg, mesh)
    shard = tp_shard(params, mesh, plan)
    full, specs = paths(params), paths(plan)
    ok = [torch.equal(t, _expected_shard(full[p], specs[p], mesh))
          for p, t in paths(shard).items()]
    # the trainer's FSDP + TP shards (DTensors) carried onto the serve
    # shards by DDMA: the same blocks
    carried = ddma_weight_sync(
        distribute(params, mesh, params_shardings(params, mesh, "train")),
        Shardings(mesh, plan))
    held = paths(shard)
    ok += [torch.equal(t, held[p]) for p, t in paths(carried).items()]
    tp = tp_rank(cfg, mesh)
    rows, tpr = tp.for_rows(B)
    prompts = torch.as_tensor(ref["prompts"])
    with torch.no_grad():
        logits, cache = prefill(shard, cfg, {"tokens": prompts[rows]}, CACHE,
                                torch.float32, tp=tpr)
        out = {"prefill": _whole(logits, tpr, B).numpy()}
        out["cache_k"] = list(cache["segments"][0]["k"].shape)
        for i, tok in enumerate(ref["decode_tokens"]):
            logits, cache = decode_step(shard, cfg, cache,
                                        torch.as_tensor(tok)[rows], tp=tpr)
            out[f"decode{i}"] = _whole(logits, tpr, B).numpy()
        st = generate(shard, cfg, prompts[rows], max_new=MAX_NEW,
                      key=prng.PRNGKey(3), temperature=TEMP, tp=tpr)
    out["tokens"] = tpr.gather_rows(st.tokens, B).numpy()
    out["blp"] = tpr.gather_rows(st.behavior_logp, B).numpy()
    out["ref_logp"] = _ref_scoring(mesh, params, ref)
    out["vp_logp"], out["vp_grad"] = _vocab_parallel(tp, ref)
    return out, {"shards_ok": [len(ok), all(ok)],
                 "heads": tpr.heads, "proj": tpr.proj, "ffn": tpr.ffn,
                 "vocab": tpr.vocab, "row0": tpr.row0,
                 "wq": list(shard["layers"]["attn"]["wq"].shape),
                 "attn": _attn_shapes(shard["layers"]["attn"])}


def _attn_shapes(attn):
    """The shapes of a rank's ``wq wk wv wo``."""
    return {w: list(attn[w].shape) for w in ("wq", "wk", "wv", "wo")}


def _ref_scoring(mesh, params, ref):
    """A reference executor on ``mesh`` (its TP shard; its rows, heads,
    FFN columns and vocabulary slice) scoring ``ref["score_tokens"]``:
    its ``ref_logp``."""
    from repro_torch.configs.llama_paper import smoke
    from repro_torch.core.executor import RefPolicyExecutor
    ex = RefPolicyExecutor(smoke(), mesh=mesh)
    assert ex.tp is not None
    ex.set_weights(params)
    ex.put_input("completions",
                 {"tokens": torch.as_tensor(ref["score_tokens"])})
    return ex.step()["ref_logp"].numpy()


def _vocab_parallel(tp, ref):
    """``dispatch.token_logprob_vocab_parallel`` of this rank's slice of
    ``ref["vp_logits"]`` [B, T, V] over the prefix T - 1: the merged
    log-probs and the gradient of the slice under ``ref["vp_g"]``."""
    from repro_torch.kernels import dispatch
    x = torch.as_tensor(ref["vp_logits"])
    n = x.shape[-1] // tp.size
    col0 = tp.rank * n
    local = x[..., col0:col0 + n].clone().requires_grad_()
    toks = torch.as_tensor(ref["vp_tokens"])
    lp = dispatch.token_logprob_vocab_parallel(local, toks, col0, tp.group,
                                               n_valid=toks.shape[1])
    (g,) = torch.autograd.grad(lp, local, torch.as_tensor(ref["vp_g"]))
    return lp.detach().numpy(), g.numpy()


def _moe_checks(mesh, mesh_name, arch, ref):
    """A MoE smoke ``arch`` on ``mesh``: each shard against the JAX
    package's ``param_spec(mode="serve")`` block (``ref["specs"]``), the
    experts a rank holds, prefill and decode logits, a rollout and a
    reference executor's scoring at the smoke's capacity factor and at
    DROP_CF, as numpy for the parent."""
    from repro_torch import configs, convert
    from repro_torch.core.ddma import ddma_weight_sync
    from repro_torch.models.sharding import Shardings, distribute, \
        params_shardings, tp_plan, tp_shard
    from repro_torch.models.tp import tp_rank
    cfg = configs.get_smoke(arch)
    params = convert.from_jax_numpy(ref["params"], device="cpu")
    tp = tp_rank(cfg, mesh)
    shard = tp_shard(params, mesh, tp_plan(cfg, mesh))
    full, want = paths(params), ref["specs"][mesh_name]
    ok = [torch.equal(t, _expected_shard(full[p], want[p], mesh))
          for p, t in paths(shard).items()]
    # the trainer's FSDP + TP shards (DTensors, expert leaves split over
    # model and data) carried onto the serve shards by DDMA
    carried = ddma_weight_sync(
        distribute(params, mesh, params_shardings(params, mesh, "train")),
        Shardings(mesh, tp_plan(cfg, mesh)))
    held = paths(shard)
    ok += [torch.equal(t, held[p]) for p, t in paths(carried).items()]
    # at the smoke's capacity factor, and at DROP_CF
    out, experts = _moe_outputs(shard, params, cfg, mesh, tp, ref)
    drop, _ = _moe_outputs(shard, params, drop_cfg(cfg), mesh, tp, ref)
    out.update({f"drop|{k}": v for k, v in drop.items()})
    _, tpr = tp.for_rows(B)
    return out, {"shards_ok": [len(ok), all(ok)], "tp": tp is not None,
                 "heads": tpr.heads, "proj": tpr.proj,
                 "attn": _attn_shapes(shard["moe_layers"]["attn"])
                 if cfg.attn_kind != "mla" else None,
                 "experts": tpr.experts,
                 "vocab": tpr.vocab, "shared": tpr.shared,
                 "held_experts": shard["moe_layers"]["moe"]["w_gate"]
                 .shape[1], "ref_experts": experts}


def _moe_outputs(shard, params, cfg, mesh, tp, ref):
    """The TP prefill and three decode steps' logits, a rollout and a
    reference executor's scoring of ``cfg`` on this rank's ``shard``
    (whole ``params`` for the executor), as numpy; and the experts the
    executor holds."""
    from repro_torch.core.executor import RefPolicyExecutor
    from repro_torch.models import decode_step, prefill
    from repro_torch.rl import prng
    from repro_torch.rl.rollout import generate
    rows, tpr = tp.for_rows(B)
    prompts = torch.as_tensor(ref["prompts"])
    out = {}
    with torch.no_grad():
        logits, cache = prefill(shard, cfg, {"tokens": prompts[rows]}, CACHE,
                                torch.float32, tp=tpr)
        out["prefill"] = _whole(logits, tpr, B).numpy()
        for i, tok in enumerate(ref["decode_tokens"]):
            logits, cache = decode_step(shard, cfg, cache,
                                        torch.as_tensor(tok)[rows], tp=tpr)
            out[f"decode{i}"] = _whole(logits, tpr, B).numpy()
        st = generate(shard, cfg, prompts[rows], max_new=MAX_NEW,
                      key=prng.PRNGKey(3), temperature=TEMP, tp=tpr)
    out["tokens"] = tpr.gather_rows(st.tokens, B).numpy()
    out["blp"] = tpr.gather_rows(st.behavior_logp, B).numpy()
    ex = RefPolicyExecutor(cfg, mesh=mesh)
    ex.set_weights(params)
    ex.put_input("completions",
                 {"tokens": torch.as_tensor(ref["score_tokens"])})
    out["ref_logp"] = ex.step()["ref_logp"].numpy()
    return out, paths(ex.params)["moe_layers/moe/w_gate"].shape[1]


def _experts_whole_check(mesh):
    """llama4-scout's smoke with 6 experts on ``mesh`` (a ``model`` axis
    of 4, which does not divide them): the plan keeps the experts whole
    and splits the shared expert; the TP forward's logits, moe_aux and
    a gradient of the split shared expert against the one-device
    forward's on the same params."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.models import forward_train, init_params
    from repro_torch.models import tp as tpmod
    from repro_torch.models.sharding import tp_plan, tp_shard
    base = configs.get_smoke(MOE_ARCHS[0])
    cfg = base.replace(moe=dataclasses.replace(base.moe, n_experts=6))
    params = init_params(cfg, seed=4, dtype=torch.float32, device="cpu")
    tp = tpmod.tp_rank(cfg, mesh)
    shard = tp_shard(params, mesh, tp_plan(cfg, mesh))
    toks = torch.as_tensor(
        np.random.default_rng(6).integers(0, cfg.vocab, (2, 12)))
    want, waux = forward_train(params, cfg, {"tokens": toks})
    got, gaux = tpmod.forward_train(shard, cfg, {"tokens": toks}, tp)
    parts = [torch.empty_like(got) for _ in range(tp.size)]
    torch.distributed.all_gather(parts, got.contiguous(), group=tp.group)
    got = torch.cat(parts, dim=-1)
    moe = shard["moe_layers"]["moe"]
    return {"experts": tp.experts, "shared": tp.shared,
            "held_experts": moe["w_gate"].shape[1],
            "shared_cols": moe["shared"]["w_up"].shape[-1],
            "logits": float((got - want).abs().max()),
            "scale": float(want.abs().max()),
            "aux": abs(float(gaux["moe_aux"]) - float(waux["moe_aux"]))}


def _executor_check(mesh, arch="llama31-8b"):
    """A generator executor on ``mesh`` (its TP shard, serving
    tensor-parallel) against the same executor without a mesh."""
    from repro_torch import configs
    from repro_torch.configs.llama_paper import smoke
    from repro_torch.core.executor import GeneratorExecutor
    from repro_torch.models import init_params
    from repro_torch.rl.data import ArithmeticTasks
    cfg = smoke() if arch == "llama31-8b" else configs.get_smoke(arch)
    params = init_params(cfg, seed=5, dtype=torch.float32, device="cpu")
    outs = []
    for m in (None, mesh):
        ex = GeneratorExecutor(cfg, ArithmeticTasks(seed=1), n_prompts=2,
                               n_per_prompt=2, max_new=5, chunk=2, seed=7,
                               temperature=1.0, device="cpu", mesh=m)
        ex.set_weights(params, version=0)
        outs.append(ex.step())
    a, b = outs
    held = {p: list(t.shape) for p, t in paths(ex.params).items()}
    stack = "layers" if cfg.family == "dense" else "moe_layers"
    return {"tokens_equal": bool(torch.equal(a["tokens"], b["tokens"])),
            "blp": float((a["behavior_logp"] - b["behavior_logp"])
                         .abs().max()),
            "mask_equal": bool(torch.equal(a["mask"], b["mask"])),
            "tp": ex.tp is not None, "wq": held[stack + "/attn/wq"],
            "held": {p: s for p, s in held.items() if "/moe/" in p}}


def rank_main(rank, world, rdv, ref_path, out_path):
    """One rank of the world: each mesh of ``MESHES`` it belongs to, its
    checks; every rank writes its own results."""
    import os
    import pickle
    import time

    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.launch import mesh as meshmod
    torch.set_num_threads(1)
    meshmod.join(rdv, rank, world, device_type="cpu")
    deadline = time.monotonic() + 600
    while not os.path.exists(ref_path):
        if time.monotonic() > deadline:
            raise TimeoutError(f"no JAX runs at {ref_path}")
        time.sleep(0.05)
    with open(ref_path, "rb") as f:
        ref = pickle.load(f)
    res, arrays = {}, {}
    for name, shape, groups in MESHES:
        meshes = [DeviceMesh("cpu", torch.as_tensor(g).reshape(shape),
                             mesh_dim_names=("data", "model"))
                  for g in groups]
        mesh = next(m for m, g in zip(meshes, groups) if rank in g)
        out, res[name] = _mesh_checks(mesh, ref)
        arrays.update({f"{name}|{k}": np.asarray(v) for k, v in out.items()})
        for arch in MOE_ARCHS:
            out, res[f"{name}|{arch}"] = _moe_checks(mesh, name, arch,
                                                     ref["moe"][arch])
            arrays.update({f"{name}|{arch}|{k}": np.asarray(v)
                           for k, v in out.items()})
        if name == "model4":
            res["experts_whole"] = _experts_whole_check(mesh)
        if name == "model2":
            res["executor"] = _executor_check(mesh)
            res["moe_executor"] = _executor_check(mesh, MOE_ARCHS[0])
    np.savez(f"{out_path}_{rank}.npz", **arrays)
    with open(f"{out_path}_{rank}.json", "w") as f:
        json.dump(res, f)
    dist.barrier()
    dist.destroy_process_group()
