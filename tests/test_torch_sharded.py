"""The sharded train step, sharded checkpoints and expert-parallel MoE
(``repro_torch.train.sharded``, ``train.checkpoint``, ``models.ffn``) on
gloo ranks on the CPU, against the JAX package.

One spawn of four ranks runs many checks on two meshes over them: a
(data 2, model 2) mesh and a (data 1, model 4) mesh.  Rendezvous is a ``file://`` in the
test's own tmp_path, so parallel test workers never share a port.  The
JAX runs (the reference's ``make_train_step`` from its own init, two
steps) are made here in the parent and handed to the ranks as numpy;
each sharded step starts from the JAX state before it, and rank 0 sends
back what the parent compares.  Tolerances are
tests/test_torch_train.py's for one step: metrics within 1e-5 relative,
moments within 1e-5 of each leaf's largest, and each leaf's update, an
Adam step at lr 1e-3, 99% within 1e-5 of its largest and all within 0.2
of it (a gradient element near Adam's eps moves its param by about lr
whatever its fp32 noise); deepseek-v3's MLA + MoE + MTP smoke within
tests/test_torch_mla.py's 1e-4, its updates all within 2 lr.  (Chained, the second step starts from
the first's fp32 noise, which Adam lifts to lr-sized moves: the port's
one-device step drifts from JAX's past these bounds the same way.)  The
cases of ``REMAT`` run again with ``remat_layers`` and hold to the same
JAX steps; the ranks count the step's one-layer gathers: with
``remat_layers`` at most one layer's gathered slices are alive at once
in the forward (two over the step, while the backward gathers again),
each layer is gathered twice, and the gathered gradients a backward
hands to the reductions never outgrow one layer's.  The dense smokes
(8 query and 2 KV heads) step tensor-parallel on both meshes
(``models.tp``): llama31's, and starcoder2's at 96 tokens, whose biases
(sliced where their heads or MLP columns split, their gradients summed
over ``model``) and window of 64 take the paths llama31's does not (its
key bias's update, rounding noise, is held to the 0.2 alone, see
``NOISE``).  On (1, 4) (2 % 4 != 0) a rank computes its columns of
``wq wk wv`` (its biases whole, added after q, k and v are gathered)
and its rows of ``wo`` around a whole attention core.  No leaf is
gathered over ``model``; a layer's gathered bytes are the plan's (a
split leaf's ``model`` slice).  The
MoE smokes step tensor-parallel too: deepseek-v3's (MLA on its 4 heads,
2 or 1 of 4 experts a rank, the MTP head's ``proj`` by columns, its
loss vocabulary-parallel) at its unchanged bounds, and llama4-scout's
(GQA as llama31's, a top-1 MoE with a shared expert, windows) at
tests/test_torch_moe.py's 1e-4 and llama31's 0.2 (an update whose
reference gradient is below 1e-6 held to the 0.2 alone, see
``G_SIGN``).  The
expert-parallel modes,
ep_shmap also under ``remat_layers`` (its recompute runs the EP
collectives again), hold to the gathered one within
tests/test_moe_ep.py's 1e-4."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch.multiprocessing as mp

from repro import configs as jconfigs
from repro.configs import llama_paper as jllama
from repro.models import forward_train as jforward
from repro.models import init_params as jinit
from repro.train import trainstep as jts
from _sharded_ranks import LR, MOE_ARCHS, REMAT, STEPS, paths, rank_main

# (name, arch, rows, accum_steps, kl_coef): llama31 smoke with its two
# microbatches' rows split over data (2 % 2 == 0), and replicated
# (3 % 2 != 0); starcoder2's smoke split; deepseek-v3's smoke (MLA, MoE
# aux, MTP) split; llama4-scout's smoke (GQA, a top-1 MoE with a shared
# expert, windows) split
CASES = [("llama", "llama31-8b", 4, 2, 0.05),
         ("llama_rep", "llama31-8b", 3, 1, 0.0),
         ("sc2", "starcoder2-3b", 4, 1, 0.0),
         ("dsv3", "deepseek-v3-671b", 4, 1, 0.0),
         ("scout", "llama4-scout-17b-a16e", 4, 1, 0.0)]
# starcoder2's smoke (biases, a window of 64) at 96 tokens, so its
# layers attend through the window
SEQ = {"starcoder2-3b": 96}
# llama4-scout's smoke at tests/test_torch_moe.py's 1e-4 (the port's
# one-device step misses 1e-5 against the JAX step at the 99th percentile
# itself: the shared expert and wq by 1.5e-5-1.8e-5; the TP step's
# router m by up to 4.2e-5 of its largest, see ``G_SIGN``)
TOL = {"llama31-8b": 1e-5, "starcoder2-3b": 1e-5, "deepseek-v3-671b": 1e-4,
       "llama4-scout-17b-a16e": 1e-4}
# the most an update may be off, as a share of the leaf's largest update:
# tests/test_torch_train.py's 0.2, and tests/test_torch_mla.py's 2 lr
# (an element whose gradient is near Adam's eps can flip its move)
WORST = {"llama31-8b": 0.2, "starcoder2-3b": 0.2, "deepseek-v3-671b": 2.0,
         "llama4-scout-17b-a16e": 0.2}
# leaves whose gradient is zero in exact arithmetic: a key bias shifts
# every score of a query by the same q . b_k, which softmax ignores, so
# what is computed is rounding noise that Adam scales up to moves of up
# to about lr, which no two implementations share (the port's one-device
# step misses the JAX step's on starcoder2's bk at the 99th percentile by
# 1.1e-2 of the largest).  Their m and v are held as every leaf's, their
# update to WORST alone
NOISE = ("layers/attn/bk",)
# and per arch, the size of the reference gradient below which an
# element's update is held to WORST alone: Adam's first step moves an
# element by lr g / (|g| + 1e-8), which turns on the gradient's last bits
# (its sign too) where |g| is within 100 of that eps.  llama4-scout's
# top-1 router has a gradient of 2.6e-05 at most (the aux loss's) that
# carries its normalised weight v / (v + 1e-9)'s rounding, of about
# 1e-9: a quarter of its elements lie below 1e-6, and there 1-3% of the
# TP step's updates miss the JAX step's by more than 1e-4 of the largest
# (0.05% at most of the elements above it)
G_SIGN = {"llama4-scout-17b-a16e": 1e-6}


def _jcfg(arch):
    return jllama.smoke() if arch == "llama31-8b" else \
        jconfigs.get_smoke(arch)


def _batch(cfg, seed, B, T=24, prompt=8):
    rng = np.random.default_rng(seed)
    mask = np.zeros((B, T), np.float32)
    mask[:, prompt:] = (rng.uniform(size=(B, T - prompt)) > 0.1)
    return {
        "tokens": rng.integers(0, cfg.vocab, size=(B, T)).astype(np.int32),
        "behavior_logp": (rng.uniform(-8, -4, size=(B, T)) * mask
                          ).astype(np.float32),
        "advantages": (rng.standard_normal((B, 1)) * mask).astype(np.float32),
        "mask": mask,
        "ref_logp": (rng.uniform(-8, -4, size=(B, T)) * mask
                     ).astype(np.float32),
    }


def _jax_runs():
    """Per case: the batch, and the JAX states (params, m and v as numpy)
    before and after each of two steps with each step's metrics.  The
    MoE smokes' gathered forward for the expert-parallel checks."""
    out = {}
    for name, arch, B, accum, kl in CASES:
        jcfg = _jcfg(arch)
        state = jts.init_train_state(jcfg, jax.random.PRNGKey(0),
                                     jnp.float32)
        batch = _batch(jcfg, 30, B, T=SEQ.get(arch, 24))
        step = jax.jit(jts.make_train_step(jcfg, lr=LR, kl_coef=kl,
                                           accum_steps=accum))
        states, metrics = [], []
        for _ in range(STEPS + 1):
            states.append(jax.device_get((state.params, state.opt.m,
                                          state.opt.v)))
            if len(metrics) < STEPS:
                state, m = step(state, jax.tree.map(jnp.asarray, batch))
                metrics.append({k: float(v) for k, v in m.items()})
        out[name] = dict(batch=batch, metrics=metrics, states=states)
    for arch in MOE_ARCHS:
        jcfg = jconfigs.get_smoke(arch)
        p = jinit(jcfg, jax.random.PRNGKey(1), jnp.float32)
        toks = np.random.default_rng(2).integers(
            0, jcfg.vocab, (4, 16)).astype(np.int32)
        logits, aux = jforward(p, jcfg, {"tokens": jnp.asarray(toks)})
        out[arch] = dict(params=jax.device_get(p), tokens=toks,
                         logits=np.asarray(logits),
                         moe_aux=float(aux["moe_aux"]))
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """One spawn of four gloo ranks running both meshes' checks, every
    case on each.  The ranks start (a torch import each) while
    this process makes the JAX runs.  Returns (the JAX runs, rank 0's
    results, its arrays)."""
    import pickle
    d = tmp_path_factory.mktemp("sharded")
    meshes = [("data2_model2", (2, 2), CASES), ("model4", (1, 4), CASES)]
    out = str(d / "out")
    ctx = mp.start_processes(rank_main, nprocs=4, join=False,
                             start_method="spawn", args=(
                                 4, "file://" + str(d / "rdv"), meshes,
                                 str(d / "runs.pkl"), str(d / "ckpt"), out))
    try:
        runs = _jax_runs()
        with open(d / "runs.tmp", "wb") as f:
            pickle.dump(runs, f)
        os.replace(d / "runs.tmp", d / "runs.pkl")
        while not ctx.join():
            pass
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
    with open(out + ".json") as f:
        res = json.load(f)
    with np.load(out + ".npz") as data:
        arrays = {tuple(k.split("|", 4)): data[k] for k in data.files}
    return runs, res, arrays


def _check_steps(res, arrays, name, runs, cases):
    """Each step from the JAX state before it against the JAX step:
    tests/test_torch_train.py's criteria (a metric of size below 1, such
    as a policy loss that cancels across rows, is held absolutely; an
    update's error is counted past one fp32 ulp of its param, the
    rounding of a norm weight near 1 under an update of lr)."""
    for base, arch, B, accum, kl in cases:
        for case in (base, base + "_remat") if base in REMAT else (base,):
            _check_case(res, arrays, name, runs[base], case, arch)


def _check_case(res, arrays, name, run, case, arch):
    tol = TOL[arch]
    for k, (metrics, adam_step) in enumerate(res["steps"][case]):
        want = run["metrics"][k]
        assert adam_step == k + 1          # Adam's step, on the host
        assert set(metrics) == set(want)
        for n in ("loss", "grad_norm", "mean_ratio", "mean_logp",
                  "total_loss") + (("mtp_loss", "moe_aux")
                                   if "mtp_loss" in want else ()):
            assert abs(metrics[n] - want[n]) <= \
                tol * max(abs(want[n]), 1.0), (case, k, n)
        before = [paths(t) for t in run["states"][k]]
        after = [paths(t) for t in run["states"][k + 1]]
        for i, part in enumerate(("params", "m", "v")):
            for p, j in after[i].items():
                t = arrays[name, case, str(k), part, p]
                if part != "params":
                    assert np.max(np.abs(t - j)) <= \
                        tol * max(np.max(np.abs(j)), 1e-30), \
                        (case, k, part, p)
                    continue
                o = before[0][p]
                dj = np.asarray(j, np.float64) - o
                dt = t.astype(np.float64) - o
                big = np.max(np.abs(dj))
                assert 0.5 * LR < big < 2 * LR, (case, k, p, big)
                ulp = np.spacing(np.abs(j).astype(np.float32))
                err = np.maximum(np.abs(dt - dj) - ulp, 0) / big
                assert err.max() <= WORST[arch], (case, k, p, err.max())
                if p in NOISE:
                    continue
                if arch in G_SIGN:
                    # the reference gradient of this step, from its m
                    g = np.abs(after[1][p] - 0.9 * before[1][p]) / 0.1
                    held = g >= G_SIGN[arch]
                    if not held.all():
                        print(f"{case} step {k + 1} {p}: reference gradient "
                              f"{g.max():.3g} at most, {1 - held.mean():.3f} "
                              f"of it below {G_SIGN[arch]:g}")
                    assert (err[held] > tol).mean() <= 0.01, (case, k, p)
                    continue
                assert np.quantile(err, 0.99) <= tol, (case, k, p)


def _check_layers(res):
    """The one-layer gathers of each ``REMAT`` case, without and with
    ``remat_layers`` (bytes of one rank)."""
    for base in REMAT:
        off, on = res["layers"][base], res["layers"][base + "_remat"]
        one = on["layer_bytes"]
        if off["layer_bytes"] == one == 0:
            # a tensor-parallel step whose every stacked leaf is this
            # rank's slice on one data rank (deepseek-v3 on (1, 4)):
            # no layer is gathered, with or without remat_layers
            for r in (off, on):
                assert r["n"] == r["peak"] == r["grad_peak"] == 0, (base, r)
            continue
        assert off["layer_bytes"] == one > 0, (base, off, on)
        assert off["n"] > 0 and on["n"] == 2 * off["n"], (base, off, on)
        assert 0 < on["fwd_peak"] <= one < off["fwd_peak"], (base, off, on)
        assert on["peak"] <= 2 * one, (base, on)
        for r in (off, on):
            assert 0 < r["grad_peak"] <= one, (base, r)


# one layer's gathered bytes in fp32.  llama31's smoke: attention's wq wk
# wv wo are 2 * 256 * 256 + 2 * 256 * 64 = 163840 params, the MLP's 3 *
# 256 * 512 = 393216 (the norms are replicated, never gathered).
# Gathered whole over both axes they were 2228224 bytes; on (2, 2) every
# split leaf is gathered over data into its model half, 557056 * 4 / 2;
# on (1, 4) nothing is gathered (data 1, and every matrix is this rank's
# model slice: attention's projections by columns and rows).
# starcoder2's smoke: the same attention, an MLP of 2 * 256 * 512 (its
# biases are replicated), so (163840 + 262144) * 4 / 2 on (2, 2)
LAYER_BYTES = {("llama31-8b", "data2_model2"): 1114112,
               ("llama31-8b", "model4"): 0,
               ("starcoder2-3b", "data2_model2"): 851968,
               ("starcoder2-3b", "model4"): 0}


def _check_tp_gathers(res, name):
    """Every case steps tensor-parallel and gathers no leaf over
    ``model``: no attention leaf (on (1, 4), where the smokes' 2 KV heads
    do not split, a rank holds its columns of ``wq wk wv`` and rows of
    ``wo``), FFN, expert, shared-expert, MLA-head, MTP ``proj``,
    ``embed`` or ``lm_head`` leaf.  A dense layer's gathered bytes are
    the plan's."""
    for base, arch, *_ in CASES:
        for case in (base, base + "_remat") if base in REMAT else (base,):
            r = res["layers"][case]
            assert r["model_paths"] == [], (case, r)
            if arch not in MOE_ARCHS:
                assert r["layer_bytes"] == LAYER_BYTES[arch, name], (case, r)


def _check_moe(res):
    for arch in MOE_ARCHS:
        r = res[arch]
        assert r["ep_calls"] == r["want_calls"] > 0, r
        assert r["jax_logits"] <= 1e-5 * max(1.0, r["logit_scale"]), r
        assert r["jax_aux"] <= 1e-6, r
        for mode in ("ep", "ep_shmap", "ep_shmap_remat"):
            assert r[mode]["logits"] <= 1e-4 and r[mode]["aux"] <= 1e-4 \
                and r[mode]["grad"] <= 1e-4, (arch, mode, r[mode])


def test_sharded_on_data2_model2(ranks):
    """(data 2, model 2): every shard of the state and of a restored
    checkpoint (fp32 and bf16) is the slice its spec names; each case's
    two sharded steps, with and without ``remat_layers``, equal the JAX
    steps (llama31's tensor-parallel on its heads, FFN and vocabulary);
    the one-layer gathers, none of llama31's over ``model``; ep and
    ep_shmap equal gathered with 2 experts a model rank."""
    jax_runs, res, arrays = ranks
    r = res["data2_model2"]
    assert r["mesh"] == [[2, 2], ["data", "model"]]
    n, ok = r["shards_ok"]
    assert ok and n > 0
    _check_steps(r, arrays, "data2_model2", jax_runs, CASES)
    _check_layers(r)
    _check_tp_gathers(r, "data2_model2")
    _check_moe(r)


def test_sharded_on_model4(ranks):
    """(data 1, model 4) from ``make_dev_mesh``: the submeshes split the
    world 2 + 2 and the production mesh refuses a world of 4; every
    case's sharded steps, with and without ``remat_layers`` (llama31's
    tensor-parallel on its FFN and vocabulary and on its columns of ``wq
    wk wv`` and rows of ``wo``, the attention core whole); no leaf
    gathered (data 1), none over ``model``; ep and ep_shmap with 1
    expert a model rank."""
    jax_runs, res, arrays = ranks
    r = res["model4"]
    assert r["mesh"] == [[1, 4], ["data", "model"]]
    assert res["submeshes"] == [[[0, 1]], [[2, 3]], 0]
    assert "256 ranks" in res["production"]
    assert r["shards_ok"][1]
    _check_steps(r, arrays, "model4", jax_runs, CASES)
    _check_layers(r)
    _check_tp_gathers(r, "model4")
    _check_moe(r)
