"""Tensor-parallel serving of the dense and MoE families
(``repro_torch.models.tp``, ``sharding.tp_plan``,
``dispatch.sample_vocab_parallel``, the generator executor on a mesh) on
gloo ranks on the CPU, against the JAX package's single-device serving
steps.

One spawn of four ranks runs three meshes over them: two (1, 2) meshes
at once (ranks 0-1 and 2-3), a (1, 4) and a (2, 2).  llama31-smoke has 8
query and 2 KV heads, so (1, 2) splits the heads; on (1, 4) (2 % 4 != 0)
a rank holds a quarter of ``wq wk wv`` by columns and of ``wo`` by rows,
as the reference's ``param_spec`` stores them, gathers q, k and v whole
and runs the attention core whole (the reference's ``constrain_attn``),
with the FFN and the vocabulary split; (2, 2) splits the heads over
``model`` and the rows over ``data``.  The JAX runs
(``repro.models.serve.prefill``, ``decode_step``,
``repro.rl.rollout.generate`` from one init, carried across by
``convert``) are made here while the ranks start.  Each mesh
holds the prefill and three decode steps' logits within 1e-5 of JAX's
(fp32; the ranks' partial products are summed by an all-reduce, one
more rounding than one product), the rollout's tokens under one key
identical, its behaviour log-probs within 1e-5, every shard the slice
its plan names (cut from the whole tree, and carried by DDMA from the
trainer's FSDP + TP DTensors) and, where the heads split, a cache of K/m
heads.  On a (1, 2) mesh a generator executor emits the unmeshed
executor's tokens.  On every mesh a reference executor scores on its
TP shard (``models.tp.forward_train`` on its rows, the
vocabulary-parallel log-prob) within 1e-5 of the JAX package's
``forward_train`` and log-softmax, and each rank's
``dispatch.token_logprob_vocab_parallel`` of its vocabulary slice and
its gradient hold to the JAX package's ``fused_logprob`` and
``fused_logprob_bwd`` run in interpret mode, as tests/test_kernels.py
runs them, within 1e-5.  The same meshes run the MoE family's smokes
(llama4-scout's GQA with a top-1 MoE and a shared expert, whose 2 KV
heads split on (1, 2) and (2, 2), and whose projections split on (1,
4) as llama31's do; deepseek-v3's MLA,
4 heads, a dense first layer and a top-2 MoE): every shard the JAX
package's ``param_spec(mode="serve")`` block, E/m experts a rank, the
same serving, rollout and scoring bounds as llama31's, and on (1, 2) a
llama4-scout generator executor against the unmeshed one.
Rendezvous is a ``file://`` in the test's own tmp_path."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch.multiprocessing as mp

from jax.sharding import AbstractMesh as JMesh

from repro import configs as jconfigs
from repro.configs.llama_paper import smoke as jsmoke
from repro.kernels.fused_logprob import fused_logprob as jlogprob
from repro.kernels.fused_logprob import fused_logprob_bwd as jlogprob_bwd
from repro.models import forward_train as jforward
from repro.models import init_params as jinit
from repro.models.serve import decode_step as jdecode
from repro.models import sharding as jsh
from repro.models.serve import prefill as jprefill
from repro.rl.rollout import generate as jgenerate
from _tp_ranks import B, CACHE, DROP_CF, MAX_NEW, MESHES, MOE_ARCHS, \
    PROMPT, TEMP, drop_cfg, rank_main

TOL = 1e-5
WORLD = 4
# each mesh's ``model`` size
MODEL_SIZE = {m[0]: m[1][1] for m in MESHES}


def _jax_runs():
    cfg = jsmoke()
    params = jinit(cfg, jax.random.PRNGKey(0), jnp.float32)
    rng = np.random.default_rng(11)
    prompts = rng.integers(3, cfg.vocab, (B, PROMPT)).astype(np.int32)
    steps = [rng.integers(3, cfg.vocab, (B, 1)).astype(np.int32)
             for _ in range(3)]
    logits, cache = jprefill(params, cfg, {"tokens": jnp.asarray(prompts)},
                             cache_len=CACHE, dtype=jnp.float32)
    out = {"prefill": np.asarray(logits)}
    for i, tok in enumerate(steps):
        logits, cache = jdecode(params, cfg, cache, jnp.asarray(tok))
        out[f"decode{i}"] = np.asarray(logits)
    st = jgenerate(params, cfg, jnp.asarray(prompts), max_new=MAX_NEW,
                   key=jax.random.PRNGKey(3), temperature=TEMP)
    out["tokens"] = np.asarray(st.tokens)
    out["blp"] = np.asarray(st.behavior_logp)
    score = rng.integers(0, cfg.vocab, (B, PROMPT + MAX_NEW)).astype(np.int32)
    logits, _ = jforward(params, cfg, {"tokens": jnp.asarray(score)})
    lp = jnp.take_along_axis(jax.nn.log_softmax(logits[:, :-1], axis=-1),
                             jnp.asarray(score)[:, 1:, None], axis=-1)[..., 0]
    out["ref_logp"] = np.pad(np.asarray(lp), ((0, 0), (1, 0)))
    # the vocabulary-parallel log-prob: [B, T, V] logits scored over the
    # prefix T - 1, a gradient g of the log-probs
    T = 9
    vp = (rng.standard_normal((B, T, cfg.vocab)) * 3).astype(np.float32)
    vtok = rng.integers(0, cfg.vocab, (B, T - 1)).astype(np.int32)
    g = rng.standard_normal((B, T - 1)).astype(np.float32)
    flat = jnp.asarray(vp[:, :-1].reshape(-1, cfg.vocab))
    logp, m, s = jlogprob(flat, jnp.asarray(vtok.reshape(-1)),
                          interpret=True, return_stats=True)
    dl = jlogprob_bwd(flat, jnp.asarray(vtok.reshape(-1)), m, jnp.log(s),
                      jnp.asarray(g.reshape(-1)), interpret=True)
    out["vp_logp"] = np.asarray(logp).reshape(B, T - 1)
    dl = np.asarray(dl).reshape(B, T - 1, cfg.vocab)
    out["vp_grad"] = np.concatenate([dl, np.zeros_like(dl[:, :1])], axis=1)
    ref = {"params": jax.device_get(params), "prompts": prompts,
           "decode_tokens": steps, "score_tokens": score, "vp_logits": vp,
           "vp_tokens": vtok, "vp_g": g, "moe": {}}
    for arch in MOE_ARCHS:
        ref["moe"][arch], out[arch] = _jax_moe_runs(arch)
    return ref, out


def _jax_moe_runs(arch):
    """A MoE smoke's JAX prefill, three decode steps, rollout and
    forward scoring from one init, at its own capacity factor and (keys
    "drop|...") at DROP_CF, and its ``param_spec(mode="serve")`` on each
    mesh of ``MESHES``."""
    cfg = jconfigs.get_smoke(arch)
    params = jinit(cfg, jax.random.PRNGKey(0), jnp.float32)
    rng = np.random.default_rng(13)
    prompts = rng.integers(3, cfg.vocab, (B, PROMPT)).astype(np.int32)
    steps = [rng.integers(3, cfg.vocab, (B, 1)).astype(np.int32)
             for _ in range(3)]
    score = rng.integers(0, cfg.vocab, (B, PROMPT + MAX_NEW)).astype(np.int32)
    out = _jax_moe_outputs(params, cfg, prompts, steps, score)
    drop = _jax_moe_outputs(params, drop_cfg(cfg), prompts, steps, score)
    out.update({f"drop|{k}": v for k, v in drop.items()})
    specs = {}
    for name, shape, _ in MESHES:
        flat = jax.tree_util.tree_flatten_with_path(jsh.params_shardings(
            params, JMesh(shape, ("data", "model")), mode="serve"))[0]
        specs[name] = {jsh._path_str(p): tuple(s.spec) for p, s in flat}
    ref = {"params": jax.device_get(params), "prompts": prompts,
           "decode_tokens": steps, "score_tokens": score, "specs": specs}
    return ref, out


def _jax_moe_outputs(params, cfg, prompts, steps, score):
    logits, cache = jprefill(params, cfg, {"tokens": jnp.asarray(prompts)},
                             cache_len=CACHE, dtype=jnp.float32)
    out = {"prefill": np.asarray(logits)}
    for i, tok in enumerate(steps):
        logits, cache = jdecode(params, cfg, cache, jnp.asarray(tok))
        out[f"decode{i}"] = np.asarray(logits)
    st = jgenerate(params, cfg, jnp.asarray(prompts), max_new=MAX_NEW,
                   key=jax.random.PRNGKey(3), temperature=TEMP)
    out["tokens"] = np.asarray(st.tokens)
    out["blp"] = np.asarray(st.behavior_logp)
    logits, _ = jforward(params, cfg, {"tokens": jnp.asarray(score)})
    lp = jnp.take_along_axis(jax.nn.log_softmax(logits[:, :-1], axis=-1),
                             jnp.asarray(score)[:, 1:, None], axis=-1)[..., 0]
    out["ref_logp"] = np.pad(np.asarray(lp), ((0, 0), (1, 0)))
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """One spawn of four gloo ranks; the JAX runs are made while they
    start.  Returns (the JAX results, each rank's results and arrays)."""
    import pickle
    d = tmp_path_factory.mktemp("tp")
    out = str(d / "out")
    ctx = mp.start_processes(rank_main, nprocs=WORLD, join=False,
                             start_method="spawn", args=(
                                 WORLD, "file://" + str(d / "rdv"),
                                 str(d / "ref.pkl"), out))
    try:
        ref, want = _jax_runs()
        with open(d / "ref.tmp", "wb") as f:
            pickle.dump(ref, f)
        os.replace(d / "ref.tmp", d / "ref.pkl")
        while not ctx.join():
            pass
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
    got = []
    for r in range(WORLD):
        with open(f"{out}_{r}.json") as f:
            res = json.load(f)
        with np.load(f"{out}_{r}.npz") as data:
            arrays = {k: data[k] for k in data.files}
        got.append((res, arrays))
    return want, got


# per mesh: (heads split, what a rank holds of wq [L, D, H hd] and of the
# cache's k [L, rows, Sc, K, hd]) for llama31-smoke (8 heads of 32, 2 KV):
# on (1, 4) a quarter of wq's columns (the projections split, the core
# whole) and a cache of all K heads, which the reference replicates
LAYOUT = {"model2": (True, [2, 256, 128], [2, 4, CACHE, 1, 32]),
          "model4": (False, [2, 256, 64], [2, 4, CACHE, 2, 32]),
          "data2_model2": (True, [2, 256, 128], [2, 2, CACHE, 1, 32])}
# the whole wq wk wv wo [L, in, out] of the smokes' attention (8 heads
# and 2 KV heads of 32; llama31's, starcoder2's and llama4-scout's), and
# the dim each splits over ``model``: the columns of wq wk wv, the rows
# of wo
ATTN_WHOLE = {"wq": ([2, 256, 256], 2), "wk": ([2, 256, 64], 2),
              "wv": ([2, 256, 64], 2), "wo": ([2, 256, 256], 1)}


def _check_attn_quarters(r, size, label):
    """Every one of ``wq wk wv wo`` a rank holds is its 1/size of the
    whole, cut along its split dim."""
    for w, (whole, dim) in ATTN_WHOLE.items():
        want = list(whole)
        want[dim] //= size
        assert r["attn"][w] == want, (label, w, r["attn"][w], want)


@pytest.mark.parametrize("name", [m[0] for m in MESHES])
def test_tp_serving_matches_jax(ranks, name):
    want, got = ranks
    heads, wq, cache_k = LAYOUT[name]
    for rank, (res, arrays) in enumerate(got):
        r = res[name]
        n, ok = r["shards_ok"]
        assert ok and n > 0, (name, rank)
        assert r["heads"] == heads and r["ffn"] and r["vocab"], r
        assert r["proj"] == (not heads), r
        assert r["wq"] == wq, (name, rank, r)
        _check_attn_quarters(r, MODEL_SIZE[name], (name, rank))
        assert list(arrays[f"{name}|cache_k"]) == cache_k, (name, rank)
        if name == "data2_model2":
            assert r["row0"] == (rank // 2) * (B // 2), (rank, r)
        for k in ("prefill", "decode0", "decode1", "decode2"):
            err = np.max(np.abs(arrays[f"{name}|{k}"] - want[k]))
            assert err <= TOL * max(1.0, np.max(np.abs(want[k]))), \
                (name, rank, k, err)
        np.testing.assert_array_equal(arrays[f"{name}|tokens"],
                                      want["tokens"])
        assert np.max(np.abs(arrays[f"{name}|blp"] - want["blp"])) <= TOL


@pytest.mark.parametrize("name", [m[0] for m in MESHES])
def test_tp_reference_scoring_matches_jax(ranks, name):
    """A reference executor on the mesh scores on its TP shard: its
    ``ref_logp`` within 1e-5 of the JAX package's forward and
    log-softmax (relative to max(1, |logp|)), on every rank."""
    want, got = ranks
    for rank, (_, arrays) in enumerate(got):
        lp = arrays[f"{name}|ref_logp"]
        assert lp.shape == want["ref_logp"].shape, (name, rank)
        err = np.abs(lp - want["ref_logp"]) \
            / np.maximum(1.0, np.abs(want["ref_logp"]))
        assert err.max() <= TOL, (name, rank, err.max())


@pytest.mark.parametrize("name", [m[0] for m in MESHES])
def test_tp_vocab_parallel_logprob_matches_jax(ranks, name):
    """Each rank's vocabulary-parallel log-prob of its slice, merged
    over the ``model`` group, and the gradient of its slice against the
    JAX package's ``fused_logprob`` and ``fused_logprob_bwd`` (interpret
    mode) of the whole rows: log-probs within 1e-5 relative to
    max(1, |logp|), the slice's gradient within 1e-5 (zero past the
    scored prefix); every rank of a ``model`` group holds the same
    log-probs bit for bit."""
    want, got = ranks
    V = want["vp_grad"].shape[-1]
    size = MODEL_SIZE[name]
    n = V // size
    groups = {}
    for rank, (_, arrays) in enumerate(got):
        lp = arrays[f"{name}|vp_logp"]
        err = np.abs(lp - want["vp_logp"]) \
            / np.maximum(1.0, np.abs(want["vp_logp"]))
        assert err.max() <= TOL, (name, rank, err.max())
        col0 = (rank % size) * n
        g = arrays[f"{name}|vp_grad"]
        assert np.max(np.abs(g - want["vp_grad"][..., col0:col0 + n])) \
            <= TOL, (name, rank)
        assert not g[:, -1].any()
        groups.setdefault(rank // size, []).append(lp)
    for lps in groups.values():
        for lp in lps[1:]:
            np.testing.assert_array_equal(lp, lps[0])


def test_tp_generator_executor(ranks):
    """On a (1, 2) mesh a dense generator holds its TP shard (half of
    wq's columns) and emits the unmeshed generator's batch."""
    _, got = ranks
    for res, _ in got:
        r = res["executor"]
        assert r["tp"] and r["wq"] == [2, 256, 128], r
        assert r["tokens_equal"] and r["mask_equal"], r
        assert r["blp"] <= TOL, r


# per (mesh, arch): whether the heads split, and the experts a rank holds
# of the smoke's 4 (llama4-scout: 8 query and 2 KV heads; deepseek-v3: 4
# MLA heads)
MOE_LAYOUT = {("model2", MOE_ARCHS[0]): (True, 2),
              ("model4", MOE_ARCHS[0]): (False, 1),
              ("data2_model2", MOE_ARCHS[0]): (True, 2),
              ("model2", MOE_ARCHS[1]): (True, 2),
              ("model4", MOE_ARCHS[1]): (True, 1),
              ("data2_model2", MOE_ARCHS[1]): (True, 2)}


@pytest.mark.parametrize("name,arch", sorted(MOE_LAYOUT))
def test_tp_moe_serving_matches_jax(ranks, name, arch):
    """A MoE smoke served tensor-parallel: every shard the JAX package's
    ``param_spec(mode="serve")`` block (cut from the whole tree, and
    carried by DDMA from the trainer's FSDP + TP DTensors; llama4-scout's
    ``wq wk wv wo`` a 1/m share on every mesh), E/m experts a rank, the
    reference executor's too; prefill and three decode steps' logits within 1e-5
    of JAX's (relative to max(1, |logit|)), the rollout's tokens under
    one key identical and its behaviour log-probs within 1e-5."""
    want, got = ranks
    want = want[arch]
    heads, experts = MOE_LAYOUT[name, arch]
    for rank, (res, arrays) in enumerate(got):
        r = res[f"{name}|{arch}"]
        n, ok = r["shards_ok"]
        assert ok and n > 0, (name, arch, rank)
        assert r["tp"] and r["heads"] == heads, r
        if arch == MOE_ARCHS[0]:
            assert r["proj"] == (not heads), r
            _check_attn_quarters(r, MODEL_SIZE[name], (name, arch, rank))
        assert r["experts"] and r["shared"] and r["vocab"], r
        assert r["held_experts"] == r["ref_experts"] == experts, r
        _check_moe_serving(arrays, want, f"{name}|{arch}|", (name, arch,
                                                             rank))


def _check_moe_serving(arrays, want, key, label, drop=""):
    """Prefill and decode logits within TOL of max(1, |logit|) of the JAX
    package's, the rollout's tokens equal and its behaviour log-probs
    within TOL (the keys ``drop`` + name)."""
    for k in ("prefill", "decode0", "decode1", "decode2"):
        w = want[drop + k]
        err = np.max(np.abs(arrays[key + drop + k] - w))
        assert err <= TOL * max(1.0, np.max(np.abs(w))), (label, k, err)
    np.testing.assert_array_equal(arrays[key + drop + "tokens"],
                                  want[drop + "tokens"])
    assert np.max(np.abs(arrays[key + drop + "blp"] - want[drop + "blp"])) \
        <= TOL, label


def _check_moe_scoring(arrays, want, key, label):
    lp = arrays[key]
    assert lp.shape == want.shape, label
    err = np.abs(lp - want) / np.maximum(1.0, np.abs(want))
    assert err.max() <= TOL, (label, err.max())


@pytest.mark.parametrize("name,arch", sorted(MOE_LAYOUT))
def test_tp_moe_reference_scoring_matches_jax(ranks, name, arch):
    """A reference executor on the mesh scores a MoE smoke on its TP
    shard: its ``ref_logp`` within 1e-5 of the JAX package's forward and
    log-softmax (relative to max(1, |logp|)), on every rank."""
    want, got = ranks
    for rank, (_, arrays) in enumerate(got):
        _check_moe_scoring(arrays, want[arch]["ref_logp"],
                           f"{name}|{arch}|ref_logp", (name, arch, rank))


@pytest.mark.parametrize("name,arch", sorted(MOE_LAYOUT))
def test_tp_moe_matches_jax_where_the_capacity_drops(ranks, name, arch):
    """At the published capacity factor DROP_CF the smokes' prefills
    (8 tokens a row: llama4-scout's 4 experts take 2 choices each,
    deepseek-v3's 5 of 16) and scoring (14: 4 and 8) drop choices, which
    a rank's own experts must drop as the gathered path does: the TP
    prefill, decode steps, rollout and reference scoring hold to the JAX
    package's at DROP_CF at the bounds above.  The drops show: JAX's
    prefill logits and scoring at DROP_CF differ from its own at the
    smoke's capacity factor, which drops nothing."""
    want, got = ranks
    want = want[arch]
    for k in ("prefill", "ref_logp"):
        assert np.max(np.abs(want["drop|" + k] - want[k])) > 1e-3, \
            (arch, k, DROP_CF)
    for rank, (_, arrays) in enumerate(got):
        label = (name, arch, rank, DROP_CF)
        _check_moe_serving(arrays, want, f"{name}|{arch}|", label,
                           drop="drop|")
        _check_moe_scoring(arrays, want["drop|ref_logp"],
                           f"{name}|{arch}|drop|ref_logp", label)


def test_tp_moe_experts_kept_whole_where_the_axis_does_not_divide(ranks):
    """llama4-scout's smoke with 6 experts on (1, 4): every rank holds the
    6 experts whole and its quarter of the shared expert's columns, and
    its TP forward matches the port's one-device forward (logits within
    1e-5 of max(1, |logit|), moe_aux within 1e-6)."""
    _, got = ranks
    for res, _ in got:
        r = res["experts_whole"]
        assert not r["experts"] and r["shared"], r
        assert r["held_experts"] == 6 and r["shared_cols"] == 128, r
        assert r["logits"] <= TOL * max(1.0, r["scale"]), r
        assert r["aux"] <= 1e-6, r


def test_tp_moe_generator_executor(ranks):
    """On a (1, 2) mesh a llama4-scout generator holds its TP shard (2 of
    the smoke's 4 experts, half the shared expert's columns) and emits
    the unmeshed generator's batch."""
    _, got = ranks
    for res, _ in got:
        r = res["moe_executor"]
        assert r["tp"] and r["wq"] == [2, 256, 128], r
        assert r["held"]["moe_layers/moe/w_gate"] == [2, 2, 256, 512], r
        assert r["held"]["moe_layers/moe/shared/w_up"] == [2, 256, 256], r
        assert r["tokens_equal"] and r["mask_equal"], r
        assert r["blp"] <= TOL, r


@pytest.mark.parametrize("m", [1, 2, 3, 5])
def test_vocab_parallel_merge_rule_matches_jax(m):
    """``dispatch.merge_logprob_partials`` of B1's plain version on m
    uneven vocabulary slices (V 515) against the JAX package's
    ``fused_logprob`` of the whole rows (interpret mode): log-probs and
    the max within 1e-6; B2's plain version on each slice with the
    merged (M, log s), concatenated, against ``fused_logprob_bwd`` within
    1e-6."""
    import torch
    from repro_torch.kernels.dispatch import merge_logprob_partials
    from repro_torch.kernels.fused_logprob import fused_logprob_bwd_plain, \
        fused_logprob_plain
    rng = np.random.default_rng(m)
    R, V = 12, 515
    x = (rng.standard_normal((R, V)) * 4).astype(np.float32)
    tok = rng.integers(0, V, R).astype(np.int32)
    g = rng.standard_normal(R).astype(np.float32)
    want, wm, ws = jlogprob(jnp.asarray(x), jnp.asarray(tok), interpret=True,
                            return_stats=True)
    want_d = jlogprob_bwd(jnp.asarray(x), jnp.asarray(tok), wm, jnp.log(ws),
                          jnp.asarray(g), interpret=True)
    cuts = np.linspace(0, V, m + 1).astype(int)
    xt, tt = torch.as_tensor(x), torch.as_tensor(tok).long()
    parts = []
    for a, b in zip(cuts, cuts[1:]):
        local = tt - int(a)
        _, mi, si = fused_logprob_plain(xt[:, a:b], local)
        inside = (local >= 0) & (local < b - a)
        t = torch.where(inside, xt[:, a:b].gather(
            1, local.clamp(0, b - a - 1)[:, None])[:, 0], -1e30)
        parts.append(torch.stack([mi, si, t], dim=-1))
    lp, M, log_s = merge_logprob_partials(torch.stack(parts))
    assert np.max(np.abs(lp.numpy() - np.asarray(want))) <= 1e-6
    np.testing.assert_array_equal(M.numpy(), np.asarray(wm))
    d = torch.cat([fused_logprob_bwd_plain(xt[:, a:b], tt - int(a), M, log_s,
                                           torch.as_tensor(g))
                   for a, b in zip(cuts, cuts[1:])], dim=1)
    assert np.max(np.abs(d.numpy() - np.asarray(want_d))) <= 1e-6
