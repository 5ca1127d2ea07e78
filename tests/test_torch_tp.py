"""Tensor-parallel serving of the dense family (``repro_torch.models.tp``,
``sharding.tp_plan``, ``dispatch.sample_vocab_parallel``, the generator
executor on a mesh) on gloo ranks on the CPU, against the JAX package's
single-device serving steps.

One spawn of four ranks runs three meshes over them: two (1, 2) meshes
at once (ranks 0-1 and 2-3), a (1, 4) and a (2, 2).  llama31-smoke has 8
query and 2 KV heads, so (1, 2) splits the heads and (1, 4) (2 % 4 != 0)
runs attention whole on every rank while the FFN and the vocabulary
split; (2, 2) splits the heads over ``model`` and the rows over
``data``.  The JAX runs (``repro.models.serve.prefill``,
``decode_step``, ``repro.rl.rollout.generate`` from one init, carried
across by ``convert``) are made here while the ranks start.  Each mesh
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
runs them, within 1e-5.
Rendezvous is a ``file://`` in the test's own tmp_path."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch.multiprocessing as mp

from repro.configs.llama_paper import smoke as jsmoke
from repro.kernels.fused_logprob import fused_logprob as jlogprob
from repro.kernels.fused_logprob import fused_logprob_bwd as jlogprob_bwd
from repro.models import forward_train as jforward
from repro.models import init_params as jinit
from repro.models.serve import decode_step as jdecode
from repro.models.serve import prefill as jprefill
from repro.rl.rollout import generate as jgenerate
from _tp_ranks import B, CACHE, MAX_NEW, MESHES, PROMPT, TEMP, rank_main

TOL = 1e-5
WORLD = 4


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
           "vp_tokens": vtok, "vp_g": g}
    return ref, out


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
# cache's k [L, rows, Sc, K, hd]) for llama31-smoke (8 heads of 32, 2 KV)
LAYOUT = {"model2": (True, [2, 256, 128], [2, 4, CACHE, 1, 32]),
          "model4": (False, [2, 256, 256], [2, 4, CACHE, 2, 32]),
          "data2_model2": (True, [2, 256, 128], [2, 2, CACHE, 1, 32])}


@pytest.mark.parametrize("name", [m[0] for m in MESHES])
def test_tp_serving_matches_jax(ranks, name):
    want, got = ranks
    heads, wq, cache_k = LAYOUT[name]
    for rank, (res, arrays) in enumerate(got):
        r = res[name]
        n, ok = r["shards_ok"]
        assert ok and n > 0, (name, rank)
        assert r["heads"] == heads and r["ffn"] and r["vocab"], r
        assert r["wq"] == wq, (name, rank, r)
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
    size = {m[0]: m[1][1] for m in MESHES}[name]
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
