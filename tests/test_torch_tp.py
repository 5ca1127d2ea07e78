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
executor's tokens.
Rendezvous is a ``file://`` in the test's own tmp_path."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch.multiprocessing as mp

from repro.configs.llama_paper import smoke as jsmoke
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
    ref = {"params": jax.device_get(params), "prompts": prompts,
           "decode_tokens": steps}
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


def test_tp_generator_executor(ranks):
    """On a (1, 2) mesh a dense generator holds its TP shard (half of
    wq's columns) and emits the unmeshed generator's batch."""
    _, got = ranks
    for res, _ in got:
        r = res["executor"]
        assert r["tp"] and r["wq"] == [2, 256, 128], r
        assert r["tokens_equal"] and r["mask_equal"], r
        assert r["blp"] <= TOL, r
