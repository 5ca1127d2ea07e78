"""The port's MoE family (llama4-scout-17b-a16e) against the JAX package's,
on the CPU.

The routing and the sort-based capacity dispatch as plain functions
(``_route``, ``_dispatch_group``, ``moe_forward``), then the family at
its smoke config (4 experts, top-1 sigmoid router, a shared expert,
window 64 every other layer) and two variants: ``fkd1`` puts one dense
layer before the MoE stack (``first_k_dense``, so the MoE stack starts at
global layer 1), and ``cf1`` sets the capacity factor to 1, so tokens
overflow their expert and are dropped.  Inputs are made with numpy from
a seed; JAX params cross through ``convert``.

Tolerances: 1e-5 of max(1, max|y|) for the MoE layer and 1e-6 for its aux
loss (fp32, the same products summed in another order); ``LOGITS``
(1e-4 fp32) between the two packages' logits; 1e-3 for prefill + decode
against the forward and 2e-3 for the ring past the window, the
reference's own bounds (``tests/test_arch_smoke.py``); 1e-4 relative for
a train step's loss, aux and gradient norm; 1e-4 for engine log-probs.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core.executor import GeneratorExecutor as JGenerator
from repro.models import decode_step as jdecode
from repro.models import ffn as jffn
from repro.models import forward_train as jforward
from repro.models import init_params as jinit
from repro.models import prefill as jprefill
from repro.models import serve as jserve
from repro.rl.data import ArithmeticTasks as JTasks
from repro.train import trainstep as jts
from repro_torch import configs, convert
from repro_torch.core.executor import GeneratorExecutor
from repro_torch.launch import train as launch
from repro_torch.models import backbone as bb
from repro_torch.models import decode_step, ffn, forward_train, \
    init_params, prefill, serve
from repro_torch.rl.data import ArithmeticTasks
from repro_torch.train import optimizer as opt
from repro_torch.train import trainstep as ts

ARCH = "llama4-scout-17b-a16e"
LOGITS = 1e-4
DECODE = 1e-3           # tests/test_arch_smoke.py: prefill + decode
RING = 2e-3             # tests/test_arch_smoke.py: ring past the window
STEP = 1e-4             # a train step's loss, moe_aux and grad_norm
ENGINE_MU = 1e-4


def _variant(cfg, name):
    if name == "fkd1":
        return cfg.replace(moe=dataclasses.replace(cfg.moe, first_k_dense=1))
    if name == "cf1":
        return cfg.replace(moe=dataclasses.replace(cfg.moe,
                                                   capacity_factor=1.0))
    return cfg


VARIANTS = ["smoke", "fkd1", "cf1"]


@pytest.fixture(scope="module")
def models():
    """variant -> (port cfg, JAX cfg, JAX params, port params), fp32."""
    out = {}
    for i, name in enumerate(VARIANTS):
        tcfg = _variant(configs.get_smoke(ARCH), name)
        jcfg = _variant(jconfigs.get_smoke(ARCH), name)
        jp = jinit(jcfg, jax.random.PRNGKey(i), jnp.float32)
        out[name] = (tcfg, jcfg, jp,
                     convert.from_jax_numpy(jax.device_get(jp), device="cpu"))
    return out


def _maxdiff(t, j):
    return float(np.max(np.abs(t.detach().numpy() - np.asarray(j))))


def _moe_cfgs(router, top_k, cf):
    """A port/JAX pair of MoE configs at d 64 with 4 experts."""
    def make(get):
        base = get(ARCH)
        return base.replace(d_model=64, moe=dataclasses.replace(
            base.moe, router=router, top_k=top_k, capacity_factor=cf,
            d_expert=96))
    return make(configs.get_smoke), make(jconfigs.get_smoke)


def _layer_params(jcfg, seed):
    """One layer's MoE params from the JAX init, for both packages."""
    jp = jffn.moe_params(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    return jp, convert.from_jax_numpy(jax.device_get(jp), device="cpu")


# ------------------------------------------------------------- routing ---

@pytest.mark.parametrize("router,top_k", [("sigmoid", 1), ("sigmoid", 2),
                                          ("softmax", 2)])
def test_route_matches_jax_with_ties(router, top_k):
    """Probabilities, weights and indices equal the reference's, and
    equal probabilities pick the lower expert first as ``jax.lax.top_k``
    does: experts 1 and 2 share a router column, so they tie for every
    token, and the rows scaled by 100 saturate the sigmoid to 1.0 in
    fp32 for every expert with a positive logit."""
    tcfg, jcfg = _moe_cfgs(router, top_k, 1.25)
    rng = np.random.default_rng(top_k)
    w = rng.standard_normal((64, 4)).astype(np.float32)
    w[:, 2] = w[:, 1]
    x = rng.standard_normal((2, 24, 64)).astype(np.float32)
    x[1, :8] *= 100.0
    jprobs, jw, jidx = jffn._route({"w_router": jnp.asarray(w)},
                                   jnp.asarray(x), jcfg.moe)
    probs, wts, idx = ffn._route({"w_router": torch.as_tensor(w)},
                                 torch.as_tensor(x), tcfg.moe)
    assert np.array_equal(idx.numpy(), np.asarray(jidx))
    assert _maxdiff(probs, jprobs) < 1e-6
    assert _maxdiff(wts, jw) < 1e-6
    # the crafted ties happened, and went to the lower index
    ties = np.asarray(jprobs)[..., 1] == np.asarray(jprobs)[..., 2]
    assert ties.all()
    if router == "sigmoid":
        assert (np.asarray(jprobs) == 1.0).sum(-1).max() >= 2
    first = idx.numpy()[..., 0]
    assert not ((first == 2) & ties).any()


@pytest.mark.parametrize("S,k,E,C", [
    (16, 1, 4, 5),      # room for all but a skewed expert's overflow
    (24, 2, 4, 3),      # top-2, heavy overflow
    (12, 1, 8, 1),      # the decode capacity of 1
    (10, 2, 3, 20),     # no overflow
])
def test_dispatch_group_matches_jax(S, k, E, C):
    """Buffer, ``dest``, ``valid`` and ``order`` of three groups bit-equal
    to the reference's vmapped ``_dispatch_group``; the skewed draw
    overflows some expert's capacity."""
    rng = np.random.default_rng(S + C)
    x = rng.standard_normal((3, S, 16)).astype(np.float32)
    idx = rng.choice(E, size=(3, S, k), p=np.r_[0.55, [0.45 / (E - 1)]
                                                * (E - 1)]).astype(np.int32)
    w = np.ones((S, k), np.float32)
    jout = jax.vmap(lambda xg, ig: jffn._dispatch_group(
        xg, ig, jnp.asarray(w), E, C))(jnp.asarray(x), jnp.asarray(idx))
    tout = ffn._dispatch_group(torch.as_tensor(x), torch.as_tensor(idx), E, C)
    for t, j in zip(tout, jout):
        assert np.array_equal(t.numpy(), np.asarray(j))
    assert not np.asarray(jout[2]).all() or C >= S * k


@pytest.mark.parametrize("router,top_k,cf", [("sigmoid", 1, 1.25),
                                             ("sigmoid", 1, 4.0),
                                             ("softmax", 2, 1.0)])
def test_moe_forward_matches_jax(router, top_k, cf):
    """y within 1e-5 of max(1, max|y|) and the aux loss within 1e-6, with
    drops (capacity factors 1 and 1.25) and without (4).  At the
    reference's init scale (expert std 1 / sqrt(E)) y's coordinates are
    of order 10-100, and one near 0 is a cancellation of such terms, so
    the error is held against the output's largest magnitude."""
    tcfg, jcfg = _moe_cfgs(router, top_k, cf)
    jp, tp = _layer_params(jcfg, 3)
    x = np.random.default_rng(9).standard_normal((3, 20, 64)
                                                 ).astype(np.float32)
    jy, jaux = jffn.moe_forward(jp, jnp.asarray(x), jcfg)
    y, aux = ffn.moe_forward(tp, torch.as_tensor(x), tcfg)
    jy = np.asarray(jy)
    assert np.max(np.abs(y.numpy() - jy)) < 1e-5 * max(1.0, np.abs(jy).max())
    assert abs(float(aux) - float(jaux)) < 1e-6


@pytest.mark.parametrize("mode", ["ep", "ep_shmap"])
def test_expert_parallel_modes_raise(mode):
    """With no mesh installed the expert-parallel modes take the gathered
    math, as the reference's do, bit for bit; a mode the reference does
    not know raises.  (The modes on a mesh: tests/test_torch_sharded.py.)"""
    tcfg, _ = _moe_cfgs("sigmoid", 1, 1.25)
    p = ffn.moe_params(torch.Generator().manual_seed(0), tcfg, 1,
                       torch.float32, "cpu")
    p = {k: v[0] if torch.is_tensor(v) else {n: t[0] for n, t in v.items()}
         for k, v in p.items()}
    x = torch.randn(2, 4, 64, generator=torch.Generator().manual_seed(1))
    y, aux = ffn.moe_forward(p, x, tcfg.replace(moe_mode=mode))
    y0, aux0 = ffn.moe_forward(p, x, tcfg)
    assert torch.equal(y, y0) and torch.equal(aux, aux0)
    with pytest.raises(ValueError, match="moe_mode"):
        ffn.moe_forward(p, x, tcfg.replace(moe_mode=mode + "_x"))


# ------------------------------------------------------------- family ----

@pytest.mark.parametrize("name", VARIANTS)
def test_stacks_and_cache_layout_match_jax(models, name):
    tcfg, jcfg, jp, tp = models[name]
    keys = [k for k, _, _ in bb.layer_stacks(tcfg)]
    assert keys == [k for k in ("dense_layers", "moe_layers") if k in jp]
    assert serve.segment_layout(tcfg) == jserve.segment_layout(jcfg)
    cache = serve.init_cache(tcfg, 2, 100, torch.float32, device="cpu")
    jcache = jserve.init_cache(jcfg, 2, 100, jnp.float32)
    assert [tuple(s["k"].shape) for s in cache["segments"]] == \
        [s["k"].shape for s in jcache["segments"]]


@pytest.mark.parametrize("S", [48, 100])
@pytest.mark.parametrize("name", VARIANTS)
def test_forward_train_matches_jax(models, name, S):
    """S = 48: the windows merge (window 64 >= S); S = 100 runs layer 0
    windowed.  Logits within 1e-4, the summed aux within 1e-6."""
    tcfg, jcfg, jp, tp = models[name]
    toks = np.random.default_rng(S).integers(0, tcfg.vocab, (2, S)
                                             ).astype(np.int32)
    want, jaux = jforward(jp, jcfg, {"tokens": jnp.asarray(toks)})
    got, aux = forward_train(tp, tcfg, {"tokens": torch.as_tensor(toks)})
    assert got.shape == (2, S, tcfg.vocab)
    assert _maxdiff(got, want) < LOGITS
    assert float(aux["moe_aux"]) > 0
    assert abs(float(aux["moe_aux"]) - float(jaux["moe_aux"])) < 1e-6


@pytest.mark.parametrize("name", VARIANTS)
def test_prefill_decode_matches_forward_and_jax(models, name):
    """Prefill then four decode steps equal the JAX ones (1e-4); where no
    token is dropped (capacity factor 4) they equal the teacher-forced
    forward too (1e-3).  With capacity factor 1 the forward's capacity
    at S tokens drops tokens that decode, one token a group, keeps."""
    tcfg, jcfg, jp, tp = models[name]
    B, S, n = 2, 32, 4
    toks = np.random.default_rng(7).integers(0, tcfg.vocab, (B, S + n)
                                             ).astype(np.int32)
    full, _ = forward_train(tp, tcfg, {"tokens": torch.as_tensor(toks)})
    last, cache = prefill(tp, tcfg, {"tokens": torch.as_tensor(toks[:, :S])},
                          cache_len=S + n + 4, dtype=torch.float32)
    jlast, jcache = jprefill(jp, jcfg, {"tokens": jnp.asarray(toks[:, :S])},
                             cache_len=S + n + 4, dtype=jnp.float32)
    exact = tcfg.moe.capacity_factor >= tcfg.moe.n_experts
    assert _maxdiff(last, jlast) < LOGITS
    if exact:
        assert _maxdiff(last, full[:, S - 1]) < DECODE
    for i in range(n):
        t = toks[:, S + i:S + i + 1]
        lg, cache = decode_step(tp, tcfg, cache, torch.as_tensor(t))
        jlg, jcache = jdecode(jp, jcfg, jcache, jnp.asarray(t))
        assert _maxdiff(lg, jlg) < LOGITS, i
        if exact:
            assert _maxdiff(lg, full[:, S + i]) < DECODE, i


@pytest.mark.parametrize("name", VARIANTS)
def test_ring_decode_past_the_window(models, name):
    """A prefill longer than the window leaves layer 0's ring of W slots
    holding its last W positions out of order; decoding wraps it again
    and equals the JAX ring's logits and slot positions, and the
    windowed forward (2e-3) where nothing is dropped."""
    tcfg, jcfg, jp, tp = models[name]
    W = tcfg.window
    B, S, n = 1, W + 6, 5
    toks = np.random.default_rng(4).integers(0, tcfg.vocab, (B, S + n)
                                             ).astype(np.int32)
    _, cache = prefill(tp, tcfg, {"tokens": torch.as_tensor(toks[:, :S])},
                       cache_len=S + n, dtype=torch.float32)
    _, jcache = jprefill(jp, jcfg, {"tokens": jnp.asarray(toks[:, :S])},
                         cache_len=S + n, dtype=jnp.float32)
    assert cache["segments"][0]["k"].shape[2] == W
    full, _ = forward_train(tp, tcfg, {"tokens": torch.as_tensor(toks)})
    exact = tcfg.moe.capacity_factor >= tcfg.moe.n_experts
    for i in range(n):
        t = toks[:, S + i:S + i + 1]
        lg, cache = decode_step(tp, tcfg, cache, torch.as_tensor(t))
        jlg, jcache = jdecode(jp, jcfg, jcache, jnp.asarray(t))
        assert _maxdiff(lg, jlg) < LOGITS, i
        if exact:
            assert _maxdiff(lg, full[:, S + i]) < RING, i
    for seg, jseg in zip(cache["segments"], jcache["segments"]):
        assert np.array_equal(seg["slot_pos"].numpy(),
                              np.asarray(jseg["slot_pos"]))
        assert _maxdiff(seg["k"], jseg["k"]) < LOGITS


@pytest.mark.parametrize("T", [24, 80])
@pytest.mark.parametrize("name", VARIANTS)
def test_train_step_matches_jax(models, name, T):
    """One ``make_train_step`` from the JAX init, inside the window and
    past it: loss, ``moe_aux`` and ``grad_norm`` within 1e-4 relative of
    the JAX step's, and the router moved."""
    tcfg, jcfg, jp, tp = models[name]
    rng = np.random.default_rng(T)
    B, prompt = 2, 8
    mask = np.zeros((B, T), np.float32)
    mask[:, prompt:] = rng.uniform(size=(B, T - prompt)) > 0.1
    batch = {
        "tokens": rng.integers(0, tcfg.vocab, (B, T)).astype(np.int32),
        "behavior_logp": (rng.uniform(-8, -4, (B, T)) * mask
                          ).astype(np.float32),
        "advantages": (rng.standard_normal((B, 1)) * mask).astype(np.float32),
        "mask": mask,
    }
    jstate = jts.TrainState(params=jp, opt=jts.adam_init(jp))
    _, jm = jax.jit(jts.make_train_step(jcfg, lr=1e-3))(
        jstate, jax.tree.map(jnp.asarray, batch))
    tstate = ts.TrainState(tp, opt.adam_init(tp))
    tnew, tm = ts.make_train_step(tcfg, lr=1e-3)(
        tstate, {k: torch.as_tensor(v) for k, v in batch.items()})
    for k in ("loss", "moe_aux", "grad_norm"):
        assert abs(float(tm[k]) - float(jm[k])) <= STEP * abs(float(jm[k])), k
    assert float(tm["moe_aux"]) > 0
    router = tnew.params["moe_layers"]["moe"]["w_router"]
    assert router.dtype == torch.float32
    assert not torch.equal(router, tp["moe_layers"]["moe"]["w_router"])


# -------------------------------------------------------- paged engine ---

def _engine(models, name, torch_side):
    tcfg, jcfg, jp, tp = models[name]
    kw = dict(n_prompts=2, n_per_prompt=2, max_new=6, chunk=2, seed=0)
    tasks = dict(prompt_len=tcfg.window + 6, max_operand=9, ops="+", seed=0)
    if torch_side:
        gen = GeneratorExecutor(tcfg, ArithmeticTasks(**tasks),
                                device="cpu", **kw)
        gen.set_weights(tp, version=0)
    else:
        gen = JGenerator(jcfg, JTasks(**tasks), **kw)
        gen.set_weights(jp, version=0)
    # a pool smaller than the batch: rows join mid-decode
    gen.engine_configure(max_running_rows=3, kv_layout="paged",
                         kv_page_size=4, row_budgets=[1, 3, 2])
    return gen


def _drain(gen, n_batches):
    for b in range(n_batches):
        gen.engine_enqueue(b, bound=1)
    items = []
    for _ in range(80):
        items += gen.engine_round(["completions"])
        if len(items) == n_batches:
            break
    assert len(items) == n_batches
    return [it["snapshot"]["completions"] for it in items]


@pytest.mark.parametrize("name", ["smoke", "cf1"])
def test_paged_engine_matches_jax(models, name):
    """Prompts past the window through a paged engine whose rows join
    mid-decode, with radix hits: a hit prefills only the prompt's suffix,
    whose capacity (from the suffix length) differs from the full
    prompt's, and with capacity factor 1 that changes which tokens are
    dropped.  Tokens and mask equal the JAX engine's, mu within 1e-4."""
    tgen, jgen = _engine(models, name, True), _engine(models, name, False)
    touts, jouts = _drain(tgen, 2), _drain(jgen, 2)
    assert tgen.engine_stats()["radix_hits"] > 0
    assert tgen.engine_stats()["radix_hits"] == \
        jgen.engine_stats()["radix_hits"]
    for t, j in zip(touts, jouts):
        for key in ("tokens", "mask"):
            assert np.array_equal(t[key].numpy(), np.asarray(j[key])), key
        assert _maxdiff(t["behavior_logp"], j["behavior_logp"]) < ENGINE_MU


# ------------------------------------------------------ params and init --

def test_convert_keeps_the_router_fp32():
    """A bf16 tree crosses both ways bit for bit, with ``w_router`` left
    in fp32, and a cast to bf16 on the way in leaves the router alone."""
    jcfg = jconfigs.get_smoke(ARCH)
    jp = jax.device_get(jinit(jcfg, jax.random.PRNGKey(0), jnp.bfloat16))
    assert jp["moe_layers"]["moe"]["w_router"].dtype == np.float32
    tp = convert.from_jax_numpy(jp, device="cpu")
    assert tp["moe_layers"]["moe"]["w_router"].dtype == torch.float32
    assert tp["moe_layers"]["moe"]["w_gate"].dtype == torch.bfloat16
    back = convert.to_jax_numpy(tp)
    for a, b in zip(jax.tree.leaves(jp), jax.tree.leaves(back)):
        assert a.dtype == b.dtype
        assert np.array_equal(a.view(np.uint8), b.view(np.uint8))
    jp32 = jax.device_get(jinit(jcfg, jax.random.PRNGKey(0), jnp.float32))
    cast = convert.from_jax_numpy(jp32, dtype=torch.bfloat16, device="cpu")
    assert cast["moe_layers"]["moe"]["w_router"].dtype == torch.float32
    assert cast["moe_layers"]["attn"]["wq"].dtype == torch.bfloat16
    own = init_params(configs.get_smoke(ARCH), 0, torch.bfloat16,
                      device="cpu")
    assert own["moe_layers"]["moe"]["w_router"].dtype == torch.float32


@pytest.mark.parametrize("name", ["smoke", "fkd1"])
def test_init_scale_matches_jax(models, name):
    """The port's init draws every leaf with the reference's scale: each
    leaf's standard deviation within 5% of the JAX init's (the expert
    leaves [L, E, D, F] take the reference's fan-in E, so their std is
    1 / sqrt(E), not 1 / sqrt(D)); the same keys, shapes and dtypes."""
    tcfg, jcfg, jp, _ = models[name]
    own = init_params(tcfg, 0, torch.float32, device="cpu")
    jflat = jax.tree_util.tree_flatten_with_path(jax.device_get(jp))[0]
    mine = {}

    def walk(t, path=()):
        for k, v in t.items():
            if isinstance(v, dict):
                walk(v, path + (k,))
            else:
                mine[path + (k,)] = v
    walk(own)
    assert len(mine) == len(jflat)
    for path, j in jflat:
        t = mine[tuple(p.key for p in path)]
        assert tuple(t.shape) == j.shape and str(j.dtype) == \
            str(t.dtype)[6:], path
        js, tsd = float(np.std(j)), float(t.std())
        if js == 0:
            assert tsd == 0, path
        else:
            assert abs(tsd - js) <= 0.05 * js, path
    expert = own["moe_layers"]["moe"]["w_gate"]
    assert abs(float(expert.std()) * np.sqrt(tcfg.moe.n_experts) - 1) < 0.05


# ------------------------------------------------------------ launcher ---

def test_launcher_runs_the_moe_smoke():
    """``--arch llama4-scout-17b-a16e --smoke --device cpu --steps 2``
    runs the async loop through the port's launcher: finite losses, a
    positive ``moe_aux`` and the staleness schedule."""
    out = launch.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                       "--steps", "2"])
    hist = out["history"]
    assert len(hist) == 2
    for h in hist:
        assert np.isfinite(h["loss"]) and h["moe_aux"] > 0
        assert h["weight_version"] == max(0, h["step"] - 1)
