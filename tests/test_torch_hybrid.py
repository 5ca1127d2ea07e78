"""The port's hybrid family (zamba2-7b: Mamba2 layers and one shared
attention block) against the JAX package's, on the CPU.

Mamba2 as plain functions first (``mamba2_forward``, the chunked SSD, at
sequence lengths below, at and past a multiple of the chunk, with its
final state; ``mamba2_decode`` step by step against it and against the
reference's), then the family at its smoke config (2 Mamba layers, the
shared block every 2, d 256, SSM chunk 32) and at a ragged variant (5
layers, the block every 2: three applications, the last group of one
layer) through ``forward_train``, prefill + decode (the Mamba states and
the shared block's ring equal the reference's, also past its 4096
slots), batch rollouts, a train step, ``convert`` (the fp32 Mamba leaves
in a bf16 tree), a checkpoint round trip, the engine's refusal, and the
launcher's async loop against the JAX launcher's history.  Inputs are
made with numpy from a seed; JAX params cross through ``convert``;
everything runs in fp32.

Tolerances: ``EXACT`` (1e-5) between the two packages' Mamba2 outputs
and states, relative to max(1, max|value|) (fp32, the SSD's products
summed in another order: the reference's four-operand einsums are
pairwise products here); ``MODEL`` (1e-4) for whole-model logits,
caches and behaviour log-probs, relative likewise: that rounding noise
grows through the layers (at the ragged variant's 5 layers the logits
differ by up to 4e-5); ``DECODE`` (1e-3) for prefill +
decode against the forward and for the chunked SSD against the stepwise
recurrence, the reference's bounds (``tests/test_arch_smoke.py``,
``tests/test_models_unit.py``); ``STEP`` (1e-4 relative) for a train
step's loss, gradient norm and updated params, and for the launcher's
history.
"""
import argparse

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import decode_step as jdecode
from repro.models import forward_train as jforward
from repro.models import init_params as jinit
from repro.models import prefill as jprefill
from repro.models import serve as jserve
from repro.models import ssm as jssm
from repro.rl.rollout import generate as jgenerate
from repro.train import trainstep as jts
from repro_torch import configs, convert
from repro_torch.core.executor import GeneratorExecutor
from repro_torch.launch import train as launch
from repro_torch.models import backbone as bb
from repro_torch.models import decode_step, forward_train, init_params, \
    prefill, serve, ssm
from repro_torch.rl import prng
from repro_torch.rl.data import ArithmeticTasks
from repro_torch.rl.rollout import generate
from repro_torch.train import checkpoint
from repro_torch.train import optimizer as opt
from repro_torch.train import trainstep as ts

ARCH = "zamba2-7b"
EXACT = 1e-5
MODEL = 1e-4            # whole-model logits and log-probs against JAX
DECODE = 1e-3           # the reference's prefill + decode and SSD bounds
STEP = 1e-4             # a train step's loss, grad norm and params
FP32_LEAVES = ("A_log", "D_skip", "dt_bias")


def _variant(cfg, name):
    """The smoke config, or its ragged variant: 5 layers, the shared
    block every 2, so three applications and a last group of one."""
    return cfg if name == "smoke" else cfg.replace(n_layers=5)


@pytest.fixture(scope="module", params=["smoke", "ragged"])
def model(request):
    """(port cfg, JAX cfg, JAX params, port params), fp32."""
    tcfg = _variant(configs.get_smoke(ARCH), request.param)
    jcfg = _variant(jconfigs.get_smoke(ARCH), request.param)
    jp = jinit(jcfg, jax.random.PRNGKey(0), jnp.float32)
    return tcfg, jcfg, jp, convert.from_jax_numpy(jax.device_get(jp),
                                                  device="cpu")


@pytest.fixture(scope="module")
def layer():
    """One Mamba2 layer's params from the JAX init (A_log, D_skip and
    dt_bias drawn so the decays differ by head), for both packages."""
    jcfg = jconfigs.get_smoke(ARCH)
    jp = dict(jssm.mamba2_params(jax.random.PRNGKey(3), jcfg, jnp.float32))
    rng = np.random.default_rng(3)
    H = jp["A_log"].shape[0]
    for k, lo, hi in (("A_log", -1.0, 1.0), ("D_skip", 0.5, 1.5),
                      ("dt_bias", -2.0, 0.5)):
        jp[k] = jnp.asarray(rng.uniform(lo, hi, H).astype(np.float32))
    return jp, convert.from_jax_numpy(jax.device_get(jp), device="cpu")


def _maxdiff(t, j):
    return float(np.max(np.abs(t.detach().float().numpy()
                               - np.asarray(j, dtype=np.float32))))


def _relerr(t, j):
    """The largest gap over max(1, the largest |value| of ``j``)."""
    return _maxdiff(t, j) / max(1.0, float(np.max(np.abs(np.asarray(j)))))


def _x(cfg, B, S, seed, scale=0.3):
    return (np.random.default_rng(seed).standard_normal(
        (B, S, cfg.d_model)) * scale).astype(np.float32)


# --------------------------------------------------------------- Mamba2 --

@pytest.mark.parametrize("S", [20, 32, 48, 70])
def test_mamba2_forward_matches_jax(layer, S):
    """The chunked SSD at S below the chunk (32), at it, and past it
    (ragged: 48, 70): y and the final conv and SSM states within 1e-5 of
    the reference's; the conv state is fp32 after a prefill."""
    cfg = configs.get_smoke(ARCH)
    jp, tp = layer
    x = _x(cfg, 2, S, S)
    jy, jst = jssm.mamba2_forward(jp, jnp.asarray(x), jconfigs.get_smoke(ARCH),
                                  return_state=True)
    y, st = ssm.mamba2_forward(tp, torch.as_tensor(x), cfg,
                               return_state=True)
    assert y.shape == (2, S, cfg.d_model)
    assert _relerr(y, jy) < EXACT
    assert st["conv"].dtype == st["ssm"].dtype == torch.float32
    assert _maxdiff(st["conv"], jst["conv"]) < EXACT
    assert _relerr(st["ssm"], jst["ssm"]) < EXACT
    assert torch.equal(y, ssm.mamba2_forward(tp, torch.as_tensor(x), cfg))


def test_mamba2_chunked_matches_stepwise(layer):
    """``tests/test_models_unit.py::test_mamba2_chunked_matches_stepwise``
    at S = 45, not a multiple of the chunk: the chunked forward against
    ``mamba2_decode`` step by step within 1e-3 (the reference's bound;
    here 1e-5 relative holds), each step within 1e-5 of the reference's
    step, and the final states equal the forward's."""
    cfg = configs.get_smoke(ARCH)
    jp, tp = layer
    B, S = 2, 45
    x = _x(cfg, B, S, 1)
    y_full, st_full = ssm.mamba2_forward(tp, torch.as_tensor(x), cfg,
                                         return_state=True)
    st = ssm.mamba2_init_state(cfg, B, device="cpu")
    jst = jssm.mamba2_init_state(jconfigs.get_smoke(ARCH), B)
    ys = []
    for t in range(S):
        yt, st = ssm.mamba2_decode(tp, torch.as_tensor(x[:, t:t + 1]), st,
                                   cfg)
        jyt, jst = jssm.mamba2_decode(jp, jnp.asarray(x[:, t:t + 1]), jst,
                                      jconfigs.get_smoke(ARCH))
        assert _relerr(yt, jyt) < EXACT, t
        ys.append(yt)
    y_step = torch.cat(ys, dim=1)
    assert _maxdiff(y_full, y_step.numpy()) < DECODE
    assert _relerr(y_full, y_step.numpy()) < EXACT
    assert _relerr(st["ssm"], st_full["ssm"].numpy()) < EXACT
    assert _maxdiff(st["conv"], st_full["conv"].numpy()) < EXACT


def test_mamba2_gradient_stays_finite_where_the_decay_overflows(layer):
    """With steps large enough that exp(cum_i - cum_j) above the diagonal
    overflows (dt about 8 and A = -e over a chunk of 32: |cum| reaches
    hundreds, as at zamba2's full width in training), the forward equals
    the reference's within 1e-5, and the port's gradient is finite where
    the reference's (exp, then mask: inf * 0) is NaN."""
    cfg = configs.get_smoke(ARCH)
    jcfg = jconfigs.get_smoke(ARCH)
    jp, _ = layer
    jp = dict(jp, A_log=jnp.ones_like(jp["A_log"]),
              dt_bias=jnp.full_like(jp["dt_bias"], 8.0))
    tp = convert.from_jax_numpy(jax.device_get(jp), device="cpu")
    x = _x(cfg, 2, 48, 9)
    jy = jssm.mamba2_forward(jp, jnp.asarray(x), jcfg)
    y = ssm.mamba2_forward(tp, torch.as_tensor(x), cfg)
    assert _relerr(y, jy) < EXACT
    jg = jax.grad(lambda p: jnp.sum(jssm.mamba2_forward(
        p, jnp.asarray(x), jcfg)))(jp)
    assert np.isnan(np.asarray(jg["w_in"])).any()
    leaves = {k: v.clone().requires_grad_() for k, v in tp.items()}
    ssm.mamba2_forward(leaves, torch.as_tensor(x), cfg).sum().backward()
    for k, v in leaves.items():
        assert bool(torch.isfinite(v.grad).all()), k
    ok = ~np.isnan(np.asarray(jg["w_in"]))
    assert _relerr(leaves["w_in"].grad[ok], np.asarray(jg["w_in"])[ok]) \
        < EXACT


def test_mamba2_decode_keeps_the_conv_state_in_x_dtype(layer):
    """In bf16 a decode step returns the convolution's inputs in x's dtype
    and h in fp32, as the reference does; a prefill's state is fp32."""
    cfg = configs.get_smoke(ARCH)
    _, tp = layer
    bf = {k: v if k in FP32_LEAVES else v.to(torch.bfloat16)
          for k, v in tp.items()}
    x = torch.as_tensor(_x(cfg, 2, 5, 2)).to(torch.bfloat16)
    y, st = ssm.mamba2_forward(bf, x, cfg, return_state=True)
    assert y.dtype == torch.bfloat16 and st["conv"].dtype == torch.float32
    y1, st1 = ssm.mamba2_decode(bf, x[:, :1], st, cfg)
    assert y1.dtype == st1["conv"].dtype == torch.bfloat16
    assert st1["ssm"].dtype == torch.float32


# --------------------------------------------------------------- family --

def test_params_and_cache_layout_match_jax(model):
    """The same keys, shapes and dtypes as the JAX init, in fp32 and in
    bf16 (A_log, D_skip and dt_bias stay fp32; ``shared_attn`` has no
    leading axis), each leaf's standard deviation within 5% of the JAX
    init's, and the cache's Mamba states and ring equal the reference's
    in shape, the ring capped at 4096 slots."""
    tcfg, jcfg, jp, _ = model
    for dtype in ("float32", "bfloat16"):
        want = jax.device_get(jinit(jcfg, jax.random.PRNGKey(0),
                                    getattr(jnp, dtype)))
        own = convert.to_jax_numpy(init_params(
            tcfg, 0, getattr(torch, dtype), device="cpu"))
        jflat = jax.tree_util.tree_flatten_with_path(want)[0]
        mine = dict(jax.tree_util.tree_flatten_with_path(own)[0])
        assert len(mine) == len(jflat)
        for path, j in jflat:
            t = mine[path]
            assert t.shape == j.shape and t.dtype == j.dtype, path
            js, tsd = float(np.std(j.astype(np.float32))), \
                float(np.std(t.astype(np.float32)))
            assert (tsd == 0) if js == 0 else abs(tsd - js) <= 0.05 * js, \
                path
        for k in FP32_LEAVES:
            assert own["mamba_layers"]["mamba"][k].dtype == np.float32
    assert own["shared_attn"]["attn"]["wq"].ndim == 2
    for cache_len in (40, 5000):
        cache = serve.init_cache(tcfg, 2, cache_len, torch.float32,
                                 device="cpu")
        jcache = jserve.init_cache(jcfg, 2, cache_len, jnp.float32)
        for part in ("mamba", "attn"):
            for k, v in cache[part].items():
                assert tuple(v.shape) == jcache[part][k].shape, (part, k)
                assert str(v.dtype)[6:] == str(jcache[part][k].dtype)
        assert cache["attn"]["k"].shape[2] == min(cache_len, 4096)
        assert cache["attn"]["k"].shape[0] == len(bb.hybrid_groups(tcfg))


@pytest.mark.parametrize("S", [16, 45])
def test_forward_train_matches_jax(model, S):
    """Logits within 1e-4 of max(1, max|logit|) of the JAX forward's;
    the shared block runs ceil(L / 2) times."""
    tcfg, jcfg, jp, tp = model
    toks = np.random.default_rng(S).integers(0, tcfg.vocab, (2, S)
                                             ).astype(np.int32)
    want, _ = jforward(jp, jcfg, {"tokens": jnp.asarray(toks)})
    got, aux = forward_train(tp, tcfg, {"tokens": torch.as_tensor(toks)})
    assert got.shape == (2, S, tcfg.vocab)
    assert bool(torch.isfinite(got).all())
    assert _relerr(got, want) < MODEL
    assert len(bb.hybrid_groups(tcfg)) == -(-tcfg.n_layers // 2)


def test_prefill_decode_matches_forward_and_jax(model):
    """Prefill of 40 (past one SSD chunk of 32) then four decode steps:
    the last prefill row and every step equal the teacher-forced forward
    (1e-3, the reference's bound) and the JAX ones (1e-4); the Mamba
    states and the shared block's ring equal the JAX caches (1e-4)."""
    tcfg, jcfg, jp, tp = model
    B, S, n = 2, 40, 4
    toks = np.random.default_rng(7).integers(0, tcfg.vocab, (B, S + n)
                                             ).astype(np.int32)
    full, _ = forward_train(tp, tcfg, {"tokens": torch.as_tensor(toks)})
    last, cache = prefill(tp, tcfg, {"tokens": torch.as_tensor(toks[:, :S])},
                          cache_len=S + 8, dtype=torch.float32)
    jlast, jcache = jprefill(jp, jcfg, {"tokens": jnp.asarray(toks[:, :S])},
                             cache_len=S + 8, dtype=jnp.float32)
    assert _maxdiff(last, full[:, S - 1].detach().numpy()) < DECODE
    assert _relerr(last, jlast) < MODEL
    for i in range(n):
        t = toks[:, S + i:S + i + 1]
        lg, cache = decode_step(tp, tcfg, cache, torch.as_tensor(t))
        jlg, jcache = jdecode(jp, jcfg, jcache, jnp.asarray(t))
        assert _maxdiff(lg, full[:, S + i].detach().numpy()) < DECODE, i
        assert _relerr(lg, jlg) < MODEL, i
    assert cache["pos"] == int(jcache["pos"]) == S + n
    assert np.array_equal(cache["attn"]["slot_pos"].numpy(),
                          np.asarray(jcache["attn"]["slot_pos"]))
    for part, keys in (("attn", ("k", "v")), ("mamba", ("conv", "ssm"))):
        for k in keys:
            assert _relerr(cache[part][k], jcache[part][k]) < MODEL, (part, k)


def test_decode_past_the_4096_slot_ring_matches_jax():
    """The shared block's ring holds min(cache_len, 4096) slots, the
    reference's own: a prefill of 4094 ids then four steps past slot 4096
    wrap it, and the logits and the Mamba states stay within 1e-4 of the
    reference's, the ring's positions equal to them."""
    tcfg, jcfg = configs.get_smoke(ARCH), jconfigs.get_smoke(ARCH)
    tcfg, jcfg = (c.replace(max_seq=8192) for c in (tcfg, jcfg))
    jp = jinit(jcfg, jax.random.PRNGKey(2), jnp.float32)
    tp = convert.from_jax_numpy(jax.device_get(jp), device="cpu")
    S, n = 4094, 4
    toks = np.random.default_rng(2).integers(0, tcfg.vocab, (1, S + n)
                                             ).astype(np.int32)
    last, cache = prefill(tp, tcfg, {"tokens": torch.as_tensor(toks[:, :S])},
                          cache_len=S + n, dtype=torch.float32)
    jlast, jcache = jprefill(jp, jcfg, {"tokens": jnp.asarray(toks[:, :S])},
                             cache_len=S + n, dtype=jnp.float32)
    assert cache["attn"]["k"].shape[2] == 4096
    assert _relerr(last, jlast) < MODEL
    for i in range(n):
        t = toks[:, S + i:S + i + 1]
        lg, cache = decode_step(tp, tcfg, cache, torch.as_tensor(t))
        jlg, jcache = jdecode(jp, jcfg, jcache, jnp.asarray(t))
        assert _relerr(lg, jlg) < MODEL, i
    sp = cache["attn"]["slot_pos"].numpy()
    assert np.array_equal(sp, np.asarray(jcache["attn"]["slot_pos"]))
    assert sp[0] == 4096 and sp[1] == 4097 and sp.min() == 2
    assert _relerr(cache["mamba"]["ssm"], jcache["mamba"]["ssm"]) < MODEL


def test_batch_rollout_matches_jax(model):
    """``generate`` in chunks from the same key words: the same tokens bit
    for bit, the behaviour log-probs within 1e-4."""
    tcfg, jcfg, jp, tp = model
    prompts = np.random.default_rng(11).integers(
        3, tcfg.vocab, (3, 12)).astype(np.int32)
    js = jgenerate(jp, jcfg, jnp.asarray(prompts), max_new=10,
                   key=jax.random.PRNGKey(5), temperature=1.0, chunk=4)
    tst = generate(tp, tcfg, torch.as_tensor(prompts), max_new=10,
                   key=prng.PRNGKey(5), temperature=1.0, chunk=4)
    assert np.array_equal(tst.tokens.numpy(), np.asarray(js.tokens))
    assert _relerr(tst.behavior_logp, js.behavior_logp) < MODEL
    assert np.array_equal(tst.done.numpy(), np.asarray(js.done))


def _jax_paths(tree):
    return {tuple(p.key for p in path): np.asarray(leaf) for path, leaf in
            jax.tree_util.tree_flatten_with_path(jax.device_get(tree))[0]}


def test_train_step_matches_jax(model):
    """One ``make_train_step`` from the JAX init: loss and ``grad_norm``
    within 1e-4 relative of the JAX step's; the updated params within
    1e-4 wherever the reference's clipped gradient is at least 1e-6 and
    within 2 lr elsewhere (see ``tests/test_torch_mla.py``); the shared
    block, every Mamba matrix and the fp32 Mamba leaves moved."""
    tcfg, jcfg, jp, tp = model
    rng = np.random.default_rng(4)
    B, T, lr = 2, 40, 1e-3
    mask = np.zeros((B, T), np.float32)
    mask[:, 8:] = rng.uniform(size=(B, T - 8)) > 0.1
    batch = {
        "tokens": rng.integers(0, tcfg.vocab, (B, T)).astype(np.int32),
        "behavior_logp": (rng.uniform(-8, -4, (B, T)) * mask
                          ).astype(np.float32),
        "advantages": (rng.standard_normal((B, 1)) * mask).astype(np.float32),
        "mask": mask,
    }
    jbatch = jax.tree.map(jnp.asarray, batch)
    jnew, jm = jax.jit(jts.make_train_step(jcfg, lr=lr))(
        jts.TrainState(params=jp, opt=jts.adam_init(jp)), jbatch)
    tnew, tm = ts.make_train_step(tcfg, lr=lr)(
        ts.TrainState(tp, opt.adam_init(tp)),
        {k: torch.as_tensor(v) for k, v in batch.items()})
    for k in ("loss", "grad_norm"):
        assert abs(float(tm[k]) - float(jm[k])) <= STEP * abs(float(jm[k])), k
    jgrads = _jax_paths(jax.jit(jax.grad(
        lambda p, b: jts.make_loss_fn(jcfg)(p, b)[0]))(jp, jbatch))
    clip = min(1.0, 1.0 / float(jm["grad_norm"]))
    new = _jax_paths(convert.to_jax_numpy(tnew.params))
    old = _jax_paths(convert.to_jax_numpy(tp))
    for path, jg in _jax_paths(jnew.params).items():
        gap = np.abs(new[path] - jg)
        sure = np.abs(jgrads[path] * clip) >= 1e-6
        assert np.all(gap[sure] <= STEP * np.maximum(1, np.abs(jg[sure]))), \
            path
        assert np.all(gap <= 2 * lr), path
    for path in new:
        if path[0] in ("shared_attn", "mamba_layers") and \
                not path[-1].startswith("ln") and path[-1] != "gate_norm":
            assert not np.array_equal(new[path], old[path]), path
    assert new[("mamba_layers", "mamba", "A_log")].dtype == np.float32


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_convert_keeps_the_mamba_leaves_fp32(dtype):
    """An fp32 JAX tree converted with ``dtype=bf16``: A_log, D_skip and
    dt_bias stay fp32 (so the decay exp(dt A) is the reference's), every
    other floating leaf is bf16; a JAX tree of either dtype crosses both
    ways bit for bit."""
    jcfg = jconfigs.get_smoke(ARCH)
    jp = jax.device_get(jinit(jcfg, jax.random.PRNGKey(1),
                              getattr(jnp, dtype)))
    cast = convert.from_jax_numpy(jp, dtype=torch.bfloat16, device="cpu")
    for k, v in cast["mamba_layers"]["mamba"].items():
        assert v.dtype == (torch.float32 if k in FP32_LEAVES
                           else torch.bfloat16), k
    assert cast["shared_attn"]["attn"]["wq"].dtype == torch.bfloat16
    tp = convert.from_jax_numpy(jp, device="cpu")
    back = convert.to_jax_numpy(tp)
    assert jax.tree.structure(back) == jax.tree.structure(jp)
    for a, b in zip(jax.tree.leaves(jp), jax.tree.leaves(back)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(a.view(np.uint8), b.view(np.uint8))


def test_bf16_train_step_and_checkpoint_keep_the_tree(tmp_path):
    """A bf16 train step keeps the fp32 Mamba leaves fp32 beside the bf16
    ones and ``shared_attn`` unstacked, and the params and fp32 Adam
    moments restore from a checkpoint bit for bit."""
    cfg = configs.get_smoke(ARCH)
    state = ts.init_train_state(cfg, 0, torch.bfloat16, device="cpu")
    rng = np.random.default_rng(6)
    B, T = 2, 24
    batch = {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab, (B, T))),
             "behavior_logp": torch.full((B, T), -5.0),
             "advantages": torch.as_tensor(
                 rng.standard_normal((B, T)).astype(np.float32)),
             "mask": torch.ones(B, T)}
    new, m = ts.make_train_step(cfg, lr=1e-3)(state, batch)
    assert np.isfinite(float(m["loss"]))
    mamba = new.params["mamba_layers"]["mamba"]
    for k, v in mamba.items():
        assert v.dtype == (torch.float32 if k in FP32_LEAVES
                           else torch.bfloat16), k
    assert not torch.equal(mamba["dt_bias"],
                           state.params["mamba_layers"]["mamba"]["dt_bias"])
    assert new.params["shared_attn"]["attn"]["wq"].dim() == 2
    path = str(tmp_path / "ckpt")
    tree = {"params": new.params, "m": new.opt.m, "v": new.opt.v}
    checkpoint.save_checkpoint(path, tree)
    flat = convert.to_jax_numpy(checkpoint.restore_checkpoint(path, tree))
    want = convert.to_jax_numpy(tree)
    for a, b in zip(jax.tree.leaves(want), jax.tree.leaves(flat)):
        assert a.dtype == b.dtype and np.array_equal(a.view(np.uint8),
                                                     b.view(np.uint8))


def test_engine_and_paged_layout_refuse_hybrid():
    """Both packages' engines refuse the hybrid family under either
    layout (its state cache is not paged KV), and so does the paged
    cache."""
    from repro.models.serve import assert_engine_cache as jassert
    tcfg, jcfg = configs.get_smoke(ARCH), jconfigs.get_smoke(ARCH)
    for layout in ("dense", "paged"):
        for fn, c in ((serve.assert_engine_cache, tcfg), (jassert, jcfg)):
            with pytest.raises(AssertionError, match="hybrid"):
                fn(c, layout)
    with pytest.raises(AssertionError, match="dense/moe"):
        serve.init_cache(tcfg, 2, 32, torch.float32, device="cpu",
                         layout="paged", page_size=4, n_pages=8)
    gen = GeneratorExecutor(tcfg, ArithmeticTasks(seed=0), n_prompts=1,
                            n_per_prompt=2, max_new=4, chunk=2, seed=0,
                            device="cpu")
    gen.set_weights(init_params(tcfg, 0, torch.float32, device="cpu"),
                    version=0)
    with pytest.raises(AssertionError, match="hybrid"):
        gen.engine_configure(kv_layout="paged", kv_page_size=4)


def test_launcher_tracks_the_jax_launcher():
    """``--arch zamba2-7b --smoke --steps 3`` through the port's launcher,
    from the JAX launcher's converted init, runs the async loop through
    the executors and the controller: the same steps, weight versions,
    staleness and rewards as the JAX launcher's history, and loss, mean
    log-prob, mean ratio and gradient norm within 1e-4 relative."""
    from repro.launch import train as jtrain
    from repro.train.trainstep import init_train_state as jinit_state

    args = launch.parse_args(["--arch", ARCH, "--smoke", "--device", "cpu",
                              "--steps", "3", "--transport", "inproc"])
    jargs = argparse.Namespace(**vars(args))
    jcfg = jconfigs.get_smoke(ARCH)
    jh = jtrain.build_controller(jcfg, jargs).run()
    jparams = jax.device_get(
        jinit_state(jcfg, jax.random.PRNGKey(0), jnp.float32).params)
    ctl = launch.build_controller(launch.config_for(args), args)
    trn = ctl.trainer.transport.executor

    def init_from_jax():
        params = convert.from_jax_numpy(jparams, device="cpu")
        trn.state = ts.TrainState(params, opt.adam_init(params))
        trn.set_output("policy_model", params)
    trn.init = init_from_jax
    th = ctl.run()
    assert len(jh) == len(th) == 3
    for j, t in zip(jh, th):
        for k in ("step", "weight_version", "sample_staleness",
                  "mean_reward"):
            assert t[k] == j[k], (t["step"], k)
        for k in ("loss", "mean_logp", "mean_ratio", "grad_norm"):
            assert abs(t[k] - j[k]) <= STEP * max(1.0, abs(j[k])), \
                (t["step"], k, t[k], j[k])
    full = launch.config_for(launch.parse_args(["--arch", ARCH]))
    assert full == configs.get_config(ARCH) and full.d_model == 3584
    bb.check_family(full)
