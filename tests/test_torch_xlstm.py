"""The port's SSM family (xlstm-350m: mLSTM and sLSTM blocks) against the
JAX package's, on the CPU.

The cells as plain functions first (``mlstm_forward``, the chunked
gated linear attention, at one chunk and at two; ``slstm_forward``, the
loop over time; each decode step by step against its forward and the
reference's decode), then the family at its smoke config (2 layers, the
second sLSTM, d 256, 4 heads) through ``forward_train``, prefill +
decode (the list of per-layer states equals the reference's), a batch
rollout, a train step, and the list tree through the tree helpers,
Adam, DDMA, ``convert``, the wire and a checkpoint; then the engine's
refusal and the launcher's async loop against the JAX launcher's
history.  Inputs are made with numpy from a seed; JAX params cross
through ``convert``; everything runs in fp32.

At the reference's init the sLSTM recurrence is chaotic: ``r_h`` [H, P,
4P] draws with H as its fan-in (std 1/2), so the recurrent gain is about
8 and a one-ulp change of the input grows about tenfold every 20 steps
(``test_slstm_at_its_init_amplifies_rounding`` shows it on the JAX
function alone); past some 30 steps no two fp32 implementations agree
to 1e-5, and at 128 the two packages' logits differ by 0.3.  So the
comparisons over up to 20 steps use the reference's init, and those
over 40 and 128 steps hold the same tolerances with ``r_h`` at a
quarter of its init (``_quarter_rh``, the same params in both
packages), where the recurrence is contractive; the mLSTM has no
hidden-to-hidden path and is compared at its init at every length.

Tolerances: ``EXACT`` (1e-5) between the two packages' cell outputs and
states, relative to max(1, max|value|) (fp32; the reference's
three-operand einsums are pairwise products here, summed in another
order); ``MODEL`` (1e-4) for whole-model logits, caches and behaviour
log-probs, relative likewise; ``DECODE`` (1e-3) for prefill + decode
against the forward and for the chunked mLSTM against its stepwise
decode, the reference's own bound (``tests/test_arch_smoke.py``);
``STEP`` (1e-4 relative) for a train step's loss, gradient norm and
updated params, and for the launcher's history.
"""
import argparse

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import backbone as jbb
from repro.models import decode_step as jdecode
from repro.models import forward_train as jforward
from repro.models import init_params as jinit
from repro.models import prefill as jprefill
from repro.models import serve as jserve
from repro.models import ssm as jssm
from repro.rl.rollout import generate as jgenerate
from repro.train import trainstep as jts
from repro_torch import configs, convert
from repro_torch.core import ddma, wire
from repro_torch.launch import train as launch
from repro_torch.models import backbone as bb
from repro_torch.models import decode_step, forward_train, init_params, \
    prefill, serve, ssm
from repro_torch.rl import prng
from repro_torch.rl.rollout import generate
from repro_torch.train import checkpoint
from repro_torch.train import optimizer as opt
from repro_torch.train import trainstep as ts

ARCH = "xlstm-350m"
EXACT = 1e-5
MODEL = 1e-4            # whole-model logits, caches and log-probs
DECODE = 1e-3           # the reference's prefill + decode bound
STEP = 1e-4             # a train step's loss, grad norm and params


def _quarter_rh(cell):
    """An sLSTM cell's params with ``r_h`` at a quarter of its init."""
    return dict(cell, r_h=cell["r_h"] * 0.25) if "r_h" in cell else cell


def _model(rh):
    """(port cfg, JAX cfg, JAX params, port params), fp32; ``rh="init"``
    is the reference's init, ``"quarter"`` its sLSTM ``r_h`` / 4."""
    tcfg, jcfg = configs.get_smoke(ARCH), jconfigs.get_smoke(ARCH)
    jp = jinit(jcfg, jax.random.PRNGKey(0), jnp.float32)
    if rh == "quarter":
        jp = dict(jp, xlstm_layers=[dict(p, cell=_quarter_rh(p["cell"]))
                                    for p in jp["xlstm_layers"]])
    return tcfg, jcfg, jp, convert.from_jax_numpy(jax.device_get(jp),
                                                  device="cpu")


@pytest.fixture(scope="module")
def model():
    return _model("init")


@pytest.fixture(scope="module")
def tame():
    return _model("quarter")


def _cell(kind, seed, rh="init"):
    """One cell's params from the JAX init (an sLSTM's ``r_h`` / 4 with
    ``rh="quarter"``), for both packages."""
    jcfg = jconfigs.get_smoke(ARCH)
    fn = jssm.mlstm_params if kind == "mlstm" else jssm.slstm_params
    jp = fn(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    if rh == "quarter":
        jp = _quarter_rh(jp)
    return jp, convert.from_jax_numpy(jax.device_get(jp), device="cpu")


def _maxdiff(t, j):
    return float(np.max(np.abs(t.detach().float().numpy()
                               - np.asarray(j, dtype=np.float32))))


def _relerr(t, j):
    """The largest gap over max(1, the largest |value| of ``j``)."""
    return _maxdiff(t, j) / max(1.0, float(np.max(np.abs(np.asarray(j)))))


def _x(cfg, B, S, seed, scale=0.5):
    return (np.random.default_rng(seed).standard_normal(
        (B, S, cfg.d_model)) * scale).astype(np.float32)


def _jax_leaves(tree):
    """A tree's leaves as numpy arrays in JAX's order (a dict's keys
    sorted)."""
    return jax.tree.leaves(convert.to_jax_numpy(tree))


def _state_pairs(st, jst):
    """(port tensor, JAX array) pairs of an mLSTM (C, n) tuple or an
    sLSTM {"h", "c", "n", "m"} dict."""
    if isinstance(st, dict):
        return [(st[k], jst[k]) for k in ("h", "c", "n", "m")]
    return list(zip(st, jst))


# ---------------------------------------------------------------- cells --

@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
@pytest.mark.parametrize("S", [40, 128])
def test_cell_forward_matches_jax(kind, S):
    """``mlstm_forward`` at one chunk (40) and two (128) and
    ``slstm_forward`` (``r_h`` / 4) at the same lengths: y and the final
    state within 1e-5 of the reference's; the states are fp32."""
    cfg, jcfg = configs.get_smoke(ARCH), jconfigs.get_smoke(ARCH)
    jp, tp = _cell(kind, S, "init" if kind == "mlstm" else "quarter")
    x = _x(cfg, 2, S, S)
    fwd, jfwd = ((ssm.mlstm_forward, jssm.mlstm_forward) if kind == "mlstm"
                 else (ssm.slstm_forward, jssm.slstm_forward))
    jy, jst = jfwd(jp, jnp.asarray(x), jcfg)
    y, st = fwd(tp, torch.as_tensor(x), cfg)
    assert y.shape == (2, S, cfg.d_model)
    assert _relerr(y, jy) < EXACT
    for t, j in _state_pairs(st, jst):
        assert t.dtype == torch.float32
        assert _relerr(t, j) < EXACT


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_cell_decode_matches_forward_and_jax(kind):
    """128 decode steps (two mLSTM chunks; the sLSTM's ``r_h`` / 4) from
    the zero state: each step within 1e-5 of the reference's decode, the
    steps together within 1e-3 of the forward (the reference's bound;
    1e-5 relative holds here), and the final states equal the
    forward's."""
    cfg, jcfg = configs.get_smoke(ARCH), jconfigs.get_smoke(ARCH)
    jp, tp = _cell(kind, 7, "init" if kind == "mlstm" else "quarter")
    B, S = 2, 128
    x = _x(cfg, B, S, 1)
    if kind == "mlstm":
        fwd, step, init = ssm.mlstm_forward, ssm.mlstm_decode, \
            ssm.mlstm_init_state
        jstep, jinit_state = jssm.mlstm_decode, jssm.mlstm_init_state
    else:
        fwd, step, init = ssm.slstm_forward, ssm.slstm_decode, \
            ssm.slstm_init_state
        jstep, jinit_state = jssm.slstm_decode, jssm.slstm_init_state
    y_full, st_full = fwd(tp, torch.as_tensor(x), cfg)
    st = init(cfg, B, device="cpu")
    jst = jinit_state(jcfg, B)
    jstep = jax.jit(jstep, static_argnums=3)
    ys = []
    for t in range(S):
        yt, st = step(tp, torch.as_tensor(x[:, t:t + 1]), st, cfg)
        jyt, jst = jstep(jp, jnp.asarray(x[:, t:t + 1]), jst, jcfg)
        assert _relerr(yt, jyt) < EXACT, t
        ys.append(yt)
    y_step = torch.cat(ys, dim=1)
    assert _maxdiff(y_full, y_step.numpy()) < DECODE
    assert _relerr(y_full, y_step.numpy()) < EXACT
    for (a, b), (c, _) in zip(_state_pairs(st, jst),
                              _state_pairs(st_full, jst)):
        assert _relerr(a, b) < EXACT
        assert _relerr(c, a.numpy()) < EXACT


def test_mlstm_takes_an_initial_state_and_refuses_a_ragged_length():
    """The chunked core continues from a state: two forwards of 64 equal
    one of 128 within 1e-5.  A length above the chunk that is no
    multiple of it (70) fails in both packages, which assert it; neither
    pads."""
    cfg, jcfg = configs.get_smoke(ARCH), jconfigs.get_smoke(ARCH)
    jp, tp = _cell("mlstm", 2)
    x = torch.as_tensor(_x(cfg, 2, 128, 2))
    y, st = ssm.mlstm_forward(tp, x, cfg)
    y1, st1 = ssm.mlstm_forward(tp, x[:, :64], cfg)
    y2, st2 = ssm.mlstm_forward(tp, x[:, 64:], cfg, st1)
    assert _relerr(torch.cat([y1, y2], dim=1), y.numpy()) < EXACT
    assert _relerr(st2[0], st[0].numpy()) < EXACT
    x70 = _x(cfg, 2, 70, 3)
    with pytest.raises(AssertionError):
        ssm.mlstm_forward(tp, torch.as_tensor(x70), cfg)
    with pytest.raises(AssertionError):
        jssm.mlstm_forward(jp, jnp.asarray(x70), jcfg)


def test_mlstm_gradient_stays_finite_where_the_forget_sum_overflows():
    """One row repeated over a chunk of 64 (a run of one token) with one
    head's forget-gate logit at -4: above the diagonal the segment sums
    reach some 250, past fp32's exp range.  The forward equals the
    reference's within 1e-5; the reference's gradient (exp, then mask:
    inf * 0) is NaN, the port's (mask, then exp) finite, and equal to the
    reference's wherever that is not NaN, within 1e-4 (each gradient
    sums 128 outputs' terms through gate exponentials)."""
    cfg, jcfg = configs.get_smoke(ARCH), jconfigs.get_smoke(ARCH)
    jp, tp = _cell("mlstm", 9)
    d_in, H, _ = ssm._mlstm_dims(cfg)
    x0 = np.random.default_rng(9).standard_normal(cfg.d_model)
    val = x0 @ np.asarray(jp["w_up"])[:, :d_in]
    f0 = val @ np.asarray(jp["w_if"])[:, H:]
    h = int(np.argmax(np.abs(f0)))
    x = np.tile(x0 * (-4.0 / f0[h]), (2, 64, 1)).astype(np.float32)
    jy, _ = jssm.mlstm_forward(jp, jnp.asarray(x), jcfg)
    y, _ = ssm.mlstm_forward(tp, torch.as_tensor(x), cfg)
    assert _relerr(y, jy) < EXACT
    jg = jax.jit(jax.grad(lambda p: jnp.sum(jssm.mlstm_forward(
        p, jnp.asarray(x), jcfg)[0])))(jp)
    assert np.isnan(np.asarray(jg["w_up"])).any()
    leaves = {k: v.clone().requires_grad_() for k, v in tp.items()}
    ssm.mlstm_forward(leaves, torch.as_tensor(x), cfg)[0].sum().backward()
    for k, v in leaves.items():
        assert bool(torch.isfinite(v.grad).all()), k
        ok = ~np.isnan(np.asarray(jg[k]))
        if ok.any():
            assert _relerr(v.grad[torch.as_tensor(ok)],
                           np.asarray(jg[k])[ok]) < MODEL, k


def test_slstm_at_its_init_amplifies_rounding():
    """At the reference's init the sLSTM is held to 1e-5 of the
    reference's over 16 steps.  Over 128 the JAX function alone, its
    input changed by one ulp (x (1 + 2^-23)), moves by more than 1e-3:
    the recurrence amplifies rounding, so no tolerance of 1e-5 can hold
    there; the port's gap from it stays within 10 times that move."""
    cfg, jcfg = configs.get_smoke(ARCH), jconfigs.get_smoke(ARCH)
    jp, tp = _cell("slstm", 40)
    x = _x(cfg, 2, 128, 40)
    jy = np.asarray(jssm.slstm_forward(jp, jnp.asarray(x), jcfg)[0])
    y, _ = ssm.slstm_forward(tp, torch.as_tensor(x), cfg)
    assert _relerr(y[:, :16], jy[:, :16]) < EXACT
    nudged = np.asarray(jssm.slstm_forward(
        jp, jnp.asarray(x * np.float32(1 + 2 ** -23)), jcfg)[0])
    move = float(np.max(np.abs(nudged - jy)))
    assert move > 1e-3
    assert _maxdiff(y, jy) <= 10 * move


def test_full_width_slstm_gradient_overflows_past_64_steps():
    """At xlstm-350m's full width (P 256, a recurrent gain near 8) the
    gradient of the last output with respect to the first input grows
    about 1.6x a step in both packages.  Over 64 steps its norm is above
    1e10 and both packages' fp32 ``global_norm`` is finite; over 128 it
    passes 1.8e19, whose square overflows fp32, so both global norms are
    inf (and clipping zeroes the step).  So the card's training phase
    takes sequences of 64; the port refuses nothing the reference
    takes."""
    from repro.train.optimizer import global_norm as jglobal_norm
    cfg, jcfg = configs.get_config(ARCH), jconfigs.get_config(ARCH)
    jp = jssm.slstm_params(jax.random.PRNGKey(0), jcfg, jnp.float32)
    tp = convert.from_jax_numpy(jax.device_get(jp), device="cpu")
    for T, finite in ((64, True), (128, False)):
        x = np.random.default_rng(T).standard_normal(
            (1, T, cfg.d_model)).astype(np.float32)
        jg = jax.jit(jax.grad(lambda x: jssm.slstm_forward(
            jp, x, jcfg)[0][:, -1].sum()))(jnp.asarray(x))
        tx = torch.as_tensor(x).requires_grad_()
        ssm.slstm_forward(tp, tx, cfg)[0][:, -1].sum().backward()
        for g in (np.asarray(jg), tx.grad.numpy()):
            assert np.isfinite(g).all()
            norm = float(np.linalg.norm(g.astype(np.float64)))
            assert (1e10 < norm < 1e19) if finite else norm > 1.85e19, \
                (T, norm)
        assert np.isfinite(float(jglobal_norm(jg))) == finite
        assert bool(torch.isfinite(opt.global_norm(tx.grad))) == finite


def test_slstm_gates_stay_stabilised():
    """Large input-gate pre-activations (the reference's max stabiliser
    m keeps exp(log_i - m) <= 1): finite outputs within 1e-5 of the
    reference's (``r_h`` / 4).  The states' gate logs reach some 100,
    where one fp32 ulp is 7.6e-6, so the states are held to 1e-4."""
    cfg, jcfg = configs.get_smoke(ARCH), jconfigs.get_smoke(ARCH)
    jp, _ = _cell("slstm", 4, "quarter")
    jp = dict(jp, w_x=jp["w_x"] * 40.0)
    tp = convert.from_jax_numpy(jax.device_get(jp), device="cpu")
    x = _x(cfg, 2, 24, 4, scale=2.0)
    jy, jst = jssm.slstm_forward(jp, jnp.asarray(x), jcfg)
    y, st = ssm.slstm_forward(tp, torch.as_tensor(x), cfg)
    assert bool(torch.isfinite(y).all())
    assert float(st["m"].abs().max()) > 50
    assert _relerr(y, jy) < EXACT
    for t, j in _state_pairs(st, jst):
        assert _relerr(t, j) < MODEL


# --------------------------------------------------------------- family --

def _meta_dense_init(gen, shape, dtype, device, scale=1.0, fan_in=0):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_param_counts(monkeypatch):
    """xlstm-350m: ``param_count`` gives 303,169,536 in both packages (the
    reference's analytic estimate, which leaves out the mLSTM's qkv
    projection); the tree holds 467,163,136, counted from the JAX
    init's shapes (``jax.eval_shape``) and from the port's init (its
    draws swapped for shape-only tensors)."""
    cfg, jcfg = configs.get_config(ARCH), jconfigs.get_config(ARCH)
    assert configs.param_count(cfg) == jconfigs.param_count(jcfg) \
        == (303_169_536, 303_169_536)
    shapes = jax.eval_shape(lambda k: jinit(jcfg, k, jnp.bfloat16),
                            jax.random.PRNGKey(0))
    assert sum(int(np.prod(a.shape)) for a in jax.tree.leaves(shapes)) \
        == 467_163_136
    monkeypatch.setattr(ssm, "dense_init", _meta_dense_init)
    monkeypatch.setattr(bb, "dense_init", _meta_dense_init)
    own = init_params(cfg, 0, torch.bfloat16, device="cpu")
    assert sum(t.numel() for t in opt.tree_leaves(own)) == 467_163_136
    assert len(own["xlstm_layers"]) == 24
    assert [i for i, p in enumerate(own["xlstm_layers"])
            if "r_h" in p["cell"]] == [5, 11, 17]


def test_params_and_cache_layout_match_jax(model):
    """The same tree as the JAX init, ``xlstm_layers`` a list of
    {"ln", "cell"} dicts, with the same shapes and dtypes in fp32 and in
    bf16, each leaf's standard deviation within 5% of the JAX init's
    (``r_h`` takes H as its fan-in, as the reference's); the cache is a
    list of mLSTM (C, n) tuples and sLSTM {"h", "c", "n", "m"} dicts of
    the reference's shapes, fp32."""
    tcfg, jcfg, _, _ = model
    for dtype in ("float32", "bfloat16"):
        want = jax.device_get(jinit(jcfg, jax.random.PRNGKey(0),
                                    getattr(jnp, dtype)))
        own = convert.to_jax_numpy(init_params(
            tcfg, 0, getattr(torch, dtype), device="cpu"))
        assert jax.tree.structure(own) == jax.tree.structure(want)
        for (path, j), (_, t) in zip(
                jax.tree_util.tree_flatten_with_path(want)[0],
                jax.tree_util.tree_flatten_with_path(own)[0]):
            assert t.shape == j.shape and t.dtype == j.dtype, path
            js, tsd = float(np.std(j.astype(np.float32))), \
                float(np.std(t.astype(np.float32)))
            assert (tsd == 0) if js == 0 else abs(tsd - js) <= 0.05 * js, \
                path
    cache = serve.init_cache(tcfg, 2, 40, torch.float32, device="cpu")
    jcache = jserve.init_cache(jcfg, 2, 40, jnp.float32)
    assert cache["pos"] == 0 and isinstance(cache["xlstm"], list)
    assert jax.tree.structure(convert.to_jax_numpy(cache["xlstm"])) == \
        jax.tree.structure(jcache["xlstm"])
    assert isinstance(cache["xlstm"][0], tuple)
    assert isinstance(cache["xlstm"][1], dict)
    for t, j in zip(_jax_leaves(cache["xlstm"]),
                    jax.tree.leaves(jcache["xlstm"])):
        assert t.shape == j.shape and t.dtype == np.float32
        assert np.array_equal(t, np.asarray(j))


@pytest.mark.parametrize("S,rh", [(16, "init"), (40, "quarter"),
                                  (128, "quarter")])
def test_forward_train_matches_jax(model, tame, S, rh):
    """Logits within 1e-4 of max(1, max|logit|) of the JAX forward's, at
    the reference's init over 16 tokens, and with ``r_h`` / 4 at one
    mLSTM chunk (40) and at two (128); the embedding is tied."""
    tcfg, jcfg, jp, tp = model if rh == "init" else tame
    toks = np.random.default_rng(S).integers(0, tcfg.vocab, (2, S)
                                             ).astype(np.int32)
    want, _ = jforward(jp, jcfg, {"tokens": jnp.asarray(toks)})
    got, aux = forward_train(tp, tcfg, {"tokens": torch.as_tensor(toks)})
    assert got.shape == (2, S, tcfg.vocab) and "lm_head" not in tp
    assert bool(torch.isfinite(got).all()) and aux["moe_aux"] == 0.0
    assert _relerr(got, want) < MODEL


@pytest.mark.parametrize("S,rh", [(16, "init"), (64, "quarter")])
def test_prefill_decode_matches_forward_and_jax(model, tame, S, rh):
    """Prefill then four decode steps: of 16 at the reference's init
    (its own ``test_multi_token_decode`` shape) and of 64, one mLSTM
    chunk, with ``r_h`` / 4.  The last prefill row and every step equal
    the teacher-forced forward (over 20, resp. 128 tokens; 1e-3, the
    reference's bound) and the JAX ones (1e-4); every layer's state
    equals the JAX cache's (1e-4)."""
    tcfg, jcfg, jp, tp = model if rh == "init" else tame
    B, n = 2, 4
    T = S + n if S + n <= 64 else 128
    toks = np.random.default_rng(7).integers(0, tcfg.vocab, (B, T)
                                             ).astype(np.int32)
    full, _ = forward_train(tp, tcfg, {"tokens": torch.as_tensor(toks)})
    last, cache = prefill(tp, tcfg, {"tokens": torch.as_tensor(toks[:, :S])},
                          cache_len=S + n, dtype=torch.float32)
    jlast, jcache = jprefill(jp, jcfg, {"tokens": jnp.asarray(toks[:, :S])},
                             cache_len=S + n, dtype=jnp.float32)
    assert _maxdiff(last, full[:, S - 1].detach().numpy()) < DECODE
    assert _relerr(last, jlast) < MODEL
    for i in range(n):
        t = toks[:, S + i:S + i + 1]
        lg, cache = decode_step(tp, tcfg, cache, torch.as_tensor(t))
        jlg, jcache = jdecode(jp, jcfg, jcache, jnp.asarray(t))
        assert _maxdiff(lg, full[:, S + i].detach().numpy()) < DECODE, i
        assert _relerr(lg, jlg) < MODEL, i
    assert cache["pos"] == int(jcache["pos"]) == S + n
    for t, j in zip(_jax_leaves(cache["xlstm"]),
                    jax.tree.leaves(jcache["xlstm"])):
        assert _relerr(torch.as_tensor(t), j) < MODEL


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
    return {tuple(getattr(p, "key", getattr(p, "idx", None)) for p in path):
            np.asarray(leaf) for path, leaf in
            jax.tree_util.tree_flatten_with_path(jax.device_get(tree))[0]}


def test_train_step_matches_jax(tame):
    """One ``make_train_step`` over 40 tokens from the JAX init with
    ``r_h`` / 4: loss and ``grad_norm`` within 1e-4 relative of the JAX
    step's; the updated params within 1e-4 wherever the reference's
    clipped gradient is at least 1e-6 and within 2 lr elsewhere (see
    ``tests/test_torch_mla.py``); every matrix of both cells moved."""
    tcfg, jcfg, jp, tp = tame
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
    moved = [p for p in new
             if p[0] == "xlstm_layers" and p[-1].startswith("w")]
    assert len(moved) == 4 + 2 and all(
        not np.array_equal(new[p], old[p]) for p in moved)
    assert not np.array_equal(new[("xlstm_layers", 1, "cell", "r_h")],
                              old[("xlstm_layers", 1, "cell", "r_h")])


# ------------------------------------------------------------ list tree --

def test_tree_helpers_walk_the_list_tree(model):
    """``tree_leaves`` walks ``xlstm_layers`` and a cache's tuples and
    dicts leaf by leaf, as many leaves as ``jax.tree.leaves``;
    ``tree_map`` keeps lists lists and tuples tuples;
    ``tree_unflatten`` rebuilds the tree; a dense tree's leaf order is
    its insertion order, as before."""
    tcfg, _, jp, tp = model
    leaves = opt.tree_leaves(tp)
    assert len(leaves) == len(jax.tree.leaves(jp)) and all(
        isinstance(t, torch.Tensor) for t in leaves)
    doubled = opt.tree_map(lambda t: 2 * t, tp)
    assert isinstance(doubled["xlstm_layers"], list)
    assert torch.equal(doubled["xlstm_layers"][1]["cell"]["r_h"],
                       2 * tp["xlstm_layers"][1]["cell"]["r_h"])
    back = opt.tree_unflatten(tp, [t.clone() for t in leaves])
    assert all(torch.equal(a, b) for a, b in
               zip(opt.tree_leaves(back), leaves))
    cache = serve.init_cache(tcfg, 2, 8, torch.float32, device="cpu")
    assert len(opt.tree_leaves(cache["xlstm"])) == 2 + 4
    cp = opt.tree_map(lambda t: t + 1, cache["xlstm"])
    assert isinstance(cp[0], tuple) and isinstance(cp[1], dict)
    dense = {"b": torch.zeros(1),
             "a": {"z": torch.ones(1), "y": torch.ones(2)}}
    assert [t.numel() for t in opt.tree_leaves(dense)] == [1, 1, 2]


def test_adam_ddma_wire_and_checkpoint_keep_the_list_tree(model, tmp_path):
    """Adam keeps one moment a leaf of the list (the update moves every
    cell's matrices and equals a per-leaf update of the flat leaves);
    DDMA's direct sync hands the same tensors back in a list and the
    parameter-server sync copies; ``quantize_dequant`` reaches the cells;
    the wire and a checkpoint round trip the tree bit for bit, the
    checkpoint in JAX's leaf order, and ``convert`` both ways."""
    tcfg, _, jp, tp = model
    grads = opt.tree_map(lambda t: torch.full_like(t, 0.01), tp)
    state = opt.adam_init(tp)
    assert isinstance(state.m["xlstm_layers"], list)
    new, st, m = opt.adam_update(tp, grads, state, lr=1e-3)
    flat, fst, fm = opt.adam_update(
        {str(i): t for i, t in enumerate(opt.tree_leaves(tp))},
        {str(i): t for i, t in enumerate(opt.tree_leaves(grads))},
        opt.adam_init({str(i): t for i, t in
                       enumerate(opt.tree_leaves(tp))}), lr=1e-3)
    assert float(m["grad_norm"]) == float(fm["grad_norm"])
    assert all(torch.equal(a, b) for a, b in
               zip(opt.tree_leaves(new), flat.values()))
    assert not torch.equal(new["xlstm_layers"][0]["cell"]["w_qkv"],
                           tp["xlstm_layers"][0]["cell"]["w_qkv"])
    synced = ddma.ddma_weight_sync(tp, torch.device("cpu"))
    assert isinstance(synced["xlstm_layers"], list)
    assert synced["xlstm_layers"][1]["cell"]["r_h"] is \
        tp["xlstm_layers"][1]["cell"]["r_h"]
    ps = ddma.ps_weight_sync(tp, torch.device("cpu"))
    assert all(torch.equal(a, b) and a is not b for a, b in
               zip(opt.tree_leaves(ps), opt.tree_leaves(tp)))
    qd = ddma.quantize_dequant(tp, min_size=1 << 12)
    assert not torch.equal(qd["xlstm_layers"][0]["cell"]["w_qkv"],
                           tp["xlstm_layers"][0]["cell"]["w_qkv"])
    wired = wire.deserialize(wire.serialize({"params": tp, "opt": st}))
    assert isinstance(wired["params"]["xlstm_layers"], list)
    assert all(torch.equal(a, b) for a, b in zip(
        opt.tree_leaves(wired["params"]), opt.tree_leaves(tp)))
    path = str(tmp_path / "ckpt")
    tree = {"params": new, "m": st.m, "v": st.v}
    checkpoint.save_checkpoint(path, tree)
    back = checkpoint.restore_checkpoint(path, tree)
    assert isinstance(back["params"]["xlstm_layers"], list)
    for a, b in zip(opt.tree_leaves(back), opt.tree_leaves(tree)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    npz = np.load(path + ".npz")
    want = jax.tree.leaves(convert.to_jax_numpy(tree))
    for i, a in enumerate(want):
        assert np.array_equal(npz[f"leaf_{i}"], a)
    again = convert.to_jax_numpy(convert.from_jax_numpy(
        jax.device_get(jp), device="cpu"))
    for a, b in zip(jax.tree.leaves(jax.device_get(jp)),
                    jax.tree.leaves(again)):
        assert np.array_equal(a, b)


def test_engine_refuses_ssm():
    """Both packages' engines refuse the SSM family under either layout
    (its state cache is not paged KV), and so does the paged cache."""
    tcfg, jcfg = configs.get_smoke(ARCH), jconfigs.get_smoke(ARCH)
    for layout in ("dense", "paged"):
        for fn, c in ((serve.assert_engine_cache, tcfg),
                      (jserve.assert_engine_cache, jcfg)):
            with pytest.raises(AssertionError, match="ssm"):
                fn(c, layout)
    with pytest.raises(AssertionError, match="dense/moe"):
        serve.init_cache(tcfg, 2, 32, torch.float32, device="cpu",
                         layout="paged", page_size=4, n_pages=8)
    assert jbb.segment_lengths(jcfg) == [] and bb.layer_stacks(tcfg) == []


def test_launcher_tracks_the_jax_launcher():
    """``--arch xlstm-350m --smoke --steps 3 --max-new 4`` through the
    port's launcher (16 tokens a sequence: the sLSTM's rounding stays
    below 1e-5 over them at its init), from the JAX launcher's converted
    init: the list tree
    moves through the trainer, weight sync and the generator, and the
    history has the JAX launcher's steps, weight versions, staleness and
    rewards, and loss, mean log-prob, mean ratio and gradient norm within
    1e-4 relative."""
    from repro.launch import train as jtrain
    from repro.train.trainstep import init_train_state as jinit_state

    args = launch.parse_args(["--arch", ARCH, "--smoke", "--device", "cpu",
                              "--steps", "3", "--transport", "inproc",
                              "--max-new", "4"])
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
    assert full == configs.get_config(ARCH) and full.d_model == 1024
    bb.check_family(full)
