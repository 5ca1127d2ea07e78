"""The port's training path against the JAX package, on the CPU.

The same inputs, made with numpy, go through both packages: the log-prob
backward (the plain version of kernel B2 against the reference's streamed
VJP and its Pallas kernel in interpret mode), the attention gradient, the
AIPO loss, Adam and one whole train step on ``llama31-smoke``.  Params
cross over with ``convert``.  Tolerances: 1e-5 in fp32 and 3e-2 in bf16
unless a test says otherwise.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import aipo as jaipo
from repro.kernels import dispatch as jdispatch
from repro.kernels.fused_logprob import fused_logprob_bwd as jbwd_kernel
from repro.models.attention import chunked_attention as jchunked
from repro.train import optimizer as jopt
from repro.train import trainstep as jts
from repro.configs.llama_paper import smoke
from repro_torch import convert
from repro_torch.configs.llama_paper import smoke as tsmoke
from repro_torch.core import aipo
from repro_torch.kernels import dispatch, fused_logprob
from repro_torch.models import init_params
from repro_torch.train import optimizer as opt
from repro_torch.train import trainstep as ts
from repro_torch.train.optimizer import tree_leaves

DTYPES = [(jnp.float32, 1e-5), (jnp.bfloat16, 3e-2)]


def _pair(x, dtype=jnp.float32):
    """The same values for both packages: a jax array and a CPU tensor
    carrying identical bits."""
    j = jnp.asarray(x).astype(dtype)
    return j, convert.from_jax_numpy(np.asarray(jax.device_get(j)),
                                     device="cpu")


def _np(t):
    return t.detach().float().cpu().numpy()


def _maxdiff(a, b):
    """max |a - b| in fp32, equal infinities agreeing."""
    a = np.asarray(a, dtype=np.float32)
    b = np.asarray(b, dtype=np.float32)
    d = np.where(a == b, 0.0, np.abs(a - b))
    assert not np.isnan(d).any()
    return float(d.max())


def _extreme(x):
    x = x.astype(np.float32)
    x[0, 5] = 1e30              # one dominating logit
    x[1, :] = -1e30             # a uniformly tiny row
    x[2, 3] = x[2, 99] = 7.0    # a duplicate maximum
    return x


def _torch_grad(fn, *xs):
    leaves = [x.detach().clone().requires_grad_() for x in xs]
    out = fn(*leaves)
    return torch.autograd.grad(out, leaves)


# ------------------------------------------------- log-prob backward (B2) --

_BWD_SHAPES = [(64, 512, 32, 128), (100, 1000, 256, 2048), (33, 257, 16, 64)]
# the +-1e30 rows are an fp32 case, as in the reference's suite
_BWD_CASES = ([s + d + (False,) for s in _BWD_SHAPES for d in DTYPES]
              + [s + DTYPES[0] + (True,) for s in _BWD_SHAPES])


@pytest.mark.parametrize("T,V,bt,bv,dtype,tol,extreme", _BWD_CASES)
def test_fused_logprob_bwd_plain_matches_reference(T, V, bt, bv, dtype, tol,
                                                   extreme):
    """The plain backward against the reference's streamed VJP and its
    Pallas backward kernel in interpret mode, from the same stats."""
    rng = np.random.default_rng(10)
    x = rng.standard_normal((T, V)) * 4
    jl, tl = _pair(_extreme(x) if extreme else x, dtype)
    toks = rng.integers(0, V, size=T).astype(np.int32)
    g = rng.standard_normal(T).astype(np.float32)
    _, m, log_s = jdispatch._logprob_stream_jnp(jl, jnp.asarray(toks), bv)
    want = jdispatch._logprob_bwd_stream_jnp(jl, jnp.asarray(toks), m, log_s,
                                             jnp.asarray(g), bv)
    want_k = jbwd_kernel(jl, jnp.asarray(toks), m, log_s, jnp.asarray(g),
                         block_t=bt, block_v=bv, interpret=True)
    got = fused_logprob.fused_logprob_bwd_plain(
        tl, torch.as_tensor(toks), torch.as_tensor(np.array(m)),
        torch.as_tensor(np.array(log_s)), torch.as_tensor(g), block_v=bv)
    assert got.dtype == tl.dtype and got.shape == (T, V)
    assert _maxdiff(_np(got), want.astype(jnp.float32)) < tol
    assert _maxdiff(_np(got), want_k.astype(jnp.float32)) < tol


@pytest.mark.parametrize("T,V", [(64, 512), (100, 1000), (33, 257)])
@pytest.mark.parametrize("dtype,tol", DTYPES)
def test_token_logprob_grad_matches_jax(T, V, dtype, tol):
    rng = np.random.default_rng(11)
    jl, tl = _pair(rng.standard_normal((T, V)) * 4, dtype)
    toks = rng.integers(0, V, size=T).astype(np.int32)
    w = rng.standard_normal(T).astype(np.float32)
    want = jax.grad(lambda l: jnp.sum(jdispatch.token_logprob(
        l, jnp.asarray(toks)) * w))(jl)
    got, = _torch_grad(lambda l: (dispatch.token_logprob(
        l, torch.as_tensor(toks)) * torch.as_tensor(w)).sum(), tl)
    assert got.dtype == tl.dtype
    assert _maxdiff(_np(got), want.astype(jnp.float32)) < tol


def test_token_logprob_grad_extreme_rows():
    x = _extreme(np.random.default_rng(12).standard_normal((8, 128)))
    jl, tl = _pair(x)
    toks = np.arange(8, dtype=np.int32) * 3
    want = jax.grad(lambda l: jnp.sum(jdispatch.token_logprob(
        l, jnp.asarray(toks), block_v=32)))(jl)
    got, = _torch_grad(lambda l: dispatch.token_logprob(
        l, torch.as_tensor(toks)).sum(), tl)
    assert _maxdiff(_np(got), want) < 1e-5


@pytest.mark.parametrize("dtype,tol", DTYPES)
def test_token_logprob_prefix_view_grad(dtype, tol):
    """The trainer's alignment: the whole logits with ``n_valid = T - 1``
    score ``logits[:, :-1]``, and the backward hands over the gradient of
    the whole logits (zero in the last position), equal to the
    reference's gradient through the slice."""
    rng = np.random.default_rng(13)
    jl, tl = _pair(rng.standard_normal((3, 12, 300)) * 4, dtype)
    toks = rng.integers(0, 300, size=(3, 11)).astype(np.int32)
    w = rng.standard_normal((3, 11)).astype(np.float32)
    want = jax.grad(lambda l: jnp.sum(jdispatch.token_logprob(
        l[:, :-1], jnp.asarray(toks)) * w))(jl)
    got, = _torch_grad(lambda l: (dispatch.token_logprob(
        l, torch.as_tensor(toks), n_valid=11) * torch.as_tensor(w)).sum(), tl)
    assert _maxdiff(_np(got), want.astype(jnp.float32)) < tol
    assert (got[:, -1] == 0).all()
    # a slice taken by the caller gives the same gradient through autograd
    sliced, = _torch_grad(lambda l: (dispatch.token_logprob(
        l[:, :-1], torch.as_tensor(toks)) * torch.as_tensor(w)).sum(), tl)
    assert torch.equal(sliced, got)
    with pytest.raises(ValueError, match="3-D"):
        dispatch.token_logprob(tl[0], torch.as_tensor(toks[0]), n_valid=11)


def test_bwd_cuda_wrapper_checks_its_inputs():
    x = torch.zeros(2, 3, 64)
    args = [torch.zeros(2, 2, dtype=torch.int32)] + [torch.zeros(2, 2)] * 3
    with pytest.raises(ValueError, match="CUDA"):
        fused_logprob.fused_logprob_bwd_cuda(x, *args, n_valid=2)


# ---------------------------------------------------- attention gradient --

@pytest.mark.parametrize("B,S,H,K,hd", [(2, 64, 8, 2, 32), (1, 50, 4, 4, 16)])
def test_attention_grad_matches_jax(B, S, H, K, hd):
    rng = np.random.default_rng(14)
    jq, tq = _pair(rng.standard_normal((B, S, H, hd)) * 0.5)
    jk, tk = _pair(rng.standard_normal((B, S, K, hd)) * 0.5)
    jv, tv = _pair(rng.standard_normal((B, S, K, hd)))
    go = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    out, vjp = jax.vjp(lambda q, k, v: jchunked(q, k, v, causal=True),
                       jq, jk, jv)
    want = vjp(jnp.asarray(go))
    leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    got_out = dispatch.attention(*leaves)
    got = torch.autograd.grad(got_out, leaves, torch.as_tensor(go))
    assert np.max(np.abs(_np(got_out) - np.asarray(out))) < 1e-5
    for a, b in zip(got, want):
        assert np.max(np.abs(_np(a) - np.asarray(b))) < 1e-5


# ------------------------------------------------------------------ AIPO --

@pytest.mark.parametrize("clip_mode", ["aipo", "ppo", "is_unclipped", "none",
                                       "onpolicy"])
def test_importance_weights_every_mode(clip_mode):
    rng = np.random.default_rng(15)
    lp = rng.uniform(-6, 1, size=200).astype(np.float32)
    blp = rng.uniform(-6, 1, size=200).astype(np.float32)
    want = jaipo.importance_weights(jnp.asarray(lp), jnp.asarray(blp),
                                    rho=2.5, clip_mode=clip_mode,
                                    ppo_eps=0.3)
    got = aipo.importance_weights(torch.as_tensor(lp), torch.as_tensor(blp),
                                  rho=2.5, clip_mode=clip_mode, ppo_eps=0.3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=0)


def test_importance_weights_unknown_mode():
    with pytest.raises(ValueError, match="bogus"):
        aipo.importance_weights(torch.zeros(2), torch.zeros(2), rho=4.0,
                                clip_mode="bogus")


def _aipo_inputs(seed, B=3, T=9, V=40):
    rng = np.random.default_rng(seed)
    return dict(
        logits=rng.standard_normal((B, T, V)) * 2,
        tokens=rng.integers(0, V, size=(B, T)).astype(np.int32),
        blp=(rng.uniform(-5, -0.5, size=(B, T))).astype(np.float32),
        adv=rng.standard_normal((B, T)).astype(np.float32),
        mask=(rng.uniform(size=(B, T)) > 0.3).astype(np.float32),
        ref=(rng.uniform(-5, -0.5, size=(B, T))).astype(np.float32))


@pytest.mark.parametrize("clip_mode", ["aipo", "ppo", "is_unclipped",
                                       "none"])
@pytest.mark.parametrize("kl_coef", [0.0, 0.1])
def test_aipo_loss_matches_jax(clip_mode, kl_coef):
    d = _aipo_inputs(16)
    jl, tl = _pair(d["logits"])
    kw = dict(rho=1.5, clip_mode=clip_mode, kl_coef=kl_coef)

    def jloss(l):
        return jaipo.aipo_loss(l, jnp.asarray(d["tokens"]),
                               jnp.asarray(d["blp"]), jnp.asarray(d["adv"]),
                               jnp.asarray(d["mask"]),
                               ref_logp=jnp.asarray(d["ref"]), **kw)

    (jl_val, jmetrics), jgrad = jax.value_and_grad(jloss, has_aux=True)(jl)
    leaf = tl.clone().requires_grad_()
    loss, metrics = aipo.aipo_loss(
        leaf, torch.as_tensor(d["tokens"]), torch.as_tensor(d["blp"]),
        torch.as_tensor(d["adv"]), torch.as_tensor(d["mask"]),
        ref_logp=torch.as_tensor(d["ref"]), **kw)
    grad, = torch.autograd.grad(loss, leaf)
    assert abs(loss.item() - float(jl_val)) < 1e-5
    assert set(metrics) == set(jmetrics)
    for k, v in jmetrics.items():
        assert not metrics[k].requires_grad
        assert abs(metrics[k].item() - float(v)) < 1e-5, k
    assert np.max(np.abs(_np(grad) - np.asarray(jgrad))) < 1e-5


def test_aipo_weight_is_a_constant():
    """With mu == pi the AIPO gradient is the on-policy one: the weight is
    detached, so it adds no gradient of its own."""
    d = _aipo_inputs(17)
    _, tl = _pair(d["logits"])
    toks = torch.as_tensor(d["tokens"])
    blp = aipo.token_logprobs(tl, toks).detach()
    grads = []
    for mode in ("aipo", "none"):
        leaf = tl.clone().requires_grad_()
        loss, m = aipo.aipo_loss(leaf, toks, blp, torch.as_tensor(d["adv"]),
                                 torch.as_tensor(d["mask"]), clip_mode=mode)
        grads.append(torch.autograd.grad(loss, leaf)[0])
        assert abs(m["mean_ratio"].item() - 1.0) < 1e-5
    assert torch.allclose(grads[0], grads[1], atol=1e-7)


# ------------------------------------------------------------------ Adam --

def _tree(seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return {"a": rng.standard_normal((6, 5)).astype(dtype),
            "b": {"c": rng.standard_normal(7).astype(dtype),
                  "d": rng.standard_normal((2, 3, 4)).astype(dtype)}}


@pytest.mark.parametrize("max_grad_norm", [1.0, 0.0])
@pytest.mark.parametrize("weight_decay", [0.0, 0.01])
def test_adam_update_matches_jax(max_grad_norm, weight_decay):
    jp = jax.tree.map(jnp.asarray, _tree(20))
    tp = convert.from_jax_numpy(_tree(20), device="cpu")
    jstate = jopt.adam_init(jp)
    tstate = opt.adam_init(tp)
    for step in range(3):
        # grads of norm ~ 5 so that clipping at 1.0 bites
        grads = _tree(21 + step)
        jp, jstate, jm = jopt.adam_update(
            jp, jax.tree.map(jnp.asarray, grads), jstate, lr=1e-2,
            weight_decay=weight_decay, max_grad_norm=max_grad_norm)
        old = [t.clone() for t in tree_leaves(tp)]
        new, tstate, tm = opt.adam_update(
            tp, convert.from_jax_numpy(grads, device="cpu"), tstate, lr=1e-2,
            weight_decay=weight_decay, max_grad_norm=max_grad_norm)
        # the update builds new params and leaves the old ones as they were
        assert all(torch.equal(a, b) for a, b in zip(old, tree_leaves(tp)))
        tp = new
        assert tstate.step == int(jstate.step) == step + 1
        assert abs(tm["grad_norm"].item() - float(jm["grad_norm"])) \
            < 1e-5 * float(jm["grad_norm"])
        for a, b in zip(tree_leaves(tp), jax.tree.leaves(jp)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                       atol=1e-6)
        for a, b in zip(tree_leaves(tstate.v), jax.tree.leaves(jstate.v)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5)


def test_adam_bf16_params_keep_their_dtype():
    p = {"w": torch.randn(4, 4).to(torch.bfloat16)}
    st = opt.adam_init(p)
    assert st.m["w"].dtype == torch.float32
    new, _, _ = opt.adam_update(p, {"w": torch.randn(4, 4).to(torch.bfloat16)},
                                st, lr=0.1)
    assert new["w"].dtype == torch.bfloat16 and not torch.equal(new["w"],
                                                               p["w"])


def test_clip_by_global_norm_matches_jax():
    grads = _tree(22)
    jg, jn = jopt.clip_by_global_norm(jax.tree.map(jnp.asarray, grads), 1.0)
    tg, tn = opt.clip_by_global_norm(
        convert.from_jax_numpy(grads, device="cpu"), 1.0)
    assert abs(tn.item() - float(jn)) < 1e-5 * float(jn)
    for a, b in zip(tree_leaves(tg), jax.tree.leaves(jg)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5)


@pytest.mark.parametrize("n", [100_000, 1_000_000])
def test_cpu_global_norm_of_a_leaf_and_of_its_halves(n):
    """On the CPU torch's fp32 ``vector_norm`` adds a leaf's squares in
    turn, so ``global_norm`` of a leaf and of its two halves (as the
    ranks of a model axis of two hold it, ``sharded_global_norm``)
    differ by more than fp32 rounding; the clip scale, and every m with
    it, moves by as much (tests/test_torch_child_mesh.py's whole-gather
    trainer).  Printed against the float64 norm, with ``x.square()
    .sum()`` beside them; each within 1e-3 of it."""
    x = torch.randn(n, generator=torch.Generator().manual_seed(0)) \
        * torch.rand(n, generator=torch.Generator().manual_seed(1)) ** 4
    exact = torch.linalg.vector_norm(x.double()).item()
    got = {"whole": opt.global_norm({"w": x}).item(),
           "halves": opt.global_norm({"a": x[:n // 2],
                                      "b": x[n // 2:]}).item(),
           "sum of squares": x.square().sum().sqrt().item()}
    rel = {k: (v - exact) / exact for k, v in got.items()}
    print(f"{n} elements, fp32 against the float64 norm: " + ", ".join(
        f"{k} {v:.2e}" for k, v in rel.items()))
    assert all(abs(v) <= 1e-3 for v in rel.values()), rel


@pytest.mark.parametrize("kind,warmup,total", [("constant", 0, 0),
                                               ("constant", 10, 0),
                                               ("cosine", 5, 40)])
def test_lr_schedule_kinds(kind, warmup, total):
    jfn = jopt.lr_schedule(kind, 3e-4, warmup, total)
    tfn = opt.lr_schedule(kind, 3e-4, warmup, total)
    for step in range(0, 50, 3):
        want = float(jfn(jnp.int32(step)))
        assert abs(tfn(step) - want) <= 1e-6 * 3e-4, (step, tfn(step), want)


# ---------------------------------------------------------- a train step --

def _train_batch(cfg, seed, B=4, T=24, prompt=8):
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


def _close(t, j, rtol):
    j = np.asarray(j, dtype=np.float32)
    err = np.max(np.abs(t.detach().numpy() - j))
    assert err <= rtol * max(np.max(np.abs(j)), 1e-30), err


@pytest.mark.parametrize("accum_steps", [1, 2])
@pytest.mark.parametrize("kl_coef", [0.0, 0.05])
def test_train_step_matches_jax(accum_steps, kl_coef):
    """One ``make_train_step`` on llama31-smoke in fp32 from the JAX init:
    loss, grad_norm and every first moment (m = (1 - b1) g, so the
    gradients themselves) within 1e-5 relative, and every param's update
    against JAX's.  The step runs at lr 1e-3, where the update stands far
    above the params' fp32 rounding.  Adam moves each param by about lr
    whatever its gradient's size, so the few gradient elements near
    eps = 1e-8, whose ~1e-6 relative error is a visible fraction of
    themselves, move their param by up to a tenth of lr; 99% of each
    leaf's updates agree within 1e-5 of the leaf's largest."""
    cfg = smoke()
    jstate = jts.init_train_state(cfg, jax.random.PRNGKey(0), jnp.float32)
    tparams = convert.from_jax_numpy(jax.device_get(jstate.params),
                                     device="cpu")
    tstate = ts.TrainState(tparams, opt.adam_init(tparams))
    batch = _train_batch(cfg, 30)
    kw = dict(kl_coef=kl_coef, accum_steps=accum_steps, lr=1e-3)
    jnew, jm = jax.jit(jts.make_train_step(cfg, **kw))(
        jstate, jax.tree.map(jnp.asarray, batch))
    tnew, tm = ts.make_train_step(tsmoke(), **kw)(
        tstate, {k: torch.as_tensor(v) for k, v in batch.items()})
    assert set(tm) == set(jm)
    for k in ("loss", "grad_norm", "mean_ratio", "mean_logp", "total_loss"):
        assert abs(float(tm[k]) - float(jm[k])) <= 1e-5 * abs(float(jm[k])), k
    jleaves = jax.tree.leaves(jax.device_get(jnew.params))
    j0 = jax.tree.leaves(jax.device_get(jstate.params))
    tleaves = tree_leaves(tnew.params)
    assert len(jleaves) == len(tleaves)
    for t, j, o, p in zip(tleaves, jleaves, j0, tree_leaves(tparams)):
        # the step built new tensors and left the old params as they were
        assert np.array_equal(p.numpy(), np.asarray(o))
        dj = np.asarray(j, np.float64) - np.asarray(o, np.float64)
        dt = t.numpy().astype(np.float64) - np.asarray(o, np.float64)
        big = np.max(np.abs(dj))
        assert 0.5e-3 < big < 2e-3       # Adam's first step is about lr
        err = np.abs(dt - dj) / big
        assert err.max() <= 0.2 and np.quantile(err, 0.99) <= 1e-5
    for t, j in zip(tree_leaves(tnew.opt.m), jax.tree.leaves(jnew.opt.m)):
        _close(t, j, 1e-5)


def test_train_step_lr_fn_and_remat():
    """``lr_fn`` reads the optimizer's step; remat (activation
    checkpointing) changes memory, not numbers."""
    cfg = tsmoke().replace(n_layers=1)
    batch = {k: torch.as_tensor(v) for k, v in _train_batch(cfg, 31).items()}
    seen = []

    def lr_fn(step):
        seen.append(step)
        return 1e-3

    outs = []
    for remat in (False, True):
        params = init_params(cfg, seed=3, dtype=torch.float32, device="cpu")
        state = ts.TrainState(params, opt.adam_init(params))
        step = ts.make_train_step(cfg, remat=remat, lr_fn=lr_fn)
        for _ in range(2):
            state, m = step(state, batch)
        outs.append((state, m))
    assert seen == [0, 1, 0, 1]
    (s0, m0), (s1, m1) = outs
    assert float(m0["loss"]) == float(m1["loss"])
    for a, b in zip(tree_leaves(s0.params), tree_leaves(s1.params)):
        assert torch.equal(a, b)

