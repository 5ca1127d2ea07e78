"""The port's VLM family (qwen2-vl-7b, M-RoPE) against the JAX package's,
on the CPU.

M-RoPE as plain functions first (``mrope_sections``, ``apply_mrope``,
``text_mrope_positions``, then GQA's forward and decode with M-RoPE),
then the family at its smoke config (2 layers, d 256, 4/2 heads of 64,
qkv bias, 16 patch embeddings ahead of the tokens) through
``forward_train``, prefill + multi-token decode across the patch prefix,
``generate(extra=)``, a train step with ``patch_embeds`` in the batch,
also split into two microbatches, and the refusals both packages share
(the engine, the paged decode and the executors, which carry no patch
embeddings).  Inputs are made with numpy from a seed; JAX params cross
through ``convert``; everything runs in fp32.

Tolerances: ``EXACT`` (1e-5) between the two packages' rotations,
attention outputs and logits (fp32, the same products summed in another
order; logits relative to max(1, max|logit|)); ``DECODE`` (1e-3) for
prefill + decode against the forward, the reference's bound
(``tests/test_arch_smoke.py``); ``STEP`` (1e-4 relative) for a train
step's loss, gradient norm and updated params.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import attention as jattn
from repro.models import common as jcommon
from repro.models import decode_step as jdecode
from repro.models import forward_train as jforward
from repro.models import init_params as jinit
from repro.models import prefill as jprefill
from repro.models import serve as jserve
from repro.rl.rollout import generate as jgenerate
from repro.train import trainstep as jts
from repro_torch import configs, convert
from repro_torch.core.executor import GeneratorExecutor
from repro_torch.models import attention as attn
from repro_torch.models import common
from repro_torch.models import decode_step, forward_train, init_params, \
    prefill, serve
from repro_torch.rl import prng
from repro_torch.rl.data import ArithmeticTasks
from repro_torch.rl.rollout import generate
from repro_torch.train import optimizer as opt
from repro_torch.train import trainstep as ts

ARCH = "qwen2-vl-7b"
EXACT = 1e-5
DECODE = 1e-3           # tests/test_arch_smoke.py: prefill + decode
STEP = 1e-4             # a train step's loss, grad norm and params


@pytest.fixture(scope="module")
def model():
    """(port cfg, JAX cfg, JAX params, port params), fp32."""
    tcfg, jcfg = configs.get_smoke(ARCH), jconfigs.get_smoke(ARCH)
    jp = jinit(jcfg, jax.random.PRNGKey(0), jnp.float32)
    return tcfg, jcfg, jp, convert.from_jax_numpy(jax.device_get(jp),
                                                  device="cpu")


def _maxdiff(t, j):
    return float(np.max(np.abs(t.detach().numpy() - np.asarray(j))))


def _relerr(t, j):
    """The largest gap over max(1, the largest |value| of ``j``)."""
    return _maxdiff(t, j) / max(1.0, float(np.max(np.abs(np.asarray(j)))))


def _patches(cfg, B, seed):
    """Patch embeddings at scale 0.02, as tests/test_arch_smoke.py draws
    them."""
    return (np.random.default_rng(seed).standard_normal(
        (B, cfg.frontend_tokens, cfg.d_model)) * 0.02).astype(np.float32)


def _batches(toks, patches):
    """The same batch for both packages."""
    return ({"tokens": jnp.asarray(toks), "patch_embeds": jnp.asarray(patches)},
            {"tokens": torch.as_tensor(toks),
             "patch_embeds": torch.as_tensor(patches)})


# --------------------------------------------------------------- M-RoPE --

@pytest.mark.parametrize("hd", [16, 64, 112, 128])
def test_mrope_sections_match_jax(hd):
    assert common.mrope_sections(hd) == jcommon.mrope_sections(hd)
    assert sum(common.mrope_sections(hd)) == hd // 2
    assert common.mrope_sections(128) == (16, 24, 24)


@pytest.mark.parametrize("hd,theta", [(64, 1e6), (128, 1e4)])
def test_apply_mrope_matches_jax(hd, theta):
    """Each section turns by its own position id: within 1e-5 of the
    reference at positions up to 4000, and the text rule (t = h = w)
    equals plain RoPE's rotation at the same positions."""
    rng = np.random.default_rng(hd)
    x = rng.standard_normal((2, 9, 3, hd)).astype(np.float32)
    pos = rng.integers(0, 4000, (3, 2, 9)).astype(np.int32)
    want = jcommon.apply_mrope(jnp.asarray(x), jnp.asarray(pos), theta)
    got = common.apply_mrope(torch.as_tensor(x), torch.as_tensor(pos), theta)
    assert _maxdiff(got, want) < EXACT
    text = common.text_mrope_positions(2, 9, offset=5)
    assert np.array_equal(text.numpy(), np.asarray(
        jcommon.text_mrope_positions(2, 9, offset=5)))
    plain = common.apply_rope(torch.as_tensor(x), text[0], theta)
    assert torch.equal(common.apply_mrope(torch.as_tensor(x), text, theta),
                       plain)


def test_gqa_forward_and_decode_with_mrope_match_jax(model):
    """One layer: ``gqa_forward`` at vision + text M-RoPE positions, then
    ``gqa_decode`` at an explicit ``mrope_pos`` and at its default (the
    row's position three times), each y and cache within 1e-5 of the
    reference's."""
    tcfg, jcfg, _, _ = model
    jp = jattn.gqa_params(jax.random.PRNGKey(3), jcfg, jnp.float32)
    tp = convert.from_jax_numpy(jax.device_get(jp), device="cpu")
    rng = np.random.default_rng(3)
    B, S, Sc = 2, 12, 16
    x = rng.standard_normal((B, S + 2, tcfg.d_model)).astype(np.float32)
    pos = rng.integers(0, 6, (3, B, S)).astype(np.int32)
    jy, (jk, jv) = jattn.gqa_forward(jp, jnp.asarray(x[:, :S]), jcfg,
                                     mrope_pos=jnp.asarray(pos))
    y, (k, v) = attn.gqa_forward(tp, torch.as_tensor(x[:, :S]), tcfg,
                                 mrope_pos=torch.as_tensor(pos))
    for got, want in ((y, jy), (k, jk), (v, jv)):
        assert _maxdiff(got, want) < EXACT
    ck = torch.zeros(B, Sc, tcfg.n_kv_heads, tcfg.hd)
    cv = torch.zeros_like(ck)
    cp = torch.full((Sc,), -1, dtype=torch.int32)
    ck[:, :S], cv[:, :S] = k.detach(), v.detach()
    cp[:S] = torch.arange(S, dtype=torch.int32)
    jc = [jnp.asarray(t.numpy()) for t in (ck, cv, cp)]
    for i, mp in enumerate([np.full((3, B, 1), 9, np.int32), None]):
        xi = x[:, S + i:S + i + 1]
        y = attn.gqa_decode(tp, torch.as_tensor(xi), ck, cv, cp, S + i, tcfg,
                            mrope_pos=None if mp is None
                            else torch.as_tensor(mp))
        jy, *jc = jattn.gqa_decode(jp, jnp.asarray(xi), *jc, S + i, jcfg,
                                   mrope_pos=None if mp is None
                                   else jnp.asarray(mp))
        assert _maxdiff(y, jy) < EXACT, i
    assert _maxdiff(ck, jc[0]) < EXACT
    assert np.array_equal(cp.numpy(), np.asarray(jc[2]))


# --------------------------------------------------------------- family --

def test_params_and_cache_layout_match_jax(model):
    """The same keys, shapes and dtypes as the JAX init (qkv biases
    included), each leaf's standard deviation within 5% of the JAX
    init's, and the dense cache's segments."""
    tcfg, jcfg, jp, _ = model
    own = convert.to_jax_numpy(init_params(tcfg, 0, torch.float32,
                                           device="cpu"))
    jflat = jax.tree_util.tree_flatten_with_path(jax.device_get(jp))[0]
    mine = dict(jax.tree_util.tree_flatten_with_path(own)[0])
    assert len(mine) == len(jflat)
    for path, j in jflat:
        t = mine[path]
        assert t.shape == j.shape and t.dtype == j.dtype, path
        js, tsd = float(np.std(j)), float(np.std(t))
        assert (tsd == 0) if js == 0 else abs(tsd - js) <= 0.05 * js, path
    assert "bq" in own["layers"]["attn"]
    assert serve.segment_layout(tcfg) == jserve.segment_layout(jcfg)
    cache = serve.init_cache(tcfg, 2, 40, torch.float32, device="cpu")
    jcache = jserve.init_cache(jcfg, 2, 40, jnp.float32)
    for seg, jseg in zip(cache["segments"], jcache["segments"]):
        for k in seg:
            assert tuple(seg[k].shape) == jseg[k].shape, k


@pytest.mark.parametrize("S", [16, 33])
def test_forward_train_matches_jax(model, S):
    """Logits of the text positions only, within 1e-5 of max(1,
    max|logit|) of the JAX forward's."""
    tcfg, jcfg, jp, tp = model
    toks = np.random.default_rng(S).integers(0, tcfg.vocab, (2, S)
                                             ).astype(np.int32)
    jb, tb = _batches(toks, _patches(tcfg, 2, S))
    want, _ = jforward(jp, jcfg, jb)
    got, aux = forward_train(tp, tcfg, tb)
    assert got.shape == (2, S, tcfg.vocab)
    assert bool(torch.isfinite(got).all())
    assert _relerr(got, want) < EXACT
    # the patches reach the text: other patches, other logits
    other, _ = forward_train(tp, tcfg, {**tb, "patch_embeds":
                                        tb["patch_embeds"] * 50})
    assert _maxdiff(other, got.detach().numpy()) > 1e-3


def test_prefill_decode_across_the_patch_prefix(model):
    """Prefill then five decode steps past the 16-patch prefix: the last
    prefill row and every step equal the teacher-forced forward (1e-3,
    the reference's bound) and the JAX ones (1e-5); ``pos`` counts the
    patches, and the KV caches equal the JAX caches."""
    tcfg, jcfg, jp, tp = model
    B, S, n, P = 2, 24, 5, tcfg.frontend_tokens
    toks = np.random.default_rng(7).integers(0, tcfg.vocab, (B, S + n)
                                             ).astype(np.int32)
    patches = _patches(tcfg, B, 7)
    jb, tb = _batches(toks, patches)
    full, _ = forward_train(tp, tcfg, tb)
    jb["tokens"], tb["tokens"] = jb["tokens"][:, :S], tb["tokens"][:, :S]
    cache_len = S + n + 3 + P
    last, cache = prefill(tp, tcfg, tb, cache_len=cache_len,
                          dtype=torch.float32)
    jlast, jcache = jprefill(jp, jcfg, jb, cache_len=cache_len,
                             dtype=jnp.float32)
    assert cache["pos"] == int(jcache["pos"]) == S + P
    assert _maxdiff(last, full[:, S - 1].detach().numpy()) < DECODE
    assert _maxdiff(last, jlast) < EXACT
    for i in range(n):
        t = toks[:, S + i:S + i + 1]
        lg, cache = decode_step(tp, tcfg, cache, torch.as_tensor(t))
        jlg, jcache = jdecode(jp, jcfg, jcache, jnp.asarray(t))
        assert _maxdiff(lg, full[:, S + i].detach().numpy()) < DECODE, i
        assert _maxdiff(lg, jlg) < EXACT, i
    assert cache["pos"] == int(jcache["pos"]) == S + P + n
    for seg, jseg in zip(cache["segments"], jcache["segments"]):
        assert np.array_equal(seg["slot_pos"].numpy(),
                              np.asarray(jseg["slot_pos"]))
        for k in ("k", "v"):
            assert _maxdiff(seg[k], jseg[k]) < EXACT, k


def test_generate_with_extra_matches_jax(model):
    """``generate(extra={"patch_embeds": ...})`` in chunks from the same
    key words: the same tokens bit for bit, the behaviour log-probs
    within 1e-5; the cache holds the patches, the token buffer does
    not."""
    tcfg, jcfg, jp, tp = model
    prompts = np.random.default_rng(11).integers(
        3, tcfg.vocab, (3, 12)).astype(np.int32)
    patches = _patches(tcfg, 3, 11)
    js = jgenerate(jp, jcfg, jnp.asarray(prompts), max_new=10,
                   key=jax.random.PRNGKey(5), temperature=1.0, chunk=4,
                   extra={"patch_embeds": jnp.asarray(patches)})
    tst = generate(tp, tcfg, torch.as_tensor(prompts), max_new=10,
                   key=prng.PRNGKey(5), temperature=1.0, chunk=4,
                   extra={"patch_embeds": torch.as_tensor(patches)})
    assert tst.tokens.shape == (3, 22)
    assert np.array_equal(tst.tokens.numpy(), np.asarray(js.tokens))
    assert _maxdiff(tst.behavior_logp, js.behavior_logp) < EXACT
    assert np.array_equal(tst.done.numpy(), np.asarray(js.done))
    assert tst.cache["pos"] == 12 + 12 + tcfg.frontend_tokens


def _train_batch(cfg, T, seed, B=4):
    rng = np.random.default_rng(seed)
    mask = np.zeros((B, T), np.float32)
    mask[:, 8:] = rng.uniform(size=(B, T - 8)) > 0.1
    return {
        "tokens": rng.integers(0, cfg.vocab, (B, T)).astype(np.int32),
        "behavior_logp": (rng.uniform(-8, -4, (B, T)) * mask
                          ).astype(np.float32),
        "advantages": (rng.standard_normal((B, 1)) * mask).astype(np.float32),
        "mask": mask,
        "patch_embeds": _patches(cfg, B, seed),
    }


def _jax_paths(tree):
    return {tuple(p.key for p in path): np.asarray(leaf) for path, leaf in
            jax.tree_util.tree_flatten_with_path(jax.device_get(tree))[0]}


@pytest.mark.parametrize("accum", [1, 2])
def test_train_step_with_patch_embeds_matches_jax(model, accum):
    """One ``make_train_step`` with ``patch_embeds`` in the batch, whole
    or split into two microbatches (every key, the patches included, cut
    on the batch axis): loss and ``grad_norm`` within 1e-4 relative of the
    JAX step's at the same ``accum_steps``, the updated params within
    1e-4 wherever the reference's clipped gradient (the mean of its
    microbatches') is at least 1e-6 and within 2 lr elsewhere (see ``tests/test_torch_mla.py``), and the
    embeddings moved."""
    tcfg, jcfg, jp, tp = model
    batch, lr = _train_batch(tcfg, 24, 3), 1e-3
    jstate = jts.TrainState(params=jp, opt=jts.adam_init(jp))
    jnew, jm = jax.jit(jts.make_train_step(jcfg, lr=lr, accum_steps=accum))(
        jstate, jax.tree.map(jnp.asarray, batch))
    tnew, tm = ts.make_train_step(tcfg, lr=lr, accum_steps=accum)(
        ts.TrainState(tp, opt.adam_init(tp)),
        {k: torch.as_tensor(v) for k, v in batch.items()})
    for k in ("loss", "grad_norm"):
        assert abs(float(tm[k]) - float(jm[k])) <= STEP * abs(float(jm[k])), k
    # the gradient the step took: the mean of its microbatches'
    grad = jax.jit(jax.grad(lambda p, b: jts.make_loss_fn(jcfg)(p, b)[0]))
    mb = 4 // accum
    jgrads = [_jax_paths(grad(jp, {k: jnp.asarray(v[i * mb:(i + 1) * mb])
                                   for k, v in batch.items()}))
              for i in range(accum)]
    jgrads = {k: sum(g[k] for g in jgrads) / accum for k in jgrads[0]}
    clip = min(1.0, 1.0 / float(jm["grad_norm"]))
    new = _jax_paths(convert.to_jax_numpy(tnew.params))
    for path, jg in _jax_paths(jnew.params).items():
        gap = np.abs(new[path] - jg)
        sure = np.abs(jgrads[path] * clip) >= 1e-6
        assert np.all(gap[sure] <= STEP * np.maximum(1, np.abs(jg[sure]))), \
            path
        assert np.all(gap <= 2 * lr), path
    assert not torch.equal(tnew.params["embed"], tp["embed"])


def test_engine_paged_paths_and_executors_refuse_vlm(model):
    """Both packages' engines refuse the VLM family under either layout,
    and so do the paged cache, the paged decode and the prefill
    continuation; the executors carry no ``patch_embeds`` in either
    package, so a generator step fails on its missing key."""
    from repro.models.serve import assert_engine_cache as jassert
    tcfg, jcfg, _, tp = model
    for layout in ("dense", "paged"):
        for fn, c in ((serve.assert_engine_cache, tcfg), (jassert, jcfg)):
            with pytest.raises(AssertionError, match="vlm"):
                fn(c, layout)
    with pytest.raises(AssertionError, match="dense/moe"):
        serve.init_cache(tcfg, 2, 32, torch.float32, device="cpu",
                         layout="paged", page_size=4, n_pages=8)
    p = {k: v[0] for k, v in tp["layers"]["attn"].items()}
    x = torch.zeros(2, 1, tcfg.d_model)
    with pytest.raises(AssertionError, match="rope/none"):
        attn.gqa_decode_paged(p, x, None, None, None, torch.tensor([3, 4]),
                              tcfg)
    with pytest.raises(AssertionError, match="rope/none"):
        attn.gqa_extend(p, x, None, None, tcfg, q_offset=4)
    gen = GeneratorExecutor(tcfg, ArithmeticTasks(seed=0), n_prompts=1,
                            n_per_prompt=2, max_new=4, chunk=2, seed=0,
                            device="cpu")
    gen.set_weights(tp, version=0)
    with pytest.raises(KeyError, match="patch_embeds"):
        gen.step()
