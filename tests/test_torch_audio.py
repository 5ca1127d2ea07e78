"""The port's audio encoder-decoder family (seamless-m4t-medium: an
encoder over precomputed frame embeddings, a decoder with cross
attention) against the JAX package's, on the CPU.

Its pieces first (``sinusoidal_positions`` and the decode step's
``_sin_pos_at``; ``chunked_attention`` and ``dispatch.attention``
unmasked and across lengths, Sq != Sk down to one query; the encoder
``_encode`` and ``gqa_cross_forward``), then the family at its smoke
config (2 encoder and 2 decoder layers, d 256, 4 heads of 64, 32
frames) through ``forward_train``, prefill + decode (the self-attention
ring and the cross-attention K and V equal the reference's), a batch
rollout through ``generate(extra=)``, a train step with the frames in
the batch, and the shared refusals: both packages' engines, and both
packages' executors, which carry no ``frame_embeds``.  Inputs and frame
embeddings are made with numpy from a seed; JAX params cross through
``convert``; everything runs in fp32.

Tolerances: ``EXACT`` (1e-5) between the two packages' attention,
encoder and cross-attention outputs, relative to max(1, max|value|)
(fp32, sums in another order), and for the sinusoidal embeddings;
``MODEL`` (1e-4) for whole-model logits, caches and behaviour log-probs,
relative likewise; ``DECODE`` (1e-3) for prefill + decode against the
forward, the reference's bound (``tests/test_arch_smoke.py``); ``STEP``
(1e-4 relative) for a train step's loss, gradient norm and updated
params.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core.executor import GeneratorExecutor as JGeneratorExecutor
from repro.models import attention as jattn
from repro.models import backbone as jbb
from repro.models import common as jcommon
from repro.models import decode_step as jdecode
from repro.models import forward_train as jforward
from repro.models import init_params as jinit
from repro.models import prefill as jprefill
from repro.models import serve as jserve
from repro.rl.data import ArithmeticTasks as JArithmeticTasks
from repro.rl.rollout import generate as jgenerate
from repro.train import trainstep as jts
from repro_torch import configs, convert
from repro_torch.core.executor import GeneratorExecutor
from repro_torch.kernels import dispatch
from repro_torch.kernels.flash_attention import chunked_attention
from repro_torch.models import attention as attn
from repro_torch.models import backbone as bb
from repro_torch.models import common, decode_step, forward_train, \
    init_params, prefill, serve
from repro_torch.rl import prng
from repro_torch.rl.data import ArithmeticTasks
from repro_torch.rl.rollout import generate
from repro_torch.train import optimizer as opt
from repro_torch.train import trainstep as ts

ARCH = "seamless-m4t-medium"
EXACT = 1e-5
MODEL = 1e-4            # whole-model logits, caches and log-probs
DECODE = 1e-3           # the reference's prefill + decode bound
STEP = 1e-4             # a train step's loss, grad norm and params


@pytest.fixture(scope="module")
def model():
    """(port cfg, JAX cfg, JAX params, port params), fp32."""
    tcfg, jcfg = configs.get_smoke(ARCH), jconfigs.get_smoke(ARCH)
    jp = jinit(jcfg, jax.random.PRNGKey(0), jnp.float32)
    return tcfg, jcfg, jp, convert.from_jax_numpy(jax.device_get(jp),
                                                  device="cpu")


def _maxdiff(t, j):
    return float(np.max(np.abs(t.detach().float().numpy()
                               - np.asarray(j, dtype=np.float32))))


def _relerr(t, j):
    """The largest gap over max(1, the largest |value| of ``j``)."""
    return _maxdiff(t, j) / max(1.0, float(np.max(np.abs(np.asarray(j)))))


def _frames(cfg, B, seed):
    """[B, frontend_tokens, D] fp32 frame embeddings from a numpy seed."""
    return np.random.default_rng(seed).standard_normal(
        (B, cfg.frontend_tokens, cfg.d_model)).astype(np.float32)


def _batches(cfg, toks, seed):
    """The same tokens and frames as a JAX batch and a port batch."""
    fr = _frames(cfg, toks.shape[0], seed)
    return ({"tokens": jnp.asarray(toks), "frame_embeds": jnp.asarray(fr)},
            {"tokens": torch.as_tensor(toks),
             "frame_embeds": torch.as_tensor(fr)})


# --------------------------------------------------------------- pieces --

def test_sinusoidal_positions_match_jax():
    """``sinusoidal_positions`` (float64 angles, then fp32) equals the
    reference's bit for bit, with an offset too; the decode step's
    ``_sin_pos_at`` (fp32 angles, as the reference's) is within 1e-5 of
    the reference's, and from the prefill's float64-angle table by no
    more than its angles' rounding: 1e-5 plus pos * 2^-23, one fp32 ulp
    of the largest angle (3.6e-5 at position 299)."""
    for S, D, off in ((300, 1024, 0), (7, 256, 5)):
        got = common.sinusoidal_positions(S, D, offset=off)
        want = np.asarray(jcommon.sinusoidal_positions(S, D, offset=off))
        assert got.dtype == torch.float32 and got.shape == (S, D)
        assert np.array_equal(got.numpy(), want)
    table = common.sinusoidal_positions(300, 1024).numpy()
    for pos in (0, 1, 63, 64, 127, 299):
        at = serve._sin_pos_at(pos, 1024)
        assert at.shape == (1, 1, 1024) and at.dtype == torch.float32
        jat = np.asarray(jserve._sin_pos_at(jnp.asarray(pos, jnp.int32),
                                            1024))
        assert _maxdiff(at, jat) < EXACT, pos
        assert _maxdiff(at[0, 0], table[pos]) < EXACT + pos * 2 ** -23, pos


@pytest.mark.parametrize("Sq,Sk,block", [(40, 40, 16), (40, 40, 512),
                                         (5, 32, 2), (1, 32, 512)])
def test_chunked_attention_unmasked_matches_jax(Sq, Sk, block):
    """``chunked_attention(causal=False)`` against the reference's: an
    encoder's self-attention (Sq == Sk) over one query block or several,
    and cross attention of Sq decoder queries over Sk frames, down to one
    query (a decode step), within 1e-5; ``dispatch.attention`` with
    ``causal=False`` routes there on the CPU, as the reference routes it;
    causal self-attention still masks."""
    rng = np.random.default_rng(Sq * 100 + Sk)
    q = rng.standard_normal((2, Sq, 4, 64)).astype(np.float32)
    k = rng.standard_normal((2, Sk, 2, 64)).astype(np.float32)
    v = rng.standard_normal((2, Sk, 2, 64)).astype(np.float32)
    want = jattn.chunked_attention(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), causal=False,
                                   block_q=block)
    tq, tk, tv = map(torch.as_tensor, (q, k, v))
    got = chunked_attention(tq, tk, tv, causal=False, block_q=block)
    assert got.shape == (2, Sq, 4, 64)
    assert _relerr(got, want) < EXACT
    assert torch.equal(dispatch.attention(tq, tk, tv, causal=False),
                       chunked_attention(tq, tk, tv, causal=False))
    if Sq == Sk:
        causal = jattn.chunked_attention(jnp.asarray(q), jnp.asarray(k),
                                         jnp.asarray(v), block_q=block)
        assert _relerr(dispatch.attention(tq, tk, tv), causal) < EXACT
        assert _maxdiff(got, causal) > 0.1


def test_encoder_and_cross_attention_match_jax(model):
    """``_encode`` (frames plus positions, unmasked layers, ``enc_norm``)
    and one decoder layer's ``_enc_kv`` and ``gqa_cross_forward`` over
    its output, within 1e-5 of the reference's."""
    tcfg, jcfg, jp, tp = model
    fr = _frames(tcfg, 2, 3)
    jenc = jbb._encode(jp, jcfg, jnp.asarray(fr))
    enc = bb._encode(tp, tcfg, torch.as_tensor(fr))
    assert enc.shape == (2, tcfg.frontend_tokens, tcfg.d_model)
    assert _relerr(enc, jenc) < EXACT
    jlp = jax.tree.map(lambda a: a[1], jp["dec_layers"])
    lp = bb.unstack(tp["dec_layers"], tcfg.n_layers)[1]
    jk, jv = jbb._enc_kv(jlp, jenc, jcfg)
    k, v = bb._enc_kv(lp, enc, tcfg)
    assert k.shape == (2, tcfg.frontend_tokens, tcfg.n_kv_heads, tcfg.hd)
    assert _relerr(k, jk) < EXACT and _relerr(v, jv) < EXACT
    x = np.random.default_rng(4).standard_normal(
        (2, 6, tcfg.d_model)).astype(np.float32)
    for S in (6, 1):
        jy = jattn.gqa_cross_forward(jlp["cross"], jnp.asarray(x[:, :S]),
                                     jk, jv, jcfg)
        y = attn.gqa_cross_forward(lp["cross"], torch.as_tensor(x[:, :S]),
                                   k, v, tcfg)
        assert y.shape == (2, S, tcfg.d_model)
        assert _relerr(y, jy) < EXACT


# --------------------------------------------------------------- family --

def _meta_dense_init(gen, shape, dtype, device, scale=1.0, fan_in=0):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_params_and_cache_layout_match_jax(model, monkeypatch):
    """The same keys, shapes and dtypes as the JAX init (``enc_layers``
    and ``dec_layers`` stacked, the decoder's with ``ln_cross`` and
    ``cross``; ``enc_norm``; an untied head), each leaf's standard
    deviation within 5% of the JAX init's; the cache's ring and cross K
    and V of the reference's shapes.  seamless-m4t-medium's
    ``param_count`` is 977,694,720 in both packages and its tree holds
    977,758,208, from the JAX init's shapes and from the port's init
    (its draws swapped for shape-only tensors)."""
    tcfg, jcfg, _, _ = model
    want = jax.device_get(jinit(jcfg, jax.random.PRNGKey(0), jnp.float32))
    own = convert.to_jax_numpy(init_params(tcfg, 0, torch.float32,
                                           device="cpu"))
    assert jax.tree.structure(own) == jax.tree.structure(want)
    for (path, j), (_, t) in zip(
            jax.tree_util.tree_flatten_with_path(want)[0],
            jax.tree_util.tree_flatten_with_path(own)[0]):
        assert t.shape == j.shape and t.dtype == j.dtype, path
        js, tsd = float(np.std(j)), float(np.std(t))
        assert (tsd == 0) if js == 0 else abs(tsd - js) <= 0.05 * js, path
    cache = serve.init_cache(tcfg, 2, 40, torch.float32, device="cpu")
    jcache = jserve.init_cache(jcfg, 2, 40, jnp.float32)
    assert set(cache) == set(jcache)
    for name in ("cross_k", "cross_v"):
        assert tuple(cache[name].shape) == jcache[name].shape
    for k, v in cache["self"].items():
        assert tuple(v.shape) == jcache["self"][k].shape, k
    full, jfull = configs.get_config(ARCH), jconfigs.get_config(ARCH)
    assert configs.param_count(full) == jconfigs.param_count(jfull) \
        == (977_694_720, 977_694_720)
    shapes = jax.eval_shape(lambda k: jinit(jfull, k, jnp.bfloat16),
                            jax.random.PRNGKey(0))
    assert sum(int(np.prod(a.shape)) for a in jax.tree.leaves(shapes)) \
        == 977_758_208
    for mod in (bb, attn, bb.ffnmod):
        monkeypatch.setattr(mod, "dense_init", _meta_dense_init)
    big = init_params(full, 0, torch.bfloat16, device="cpu")
    assert sum(t.numel() for t in opt.tree_leaves(big)) == 977_758_208


@pytest.mark.parametrize("S", [16, 45])
def test_forward_train_matches_jax(model, S):
    """Logits within 1e-4 of max(1, max|logit|) of the JAX forward's; the
    frames move them (cross attention reads the encoder)."""
    tcfg, jcfg, jp, tp = model
    toks = np.random.default_rng(S).integers(0, tcfg.vocab, (2, S)
                                             ).astype(np.int32)
    jb, tb = _batches(tcfg, toks, S)
    want, _ = jforward(jp, jcfg, jb)
    got, aux = forward_train(tp, tcfg, tb)
    assert got.shape == (2, S, tcfg.vocab)
    assert bool(torch.isfinite(got).all()) and aux["moe_aux"] == 0.0
    assert _relerr(got, want) < MODEL
    other, _ = forward_train(tp, tcfg, {**tb, "frame_embeds":
                                        tb["frame_embeds"] * 3})
    assert _maxdiff(other, want) > 1e-2


def test_prefill_decode_matches_forward_and_jax(model):
    """Prefill of 40 then four decode steps: the last prefill row and
    every step equal the teacher-forced forward (1e-3, the reference's
    bound) and the JAX ones (1e-4); the ring, its positions and the
    cross-attention K and V equal the JAX cache's (1e-4)."""
    tcfg, jcfg, jp, tp = model
    B, S, n = 2, 40, 4
    toks = np.random.default_rng(7).integers(0, tcfg.vocab, (B, S + n)
                                             ).astype(np.int32)
    jb, tb = _batches(tcfg, toks, 7)
    full, _ = forward_train(tp, tcfg, tb)
    last, cache = prefill(tp, tcfg, {**tb, "tokens": tb["tokens"][:, :S]},
                          cache_len=S + n, dtype=torch.float32)
    jlast, jcache = jprefill(jp, jcfg, {**jb, "tokens": jb["tokens"][:, :S]},
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
    assert np.array_equal(cache["self"]["slot_pos"].numpy(),
                          np.asarray(jcache["self"]["slot_pos"]))
    for k in ("k", "v"):
        assert _relerr(cache["self"][k], jcache["self"][k]) < MODEL, k
    for k in ("cross_k", "cross_v"):
        assert _relerr(cache[k], jcache[k]) < MODEL, k


def test_batch_rollout_matches_jax(model):
    """``generate(extra={"frame_embeds": ...})`` in chunks from the same
    key words: the same tokens bit for bit, the behaviour log-probs
    within 1e-4; the cache holds the tokens only (no prefix)."""
    tcfg, jcfg, jp, tp = model
    prompts = np.random.default_rng(11).integers(
        3, tcfg.vocab, (3, 12)).astype(np.int32)
    fr = _frames(tcfg, 3, 11)
    js = jgenerate(jp, jcfg, jnp.asarray(prompts), max_new=10,
                   key=jax.random.PRNGKey(5), temperature=1.0, chunk=4,
                   extra={"frame_embeds": jnp.asarray(fr)})
    tst = generate(tp, tcfg, torch.as_tensor(prompts), max_new=10,
                   key=prng.PRNGKey(5), temperature=1.0, chunk=4,
                   extra={"frame_embeds": torch.as_tensor(fr)})
    assert np.array_equal(tst.tokens.numpy(), np.asarray(js.tokens))
    assert _relerr(tst.behavior_logp, js.behavior_logp) < MODEL
    assert np.array_equal(tst.done.numpy(), np.asarray(js.done))
    assert tst.cache["self"]["k"].shape[2] == 12 + 12


def _jax_paths(tree):
    return {tuple(p.key for p in path): np.asarray(leaf) for path, leaf in
            jax.tree_util.tree_flatten_with_path(jax.device_get(tree))[0]}


def test_train_step_with_frame_embeds_matches_jax(model):
    """One ``make_train_step`` with ``frame_embeds`` in the batch: loss
    and ``grad_norm`` within 1e-4 relative of the JAX step's; the updated
    params within 1e-4 wherever the reference's clipped gradient is at
    least 1e-6 and within 2 lr elsewhere (see ``tests/test_torch_mla.py``);
    the encoder's and the cross attention's matrices moved."""
    tcfg, jcfg, jp, tp = model
    rng = np.random.default_rng(4)
    B, T, lr = 2, 24, 1e-3
    mask = np.zeros((B, T), np.float32)
    mask[:, 8:] = rng.uniform(size=(B, T - 8)) > 0.1
    batch = {
        "tokens": rng.integers(0, tcfg.vocab, (B, T)).astype(np.int32),
        "behavior_logp": (rng.uniform(-8, -4, (B, T)) * mask
                          ).astype(np.float32),
        "advantages": (rng.standard_normal((B, 1)) * mask).astype(np.float32),
        "mask": mask,
        "frame_embeds": _frames(tcfg, B, 4),
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
    for path in (("enc_layers", "attn", "wq"), ("enc_layers", "mlp", "w_up"),
                 ("dec_layers", "cross", "wk"), ("dec_layers", "cross", "wo"),
                 ("lm_head",)):
        assert not np.array_equal(new[path], old[path]), path


def test_engine_and_executors_refuse_audio(model):
    """Both packages' engines refuse the audio family under either layout,
    and so does the paged cache; the executors carry no ``frame_embeds``
    in either package, so a generator's first step fails on the missing
    key in both."""
    tcfg, jcfg, jp, tp = model
    for layout in ("dense", "paged"):
        for fn, c in ((serve.assert_engine_cache, tcfg),
                      (jserve.assert_engine_cache, jcfg)):
            with pytest.raises(AssertionError, match="audio"):
                fn(c, layout)
    with pytest.raises(AssertionError, match="dense/moe"):
        serve.init_cache(tcfg, 2, 32, torch.float32, device="cpu",
                         layout="paged", page_size=4, n_pages=8)
    gen = GeneratorExecutor(tcfg, ArithmeticTasks(seed=0), n_prompts=1,
                            n_per_prompt=2, max_new=4, chunk=2, seed=0,
                            device="cpu")
    gen.set_weights(tp, version=0)
    with pytest.raises(KeyError, match="frame_embeds"):
        gen.step()
    jgen = JGeneratorExecutor(jcfg, JArithmeticTasks(seed=0), n_prompts=1,
                              n_per_prompt=2, max_new=4, chunk=2, seed=0)
    jgen.set_weights(jp, version=0)
    with pytest.raises(KeyError, match="frame_embeds"):
        jgen.step()
