"""The port's MLA + MTP family (deepseek-v3-671b) against the JAX
package's, on the CPU.

MLA as plain functions first (``mla_forward`` in the expanded form,
``mla_decode`` in the absorbed form over the latent cache,
``dispatch.attention`` with qk and v head dims that differ), then the
family at its smoke config (2 layers, the first dense and the second MoE
with 4 experts top-2 sigmoid and a shared expert, an MTP head, capacity
factor 4 so nothing drops) through ``forward_train``, prefill + decode,
batch rollouts, a train step with the MTP loss, ``convert`` and the
launcher.  Inputs are made with numpy from a seed; JAX params cross
through ``convert``; everything runs in fp32.

Tolerances: ``EXACT`` (1e-5) between the two packages' MLA outputs,
caches and logits (fp32, the same products summed in another order); for
``forward_train``'s logits and ``mtp_logits`` 1e-5 of max(1, max|logit|),
since that rounding noise grows with depth (the MTP head's logits come
after three layers and reach |4.5|: a mean gap of 1.7e-6 and a largest
of 1.5e-5 at S 33-64);
``ABSORBED`` (1e-4) between the absorbed decode and the expanded
forward's last row (the two forms sum different products); ``DECODE``
(1e-3) for prefill + decode against the forward, the reference's bound
(``tests/test_arch_smoke.py``); ``STEP`` (1e-4 relative) for a train
step's loss, ``mtp_loss``, gradients and updated params (see
``test_train_step_matches_jax`` for where Adam's eps bounds the last).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import attention as jattn
from repro.models import decode_step as jdecode
from repro.models import forward_train as jforward
from repro.models import init_params as jinit
from repro.models import prefill as jprefill
from repro.models import serve as jserve
from repro.rl.rollout import generate as jgenerate
from repro.train import trainstep as jts
from repro_torch import configs, convert
from repro_torch.core.executor import GeneratorExecutor
from repro_torch.kernels import dispatch
from repro_torch.launch import train as launch
from repro_torch.models import attention as attn
from repro_torch.models import backbone as bb
from repro_torch.models import decode_step, forward_train, init_params, \
    prefill, serve
from repro_torch.rl import prng
from repro_torch.rl.data import ArithmeticTasks
from repro_torch.rl.rollout import generate
from repro_torch.train import optimizer as opt
from repro_torch.train import trainstep as ts

ARCH = "deepseek-v3-671b"
EXACT = 1e-5
ABSORBED = 1e-4
DECODE = 1e-3           # tests/test_arch_smoke.py: prefill + decode
STEP = 1e-4             # a train step's loss, mtp_loss and params


@pytest.fixture(scope="module")
def model():
    """(port cfg, JAX cfg, JAX params, port params), fp32."""
    tcfg, jcfg = configs.get_smoke(ARCH), jconfigs.get_smoke(ARCH)
    jp = jinit(jcfg, jax.random.PRNGKey(0), jnp.float32)
    return tcfg, jcfg, jp, convert.from_jax_numpy(jax.device_get(jp),
                                                  device="cpu")


@pytest.fixture(scope="module")
def layer(model):
    """One MLA layer's params from the JAX init, for both packages."""
    tcfg, jcfg, _, _ = model
    jp = jattn.mla_params(jax.random.PRNGKey(3), jcfg, jnp.float32)
    return jp, convert.from_jax_numpy(jax.device_get(jp), device="cpu")


def _maxdiff(t, j):
    return float(np.max(np.abs(t.detach().numpy() - np.asarray(j))))


def _relerr(t, j):
    """The largest gap over max(1, the largest |value| of ``j``)."""
    return _maxdiff(t, j) / max(1.0, float(np.max(np.abs(np.asarray(j)))))


def _x(cfg, B, S, seed):
    return np.random.default_rng(seed).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)


# ------------------------------------------------------------------ MLA --

@pytest.mark.parametrize("S", [16, 33])
def test_mla_forward_matches_jax(model, layer, S):
    """y, the latent c_kv and the rotated shared key within 1e-5."""
    tcfg, jcfg, _, _ = model
    jp, tp = layer
    x = _x(tcfg, 2, S, S)
    jy, (jckv, jkr) = jattn.mla_forward(jp, jnp.asarray(x), jcfg)
    y, (ckv, kr) = attn.mla_forward(tp, torch.as_tensor(x), tcfg)
    m = tcfg.mla
    assert ckv.shape == (2, S, m.kv_lora_rank)
    assert kr.shape == (2, S, m.qk_rope_dim)
    for got, want in ((y, jy), (ckv, jckv), (kr, jkr)):
        assert _maxdiff(got, want) < EXACT


def test_mla_decode_matches_jax_and_the_expanded_form(model, layer):
    """Four one-token steps over a latent cache filled by an expanded
    prefill: y and the updated caches and slot positions equal the
    reference's (1e-5), and each step's y equals the expanded forward's
    row at that position (1e-4)."""
    tcfg, jcfg, _, _ = model
    jp, tp = layer
    m = tcfg.mla
    B, S, n, Sc = 2, 10, 4, 16
    x = _x(tcfg, B, S + n, 5)
    full, _ = attn.mla_forward(tp, torch.as_tensor(x), tcfg)
    _, (ckv, kr) = attn.mla_forward(tp, torch.as_tensor(x[:, :S]), tcfg)
    cache_ckv = torch.zeros((B, Sc, m.kv_lora_rank))
    cache_kr = torch.zeros((B, Sc, m.qk_rope_dim))
    cache_pos = torch.full((Sc,), -1, dtype=torch.int32)
    cache_ckv[:, :S], cache_kr[:, :S] = ckv, kr
    cache_pos[:S] = torch.arange(S, dtype=torch.int32)
    jc = [jnp.asarray(t.numpy()) for t in (cache_ckv, cache_kr, cache_pos)]
    for i in range(n):
        xi = x[:, S + i:S + i + 1]
        y = attn.mla_decode(tp, torch.as_tensor(xi), cache_ckv, cache_kr,
                            cache_pos, S + i, tcfg)
        jy, *jc = jattn.mla_decode(jp, jnp.asarray(xi), *jc, S + i, jcfg)
        assert y.shape == (B, 1, tcfg.d_model)
        assert _maxdiff(y, jy) < EXACT, i
        assert _maxdiff(y[:, 0], full[:, S + i].detach().numpy()) \
            < ABSORBED, i
    assert _maxdiff(cache_ckv, jc[0]) < EXACT
    assert _maxdiff(cache_kr, jc[1]) < EXACT
    assert np.array_equal(cache_pos.numpy(), np.asarray(jc[2]))


def test_mla_decode_refuses_per_row_cursors(model, layer):
    """A tensor ``pos`` (the engine's per-row cursors) raises: neither
    package's engine takes a latent cache."""
    tcfg, _, _, _ = model
    _, tp = layer
    m = tcfg.mla
    with pytest.raises(NotImplementedError, match="per-row"):
        attn.mla_decode(tp, torch.zeros(2, 1, tcfg.d_model),
                        torch.zeros(2, 8, m.kv_lora_rank),
                        torch.zeros(2, 8, m.qk_rope_dim),
                        torch.full((8,), -1, dtype=torch.int32),
                        torch.tensor([3, 4]), tcfg)


@pytest.mark.parametrize("Sq,bq", [(24, 512), (40, 16)])
def test_attention_with_asymmetric_head_dims_matches_jax(Sq, bq):
    """``dispatch.attention`` with qk 48 against v 32 takes the plain
    ``chunked_attention`` on the CPU (the flash kernel has no such
    instance; the reference routes it there too) and equals the
    reference's ``chunked_attention`` within 1e-5, one query block or
    several.  Cross attention (8 keys, no mask) routes to
    ``chunked_attention`` too, as in the reference, and equals its."""
    from repro_torch.kernels.flash_attention import chunked_attention
    rng = np.random.default_rng(Sq)
    q = rng.standard_normal((2, Sq, 4, 48)).astype(np.float32)
    k = rng.standard_normal((2, Sq, 4, 48)).astype(np.float32)
    v = rng.standard_normal((2, Sq, 4, 32)).astype(np.float32)
    want = jattn.chunked_attention(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), block_q=bq)
    got = dispatch.attention(*map(torch.as_tensor, (q, k, v)))
    assert got.shape == (2, Sq, 4, 32)
    assert _maxdiff(got, want) < EXACT
    plain = chunked_attention(*map(torch.as_tensor, (q, k, v)), block_q=bq)
    assert _maxdiff(plain, want) < EXACT
    cross = dispatch.attention(torch.as_tensor(q), torch.as_tensor(k[:, :8]),
                               torch.as_tensor(v[:, :8]), causal=False)
    jcross = jattn.chunked_attention(jnp.asarray(q), jnp.asarray(k[:, :8]),
                                     jnp.asarray(v[:, :8]), causal=False)
    assert cross.shape == (2, Sq, 4, 32)
    assert _maxdiff(cross, jcross) < EXACT


# --------------------------------------------------------------- family --

def test_params_and_cache_layout_match_jax(model):
    """The same keys, shapes and dtypes as the JAX init (the MTP block is
    one layer with no leading axis), each leaf's standard deviation
    within 5% of the JAX init's, and the latent cache's segments."""
    tcfg, jcfg, jp, _ = model
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
        assert (tsd == 0) if js == 0 else abs(tsd - js) <= 0.05 * js, path
    assert own["mtp"]["block"]["attn"]["wq_a"].dim() == 2
    assert "mlp" in own["mtp"]["block"] and "moe" not in own["mtp"]["block"]
    assert serve.segment_layout(tcfg) == jserve.segment_layout(jcfg)
    cache = serve.init_cache(tcfg, 2, 40, torch.float32, device="cpu")
    jcache = jserve.init_cache(jcfg, 2, 40, jnp.float32)
    for seg, jseg in zip(cache["segments"], jcache["segments"]):
        assert sorted(seg) == sorted(jseg) == ["ckv", "krope", "slot_pos"]
        for k in seg:
            assert tuple(seg[k].shape) == jseg[k].shape, k


@pytest.mark.parametrize("S", [16, 33])
def test_forward_train_matches_jax(model, S):
    """Logits and ``mtp_logits`` within 1e-5 of max(1, max|logit|) of the
    JAX forward's, ``moe_aux`` within 1e-5."""
    tcfg, jcfg, jp, tp = model
    toks = np.random.default_rng(S).integers(0, tcfg.vocab, (2, S)
                                             ).astype(np.int32)
    want, jaux = jforward(jp, jcfg, {"tokens": jnp.asarray(toks)})
    got, aux = forward_train(tp, tcfg, {"tokens": torch.as_tensor(toks)})
    assert got.shape == aux["mtp_logits"].shape == (2, S, tcfg.vocab)
    assert _relerr(got, want) < EXACT
    assert _relerr(aux["mtp_logits"], jaux["mtp_logits"]) < EXACT
    assert float(aux["moe_aux"]) > 0
    assert abs(float(aux["moe_aux"]) - float(jaux["moe_aux"])) < EXACT


def test_prefill_decode_matches_forward_and_jax(model):
    """Prefill then four decode steps: the last prefill row and every
    decode step equal the teacher-forced forward (1e-3, the reference's
    bound) and the JAX ones (1e-5); the latent caches equal the JAX
    caches."""
    tcfg, jcfg, jp, tp = model
    B, S, n = 2, 32, 4
    toks = np.random.default_rng(7).integers(0, tcfg.vocab, (B, S + n)
                                             ).astype(np.int32)
    full, _ = forward_train(tp, tcfg, {"tokens": torch.as_tensor(toks)})
    last, cache = prefill(tp, tcfg, {"tokens": torch.as_tensor(toks[:, :S])},
                          cache_len=S + 8, dtype=torch.float32)
    jlast, jcache = jprefill(jp, jcfg, {"tokens": jnp.asarray(toks[:, :S])},
                             cache_len=S + 8, dtype=jnp.float32)
    assert _maxdiff(last, full[:, S - 1].detach().numpy()) < DECODE
    assert _maxdiff(last, jlast) < EXACT
    for i in range(n):
        t = toks[:, S + i:S + i + 1]
        lg, cache = decode_step(tp, tcfg, cache, torch.as_tensor(t))
        jlg, jcache = jdecode(jp, jcfg, jcache, jnp.asarray(t))
        assert _maxdiff(lg, full[:, S + i].detach().numpy()) < DECODE, i
        assert _maxdiff(lg, jlg) < EXACT, i
    assert cache["pos"] == int(jcache["pos"]) == S + n
    for seg, jseg in zip(cache["segments"], jcache["segments"]):
        assert np.array_equal(seg["slot_pos"].numpy(),
                              np.asarray(jseg["slot_pos"]))
        for k in ("ckv", "krope"):
            assert _maxdiff(seg[k], jseg[k]) < EXACT, k


def test_batch_rollout_matches_jax(model):
    """``generate`` in chunks from the same key words: the same tokens bit
    for bit, the behaviour log-probs within 1e-5."""
    tcfg, jcfg, jp, tp = model
    prompts = np.random.default_rng(11).integers(
        3, tcfg.vocab, (3, 12)).astype(np.int32)
    js = jgenerate(jp, jcfg, jnp.asarray(prompts), max_new=10,
                   key=jax.random.PRNGKey(5), temperature=1.0, chunk=4)
    tst = generate(tp, tcfg, torch.as_tensor(prompts), max_new=10,
                   key=prng.PRNGKey(5), temperature=1.0, chunk=4)
    assert np.array_equal(tst.tokens.numpy(), np.asarray(js.tokens))
    assert _maxdiff(tst.behavior_logp, js.behavior_logp) < EXACT
    assert np.array_equal(tst.done.numpy(), np.asarray(js.done))


def _paths(tree, path=()):
    """{key path: leaf} of a nested dict."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_paths(v, path + (k,)))
        else:
            out[path + (k,)] = v
    return out


def _jax_paths(tree):
    return {tuple(p.key for p in path): np.asarray(leaf) for path, leaf in
            jax.tree_util.tree_flatten_with_path(jax.device_get(tree))[0]}


@pytest.mark.parametrize("T", [24, 40])
def test_train_step_matches_jax(model, T):
    """One ``make_train_step`` from the JAX init, the MTP loss in it:
    loss, ``mtp_loss``, ``moe_aux`` and ``grad_norm`` within 1e-4
    relative of the JAX step's; every leaf's gradient within 1e-4 of its
    largest |gradient|; the updated params within 1e-4 wherever the
    reference's clipped gradient is at least 1e-6 (100 x Adam's eps: the
    first Adam step is lr g / (|g| + eps), so where |g| is near eps fp32
    noise in g moves the update by up to 2 lr) and within 2 lr
    elsewhere; the MTP head and every MLA leaf but the norms moved."""
    tcfg, jcfg, jp, tp = model
    rng = np.random.default_rng(T)
    B, prompt, lr = 2, 8, 1e-3
    mask = np.zeros((B, T), np.float32)
    mask[:, prompt:] = rng.uniform(size=(B, T - prompt)) > 0.1
    batch = {
        "tokens": rng.integers(0, tcfg.vocab, (B, T)).astype(np.int32),
        "behavior_logp": (rng.uniform(-8, -4, (B, T)) * mask
                          ).astype(np.float32),
        "advantages": (rng.standard_normal((B, 1)) * mask).astype(np.float32),
        "mask": mask,
    }
    jbatch = jax.tree.map(jnp.asarray, batch)
    tbatch = {k: torch.as_tensor(v) for k, v in batch.items()}
    jstate = jts.TrainState(params=jp, opt=jts.adam_init(jp))
    jnew, jm = jax.jit(jts.make_train_step(jcfg, lr=lr))(jstate, jbatch)
    tstate = ts.TrainState(tp, opt.adam_init(tp))
    tnew, tm = ts.make_train_step(tcfg, lr=lr)(tstate, tbatch)
    for k in ("loss", "mtp_loss", "moe_aux", "grad_norm"):
        assert abs(float(tm[k]) - float(jm[k])) <= STEP * abs(float(jm[k])), k
    assert float(tm["mtp_loss"]) > 0

    jgrads = _jax_paths(jax.jit(jax.grad(
        lambda p, b: jts.make_loss_fn(jcfg)(p, b)[0]))(jp, jbatch))
    _, tgrads = ts.value_and_grad(ts.make_loss_fn(tcfg), tp, tbatch)
    tgrads = _paths(tgrads)
    assert sorted(tgrads) == sorted(jgrads)
    clip = min(1.0, 1.0 / float(jm["grad_norm"]))
    new, old = _paths(tnew.params), _paths(tp)
    for path, jg in _jax_paths(jnew.params).items():
        g = jgrads[path]
        assert np.max(np.abs(tgrads[path].numpy() - g)) <= \
            STEP * max(np.max(np.abs(g)), 1e-30), path
        gap = np.abs(new[path].numpy() - jg)
        sure = np.abs(g * clip) >= 1e-6
        assert np.all(gap[sure] <= STEP * np.maximum(1, np.abs(jg[sure]))), \
            path
        assert np.all(gap <= 2 * lr), path
    moved = {p: not torch.equal(new[p], old[p]) for p in new}
    assert moved[("mtp", "proj")]
    for p, m in moved.items():
        if "attn" in p and not p[-1].endswith("norm"):
            assert m, p


def test_engine_and_paged_layout_refuse_mla(model):
    """The engine (either layout) and the paged cache refuse the latent
    cache, as the reference does."""
    from repro.models.serve import assert_engine_cache as jassert
    tcfg, jcfg, _, tp = model
    for layout in ("dense", "paged"):
        for fn, c in ((serve.assert_engine_cache, tcfg), (jassert, jcfg)):
            with pytest.raises(AssertionError, match="latent"):
                fn(c, layout)
    with pytest.raises(AssertionError, match="latent"):
        serve.init_cache(tcfg, 2, 32, torch.float32, device="cpu",
                         layout="paged", page_size=4, n_pages=8)
    gen = GeneratorExecutor(tcfg, ArithmeticTasks(seed=0), n_prompts=1,
                            n_per_prompt=2, max_new=4, chunk=2, seed=0,
                            device="cpu")
    gen.set_weights(tp, version=0)
    with pytest.raises(AssertionError, match="latent"):
        gen.engine_configure(kv_layout="paged", kv_page_size=4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_convert_round_trip_of_the_mtp_head(dtype):
    """The whole tree, the ``mtp`` subtree and its unstacked block
    included, crosses both ways bit for bit; the router stays fp32."""
    jcfg = jconfigs.get_smoke(ARCH)
    jp = jax.device_get(jinit(jcfg, jax.random.PRNGKey(1),
                              getattr(jnp, dtype)))
    tp = convert.from_jax_numpy(jp, device="cpu")
    assert tp["mtp"]["block"]["attn"]["wk_b"].dtype == getattr(torch, dtype)
    assert tp["moe_layers"]["moe"]["w_router"].dtype == torch.float32
    assert tuple(tp["mtp"]["proj"].shape) == (2 * jcfg.d_model, jcfg.d_model)
    back = convert.to_jax_numpy(tp)
    assert jax.tree.structure(back) == jax.tree.structure(jp)
    for a, b in zip(jax.tree.leaves(jp), jax.tree.leaves(back)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(a.view(np.uint8), b.view(np.uint8))


def test_launcher_runs_the_mla_smoke():
    """``--arch deepseek-v3-671b --smoke --device cpu --steps 2`` runs the
    async loop through the port's launcher with the MTP loss; without
    ``--smoke`` the launcher takes the published config."""
    out = launch.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                       "--steps", "2"])
    hist = out["history"]
    assert len(hist) == 2
    for h in hist:
        assert np.isfinite(h["loss"]) and h["moe_aux"] > 0
        assert np.isfinite(h["mtp_loss"]) and h["mtp_loss"] > 0
        assert h["weight_version"] == max(0, h["step"] - 1)
    full = launch.config_for(launch.parse_args(["--arch", ARCH]))
    assert full == configs.get_config(ARCH) and full.d_model == 7168
    bb.check_family(full)
