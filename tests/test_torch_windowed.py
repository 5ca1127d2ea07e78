"""The port's windowed dense family against the JAX package's, on the CPU.

The four windowed archs of the registry (starcoder2-3b, command-r-35b,
deepseek-67b, nemotron-4-340b) at their smoke configs (window 64), and a
dense micro config whose ``window_pattern`` makes two segments: the
windowed ``chunked_attention``, the segment walk of ``forward_train``
(windows merged for a sequence no longer than the window, windowed past
it), prefill + decode, the ring decode past the window, one train step,
the batch rollout and the paged engine.  Inputs are made with numpy from
a seed; JAX params cross through ``convert``.

Tolerances: ``LOGITS`` (1e-4 fp32) between the two packages' logits,
where a d 256 product summed in another order differs by a few 1e-6
relative; the reference's own bounds where its test states one:
1e-3 for prefill + decode against forward and 2e-3 for the ring
(``tests/test_arch_smoke.py``), 1e-4 for engine log-probs against the
teacher-forced recompute (``tests/test_paging.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core.executor import GeneratorExecutor as JGenerator
from repro.models import backbone as jbb
from repro.models import decode_step as jdecode
from repro.models import forward_train as jforward
from repro.models import init_params as jinit
from repro.models import prefill as jprefill
from repro.models import serve as jserve
from repro.models.attention import chunked_attention as jchunked
from repro.rl.data import ArithmeticTasks as JTasks
from repro.rl.rollout import generate as jgenerate
from repro.train import trainstep as jts
from repro_torch import configs, convert
from repro_torch.core.aipo import token_logprobs
from repro_torch.core.executor import GeneratorExecutor
from repro_torch.kernels.flash_attention import chunked_attention
from repro_torch.models import backbone as bb
from repro_torch.models import decode_step, forward_train, prefill
from repro_torch.models import serve
from repro_torch.rl import prng
from repro_torch.rl.data import ArithmeticTasks
from repro_torch.rl.rollout import generate
from repro_torch.train import optimizer as opt
from repro_torch.train import trainstep as ts

ARCHS = ["starcoder2-3b", "command-r-35b", "deepseek-67b", "nemotron-4-340b"]
LOGITS = 1e-4
DECODE = 1e-3           # tests/test_arch_smoke.py: prefill + decode
RING = 2e-3             # tests/test_arch_smoke.py: ring past the window
ENGINE_MU = 1e-4        # tests/test_paging.py: engine mu vs recompute


def _micro_two_segments(get):
    """Two layers, the first windowed and the second global: two cache
    segments of different ring sizes."""
    return get("starcoder2-3b").replace(
        n_layers=2, d_model=32, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=64, vocab=512, window=6, window_pattern=2)


CONFIGS = {a: (lambda a=a: (configs.get_smoke(a), jconfigs.get_smoke(a)))
           for a in ARCHS}
CONFIGS["pattern2"] = lambda: (_micro_two_segments(configs.get_smoke),
                               _micro_two_segments(jconfigs.get_smoke))
NAMES = list(CONFIGS)


@pytest.fixture(scope="module")
def models():
    """name -> (port cfg, JAX cfg, JAX params, port params), fp32, with
    random biases where the config has them so a dropped term shows."""
    out = {}
    for i, name in enumerate(NAMES):
        tcfg, jcfg = CONFIGS[name]()
        jp = jinit(jcfg, jax.random.PRNGKey(i), jnp.float32)
        if jcfg.bias:
            jp = jax.tree_util.tree_map_with_path(
                lambda path, a: a + 0.05 if path[-1].key.startswith("b")
                else a, jp)
        out[name] = (tcfg, jcfg, jp,
                     convert.from_jax_numpy(jax.device_get(jp), device="cpu"))
    return out


def _maxdiff(t, j):
    return float(np.max(np.abs(t.detach().numpy() - np.asarray(j))))


# ------------------------------------------------------ chunked_attention --

@pytest.mark.parametrize("S,window,bq,q_offset", [
    (96, 0, 32, 0), (96, 32, 16, 0), (128, 64, 32, 0), (100, 48, 32, 0),
    (256, 32, 32, 0), (70, 16, 16, 30), (40, 64, 16, 24),
])
def test_chunked_attention_window_matches_jax(S, window, bq, q_offset):
    """The S / window / block_q grid of ``tests/test_models_unit.py`` (the
    span path wherever S > window + block_q), plus prefill continuations
    over a cached prefix, windowed and with the window past the keys."""
    rng = np.random.default_rng(S + window)
    q = (rng.standard_normal((2, S - q_offset, 4, 16)) * 0.5
         ).astype(np.float32)
    k = (rng.standard_normal((2, S, 2, 16)) * 0.5).astype(np.float32)
    v = rng.standard_normal((2, S, 2, 16)).astype(np.float32)
    want = jchunked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                    window=window, block_q=bq, q_offset=q_offset)
    got = chunked_attention(torch.as_tensor(q), torch.as_tensor(k),
                            torch.as_tensor(v), window=window, block_q=bq,
                            q_offset=q_offset)
    assert _maxdiff(got, want) < 1e-5


# ------------------------------------------------------- configs / layout --

@pytest.mark.parametrize("name", NAMES)
def test_segments_and_ring_layout_match_jax(models, name):
    tcfg, jcfg, _, _ = models[name]
    L = tcfg.n_layers
    assert bb._layer_windows(tcfg, L) == \
        [int(w) for w in jbb._layer_windows(jcfg, L)]
    for seq_len in (0, 8, tcfg.window, tcfg.window + 1):
        assert bb._segment_windows(tcfg, L, 0, seq_len) == \
            jbb._segment_windows(jcfg, L, 0, seq_len)
    assert serve.segment_layout(tcfg) == jserve.segment_layout(jcfg)
    cache = serve.init_cache(tcfg, 2, 100, torch.float32, device="cpu")
    jcache = jserve.init_cache(jcfg, 2, 100, jnp.float32)
    assert len(cache["segments"]) == len(jcache["segments"])
    for seg, jseg in zip(cache["segments"], jcache["segments"]):
        assert tuple(seg["k"].shape) == jseg["k"].shape
    if name == "pattern2":
        assert [s["k"].shape[2] for s in cache["segments"]] == [6, 100]


# ------------------------------------------------------------ forward ----

@pytest.mark.parametrize("S", [48, 100])
@pytest.mark.parametrize("name", NAMES)
def test_forward_train_matches_jax(models, name, S):
    """S = 48: the windows merge (window >= S, and the pattern2 micro
    config's window 6 still bites); S = 100 runs every window."""
    tcfg, jcfg, jp, tp = models[name]
    toks = np.random.default_rng(S).integers(0, tcfg.vocab, (2, S)
                                             ).astype(np.int32)
    want, _ = jforward(jp, jcfg, {"tokens": jnp.asarray(toks)})
    got, _ = forward_train(tp, tcfg, {"tokens": torch.as_tensor(toks)})
    assert got.shape == (2, S, tcfg.vocab)
    assert _maxdiff(got, want) < LOGITS


@pytest.mark.parametrize("name", NAMES)
def test_prefill_decode_matches_forward_and_jax(models, name):
    """``tests/test_arch_smoke.py::test_prefill_decode_matches_forward``
    and ``test_multi_token_decode``: prefill then four decode steps equal
    the teacher-forced forward (1e-3) and the JAX decode logits."""
    tcfg, jcfg, jp, tp = models[name]
    B, S, n = 2, 32, 4
    toks = np.random.default_rng(7).integers(0, tcfg.vocab, (B, S + n)
                                             ).astype(np.int32)
    full, _ = forward_train(tp, tcfg, {"tokens": torch.as_tensor(toks)})
    last, cache = prefill(tp, tcfg, {"tokens": torch.as_tensor(toks[:, :S])},
                          cache_len=S + n + 4, dtype=torch.float32)
    jlast, jcache = jprefill(jp, jcfg, {"tokens": jnp.asarray(toks[:, :S])},
                             cache_len=S + n + 4, dtype=jnp.float32)
    assert _maxdiff(last, full[:, S - 1]) < DECODE
    assert _maxdiff(last, jlast) < LOGITS
    for i in range(n):
        t = toks[:, S + i:S + i + 1]
        lg, cache = decode_step(tp, tcfg, cache, torch.as_tensor(t))
        jlg, jcache = jdecode(jp, jcfg, jcache, jnp.asarray(t))
        assert _maxdiff(lg, full[:, S + i]) < DECODE, i
        assert _maxdiff(lg, jlg) < LOGITS, i


@pytest.mark.parametrize("name", NAMES)
def test_ring_decode_past_the_window(models, name):
    """``tests/test_arch_smoke.py::test_ring_buffer_window_decode``: a
    prefill longer than the window leaves a ring of W slots holding its
    last W positions out of order; decoding wraps it again and equals the
    windowed forward (2e-3) and the JAX ring's logits and slot positions."""
    tcfg, jcfg, jp, tp = models[name]
    W = tcfg.window
    B, S, n = 1, W + 6, 5
    toks = np.random.default_rng(4).integers(0, tcfg.vocab, (B, S + n)
                                             ).astype(np.int32)
    _, cache = prefill(tp, tcfg, {"tokens": torch.as_tensor(toks[:, :S])},
                       cache_len=S + n, dtype=torch.float32)
    _, jcache = jprefill(jp, jcfg, {"tokens": jnp.asarray(toks[:, :S])},
                         cache_len=S + n, dtype=jnp.float32)
    ring = cache["segments"][0]
    assert ring["k"].shape[2] == W
    full, _ = forward_train(tp, tcfg, {"tokens": torch.as_tensor(toks)})
    for i in range(n):
        t = toks[:, S + i:S + i + 1]
        lg, cache = decode_step(tp, tcfg, cache, torch.as_tensor(t))
        jlg, jcache = jdecode(jp, jcfg, jcache, jnp.asarray(t))
        assert _maxdiff(lg, full[:, S + i]) < RING, i
        assert _maxdiff(lg, jlg) < LOGITS, i
    for seg, jseg in zip(cache["segments"], jcache["segments"]):
        assert np.array_equal(seg["slot_pos"].numpy(),
                              np.asarray(jseg["slot_pos"]))
        assert _maxdiff(seg["k"], jseg["k"]) < LOGITS
    # the ring wrapped: it holds the last W positions, each at pos % W
    want = np.zeros(W, np.int32)
    for p in range(S + n - W, S + n):
        want[p % W] = p
    assert np.array_equal(ring["slot_pos"].numpy(), want)


# ---------------------------------------------------------- train step ---

@pytest.mark.parametrize("T", [24, 80])
@pytest.mark.parametrize("name", ["starcoder2-3b", "pattern2"])
def test_train_step_matches_jax(models, name, T):
    """One ``make_train_step`` from the JAX init, with the sequence inside
    the window (merged) and past it: loss and grad norm within 1e-5
    relative; each leaf's first moment (its gradient times 1 - b1) within
    1e-5 of the leaf's largest; and its updates as
    ``tests/test_torch_train.py`` holds them: all within 0.2 of the
    largest, and 99% within 1e-5 where the leaf has the 1000 elements
    that make a 99% quantile (Adam moves a param whose gradient is near
    eps by a visible fraction of lr).  The key bias is left out: its
    gradient is 0 in exact arithmetic (it shifts every score of a query
    row by the same q . b_k, which the softmax cancels), so both
    packages' Adam steps scale rounding noise up to about lr."""
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
    jnew, jm = jax.jit(jts.make_train_step(jcfg, lr=1e-3))(
        jstate, jax.tree.map(jnp.asarray, batch))
    tstate = ts.TrainState(tp, opt.adam_init(tp))
    tnew, tm = ts.make_train_step(tcfg, lr=1e-3)(
        tstate, {k: torch.as_tensor(v) for k, v in batch.items()})
    for k in ("loss", "grad_norm"):
        assert abs(float(tm[k]) - float(jm[k])) <= 1e-5 * abs(float(jm[k])), k
    jleaves = jax.tree_util.tree_flatten_with_path(
        jax.device_get(jnew.params))[0]
    for t, tm1, (path, j), jm1, o in zip(
            opt.tree_leaves(tnew.params), opt.tree_leaves(tnew.opt.m),
            jleaves, jax.tree.leaves(jax.device_get(jnew.opt.m)),
            jax.tree.leaves(jax.device_get(jp))):
        if path[-1].key == "bk":
            continue
        jm1 = np.asarray(jm1)
        assert np.max(np.abs(tm1.numpy() - jm1)) \
            <= 1e-5 * np.max(np.abs(jm1)), path
        dj = np.asarray(j, np.float64) - np.asarray(o, np.float64)
        dt = t.numpy().astype(np.float64) - np.asarray(o, np.float64)
        err = np.abs(dt - dj) / np.max(np.abs(dj))
        assert err.max() <= 0.2, path
        if err.size >= 1000:
            assert np.quantile(err, 0.99) <= 1e-5, path


# ------------------------------------------------------- batch rollout ---

@pytest.mark.parametrize("name", NAMES)
def test_batch_rollout_matches_jax_past_the_window(models, name):
    """``generate`` from prompts past the window, in chunks: the same key
    words give the same tokens bit for bit, the behaviour log-probs agree
    within 1e-5 (fp32), and the rows that finish keep ticking into the
    ring as in the reference."""
    tcfg, jcfg, jp, tp = models[name]
    Sp = tcfg.window + 4
    prompts = np.random.default_rng(11).integers(
        3, tcfg.vocab, (3, Sp)).astype(np.int32)
    js = jgenerate(jp, jcfg, jnp.asarray(prompts), max_new=10,
                   key=jax.random.PRNGKey(5), temperature=1.0, chunk=4)
    tst = generate(tp, tcfg, torch.as_tensor(prompts), max_new=10,
                   key=prng.PRNGKey(5), temperature=1.0, chunk=4)
    assert np.array_equal(tst.tokens.numpy(), np.asarray(js.tokens))
    assert _maxdiff(tst.behavior_logp, js.behavior_logp) < 1e-5
    assert np.array_equal(tst.done.numpy(), np.asarray(js.done))
    for seg, jseg in zip(tst.cache["segments"], js.cache["segments"]):
        assert np.array_equal(seg["slot_pos"].numpy(),
                              np.asarray(jseg["slot_pos"]))


# -------------------------------------------------------- paged engine ---

def _engine(name, models, torch_side, prompt_len):
    tcfg, jcfg, jp, tp = models[name]
    kw = dict(n_prompts=2, n_per_prompt=2, max_new=6, chunk=2, seed=0)
    if torch_side:
        gen = GeneratorExecutor(tcfg, ArithmeticTasks(
            prompt_len=prompt_len, max_operand=9, ops="+", seed=0),
            device="cpu", **kw)
        gen.set_weights(tp, version=0)
    else:
        gen = JGenerator(jcfg, JTasks(prompt_len=prompt_len, max_operand=9,
                                      ops="+", seed=0), **kw)
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


@pytest.mark.parametrize("name", ["starcoder2-3b", "pattern2"])
def test_paged_engine_windowed_matches_jax(models, name):
    """The twin of ``tests/test_paging.py::
    test_engine_paged_windowed_family_exact_mu``: prompts past the window
    (starcoder2's 64; the micro config's 6), a paged engine whose rows
    join mid-decode; the emitted batches equal the JAX engine's (tokens
    and mask exactly, mu within 1e-5), and mu equals the teacher-forced
    windowed recompute within 1e-4."""
    tcfg, jcfg, jp, tp = models[name]
    prompt_len = tcfg.window + 6
    touts = _drain(_engine(name, models, True, prompt_len), 2)
    jouts = _drain(_engine(name, models, False, prompt_len), 2)
    for t, j in zip(touts, jouts):
        for key in ("tokens", "mask"):
            assert np.array_equal(t[key].numpy(), np.asarray(j[key])), key
        assert _maxdiff(t["behavior_logp"], j["behavior_logp"]) < 1e-5
        toks = t["tokens"]
        logits, _ = forward_train(tp, tcfg, {"tokens": toks})
        rec = torch.zeros_like(t["behavior_logp"])
        rec[:, 1:] = token_logprobs(logits[:, :-1], toks[:, 1:].long())
        m = t["mask"]
        assert float((t["behavior_logp"] * m - rec * m).abs().max()) \
            < ENGINE_MU


def test_engine_cache_contract_windowed():
    """``tests/test_paging.py::test_engine_cache_contract_paged_vs_dense``:
    the paged layout admits windows, the dense layout refuses them with
    the reference's message, and both still refuse MLA and hybrids."""
    from repro.models.serve import assert_engine_cache as jassert
    for cfg, jcfg in (CONFIGS["starcoder2-3b"](), CONFIGS["pattern2"]()):
        serve.assert_engine_cache(cfg, "paged")
        jassert(jcfg, "paged")
        for fn, c in ((serve.assert_engine_cache, cfg), (jassert, jcfg)):
            with pytest.raises(AssertionError, match="paged layout"):
                fn(c, "dense")
        for layout in ("dense", "paged"):
            with pytest.raises(AssertionError, match="latent"):
                serve.assert_engine_cache(cfg.replace(attn_kind="mla"),
                                          layout)
            with pytest.raises(AssertionError, match="family"):
                serve.assert_engine_cache(cfg.replace(family="hybrid"),
                                          layout)
