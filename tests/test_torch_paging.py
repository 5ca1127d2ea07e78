"""The port's paged KV cache against the JAX package's: the allocator and
radix bookkeeping (a copy, held to the same tables and refcounts), the
plain paged attention against ``paged_attention_ref`` and the Pallas
kernel in interpret mode, per-row and paged decode against JAX, and,
within the port, the reference's bitwise properties: paged == dense,
and a radix-hit admission == a fresh prefill.

Inputs are made with numpy from a seed; JAX params cross through
``convert``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.llama_paper import smoke
from repro.kernels.paged_attention import paged_attention_kernel, \
    paged_attention_ref
from repro.models import decode_step as jdecode
from repro.models import init_params as jinit
from repro.models import paging as jpaging
from repro.rl import rollout as jrollout
from repro_torch import convert
from repro_torch.configs.llama_paper import smoke as tsmoke
from repro_torch.kernels import dispatch
from repro_torch.kernels.paged_attention import paged_attention_plain
from repro_torch.models import decode_step
from repro_torch.models import paging
from repro_torch.models.serve import SlotPool, assert_engine_cache
from repro_torch.rl import prng
from repro_torch.rl import rollout


def _micro(mk):
    return mk().replace(n_layers=1, d_model=32, n_heads=2, n_kv_heads=2,
                        head_dim=16, d_ff=64, vocab=64)


@pytest.fixture(scope="module")
def micro():
    jp = jinit(_micro(smoke), jax.random.PRNGKey(0), jnp.float32)
    return _micro(tsmoke), convert.from_jax_numpy(jax.device_get(jp),
                                                  device="cpu")


# --------------------------------------------- allocator and radix tree --

def _script(mod):
    """A scripted sequence of pool and radix operations; returns every
    observable result (tables, refcounts, free counts, matches)."""
    pool = mod.PagePool(10)
    radix = mod.RadixCache(pool, page_size=4)
    log = []
    a = pool.alloc_many(3)
    b = pool.alloc()
    pool.incref(b)
    log += [a, b, pool.refcount(b), pool.decref(b), pool.free_count]
    prompt = tuple(range(13))
    p1 = mod.plan_admission(pool, radix, prompt, 4, 4)
    log += [p1.table, p1.n_cached]
    log.append(radix.insert(prompt, p1.table))
    p2 = mod.plan_admission(pool, radix, prompt, 4, 4)
    log += [p2.table, p2.n_cached, [pool.refcount(p) for p in range(10)]]
    log += [radix.match(prompt), radix.match(prompt, max_tokens=9),
            radix.match((7,) * 12)]
    other = tuple(range(50, 63))
    log.append(mod.plan_admission(pool, radix, other, 4, 4))  # dry arena
    mod.release_plan(pool, p1)
    mod.release_plan(pool, p2)
    log += [pool.free_count, [pool.refcount(p) for p in range(10)]]
    p3 = mod.plan_admission(pool, radix, other, 4, 4)   # evicts under need
    log += [p3.table, p3.n_cached, len(radix), pool.free_count]
    mod.release_plan(pool, p3)
    for p in a + [b]:
        pool.decref(p)
    log.append(radix.evict(2))
    radix.clear()
    pool.assert_no_leaks()
    log += [pool.free_count, mod.paged_blocks(13, 4), mod.paged_clamp(13, 4)]
    return log


def test_paging_bookkeeping_matches_jax():
    assert _script(paging) == _script(jpaging)


def test_page_pool_refuses_double_free_and_use_after_free():
    pool = paging.PagePool(2)
    p = pool.alloc()
    assert pool.decref(p)
    with pytest.raises(AssertionError, match="double free"):
        pool.decref(p)
    with pytest.raises(AssertionError, match="use-after-free"):
        pool.incref(p)


def test_slot_pool_and_cache_contract():
    sp = SlotPool(3)
    assert [sp.acquire() for _ in range(3)] == [0, 1, 2]
    assert sp.acquire() is None and sp.free_count == 0
    sp.release(1)
    assert sp.used == frozenset({0, 2}) and sp.acquire() == 1
    cfg = tsmoke()
    assert_engine_cache(cfg)
    assert_engine_cache(cfg.replace(window=8), "paged")
    with pytest.raises(AssertionError, match="paged layout"):
        assert_engine_cache(cfg.replace(window=8), "dense")
    with pytest.raises(AssertionError, match="latent"):
        assert_engine_cache(cfg.replace(attn_kind="mla"), "paged")


# ------------------------------------------------ paged attention, plain --

def _arena_problem(pos):
    """The shapes of the reference suite's ``arena_problem``."""
    rng = np.random.default_rng(0)
    B, H, K, hd, P, mb, n_pages = 3, 4, 2, 16, 5, 4, 16
    q = rng.standard_normal((B, H, hd), dtype=np.float32)
    ak = rng.standard_normal((n_pages + 1, P, K, hd), dtype=np.float32)
    av = rng.standard_normal((n_pages + 1, P, K, hd), dtype=np.float32)
    pt = rng.integers(0, n_pages, (B, mb + 1)).astype(np.int32)
    return q, ak, av, pt, np.asarray(pos, np.int32)


@pytest.mark.parametrize("window,pos", [(0, [3, 11, 19]), (6, [3, 11, 19]),
                                        (0, [0, 0, 0]), (6, [0, 9, 19])])
def test_paged_attention_plain_matches_jax(window, pos):
    """Against the gather reference and the Pallas kernel in interpret
    mode, fp32 within 2e-5 (the reference suite's own tolerance); pos = 0
    leaves whole pages masked."""
    args = _arena_problem(pos)
    got = paged_attention_plain(*map(torch.as_tensor, args), window=window)
    jargs = [jnp.asarray(a) for a in args]
    for want in (paged_attention_ref(*jargs, window=window),
                 paged_attention_kernel(*jargs, window=window,
                                        interpret=True)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=2e-5, atol=2e-5)
    assert torch.isfinite(got).all()


def test_paged_attention_dispatch_takes_plain_on_cpu():
    args = [torch.as_tensor(a) for a in _arena_problem([3, 11, 19])]
    assert torch.equal(dispatch.paged_attention(*args, window=6),
                       paged_attention_plain(*args, window=6))


def test_paged_attention_cuda_refuses_cpu_tensors():
    from repro_torch.kernels.paged_attention import paged_attention_cuda
    args = [torch.as_tensor(a) for a in _arena_problem([3, 11, 19])]
    with pytest.raises(ValueError, match="CUDA"):
        paged_attention_cuda(*args)


# ------------------------------------------ per-row decode against JAX ----

@pytest.fixture(scope="module")
def smoke_models():
    jp = jinit(smoke(), jax.random.PRNGKey(1), jnp.float32)
    return jp, convert.from_jax_numpy(jax.device_get(jp), device="cpu")


def _prompt(seed, n=6, vocab=512):
    return np.random.default_rng(seed).integers(3, vocab, (1, n)).astype(
        np.int32)


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_divergent_cursor_decode_matches_jax(smoke_models, layout):
    """llama31-smoke, fp32: rows admitted at different times decode at
    divergent cursors; every step's logits and cursors match JAX's within
    1e-5, and the pool's tokens and log-probs after a sampled chunk are
    equal (tokens) and within 1e-5 (log-probs)."""
    jp, tp = smoke_models
    T, Sp, P, R = 16, 6, 4, 3
    jcfg, tcfg = smoke(), tsmoke()
    kw = dict(kv_layout=layout, kv_page_size=P)
    jpool = jrollout.start_row_pool(jcfg, R, T, Sp, **kw)
    tpool = rollout.start_row_pool(tcfg, R, T, Sp, device="cpu", **kw)
    mb = paging.paged_blocks(T, P)
    pages = paging.PagePool(R * mb)

    def admit(slot, seed):
        nonlocal jpool, tpool
        pr = _prompt(seed)
        if layout == "dense":
            jrow = jrollout.start_rollout(jp, jcfg, jnp.asarray(pr), T,
                                          cache_len=T + 1)
            jpool = jrollout.admit_row(jpool, jrow, slot)
            trow = rollout.start_rollout(tp, tcfg, torch.as_tensor(pr), T,
                                         cache_len=T + 1)
            tpool = rollout.admit_row(tpool, trow, slot)
            return
        table = pages.alloc_many(mb) + [pages.trash_page]
        jpool = jrollout.admit_row_paged(
            jp, jcfg, jpool, jnp.asarray(pr), jnp.asarray(table, jnp.int32),
            slot, n_cached=0)
        tpool = rollout.admit_row_paged(
            tp, tcfg, tpool, torch.as_tensor(pr),
            torch.tensor(table, dtype=torch.int32), slot, n_cached=0)

    def step(toks):
        nonlocal jpool, tpool
        jl, jc = jdecode(jp, jcfg, jpool.cache, jnp.asarray(toks)[:, None])
        tl, tc = decode_step(tp, tcfg, tpool.cache, torch.as_tensor(toks)[:, None])
        jpool, tpool = jpool._replace(cache=jc), tpool._replace(cache=tc)
        assert np.array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
        return jl, tl

    admit(0, 1)
    jl, tl = step(np.asarray([7, 0, 0], np.int32))
    assert np.max(np.abs(tl[0].numpy() - np.asarray(jl[0]))) < 1e-5
    jpool = jpool._replace(last_logits=jl)
    tpool = tpool._replace(last_logits=tl)
    admit(2, 2)
    jl, tl = step(np.asarray([9, 0, 11], np.int32))
    for r in (0, 2):
        assert np.max(np.abs(tl[r].numpy() - np.asarray(jl[r]))) < 1e-5
    jpool = jpool._replace(last_logits=jl)
    tpool = tpool._replace(last_logits=tl)
    jpool = jrollout.rollout_rows_chunk(jp, jcfg, jpool,
                                        jax.random.PRNGKey(4), n_steps=4)
    tpool = rollout.rollout_rows_chunk(tp, tcfg, tpool, prng.PRNGKey(4),
                                       n_steps=4)
    assert np.array_equal(tpool.tokens.numpy(), np.asarray(jpool.tokens))
    assert np.max(np.abs(tpool.behavior_logp.numpy()
                         - np.asarray(jpool.behavior_logp))) < 1e-5
    assert np.array_equal(tpool.done.numpy(), np.asarray(jpool.done))


def test_vector_pos_decode_matches_scalar_pos(smoke_models):
    """A [B] cursor tensor with equal entries decodes as the int cursor
    it generalizes, bit for bit."""
    _, tp = smoke_models
    cfg = tsmoke()
    pr = torch.as_tensor(np.concatenate([_prompt(3), _prompt(4)]))
    outs = []
    for per_row in (False, True):
        st = rollout.start_rollout(tp, cfg, pr, 10)
        if per_row:
            st.cache["pos"] = torch.full((2,), st.cache["pos"],
                                         dtype=torch.int32)
        logits, cache = decode_step(tp, cfg, st.cache,
                                    torch.tensor([[3], [9]]))
        outs.append(logits)
    assert torch.equal(*outs)
    assert cache["pos"].tolist() == [7, 7]


# --------------------------------------- within the port: bitwise parity --

def _pools(cfg, R, T, Sp, P, n_pages):
    """Matched dense and paged pools: the paged logical length mb * P
    equals the dense ring's total_len + 1, the bitwise precondition."""
    mb = paging.paged_blocks(T, P)
    assert mb * P == T + 1, (T, P)
    dense = rollout.start_row_pool(cfg, R, T, Sp, device="cpu")
    paged = rollout.start_row_pool(cfg, R, T, Sp, device="cpu",
                                   kv_layout="paged", kv_page_size=P,
                                   kv_pages=n_pages)
    return dense, paged, mb


def _admit_pair(params, cfg, dense, paged, pr, slot, pool, radix, mb, P):
    T = dense.tokens.shape[1]
    row = rollout.start_rollout(params, cfg, pr, T, cache_len=T + 1)
    dense = rollout.admit_row(dense, row, slot)
    ids = tuple(int(t) for t in pr[0])
    plan = paging.plan_admission(pool, radix, ids, mb, P)
    if plan is None:
        return dense, paged, None
    paged = rollout.admit_row_paged(
        params, cfg, paged, pr,
        torch.tensor(plan.table + (pool.trash_page,), dtype=torch.int32),
        slot, n_cached=plan.n_cached)
    if radix is not None:
        radix.insert(ids, plan.table)
    return dense, paged, plan


def _run_mirrored(cfg, params, order, shared_prefix):
    """Drive matched dense and paged pools through an interleaved
    admit / decode / release schedule; with ``shared_prefix`` the prompts
    share their first 5 tokens (one page), so admissions hit the radix."""
    T, Sp, P, R = 9, 7, 5, 3
    dense, paged, mb = _pools(cfg, R, T, Sp, P, R * 2 + 2)
    pool = paging.PagePool(R * mb + 2)
    radix = paging.RadixCache(pool, P)
    rng = np.random.default_rng(3)
    head = rng.integers(3, cfg.vocab, 5)
    prompts = []
    for _ in range(5):
        pr = rng.integers(3, cfg.vocab, Sp)
        if shared_prefix:
            pr[:5] = head
        prompts.append(torch.as_tensor(pr[None].astype(np.int32)))
    live, plans, nxt = {}, {}, 0
    for step, op in enumerate(order):
        if op == 0 and nxt < len(prompts) and len(live) < R:
            slot = min(set(range(R)) - set(live))
            dense, paged, plan = _admit_pair(params, cfg, dense, paged,
                                             prompts[nxt], slot, pool,
                                             radix, mb, P)
            if plan is None:
                continue
            live[slot], plans[slot] = nxt, plan
            nxt += 1
        elif op == 1:
            key = prng.PRNGKey(step)
            dense = rollout.rollout_rows_chunk(params, cfg, dense, key,
                                               n_steps=2)
            paged = rollout.rollout_rows_chunk(params, cfg, paged, key,
                                               n_steps=2)
        elif op == 2 and live:
            slot = min(live)
            paging.release_plan(pool, plans.pop(slot))
            paged = rollout.release_row(paged, slot)
            paged.done[slot] = True
            dense.done[slot] = True
            del live[slot]
    return dense, paged, radix


def _assert_pools_equal(dense, paged):
    assert torch.equal(dense.tokens, paged.tokens)
    assert torch.equal(dense.behavior_logp, paged.behavior_logp)
    # logits are compared where they are ever used: live rows whose cursor
    # is still in bounds (a released row decodes on the ring's spare slot
    # in one layout and the trash page in the other)
    T = dense.tokens.shape[1]
    lv = ~dense.done & (dense.cache["pos"] < T)
    assert torch.equal(dense.last_logits[lv], paged.last_logits[lv])


def _model(request, name):
    """(port cfg, port params) of the ``micro`` or ``smoke_models``
    fixture."""
    params = request.getfixturevalue(name)[1]
    return (_micro(tsmoke) if name == "micro" else tsmoke()), params


# A radix hit prefills the prompt's last two tokens alone.  At micro widths
# (g = 1, hd = 16) the attention products of those two query rows fall
# under torch's CPU threshold for small batched products (depth x rows x
# columns < 400), which runs its own loop instead of MKL's and sums in
# another order, so the shared-prefix case runs at llama31-smoke widths
# (see test_radix_hit_at_micro_widths_is_exact_to_rounding).
@pytest.mark.parametrize("name,shared_prefix", [("micro", False),
                                                ("smoke_models", False),
                                                ("smoke_models", True)])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_paged_matches_dense_across_admit_release_orders(request, name,
                                                         shared_prefix,
                                                         seed):
    """Any interleaving of admissions, decode chunks and releases keeps
    paged decode bitwise equal to the dense ring, radix hits included."""
    cfg, params = _model(request, name)
    order = np.random.default_rng(seed).integers(0, 3, 14).tolist()
    dense, paged, radix = _run_mirrored(cfg, params, order, shared_prefix)
    _assert_pools_equal(dense, paged)
    if shared_prefix and order.count(0) > 1:
        assert len(radix) > 0


def test_paged_decode_matches_dense_bitwise(micro):
    cfg, params = micro
    T, Sp, P = 9, 5, 5
    dense, paged, mb = _pools(cfg, 3, T, Sp, P, 6)
    pool = paging.PagePool(3 * mb)
    rng = np.random.default_rng(5)
    for slot in range(2):
        pr = torch.as_tensor(rng.integers(3, cfg.vocab, (1, Sp)).astype(
            np.int32))
        dense, paged, _ = _admit_pair(params, cfg, dense, paged, pr, slot,
                                      pool, None, mb, P)
    assert torch.equal(dense.last_logits, paged.last_logits)
    dense = rollout.rollout_rows_chunk(params, cfg, dense, prng.PRNGKey(7),
                                       n_steps=4)
    paged = rollout.rollout_rows_chunk(params, cfg, paged, prng.PRNGKey(7),
                                       n_steps=4)
    assert torch.equal(dense.tokens, paged.tokens)
    assert torch.equal(dense.last_logits, paged.last_logits)


def _radix_hit(cfg, params):
    """Admit a 12-token prompt fresh into row 0, then again into row 1
    from the radix (two pages of 5 cached, the last two tokens
    prefilled); returns (pool, plan 1, plan 2)."""
    T, P, Sp = 19, 5, 12                      # mb = 4
    paged = rollout.start_row_pool(cfg, 3, T, Sp, device="cpu",
                                   kv_layout="paged", kv_page_size=P,
                                   kv_pages=12)
    pool = paging.PagePool(12)
    radix = paging.RadixCache(pool, P)
    pr = torch.arange(1, Sp + 1, dtype=torch.int32)[None] + 3
    ids = tuple(int(t) for t in pr[0])
    p1 = paging.plan_admission(pool, radix, ids, 4, P)
    assert p1.n_cached == 0
    paged = rollout.admit_row_paged(
        params, cfg, paged, pr,
        torch.tensor(p1.table + (pool.trash_page,), dtype=torch.int32), 0,
        n_cached=0)
    radix.insert(ids, p1.table)
    p2 = paging.plan_admission(pool, radix, ids, 4, P)
    assert p2.n_cached == 10 and p2.table[:2] == p1.table[:2]
    paged = rollout.admit_row_paged(
        params, cfg, paged, pr,
        torch.tensor(p2.table + (pool.trash_page,), dtype=torch.int32), 1,
        n_cached=p2.n_cached)
    return paged, p1, p2


def test_radix_hit_admission_matches_fresh_prefill_bitwise(smoke_models):
    """llama31-smoke: a sibling admitted from shared radix pages (only the
    suffix prefilled) has the last-token logits and suffix KVs of the full
    prefill that populated those pages, bit for bit; the shared pages are
    byte-identical after both rows have decoded."""
    cfg, params = tsmoke(), smoke_models[1]
    paged, p1, p2 = _radix_hit(cfg, params)
    assert torch.equal(paged.last_logits[0], paged.last_logits[1])
    seg = paged.cache["segments"][0]
    for name in ("k", "v"):       # tokens 10 and 11 of each row: page 2
        assert torch.equal(seg[name][:, p1.table[2], :2],
                           seg[name][:, p2.table[2], :2])
    shared = [seg[n][:, list(p1.table[:2])].clone() for n in ("k", "v")]
    paged = rollout.rollout_rows_chunk(params, cfg, paged, prng.PRNGKey(2),
                                       n_steps=5)
    assert paged.cache["pos"].tolist()[:2] == [17, 17]
    for n, before in zip(("k", "v"), shared):
        assert torch.equal(seg[n][:, list(p1.table[:2])], before)


def test_radix_hit_at_micro_widths_is_exact_to_rounding(micro):
    """At micro widths the two-row continuation's attention products take
    torch's small-product CPU loop (see above): the radix hit's logits
    equal the fresh prefill's within 1e-5, the suite's fp32 parity
    tolerance, not bit for bit; the shared pages stay byte-identical."""
    cfg, params = _micro(tsmoke), micro[1]
    paged, p1, _ = _radix_hit(cfg, params)
    err = (paged.last_logits[0] - paged.last_logits[1]).abs().max().item()
    assert err < 1e-5
    seg = paged.cache["segments"][0]
    shared = seg["k"][:, list(p1.table[:2])].clone()
    rollout.rollout_rows_chunk(params, cfg, paged, prng.PRNGKey(2),
                               n_steps=5)
    assert torch.equal(seg["k"][:, list(p1.table[:2])], shared)
