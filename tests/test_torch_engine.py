"""The port's continuous-batching engine against the JAX package's: the
same seeds and converted params through ``engine_configure`` /
``engine_enqueue`` / ``engine_round`` emit the same batches in both
layouts; and, within the port, the emitted batches feed the reference
and reward executors, abort leaks nothing, and a small arena turns into
admission backpressure.

Inputs are made with numpy from a seed; JAX params cross through
``convert``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.llama_paper import smoke
from repro.core.executor import GeneratorExecutor as JGenerator
from repro.models import init_params as jinit
from repro.rl.data import ArithmeticTasks as JTasks
from repro_torch import convert
from repro_torch.configs.llama_paper import smoke as tsmoke
from repro_torch.core.executor import GeneratorExecutor, \
    RefPolicyExecutor, RewardExecutor
from repro_torch.kernels import dispatch
from repro_torch.rl.data import ArithmeticTasks


def _micro(mk):
    return mk().replace(n_layers=1, d_model=32, n_heads=2, n_kv_heads=2,
                        head_dim=16, d_ff=64, vocab=64)


# name -> (config maker, generator kwargs, engine kwargs, batches)
SETUPS = {
    # the reference suite's engine setup (tests/test_engine.py)
    "micro": (_micro, dict(n_prompts=2, n_per_prompt=2, max_new=4, chunk=2),
              dict(max_running_rows=8, kv_page_size=4), 2),
    # llama31-smoke with stragglers and a pool smaller than the work, so
    # rows are admitted mid-decode at divergent cursors
    "smoke": (lambda mk: mk(), dict(n_prompts=2, n_per_prompt=3, max_new=6,
                                    chunk=2),
              dict(max_running_rows=5, kv_page_size=4,
                   row_budgets=[1, 3, 2]), 3),
}


@pytest.fixture(scope="module")
def params():
    out = {}
    for name, (mk, *_) in SETUPS.items():
        jp = jinit(mk(smoke), jax.random.PRNGKey(0), jnp.float32)
        out[name] = jp, convert.from_jax_numpy(jax.device_get(jp),
                                               device="cpu")
    return out


def _drain(gen, n_batches, bound=1, max_rounds=80):
    for b in range(n_batches):
        gen.engine_enqueue(b, bound=bound)
    items, rounds = [], 0
    while len(items) < n_batches and rounds < max_rounds:
        items += gen.engine_round(["completions"])
        rounds += 1
    assert len(items) == n_batches, f"{len(items)} batches in {rounds} rounds"
    return [it["snapshot"]["completions"] for it in items], rounds


def _generator(name, params, layout, torch_side):
    mk, gkw, ekw, _ = SETUPS[name]
    if torch_side:
        gen = GeneratorExecutor(mk(tsmoke), ArithmeticTasks(
            prompt_len=8, max_operand=9, ops="+", seed=0), seed=0,
            device="cpu", **gkw)
        gen.set_weights(params[name][1], version=0)
    else:
        gen = JGenerator(mk(smoke), JTasks(prompt_len=8, max_operand=9,
                                           ops="+", seed=0), seed=0, **gkw)
        gen.set_weights(params[name][0], version=0)
    gen.engine_configure(kv_layout=layout, **ekw)
    return gen


@pytest.mark.parametrize("layout", ["dense", "paged"])
@pytest.mark.parametrize("name", ["micro", "smoke"])
def test_engine_matches_jax(params, name, layout):
    """Emitted batches equal the JAX engine's: tokens, mask, row versions
    and group advantages exactly, behaviour log-probs within 1e-5 (fp32);
    the engines count the same admissions, harvests and radix hits."""
    n = SETUPS[name][3]
    touts, _ = _drain(_generator(name, params, layout, True), n)
    jgen = _generator(name, params, layout, False)
    jouts, _ = _drain(jgen, n)
    for t, j in zip(touts, jouts):
        for key in ("tokens", "mask"):
            assert np.array_equal(t[key].numpy(), np.asarray(j[key])), key
        for key in ("row_versions", "group_advantages", "group_rewards"):
            assert np.array_equal(t[key], np.asarray(j[key])), key
        err = np.abs(t["behavior_logp"].numpy()
                     - np.asarray(j["behavior_logp"])).max()
        assert err < 1e-5
        assert t["prompt_len"] == j["prompt_len"]
        assert t["answers"] == j["answers"]
        assert t["weight_version"] == j["weight_version"]


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_engine_stats_match_jax(params, layout):
    stats = []
    for torch_side in (True, False):
        gen = _generator("smoke", params, layout, torch_side)
        _drain(gen, 3)
        stats.append(gen.engine_stats())
    t, j = stats
    keys = ("rows_enqueued", "rows_admitted", "rows_harvested",
            "batches_emitted", "staleness_violations",
            "admission_backpressure", "radix_hits", "radix_misses",
            "prefix_tokens_reused", "waiting", "running", "pages_in_use")
    assert {k: t.get(k) for k in keys} == {k: j.get(k) for k in keys}
    if layout == "paged":
        assert t["radix_hits"] > 0


def test_engine_decodes_through_paged_attention(params, monkeypatch):
    """Every decode step of every layer calls ``dispatch.paged_attention``
    once for the whole pool: n_layers x chunk calls a decode round."""
    calls = []
    real = dispatch.paged_attention

    def counted(*a, **kw):
        calls.append(a[0].shape[0])
        return real(*a, **kw)
    monkeypatch.setattr(dispatch, "paged_attention", counted)
    gen = _generator("smoke", params, "paged", True)
    decode_rounds = []
    real_round = gen._engine.round

    def round_():
        decode_rounds.append(bool(gen._engine.tickets or gen._engine.waiting))
        return real_round()
    gen._engine.round = round_
    _drain(gen, 3)
    cfg = gen.cfg
    assert len(calls) == cfg.n_layers * gen.chunk * sum(decode_rounds)
    assert set(calls) == {5}                  # the whole pool, every call


def test_engine_batches_feed_reference_and_reward(params):
    """The emitted batch goes through RefPolicyExecutor and RewardExecutor
    unchanged: at T = 1 the behaviour log-probs equal the reference's
    teacher-forced ones within 1e-4 (the reference suite's tolerance), and
    the reward's advantages equal the engine's group-local ones."""
    for layout in ("dense", "paged"):
        gen = _generator("smoke", params, layout, True)
        outs, _ = _drain(gen, 3)
        ref = RefPolicyExecutor(gen.cfg)
        ref.set_weights(params["smoke"][1])
        rew = RewardExecutor(n_per_prompt=3)
        for out in outs:
            ref.put_input("completions", out)
            scored = ref.step()
            m = out["mask"]
            assert m.sum() > 0
            err = ((scored["behavior_logp"] - scored["ref_logp"]) * m).abs()
            assert err.max().item() < 1e-4
            rew.put_input("completions_with_ref", scored)
            adv = rew.step()["advantages"]
            want = torch.as_tensor(out["group_advantages"]).float()[:, None]
            assert torch.equal(adv, want * m)


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_engine_abort_mid_decode_releases_everything(params, layout):
    gen = _generator("micro", params, layout, True)
    gen.engine_enqueue(0, bound=0)
    gen.engine_round(["completions"])          # one round: rows mid-decode
    eng = gen._engine
    assert len(eng.cache) == 1 and eng.slots.free_count < 8
    if layout == "paged":
        assert eng.page_pool.pages_in_use > 0
    assert gen.engine_abort() == 4
    assert len(eng.cache) == 0 and not eng.tickets and not eng.waiting
    assert eng.slots.free_count == 8 and eng.ledger.open_groups == 0
    assert gen.engine_inflight() == []
    if layout == "paged":
        eng.page_pool.assert_no_leaks()
        assert len(eng.radix) == 0


def test_engine_paged_small_arena_backpressures_and_completes(params):
    """An arena of 5 pages holds one row of 3 blocks (prompt 8 + 4 new at
    page 4) at a time plus prefixes: admissions wait for harvests, the
    run completes every row, and abort leaves no page in use."""
    gen = _generator("micro", params, "paged", True)
    gen.engine_configure(max_running_rows=8, kv_layout="paged",
                         kv_page_size=4, kv_pages=5)
    outs, _ = _drain(gen, 1, bound=2, max_rounds=120)
    st = gen.engine_stats()
    assert st["rows_harvested"] == 4 and st["admission_backpressure"] > 0
    assert st["waiting"] == 0 and st["running"] == 0
    assert outs[0]["tokens"].shape == (4, 12)
    gen.engine_abort()
    assert gen.engine_stats()["pages_in_use"] == 0


# ------------------------------------- the reference's knobs and ledger API --

@pytest.mark.parametrize("env_layout", ["paged", "dense"])
def test_kv_layout_defers_to_the_environment_as_jax(params, monkeypatch,
                                                    env_layout):
    """``kv_layout=""`` reads ``REPRO_KV_LAYOUT`` in both packages, so
    under the variable both engines run the same layout and emit the same
    batches."""
    monkeypatch.setenv("REPRO_KV_LAYOUT", env_layout)
    gens = [_generator("micro", params, "", side) for side in (True, False)]
    assert [g._engine.kv_layout for g in gens] == [env_layout] * 2
    assert [g._engine.page_pool is not None for g in gens] == \
        [env_layout == "paged"] * 2
    touts, _ = _drain(gens[0], 2)
    jouts, _ = _drain(gens[1], 2)
    for t, j in zip(touts, jouts):
        assert np.array_equal(t["tokens"].numpy(), np.asarray(j["tokens"]))
        assert np.array_equal(t["row_versions"], np.asarray(j["row_versions"]))


def test_round_delay_paces_every_decode_round_as_jax(params):
    """``engine_configure(round_delay_s=)`` sleeps once per decode round in
    both packages: the same rounds, each at least the delay, and the same
    batches in the same order."""
    import time
    delay, runs = 0.05, []
    for side in (True, False):
        gen = _generator("micro", params, "paged", side)
        gen.engine_configure(round_delay_s=delay, kv_layout="paged",
                             **SETUPS["micro"][2])
        assert gen._engine.round_delay_s == delay
        t0 = time.monotonic()
        outs, rounds = _drain(gen, 2)
        runs.append((outs, rounds, time.monotonic() - t0))
    (touts, trounds, tsec), (jouts, jrounds, _) = runs
    assert trounds == jrounds and tsec >= trounds * delay
    for t, j in zip(touts, jouts):
        assert np.array_equal(t["tokens"].numpy(), np.asarray(j["tokens"]))


def _ledger_script(GroupLedger, RowJob):
    """``tests/test_engine.py::
    test_ledger_invalidate_and_reopen_after_killed_worker``: the open and
    complete group counts after each step."""
    def ticket(g, s):
        return RowJob(batch_index=0, group=g, sib=s, prompt=None,
                      answer="0")
    row = {"tokens": np.asarray([2], np.int32), "logp": None, "version": 0,
           "prompt_len": 0, "queue_wait_s": 0.0}
    led = GroupLedger(2)
    log = []
    for g in range(2):
        led.open_group(0, g, "0")
    for g, s in ((0, 0), (0, 1), (1, 0)):
        log.append((led.add(ticket(g, s), row), led.open_groups,
                    led.complete_groups))
    log.append((led.invalidate_batch(0), led.open_groups,
                led.complete_groups))
    for g in range(2):
        led.open_group(0, g, "0")
    for g in range(2):
        for s in range(2):
            log.append((led.add(ticket(g, s), row), led.open_groups,
                        led.complete_groups))
    log.append((len(led.pop_batch(0, 2)), led.open_groups,
                led.complete_groups))
    return log


def test_ledger_complete_groups_equals_jax():
    from repro.rl.engine import GroupLedger as JLedger
    from repro.rl.scheduler import RowJob as JRowJob
    from repro_torch.rl.engine import GroupLedger
    from repro_torch.rl.scheduler import RowJob
    got = _ledger_script(GroupLedger, RowJob)
    assert got == _ledger_script(JLedger, JRowJob)
    assert got[2] == (False, 1, 1) and got[3] == (3, 0, 0)
