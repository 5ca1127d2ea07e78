"""The port's generator pool (``repro_torch.core.genpool``) and chunk
scheduler (``repro_torch.rl.scheduler``): the scheduler's early exit,
priority harvest and parking, on both packages' schedulers; adaptive
staleness trajectories equal to the JAX package's on the same
observations; pools of 1 and 2 keeping order and bound; a straggler that
delays but never drops; complete-batch mode equal to chunked mode; and
an engine-mode pool on paged KV equal to the dense one.  After
``tests/test_genpool.py``.  Every threaded run passes a ``timeout``."""
import numpy as np
import pytest

from repro.core.genpool import AdaptiveStalenessController as JAdaptive
from repro.core.offpolicy import PartialRolloutCache as JCache
from repro.rl.scheduler import RolloutJob as JJob
from repro.rl.scheduler import RolloutScheduler as JScheduler
from repro_torch import serve_partial_rollouts
from repro_torch.configs.llama_paper import smoke
from repro_torch.core import (AdaptiveStalenessController, CommType,
                              CommunicationChannel, ExecutorController,
                              GeneratorExecutor, PartialRolloutCache,
                              PoolConfig, RewardExecutor,
                              SyncExecutorController, TrainerExecutor,
                              WeightsCommunicationChannel,
                              build_generator_pool, spawn_actor)
from repro_torch.core.genpool import WorkAssignment
from repro_torch.rl.data import ArithmeticTasks
from repro_torch.rl.scheduler import RolloutJob, RolloutScheduler

TIMEOUT = 60.0
KEYS = ("loss", "grad_norm", "mean_ratio", "mean_reward")


def micro_cfg():
    return smoke().replace(n_layers=1, d_model=32, n_heads=2, n_kv_heads=2,
                           head_dim=16, d_ff=64, vocab=64)


def build_pool(n_gens=2, staleness=1, max_steps=8, adaptive=None, pool=None,
               lr=5e-2, cfg=None, prompt_len=8, n_prompts=4, chunk=2):
    """Full pipeline with ``n_gens`` generator workers, one weight channel
    each, one shared data pipeline."""
    cfg = cfg or micro_cfg()
    rew = RewardExecutor(n_per_prompt=2)
    trn = TrainerExecutor(cfg, lr=lr, seed=0, device="cpu")
    gens, chans = build_generator_pool(
        cfg, trn,
        lambda g: ArithmeticTasks(prompt_len=prompt_len, max_operand=4,
                                  ops="+", seed=100 + g),
        n_generators=n_gens, seed=100, n_prompts=n_prompts, n_per_prompt=2,
        max_new=4, temperature=1.0, chunk=chunk, device="cpu")
    chans += [CommunicationChannel("completions", gens[0], rew,
                                   CommType.GATHER),
              CommunicationChannel("completions_with_reward", rew, trn,
                                   CommType.SCATTER)]
    return ExecutorController(gens + [rew, trn], chans, max_steps=max_steps,
                              mode="async", staleness=staleness,
                              timeout=TIMEOUT, adaptive=adaptive, pool=pool)


def rows(history):
    return [[h[k] for k in KEYS] for h in history]


# ------------------------------------------------- multi-generator fan-in --

@pytest.mark.parametrize("n_gens", [1, 2])
def test_pool_interleaves_batches_and_keeps_schedule(n_gens):
    """Worker ``i`` produces batches ``i, i+N, ...``; the consumer
    reorders the fan-in so training happens in batch order, on the exact
    bounded-staleness weight schedule."""
    s = 1
    ctl = build_pool(n_gens=n_gens, staleness=s, max_steps=4 * n_gens)
    hist = ctl.run()
    n = 4 * n_gens
    assert [h["step"] for h in hist] == list(range(n))
    assert [h["weight_version"] for h in hist] == \
        [max(0, i - s) for i in range(n)]
    names = ["generator"] if n_gens == 1 else \
        [f"generator{g}" for g in range(n_gens)]
    assert [h["generator"] for h in hist] == \
        [names[i % n_gens] for i in range(n)]
    assert max(ctl.staleness_hist) <= s
    assert all(g.call("pinned_count") == 0 for g in ctl.generators)


def test_pool_of_one_matches_sequential():
    a, b = build_pool(n_gens=1, max_steps=5), build_pool(n_gens=1,
                                                         max_steps=5)
    assert rows(a.run()) == rows(b.run_sequential())


def test_straggler_worker_delays_but_never_drops():
    """Per-chunk latency on half the batches changes wall-clock only:
    every batch arrives, in order, on schedule and within the bound."""
    s = 2
    delays = []

    def delay(b, c):
        delays.append((b, c))
        return 0.03 if b % 2 == 0 else 0.0
    ctl = build_pool(n_gens=2, staleness=s, max_steps=8,
                     pool=PoolConfig(chunk_delay=delay))
    hist = ctl.run()
    assert [h["step"] for h in hist] == list(range(8))
    assert [h["weight_version"] for h in hist] == \
        [max(0, n - s) for n in range(8)]
    assert max(ctl.staleness_hist) <= s
    assert {b for b, _ in delays} == set(range(8))
    # 4 slow batches x 2 chunks x 30 ms, all counted as worker busy time
    assert ctl.stats["gen_worker_s"] >= 0.03 * 8


def test_complete_batch_mode_matches_chunked():
    """chunk_scheduling=False (one gen.step a batch) trains on bit for
    bit the batches the chunk-scheduled path trains on."""
    a = build_pool(n_gens=2, max_steps=6,
                   pool=PoolConfig(chunk_scheduling=False))
    b = build_pool(n_gens=2, max_steps=6)
    assert rows(a.run()) == rows(b.run())


def test_engine_pool_paged_equals_dense():
    """The continuous-batching pool on paged KV trains on the batches the
    dense one does.  With lr 0 every version's params are equal, and with
    a bound past the run every admission gate is open from the start, so
    each worker's rounds -- and so its keys -- do not depend on timing.
    Straggler budgets keep rows at divergent cursors."""
    cfg = smoke().replace(n_layers=2, vocab=64)
    out = {}
    for layout in ("dense", "paged"):
        ctl = build_pool(n_gens=2, staleness=8, max_steps=6, lr=0.0,
                         cfg=cfg, prompt_len=16, n_prompts=2, chunk=2,
                         pool=PoolConfig(engine=True, kv_layout=layout,
                                         kv_page_size=4, max_inflight=3,
                                         engine_row_budgets=[1, 2, 2, 1]))
        hist = ctl.run()
        stats = [g.call("engine_stats") for g in ctl.generators]
        assert [h["step"] for h in hist] == list(range(6))
        assert all(h["sample_staleness"] <= 8 for h in hist)
        assert all(st["staleness_violations"] == 0 and st["running"] == 0
                   and st["waiting"] == 0 and st["batches_emitted"] == 3
                   for st in stats)
        if layout == "paged":
            assert sum(st["radix_hits"] for st in stats) > 0
            for g in ctl.generators:                 # aborted: no page held
                assert g.transport.executor._engine.page_pool \
                    .pages_in_use == 0
        out[layout] = rows(hist)
    assert out["paged"] == out["dense"]


def test_attach_and_detach_generators_mid_run():
    """A worker attached mid-run gets the latest weights replayed and a
    share of the unstarted batches; a detached one finishes what it
    admitted and takes no more.  Order and bound hold throughout."""
    cfg = micro_cfg()
    box = {}

    class ResizingTrainer(TrainerExecutor):
        def step(self):
            ctl = box["ctl"]
            if self.curr_step == 2:
                box["new"] = ctl.attach_generator(spawn_actor(
                    GeneratorExecutor, cfg,
                    ArithmeticTasks(prompt_len=8, max_operand=4, ops="+",
                                    seed=7),
                    n_prompts=4, n_per_prompt=2, max_new=4, chunk=2,
                    seed=7, name="extra", device="cpu"))
            if self.curr_step == 4:
                box["moved"] = ctl.detach_generator("generator1")
            return super().step()

    rew = RewardExecutor(n_per_prompt=2)
    trn = ResizingTrainer(cfg, lr=5e-2, seed=0, device="cpu")
    gens, chans = build_generator_pool(
        cfg, trn, lambda g: ArithmeticTasks(prompt_len=8, max_operand=4,
                                            ops="+", seed=100 + g),
        n_generators=2, seed=100, n_prompts=4, n_per_prompt=2, max_new=4,
        chunk=2, device="cpu")
    chans += [CommunicationChannel("completions", gens[0], rew,
                                   CommType.GATHER),
              CommunicationChannel("completions_with_reward", rew, trn,
                                   CommType.SCATTER)]
    ctl = box["ctl"] = ExecutorController(
        gens + [rew, trn], chans, max_steps=12, mode="async", staleness=1,
        timeout=TIMEOUT)
    hist = ctl.run()
    assert [h["step"] for h in hist] == list(range(12))
    assert [h["weight_version"] for h in hist] == \
        [max(0, n - 1) for n in range(12)]
    producers = [h["generator"] for h in hist]
    assert "extra" in producers and box["new"].name == "extra"
    assert box["new"].call("weight_version") >= 2
    assert box["moved"] and "generator1" not in producers[-len(
        box["moved"]):]
    assert all(n not in box["moved"] for n, p in enumerate(producers)
               if p == "generator1")


def test_serve_partial_rollouts_runs_on_the_cpu(capsys):
    """The example: serving harvests the short requests first; the pool
    of three with a straggler trains in order under the adaptive
    bound."""
    order, ctl = serve_partial_rollouts.main(["--device", "cpu",
                                              "--steps", "6"])
    assert order == [0, 2, 1]
    assert [h["step"] for h in ctl.history] == list(range(6))
    assert all(h["sample_staleness"] <= h["staleness_bound"] <= 3
               for h in ctl.history)
    assert len(ctl._bounds.bound_history) == 6
    assert "adaptive bound trajectory" in capsys.readouterr().out


def test_pool_without_a_trainer_builds_no_weight_channel():
    """The launcher spawns its trainer beside the pool and wires the
    weight channels once both are up."""
    gens, chans = build_generator_pool(
        micro_cfg(), None,
        lambda g: ArithmeticTasks(prompt_len=8, max_operand=4, ops="+",
                                  seed=g),
        n_generators=2, n_prompts=4, n_per_prompt=2, max_new=4,
        device="cpu")
    assert [g.name for g in gens] == ["generator0", "generator1"]
    assert chans == []


def test_duplicate_generator_names_rejected():
    cfg = micro_cfg()
    tasks = ArithmeticTasks(prompt_len=8, max_operand=4, ops="+", seed=0)
    gens = [GeneratorExecutor(cfg, tasks, n_prompts=4, n_per_prompt=2,
                              max_new=4, seed=g, device="cpu")
            for g in range(2)]
    trn = TrainerExecutor(cfg, lr=5e-2, seed=0, device="cpu")
    rew = RewardExecutor(n_per_prompt=2)
    with pytest.raises(ValueError, match="unique"):
        ExecutorController(
            gens + [rew, trn],
            [WeightsCommunicationChannel("policy_model", trn, g)
             for g in gens], max_steps=1, mode="async")


def test_sequential_run_rejects_pool():
    ctl = build_pool(n_gens=2, max_steps=1)
    with pytest.raises(ValueError, match="pool"):
        SyncExecutorController.run(ctl)
    with pytest.raises(ValueError, match="pool"):
        ctl.run_sequential()


def test_pool_config_rejects_ignored_knobs():
    with pytest.raises(ValueError, match="chunk_scheduling"):
        PoolConfig(chunk_scheduling=False, chunk_delay=lambda b, c: 0.0)
    with pytest.raises(ValueError, match="engine"):
        PoolConfig(engine=True, chunk_delay=lambda b, c: 0.0)


def test_work_assignment_drain_and_rebalance():
    asn = WorkAssignment(["a", "b"], 0, 8)
    assert asn.next_for("a") == 0 and asn.next_for("b") == 1
    assert asn.start("a", 0) and not asn.start("b", 0)
    assert asn.drain_worker("b") == [1, 3, 5, 7]
    assert asn.next_for("b") is None and asn.is_retired("b")
    assert asn.idle("b") and not asn.all_done()
    asn.add_worker("c")
    asn.rebalance()
    assert [asn.next_for(k) for k in ("a", "c")] == [1, 2]
    asn.finish("a", 0)
    with pytest.raises(RuntimeError, match="no other workers"):
        WorkAssignment(["x"], 0, 2).drain_worker("x")


# ----------------------------------------------------- adaptive staleness --

def test_adaptive_widens_on_starvation_and_narrows_back():
    ad = AdaptiveStalenessController(bound=1, min_bound=1, max_bound=3,
                                     window=4)
    for _ in range(8):
        ad.observe(queue_depth=0, train_idle_s=0.5)
    assert ad.bound() == 3
    for _ in range(8):
        ad.observe(queue_depth=2, train_idle_s=0.0)
    assert ad.bound() == 1
    ad.on_pool_resize(3)                    # the window restarts
    for _ in range(3):
        ad.observe(queue_depth=0, train_idle_s=0.5)
    assert ad.bound() == 1


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_adaptive_trajectory_equals_jax(seed):
    """The same observation sequence moves both packages' bounds
    identically, step by step."""
    rng = np.random.default_rng(seed)
    kw = dict(bound=2, min_bound=1, max_bound=4, window=3)
    ta, ja = AdaptiveStalenessController(**kw), JAdaptive(**kw)
    for _ in range(200):
        depth = int(rng.integers(0, 3)) if rng.random() < 0.5 else 0
        idle = float(rng.choice([0.0, 5e-4, 2e-3, 0.5]))
        ta.observe(queue_depth=depth, train_idle_s=idle)
        ja.observe(queue_depth=depth, train_idle_s=idle)
    assert ta.bound_history == ja.bound_history
    assert len(set(ta.bound_history)) > 1
    with pytest.raises(ValueError):
        AdaptiveStalenessController(min_bound=3, max_bound=2)


# ------------------------------------------------ RolloutScheduler (unit) --

class _FakeDone:
    def __init__(self, v):
        self.v = v

    def all(self):
        return self.v

    def __bool__(self):
        return self.v


class _FakeState:
    def __init__(self, done=False):
        self.done = _FakeDone(done)


class _FakeExecutor:
    """Chunk-stepping double: finishes job ``i`` after ``lengths[i]``
    chunks."""

    def __init__(self, lengths):
        self.lengths = lengths
        self.emitted = []
        self.released = []

    def advance_chunk(self, job, state):
        job.chunks_done += 1
        return _FakeState(done=job.chunks_done >= self.lengths[
            job.batch_index])

    def emit_batch(self, job, state):
        self.emitted.append(job.batch_index)
        return {"batch_index": job.batch_index}

    def release_job(self, job):
        self.released.append(job.batch_index)


PACKAGES = {"torch": (RolloutScheduler, PartialRolloutCache, RolloutJob),
            "jax": (JScheduler, JCache, JJob)}


def _job(job_cls, i, n_chunks=8):
    return job_cls(batch_index=i, params=None, weight_version=0, key=None,
                   meta={}, max_new=n_chunks, chunk=1, n_chunks=n_chunks)


@pytest.mark.parametrize("pkg", ["torch", "jax"])
def test_scheduler_early_exit_harvests_before_budget(pkg):
    sched_cls, cache_cls, job_cls = PACKAGES[pkg]
    ex = _FakeExecutor(lengths={0: 2})
    sched = sched_cls(ex, cache_cls())
    sched.admit(_job(job_cls, 0), _FakeState())
    steps, job = 0, None
    while sched.pending():
        done = sched.step()
        steps += 1
        if done:
            job, _ = done
    assert steps == 2 and ex.emitted == [0] and job.chunks_done == 2
    late = sched_cls(ex, cache_cls(), early_exit=False)
    late.admit(_job(job_cls, 0), _FakeState())
    assert len(list(late.drain())) == 1
    assert ex.emitted == [0, 0]


@pytest.mark.parametrize("pkg", ["torch", "jax"])
def test_scheduler_priority_orders_harvest(pkg):
    """Default priority (batch index) drains in index order even when a
    later-admitted job is shorter; a custom priority can invert that."""
    sched_cls, cache_cls, job_cls = PACKAGES[pkg]
    ex = _FakeExecutor(lengths={0: 3, 1: 1})
    sched = sched_cls(ex, cache_cls())
    sched.admit(_job(job_cls, 0), _FakeState())
    sched.admit(_job(job_cls, 1), _FakeState())
    list(sched.drain())
    assert ex.emitted == [0, 1]
    ex2 = _FakeExecutor(lengths={0: 3, 1: 1})
    sched2 = sched_cls(ex2, cache_cls(),
                       priority=lambda job, state: job.chunks_done)
    sched2.admit(_job(job_cls, 0), _FakeState())
    sched2.admit(_job(job_cls, 1), _FakeState())
    sched2.step()                            # advances 0 (tie -> FIFO)
    sched2.step()                            # advances 1 -> finishes first
    assert ex2.emitted == [1]


@pytest.mark.parametrize("pkg", ["torch", "jax"])
def test_scheduler_parks_states_in_cache(pkg):
    sched_cls, cache_cls, job_cls = PACKAGES[pkg]
    ex = _FakeExecutor(lengths={0: 3, 1: 3})
    cache = cache_cls()
    sched = sched_cls(ex, cache)
    sched.admit(_job(job_cls, 0), _FakeState())
    sched.admit(_job(job_cls, 1), _FakeState())
    assert len(cache) == 2
    assert sched.step() is None and len(cache) == 2
    assert sorted(j.batch_index for j in sched.inflight()) == [0, 1]
    list(sched.drain())
    assert len(cache) == 0 and sorted(ex.emitted) == [0, 1]


@pytest.mark.parametrize("pkg", ["torch", "jax"])
def test_scheduler_clear_and_abandoned_drain_release(pkg):
    """Jobs dropped without emitting leave the cache and release their
    executor-side pins, on ``clear`` and on an abandoned ``drain``."""
    sched_cls, cache_cls, job_cls = PACKAGES[pkg]
    ex = _FakeExecutor(lengths={0: 1, 1: 5, 2: 5})
    cache = cache_cls()
    sched = sched_cls(ex, cache)
    for i in range(3):
        sched.admit(_job(job_cls, i), _FakeState())
    for job, _ in sched.drain():
        break                                # abandon after the first
    assert ex.emitted == [0] and sorted(ex.released) == [1, 2]
    assert len(cache) == 0 and sched.pending() == 0


@pytest.mark.parametrize("pkg", ["torch", "jax"])
def test_straggler_injection_in_scheduler(pkg):
    sched_cls, cache_cls, job_cls = PACKAGES[pkg]
    ex = _FakeExecutor(lengths={0: 2, 1: 2})
    delays = []
    sched = sched_cls(ex, cache_cls(),
                      chunk_delay=lambda b, c: delays.append((b, c)) or 0.0)
    sched.admit(_job(job_cls, 0), _FakeState())
    sched.admit(_job(job_cls, 1), _FakeState())
    list(sched.drain())
    assert sorted(ex.emitted) == [0, 1]
    assert (0, 0) in delays and (1, 0) in delays


def test_pinned_jobs_release_on_emit_and_clear():
    """The generator's pinned-params hooks: a pinned job decodes from its
    pin, emit releases it, and ``release_job`` frees an abandoned one;
    ``repin_job`` moves a job onto the current weights."""
    from repro_torch.core.executor import PinnedParams
    from repro_torch.models import init_params
    cfg = micro_cfg()
    gen = GeneratorExecutor(cfg, ArithmeticTasks(prompt_len=8), n_prompts=2,
                            n_per_prompt=1, max_new=4, chunk=2,
                            device="cpu")
    p0 = init_params(cfg, seed=0, device="cpu")
    gen.set_weights(p0, version=0)
    job, state = gen.begin_batch_pinned(0)
    assert isinstance(job.params, PinnedParams) and gen.pinned_count() == 1
    job2, state2 = gen.begin_batch_pinned(1)
    gen.set_weights(init_params(cfg, seed=1, device="cpu"), version=1)
    for _ in range(job.n_chunks):
        job, state = gen.advance_chunk_rt(job, state)
    snap = gen.emit_batch_snapshot(job, state, ["completions"])
    assert snap["completions"]["weight_version"] == 0
    assert gen.pinned_count() == 1
    gen.repin_job(job2)
    assert job2.weight_version == 1 and gen.pinned_count() == 1
    gen.release_job(job2)
    assert gen.pinned_count() == 0


def test_pool_config_fields_equal_jax():
    """``PoolConfig`` has the reference's fields and defaults, in order,
    ``engine_round_delay_s`` included."""
    import dataclasses
    from repro.core.genpool import PoolConfig as JPoolConfig
    assert [(f.name, f.default) for f in dataclasses.fields(PoolConfig)] \
        == [(f.name, f.default) for f in dataclasses.fields(JPoolConfig)]


def test_engine_pool_round_delay_and_layout_from_env(monkeypatch):
    """An engine pool with ``kv_layout=""`` runs the layout
    ``REPRO_KV_LAYOUT`` names, and ``engine_round_delay_s`` reaches every
    worker's engine, which sleeps it once per decode round; the paced
    paged run trains on the batches of the unpaced dense one (lr 0 and a
    bound past the run, as in ``test_engine_pool_paged_equals_dense``)."""
    import time
    cfg = smoke().replace(n_layers=2, vocab=64)
    out = {}
    for layout, delay in (("", 0.05), ("dense", 0.0)):
        monkeypatch.setenv("REPRO_KV_LAYOUT", "paged")
        ctl = build_pool(n_gens=2, staleness=8, max_steps=4, lr=0.0,
                         cfg=cfg, prompt_len=16, n_prompts=2, chunk=2,
                         pool=PoolConfig(engine=True, kv_layout=layout,
                                         kv_page_size=4, max_inflight=3,
                                         engine_round_delay_s=delay))
        t0 = time.monotonic()
        hist = ctl.run()
        wall = time.monotonic() - t0
        engines = [g.transport.executor._engine for g in ctl.generators]
        assert [e.kv_layout for e in engines] == [layout or "paged"] * 2
        assert [e.round_delay_s for e in engines] == [delay] * 2
        # each worker decoded at least 2 rounds (max_new 4, chunk 2)
        assert wall >= 2 * delay
        out[layout] = rows(hist)
    assert out[""] == out["dense"]
