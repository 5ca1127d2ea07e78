"""The port's supervised recovery on the CPU, the second half of
``tests/test_supervision.py``'s twins (the first is
``tests/test_torch_supervision.py``): the frozen reference killed at a
consumer boundary and respawned from its version-0 seed, bit for bit
its no-fault run and within 1e-4 of the JAX package's no-fault run;
runtime attach and detach under a supervisor; a paged engine worker
killed and re-admitted through the radix cache, once with a batch in
flight; and, after
``tests/test_obs.py``, the recovery span on the exported timeline.

Every threaded run passes a ``timeout``; the bit-for-bit cases run torch
on one CPU thread in every process."""
import threading
import time

import jax
import jax.numpy as jnp
import pytest
import torch

from repro_torch import convert
from repro_torch.core import (CommType, CommunicationChannel,
                              ExecutorController, FaultPlan,
                              GeneratorExecutor, PoolConfig,
                              RefPolicyExecutor, RewardExecutor, Supervisor,
                              TrainerExecutor, WeightsCommunicationChannel,
                              build_generator_pool, close_all_actors,
                              spawn_actor)
from repro_torch.obs import trace as obs_trace
from repro_torch.obs.__main__ import summarize
from repro_torch.rl.data import ArithmeticTasks
from repro_torch.train.optimizer import adam_init
from repro_torch.train.trainstep import TrainState

from test_torch_supervision import (KEYS, TIMEOUT, build_supervised,
                                    micro_cfg, rows)


@pytest.fixture(autouse=True)
def _reap_actors():
    yield
    close_all_actors()


@pytest.fixture
def one_thread(monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(before)


class RecordingRef(RefPolicyExecutor):
    """The frozen reference, recording every weight delivery's version."""

    def __init__(self, cfg, name="ref"):
        super().__init__(cfg, name=name)
        self.delivered = []

    def set_weights(self, params, version=None):
        self.delivered.append(version)
        super().set_weights(params, version)


class FromJaxTrainer(TrainerExecutor):
    """The port's trainer started from the JAX package's init."""

    def __init__(self, cfg, jparams, **kw):
        super().__init__(cfg, device="cpu", **kw)
        self._jparams = jparams

    def init(self):
        params = convert.from_jax_numpy(self._jparams, device="cpu")
        self.state = TrainState(params, adam_init(params))
        self.set_output("policy_model", params)


def _ref_pipeline(chaos=None, max_steps=5, trainer=None):
    """The launcher's ``--kl-coef`` wiring: the frozen reference scored
    between generator and reward, hosted in its own process."""
    cfg = micro_cfg()
    rew = RewardExecutor(n_per_prompt=2)
    trn = trainer or TrainerExecutor(cfg, lr=5e-2, seed=0, kl_coef=0.1,
                                     device="cpu")
    gens, chans = build_generator_pool(
        cfg, trn,
        lambda g: ArithmeticTasks(prompt_len=8, max_operand=4, ops="+",
                                  seed=100 + g),
        n_generators=1, seed=100, n_prompts=4, n_per_prompt=2,
        max_new=4, temperature=1.0, chunk=2, device="cpu",
        transport="inproc")
    ref = spawn_actor(RecordingRef, cfg, transport="proc",
                      call_timeout=TIMEOUT)
    chans += [
        WeightsCommunicationChannel("policy_model", trn, ref),
        CommunicationChannel("completions", gens[0], ref,
                             CommType.BROADCAST),
        CommunicationChannel("completions_with_ref", ref, rew,
                             CommType.GATHER),
        CommunicationChannel("completions_with_reward", rew, trn,
                             CommType.SCATTER),
    ]
    return ExecutorController(gens + [ref, rew, trn], chans,
                              max_steps=max_steps, mode="async",
                              staleness=1, timeout=TIMEOUT,
                              supervise=Supervisor(chaos=chaos))


def test_reference_kill_recovers_bit_for_bit(one_thread):
    """Kill the frozen reference at a consumer boundary: the respawn
    replays its recorded version-0 seed (the fabric's latest would be
    wrong: the reference never moves), the batch retries, and the run
    trains bit for bit what the no-fault run trains."""
    chaos = FaultPlan.parse("kill:ref@consume=3")
    faulty = _ref_pipeline(chaos=chaos)
    hf = faulty.run()
    ref = faulty.executors["ref"]
    second_life = ref.call("delivered")
    clean = _ref_pipeline()
    hc = clean.run()
    assert chaos.unfired() == []
    respawns = faulty.supervisor.events("respawned")
    assert [e["actor"] for e in respawns] == ["ref"]
    assert respawns[0]["version"] == 0
    # the seed came first, so it is what the new reference keeps; the
    # schedule's later deliveries (versions 2 and 3) do not stick
    assert second_life == [0, 2, 3]
    assert [h["step"] for h in hf] == list(range(5))
    assert rows(hf) == rows(hc)


def test_reference_kill_tracks_the_jax_package(one_thread):
    """The reference-kill run against the JAX package's no-fault threaded
    run of the same pipeline from the same init: the same tokens, so the
    rewards and versions are equal, and the train metrics agree within
    1e-4 (``tests/test_torch_async_controller.py``'s tolerance)."""
    from repro.configs.llama_paper import smoke as jsmoke
    from repro.core import CommType as JCommType
    from repro.core import CommunicationChannel as JChannel
    from repro.core import ExecutorController as JController
    from repro.core import RefPolicyExecutor as JRef
    from repro.core import RewardExecutor as JReward
    from repro.core import TrainerExecutor as JTrainer
    from repro.core import WeightsCommunicationChannel as JWeights
    from repro.core import build_generator_pool as jbuild_pool
    from repro.rl.data import ArithmeticTasks as JTasks
    from repro.train.trainstep import init_train_state as jinit_state

    jcfg = jsmoke().replace(n_layers=1, d_model=32, n_heads=2, n_kv_heads=2,
                            head_dim=16, d_ff=64, vocab=64)
    jrew = JReward(n_per_prompt=2)
    jtrn = JTrainer(jcfg, lr=5e-2, seed=0, kl_coef=0.1)
    jgens, jchans = jbuild_pool(
        jcfg, jtrn,
        lambda g: JTasks(prompt_len=8, max_operand=4, ops="+",
                         seed=100 + g),
        n_generators=1, seed=100, n_prompts=4, n_per_prompt=2, max_new=4,
        temperature=1.0, chunk=2, transport="inproc")
    jref = JRef(jcfg)
    jchans += [
        JWeights("policy_model", jtrn, jref),
        JChannel("completions", jgens[0], jref, JCommType.BROADCAST),
        JChannel("completions_with_ref", jref, jrew, JCommType.GATHER),
        JChannel("completions_with_reward", jrew, jtrn, JCommType.SCATTER)]
    jh = JController(jgens + [jref, jrew, jtrn], jchans, max_steps=5,
                     mode="async", staleness=1, timeout=TIMEOUT).run()
    jparams = jax.device_get(
        jinit_state(jcfg, jax.random.PRNGKey(0), jnp.float32).params)
    chaos = FaultPlan.parse("kill:ref@consume=3")
    ctl = _ref_pipeline(chaos=chaos, trainer=FromJaxTrainer(
        micro_cfg(), jparams, lr=5e-2, seed=0, kl_coef=0.1))
    th = ctl.run()
    assert chaos.unfired() == []
    assert len(th) == len(jh) == 5
    for j, t in zip(jh, th):
        for k in ("step", "weight_version", "sample_staleness",
                  "mean_reward", "generator"):
            assert t[k] == j[k], (t["step"], k)
        for k in ("loss", "grad_norm", "mean_ratio", "mean_logp"):
            assert abs(t[k] - j[k]) <= 1e-4 * max(1.0, abs(j[k])), \
                (t["step"], k, t[k], j[k])


# ------------------------------------------------------ runtime elasticity --

class SlowTrainer(TrainerExecutor):
    """Stretches the run so mid-run membership changes land inside it."""

    def step(self):
        time.sleep(0.3)
        return super().step()


def test_attach_and_detach_generators_midrun():
    """Runtime grow and shrink on the supervision machinery: a pre-warmed
    socket hot spare attaches mid-run (weights replayed from the fabric,
    rebalanced into the round robin), then a founding member detaches;
    every batch completes on schedule."""
    ctl = build_supervised(n_gens=2, staleness=2, max_steps=12,
                           transport="inproc", trainer_cls=SlowTrainer)
    spare = spawn_actor(
        GeneratorExecutor, micro_cfg(),
        ArithmeticTasks(prompt_len=8, max_operand=4, ops="+", seed=107),
        seed=107, name="generator2", transport="socket", device="cpu",
        n_prompts=4, n_per_prompt=2, max_new=4, temperature=1.0, chunk=2,
        call_timeout=TIMEOUT)
    assert spare.call("ping") == "generator2"     # pre-warmed: child up
    failures = []

    def elastic():
        try:
            deadline = time.monotonic() + TIMEOUT
            while len(ctl.history) < 1 and time.monotonic() < deadline:
                time.sleep(0.02)
            ctl.attach_generator(spare)
            while len(ctl.history) < 7 and time.monotonic() < deadline:
                time.sleep(0.02)
            ctl.detach_generator("generator1")
        except BaseException as e:                # surfaced after join
            failures.append(e)

    helper = threading.Thread(target=elastic, name="elasticity")
    helper.start()
    try:
        hist = ctl.run()
    finally:
        helper.join(timeout=TIMEOUT)
    assert not helper.is_alive()
    assert failures == []
    assert [h["step"] for h in hist] == list(range(12))
    assert "generator2" in [h["generator"] for h in hist]
    assert ctl.supervisor.covers(spare)
    assert [e["n_workers"] for e in
            ctl.supervisor.events("pool-resized")] == [3, 2]
    assert max(ctl.staleness_hist) <= 2


# -------------------------------------------- paged engine re-admission --

def test_paged_engine_kill_respawns_with_radix_reuse():
    """Kill a proc-placed paged engine worker: the respawned engine
    starts from an empty arena and radix, and the re-admitted batches'
    siblings hit the republished prompt prefix instead of prefilling
    it again, while the per-row staleness contract holds."""
    cfg = micro_cfg()
    rew = RewardExecutor(n_per_prompt=2)
    trn = TrainerExecutor(cfg, lr=5e-2, seed=0, device="cpu")
    gens, chans = build_generator_pool(
        cfg, trn,
        lambda g: ArithmeticTasks(prompt_len=8, max_operand=4, ops="+",
                                  seed=100 + g),
        n_generators=2, seed=100, n_prompts=2, n_per_prompt=2,
        max_new=4, temperature=1.0, chunk=2, device="cpu", transport="proc",
        call_timeout=TIMEOUT)
    chans += [CommunicationChannel("completions", gens[0], rew,
                                   CommType.GATHER),
              CommunicationChannel("completions_with_reward", rew, trn,
                                   CommType.SCATTER)]
    chaos = FaultPlan.parse("kill:generator1@batch=3")
    ctl = ExecutorController(
        gens + [rew, trn], chans, max_steps=8, mode="async", staleness=2,
        timeout=TIMEOUT, supervise=Supervisor(chaos=chaos),
        pool=PoolConfig(engine=True, max_inflight=3, kv_layout="paged",
                        kv_page_size=4))
    hist = ctl.run()
    assert chaos.unfired() == []
    sup = ctl.supervisor
    assert [e["actor"] for e in sup.events("respawned")] == ["generator1"]
    readmitted = sup.events("readmitted")
    assert [e["actor"] for e in readmitted] == ["generator1"]
    assert [h["step"] for h in hist] == list(range(8))
    assert max(ctl.staleness_hist) <= 2
    for gen in gens:
        st = gen.call("engine_stats")
        assert st["kv_layout"] == "paged"
        assert st["staleness_violations"] == 0
        assert st["waiting"] == 0 and st["running"] == 0
        # every admitted prompt has a sibling: the prefix is computed at
        # most once a prompt, the rest hit the radix
        assert st["radix_hits"] > 0
        assert st["prefix_tokens_reused"] > 0


def test_engine_readmits_the_batch_in_flight():
    """At staleness 3 generator1 enqueues batch 1 and goes straight on to
    admit batch 3, where it is killed: the readmit hook re-enqueues batch
    1 into the respawned engine, whose rows -- siblings of one prompt --
    prefill it again through the radix cache, and batch 3 is retried."""
    cfg = micro_cfg()
    rew = RewardExecutor(n_per_prompt=2)
    trn = TrainerExecutor(cfg, lr=5e-2, seed=0, device="cpu")
    gens, chans = build_generator_pool(
        cfg, trn,
        lambda g: ArithmeticTasks(prompt_len=8, max_operand=4, ops="+",
                                  seed=100 + g),
        n_generators=2, seed=100, n_prompts=2, n_per_prompt=2,
        max_new=4, temperature=1.0, chunk=2, device="cpu", transport="proc",
        call_timeout=TIMEOUT)
    chans += [CommunicationChannel("completions", gens[0], rew,
                                   CommType.GATHER),
              CommunicationChannel("completions_with_reward", rew, trn,
                                   CommType.SCATTER)]
    chaos = FaultPlan.parse("kill:generator1@batch=3")
    ctl = ExecutorController(
        gens + [rew, trn], chans, max_steps=6, mode="async", staleness=3,
        timeout=TIMEOUT, supervise=Supervisor(chaos=chaos),
        pool=PoolConfig(engine=True, max_inflight=3, kv_layout="paged",
                        kv_page_size=4))
    hist = ctl.run()
    assert chaos.unfired() == []
    readmitted = ctl.supervisor.events("readmitted")
    assert [(e["actor"], e["batches"]) for e in readmitted] == \
        [("generator1", "[1]")]
    assert [h["step"] for h in hist] == list(range(6))
    assert [h["generator"] for h in hist] == \
        [f"generator{n % 2}" for n in range(6)]
    assert max(ctl.staleness_hist) <= 3
    st = gens[1].call("engine_stats")      # the respawned engine
    assert st["batches_emitted"] == 3      # 1 again, then 3 and 5
    assert st["radix_hits"] > 0 and st["staleness_violations"] == 0
    assert st["waiting"] == 0 and st["running"] == 0


# ------------------------------------------------------------ the timeline --

@pytest.fixture
def traced():
    prior = obs_trace.disable()
    t = obs_trace.enable("controller")
    try:
        yield t
    finally:
        obs_trace.disable()
        if prior is not None:
            obs_trace.enable(prior.proc)


def test_chaos_kill_produces_recovery_span_on_aligned_timeline(
        traced, tmp_path):
    """A traced chaos run over ``proc`` (pool of 2) exports valid Chrome
    JSON with spans from at least 3 processes on one timeline,
    per-subscriber publish spans, and a recovery span whose duration
    matches the supervisor's event log."""
    chaos = FaultPlan.parse("kill:generator1@batch=3")
    ctl = build_supervised(n_gens=2, staleness=1, max_steps=6,
                           transport="proc", chaos=chaos)
    hist = ctl.run()
    assert [h["step"] for h in hist] == list(range(6))
    respawns = ctl.supervisor.events("respawned")
    assert [e["actor"] for e in respawns] == ["generator1"]

    doc = obs_trace.export(str(tmp_path / "chaos.json"))
    assert obs_trace.validate_chrome(doc) == []
    evs = traced.events()
    span_procs = {e[0] for e in evs if e[2] == "X"}
    assert {"controller", "generator0", "generator1"} <= span_procs
    pubs = {e[3] for e in evs if e[4] == "fabric"}
    assert {"publish:generator0", "publish:generator1"} <= pubs
    # the recovery span matches the supervisor's event log (one epoch)
    recs = [e for e in evs if e[3] == "recover" and e[4] == "supervisor"]
    assert len(recs) == 1
    rec = recs[0]
    assert rec[7]["actor"] == "generator1"
    assert rec[6] == pytest.approx(respawns[0]["recovery_s"], rel=1e-6)
    assert rec[5] + rec[6] == pytest.approx(respawns[0]["t"], abs=0.05)
    # the lifecycle events are instants on the same timeline
    kinds = {e[3] for e in evs if e[4] == "supervisor" and e[2] == "i"}
    assert {"recovering", "respawned"} <= kinds
    s = summarize(evs)
    assert len(s["recoveries"]) == 1
    assert set(s["publish_by_subscriber"]) >= {"generator0", "generator1"}
    assert s["batch_latency"]["count"] == 6
    assert all(0.0 < h["t"] <= obs_trace.now() for h in hist)
    assert KEYS[0] in hist[0]
