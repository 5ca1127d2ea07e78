"""The port's supervision (``repro_torch.core.supervise``) on the CPU, after
``tests/test_supervision.py``: the fault grammar and its one-shot firing,
``WorkAssignment`` round robin, fail-over and grow/drain, the supervised
no-fault pool of 1 bit-equal to ``run_sequential``, a generator killed at
a batch boundary and mid-decode and respawned, the restart budget
exhausted and the pool degrading to the survivor, hang triage by ping,
the monitor thread noting a death, an shm respawn reaping its process
and segments, and the fabric's replay of the latest committed version;
beside them, parity with the JAX
package: the same faults from the same specs, and the same schedule and
recovery events under the same kill.  The reference kill, runtime
attach/detach, the paged engine's re-admission and the recovery span
are in ``tests/test_torch_supervision_recovery.py``.

Children pay a torch import each (about 2 s here), so spawns are few;
every threaded run passes a ``timeout`` and every call its own.  The
bit-for-bit cases run torch on one CPU thread in every process (see
``tests/test_torch_actors.py``)."""
import multiprocessing.shared_memory as sm
import os
import time

import numpy as np
import pytest
import torch

from repro_torch.configs.llama_paper import smoke
from repro_torch.core import (ActorDied, CommType, CommunicationChannel,
                              Executor, ExecutorController, FaultPlan,
                              RestartPolicy, RewardExecutor, Supervisor,
                              TrainerExecutor, WeightFabric,
                              WeightsCommunicationChannel, as_handle,
                              build_generator_pool, close_all_actors,
                              spawn_actor)
from repro_torch.core.fabric import payload_key
from repro_torch.core.genpool import WorkAssignment
from repro_torch.core.supervise import RESPAWNED
from repro_torch.rl.data import ArithmeticTasks
from repro_torch.train.optimizer import tree_leaves

TIMEOUT = 120.0
KEYS = ("loss", "grad_norm", "mean_ratio", "mean_logp", "mean_reward",
        "weight_version")
SPECS = ("kill:generator1@batch=2; kill:g0@batch=3,chunk=1;"
         "hang:generator0@batch=2:7.5; drop:g@publish=3; kill:ref@consume=4")


@pytest.fixture(autouse=True)
def _reap_actors():
    yield
    close_all_actors()


@pytest.fixture
def one_thread(monkeypatch):
    """torch on one CPU thread here and in every child spawned meanwhile."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(before)


def micro_cfg():
    return smoke().replace(n_layers=1, d_model=32, n_heads=2, n_kv_heads=2,
                           head_dim=16, d_ff=64, vocab=64)


def build_supervised(n_gens=2, staleness=1, max_steps=6, transport="proc",
                     chaos=None, policy=None, supervise=True,
                     trainer_cls=TrainerExecutor):
    """The micro pipeline of ``tests/test_torch_genpool.py`` with a
    supervisor wired in."""
    cfg = micro_cfg()
    rew = RewardExecutor(n_per_prompt=2)
    trn = trainer_cls(cfg, lr=5e-2, seed=0, device="cpu")
    gens, chans = build_generator_pool(
        cfg, trn,
        lambda g: ArithmeticTasks(prompt_len=8, max_operand=4, ops="+",
                                  seed=100 + g),
        n_generators=n_gens, seed=100, n_prompts=4, n_per_prompt=2,
        max_new=4, temperature=1.0, chunk=2, device="cpu",
        transport=transport, call_timeout=TIMEOUT)
    chans += [CommunicationChannel("completions", gens[0], rew,
                                   CommType.GATHER),
              CommunicationChannel("completions_with_reward", rew, trn,
                                   CommType.SCATTER)]
    sup = Supervisor(policy or RestartPolicy(), chaos=chaos) \
        if supervise else None
    return ExecutorController(gens + [rew, trn], chans, max_steps=max_steps,
                              mode="async", staleness=staleness,
                              timeout=TIMEOUT, supervise=sup)


def rows(history):
    return [[h[k] for k in KEYS] for h in history]


class EchoExecutor(Executor):
    """An importable RPC target for the respawn cases."""

    role = "echo"

    def pid(self):
        return os.getpid()

    def echo(self, x):
        return x


class WeightSink(Executor):
    """Applies staged weights; reports their sum."""

    role = "sink"

    def __init__(self, name="sink"):
        super().__init__(name)
        self.params = None
        self.weight_version = -1

    def set_weights(self, params, version=None):
        self.params = params
        if version is not None:
            self.weight_version = version

    def weights_sum(self) -> float:
        return float(self.params["w"].double().sum())


class Source(Executor):
    def __init__(self):
        super().__init__("trainer")


# ------------------------------------------------------------ fault plans --

def test_fault_plan_parse_grammar():
    plan = FaultPlan.parse(SPECS)
    got = [(f.action, f.actor, f.point, f.index, f.chunk)
           for f in plan.faults]
    assert got == [("kill", "generator1", "batch", 2, None),
                   ("kill", "g0", "batch", 3, 1),
                   ("hang", "generator0", "batch", 2, None),
                   ("drop", "g", "publish", 3, None),
                   ("kill", "ref", "consume", 4, None)]
    assert plan.faults[2].arg == 7.5
    assert len(plan.unfired()) == 5


@pytest.mark.parametrize("spec", [SPECS, "kill:generator1@batch=3",
                                  "kill:generator1@batch=3,chunk=1",
                                  "hang:generator0@publish=2:0.5;;",
                                  " drop:ref@consume=0 "])
def test_fault_plan_parse_equals_jax(spec, monkeypatch):
    """The same spec gives the same faults in both packages, and
    ``from_env`` reads ``REPRO_CHAOS`` in both."""
    from repro.core.supervise import FaultPlan as JFaultPlan

    def fields(plan):
        return [(f.action, f.actor, f.point, f.index, f.chunk, f.arg,
                 f.fired) for f in plan.faults]
    assert fields(FaultPlan.parse(spec)) == fields(JFaultPlan.parse(spec))
    monkeypatch.setenv("REPRO_CHAOS", spec)
    assert fields(FaultPlan.from_env()) == fields(JFaultPlan.from_env())
    monkeypatch.setenv("REPRO_CHAOS", " ")
    assert FaultPlan.from_env() is None and JFaultPlan.from_env() is None


def test_fault_plan_fires_once_at_exact_coordinates():
    class FakeHandle:
        name = "g"

        def __init__(self):
            self.casts = []
            self.transport = self

        def cast(self, method, *args):
            self.casts.append((method, args))

    plan = FaultPlan.parse("hang:g@batch=2,chunk=1:5")
    h = FakeHandle()
    plan.bind(h)
    assert not plan.fire("batch", "g", 2, None)       # chunk mismatch
    assert not plan.fire("batch", "other", 2, 1)      # actor mismatch
    assert not plan.fire("publish", "g", 2, 1)        # point mismatch
    assert plan.fire("batch", "g", 2, 1)
    assert h.casts == [("chaos_hang", (5.0,))]
    assert not plan.fire("batch", "g", 2, 1)          # each fires once
    assert plan.unfired() == []
    assert plan.fired_log == [("hang", "g", "batch", 2, 1)]
    with pytest.raises(RuntimeError, match="unbound"):
        FaultPlan.parse("kill:nobody@consume=1").fire_any("consume", 1)


# -------------------------------------------------------- work assignment --

def test_work_assignment_round_robin_and_failover_resort():
    wa = WorkAssignment(["a", "b"], 0, 8)
    assert wa.next_for("a") == 0 and wa.next_for("b") == 1
    wa.start("a", 0)
    wa.start("b", 1)
    wa.finish("a", 0)
    # b dies holding batch 1 in flight with 3, 5, 7 still queued
    assert wa.fail_over("b") == [1, 3, 5, 7]
    assert wa.survivors() == ["a"] and wa.is_retired("b")
    order = []
    while (n := wa.next_for("a")) is not None:
        wa.start("a", n)
        wa.finish("a", n)
        order.append(n)
    # remapped indices sorted in: the head is always the smallest, so
    # the consumer's in-order admission gate never starves
    assert order == [1, 2, 3, 4, 5, 6, 7]
    assert wa.all_done()


def test_work_assignment_failover_without_survivors_raises():
    wa = WorkAssignment(["a"], 0, 4)
    with pytest.raises(RuntimeError, match="surviv"):
        wa.fail_over("a")


def test_work_assignment_requeue_keeps_order():
    wa = WorkAssignment(["a", "b"], 0, 6)
    wa.start("a", 0)
    wa.start("a", 2)
    wa.requeue("a", 0)                       # its generator was respawned
    assert wa.next_for("a") == 0 and not wa.all_done()
    wa.start("a", 0)
    for n in (0, 2):
        wa.finish("a", n)
    assert wa.next_for("a") == 4


def test_work_assignment_grow_and_drain():
    wa = WorkAssignment(["a", "b"], 0, 9)
    wa.start("a", 0)                         # in flight: stays a's
    wa.add_worker("c")
    wa.rebalance()
    # every unstarted index re-dealt ascending over a, b, c
    assert wa.next_for("a") == 1 and wa.next_for("b") == 2
    assert wa.next_for("c") == 3
    moved = wa.drain_worker("b")
    assert moved == [2, 5, 8] and wa.is_retired("b")
    assert wa.next_for("b") is None
    remaining = set()
    for name in ("a", "c"):
        while (n := wa.next_for(name)) is not None:
            wa.start(name, n)
            wa.finish(name, n)
            remaining.add(n)
    wa.finish("a", 0)
    assert remaining == set(range(1, 9))
    assert wa.all_done()


# ------------------------------------------- no-fault numeric equivalence --

def test_supervised_pool_of_one_no_fault_matches_sequential(one_thread):
    """The supervision machinery in the loop (fabric seeding, chaos hooks
    at None, the work assignment, retry wrappers) changes no number: a
    supervised no-fault pool of 1, its generator in a child, trains bit
    for bit what the sequential reference trains."""
    supervised = build_supervised(n_gens=1, staleness=1, max_steps=3,
                                  transport="proc")
    reference = build_supervised(n_gens=1, staleness=1, max_steps=3,
                                 transport="inproc", supervise=False)
    hs = supervised.run()
    hr = reference.run_sequential()
    assert rows(hs) == rows(hr)
    assert [h["weight_version"] for h in hs] == [0, 0, 1]
    assert supervised.supervisor.events("respawned") == []


# ------------------------------------------------------------- kill chaos --

@pytest.mark.parametrize("where", ["batch=3", "batch=3,chunk=1"])
def test_kill_generator_respawns_and_completes(where):
    """SIGKILL one pool worker at a batch boundary and mid-decode: every
    batch completes in order, the victim is respawned (weights replayed,
    jobs re-admitted), and the staleness bound holds throughout."""
    chaos = FaultPlan.parse(f"kill:generator1@{where}")
    ctl = build_supervised(n_gens=2, staleness=1, max_steps=6,
                           transport="proc", chaos=chaos)
    hist = ctl.run()
    sup = ctl.supervisor
    assert [h["step"] for h in hist] == list(range(6))
    assert chaos.unfired() == []
    respawns = sup.events("respawned")
    assert [e["actor"] for e in respawns] == ["generator1"]
    assert respawns[0]["recovery_s"] > 0.0
    assert respawns[0]["spawn_s"] > 0.0 and respawns[0]["version"] >= 0
    # the replay moved one version of the policy
    params = ctl.executors["trainer"].call("get_output", "policy_model")
    assert respawns[0]["replay_gb"] == pytest.approx(
        sum(t.nbytes for t in tree_leaves(params)) / 1e9, rel=1e-12)
    # ownership survives the respawn: the victim still produces its own
    # batches, the one it was killed on included
    assert [h["generator"] for h in hist] == \
        [f"generator{n % 2}" for n in range(6)]
    assert max(ctl.staleness_hist) <= 1
    assert all(h["weight_version"] >= h["step"] - 1 for h in hist)
    assert all(np.isfinite(h["loss"]) for h in hist)


def test_kill_generator_schedule_and_events_equal_jax():
    """The same kill over ``proc`` in both packages: the same steps,
    producers and weight versions, and the same recovery events."""
    from repro.configs.llama_paper import smoke as jsmoke
    from repro.core import CommType as JCommType
    from repro.core import CommunicationChannel as JChannel
    from repro.core import ExecutorController as JController
    from repro.core import FaultPlan as JFaultPlan
    from repro.core import RewardExecutor as JReward
    from repro.core import Supervisor as JSupervisor
    from repro.core import TrainerExecutor as JTrainer
    from repro.core import build_generator_pool as jbuild_pool
    from repro.rl.data import ArithmeticTasks as JTasks

    jcfg = jsmoke().replace(n_layers=1, d_model=32, n_heads=2, n_kv_heads=2,
                            head_dim=16, d_ff=64, vocab=64)
    jrew = JReward(n_per_prompt=2)
    jtrn = JTrainer(jcfg, lr=5e-2, seed=0)
    jgens, jchans = jbuild_pool(
        jcfg, jtrn,
        lambda g: JTasks(prompt_len=8, max_operand=4, ops="+",
                         seed=100 + g),
        n_generators=2, seed=100, n_prompts=4, n_per_prompt=2, max_new=4,
        temperature=1.0, chunk=2, transport="proc")
    jchans += [JChannel("completions", jgens[0], jrew, JCommType.GATHER),
               JChannel("completions_with_reward", jrew, jtrn,
                        JCommType.SCATTER)]
    jchaos = JFaultPlan.parse("kill:generator1@batch=3")
    jctl = JController(jgens + [jrew, jtrn], jchans, max_steps=6,
                       mode="async", staleness=1, timeout=TIMEOUT,
                       supervise=JSupervisor(chaos=jchaos))
    try:
        jh = jctl.run()
    finally:
        for g in jgens:
            g.close()
    chaos = FaultPlan.parse("kill:generator1@batch=3")
    ctl = build_supervised(chaos=chaos)
    th = ctl.run()
    cols = ("step", "generator", "weight_version")
    assert [[h[k] for k in cols] for h in th] == \
        [[h[k] for k in cols] for h in jh]

    def recovery(sup):
        return [(e["event"], e["actor"]) for e in sup.events()
                if e["event"] in ("recovering", "respawned", "lost",
                                  "readmitted", "pool-resized")]
    assert recovery(ctl.supervisor) == recovery(jctl.supervisor) == [
        ("recovering", "generator1"), ("respawned", "generator1")]
    assert {e["actor"] for e in ctl.supervisor.events()} == \
        {e["actor"] for e in jctl.supervisor.events()}
    assert chaos.fired_log == jchaos.fired_log


def test_restart_budget_exhausted_degrades_to_survivors():
    """max_restarts=0: the victim is declared lost, its batches fail over
    to the survivor, the fabric stops publishing to the corpse, and the
    run still completes every batch."""
    chaos = FaultPlan.parse("kill:generator1@batch=3")
    ctl = build_supervised(n_gens=2, staleness=1, max_steps=6,
                           transport="proc", chaos=chaos,
                           policy=RestartPolicy(max_restarts=0))
    hist = ctl.run()
    sup = ctl.supervisor
    assert [h["step"] for h in hist] == list(range(6))
    assert sup.is_lost("generator1")
    assert [e["actor"] for e in sup.events("lost")] == ["generator1"]
    assert sup.events("respawned") == []
    # batches 3 and 5 (the victim's) were remapped to the survivor
    assert [h["generator"] for h in hist] == \
        ["generator0", "generator1"] + ["generator0"] * 4
    assert ctl._fabric.dead_subscribers() != []
    assert [e["n_workers"] for e in sup.events("pool-resized")] == [1]
    assert max(ctl.staleness_hist) <= 1


def test_losing_the_last_worker_fails_fast():
    """Zero survivors falls back to fail-fast: a pool of 1 whose only
    generator is declared lost re-raises from ``run``."""
    chaos = FaultPlan.parse("kill:generator@batch=1")
    ctl = build_supervised(n_gens=1, max_steps=4, chaos=chaos,
                           policy=RestartPolicy(max_restarts=0))
    with pytest.raises(RuntimeError, match="no surviving workers"):
        ctl.run()
    assert chaos.unfired() == []
    assert [e["actor"] for e in ctl.supervisor.events("lost")] == \
        ["generator"]


# ------------------------------------------------------------ hang triage --

def test_hang_triage_and_responsive_backpressure():
    """A TimeoutError is triaged with a ping: a responsive actor means
    backpressure (re-raised, no restart spent); an unresponsive but live
    child is killed and respawned."""
    h = spawn_actor(EchoExecutor, "hangy", transport="proc",
                    call_timeout=TIMEOUT)
    sup = Supervisor(RestartPolicy(max_restarts=1, hang_ping_s=0.5))
    sup.register(h)
    with pytest.raises(TimeoutError, match="backpressure"):
        sup.recover(h, TimeoutError("backpressure: queue full"))
    assert sup.restarts("hangy") == 0
    assert sup.events("hang-detected") == []
    old_pid = h.call("pid")
    h.cast("chaos_hang", 30.0)               # wedge the child's RPC loop
    with pytest.raises(TimeoutError):
        h.call("ping", timeout=1.0)
    assert sup.recover(h, TimeoutError("deadline")) == RESPAWNED
    assert [e["actor"] for e in sup.events("hang-detected")] == ["hangy"]
    assert sup.restarts("hangy") == 1
    assert h.call("ping") == "hangy"         # a fresh child, live at once
    assert h.call("pid") != old_pid
    # the budget is spent: the next death declares the actor lost
    h.transport._proc.kill()
    with pytest.raises(ActorDied):
        h.call("ping", timeout=30.0)
    assert sup.recover(h, ActorDied("killed")) == "lost"
    assert sup.is_lost("hangy") and not sup.covers(h)


# -------------------------------------------------------- respawn hygiene --

def test_shm_respawn_reaps_process_and_segments():
    """SIGKILL and respawn of a ``ShmTransport`` actor leave no /dev/shm
    segment and a reaped predecessor: the new child gets fresh rings."""
    h = spawn_actor(EchoExecutor, "shm-victim", transport="shm",
                    call_timeout=TIMEOUT)
    sup = Supervisor()
    sup.register(h)
    payload = {"w": torch.arange(1 << 17, dtype=torch.float32)}
    assert torch.equal(h.call("echo", payload)["w"], payload["w"])
    old_proc = h.transport._proc
    old_segs = list(h.transport.segment_names())
    assert old_segs
    old_proc.kill()
    with pytest.raises(ActorDied):
        h.call("ping", timeout=30.0)
    # the liveness hook fired once, on the receive that found it gone
    assert [e["actor"] for e in sup.events("death-detected")] == \
        ["shm-victim"]
    assert sup.recover(h, ActorDied("killed")) == RESPAWNED
    assert not old_proc.is_alive() and old_proc.exitcode is not None
    for name in old_segs:
        with pytest.raises(FileNotFoundError):
            sm.SharedMemory(name=name)
    # a payload-sized echo proves the new rings work
    assert torch.equal(h.call("echo", payload)["w"], payload["w"])
    new_segs = list(h.transport.segment_names())
    assert new_segs and not set(new_segs) & set(old_segs)
    h.close()
    for name in new_segs:
        with pytest.raises(FileNotFoundError):
            sm.SharedMemory(name=name)


def test_monitor_notes_a_death_no_call_found():
    """The optional monitor thread records ``unhealthy`` once for a
    killed child that no thread is calling, and after the respawn
    watches the new child without a second event."""
    h = spawn_actor(EchoExecutor, "watched", transport="proc",
                    call_timeout=TIMEOUT)
    sup = Supervisor()
    sup.register(h)
    sup.start_monitor()
    try:
        assert h.call("ping") == "watched"
        h.transport._proc.kill()
        deadline = time.monotonic() + 30.0
        while not sup.events("unhealthy") and time.monotonic() < deadline:
            time.sleep(0.05)
        assert [e["actor"] for e in sup.events("unhealthy")] == ["watched"]
        assert sup.recover(h, ActorDied("killed")) == RESPAWNED
        assert h.call("ping") == "watched"
        time.sleep(1.0)                     # several polls of the new child
        assert [e["actor"] for e in sup.events("unhealthy")] == ["watched"]
    finally:
        sup.stop_monitor()


def test_respawn_rebuilds_from_the_spawn_spec():
    """``respawn`` swaps a fresh transport into the same handle; a
    handle made without ``spawn_actor`` has no spec and refuses."""
    h = spawn_actor(EchoExecutor, "inproc-echo", transport="inproc")
    before = h.transport
    assert h.respawn() is h and h.transport is not before
    assert h.name == "inproc-echo" and h.call("ping") == "inproc-echo"
    with pytest.raises(RuntimeError, match="spawn spec"):
        as_handle(EchoExecutor("bare")).respawn()


def test_fabric_reattach_replays_latest_committed_version():
    """The respawn's replay at the fabric level: the newcomer receives the
    latest committed version straight into its slots (not version 0),
    then rejoins the publish loop."""
    sink = spawn_actor(WeightSink, "rsink", transport="proc",
                       call_timeout=TIMEOUT)
    src = as_handle(Source())
    ch = WeightsCommunicationChannel("policy_model", src, sink)
    fab = WeightFabric([ch], overlap=True, max_staged=4, timeout=TIMEOUT)
    sup = Supervisor()
    sup.attach_fabric(fab)
    sup.register(sink, channels=[ch])
    try:
        fab.publish(1, {payload_key(ch): {"w": torch.ones(2)}})
        assert ch.recv(timeout=15.0)[0] == 1
        fab.flush(15.0)
        sink.transport._proc.kill()
        with pytest.raises(ActorDied):
            sink.call("ping", timeout=30.0)
        assert sup.recover(sink, ActorDied("killed")) == RESPAWNED
        assert sup.events("respawned")[0]["version"] == 1
        assert sink.call("weights_sum") == 2.0      # v1 replayed
        assert sink.call("weight_version") == 1
        assert fab.dead_subscribers() == []         # back in the loop
        fab.publish(2, {payload_key(ch): {"w": torch.full((2,), 2.0)}})
        assert ch.recv(timeout=15.0)[0] == 2
        fab.flush(15.0)
        assert sink.call("weights_sum") == 4.0
    finally:
        fab.close()
        sink.close()


def test_fabric_publish_fault_detaches_and_reports():
    """A ``drop`` at publish cuts the subscriber's connection as that
    version publishes: the fabric detaches it, keeps serving the others,
    and the supervisor logs ``publish-failed``."""
    sinks = [spawn_actor(WeightSink, f"s{i}", transport="proc",
                         call_timeout=TIMEOUT) for i in range(2)]
    src = as_handle(Source())
    chs = [WeightsCommunicationChannel("policy_model", src, s)
           for s in sinks]
    fab = WeightFabric(chs, overlap=True, max_staged=4, timeout=TIMEOUT)
    chaos = FaultPlan.parse("drop:s1@publish=2")
    sup = Supervisor(chaos=chaos)
    sup.attach_fabric(fab)
    for s, ch in zip(sinks, chs):
        sup.register(s, channels=[ch])
    fab.chaos = chaos
    try:
        for v in (1, 2):
            fab.publish(v, {payload_key(chs[0]): {"w": torch.ones(2) * v}})
        fab.flush(30.0)
        assert chaos.unfired() == []
        assert fab.dead_subscribers() == [chs[1]]
        assert [e["actor"] for e in sup.events("publish-failed")] == ["s1"]
        assert [chs[0].recv(timeout=15.0)[0] for _ in range(2)] == [1, 2]
    finally:
        fab.close()


# -------------------------------------------------- per-role restart policy --

class GenEcho(EchoExecutor):
    """An RPC target in the generator role."""

    role = "generator"


def _jax_gen_echo():
    from repro.core.executor import Executor as JExecutor

    class JGenEcho(JExecutor):
        role = "generator"
    return JGenEcho


class JGenEcho:
    """Picklable factory of the JAX package's generator-role echo
    executor (the class itself is made on import of the JAX package)."""

    def __new__(cls, name):
        return _jax_gen_echo()(name)


def _per_role_budget(sup_mod, actors_mod, factory):
    """A generator child under ``{"generator": max_restarts=1}`` is
    killed twice: the first death respawns it, the second finds the
    budget spent.  Returns what the supervisor reported."""
    pol = sup_mod.RestartPolicy(max_restarts=1, backoff_s=0.0)
    sup = sup_mod.Supervisor({"generator": pol},
                             default=sup_mod.RestartPolicy(max_restarts=5))
    out = [sup.policy_for("generator") == pol,
           sup.policy_for("ref").max_restarts, sup.monitor_poll_s]
    h = actors_mod.spawn_actor(factory, "gen", transport="proc",
                               call_timeout=TIMEOUT)
    try:
        sup.register(h)
        for _ in range(2):
            h.transport._proc.kill()
            with pytest.raises(actors_mod.ActorDied):
                h.call("ping", timeout=30.0)
            out.append(sup.recover(h, actors_mod.ActorDied("killed")))
        out += [sup.restarts("gen"), sup.is_lost("gen"),
                [e["event"] for e in sup.events()
                 if e["event"] in ("respawned", "lost")]]
    finally:
        h.close()
    return out


def test_per_role_policies_budget_equals_jax():
    """``Supervisor({"generator": RestartPolicy(max_restarts=1)}, default=
    ...)``: ``policy_for`` gives the role its own budget and every other
    role the default; the generator recovers once, then is lost, as in
    the JAX package.  A bare ``RestartPolicy`` is still the default."""
    from repro.core import actors as jactors
    from repro.core import supervise as jsup
    from repro_torch.core import actors, supervise
    got = _per_role_budget(supervise, actors, GenEcho)
    want = _per_role_budget(jsup, jactors, JGenEcho)
    assert got == want
    assert got[:3] == [True, 5, 0.2]
    assert got[3:] == [RESPAWNED, "lost", 1, True, ["respawned", "lost"]]
    pol = RestartPolicy(max_restarts=2)
    assert Supervisor(pol).policy_for("generator") is pol
    assert Supervisor(pol).default is pol
    assert Supervisor(monitor_poll_s=0.05).monitor_poll_s == 0.05
