"""The port's actor transports on the CPU (``repro_torch.core.actors``),
after ``tests/test_actors.py`` and ``tests/test_concurrency.py``: proc,
shm and socket handles keep call and cast order and read attributes;
remote exceptions keep their type; a timeout does not poison the handle;
a child's constructor failure propagates; a killed child raises
``ActorDied`` instead of hanging; the shm ring reuses and grows its slots
with exact bytes and leaves no segment behind; ``DeviceSpec`` reaches the
child; a pool of 1 with its generator in a child equals ``run_sequential``
and the in-process run bit for bit, re-raises when the child is killed
mid-run, and tracks the JAX package's run from the same converted init.

Children pay a torch import each (about 2 s here), so spawns are few.
Every join, call and wait has its own timeout.  The bit-for-bit cases run
torch on one CPU thread in every process: its CPU reductions split their
work by the thread count, which a pool thread and a child's main thread
need not share (on the card no kernel depends on host threads)."""
import os
import queue
import threading
import time

import pytest
import torch

from repro_torch.configs.llama_paper import smoke
from repro_torch.core import (ActorDied, CommType, CommunicationChannel,
                              DeviceSpec, Executor, ExecutorController,
                              GeneratorExecutor, PartialRolloutCache,
                              RemoteActorError, RewardExecutor,
                              StalenessBuffer, TrainerExecutor,
                              WeightsCommunicationChannel, close_all_actors,
                              serve_actor_host, spawn_actor)
from repro_torch.core import actors
from repro_torch.core.offpolicy import Closed
from repro_torch.rl.data import ArithmeticTasks

KEYS = ("loss", "grad_norm", "mean_ratio", "mean_logp", "mean_reward",
        "weight_version")


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


class EchoExecutor(Executor):
    """An importable RPC target for the contract tests."""

    role = "echo"

    def __init__(self, name="echo", device=None):
        super().__init__(name)
        self.device = device

    def pid(self):
        return os.getpid()

    def echo(self, x):
        return x

    def env(self, key):
        return os.environ.get(key)

    def boom(self):
        raise ValueError("kaboom")

    def sleep(self, t):
        time.sleep(t)
        return "slept"

    def unpicklable_boom(self):
        e = ValueError("gnarly")
        e.payload = lambda: None             # defeats exception pickling
        raise e


@pytest.mark.parametrize("transport", ["proc", "shm", "socket"])
def test_remote_handle_order_attributes_and_close(transport):
    h = spawn_actor(EchoExecutor, "remote-echo", transport=transport,
                    spawn_timeout=60.0, call_timeout=60.0)
    try:
        assert h.name == "remote-echo" and h.role == "echo" and h.remote
        assert h.call("pid") != os.getpid()
        payload = {"w": torch.arange(6, dtype=torch.bfloat16),
                   "big": torch.randn(40_000), "meta": ["a", 3]}
        got = h.call("echo", payload)
        assert got["meta"] == ["a", 3]
        for k in ("w", "big"):
            assert got[k].dtype == payload[k].dtype
            assert torch.equal(got[k], payload[k])
        # cast then call is FIFO: the call observes the cast
        for i in range(5):
            h.cast("put_input", "k", i)
        assert h.call("get_input", "k") == 4
        assert h.call("curr_step") == 0      # an attribute read
        assert h.healthy()
        assert h.spawn_spec.transport == transport
    finally:
        h.close()
    assert not h.healthy()
    with pytest.raises(ActorDied):
        h.call("ping")
    h.join(timeout=10.0)


@pytest.fixture
def echo_proc():
    h = spawn_actor(EchoExecutor, "boomer", transport="proc",
                    spawn_timeout=60.0, call_timeout=60.0)
    yield h
    h.close()


def test_remote_exception_keeps_its_type(echo_proc):
    h = echo_proc
    with pytest.raises(ValueError, match="kaboom") as ei:
        h.call("boom")
    assert isinstance(ei.value.__cause__, RemoteActorError)
    assert "boom" in str(ei.value.__cause__)     # the remote traceback
    assert h.call("ping") == "boomer"            # the actor survives
    with pytest.raises(RemoteActorError, match="gnarly"):
        h.call("unpicklable_boom")
    # a cast's error surfaces on the next call, which still consumes its
    # own reply: later calls get their own results
    h.cast("boom")
    with pytest.raises(ValueError, match="kaboom"):
        h.call("ping")
    assert h.call("echo", "after") == "after"
    with pytest.raises(TypeError, match="attribute"):
        h.call("curr_step", 1)


def test_call_timeout_does_not_poison_the_handle(echo_proc):
    h = echo_proc
    with pytest.raises(TimeoutError, match="sleep"):
        h.call("sleep", 1.5, timeout=0.3)
    assert h.call("echo", 42) == 42          # not the late 'slept'
    assert h.call("ping") == "boomer"
    assert h.healthy()


def test_child_constructor_failure_propagates():
    with pytest.raises(ValueError, match="n_per_prompt"):
        spawn_actor(RewardExecutor, n_per_prompt=0, transport="proc",
                    spawn_timeout=60.0)


def test_killed_child_raises_actor_died_not_hang():
    h = spawn_actor(EchoExecutor, "victim", transport="proc",
                    spawn_timeout=60.0)
    assert h.call("ping") == "victim"
    h.transport._proc.kill()
    t0 = time.monotonic()
    with pytest.raises(ActorDied, match="exited"):
        h.call("ping", timeout=30.0)
    assert time.monotonic() - t0 < 10.0      # the liveness poll, not 30 s
    assert not h.healthy()


def test_shm_ring_reuses_and_grows_exact_bytes_and_leaves_nothing(
        monkeypatch):
    monkeypatch.setenv("REPRO_SHM_SLOTS", "2")
    h = spawn_actor(EchoExecutor, "shm-echo", transport="shm",
                    spawn_timeout=60.0, call_timeout=60.0)
    names = set()
    try:
        assert len(h.transport._tx_ring._slots) == 2
        gen = torch.Generator().manual_seed(7)
        mid = {"w": torch.randn(256, 300, generator=gen),
               "q": torch.arange(123).to(torch.bfloat16), "meta": ["x", 1]}
        for _ in range(5):                   # slot recycling
            got = h.call("echo", mid)
            assert torch.equal(got["w"], mid["w"])
            assert torch.equal(got["q"], mid["q"])
            names.update(h.transport.segment_names())
        n_before = len(h.transport._tx_ring.created)
        big = {"w": torch.randn(3_000_000, generator=gen)}
        assert torch.equal(h.call("echo", big)["w"], big["w"])  # grows
        assert len(h.transport._tx_ring.created) > n_before
        assert torch.equal(h.call("echo", mid)["w"], mid["w"])
        h.cast("put_input", "k", 11)             # still FIFO over shm
        assert h.call("get_input", "k") == 11
        names.update(h.transport.segment_names())
    finally:
        h.close()
    assert names and not any(os.path.exists(f"/dev/shm/{n}") for n in names)
    assert h.transport.segment_names() == []


def test_device_spec_reaches_the_child(monkeypatch):
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "3,5")
    h = spawn_actor(EchoExecutor, "dev-probe", transport="proc",
                    device_spec=DeviceSpec(device_count=1),
                    spawn_timeout=60.0)
    try:
        assert h.call("env", "CUDA_VISIBLE_DEVICES") == "3"
        assert h.call("device") == "cuda"    # handed the child's card
        assert h.device is None              # staging is the wire
    finally:
        h.close()
    assert DeviceSpec(device_count=2).executor_kwargs(
        EchoExecutor, {"device": "cpu"}) == {"device": "cpu"}
    assert DeviceSpec(device_count=2).executor_kwargs(
        RewardExecutor, {"n_per_prompt": 2}) == {"n_per_prompt": 2}
    # a child's own mesh: its shape, axes and ranks (a mesh of more than
    # one rank is that many processes, tests/test_torch_child_mesh.py)
    spec = DeviceSpec(device_count=2, mesh_shape=(1, 2))
    assert spec.mesh_axes == ("data", "model") and spec.mesh_size == 2
    assert DeviceSpec(device_count=2).mesh_size == 0
    assert DeviceSpec().build_mesh("cpu") is None
    with pytest.raises(ValueError, match="join"):
        spec.build_mesh("cpu")               # no world of two here
    with pytest.raises(ValueError, match="mesh_shape"):
        DeviceSpec(mesh_shape=(1, 2, 2))     # three dims, two axes


def test_socket_actor_on_a_listening_host():
    """``serve_actor_host`` serves one actor a connection, here on a
    thread of this process; ``REPRO_SOCKET_ADDRS`` routes spawns to it."""
    ready = queue.Queue()
    t = threading.Thread(target=serve_actor_host,
                         args=("127.0.0.1", 0),
                         kwargs={"once": True, "ready": ready.put},
                         daemon=True)
    t.start()
    port = ready.get(timeout=10.0)
    os.environ["REPRO_SOCKET_ADDRS"] = f"127.0.0.1:{port}"
    try:
        h = spawn_actor(EchoExecutor, "hosted", transport="socket")
    finally:
        del os.environ["REPRO_SOCKET_ADDRS"]
    assert h.transport.address == ("127.0.0.1", port)
    assert h.call("pid") == os.getpid()      # served by the host thread
    assert h.call("echo", {"x": torch.ones(3)})["x"].sum().item() == 3.0
    h.close()
    t.join(timeout=10.0)
    assert not t.is_alive()


@pytest.mark.parametrize("at_once", [True, False])
def test_spawn_all_starts_jobs_at_once_or_in_order(at_once):
    spans = {}

    def job(k):
        t0 = time.perf_counter()
        time.sleep(0.2)
        spans[k] = (t0, time.perf_counter(), threading.current_thread())
        return k
    out = actors.spawn_all([lambda k=k: job(k) for k in range(3)], at_once)
    assert out == [0, 1, 2]
    starts = [spans[k][0] for k in range(3)]
    ends = [spans[k][1] for k in range(3)]
    if at_once:
        assert max(starts) < min(ends)
        assert threading.current_thread() not in {s[2] for s in
                                                   spans.values()}
    else:
        assert starts[1] >= ends[0] and starts[2] >= ends[1]
        assert {s[2] for s in spans.values()} == {threading.current_thread()}


def test_spawn_all_closes_what_the_others_spawned_when_one_fails():
    class Handle:
        closed = False

        def close(self):
            self.closed = True
    trainer, pool = Handle(), [Handle(), Handle()]

    def fails():
        raise RuntimeError("the reference did not start")
    with pytest.raises(RuntimeError, match="did not start"):
        actors.spawn_all([lambda: trainer, lambda: (pool, []), fails])
    assert trainer.closed and all(h.closed for h in pool)


def test_unknown_transport_and_respawn_raise():
    with pytest.raises(ValueError, match="unknown transport"):
        spawn_actor(EchoExecutor, transport="carrier-pigeon")
    h = spawn_actor(EchoExecutor, transport="inproc")
    assert not h.remote
    # a handle with a recorded spawn spec respawns (core/supervise.py
    # drives it); one made around a bare executor has no spec and raises
    assert h.respawn() is h and h.call("ping") == "echo"
    with pytest.raises(RuntimeError, match="spawn spec"):
        actors.as_handle(EchoExecutor("bare")).respawn()


# ------------------------------------------ the controller over a child --

def micro_cfg():
    return smoke().replace(n_layers=1, d_model=32, n_heads=2, n_kv_heads=2,
                           head_dim=16, d_ff=64, vocab=64)


def build_controller(seed, transport, chunk=0, steps=3, trainer_cls=None):
    cfg = micro_cfg()
    tasks = ArithmeticTasks(prompt_len=8, max_operand=4, ops="+", seed=seed)
    gen = spawn_actor(GeneratorExecutor, cfg, tasks, n_prompts=4,
                      n_per_prompt=2, max_new=4, temperature=1.0, seed=seed,
                      chunk=chunk, device="cpu", transport=transport,
                      spawn_timeout=60.0, call_timeout=60.0)
    rew = RewardExecutor(n_per_prompt=2)
    trn = (trainer_cls or TrainerExecutor)(cfg, lr=5e-2, seed=seed,
                                           device="cpu")
    return ExecutorController(
        [gen, rew, trn],
        [WeightsCommunicationChannel("policy_model", trn, gen),
         CommunicationChannel("completions", gen, rew, CommType.GATHER),
         CommunicationChannel("completions_with_reward", rew, trn,
                              CommType.SCATTER)],
        max_steps=steps, mode="async", staleness=1, timeout=120.0)


def rows(history):
    return [[h[k] for k in KEYS] for h in history]


@pytest.mark.parametrize("chunk", [0, 2])
def test_proc_pool_of_one_matches_sequential_and_inproc(chunk, one_thread):
    """The generator in a child -- batches, weights and, with chunk=2,
    the job and its KV state crossing the socket every chunk -- trains
    bit for bit what the in-process threaded run and ``run_sequential``
    train; the child pins each job's params and releases every pin."""
    remote = build_controller(11, "proc", chunk=chunk)
    hp = remote.run()
    gen = remote.generator
    if chunk:
        assert gen.call("pinned_count") == 0
        staged = gen.call("staged_versions")
        assert staged == remote._channels_by_gen[gen.name][0] \
            .queued_versions()
    hi = build_controller(11, "inproc", chunk=chunk).run()
    hs = build_controller(11, "inproc", chunk=chunk).run_sequential()
    assert rows(hp) == rows(hi) == rows(hs)
    assert [h["weight_version"] for h in hp] == [0, 0, 1]


def test_controller_reraises_when_child_killed_mid_run():
    holder = []

    class KillerTrainer(TrainerExecutor):
        def step(self):
            if self.curr_step >= 1:
                holder[0].transport._proc.kill()
            return super().step()

    ctl = build_controller(3, "proc", steps=6, trainer_cls=KillerTrainer)
    holder.append(ctl.generator)
    t0 = time.monotonic()
    with pytest.raises(ActorDied):
        ctl.run()
    assert time.monotonic() - t0 < 60.0
    assert ctl._sample_queue.closed          # shutdown() ran


def test_proc_run_tracks_the_jax_package():
    """The proc-placed micro run against the JAX package's in-process run
    of ``tests/test_actors.py``'s controller, the port's trainer started
    from the JAX init: rewards and versions equal, metrics within 1e-4
    (``tests/test_torch_quickstart.py``'s tolerance)."""
    import jax
    import jax.numpy as jnp

    from repro.configs.llama_paper import smoke as jsmoke
    from repro.core import CommType as JCommType
    from repro.core import CommunicationChannel as JChannel
    from repro.core import ExecutorController as JController
    from repro.core import GeneratorExecutor as JGenerator
    from repro.core import RewardExecutor as JReward
    from repro.core import TrainerExecutor as JTrainer
    from repro.core import WeightsCommunicationChannel as JWeights
    from repro.rl.data import ArithmeticTasks as JTasks
    from repro.train.trainstep import init_train_state as jinit_state
    from repro_torch import convert
    from repro_torch.train.optimizer import adam_init
    from repro_torch.train.trainstep import TrainState

    jcfg = jsmoke().replace(n_layers=1, d_model=32, n_heads=2, n_kv_heads=2,
                            head_dim=16, d_ff=64, vocab=64)
    jgen = JGenerator(jcfg, JTasks(prompt_len=8, max_operand=4, ops="+",
                                   seed=5), n_prompts=4, n_per_prompt=2,
                      max_new=4, temperature=1.0, seed=5)
    jtrn = JTrainer(jcfg, lr=5e-2, seed=5)
    jrew = JReward(n_per_prompt=2)
    jh = JController(
        [jgen, jrew, jtrn],
        [JWeights("policy_model", jtrn, jgen),
         JChannel("completions", jgen, jrew, JCommType.GATHER),
         JChannel("completions_with_reward", jrew, jtrn, JCommType.SCATTER)],
        max_steps=3, mode="async", staleness=1, timeout=120.0).run()
    jparams = jax.device_get(
        jinit_state(jcfg, jax.random.PRNGKey(5), jnp.float32).params)
    ctl = build_controller(5, "proc")
    trn = ctl.trainer.transport.executor

    def init_from_jax():
        params = convert.from_jax_numpy(jparams, device="cpu")
        trn.state = TrainState(params, adam_init(params))
        trn.set_output("policy_model", params)
    trn.init = init_from_jax
    th = ctl.run()
    assert len(th) == len(jh) == 3
    for j, t in zip(jh, th):
        for k in ("weight_version", "sample_staleness", "mean_reward"):
            assert t[k] == j[k], (t["step"], k)
        for k in ("loss", "mean_logp", "mean_ratio", "grad_norm"):
            assert abs(t[k] - j[k]) <= 1e-4 * max(1.0, abs(j[k])), \
                (t["step"], k, t[k], j[k])


# ------------------------------------------------------------ concurrency --
# tests/test_concurrency.py's cases that tests/test_torch_controller.py
# does not cover

N_THREADS, N_ITEMS = 8, 40


def test_many_producers_one_consumer_no_drop_no_dup():
    buf = StalenessBuffer(delay=0, max_size=4)
    got, errs = [], []

    def producer(p):
        try:
            for i in range(N_ITEMS):
                buf.push(i, (p, i), timeout=30.0)
        except BaseException as e:           # pragma: no cover
            errs.append(e)

    def consumer():
        try:
            for _ in range(N_THREADS * N_ITEMS):
                got.append(buf.pop_wait(timeout=30.0)[1])
        except BaseException as e:           # pragma: no cover
            errs.append(e)

    threads = [threading.Thread(target=producer, args=(p,))
               for p in range(N_THREADS)] + \
        [threading.Thread(target=consumer)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60.0)
    assert not any(t.is_alive() for t in threads), "deadlocked"
    assert not errs
    assert sorted(got) == sorted((p, i) for p in range(N_THREADS)
                                 for i in range(N_ITEMS))
    for p in range(N_THREADS):               # per-producer FIFO
        mine = [i for (q_, i) in got if q_ == p]
        assert mine == sorted(mine)
    assert len(buf) == 0


def _blocked(fn):
    """Run ``fn`` on a thread that must be blocked; returns (thread, list
    that gets "closed" when ``fn`` raises ``Closed``)."""
    raised = []

    def body():
        try:
            fn()
        except Closed:
            raised.append("closed")
    t = threading.Thread(target=body)
    t.start()
    t.join(timeout=0.2)
    assert t.is_alive()
    return t, raised


def test_close_unblocks_producer_and_empty_consumer():
    buf = StalenessBuffer(delay=0, max_size=1)
    buf.push(0, "fill")
    t, raised = _blocked(lambda: buf.push(1, "overflow", timeout=30.0))
    empty = StalenessBuffer(delay=0)
    t2, raised2 = _blocked(lambda: empty.pop_wait(timeout=30.0))
    buf.close()
    empty.close()
    for th in (t, t2):
        th.join(timeout=5.0)
        assert not th.is_alive()
    assert raised == raised2 == ["closed"]


def test_partial_rollout_cache_contended_put_get_pending():
    cache = PartialRolloutCache()
    seen = [[] for _ in range(N_THREADS)]
    back = [[] for _ in range(N_THREADS)]
    errs = []

    def worker(w):
        try:
            for i in range(N_ITEMS):
                rid = cache.put(("state", w, i))
                seen[w].append(rid)
                cache.pending()
                if i % 2:
                    back[w].append(cache.get(rid))
        except BaseException as e:           # pragma: no cover
            errs.append(e)

    threads = [threading.Thread(target=worker, args=(w,))
               for w in range(N_THREADS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30.0)
    assert not errs and not any(t.is_alive() for t in threads)
    ids = [r for s in seen for r in s]
    assert len(ids) == len(set(ids))
    for w in range(N_THREADS):
        assert back[w] == [("state", w, i) for i in range(N_ITEMS) if i % 2]
    left = {cache.get(r) for r in cache.pending()}
    assert left == {("state", w, i) for w in range(N_THREADS)
                    for i in range(N_ITEMS) if not i % 2}
    assert len(cache) == 0


def test_channel_close_unblocks_send_and_recv_timeout_stays_empty():
    ch = CommunicationChannel("c", Executor("a"), Executor("b"),
                              CommType.BROADCAST, capacity=1)
    with pytest.raises(queue.Empty):
        ch.recv(timeout=0.1)
    ch.send("x")
    t, raised = _blocked(lambda: ch.send("y", timeout=30.0))
    ch.close()
    t.join(timeout=5.0)
    assert not t.is_alive() and raised == ["closed"]


def test_close_all_actors_unlinks_leaked_segments():
    seg = actors._shm_create(4096)
    assert os.path.exists(f"/dev/shm/{seg.name}")
    close_all_actors()
    assert not os.path.exists(f"/dev/shm/{seg.name}")


def _shm_layout(actors_mod, reward_cls, **kw):
    """The rings an ``ShmTransport`` builds: its threshold, parent ->
    child slots, the child -> parent segments and their bytes, and one
    call through it."""
    t = actors_mod.ShmTransport(reward_cls, kwargs={"n_per_prompt": 1},
                                spawn_timeout=60.0, call_timeout=60.0, **kw)
    try:
        return (t._threshold, len(t._tx_ring._slots),
                len(t._child_tx_segs), t._child_tx_segs[0].size >= 1 << 16
                and t._child_tx_segs[0].size < 1 << 17,
                actors_mod.ActorHandle(t).call("ping"))
    finally:
        t.close()


def test_shm_transport_explicit_arguments_win_over_env_as_jax(monkeypatch):
    """``ShmTransport(threshold=, slots=, slot_bytes=)``, after the
    reference's signature: each explicit argument wins over its
    environment variable, and the rings come out as the JAX package
    builds them from the same arguments."""
    from repro.core import actors as jactors
    from repro.core.executor import RewardExecutor as JReward
    monkeypatch.setenv("REPRO_SHM_THRESHOLD", "999999")
    monkeypatch.setenv("REPRO_SHM_SLOTS", "8")
    monkeypatch.setenv("REPRO_SHM_SLOT_BYTES", str(1 << 20))
    kw = dict(threshold=4096, slots=2, slot_bytes=1 << 16)
    got = _shm_layout(actors, RewardExecutor, **kw)
    assert got == _shm_layout(jactors, JReward, **kw)
    assert got == (4096, 2, 2, True, "reward")
    env = _shm_layout(actors, RewardExecutor)        # the variables again
    assert env[:3] == (999999, 8, 4)
