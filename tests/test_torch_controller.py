"""The port's trainer executor, weight sync and sequential controller.

Against the JAX package on the CPU: one trainer step on the batch the JAX
generator and reward executors produce, a whole async-schedule run from
the same init, and the int8 fake-quantization.  Within the port: the
controller's staleness contract, the snapshot isolation of weight
hand-offs, the channels and buffers.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.llama_paper import smoke
from repro.core import controller as jctl
from repro.core import ddma as jddma
from repro.core import executor as jex
from repro.core.channels import CommType as JCommType
from repro.core.channels import CommunicationChannel as JChannel
from repro.core.channels import WeightsCommunicationChannel as JWeights
from repro.rl.data import ArithmeticTasks as JTasks
from repro.train.trainstep import init_train_state as jinit_state
from repro_torch import convert
from repro_torch import quickstart
from repro_torch.configs.llama_paper import smoke as tsmoke
from repro_torch.core import ddma
from repro_torch.core import executor as tex
from repro_torch.core.actors import as_handle, spawn_actor
from repro_torch.core.channels import CommType, CommunicationChannel, \
    WeightsCommunicationChannel
from repro_torch.core.controller import AsyncExecutorController, \
    ExecutorController, SyncExecutorController
from repro_torch.core.offpolicy import Closed, PartialRolloutCache, \
    StalenessBuffer
from repro_torch.models import init_params
from repro_torch.rl.data import ArithmeticTasks
from repro_torch.rl.rollout import start_rollout
from repro_torch.train.optimizer import adam_init, tree_leaves
from repro_torch.train.trainstep import TrainState

METRIC_KEYS = ("loss", "grad_norm", "mean_ratio", "clip_frac", "mean_logp",
               "mean_adv", "total_loss")


def micro(cfg):
    return cfg.replace(n_layers=1, d_model=32, n_heads=2, n_kv_heads=2,
                       head_dim=16, d_ff=64, vocab=64)


def quick(cfg):
    """The widths of the quickstart."""
    return cfg.replace(n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
                       head_dim=32, d_ff=256, vocab=64)


class FromJaxTrainer(tex.TrainerExecutor):
    """The port's trainer started from the JAX package's init."""

    def __init__(self, cfg, jparams, **kw):
        super().__init__(cfg, device="cpu", **kw)
        self._jparams = jparams

    def init(self):
        params = convert.from_jax_numpy(self._jparams, device="cpu")
        self.state = TrainState(params, adam_init(params))
        self.set_output("policy_model", params)


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-12)


def test_trainer_step_matches_jax():
    """The JAX generator -> reward batch of step 0 through both packages'
    ``TrainerExecutor.step``, the port's state converted from the JAX
    init: equal metrics and params.  The quickstart's widths and tasks;
    seed 1 draws a batch with rewards, so the gradient is not zero."""
    cfg, tcfg = quick(smoke()), quick(tsmoke())
    jgen = jex.GeneratorExecutor(
        cfg, JTasks(prompt_len=10, max_operand=9, ops="+", seed=1),
        n_prompts=4, n_per_prompt=4, max_new=6, seed=1)
    jtrn = jex.TrainerExecutor(cfg, seed=0)
    jtrn.init()
    jgen.set_weights(jtrn.get_model(), version=0)
    jrew = jex.RewardExecutor(n_per_prompt=4)
    jrew.put_input("completions", jgen.step())
    scored = jrew.step()
    assert scored["mean_reward"] > 0
    ttrn = FromJaxTrainer(tcfg, jax.device_get(jtrn.get_model()))
    ttrn.init()
    tscored = {k: (torch.as_tensor(np.array(v)) if k != "mean_reward"
                   else v) for k, v in scored.items()}
    jtrn.put_input("completions_with_reward", scored)
    ttrn.put_input("completions_with_reward", tscored)
    jm, tm = jtrn.step(), ttrn.step()
    assert set(jm) == set(tm)
    for k in METRIC_KEYS:
        assert _rel(tm[k], jm[k]) <= 1e-5 or abs(tm[k] - jm[k]) < 1e-7, k
    assert tm["mean_reward"] == jm["mean_reward"]
    # lr 1e-3: Adam moves each param by about lr whatever its gradient's
    # size, so a gradient element near eps = 1e-8, whose 1e-6 relative
    # error is a visible fraction of itself, can move its param by a
    # fraction of lr; every other param agrees within 1e-6
    d = np.concatenate([
        np.abs(t.numpy() - np.asarray(j)).ravel() for t, j in
        zip(tree_leaves(ttrn.get_model()),
            jax.tree.leaves(jax.device_get(jtrn.get_model())))])
    assert d.max() <= 1e-4 and (d > 1e-6).mean() <= 1e-4


def _jax_ctl(cfg, staleness, steps, seed, mode="async"):
    tasks = JTasks(prompt_len=10, max_operand=9, ops="+", seed=seed)
    gen = jex.GeneratorExecutor(cfg, tasks, n_prompts=4, n_per_prompt=4,
                                max_new=6, seed=seed)
    rew = jex.RewardExecutor(n_per_prompt=4)
    trn = jex.TrainerExecutor(cfg, lr=2e-3, seed=seed)
    return jctl.SyncExecutorController(
        [gen, rew, trn],
        [JWeights("policy_model", trn, gen),
         JChannel("completions", gen, rew, JCommType.GATHER),
         JChannel("completions_with_reward", rew, trn, JCommType.SCATTER)],
        max_steps=steps, mode=mode, staleness=staleness)


def _port_ctl(cfg, staleness, steps, seed, mode="async", trainer=None):
    tasks = ArithmeticTasks(prompt_len=10, max_operand=9, ops="+",
                            seed=seed)
    gen = tex.GeneratorExecutor(cfg, tasks, n_prompts=4, n_per_prompt=4,
                                max_new=6, seed=seed, device="cpu")
    rew = tex.RewardExecutor(n_per_prompt=4)
    trn = trainer or tex.TrainerExecutor(cfg, lr=2e-3, seed=seed,
                                         device="cpu")
    return SyncExecutorController(
        [gen, rew, trn],
        [WeightsCommunicationChannel("policy_model", trn, gen),
         CommunicationChannel("completions", gen, rew, CommType.GATHER),
         CommunicationChannel("completions_with_reward", rew, trn,
                              CommType.SCATTER)],
        max_steps=steps, mode=mode, staleness=staleness)


@pytest.mark.parametrize("mode,staleness", [("async", 1), ("sync", 0)])
def test_schedule_matches_jax(mode, staleness):
    """Three steps of the whole loop -- generate, score, train, sync --
    in both packages from the same init: the same tokens are sampled, so
    the rewards are equal, and the train metrics agree.  The quickstart's
    widths, tasks and lr; seed 5 draws a rewarded first batch."""
    seed = 5
    cfg = quick(smoke())
    jparams = jax.device_get(
        jinit_state(cfg, jax.random.PRNGKey(seed), jnp.float32).params)
    jh = _jax_ctl(cfg, staleness, 3, seed, mode).run()
    trn = FromJaxTrainer(quick(tsmoke()), jparams, lr=2e-3, seed=seed)
    th = _port_ctl(quick(tsmoke()), staleness, 3, seed, mode, trn).run()
    assert jh[0]["mean_reward"] > 0
    for j, t in zip(jh, th):
        for k in ("step", "weight_version", "trainer_version",
                  "sample_staleness", "mean_reward"):
            assert t[k] == j[k], k
        for k in ("loss", "grad_norm", "mean_ratio", "mean_logp"):
            assert abs(t[k] - j[k]) <= 1e-4 * max(1.0, abs(j[k])), k


@pytest.mark.parametrize("staleness", [1, 2])
def test_weight_version_schedule(staleness):
    ctl = _port_ctl(micro(tsmoke()), staleness, 4, seed=3)
    hist = ctl.run()
    for n, h in enumerate(hist):
        assert h["weight_version"] == max(0, n - staleness)
        assert h["trainer_version"] == n + 1
        assert h["sample_staleness"] == min(n, staleness)
    assert sum(ctl.staleness_hist.values()) == 4
    # a second run continues the schedule
    more = ctl.run()
    assert [h["step"] for h in more[4:]] == [4, 5, 6, 7]
    assert all(h["weight_version"] == h["step"] - staleness
               for h in more[4:])


def test_sync_mode_delivers_fresh_weights():
    ctl = _port_ctl(micro(tsmoke()), 3, 3, seed=1, mode="sync")
    assert ctl.staleness == 0
    hist = ctl.run()
    assert [h["weight_version"] for h in hist] == [0, 1, 2]
    assert all(h["sample_staleness"] == 0 for h in hist)


def test_staleness_bound_violation_raises():
    ctl = _port_ctl(micro(tsmoke()), 1, 1, seed=1)
    ctl.init()
    with pytest.raises(RuntimeError, match="staleness bound violated"):
        ctl._record(5, 0.0, weight_version=3)
    ctl._record(5, 0.0, weight_version=4)


def test_executor_controller_modes():
    """mode="async" builds the threaded controller; ``supervise`` takes
    True, a ``RestartPolicy`` or a ``Supervisor`` (see
    tests/test_torch_supervision.py), ``checkpoint_every`` is kept, and an
    unknown transport is refused (the process transports run: see
    tests/test_torch_actors.py)."""
    cfg = micro(tsmoke())
    ctl = _port_ctl(cfg, 1, 1, seed=1)
    threaded = ExecutorController(list(ctl.executors.values()),
                                  ctl.channels, 1, mode="async")
    assert isinstance(threaded, AsyncExecutorController)
    assert isinstance(ExecutorController(
        [tex.RewardExecutor(n_per_prompt=1)], [], 1, mode="sync"),
        SyncExecutorController)
    args = ([tex.RewardExecutor(n_per_prompt=1)], [], 1)
    with pytest.raises(ValueError, match="generator and a trainer"):
        ExecutorController(*args, mode="async")
    from repro_torch.core import RestartPolicy, Supervisor
    assert isinstance(ExecutorController(*args, mode="sync", supervise=True)
                      .supervisor, Supervisor)
    policy = RestartPolicy(max_restarts=1)
    assert ExecutorController(*args, mode="sync", supervise=policy) \
        .supervisor.default is policy
    sup = Supervisor()
    assert ExecutorController(*args, mode="sync", supervise=sup) \
        .supervisor is sup
    assert ExecutorController(*args, mode="sync").supervisor is None
    ck = ExecutorController(*args, mode="sync", checkpoint_every=2,
                            checkpoint_path="ck")
    assert (ck.checkpoint_every, ck.checkpoint_path) == (2, "ck")
    with pytest.raises(ValueError, match="unknown transport"):
        spawn_actor(tex.RewardExecutor, n_per_prompt=1, transport="rdma")
    with pytest.raises(ValueError, match="unique"):
        SyncExecutorController([tex.RewardExecutor(n_per_prompt=1)] * 2,
                               [], 1)
    gens = [tex.GeneratorExecutor(cfg, ArithmeticTasks(), n_prompts=1,
                                  n_per_prompt=1, max_new=1, device="cpu",
                                  name=f"g{i}") for i in range(2)]
    with pytest.raises(ValueError, match="single generator"):
        SyncExecutorController(gens, [], 1).run()


def _fingerprint(params):
    return [t.clone() for t in tree_leaves(params)]


def test_weight_snapshots_are_isolated():
    """A delivered snapshot is never changed by later trainer steps: the
    generator's version n-1 tensors stay bit-equal after step n, and
    differ from the trainer's version n."""
    ctl = _port_ctl(micro(tsmoke()), 1, 2, seed=2)
    ctl.run()                                     # trainer at version 2
    gen = ctl.generator.transport.executor
    trn = ctl.trainer.transport.executor
    ctl._sync_weights(2)                          # generator gets version 1
    assert gen.weight_version == 1
    held = _fingerprint(gen.params)
    v2 = tree_leaves(trn.get_model())
    assert any(not torch.equal(a, b) for a, b in zip(held, v2))
    gen.step()
    ctl._pipeline()                               # trainer -> version 3
    assert all(torch.equal(a, b) for a, b in
               zip(held, tree_leaves(gen.params)))
    assert any(not torch.equal(a, b) for a, b in
               zip(held, tree_leaves(trn.get_model())))


def test_trainer_executor_surface(tmp_path):
    cfg = micro(tsmoke())
    trn = tex.TrainerExecutor(cfg, device="cpu")
    assert trn.dtype == torch.float32 and trn.role == "trainer"
    trn.init()
    assert trn.get_output("policy_model") is trn.get_model()
    assert trn.last_metrics() == {} and trn.recent_metrics(3) == []
    trn.save_checkpoint(str(tmp_path / "ck"), 0)      # {path}/{name}_{step}
    assert sorted(p.name for p in (tmp_path / "ck").iterdir()) == [
        "trainer_0.json", "trainer_0.npz"]


# ------------------------------------------------------ weights and int8 --

def test_quantize_dequant_matches_jax():
    jp = jax.device_get(jinit_state(smoke(), jax.random.PRNGKey(1),
                                    jnp.float32).params)
    want = jax.device_get(jddma.quantize_dequant(jp))
    got = ddma.quantize_dequant(convert.from_jax_numpy(jp, device="cpu"))
    for t, j in zip(tree_leaves(got), jax.tree.leaves(want)):
        assert np.array_equal(t.numpy(), np.asarray(j))
    w = np.random.default_rng(0).standard_normal((300, 70)).astype(np.float32)
    jq, js = jddma.quantize_int8(jnp.asarray(w))
    tq, tsc = ddma.quantize_int8(torch.as_tensor(w))
    assert tq.dtype == torch.int8
    assert np.array_equal(tq.numpy(), np.asarray(jq))
    assert np.array_equal(tsc.numpy(), np.asarray(js))
    back = ddma.dequantize_int8(tq, tsc, torch.float32)
    assert np.array_equal(back.numpy(),
                          np.asarray(jddma.dequantize_int8(jq, js,
                                                           jnp.float32)))


def test_quantized_generator_runs():
    cfg = micro(tsmoke())
    params = init_params(cfg, seed=0, dtype=torch.float32, device="cpu")
    gen = tex.GeneratorExecutor(cfg, ArithmeticTasks(), n_prompts=2,
                                n_per_prompt=2, max_new=3, quantize=True,
                                device="cpu")
    gen.set_weights(params, version=0)
    assert all(a.shape == b.shape and a.dtype == b.dtype for a, b in
               zip(tree_leaves(gen.params), tree_leaves(params)))
    out = gen.step()
    assert out["tokens"].shape == (4, ArithmeticTasks().prompt_len + 3)
    # at the smoke widths the stacked matmul weights reach the 64k-element
    # threshold and go through int8
    big = tex.GeneratorExecutor(tsmoke(), ArithmeticTasks(), n_prompts=1,
                                n_per_prompt=1, max_new=1, quantize=True,
                                device="cpu")
    bp = init_params(tsmoke(), seed=0, dtype=torch.float32, device="cpu")
    big.set_weights(bp, version=0)
    assert not torch.equal(big.params["layers"]["mlp"]["w_up"],
                           bp["layers"]["mlp"]["w_up"])


def test_weight_sync_paths():
    params = {"a": torch.randn(3, 4), "b": {"c": torch.randn(5)}}
    same = ddma.ddma_weight_sync(params, torch.device("cpu"))
    assert same["a"] is params["a"]             # same device: no copy
    ps = ddma.ps_weight_sync(params, torch.device("cpu"))
    assert ps["a"] is not params["a"] and torch.equal(ps["a"], params["a"])
    secs, out = ddma.timed_sync(ddma.ps_weight_sync, params,
                                torch.device("cpu"), repeats=2)
    assert secs >= 0 and torch.equal(out["b"]["c"], params["b"]["c"])


def test_channel_prepare_routes_weights_through_sync():
    cfg = micro(tsmoke())
    gen = tex.GeneratorExecutor(cfg, ArithmeticTasks(), n_prompts=1,
                                n_per_prompt=1, max_new=1, device="cpu")
    rew = tex.RewardExecutor(n_per_prompt=1)
    params = {"w": torch.randn(2, 2)}
    ps = CommunicationChannel("policy_model", rew, gen,
                              CommType.PS_WEIGHTS_UPDATE)
    ps.deliver(params, version=3)
    assert gen.weight_version == 3 and gen.params["w"] is not params["w"]
    dd = WeightsCommunicationChannel("policy_model", rew, gen)
    dd.deliver(params, version=4)
    assert gen.params["w"] is params["w"]
    dd.deliver({"w": torch.zeros(2, 2)}, version=2)   # older: dropped
    assert gen.weight_version == 4 and gen.params["w"] is params["w"]
    data = CommunicationChannel("completions", gen, rew, CommType.GATHER)
    data.deliver({"x": 1})
    assert rew.get_input("completions") == {"x": 1}


def test_stage_and_commit_weights():
    cfg = micro(tsmoke())
    gen = tex.GeneratorExecutor(cfg, ArithmeticTasks(), n_prompts=1,
                                n_per_prompt=1, max_new=1, device="cpu")
    p1, p2 = {"w": torch.ones(1)}, {"w": torch.zeros(1)}
    gen.stage_weights(p1, 1)
    gen.stage_weights(p1, 1)
    gen.stage_weights(p2, 2)
    assert gen.staged_versions() == [1, 2]
    gen.commit_weights(1)
    assert gen.params is p1 and gen.staged_versions() == [1, 2]
    gen.commit_weights(1)
    gen.commit_weights(2)
    assert gen.params is p2 and gen.staged_versions() == []
    gen.configure(temperature=0.5)
    assert gen.temperature == 0.5
    with pytest.raises(AttributeError):
        gen.configure(no_such_field=1)


def test_handles_are_canonical():
    rew = tex.RewardExecutor(n_per_prompt=1)
    h = as_handle(rew)
    assert as_handle(rew) is h and as_handle(h) is h
    assert h.name == "reward" and h.role == "reward"
    assert h.call("n_per_prompt") == 1
    h.cast("set_step", 7)
    assert h.call("curr_step") == 7
    with pytest.raises(TypeError):
        h.call("n_per_prompt", 2)


# ------------------------------------------------- buffers and channels --

def test_staleness_buffer_delivers_tick_minus_staleness():
    for s in (1, 2, 3):
        buf = StalenessBuffer(delay=s)
        buf.push(0, "w0")
        assert buf.pop() is None
        for tick in range(1, 8):
            buf.push(tick, f"w{tick}")
            released = buf.pop()
            if tick < s:
                assert released is None
            else:
                assert released == (tick - s, f"w{tick - s}")


def test_buffer_and_channel_close():
    buf = StalenessBuffer(delay=0, max_size=1)
    buf.push(0, "a")
    with pytest.raises(TimeoutError):
        buf.push(1, "b", timeout=0.01)
    buf.close()
    assert buf.pop_wait(timeout=1) == (0, "a")   # queued entries drain
    with pytest.raises(Closed):
        buf.pop_wait(timeout=1)
    with pytest.raises(Closed):
        buf.push(2, "c")

    rew = tex.RewardExecutor(n_per_prompt=1)
    ch = CommunicationChannel("completions", rew, rew, CommType.GATHER,
                              capacity=2)
    ch.send({"n": 1})
    ch.send({"n": 2})
    assert ch.pending() == 2
    assert ch.recv(timeout=1) == (None, {"n": 1})
    assert rew.get_input("completions") == {"n": 1}
    assert ch.drain() == 1 and ch.pending() == 0
    ch.close()
    assert ch.closed
    with pytest.raises(Closed):
        ch.send({"n": 3})
    with pytest.raises(Closed):
        ch.recv(timeout=1)


def test_partial_rollout_cache():
    cfg = micro(tsmoke())
    params = init_params(cfg, seed=0, dtype=torch.float32, device="cpu")
    prompts = torch.as_tensor(ArithmeticTasks(prompt_len=8).sample(2, 1)
                              .prompts)
    cache = PartialRolloutCache()
    st = start_rollout(params, cfg, prompts, 12)
    rid = cache.put(st)
    assert cache.pending() == [rid] and len(cache) == 1
    assert not PartialRolloutCache.finished_mask(st).any()
    st.done[1] = True
    assert PartialRolloutCache.finished_mask(st).tolist() == [False, True]
    full = start_rollout(params, cfg, prompts, 8)
    assert PartialRolloutCache.finished_mask(full).all()
    assert cache.get(rid) is st and len(cache) == 0


def test_quickstart_runs_on_the_cpu(capsys):
    history = quickstart.main(["--device", "cpu", "--steps", "3"])
    assert [h["weight_version"] for h in history] == [0, 0, 1]
    assert all(np.isfinite(h["loss"]) for h in history)
    assert "last-5 train reward" in capsys.readouterr().out
