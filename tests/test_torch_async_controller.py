"""The port's threaded ``AsyncExecutorController``: bit for bit equal to
its own ``run_sequential`` at staleness 1 and 2, with chunk scheduling on
and off; against the JAX package's threaded controller from the
converted init; one entry point per controller, continuation, the
bounded-staleness schedule, failure propagation with every thread
joined, and the KL-reference pipeline.  After
``tests/test_async_controller.py``.  Every threaded run passes a
``timeout``, so a hang fails the test instead of the whole run."""
import threading
import time

import jax
import jax.numpy as jnp
import pytest

from repro.configs.llama_paper import smoke as jsmoke
from repro.core import ExecutorController as JController
from repro.core import GeneratorExecutor as JGenerator
from repro.core import RewardExecutor as JReward
from repro.core import TrainerExecutor as JTrainer
from repro.core.channels import CommType as JCommType
from repro.core.channels import CommunicationChannel as JChannel
from repro.core.channels import WeightsCommunicationChannel as JWeights
from repro.rl.data import ArithmeticTasks as JTasks
from repro.train.trainstep import init_train_state as jinit_state
from repro_torch import convert
from repro_torch.configs.llama_paper import smoke
from repro_torch.core import (AsyncExecutorController, CommType,
                              CommunicationChannel, ExecutorController,
                              GeneratorExecutor, RefPolicyExecutor,
                              RewardExecutor, TrainerExecutor,
                              WeightsCommunicationChannel, spawn_actor)
from repro_torch.rl.data import ArithmeticTasks
from repro_torch.train.optimizer import adam_init
from repro_torch.train.trainstep import TrainState

# training metrics that must agree exactly between threaded and sequential
METRIC_KEYS = ("loss", "grad_norm", "mean_ratio", "mean_reward")
TIMEOUT = 60.0


def micro_cfg(cfg):
    return cfg.replace(n_layers=1, d_model=32, n_heads=2, n_kv_heads=2,
                       head_dim=16, d_ff=64, vocab=64)


def build(seed=0, staleness=1, max_steps=4, gen_cls=None, trn_cls=None,
          chunk=0, timeout=TIMEOUT, pool=None):
    cfg = micro_cfg(smoke())
    tasks = ArithmeticTasks(prompt_len=8, max_operand=4, ops="+", seed=seed)
    gen = spawn_actor(gen_cls or GeneratorExecutor, cfg, tasks, n_prompts=4,
                      n_per_prompt=2, max_new=4, temperature=1.0, seed=seed,
                      chunk=chunk, device="cpu")
    rew = RewardExecutor(n_per_prompt=2)
    trn = (trn_cls or TrainerExecutor)(cfg, lr=5e-2, seed=seed,
                                       device="cpu")
    return ExecutorController(
        [gen, rew, trn],
        [WeightsCommunicationChannel("policy_model", trn, gen),
         CommunicationChannel("completions", gen, rew, CommType.GATHER),
         CommunicationChannel("completions_with_reward", rew, trn,
                              CommType.SCATTER)],
        max_steps=max_steps, mode="async", staleness=staleness,
        timeout=timeout, pool=pool)


def metrics(history):
    return [[h[k] for k in METRIC_KEYS] for h in history]


def wait_for_threads(before):
    deadline = time.monotonic() + 10
    while threading.active_count() > before and time.monotonic() < deadline:
        time.sleep(0.05)
    return threading.active_count() <= before


# ------------------------------------------------- threaded == sequential --

@pytest.mark.parametrize("staleness", [1, 2])
@pytest.mark.parametrize("chunk", [0, 2])
def test_threaded_matches_sequential_bit_for_bit(staleness, chunk):
    """Threads change wall-clock overlap, never numerics: weight versions
    are pinned by count.  ``chunk=2`` runs the pool's chunk-scheduled
    path in two resumable chunks a batch."""
    threaded = build(seed=11, staleness=staleness, chunk=chunk)
    assert isinstance(threaded, AsyncExecutorController)
    sequential = build(seed=11, staleness=staleness, chunk=chunk)
    ht = threaded.run()
    hs = sequential.run_sequential()
    assert metrics(ht) == metrics(hs)          # exact float equality
    assert [h["weight_version"] for h in ht] == \
        [h["weight_version"] for h in hs] == \
        [max(0, n - staleness) for n in range(4)]
    assert threaded.stats["overlap_s"] >= 0.0
    assert sequential.stats["overlap_s"] == 0.0


class FromJaxTrainer(TrainerExecutor):
    """The port's trainer started from the JAX package's init."""

    def __init__(self, cfg, jparams, **kw):
        super().__init__(cfg, device="cpu", **kw)
        self._jparams = jparams

    def init(self):
        params = convert.from_jax_numpy(self._jparams, device="cpu")
        self.state = TrainState(params, adam_init(params))
        self.set_output("policy_model", params)


def quick(cfg):
    return cfg.replace(n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
                       head_dim=32, d_ff=256, vocab=64)


def test_threaded_matches_jax_threaded():
    """Four threaded steps in both packages from the same init: the same
    tokens are sampled, so the rewards and versions are equal, and the
    train metrics agree to 1e-4.  The quickstart's widths, tasks and lr;
    seed 5 draws a rewarded first batch."""
    seed, steps = 5, 4
    cfg = quick(jsmoke())
    jparams = jax.device_get(
        jinit_state(cfg, jax.random.PRNGKey(seed), jnp.float32).params)
    jgen = JGenerator(cfg, JTasks(prompt_len=10, max_operand=9, ops="+",
                                  seed=seed),
                      n_prompts=4, n_per_prompt=4, max_new=6, seed=seed)
    jrew = JReward(n_per_prompt=4)
    jtrn = JTrainer(cfg, lr=2e-3, seed=seed)
    jctl = JController(
        [jgen, jrew, jtrn],
        [JWeights("policy_model", jtrn, jgen),
         JChannel("completions", jgen, jrew, JCommType.GATHER),
         JChannel("completions_with_reward", jrew, jtrn, JCommType.SCATTER)],
        max_steps=steps, mode="async", staleness=1, timeout=TIMEOUT)
    tcfg = quick(smoke())
    gen = GeneratorExecutor(tcfg, ArithmeticTasks(
        prompt_len=10, max_operand=9, ops="+", seed=seed),
        n_prompts=4, n_per_prompt=4, max_new=6, seed=seed, device="cpu")
    rew = RewardExecutor(n_per_prompt=4)
    trn = FromJaxTrainer(tcfg, jparams, lr=2e-3, seed=seed)
    tctl = ExecutorController(
        [gen, rew, trn],
        [WeightsCommunicationChannel("policy_model", trn, gen),
         CommunicationChannel("completions", gen, rew, CommType.GATHER),
         CommunicationChannel("completions_with_reward", rew, trn,
                              CommType.SCATTER)],
        max_steps=steps, mode="async", staleness=1, timeout=TIMEOUT)
    jh, th = jctl.run(), tctl.run()
    assert jh[0]["mean_reward"] > 0
    for j, t in zip(jh, th):
        for k in ("step", "weight_version", "trainer_version",
                  "sample_staleness", "staleness_bound", "generator",
                  "mean_reward"):
            assert t[k] == j[k], k
        for k in ("loss", "grad_norm", "mean_ratio", "mean_logp"):
            assert abs(t[k] - j[k]) <= 1e-4 * max(1.0, abs(j[k])), k
    assert set(tctl.stats) == set(jctl.stats)


# ------------------------------------------------------- entry points --

def test_mixing_threaded_and_sequential_runs_raises():
    ctl = build(seed=2, max_steps=2)
    ctl.run()
    with pytest.raises(RuntimeError, match="fresh controller"):
        ctl.run_sequential()
    ctl2 = build(seed=2, max_steps=2)
    ctl2.run_sequential()
    with pytest.raises(RuntimeError, match="fresh controller"):
        ctl2.run()


def test_continuation_matches_single_run():
    """run() twice continues the schedule where it left off: counters,
    channel queues and key state persist."""
    split = build(seed=5, max_steps=2)
    split.run()
    split.run()
    whole = build(seed=5, max_steps=4)
    whole.run()
    assert metrics(split.history) == metrics(whole.history)
    assert [h["step"] for h in split.history] == [0, 1, 2, 3]


def test_weight_version_schedule_and_history():
    s = 2
    ctl = build(seed=3, staleness=s, max_steps=5)
    hist = ctl.run()
    for n, h in enumerate(hist):
        assert h["weight_version"] == max(0, n - s)
        assert h["trainer_version"] == n + 1
        assert h["sample_staleness"] == min(n, s) <= h["staleness_bound"]
        assert h["generator"] == "generator"
        assert h["queue_depth"] >= 0
        assert h["gen_idle_s"] >= 0 and h["train_idle_s"] >= 0
    assert max(ctl.staleness_hist) <= s
    assert sum(ctl.staleness_hist.values()) == len(hist)
    st = ctl.stats
    for key in ("wall_s", "gen_busy_s", "gen_worker_s", "train_busy_s",
                "overlap_s", "gen_idle_s", "train_idle_s", "publish_s",
                "publish_overlap_s", "publish_wait_s"):
        assert key in st
    assert st["gen_busy_s"] > 0 and st["train_busy_s"] > 0
    assert st["gen_busy_s"] <= st["wall_s"]
    assert ctl._fabric._thread is None            # quiesced after the run


def test_two_live_weight_channels_both_drained():
    """Every weight channel into the generator is drained each version,
    or its bounded queue would wedge the fabric's send."""
    cfg = micro_cfg(smoke())
    gen = GeneratorExecutor(cfg, ArithmeticTasks(prompt_len=8, max_operand=4,
                                                 ops="+", seed=2),
                            n_prompts=4, n_per_prompt=2, max_new=4, seed=2,
                            device="cpu")
    rew = RewardExecutor(n_per_prompt=2)
    trn = TrainerExecutor(cfg, lr=5e-2, seed=2, device="cpu")
    ctl = ExecutorController(
        [gen, rew, trn],
        [WeightsCommunicationChannel("policy_model", trn, gen),
         WeightsCommunicationChannel("policy_model", trn, gen),
         CommunicationChannel("completions", gen, rew, CommType.GATHER),
         CommunicationChannel("completions_with_reward", rew, trn,
                              CommType.SCATTER)],
        max_steps=8, mode="async", staleness=1, timeout=TIMEOUT)
    assert len(ctl.run()) == 8
    for ch in ctl._live_weight_channels:
        assert ch.pending() <= ctl.staleness + 1


def _build_kl(seed, staleness):
    cfg = micro_cfg(smoke())
    gen = GeneratorExecutor(cfg, ArithmeticTasks(prompt_len=8, max_operand=4,
                                                 ops="+", seed=seed),
                            n_prompts=4, n_per_prompt=2, max_new=4,
                            seed=seed, chunk=2, device="cpu")
    ref = RefPolicyExecutor(cfg)
    rew = RewardExecutor(n_per_prompt=2)
    trn = TrainerExecutor(cfg, lr=5e-2, kl_coef=0.1, seed=seed,
                          device="cpu")
    return ExecutorController(
        [gen, ref, rew, trn],
        [WeightsCommunicationChannel("policy_model", trn, gen),
         WeightsCommunicationChannel("policy_model", trn, ref),
         CommunicationChannel("completions", gen, ref, CommType.BROADCAST),
         CommunicationChannel("completions_with_ref", ref, rew,
                              CommType.GATHER),
         CommunicationChannel("completions_with_reward", rew, trn,
                              CommType.SCATTER)],
        max_steps=4, mode="async", staleness=staleness, timeout=TIMEOUT)


@pytest.mark.parametrize("staleness", [1, 3])
def test_kl_reference_pipeline_threaded_matches_sequential(staleness):
    """A weight channel into the frozen reference is serviced on the
    consumer thread on the sequential path's delayed schedule."""
    threaded, sequential = _build_kl(9, staleness), _build_kl(9, staleness)
    ht = threaded.run()
    hs = sequential.run_sequential()
    assert metrics(ht) == metrics(hs)
    assert [h["weight_version"] for h in ht] == \
        [max(0, n - staleness) for n in range(4)]


# -------------------------------------------------- failure propagation --

class _ExplodingGenerator(GeneratorExecutor):
    def begin_batch(self, batch_index=None):
        if self.curr_step >= 1:
            raise RuntimeError("generator exploded")
        return super().begin_batch(batch_index)


class _ExplodingTrainer(TrainerExecutor):
    def step(self):
        if self.curr_step >= 2:
            raise RuntimeError("trainer exploded")
        return super().step()


@pytest.mark.parametrize("where", ["generator", "trainer"])
def test_exceptions_propagate_and_every_thread_joins(where):
    """A worker's or the consumer's exception re-raises on the caller,
    the comms close so every blocked peer unwinds, and no thread (the
    fabric's publisher included) outlives the run."""
    before = threading.active_count()
    if where == "generator":
        ctl = build(max_steps=6, gen_cls=_ExplodingGenerator)
    else:
        ctl = build(max_steps=8, trn_cls=_ExplodingTrainer)
    with pytest.raises(RuntimeError, match=f"{where} exploded"):
        ctl.run()
    assert wait_for_threads(before)
    assert ctl._sample_queue.closed             # shutdown() ran
    assert all(ch.closed for ch in ctl.channels)
