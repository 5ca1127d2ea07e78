"""The quickstart, port against JAX (ROADMAP A6): the quickstart's own
config, seed and 20 steps on both packages' threaded controllers, the
port's trainer started from the JAX init.  The same tokens are sampled
at every step, so the rewards and the version fields are equal; the
teacher-forced log-probs (``mean_logp``) and the per-step loss agree to
1e-4."""
import jax
import jax.numpy as jnp

from repro.configs.llama_paper import smoke as jsmoke
from repro.core import (CommType, CommunicationChannel, ExecutorController,
                        GeneratorExecutor, RewardExecutor, TrainerExecutor,
                        WeightsCommunicationChannel, spawn_actor)
from repro.rl.data import ArithmeticTasks
from repro.train.trainstep import init_train_state as jinit_state
from repro_torch import convert, quickstart
from repro_torch.train.optimizer import adam_init
from repro_torch.train.trainstep import TrainState

STEPS = 20


def jax_quickstart():
    """``examples/quickstart.py``'s controller, as its ``main`` builds it
    (in process)."""
    cfg = jsmoke().replace(n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
                           head_dim=32, d_ff=256, vocab=64)
    tasks = ArithmeticTasks(prompt_len=10, max_operand=9, ops="+")
    generator = spawn_actor(GeneratorExecutor, cfg, tasks, n_prompts=8,
                            n_per_prompt=4, max_new=6, temperature=1.0,
                            transport="inproc")
    trainer = spawn_actor(TrainerExecutor, cfg, lr=2e-3, rho=4.0,
                          clip_mode="aipo", transport="inproc")
    reward = RewardExecutor(n_per_prompt=4)
    return cfg, ExecutorController(
        executor_group=[generator, reward, trainer],
        communication_channels=[
            WeightsCommunicationChannel("policy_model", trainer, generator),
            CommunicationChannel("completions", generator, reward,
                                 CommType.GATHER),
            CommunicationChannel("completions_with_reward", reward, trainer,
                                 CommType.SCATTER),
        ],
        max_steps=STEPS, mode="async", staleness=1, timeout=60.0)


def test_quickstart_matches_jax():
    cfg, jctl = jax_quickstart()
    # the JAX trainer's own init: TrainerExecutor(seed=0)
    jparams = jax.device_get(
        jinit_state(cfg, jax.random.PRNGKey(0), jnp.float32).params)
    tctl = quickstart.build("cpu", STEPS, timeout=60.0)
    trn = tctl.trainer.transport.executor

    def init_from_jax():
        params = convert.from_jax_numpy(jparams, device="cpu")
        trn.state = TrainState(params, adam_init(params))
        trn.set_output("policy_model", params)
    trn.init = init_from_jax
    jh, th = jctl.run(), tctl.run()
    assert len(jh) == len(th) == STEPS
    assert sum(h["mean_reward"] for h in jh) > 0
    for j, t in zip(jh, th):
        for k in ("step", "weight_version", "trainer_version",
                  "sample_staleness", "staleness_bound", "mean_reward"):
            assert t[k] == j[k], (t["step"], k)
        for k in ("loss", "mean_logp", "mean_ratio", "grad_norm"):
            assert abs(t[k] - j[k]) <= 1e-4 * max(1.0, abs(j[k])), \
                (t["step"], k, t[k], j[k])
    assert [h["weight_version"] for h in th] == \
        [max(0, n - 1) for n in range(STEPS)]
