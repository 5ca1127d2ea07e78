"""Quickstart: asynchronous off-policy RL (AIPO) on a toy arithmetic task,
on the PyTorch port (the twin of the JAX package's
``examples/quickstart.py``).

    PYTHONPATH=src python -m repro_torch.quickstart [--device cpu]

Builds the paper's pipeline -- generator, rule-based reward, AIPO trainer,
DDMA weight channel, single controller -- on a ~1M-param policy and runs
20 async RL steps on the threaded controller: the generator on a worker
thread, reward and trainer on the consumer thread, staleness 1.  Watch
mean_reward rise and mean_ratio hover just off 1.0: that is the 1-step
off-policyness AIPO corrects.  The device defaults to CUDA.

The run is traced (``repro_torch.obs``): the summary printed at the end
comes from the same span stream ``obs.trace.export`` writes for Perfetto.
"""
from __future__ import annotations

import argparse

from repro_torch.configs.llama_paper import smoke
from repro_torch.core import (AsyncExecutorController, CommType,
                              CommunicationChannel, ExecutorController,
                              GeneratorExecutor, RewardExecutor,
                              TrainerExecutor, WeightsCommunicationChannel,
                              close_all_actors, spawn_actor)
from repro_torch.obs import trace as obs_trace
from repro_torch.obs.__main__ import summary_lines
from repro_torch.rl.data import ArithmeticTasks


def build(device=None, steps: int = 20,
          timeout: float = 600.0) -> AsyncExecutorController:
    """The quickstart's executors and channels behind the threaded
    controller."""
    cfg = smoke().replace(n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
                          head_dim=32, d_ff=256, vocab=64)
    tasks = ArithmeticTasks(prompt_len=10, max_operand=9, ops="+")
    # transport=None reads $REPRO_TRANSPORT: REPRO_TRANSPORT=proc puts the
    # generator and the trainer each in a spawned child
    generator = spawn_actor(GeneratorExecutor, cfg, tasks, n_prompts=8,
                            n_per_prompt=4, max_new=6, temperature=1.0,
                            device=device)
    trainer = spawn_actor(TrainerExecutor, cfg, lr=2e-3, rho=4.0,
                          clip_mode="aipo", device=device)
    reward = RewardExecutor(n_per_prompt=4)
    return ExecutorController(
        executor_group=[generator, reward, trainer],
        communication_channels=[
            WeightsCommunicationChannel("policy_model", trainer, generator),
            CommunicationChannel("completions", generator, reward,
                                 CommType.GATHER),
            CommunicationChannel("completions_with_reward", reward, trainer,
                                 CommType.SCATTER),
        ],
        max_steps=steps, mode="async", staleness=1, timeout=timeout)


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    ap.add_argument("--steps", type=int, default=20)
    args = ap.parse_args(argv)
    was_on = obs_trace.enabled()
    tracer = obs_trace.enable("controller")
    controller = build(args.device, args.steps)
    try:
        history = controller.run()
        tail = controller.trainer.call("recent_metrics", 5)
    finally:
        close_all_actors()
        if not was_on:          # a caller in the same process keeps its
            obs_trace.disable()  # zero-cost disabled tracer
    print(f"{'step':>4} {'reward':>7} {'loss':>8} {'ratio':>6} "
          f"{'wv':>3} {'time':>6}")
    for h in history:
        print(f"{h['step']:>4} {h['mean_reward']:>7.3f} "
              f"{h['loss']:>8.4f} {h['mean_ratio']:>6.3f} "
              f"{h['weight_version']:>3} {h['step_time']:>6.2f}s")
    s = controller.stats
    print(f"wall={s['wall_s']:.1f}s  gen/train overlap={s['overlap_s']:.1f}s "
          "(generator and trainer run on their own threads)")
    for line in summary_lines(tracer.events()):
        print(line)
    print("last-5 train reward:",
          round(sum(m["mean_reward"] for m in tail) / max(len(tail), 1), 3))
    return history


if __name__ == "__main__":
    main()
