"""Quickstart: asynchronous off-policy RL (AIPO) on a toy arithmetic task,
on the PyTorch port (the twin of the JAX package's
``examples/quickstart.py``).

    PYTHONPATH=src python -m repro_torch.quickstart [--device cpu]

Builds the paper's pipeline -- generator, rule-based reward, AIPO trainer,
DDMA weight channel, single controller -- on a ~1M-param policy and runs
20 steps of the async schedule (staleness 1) on the sequential controller.
Watch mean_reward rise and mean_ratio hover just off 1.0: that is the
1-step off-policyness AIPO corrects.  The device defaults to CUDA.
"""
from __future__ import annotations

import argparse

from repro_torch.configs.llama_paper import smoke
from repro_torch.core.channels import CommType, CommunicationChannel, \
    WeightsCommunicationChannel
from repro_torch.core.controller import SyncExecutorController
from repro_torch.core.executor import GeneratorExecutor, RewardExecutor, \
    TrainerExecutor
from repro_torch.rl.data import ArithmeticTasks


def build(device=None, steps: int = 20) -> SyncExecutorController:
    """The quickstart's executors and channels behind one controller."""
    cfg = smoke().replace(n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
                          head_dim=32, d_ff=256, vocab=64)
    tasks = ArithmeticTasks(prompt_len=10, max_operand=9, ops="+")
    generator = GeneratorExecutor(cfg, tasks, n_prompts=8, n_per_prompt=4,
                                  max_new=6, temperature=1.0, device=device)
    trainer = TrainerExecutor(cfg, lr=2e-3, rho=4.0, clip_mode="aipo",
                              device=device)
    reward = RewardExecutor(n_per_prompt=4)
    return SyncExecutorController(
        executor_group=[generator, reward, trainer],
        communication_channels=[
            WeightsCommunicationChannel("policy_model", trainer, generator),
            CommunicationChannel("completions", generator, reward,
                                 CommType.GATHER),
            CommunicationChannel("completions_with_reward", reward, trainer,
                                 CommType.SCATTER),
        ],
        max_steps=steps, mode="async", staleness=1)


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    ap.add_argument("--steps", type=int, default=20)
    args = ap.parse_args(argv)
    controller = build(args.device, args.steps)
    history = controller.run()
    print(f"{'step':>4} {'reward':>7} {'loss':>8} {'ratio':>6} "
          f"{'wv':>3} {'time':>6}")
    for h in history:
        print(f"{h['step']:>4} {h['mean_reward']:>7.3f} "
              f"{h['loss']:>8.4f} {h['mean_ratio']:>6.3f} "
              f"{h['weight_version']:>3} {h['step_time']:>6.2f}s")
    tail = controller.trainer.call("recent_metrics", 5)
    print(f"wall={controller.stats['wall_s']:.1f}s (sequential schedule: "
          "no generator/trainer overlap)")
    print("last-5 train reward:",
          round(sum(m["mean_reward"] for m in tail) / max(len(tail), 1), 3))
    return history


if __name__ == "__main__":
    main()
