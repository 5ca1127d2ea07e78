"""Partial-rollout scheduling, two ways (paper Sec. 4.2), on the PyTorch
port (the twin of the JAX package's ``examples/serve_partial_rollouts.py``).

Part 1 -- serving: a ``RolloutScheduler`` drives one generator over a
work heap of resumable requests with very different finish times.  A
most-progress-first priority harvests short requests the moment they
complete while the straggler keeps its KV cache and cursor parked in the
``PartialRolloutCache`` between chunks -- no request waits for the batch.

Part 2 -- training: the generator pool end to end.  Three generator
workers (one with injected straggler latency) fan into the async
controller's sample queue under an ``AdaptiveStalenessController``; the
run prints the observed staleness histogram, the bound trajectory and
the overlap stats.

    PYTHONPATH=src python -m repro_torch.serve_partial_rollouts [--device cpu]

The device defaults to CUDA.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs.llama_paper import smoke
from repro_torch.core import (AdaptiveStalenessController, CommType,
                              CommunicationChannel, ExecutorController,
                              GeneratorExecutor, PartialRolloutCache,
                              PoolConfig, RewardExecutor, TrainerExecutor,
                              build_generator_pool, close_all_actors,
                              spawn_actor)
from repro_torch.models import init_params
from repro_torch.rl.data import ArithmeticTasks, decode_ids
from repro_torch.rl.scheduler import RolloutScheduler

CHUNK = 4          # token budget per scheduling round (partial rollout)
MAX_NEW = 16
N_GENERATORS = 3
STEPS = 12


def tiny_cfg():
    return smoke().replace(n_layers=1, d_model=64, n_heads=4, n_kv_heads=2,
                           head_dim=16, d_ff=128, vocab=64)


def serve(device=None):
    """Chunk-scheduled serving: harvest order follows completion, not
    admission.  Returns the harvested batch indices in harvest order."""
    print("== Part 1: chunk-scheduled serving " + "=" * 30)
    cfg = tiny_cfg()
    gen = spawn_actor(GeneratorExecutor, cfg,
                      ArithmeticTasks(prompt_len=10, max_operand=99,
                                      ops="+*"),
                      n_prompts=3, n_per_prompt=1, max_new=MAX_NEW,
                      chunk=CHUNK, seed=0, device=device)
    gen.cast("set_weights", init_params(cfg, seed=0, dtype=torch.float32,
                                        device=device), version=0)
    sched = RolloutScheduler(
        gen, PartialRolloutCache(),
        # serving has no training-order constraint: shortest-remaining-
        # budget first, so the straggler batch never blocks a harvest
        priority=lambda job, state: job.n_chunks - job.chunks_done)
    for r, target in enumerate((4, MAX_NEW, 8)):  # mixed request lengths
        gen.call("configure", max_new=target)
        job, state = gen.begin_batch(r)
        sched.admit(job, state)
        print(f"admitted request batch {r} "
              f"({job.n_chunks} chunks of {CHUNK} tokens budgeted)")
    order = []
    for job, out in sched.drain():           # short requests retire first
        toks = out["tokens"].cpu().numpy()
        texts = [decode_ids(t[out["prompt_len"]:]) for t in toks]
        print(f"harvested batch {job.batch_index} after "
              f"{job.chunks_done}/{job.n_chunks} chunks -> {texts}")
        order.append(job.batch_index)
    return order


def train_with_pool(device=None, steps: int = STEPS, delay_s: float = 0.15):
    """Generator pool + adaptive staleness, end to end.  Returns the
    controller after its run."""
    print("\n== Part 2: generator pool end-to-end " + "=" * 28)
    cfg = tiny_cfg()
    rew = RewardExecutor(n_per_prompt=2)
    trn = TrainerExecutor(cfg, lr=5e-3, seed=0, device=device)
    gens, chans = build_generator_pool(
        cfg, trn,
        lambda g: ArithmeticTasks(prompt_len=10, max_operand=9, ops="+",
                                  seed=g),
        n_generators=N_GENERATORS, n_prompts=4, n_per_prompt=2, max_new=8,
        chunk=CHUNK, device=device)
    chans += [CommunicationChannel("completions", gens[0], rew,
                                   CommType.GATHER),
              CommunicationChannel("completions_with_reward", rew, trn,
                                   CommType.SCATTER)]
    adaptive = AdaptiveStalenessController(bound=1, min_bound=1,
                                           max_bound=3, window=3)
    ctl = ExecutorController(
        gens + [rew, trn], chans, max_steps=steps, mode="async",
        staleness=1, timeout=300.0, adaptive=adaptive,
        # worker 0's batches straggle: every chunk sleeps
        pool=PoolConfig(chunk_delay=lambda b, c:
                        delay_s if b % N_GENERATORS == 0 else 0.0))
    t0 = time.monotonic()
    hist = ctl.run()
    wall = time.monotonic() - t0
    print(f"{steps} steps in {wall:.1f}s  "
          f"(trainer idle {ctl.stats['train_idle_s']:.1f}s, "
          f"generators idle {ctl.stats['gen_idle_s']:.1f}s, "
          f"overlap {ctl.stats['overlap_s']:.1f}s)")
    print("batch -> producing worker:",
          {h["step"]: h["generator"] for h in hist})
    print("observed staleness histogram:",
          dict(sorted(ctl.staleness_hist.items())))
    print("adaptive bound trajectory:", adaptive.bound_history)
    print("mean reward per step:",
          [round(h["mean_reward"], 3) for h in hist])
    return ctl


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    ap.add_argument("--steps", type=int, default=STEPS)
    args = ap.parse_args(argv)
    try:
        order = serve(args.device)
        ctl = train_with_pool(args.device, args.steps)
    finally:
        close_all_actors()
    return order, ctl


if __name__ == "__main__":
    main()
