"""End-to-end training on the PyTorch port (the twin of the JAX package's
``examples/train_arithmetic_rl.py``): train a small policy with async AIPO
on 2-digit arithmetic, with periodic greedy evaluation and checkpoints.

    PYTHONPATH=src python -m repro_torch.train_arithmetic_rl \\
        [--steps 200] [--eval-every 25] [--device cpu]

The controller is run again for every ``--eval-every`` steps (repeated
``run()`` calls continue its counters, queues and executor state); after
each stretch the trainer's params are evaluated greedily
(``rl.rollout.generate`` at temperature 0) on fresh prompts, and the
controller writes ``{--checkpoint-path}/trainer_{step}`` (``.npz`` and
``.json``) at the same cadence.  ``REPRO_TRANSPORT=proc`` moves the
generator and the trainer into their own processes.  The device defaults
to CUDA.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs.llama_paper import smoke
from repro_torch.core import (CommType, CommunicationChannel,
                              ExecutorController, GeneratorExecutor,
                              RewardExecutor, TrainerExecutor,
                              WeightsCommunicationChannel, close_all_actors,
                              spawn_actor)
from repro_torch.device import resolve
from repro_torch.rl import prng
from repro_torch.rl.data import ArithmeticTasks, decode_ids
from repro_torch.rl.rewards import score_group
from repro_torch.rl.rollout import generate


@torch.no_grad()
def evaluate(params, cfg, tasks, device, n=32) -> float:
    """Greedy accuracy on ``n`` fresh prompts."""
    batch = tasks.sample(n, 1)
    st = generate(params, cfg, torch.as_tensor(batch.prompts, device=device),
                  max_new=8, key=prng.PRNGKey(0), temperature=0.0)
    texts = [decode_ids(t[batch.prompts.shape[1]:])
             for t in st.tokens.cpu().numpy()]
    return float(score_group(batch.answers, texts).mean())


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--eval-every", type=int, default=25)
    ap.add_argument("--d-model", type=int, default=256)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    ap.add_argument("--checkpoint-path", default="checkpoints",
                    help="directory of the periodic checkpoints")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Train and evaluate; returns the eval rows, the history, and the
    trainer's final params (fetched before the actors close)."""
    args = parse_args(argv)
    device = resolve(args.device)
    cfg = smoke().replace(n_layers=args.layers, d_model=args.d_model,
                          n_heads=8, n_kv_heads=2,
                          head_dim=args.d_model // 8,
                          d_ff=args.d_model * 3, vocab=64)
    tasks = ArithmeticTasks(prompt_len=10, max_operand=20, ops="+")
    # actors behind handles: REPRO_TRANSPORT=proc moves the generator and
    # the trainer into their own processes, same script
    gen = spawn_actor(GeneratorExecutor, cfg, tasks, n_prompts=16,
                      n_per_prompt=4, max_new=6, temperature=1.0,
                      device=device)
    rew = RewardExecutor(n_per_prompt=4)
    trn = spawn_actor(TrainerExecutor, cfg, lr=1e-3, rho=4.0, device=device)
    ctl = ExecutorController(
        [gen, rew, trn],
        [WeightsCommunicationChannel("policy_model", trn, gen),
         CommunicationChannel("completions", gen, rew, CommType.GATHER),
         CommunicationChannel("completions_with_reward", rew, trn,
                              CommType.SCATTER)],
        max_steps=args.eval_every, mode="async", staleness=1,
        checkpoint_every=args.eval_every,
        checkpoint_path=args.checkpoint_path)

    t0 = time.time()
    done = 0
    evals = []
    try:
        while done < args.steps:
            # repeated run() calls continue the controller: the worker
            # threads start again, counters and queues persist
            ctl.max_steps = min(args.eval_every, args.steps - done)
            ctl.run()
            done += ctl.max_steps
            # handle endpoints, not executor attributes: get_model and
            # recent_metrics work the same for a trainer in a child
            acc = evaluate(trn.call("get_model"), cfg, tasks, device)
            rew_tr = float(np.mean([h["mean_reward"]
                                    for h in trn.call("recent_metrics",
                                                      10)]))
            ov = ctl.stats.get("overlap_s", 0.0)
            evals.append({"step": done, "greedy_acc": acc,
                          "train_reward": rew_tr, "overlap_s": ov})
            print(f"step {done:4d}  greedy_acc={acc:.3f}  "
                  f"train_reward={rew_tr:.3f}  gen/train_overlap={ov:.1f}s  "
                  f"elapsed={time.time()-t0:.0f}s", flush=True)
        model = trn.call("get_model")
    finally:
        close_all_actors()
    return {"evals": evals, "history": ctl.history, "model": model}


if __name__ == "__main__":
    main()
