"""Times kernels B1 (``fused_logprob_cuda``) and B2
(``fused_logprob_bwd_cuda``) on the card at the kernel table's shapes,
each under a range of split plans beside the one its wrapper picks
(``split_plan`` for B1, ``bwd_plan`` for B2):

    PYTHONPATH=src python -m repro_torch.kernels.logprob_sweep

Each shape is the [16, T - 1, V] bf16 view of [16, T, V] logits that the
scorer (B1) or the trainer (B2) reads.  A plan is forced through B1's
plan cache or B2's ``BWD_SPAN``; each time is the least of three
CUDA-event means over 20 back-to-back calls.  Prints one line a shape and plan, and the
card's name and power limit first.
"""
from __future__ import annotations

import subprocess

import torch

from repro_torch.kernels import build, fused_logprob as fl

# (V, T): llama31-8b, llama4-scout, deepseek-v3, xlstm-350m and
# seamless-m4t-medium's scoring views; then the trainers'
FWD_SHAPES = ((128256, 80), (202048, 288), (129280, 288), (50304, 320),
              (256206, 128))
BWD_SHAPES = ((128256, 80), (129280, 80), (50304, 128), (50304, 32),
              (256206, 128), (256206, 96))
FWD_SPLITS = (1, 2, 3, 4, 5, 6, 8)
BWD_SPANS = (4096, 6144, 8192, 16384, 32768, None)    # None: whole rows


def events_ms(fn, n: int = 20) -> float:
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    best = None
    for _ in range(3):
        a.record()
        for _ in range(n):
            fn()
        b.record()
        b.synchronize()
        ms = a.elapsed_time(b) / n
        best = ms if best is None else min(best, ms)
    return best


def _force(kind, dev, rows, V, span):
    """Make B1 (through the wrappers' plan cache) or B2 (through
    ``fl.BWD_SPAN``, which ``bwd_plan`` reads) cut rows of ``V`` columns
    at ``span``, whole rows past V.  Returns the plan."""
    span = fl.SPAN_ALIGN * -(-min(span, V) // fl.SPAN_ALIGN)
    if kind == "B1":
        fl._PLANS[dev, rows, V] = (span, fl.n_splits_of(V, span))
        return fl._PLANS[dev, rows, V]
    fl.BWD_SPAN = span
    return fl.bwd_plan(V)


def main() -> None:
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    n_sm = build.sm_count(dev)
    default_bwd = fl.BWD_SPAN
    gen = torch.Generator(device=dev).manual_seed(0)
    for kind, shapes in (("B1", FWD_SHAPES), ("B2", BWD_SHAPES)):
        for V, T in shapes:
            x = (torch.randn(16, T, V, generator=gen, device=dev)
                 * 2).to(torch.bfloat16)
            view = x[:, :-1]
            toks = torch.randint(0, V, (16, T - 1), generator=gen,
                                 device=dev, dtype=torch.int32)
            fl._PLANS.clear()
            _, m, s = fl.fused_logprob_cuda(view, toks)
            log_s = torch.log(s)
            g = torch.randn(16, T - 1, generator=gen, device=dev)
            if kind == "B1":
                rows = 16 * (T - 1)
                picked = fl.split_plan(rows, V, n_sm)
                spans = [fl.SPAN_ALIGN * -(-V // (k * fl.SPAN_ALIGN))
                         for k in FWD_SPLITS
                         if k == 1 or V // k >= fl.MIN_SPAN]

                def run():
                    return fl.fused_logprob_cuda(view, toks)
            else:
                picked = fl.bwd_plan(V)
                spans = [sp or V for sp in BWD_SPANS]
                rows = 16 * T

                def run():
                    return fl.fused_logprob_bwd_cuda(x, toks, m, log_s, g,
                                                     n_valid=T - 1)
            for span in [picked[0]] + spans:
                plan = _force(kind, dev, rows, V, span)
                ms = events_ms(run)
                mark = " (the wrapper's)" if plan == picked else ""
                print(f"{kind} [16, {T - 1}, {V}] bf16: {plan[1]} splits of "
                      f"{plan[0]}{mark}: {ms:.4f} ms", flush=True)
            del x, view
            fl.BWD_SPAN = default_bwd
    fl._PLANS.clear()


if __name__ == "__main__":
    main()
