"""DDMA: direct device-to-device weight synchronization (paper Sec. 5.2;
the port of the JAX package's ``core/ddma.py``).

``ddma_weight_sync`` moves every leaf straight to the target device; on
the trainer's own device that is the same tensor, with no copy.  That is
safe because the optimizer never writes a param in place
(``train/optimizer.py``): a delivered snapshot cannot change under the
generator.  ``ps_weight_sync`` is the parameter-server baseline the paper
contrasts against: every leaf goes through host memory and back.

``quantize_dequant`` gives the generator its low-precision weights (the
paper uses fp8; this is the reference's int8 symmetric per-channel
fake-quantization, applied once at weight sync, with no int8 kernel).
"""
from __future__ import annotations

import statistics
import time
from typing import Any, Callable

import torch

from repro_torch.train.optimizer import tree_leaves, tree_map


def ddma_weight_sync(params, device) -> Any:
    """Direct device-to-device transfer of every leaf to ``device``."""
    return tree_map(lambda x: x.to(device, non_blocking=True), params)


def ps_weight_sync(params, device) -> Any:
    """Parameter-server-style baseline: host gather, then host scatter."""
    host = tree_map(lambda x: x.to("cpu", copy=True), params)
    return tree_map(lambda x: x.to(device), host)


def _sync(tree) -> None:
    devices = {x.device for x in tree_leaves(tree)
               if isinstance(x, torch.Tensor)}
    for d in devices:
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def timed_sync(fn: Callable, params, device, repeats: int = 3,
               warmup: int = 1):
    """Median wall-clock of a sync path, after ``warmup`` untimed calls;
    the device is synchronized before the clock starts and before it
    stops.  Returns (seconds, the last result)."""
    _sync(params)
    out = None
    for _ in range(max(0, warmup)):
        out = fn(params, device)
        _sync(out)
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        out = fn(params, device)
        _sync(out)
        times.append(time.perf_counter() - t0)
    return float(statistics.median(times)), out


# -------------------------------------------------- generator quantization -

def quantize_int8(w: torch.Tensor):
    """Symmetric per-output-channel int8 quantization of a 2-D weight."""
    wf = w.float()
    scale = wf.abs().amax(dim=0, keepdim=True)
    scale = torch.clamp(scale, min=1e-8) / 127.0
    q = torch.clamp(torch.round(wf / scale), -127, 127)
    return q.to(torch.int8), scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor,
                    dtype=torch.bfloat16):
    return (q.float() * scale).to(dtype)


def quantize_dequant(params, min_size: int = 1 << 16, dtype=None):
    """Fake-quantize every large matmul weight (fp8-generator analogue):
    same shapes and dtypes, values through int8.  This is how the
    generator's policy mu ends up numerically different from the learner's
    pi -- one of the off-policy sources AIPO corrects for."""
    def qd(x):
        if x.dim() >= 2 and x.numel() >= min_size and x.is_floating_point():
            mat = x.reshape(-1, x.shape[-1])
            q, s = quantize_int8(mat)
            return dequantize_int8(q, s, dtype or x.dtype).reshape(x.shape)
        return x
    return tree_map(qd, params)
