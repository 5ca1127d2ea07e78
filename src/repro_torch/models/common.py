"""Shared building blocks: norms, activations, rotary and sinusoidal
position embeddings, init (the port of the JAX package's
``models/common.py``)."""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def rmsnorm(x, w, eps: float = 1e-6):
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * w.float()).to(x.dtype)


def layernorm(x, w, eps: float = 1e-5):
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    return ((xf - mu) * torch.rsqrt(var + eps) * w.float()).to(x.dtype)


def norm(x, w, kind: str):
    return rmsnorm(x, w) if kind == "rmsnorm" else layernorm(x, w)


def act_fn(x, kind: str):
    if kind == "sq_relu":
        r = F.relu(x)
        return r * r
    if kind == "gelu":
        return F.gelu(x, approximate="tanh")     # jax.nn.gelu's default
    return F.silu(x)


# ---------------------------------------------------------------- rotary ---

def rope_freqs(head_dim: int, theta: float) -> np.ndarray:
    """Inverse frequencies in float64, as the reference computes them."""
    return 1.0 / (theta ** (np.arange(0, head_dim, 2) / head_dim))


def apply_rope(x, positions, theta: float):
    """x: [..., S, H, hd]; positions: broadcastable to [..., S].  The
    half-split rotation: dims [0, hd/2) pair with [hd/2, hd)."""
    hd = x.shape[-1]
    freqs = torch.as_tensor(rope_freqs(hd, theta), dtype=torch.float32,
                            device=x.device)
    ang = positions[..., :, None].float() * freqs          # [..., S, hd/2]
    cos = torch.cos(ang)[..., :, None, :]                  # [..., S, 1, hd/2]
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def mrope_sections(head_dim: int):
    """Qwen2-VL's M-RoPE: the rotary pairs split into (temporal, height,
    width) sections; (16, 24, 24) at head dim 128."""
    half = head_dim // 2
    t = half // 4
    h = (half - t) // 2
    return (t, h, half - t - h)


def apply_mrope(x, pos_thw, theta: float):
    """x: [B, S, H, hd]; pos_thw: [3, B, S] (temporal, height and width
    position ids).  Each section of the rotary pairs turns by its own
    position id; the angles are fp32, from ``rope_freqs``."""
    hd = x.shape[-1]
    freqs = torch.as_tensor(rope_freqs(hd, theta), dtype=torch.float32,
                            device=x.device)
    ang_all = pos_thw[..., None].float() * freqs           # [3, B, S, hd/2]
    pieces, off = [], 0
    for i, sec in enumerate(mrope_sections(hd)):
        pieces.append(ang_all[i, ..., off:off + sec])
        off += sec
    ang = torch.cat(pieces, dim=-1)                        # [B, S, hd/2]
    cos = torch.cos(ang)[..., :, None, :]
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def text_mrope_positions(batch: int, seq: int, offset=0, device=None):
    """Plain text: t == h == w == position (Qwen2-VL's rule for text).
    Returns [3, B, S] int64."""
    p = (torch.arange(seq, device=device) + offset).expand(batch, seq)
    return torch.stack([p, p, p])


def sinusoidal_positions(seq: int, d_model: int, offset=0, device=None):
    """[seq, d_model] fp32 sinusoidal position embeddings (sines in the
    first half, cosines in the second): the angles are computed in
    float64 numpy and cast once, as the reference does."""
    pos = np.arange(seq)[:, None] + offset
    i = np.arange(d_model // 2)[None, :]
    ang = pos / (10000 ** (2 * i / d_model))
    out = np.concatenate([np.sin(ang), np.cos(ang)], axis=-1)
    return torch.as_tensor(out, dtype=torch.float32, device=device)


# ------------------------------------------------------------------ init ---

def dense_init(gen: torch.Generator, shape, dtype, device,
               scale: float = 1.0, fan_in: int = 0):
    """Normal(0, scale / sqrt(fan_in)) from an explicit generator, drawn in
    fp32 and cast.  ``fan_in`` defaults to ``shape[-2]``, which for a
    stacked [L, d_in, d_out] leaf is the reference's ``shape[0]`` of the
    per-layer leaf; a stacked leaf of more dims passes the reference's
    per-layer ``shape[0]`` itself.  (The reference draws from a JAX key,
    so the two inits differ; the tests carry the JAX params over with
    ``convert``.)"""
    fan_in = fan_in or (shape[-2] if len(shape) >= 2 else 1)
    std = scale / np.sqrt(fan_in)
    w = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return (w * std).to(dtype)
