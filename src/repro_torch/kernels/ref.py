"""Dense oracles for the kernels on the port's path (the port of the
JAX package's ``kernels/ref.py``): each materializes what its kernel
streams, which is what makes them obviously right."""
from __future__ import annotations

import torch

from repro_torch.kernels.fused_sample import gumbel_noise, key_data_u32


def fused_logprob_ref(logits, tokens):
    """logits: [T, V]; tokens: [T] -> [T] fp32 log-softmax gather."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return logp.gather(1, tokens.long()[:, None])[:, 0]


def flash_attention_ref(q, k, v):
    """Naive causal GQA attention.  q: [B,S,H,hd]; k/v: [B,S,K,hd]."""
    B, S, H, hd = q.shape
    K = k.shape[2]
    g = H // K
    qf = q.reshape(B, S, K, g, hd).float()
    s = torch.einsum("bqkgh,bskh->bkgqs", qf, k.float()) * hd ** -0.5
    mask = torch.tril(torch.ones(S, S, dtype=torch.bool, device=q.device))
    s = torch.where(mask, s, -1e30)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskh->bqkgh", p, v.float())
    return o.reshape(B, S, H, hd).to(q.dtype)


def int8_matmul_ref(x, w_q, scale, out_dtype=torch.float32):
    """Dequantize-then-matmul oracle."""
    w = w_q.float() * scale[None, :]
    return (x.float() @ w).to(out_dtype)


def fused_sample_ref(logits, key, temperature: float = 1.0):
    """Dense Gumbel-max oracle: the full [B, V] noise and log-softmax.
    Shares the counter-based noise, so tokens match bit for bit."""
    B, V = logits.shape
    scaled = logits.float() * (1.0 / temperature if temperature > 0.0
                               else 1.0)
    z = scaled
    if temperature > 0.0:
        k0, k1 = key_data_u32(key)
        dev = logits.device
        rows = torch.arange(B, device=dev)[:, None].expand(B, V)
        cols = torch.arange(V, device=dev)[None, :].expand(B, V)
        z = scaled + gumbel_noise(rows, cols, k0, k1)
    tok = torch.argmax(z, dim=-1)
    logp = torch.log_softmax(scaled, dim=-1)
    return tok.int(), logp.gather(1, tok[:, None])[:, 0]
