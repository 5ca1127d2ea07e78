"""Backbone: dense-family model assembly (the port of the JAX package's
``models/backbone.py``).

Params are nested dicts of tensors in the reference pytree's key layout,
layers stacked on a leading axis, so ``convert`` maps one onto the other
key for key.  The layer stack is a Python loop where the reference scans.
The other families come with ROADMAP A11.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import DeviceLike, resolve
from repro_torch.models import attention as attn
from repro_torch.models import ffn as ffnmod
from repro_torch.models.common import dense_init, norm

Params = Dict[str, Any]


def check_dense(cfg: ArchConfig) -> None:
    """The port runs the dense family with full attention only."""
    if cfg.family != "dense" or cfg.attn_kind != "gqa":
        raise NotImplementedError(
            f"family={cfg.family!r}, attn_kind={cfg.attn_kind!r}: only the "
            "dense GQA family is ported (others: ROADMAP A11)")
    if cfg.window:
        raise NotImplementedError(
            "sliding-window attention is ported with the windowed dense "
            "family (ROADMAP A11)")


def init_params(cfg: ArchConfig, seed: int = 0, dtype=torch.bfloat16,
                device: DeviceLike = None) -> Params:
    """Random params drawn from a ``torch.Generator`` seeded with ``seed``
    on ``device``, with the reference's shapes and scales."""
    check_dense(cfg)
    dev = resolve(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    D, L = cfg.d_model, cfg.n_layers
    params: Params = {
        "embed": dense_init(gen, (cfg.vocab, D), dtype, dev),
        "final_norm": torch.ones(D, dtype=dtype, device=dev),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(gen, (D, cfg.vocab), dtype, dev)
    params["layers"] = {
        "ln1": torch.ones((L, D), dtype=dtype, device=dev),
        "attn": attn.gqa_params(gen, cfg, L, dtype, dev),
        "ln2": torch.ones((L, D), dtype=dtype, device=dev),
        "mlp": ffnmod.mlp_params(gen, L, D, cfg.d_ff, cfg.act, dtype, dev,
                                 bias=cfg.bias),
    }
    return params


def _attn_block(p, x, cfg):
    y, kv = attn.gqa_forward(p["attn"], norm(x, p["ln1"], cfg.norm), cfg)
    return x + y, kv


def _ffn_block(p, x, cfg):
    h = norm(x, p["ln2"], cfg.norm)
    return x + ffnmod.mlp_forward(p["mlp"], h, cfg.act, bias=cfg.bias)


def unstack(stacked: Params, n: int) -> list:
    """The ``n`` per-layer subtrees of a stacked params subtree (views, no
    copies), from one ``unbind`` per leaf.  Its backward stacks the
    layers' gradients in one allocation; indexing one layer at a time
    would zero-fill a whole stacked gradient per layer."""
    per = {k: unstack(v, n) if isinstance(v, dict) else v.unbind(0)
           for k, v in stacked.items()}
    return [{k: v[i] for k, v in per.items()} for i in range(n)]


def _run_decoder_stack(stacked, x, cfg, collect_kv: bool = False):
    """Every layer in order; with ``collect_kv`` also each layer's rotated
    (k, v), for prefill to write into the cache."""
    kvs = []
    for p in unstack(stacked, cfg.n_layers):
        x, kv = _attn_block(p, x, cfg)
        x = _ffn_block(p, x, cfg)
        if collect_kv:
            kvs.append(kv)
    return x, kvs


def _embed(params, cfg, tokens):
    return params["embed"][tokens.long()]


def _logits(params, cfg, x):
    """Logits in the params' dtype."""
    x = norm(x, params["final_norm"], cfg.norm)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return x @ head


def forward_train(params: Params, cfg: ArchConfig, batch) -> tuple:
    """Teacher-forced forward.  Returns (logits [B, S, V], aux)."""
    check_dense(cfg)
    x = _embed(params, cfg, batch["tokens"])
    x, _ = _run_decoder_stack(params["layers"], x, cfg)
    return _logits(params, cfg, x), {"moe_aux": 0.0}
