"""Backbone: dense-family model assembly (the port of the JAX package's
``models/backbone.py``).

Params are nested dicts of tensors in the reference pytree's key layout,
layers stacked on a leading axis, so ``convert`` maps one onto the other
key for key.  The layer stack is a Python loop where the reference scans,
walked in segments of one window size each (``_segment_windows``).  The
other families come with ROADMAP A11.
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
    """The port runs the dense GQA family, with or without windows."""
    if cfg.family != "dense" or cfg.attn_kind != "gqa":
        raise NotImplementedError(
            f"family={cfg.family!r}, attn_kind={cfg.attn_kind!r}: only the "
            "dense GQA family is ported (others: ROADMAP A11)")


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


def _is_global_layer(cfg, i):
    """window_pattern: every Nth layer is global (full attention)."""
    if not cfg.window:
        return True
    if cfg.window_pattern:
        return (i + 1) % cfg.window_pattern == 0
    return False


def _layer_windows(cfg, n_layers, offset=0):
    return [0 if _is_global_layer(cfg, offset + i) else cfg.window
            for i in range(n_layers)]


def _segment_windows(cfg, n_layers, offset=0, seq_len=0):
    """Split [offset, offset + n) into maximal runs of one window size,
    as ``(start, end, window)``.

    With ``seq_len`` and ``window >= seq_len`` windowed attention equals
    full attention exactly, so such layers count as full and the runs
    merge (training passes it; prefill never does, its cache layout must
    match ``serve.segment_layout``)."""
    wins = [0 if seq_len and w >= seq_len else w
            for w in _layer_windows(cfg, n_layers, offset)]
    runs = []
    i = 0
    while i < n_layers:
        j = i
        while j < n_layers and wins[j] == wins[i]:
            j += 1
        runs.append((i, j, wins[i]))
        i = j
    return runs


def _attn_block(p, x, cfg, *, window=0):
    y, kv = attn.gqa_forward(p["attn"], norm(x, p["ln1"], cfg.norm), cfg,
                             window=window)
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


def _run_decoder_stack(stacked, x, cfg, collect_kv: bool = False,
                       seq_len: int = 0):
    """Every layer in order, segment by segment of one window each; with
    ``collect_kv`` also each segment's rotated (k, v), stacked
    [L_seg, B, S, K, hd], for prefill to write into the cache.
    ``seq_len`` merges windows no shorter than the sequence (training)."""
    layers = unstack(stacked, cfg.n_layers)
    kv_segs = []
    for i, j, w in _segment_windows(cfg, cfg.n_layers, 0, seq_len):
        kvs = []
        for p in layers[i:j]:
            x, kv = _attn_block(p, x, cfg, window=w)
            x = _ffn_block(p, x, cfg)
            if collect_kv:
                kvs.append(kv)
        if collect_kv:
            kv_segs.append((torch.stack([k for k, _ in kvs]),
                            torch.stack([v for _, v in kvs])))
    return x, kv_segs


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
    x, _ = _run_decoder_stack(params["layers"], x, cfg,
                              seq_len=x.shape[1])
    return _logits(params, cfg, x), {"moe_aux": 0.0}
