"""Backbone: model assembly for the dense, MoE, VLM and hybrid families
(the port of the JAX package's ``models/backbone.py``).

Params are nested dicts of tensors in the reference pytree's key layout,
layers stacked on a leading axis, so ``convert`` maps one onto the other
key for key.  A dense or VLM model has one stack, ``layers``; a MoE model
has ``dense_layers`` (its ``first_k_dense`` leading layers, when set) and
``moe_layers`` (``layer_stacks``).  Each stack is a Python loop where the
reference scans, walked in segments of one window size each
(``_segment_windows``).  Attention is GQA or MLA (``attn_kind``); a MoE
model with ``mtp`` (DeepSeek-V3) also has ``mtp``, the multi-token
prediction head, whose ``block`` is one decoder layer with a dense MLP
and no leading layer axis, as in the reference.

A VLM (Qwen2-VL) prefixes its tokens with precomputed patch embeddings
(``batch["patch_embeds"]``, the vision tower is a stub in both packages)
and turns q and k by M-RoPE: patch i at (0, i // side, i % side) with
side = floor(sqrt(P)), text token t at side + t in all three sections.
A hybrid (Zamba2) has ``mamba_layers``, a stack of Mamba2 layers, and
``shared_attn``, one decoder layer with no leading axis whose weights
run before every group of ``shared_attn_every`` Mamba layers.

An xLSTM (the SSM family) has ``xlstm_layers``, a list of per-layer
dicts ``{"ln", "cell"}`` as in the reference, not a stack: its two kinds
of cell (sLSTM at ``cfg.xlstm.slstm_layers``, mLSTM elsewhere) hold
different leaves.  It has no attention.  The audio encoder-decoder
(SeamlessM4T) has ``enc_layers`` and ``dec_layers``, stacks of GQA
layers whose decoder layers also hold ``ln_cross`` and ``cross`` (the
cross attention over the encoder's output), and ``enc_norm``.  Its
encoder reads precomputed frame embeddings (``batch["frame_embeds"]``
[B, F, D], the speech front end is a stub in both packages) plus
sinusoidal positions, unmasked; its decoder adds sinusoidal positions
to the token embeddings, with no rotation.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.device import DeviceLike, resolve
from repro_torch.models import attention as attn
from repro_torch.models import ffn as ffnmod
from repro_torch.models import ssm as ssmmod
from repro_torch.models.common import dense_init, norm, \
    sinusoidal_positions, text_mrope_positions

Params = Dict[str, Any]


def check_family(cfg: ArchConfig) -> None:
    """The port runs every family of the reference: dense and MoE with
    GQA or MLA attention, with or without windows, the MoE family's MTP
    head; VLM, hybrid and the audio encoder-decoder with GQA; the SSM
    family (xLSTM) with no attention.  A config whose family lacks the
    sub-config it needs raises ``ValueError``."""
    fam, kind = cfg.family, cfg.attn_kind
    if fam in ("dense", "moe") and kind in ("gqa", "mla"):
        if kind == "mla" and cfg.mla is None:
            raise ValueError(f"{cfg.name}: attn_kind='mla' needs an "
                             "MLAConfig in cfg.mla")
        return
    if fam in ("vlm", "hybrid", "audio") and kind == "gqa":
        if fam == "hybrid" and (cfg.ssm is None
                                or cfg.shared_attn_every < 1):
            raise ValueError(f"{cfg.name}: the hybrid family needs an "
                             "SSMConfig and shared_attn_every >= 1")
        if fam == "audio" and not (cfg.enc_dec and cfg.n_enc_layers >= 1):
            raise ValueError(f"{cfg.name}: the audio family needs "
                             "enc_dec=True and n_enc_layers >= 1")
        return
    if fam == "ssm":
        if cfg.xlstm is None:
            raise ValueError(f"{cfg.name}: the SSM family needs an "
                             "XLSTMConfig in cfg.xlstm")
        return
    raise ValueError(
        f"{cfg.name}: family={fam!r} with attn_kind={kind!r} is no family "
        "of the reference (dense and moe take gqa or mla; vlm, hybrid and "
        "audio take gqa; ssm has its own cells)")


def layer_stacks(cfg: ArchConfig) -> list:
    """The decoder-only attention layer stacks in the order every path
    walks them, as ``(params key, n_layers, index of the stack's first
    layer)``; none for the hybrid family, whose one attention layer is
    ``shared_attn``, for the SSM family, which has no attention, or for
    the audio family, whose stacks ``enc_layers`` and ``dec_layers`` have
    paths of their own."""
    if cfg.family in ("hybrid", "ssm", "audio"):
        return []
    if cfg.family == "moe":
        fkd = cfg.moe.first_k_dense
        return ([("dense_layers", fkd, 0)] if fkd else []) \
            + [("moe_layers", cfg.n_layers - fkd, fkd)]
    return [("layers", cfg.n_layers, 0)]


def _layer_params(gen, cfg, n, dtype, dev, *, moe: bool,
                  cross: bool = False) -> Params:
    D = cfg.d_model
    attn_params = attn.mla_params if cfg.attn_kind == "mla" \
        else attn.gqa_params
    p = {"ln1": torch.ones((n, D), dtype=dtype, device=dev),
         "attn": attn_params(gen, cfg, n, dtype, dev),
         "ln2": torch.ones((n, D), dtype=dtype, device=dev)}
    if moe:
        p["moe"] = ffnmod.moe_params(gen, cfg, n, dtype, dev)
    else:
        p["mlp"] = ffnmod.mlp_params(gen, n, D, cfg.d_ff, cfg.act, dtype,
                                     dev, bias=cfg.bias)
    if cross:
        p["ln_cross"] = torch.ones((n, D), dtype=dtype, device=dev)
        p["cross"] = attn.gqa_params(gen, cfg, n, dtype, dev)
    return p


def _xlstm_layers(gen, cfg, dtype, dev) -> list:
    """xLSTM's per-layer ``{"ln", "cell"}`` dicts, sLSTM cells at
    ``cfg.xlstm.slstm_layers`` and mLSTM cells elsewhere."""
    out = []
    for i in range(cfg.n_layers):
        cell = ssmmod.slstm_params if i in cfg.xlstm.slstm_layers \
            else ssmmod.mlstm_params
        out.append({"ln": torch.ones(cfg.d_model, dtype=dtype, device=dev),
                    "cell": cell(gen, cfg, dtype, dev)})
    return out


def init_params(cfg: ArchConfig, seed: int = 0, dtype=torch.bfloat16,
                device: DeviceLike = None) -> Params:
    """Random params drawn from a ``torch.Generator`` seeded with ``seed``
    on ``device`` (``meta`` gives the shapes and dtypes alone), with the reference's shapes and scales (a MoE router
    and Mamba2's ``A_log``, ``D_skip`` and ``dt_bias`` stay fp32 whatever
    ``dtype`` is, as in the reference).  The MTP head's ``block`` and the
    hybrid's ``shared_attn`` are one layer with no leading axis; xLSTM's
    ``xlstm_layers`` is a list of layers."""
    check_family(cfg)
    dev = resolve(device)
    # the meta device has no generator: its tensors hold shapes only
    gen = torch.Generator(device="cpu" if dev.type == "meta" else dev
                          ).manual_seed(seed)
    D = cfg.d_model
    params: Params = {
        "embed": dense_init(gen, (cfg.vocab, D), dtype, dev),
        "final_norm": torch.ones(D, dtype=dtype, device=dev),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(gen, (D, cfg.vocab), dtype, dev)
    for key, n, _ in layer_stacks(cfg):
        params[key] = _layer_params(gen, cfg, n, dtype, dev,
                                    moe=key == "moe_layers")
    if cfg.family == "hybrid":
        L = cfg.n_layers
        params["mamba_layers"] = {
            "ln1": torch.ones((L, D), dtype=dtype, device=dev),
            "mamba": ssmmod.mamba2_params(gen, cfg, L, dtype, dev)}
        params["shared_attn"] = unstack(_layer_params(
            gen, cfg, 1, dtype, dev, moe=False), 1)[0]
    if cfg.family == "ssm":
        params["xlstm_layers"] = _xlstm_layers(gen, cfg, dtype, dev)
    if cfg.family == "audio":
        params["enc_layers"] = _layer_params(gen, cfg, cfg.n_enc_layers,
                                             dtype, dev, moe=False)
        params["dec_layers"] = _layer_params(gen, cfg, cfg.n_layers, dtype,
                                             dev, moe=False, cross=True)
        params["enc_norm"] = torch.ones(D, dtype=dtype, device=dev)
    if cfg.family == "moe" and cfg.mtp:
        params["mtp"] = {
            "proj": dense_init(gen, (2 * D, D), dtype, dev),
            "block": unstack(_layer_params(gen, cfg, 1, dtype, dev,
                                           moe=False), 1)[0],
            "norm": torch.ones(D, dtype=dtype, device=dev)}
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


def segment_lengths(cfg, kind: str = "train", seq_len: int = 0):
    """Lengths of every layer stack that the reference scans for the
    given step kind (train/prefill/decode), its dry run's counted-layers
    extrapolation.  seq_len only merges for kind='train'."""
    sl = seq_len if kind == "train" else 0
    if cfg.family in ("dense", "vlm"):
        return [j - i for (i, j, _) in
                _segment_windows(cfg, cfg.n_layers, 0, sl)]
    if cfg.family == "moe":
        out = []
        fkd = cfg.moe.first_k_dense
        if fkd:
            out += [j - i for (i, j, _) in _segment_windows(cfg, fkd, 0, sl)]
        # the MTP block is one unscanned layer, counted in full
        out += [j - i for (i, j, _) in
                _segment_windows(cfg, cfg.n_layers - fkd, fkd, sl)]
        return out
    if cfg.family == "hybrid":
        k = cfg.shared_attn_every
        out, i = [], 0
        while i < cfg.n_layers:
            out.append(min(k, cfg.n_layers - i))
            i += k
        return out
    if cfg.family == "ssm":
        return []                       # a Python loop: counted in full
    if cfg.family == "audio":
        if kind == "decode":
            return [cfg.n_layers]
        return [cfg.n_enc_layers, cfg.n_layers]
    raise ValueError(cfg.family)


def counted_layers(cfg, u: int, kind: str = "train",
                   seq_len: int = 0) -> int:
    """How many layer instances the reference's cost analysis sees at
    scan_group=u."""
    tot = 0
    for n in segment_lengths(cfg, kind, seq_len):
        tot += n if n <= u else u + (n % u)
    return tot


def real_layers(cfg, kind: str = "train", seq_len: int = 0) -> int:
    return sum(segment_lengths(cfg, kind, seq_len))


def _attn_block(p, x, cfg, *, window=0, mrope_pos=None):
    """The attention half of a layer: (x + attn(norm(x)), what the cache
    holds: rotated (k, v), or MLA's (c_kv, k_rope))."""
    h = norm(x, p["ln1"], cfg.norm)
    if cfg.attn_kind == "mla":
        y, kv = attn.mla_forward(p["attn"], h, cfg)
    else:
        y, kv = attn.gqa_forward(p["attn"], h, cfg, window=window,
                                 mrope_pos=mrope_pos)
    return x + y, kv


def _ffn_block(p, x, cfg):
    """The FFN half of a layer: (x + ffn(norm(x)), the MoE aux loss)."""
    h = norm(x, p["ln2"], cfg.norm)
    if "moe" in p:
        y, aux = ffnmod.moe_forward(p["moe"], h, cfg)
        return x + y, aux
    return x + ffnmod.mlp_forward(p["mlp"], h, cfg.act, bias=cfg.bias), 0.0


class StackShard:
    """A leaf of a layer stack held as this rank's shard ``t`` [L, ...],
    as the sharded train step passes it (``train/sharded.py``):
    ``gather`` turns one layer's shard into that layer's whole leaf.
    ``unbind`` splits it into its layers' shards as a tensor's splits,
    so ``unstack`` walks both, and each layer's work gathers its own
    leaves when it starts (``_layer``)."""

    __slots__ = ("t", "gather")

    def __init__(self, t: torch.Tensor, gather):
        self.t, self.gather = t, gather

    def unbind(self, dim: int = 0) -> tuple:
        return tuple(StackShard(x, self.gather) for x in self.t.unbind(dim))


def unstack(stacked: Params, n: int) -> list:
    """The ``n`` per-layer subtrees of a stacked params subtree (views, no
    copies), from one ``unbind`` per leaf.  Its backward stacks the
    layers' gradients in one allocation; indexing one layer at a time
    would zero-fill a whole stacked gradient per layer."""
    per = {k: unstack(v, n) if isinstance(v, dict) else v.unbind(0)
           for k, v in stacked.items()}
    return [{k: v[i] for k, v in per.items()} for i in range(n)]


def _gathered(p: Params) -> Params:
    return {k: _gathered(v) if isinstance(v, dict)
            else v.gather(v.t) if isinstance(v, StackShard) else v
            for k, v in p.items()}


def _run_layer(fn, p, *args):
    return fn(_gathered(p), *args)


def _layer(cfg, fn, p, *args):
    """One layer's work, ``fn(p, *args)``, its ``StackShard`` leaves
    gathered first.  With ``cfg.remat_layers`` while grad is on it runs
    under a checkpoint, the reference's ``jax.checkpoint`` of each layer
    scan's body: the backward keeps the layer's inputs and recomputes
    the rest, the gather included (the layers draw no random numbers,
    so no RNG state is kept)."""
    if cfg.remat_layers and torch.is_grad_enabled():
        return checkpoint(_run_layer, fn, p, *args, use_reentrant=False,
                          preserve_rng_state=False)
    return _run_layer(fn, p, *args)


def _decoder_layer(p, x, cfg, window=0, mrope_pos=None):
    """One decoder layer: (x, the MoE aux loss, what the cache holds)."""
    x, kv = _attn_block(p, x, cfg, window=window, mrope_pos=mrope_pos)
    x, aux = _ffn_block(p, x, cfg)
    return x, aux, kv


def _run_decoder_stack(stacked, x, cfg, n_layers: int, offset: int = 0,
                       collect_kv: bool = False, seq_len: int = 0,
                       mrope_pos=None):
    """The ``n_layers`` layers of one stack in order (global layer indices
    from ``offset``, which set the windows), segment by segment of one
    window each.  Returns (x, the summed MoE aux, kv_segs): with
    ``collect_kv`` each segment's rotated (k, v), stacked [L_seg, B, S,
    K, hd] (MLA: (c_kv, k_rope), [L_seg, B, S, *]), for prefill to write
    into the cache.  ``seq_len`` merges windows no shorter than the
    sequence (training); ``mrope_pos`` [3, B, S] are the VLM's M-RoPE
    positions."""
    layers = unstack(stacked, n_layers)
    aux = 0.0
    kv_segs = []
    for i, j, w in _segment_windows(cfg, n_layers, offset, seq_len):
        kvs = []
        for p in layers[i:j]:
            x, a, kv = _layer(cfg, _decoder_layer, p, x, cfg, w, mrope_pos)
            aux = aux + a
            if collect_kv:
                kvs.append(kv)
        if collect_kv:
            kv_segs.append((torch.stack([k for k, _ in kvs]),
                            torch.stack([v for _, v in kvs])))
    return x, aux, kv_segs


def _embed(params, cfg, tokens):
    return params["embed"][tokens.long()]


def vlm_prefix(cfg, x, batch):
    """A VLM's input: the patch embeddings [B, P, D] (cast to x's dtype)
    before the token embeddings x [B, S, D], and the M-RoPE positions
    [3, B, P + S] of both: patch i at (0, i // side, i % side), token t
    at side + t, with side = floor(sqrt(P)).  Returns (x, mrope_pos,
    P)."""
    patches = batch["patch_embeds"].to(x.dtype)
    B, P = patches.shape[:2]
    side = max(int(P ** 0.5), 1)
    i = torch.arange(P, device=x.device).expand(B, P)
    vis = torch.stack([torch.zeros_like(i), i // side, i % side])
    txt = text_mrope_positions(B, x.shape[1], offset=side, device=x.device)
    return (torch.cat([patches, x], dim=1), torch.cat([vis, txt], dim=-1),
            P)


def hybrid_groups(cfg) -> list:
    """The hybrid's Mamba layer groups ``(start, end)``: the shared
    attention block runs before each, ceil(n_layers / shared_attn_every)
    times in all; the last group may be shorter."""
    k, L = cfg.shared_attn_every, cfg.n_layers
    return [(i, min(i + k, L)) for i in range(0, L, k)]


def mamba_layer(p, x, cfg, return_state: bool = False):
    """x + Mamba2(norm(x)) (and, with ``return_state``, the layer's decode
    state after the last step)."""
    out = ssmmod.mamba2_forward(p["mamba"], norm(x, p["ln1"], cfg.norm),
                                cfg, return_state=return_state)
    if return_state:
        return x + out[0], out[1]
    return x + out


def _logits(params, cfg, x):
    """Logits in the params' dtype."""
    x = norm(x, params["final_norm"], cfg.norm)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return x @ head


def forward_train(params: Params, cfg: ArchConfig, batch) -> tuple:
    """Teacher-forced forward.  Returns (logits [B, S, V], aux) with the
    MoE layers' summed load-balance loss in ``aux["moe_aux"]`` and, with
    an MTP head, its logits [B, S, V] in ``aux["mtp_logits"]``: position
    t predicts token t + 2 from (h_t, embed(token t + 1)), the last
    position reading its own token again, as in the reference.  A VLM's
    batch holds ``patch_embeds`` [B, P, D]; its logits are the text
    positions' only.  An audio model's batch holds ``frame_embeds``
    [B, F, D], which the encoder reads."""
    check_family(cfg)
    tokens = batch["tokens"]
    S = tokens.shape[1]
    x = _embed(params, cfg, tokens)
    if cfg.family == "ssm":
        for i, p in enumerate(params["xlstm_layers"]):
            x = x + xlstm_layer(p, x, cfg, i)[0]
        return _logits(params, cfg, x), {"moe_aux": 0.0}
    if cfg.family == "audio":
        enc = _encode(params, cfg, batch["frame_embeds"])
        x = x + sinusoidal_positions(S, cfg.d_model,
                                     device=x.device)[None].to(x.dtype)
        x, _ = run_encdec_decoder(params, cfg, x, enc)
        return _logits(params, cfg, x), {"moe_aux": 0.0}
    mrope_pos = None
    if cfg.family == "vlm":
        x, mrope_pos, _ = vlm_prefix(cfg, x, batch)
    aux = 0.0
    for key, n, off in layer_stacks(cfg):
        x, a, _ = _run_decoder_stack(params[key], x, cfg, n, off,
                                     seq_len=x.shape[1], mrope_pos=mrope_pos)
        aux = aux + a
    if cfg.family == "vlm":
        x = x[:, -S:]
    if cfg.family == "hybrid":
        layers = unstack(params["mamba_layers"], cfg.n_layers)
        for i, j in hybrid_groups(cfg):
            x, _, _ = _decoder_layer(params["shared_attn"], x, cfg)
            for p in layers[i:j]:
                x = _layer(cfg, mamba_layer, p, x, cfg)
    out = {"moe_aux": aux}
    if cfg.mtp and "mtp" in params:
        mtp = params["mtp"]
        nxt = torch.cat([tokens[:, 1:], tokens[:, -1:]], dim=1)
        h = torch.cat([norm(x, mtp["norm"], cfg.norm),
                       _embed(params, cfg, nxt)], dim=-1) @ mtp["proj"]
        h, _, _ = _decoder_layer(mtp["block"], h, cfg)
        out["mtp_logits"] = _logits(params, cfg, h)
    return _logits(params, cfg, x), out


def xlstm_layer(p, x, cfg, i: int, state=None):
    """Layer ``i`` of an xLSTM without its residual: (cell(norm(x)), the
    cell's state after the last step), an sLSTM cell where
    ``cfg.xlstm.slstm_layers`` names ``i``, else an mLSTM cell."""
    fwd = ssmmod.slstm_forward if i in cfg.xlstm.slstm_layers \
        else ssmmod.mlstm_forward
    return fwd(p["cell"], norm(x, p["ln"], cfg.norm), cfg, state)


def _encode(params, cfg, frame_embeds):
    """The encoder: frame embeddings [B, F, D] (cast to the params' dtype:
    the reference adds them as given, and a bf16 model's products in
    torch take one dtype) plus sinusoidal positions, through the encoder
    layers with unmasked self-attention, then ``enc_norm``."""
    x = frame_embeds.to(params["enc_norm"].dtype)
    x = x + sinusoidal_positions(x.shape[1], cfg.d_model,
                                 device=x.device)[None].to(x.dtype)
    for p in unstack(params["enc_layers"], cfg.n_enc_layers):
        x = _layer(cfg, _encoder_layer, p, x, cfg)
    return norm(x, params["enc_norm"], cfg.norm)


def _encoder_layer(p, x, cfg):
    y, _ = attn.gqa_forward(p["attn"], norm(x, p["ln1"], cfg.norm), cfg,
                            causal=False)
    return _ffn_block(p, x + y, cfg)[0]


def _enc_kv(p, enc, cfg):
    """A decoder layer's cross-attention K and V [B, F, K, hd] from the
    encoder's output (no bias, no rotation, as in the reference)."""
    B, F_ = enc.shape[:2]
    K, hd = cfg.n_kv_heads, cfg.hd
    return ((enc @ p["cross"]["wk"]).reshape(B, F_, K, hd),
            (enc @ p["cross"]["wv"]).reshape(B, F_, K, hd))


def _encdec_layer(p, x, enc, cfg):
    """One decoder layer: (x, its self-attention's (k, v) and its cross
    attention's (k, v))."""
    y, (k, v) = attn.gqa_forward(p["attn"], norm(x, p["ln1"], cfg.norm), cfg)
    x = x + y
    ek, ev = _enc_kv(p, enc, cfg)
    x = x + attn.gqa_cross_forward(
        p["cross"], norm(x, p["ln_cross"], cfg.norm), ek, ev, cfg)
    x, _ = _ffn_block(p, x, cfg)
    return x, (k, v, ek, ev)


def run_encdec_decoder(params, cfg, x, enc, collect: bool = False):
    """The decoder layers over x [B, S, D] (positions added): causal
    self-attention, cross attention over ``enc`` [B, F, D], the MLP.
    Returns (x, kvs): with ``collect`` the self-attention's (k, v) and the
    cross attention's (k, v) of every layer, stacked [L, B, S | F, K,
    hd], for prefill to cache; else None."""
    kvs = []
    for p in unstack(params["dec_layers"], cfg.n_layers):
        x, kv = _layer(cfg, _encdec_layer, p, x, enc, cfg)
        if collect:
            kvs.append(kv)
    if not collect:
        return x, None
    return x, tuple(torch.stack(t) for t in zip(*kvs))
