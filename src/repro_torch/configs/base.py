"""Architecture and input-shape config system (a copy of the JAX package's
``configs/base.py``).

The dataclasses keep the reference's field names and defaults so a config
built for one package reads the same in the other.  The port runs every
family of the reference: dense, MoE (MLA and MTP included), VLM, hybrid,
SSM (xLSTM) and the audio encoder-decoder.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    n_shared: int = 0           # shared (always-on) experts
    d_expert: int = 0           # per-expert ffn width (0 -> use d_ff)
    router: str = "softmax"     # softmax | sigmoid (deepseek-v3 uses sigmoid)
    capacity_factor: float = 1.25
    aux_loss_coef: float = 0.001
    first_k_dense: int = 0      # leading dense layers (deepseek-v3: 3)


@dataclass(frozen=True)
class MLAConfig:
    """Multi-head Latent Attention (DeepSeek-V2/V3)."""
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class SSMConfig:
    """Mamba2 (SSD) block config."""
    d_state: int = 64
    d_conv: int = 4
    expand: int = 2
    n_ssm_heads: int = 0        # 0 -> d_inner // head_dim_ssm
    head_dim_ssm: int = 64
    chunk: int = 128            # SSD chunk length


@dataclass(frozen=True)
class XLSTMConfig:
    """xLSTM block layout: mLSTM everywhere except sLSTM at given layers."""
    slstm_layers: Tuple[int, ...] = ()
    proj_factor_m: float = 2.0  # mLSTM up-projection
    proj_factor_s: float = 1.333
    conv_kernel: int = 4


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                 # dense | moe | hybrid | ssm | audio | vlm
    source: str                 # citation
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0           # 0 -> d_model // n_heads
    act: str = "silu_gated"     # silu_gated | sq_relu | gelu
    attn_kind: str = "gqa"      # gqa | mla | none
    rope_kind: str = "rope"     # rope | mrope | none
    rope_theta: float = 10000.0
    norm: str = "rmsnorm"       # rmsnorm | layernorm
    bias: bool = False
    tie_embeddings: bool = False
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    xlstm: Optional[XLSTMConfig] = None
    # hybrid (zamba2): one *shared* attention+mlp block applied every k layers
    shared_attn_every: int = 0
    # encoder-decoder (seamless): n_enc_layers encoder layers + cross-attn
    enc_dec: bool = False
    n_enc_layers: int = 0
    # modality frontend stub: embeddings arrive precomputed
    frontend: str = "none"      # none | audio | vision
    frontend_tokens: int = 0    # frames / patches fed to encoder or prefix
    # sliding-window attention (native, or beyond-paper variant for long ctx)
    window: int = 0             # 0 -> full attention
    window_pattern: int = 0     # llama4 iRoPE: every Nth layer is full-attn
    window_native: bool = False # True if the model card itself is windowed
    mtp: bool = False           # multi-token-prediction aux head (deepseek-v3)
    # max position embeddings used to size rope tables in training
    max_seq: int = 8192
    # --- lowering knobs (dry-run / perf, not architecture) ---
    # unroll *inner* chunk scans (attention q-blocks, ssd chunks) fully,
    # with block counts capped at <=16, so cost_analysis counts them.
    # sLSTM time scans stay rolled (undercount noted in EXPERIMENTS.md).
    unroll_scans: bool = False
    # layer-scan group size: scan body holds `scan_group` layers.  XLA
    # cost_analysis counts loop bodies ONCE, so compiling u=1 and u=2 and
    # differencing isolates true per-layer cost (launch/dryrun.py).
    scan_group: int = 1
    # per-layer activation rematerialization (the reference's remat knob)
    remat_layers: bool = False
    # MoE dispatch mode: "gathered" (experts fsdp-gathered, baseline) or
    # "ep" (expert-parallel with explicit sharding constraints, optimized)
    moe_mode: str = "gathered"

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    def validate(self) -> "ArchConfig":
        assert self.n_heads % max(self.n_kv_heads, 1) == 0, self.name
        assert self.family in ("dense", "moe", "hybrid", "ssm", "audio", "vlm")
        if self.family == "moe":
            assert self.moe is not None
        return self

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str                   # train | prefill | decode


INPUT_SHAPES = {
    "train_4k":    ShapeSpec("train_4k",    4_096,   256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768,  32,  "prefill"),
    "decode_32k":  ShapeSpec("decode_32k",  32_768,  128, "decode"),
    "long_500k":   ShapeSpec("long_500k",   524_288, 1,   "decode"),
}


def param_count(cfg: ArchConfig) -> Tuple[int, int]:
    """(total_params, active_params) analytic estimate."""
    D, V, L = cfg.d_model, cfg.vocab, cfg.n_layers
    hd = cfg.hd
    emb = V * D * (1 if cfg.tie_embeddings else 2)

    def attn_params() -> int:
        if cfg.attn_kind == "mla":
            m = cfg.mla
            qk = m.qk_nope_dim + m.qk_rope_dim
            p = D * m.q_lora_rank + m.q_lora_rank * cfg.n_heads * qk
            p += D * (m.kv_lora_rank + m.qk_rope_dim)
            p += m.kv_lora_rank * cfg.n_heads * (m.qk_nope_dim + m.v_head_dim)
            p += cfg.n_heads * m.v_head_dim * D
            return p
        if cfg.attn_kind == "none":
            return 0
        q = D * cfg.n_heads * hd
        kv = 2 * D * cfg.n_kv_heads * hd
        o = cfg.n_heads * hd * D
        return q + kv + o

    def ffn_dense(dff: int) -> int:
        mult = 3 if cfg.act == "silu_gated" else 2
        return mult * D * dff

    total = emb
    active = emb
    for i in range(L):
        a = attn_params()
        if cfg.family == "hybrid":
            a = 0  # mamba layers; shared block added below
        if cfg.moe is not None and i >= cfg.moe.first_k_dense:
            de = cfg.moe.d_expert or cfg.d_ff
            routed = cfg.moe.n_experts * ffn_dense(de)
            shared = cfg.moe.n_shared * ffn_dense(de)
            router = D * cfg.moe.n_experts
            total += a + routed + shared + router
            active += a + (cfg.moe.top_k + cfg.moe.n_shared) * ffn_dense(de) + router
        elif cfg.ssm is not None or cfg.family == "hybrid":
            s = cfg.ssm or SSMConfig()
            d_in = s.expand * D
            p = D * 2 * d_in + d_in * D + d_in * 2 * s.d_state  # rough ssd block
            total += p
            active += p
        elif cfg.xlstm is not None:
            d_in = int(cfg.xlstm.proj_factor_m * D)
            p = 2 * D * d_in + d_in * D + 4 * D * D
            total += p
            active += p
        else:
            f = ffn_dense(cfg.d_ff)
            total += a + f
            active += a + f
    if cfg.shared_attn_every:
        a = D * (cfg.n_heads + 2 * cfg.n_kv_heads) * hd + cfg.n_heads * hd * D
        f = ffn_dense(cfg.d_ff)
        total += a + f
        active += a + f
    if cfg.enc_dec:
        # encoder layers + decoder cross-attention
        a = 4 * D * cfg.n_heads * hd
        f = ffn_dense(cfg.d_ff)
        total += cfg.n_enc_layers * (a + f) + L * a
        active += cfg.n_enc_layers * (a + f) + L * a
    return int(total), int(active)
