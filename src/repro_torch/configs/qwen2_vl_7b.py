"""Qwen2-VL 7B  [arXiv:2409.12191].

VLM: ViT vision tower is a STUB (precomputed patch embeddings prefix the
token sequence).  Language backbone: 28L GQA (28 heads / 4 KV) with
M-RoPE (temporal/height/width rotary sections).  long_500k skipped
(full attention)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-vl-7b",
    family="vlm",
    source="arXiv:2409.12191",
    n_layers=28,
    d_model=3584,
    n_heads=28,
    n_kv_heads=4,
    d_ff=18944,
    vocab=152064,
    head_dim=128,
    act="silu_gated",
    bias=True,              # qwen2 uses qkv bias
    rope_kind="mrope",
    rope_theta=1_000_000.0,
    frontend="vision",
    frontend_tokens=256,    # patch embeddings prefixed per sample
).validate()


def smoke() -> ArchConfig:
    return CONFIG.replace(
        n_layers=2, d_model=256, n_heads=4, n_kv_heads=2, head_dim=64,
        d_ff=512, vocab=512, max_seq=256, frontend_tokens=16,
    ).validate()
