"""SeamlessM4T-medium  [arXiv:2308.11596].

Encoder-decoder multimodal translation backbone.  Per the carve-out, the
conformer/conv audio frontend is a STUB: ``input_specs`` feeds precomputed
frame embeddings [B, frames, d_model] to the text/speech encoder; we build
the 12L encoder + 12L decoder transformer with cross-attention.
No decode for long_500k (full attention enc-dec).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="seamless-m4t-medium",
    family="audio",
    source="arXiv:2308.11596",
    n_layers=12,            # decoder layers
    n_enc_layers=12,
    enc_dec=True,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab=256206,
    head_dim=64,
    act="silu_gated",
    norm="layernorm",
    rope_kind="none",       # learned/sinusoidal positions; we use sinusoidal
    frontend="audio",
    frontend_tokens=1024,   # encoder frames fed by the stub per sample
).validate()


def smoke() -> ArchConfig:
    return CONFIG.replace(
        n_layers=2, n_enc_layers=2, d_model=256, n_heads=4, n_kv_heads=4,
        head_dim=64, d_ff=512, vocab=512, max_seq=256, frontend_tokens=32,
    ).validate()
