"""DeepSeek 67B  [arXiv:2401.02954].  Llama-architecture dense decoder,
GQA (64 heads / 8 KV), SwiGLU.  long_500k via beyond-paper sliding window."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-67b",
    family="dense",
    source="arXiv:2401.02954",
    n_layers=95,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=22016,
    vocab=102400,
    head_dim=128,
    act="silu_gated",
    window=8192,
    window_native=False,
).validate()


def smoke() -> ArchConfig:
    return CONFIG.replace(
        n_layers=2, d_model=256, n_heads=8, n_kv_heads=2, head_dim=32,
        d_ff=512, vocab=512, max_seq=256, window=64,
    ).validate()
