"""StarCoder2-3B  [arXiv:2402.19173].  Dense decoder, GQA (24 heads / 2 KV),
RoPE, non-gated GELU MLP, *native* sliding-window attention (4096) -- so
long_500k runs natively."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="starcoder2-3b",
    family="dense",
    source="arXiv:2402.19173",
    n_layers=30,
    d_model=3072,
    n_heads=24,
    n_kv_heads=2,
    d_ff=12288,
    vocab=49152,
    head_dim=128,
    act="gelu",
    bias=True,
    norm="layernorm",
    rope_theta=100_000.0,
    window=4096,
    window_native=True,
).validate()


def smoke() -> ArchConfig:
    return CONFIG.replace(
        n_layers=2, d_model=256, n_heads=8, n_kv_heads=2, head_dim=32,
        d_ff=512, vocab=512, max_seq=256, window=64,
    ).validate()
