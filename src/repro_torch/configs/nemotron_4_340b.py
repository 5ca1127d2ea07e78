"""Nemotron-4 340B  [arXiv:2402.16819].

Dense decoder, GQA (96 heads / 8 KV), squared-ReLU (non-gated) MLP.
long_500k decode runs only via the beyond-paper sliding-window serve
variant (window=8192), flagged window_native=False.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="nemotron-4-340b",
    family="dense",
    source="arXiv:2402.16819",
    n_layers=96,
    d_model=18432,
    n_heads=96,
    n_kv_heads=8,
    d_ff=73728,
    vocab=256000,
    head_dim=192,
    act="sq_relu",
    norm="layernorm",
    window=8192,           # beyond-paper long-context serve variant
    window_native=False,
).validate()


def smoke() -> ArchConfig:
    return CONFIG.replace(
        n_layers=2, d_model=256, n_heads=8, n_kv_heads=2, head_dim=32,
        d_ff=1024, vocab=512, max_seq=256, window=64,
    ).validate()
