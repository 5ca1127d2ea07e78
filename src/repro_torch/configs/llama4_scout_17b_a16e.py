"""Llama-4 Scout 17B-active / 16 experts  [hf:meta-llama/Llama-4-Scout-17B-16E].

MoE top-1 routing + shared expert, early-fusion multimodal text backbone
(vision frontend not exercised here -- text path only, as assigned dims are
the language backbone).  iRoPE-style interleaved attention: 3 of every 4
layers use chunked/local attention (window), every 4th is global -- which is
why long_500k *runs* natively for this arch.
"""
from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    source="hf:meta-llama/Llama-4-Scout-17B-16E",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=8192,
    vocab=202048,
    head_dim=128,
    act="silu_gated",
    rope_theta=500_000.0,
    moe=MoEConfig(n_experts=16, top_k=1, n_shared=1, d_expert=8192,
                  router="sigmoid"),
    window=8192,
    window_pattern=4,       # every 4th layer global
    window_native=True,
).validate()


def smoke() -> ArchConfig:
    return CONFIG.replace(
        n_layers=2, d_model=256, n_heads=8, n_kv_heads=2, head_dim=32,
        d_ff=512, vocab=512, max_seq=256, window=64, window_pattern=2,
        moe=MoEConfig(n_experts=4, top_k=1, n_shared=1, d_expert=512,
                      router="sigmoid", capacity_factor=4.0),
    ).validate()
