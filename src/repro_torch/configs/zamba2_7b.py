"""Zamba2-7B  [arXiv:2411.15242].

Hybrid: 81 Mamba2 layers with a *shared* attention(+MLP) block applied
every 6 layers (weights reused at every application, as in the paper).
SSM state size 64.  Attention KV = full MHA within the shared block.
"""
from repro_torch.configs.base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="zamba2-7b",
    family="hybrid",
    source="arXiv:2411.15242",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    d_ff=14336,
    vocab=32000,
    head_dim=112,
    act="silu_gated",
    ssm=SSMConfig(d_state=64, d_conv=4, expand=2, head_dim_ssm=64, chunk=128),
    shared_attn_every=6,
).validate()


def smoke() -> ArchConfig:
    return CONFIG.replace(
        n_layers=2, d_model=256, n_heads=4, n_kv_heads=4, head_dim=64,
        d_ff=512, vocab=512, max_seq=256,
        ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim_ssm=32, chunk=32),
        shared_attn_every=2,
    ).validate()
