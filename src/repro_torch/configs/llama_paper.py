"""The paper's own policy models: Llama 3.1 8B / 70B / 405B
[arXiv:2407.21783], and the 8B's smoke variant (a copy of the JAX
package's ``configs/llama_paper.py``)."""
from repro_torch.configs.base import ArchConfig

LLAMA31_8B = ArchConfig(
    name="llama31-8b", family="dense", source="arXiv:2407.21783",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=14336,
    vocab=128256, head_dim=128, act="silu_gated", rope_theta=500_000.0,
).validate()

LLAMA31_70B = ArchConfig(
    name="llama31-70b", family="dense", source="arXiv:2407.21783",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8, d_ff=28672,
    vocab=128256, head_dim=128, act="silu_gated", rope_theta=500_000.0,
).validate()

LLAMA31_405B = ArchConfig(
    name="llama31-405b", family="dense", source="arXiv:2407.21783",
    n_layers=126, d_model=16384, n_heads=128, n_kv_heads=8, d_ff=53248,
    vocab=128256, head_dim=128, act="silu_gated", rope_theta=500_000.0,
).validate()


def smoke() -> ArchConfig:
    return LLAMA31_8B.replace(
        name="llama31-smoke", n_layers=2, d_model=256, n_heads=8,
        n_kv_heads=2, head_dim=32, d_ff=512, vocab=512, max_seq=256,
    ).validate()
