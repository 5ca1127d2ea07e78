"""Command-R 35B  [hf:CohereForAI/c4ai-command-r-v01].  Dense decoder,
GQA (64 heads / 8 KV), no biases, SwiGLU-style act.  long_500k via
beyond-paper sliding window."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="command-r-35b",
    family="dense",
    source="hf:CohereForAI/c4ai-command-r-v01",
    n_layers=40,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=22528,
    vocab=256000,
    head_dim=128,
    act="silu_gated",
    bias=False,
    norm="layernorm",
    tie_embeddings=True,
    window=8192,
    window_native=False,
).validate()


def smoke() -> ArchConfig:
    return CONFIG.replace(
        n_layers=2, d_model=256, n_heads=8, n_kv_heads=2, head_dim=32,
        d_ff=512, vocab=512, max_seq=256, window=64,
    ).validate()
