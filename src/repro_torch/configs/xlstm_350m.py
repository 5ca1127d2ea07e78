"""xLSTM-350M  [arXiv:2405.04517].

24 blocks, mostly mLSTM (matrix-memory, parallelizable) with sLSTM
(scalar-memory, strictly recurrent) at a sparse set of layers, following
the paper's xLSTM[7:1]-style layout.  No separate MLP (d_ff=0): each block
carries its own up/down projections.  4 heads, vocab 50304 (GPT-NeoX).

Two parameter counts, which differ: ``param_count`` gives 303,169,536,
the reference's analytic estimate, whose one term a block (2 D d_in +
d_in D + 4 D^2) leaves out the mLSTM's qkv projection [d_in, 3 d_in] and
does not tell the two kinds of block apart; the tree that
``init_params`` builds holds 467,163,136 in both packages (21 mLSTM
cells of 18.9 M and 3 sLSTM cells of 6.3 M, the tied embedding and the
norms).
"""
from repro_torch.configs.base import ArchConfig, XLSTMConfig

CONFIG = ArchConfig(
    name="xlstm-350m",
    family="ssm",
    source="arXiv:2405.04517",
    n_layers=24,
    d_model=1024,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab=50304,
    head_dim=256,
    attn_kind="none",
    rope_kind="none",
    norm="layernorm",
    xlstm=XLSTMConfig(slstm_layers=(5, 11, 17), proj_factor_m=2.0),
    tie_embeddings=True,
).validate()


def smoke() -> ArchConfig:
    return CONFIG.replace(
        n_layers=2, d_model=256, n_heads=4, n_kv_heads=4, head_dim=64,
        vocab=512, max_seq=256,
        xlstm=XLSTMConfig(slstm_layers=(1,), proj_factor_m=2.0),
    ).validate()
