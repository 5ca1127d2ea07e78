"""DeepSeek-V3 671B  [arXiv:2412.19437].

MLA attention, 1 shared + 256 routed experts (top-8, sigmoid router,
first 3 layers dense), MTP auxiliary head.
"""
from repro_torch.configs.base import ArchConfig, MLAConfig, MoEConfig

CONFIG = ArchConfig(
    name="deepseek-v3-671b",
    family="moe",
    source="arXiv:2412.19437",
    n_layers=61,
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,
    d_ff=18432,            # dense-layer ffn width (first_k_dense layers)
    vocab=129280,
    head_dim=128,
    act="silu_gated",
    attn_kind="mla",
    rope_kind="rope",
    mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512,
                  qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128),
    moe=MoEConfig(n_experts=256, top_k=8, n_shared=1, d_expert=2048,
                  router="sigmoid", first_k_dense=3),
    mtp=True,
).validate()


def smoke() -> ArchConfig:
    return CONFIG.replace(
        n_layers=2, d_model=256, n_heads=4, n_kv_heads=4, head_dim=64,
        d_ff=512, vocab=512, max_seq=256,
        mla=MLAConfig(q_lora_rank=128, kv_lora_rank=64,
                      qk_nope_dim=64, qk_rope_dim=32, v_head_dim=64),
        # capacity_factor >= n_experts => lossless routing, so smoke tests
        # can assert exact prefill/decode equivalence
        moe=MoEConfig(n_experts=4, top_k=2, n_shared=1, d_expert=128,
                      router="sigmoid", first_k_dense=1, capacity_factor=4.0),
    ).validate()
