"""kimi-k2-1t-a32b [moe] — trillion-param MoE, 384 routed experts top-8
+ 1 shared, first layer dense (paper-table config) [arXiv:2501.kimi2;
unverified]."""
from repro_torch.configs.base import ModelConfig

FULL = ModelConfig(
    name="kimi-k2-1t-a32b", family="moe",
    num_layers=61, d_model=7168, num_heads=64, num_kv_heads=8, head_dim=128,
    d_ff=2048, vocab_size=163840, rope_theta=50000.0,
    moe_num_experts=384, moe_top_k=8, moe_num_shared=1, moe_d_ff=2048,
    moe_first_dense=1, moe_dense_ff=18432,
)

def smoke() -> ModelConfig:
    return FULL.replace(
        num_layers=3, d_model=256, num_heads=4, num_kv_heads=2, head_dim=64,
        d_ff=256, vocab_size=512, sparse_block=64, attn_block=64,
        attn_chunk=128, dtype="float32",
        moe_num_experts=8, moe_top_k=2, moe_num_shared=1, moe_d_ff=256,
        moe_first_dense=1, moe_dense_ff=512,
    )
