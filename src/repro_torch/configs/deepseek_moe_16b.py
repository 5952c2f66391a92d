"""deepseek-moe-16b [moe] — 2 shared + 64 routed top-6, fine-grained
[arXiv:2401.06066; hf]. First layer is a dense MLP (d_ff 10944)."""
from repro_torch.configs.base import ModelConfig

FULL = ModelConfig(
    name="deepseek-moe-16b", family="moe",
    num_layers=28, d_model=2048, num_heads=16, num_kv_heads=16, head_dim=128,
    d_ff=1408, vocab_size=102400, rope_theta=10000.0,
    moe_num_experts=64, moe_top_k=6, moe_num_shared=2, moe_d_ff=1408,
    moe_first_dense=1, moe_dense_ff=10944,
)

def smoke() -> ModelConfig:
    return FULL.replace(
        num_layers=3, d_model=256, num_heads=4, num_kv_heads=4, head_dim=64,
        d_ff=256, vocab_size=512, sparse_block=64, attn_block=64,
        attn_chunk=128, dtype="float32",
        moe_num_experts=8, moe_top_k=2, moe_num_shared=2, moe_d_ff=256,
        moe_first_dense=1, moe_dense_ff=512,
    )
