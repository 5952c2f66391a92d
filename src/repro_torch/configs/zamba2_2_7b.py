"""zamba2-2.7b [hybrid] — Mamba2 blocks + a shared attention block
[arXiv:2411.15242; hf]. 54 layers as 9 cycles of (5 Mamba2 + 1 shared
attn+MLP block); the attention block's parameters are shared across all 9
positions (Zamba's signature trick)."""
from repro_torch.configs.base import ModelConfig

FULL = ModelConfig(
    name="zamba2-2.7b", family="hybrid",
    num_layers=54, d_model=2560, num_heads=32, num_kv_heads=32, head_dim=80,
    d_ff=10240, vocab_size=32000, rope_theta=10000.0,
    ssm_state=64, ssm_head_dim=64, ssm_expand=2, attn_every=6,
)

def smoke() -> ModelConfig:
    return FULL.replace(
        num_layers=6, d_model=256, num_heads=4, num_kv_heads=4, head_dim=64,
        d_ff=512, vocab_size=512, sparse_block=64, attn_block=64,
        attn_chunk=128, dtype="float32", ssm_state=32, ssm_head_dim=32,
        attn_every=3, ssm_chunk=32,
    )
