"""qwen2-vl-7b [vlm] — M-RoPE, dynamic resolution [arXiv:2409.12191; hf].

Backbone only: the vision frontend is a stub; the caller supplies
precomputed patch embeddings (B, S, d_model) plus (B, S, 3) M-RoPE
position streams (temporal/height/width).
"""
from repro_torch.configs.base import ModelConfig

FULL = ModelConfig(
    name="qwen2-vl-7b", family="vlm",
    num_layers=28, d_model=3584, num_heads=28, num_kv_heads=4, head_dim=128,
    d_ff=18944, vocab_size=152064, qkv_bias=True, rope_theta=1e6,
    mrope_sections=(16, 24, 24), embed_inputs=False,
)

def smoke() -> ModelConfig:
    return FULL.replace(
        num_layers=3, d_model=256, num_heads=4, num_kv_heads=2, head_dim=64,
        d_ff=512, vocab_size=512, sparse_block=64, attn_block=64,
        attn_chunk=128, dtype="float32", mrope_sections=(8, 12, 12),
    )
