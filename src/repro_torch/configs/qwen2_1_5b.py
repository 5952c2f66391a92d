"""qwen2-1.5b [dense] — GQA, QKV bias [arXiv:2407.10671; hf]."""
from repro_torch.configs.base import ModelConfig

FULL = ModelConfig(
    name="qwen2-1.5b", family="dense",
    num_layers=28, d_model=1536, num_heads=12, num_kv_heads=2, head_dim=128,
    d_ff=8960, vocab_size=151936, qkv_bias=True, tie_embeddings=True,
    rope_theta=1e6,
)

def smoke() -> ModelConfig:
    return FULL.replace(
        num_layers=3, d_model=256, num_heads=4, num_kv_heads=2, head_dim=64,
        d_ff=512, vocab_size=512, sparse_block=64, attn_block=64,
        attn_chunk=128, dtype="float32",
    )
