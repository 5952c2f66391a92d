"""qwen3-1.7b [dense] — qk_norm, GQA [hf:Qwen/Qwen3-8B family; hf]."""
from repro_torch.configs.base import ModelConfig

FULL = ModelConfig(
    name="qwen3-1.7b", family="dense",
    num_layers=28, d_model=2048, num_heads=16, num_kv_heads=8, head_dim=128,
    d_ff=6144, vocab_size=151936, qk_norm=True, tie_embeddings=True,
    rope_theta=1e6,
)


def smoke() -> ModelConfig:
    return FULL.replace(
        num_layers=3, d_model=256, num_heads=4, num_kv_heads=2, head_dim=64,
        d_ff=512, vocab_size=512, sparse_block=64, attn_block=64,
        attn_chunk=128, dtype="float32",
    )
