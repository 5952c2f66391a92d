"""smollm-360m [dense] — llama-arch small [hf:HuggingFaceTB/SmolLM; hf].

d_model=960 is not a multiple of 128, so the pixelfly block is 64 for this
arch (the port's kernels take blocks 64 and 128).
"""
from repro_torch.configs.base import ModelConfig

FULL = ModelConfig(
    name="smollm-360m", family="dense",
    num_layers=32, d_model=960, num_heads=15, num_kv_heads=5, head_dim=64,
    d_ff=2560, vocab_size=49152, tie_embeddings=True, rope_theta=10000.0,
    sparse_block=64,
)

def smoke() -> ModelConfig:
    return FULL.replace(
        num_layers=3, d_model=192, num_heads=3, num_kv_heads=1, head_dim=64,
        d_ff=512, vocab_size=512, sparse_block=64, attn_block=64,
        attn_chunk=128, dtype="float32",
    )
