"""deepseek-67b [dense] — llama-arch [arXiv:2401.02954; hf]."""
from repro_torch.configs.base import ModelConfig

FULL = ModelConfig(
    name="deepseek-67b", family="dense",
    num_layers=95, d_model=8192, num_heads=64, num_kv_heads=8, head_dim=128,
    d_ff=22016, vocab_size=102400, rope_theta=10000.0,
)

def smoke() -> ModelConfig:
    return FULL.replace(
        num_layers=3, d_model=256, num_heads=4, num_kv_heads=2, head_dim=64,
        d_ff=512, vocab_size=512, sparse_block=64, attn_block=64,
        attn_chunk=128, dtype="float32",
    )
