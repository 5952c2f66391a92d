"""mamba2-130m [ssm] — SSD (state-space duality) [arXiv:2405.21060;
unverified]. Attention-free: the paper's attention sparsity is
inapplicable (DESIGN.md §5); pixelfly applies to out_proj (in_proj's
fused width 3352 is not block-divisible and stays dense)."""
from repro_torch.configs.base import ModelConfig

FULL = ModelConfig(
    name="mamba2-130m", family="ssm",
    num_layers=24, d_model=768, num_heads=0, num_kv_heads=0, head_dim=64,
    d_ff=0, vocab_size=50280, tie_embeddings=True,
    ssm_state=128, ssm_head_dim=64, ssm_expand=2,
)

def smoke() -> ModelConfig:
    return FULL.replace(
        num_layers=3, d_model=256, vocab_size=512, sparse_block=64,
        dtype="float32", ssm_state=32, ssm_head_dim=32, ssm_chunk=32,
    )
