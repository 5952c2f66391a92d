"""musicgen-large [audio] — decoder-only over EnCodec tokens
[arXiv:2306.05284; hf]. The EnCodec frontend is a stub: the caller
provides precomputed frame embeddings; logits are over the 2048-entry
codebook vocab."""
from repro_torch.configs.base import ModelConfig

FULL = ModelConfig(
    name="musicgen-large", family="audio",
    num_layers=48, d_model=2048, num_heads=32, num_kv_heads=32, head_dim=64,
    d_ff=8192, vocab_size=2048, rope_theta=10000.0, embed_inputs=False,
)

def smoke() -> ModelConfig:
    return FULL.replace(
        num_layers=3, d_model=256, num_heads=4, num_kv_heads=4, head_dim=64,
        d_ff=512, vocab_size=256, sparse_block=64, attn_block=64,
        attn_chunk=128, dtype="float32",
    )
