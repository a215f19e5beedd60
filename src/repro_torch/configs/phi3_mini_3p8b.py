"""phi3-mini-3.8b [dense]: RoPE SwiGLU GQA. 32L d_model=3072 32H (kv=32)
d_ff=8192 vocab=32064.  [arXiv:2404.14219; unverified]"""
from repro_torch.models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="phi3-mini-3.8b", family="dense",
        num_layers=32, d_model=3072, num_heads=32, num_kv_heads=32,
        d_ff=8192, vocab_size=32064, head_dim=96,
        block_template=("attn_mlp",), rope_theta=1e4,
        norm="rmsnorm", tie_embeddings=False,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="phi3-mini-smoke", family="dense",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
        d_ff=160, vocab_size=256, head_dim=16,
        block_template=("attn_mlp",), tie_embeddings=False,
    )
