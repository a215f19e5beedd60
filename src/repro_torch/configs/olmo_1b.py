"""olmo-1b [dense]: non-parametric LN. 16L d_model=2048 16H (kv=16)
d_ff=8192 vocab=50304.  [arXiv:2402.00838; hf]"""
from repro_torch.models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="olmo-1b", family="dense",
        num_layers=16, d_model=2048, num_heads=16, num_kv_heads=16,
        d_ff=8192, vocab_size=50304, head_dim=128,
        block_template=("attn_mlp",), rope_theta=1e4,
        norm="layernorm_nonparam", tie_embeddings=True,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="olmo-smoke", family="dense",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
        d_ff=160, vocab_size=256, head_dim=16,
        block_template=("attn_mlp",), norm="layernorm_nonparam",
        tie_embeddings=True,
    )
