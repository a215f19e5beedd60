"""starcoder2-15b [dense]: GQA, RoPE, LayerNorm. 40L d_model=6144 48H (kv=4)
d_ff=24576 vocab=49152.  [arXiv:2402.19173; hf]"""
from repro_torch.models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="starcoder2-15b", family="dense",
        num_layers=40, d_model=6144, num_heads=48, num_kv_heads=4,
        d_ff=24576, vocab_size=49152, head_dim=128,
        block_template=("attn_mlp",), rope_theta=1e5,
        norm="layernorm", tie_embeddings=False,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="starcoder2-smoke", family="dense",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        d_ff=192, vocab_size=256, head_dim=16,
        block_template=("attn_mlp",), norm="layernorm",
        tie_embeddings=False,
    )
