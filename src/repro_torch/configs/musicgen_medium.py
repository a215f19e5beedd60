"""musicgen-medium [audio]: decoder-only over EnCodec tokens. 48L
d_model=1536 24H (kv=24) d_ff=6144 vocab=2048.  [arXiv:2306.05284; hf]

Backbone only: the EnCodec frontend is a STUB — ``input_specs()`` provides
precomputed frame embeddings (the four-codebook delay-pattern sum)."""
from repro_torch.models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="musicgen-medium", family="audio",
        num_layers=48, d_model=1536, num_heads=24, num_kv_heads=24,
        d_ff=6144, vocab_size=2048, head_dim=64,
        block_template=("attn_mlp",), rope_theta=1e4,
        norm="layernorm", input_mode="embeddings", tie_embeddings=False,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="musicgen-smoke", family="audio",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
        d_ff=160, vocab_size=128, head_dim=16,
        block_template=("attn_mlp",), norm="layernorm",
        input_mode="embeddings", tie_embeddings=False,
    )
