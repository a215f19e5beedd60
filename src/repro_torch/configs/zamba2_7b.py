"""zamba2-7b [hybrid]: Mamba2 backbone + shared attention blocks. 81L
d_model=3584 32H (kv=32) d_ff=14336 ssm_state=64 vocab=32000.
[arXiv:2411.15242; unverified]

Structure: 3 mamba prologue + (5×mamba + shared-attn) × 13 = 81 layers;
the attention+MLP block's params are SHARED across its 13 occurrences
(each occurrence keeps its own KV cache)."""
from repro_torch.models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-7b", family="hybrid",
        num_layers=81, d_model=3584, num_heads=32, num_kv_heads=32,
        d_ff=14336, vocab_size=32000, head_dim=112,
        prologue=("mamba", "mamba", "mamba"),
        block_template=("mamba", "mamba", "mamba", "mamba", "mamba",
                        "shared_attn"),
        shared_slots=(5,),
        ssm_state=64, ssm_expand=2, conv_width=4,
        rope_theta=1e4, norm="rmsnorm", tie_embeddings=False,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="zamba2-smoke", family="hybrid",
        num_layers=3, d_model=64, num_heads=2, num_kv_heads=2,
        d_ff=128, vocab_size=256, head_dim=32,
        prologue=("mamba",),
        block_template=("mamba", "shared_attn"),
        shared_slots=(1,),
        ssm_state=16, ssm_expand=2, conv_width=4,
        tie_embeddings=False,
    )
