"""mixtral-8x22b [moe]: 8 experts top-2, sliding-window attention. 56L
d_model=6144 48H (kv=8) d_ff=16384 vocab=32768.  [arXiv:2401.04088; hf]"""
from repro_torch.models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mixtral-8x22b", family="moe",
        num_layers=56, d_model=6144, num_heads=48, num_kv_heads=8,
        d_ff=16384, vocab_size=32768, head_dim=128,
        block_template=("attn_moe",),
        num_experts=8, num_experts_per_tok=2, moe_d_ff=16384,
        sliding_window=4096, rope_theta=1e6,
        norm="rmsnorm", tie_embeddings=False,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="mixtral-smoke", family="moe",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        d_ff=128, vocab_size=256, head_dim=16,
        block_template=("attn_moe",),
        num_experts=4, num_experts_per_tok=2, moe_d_ff=128,
        moe_capacity_factor=4.0, moe_group_size=64,
        sliding_window=32, tie_embeddings=False,
    )
