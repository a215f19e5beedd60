"""deepseek-v2-lite-16b [moe]: MLA kv_lora=512, MoE 64 routed top-6 + 2
shared, first layer dense. 27L d_model=2048 16H d_ff(dense)=10944
moe_d_ff=1408 vocab=102400.  [arXiv:2405.04434; hf]

Note (DESIGN.md): the assignment note "160 routed" matches DeepSeek-V2
*full*; the header "MoE 64e top-6" matches the official v2-lite card, which
we follow."""
from repro_torch.models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-lite-16b", family="moe",
        num_layers=27, d_model=2048, num_heads=16, num_kv_heads=16,
        d_ff=10944, vocab_size=102400,
        prologue=("mla_mlp",), block_template=("mla_moe",),
        num_experts=64, num_experts_per_tok=6, num_shared_experts=2,
        moe_d_ff=1408,
        kv_lora_rank=512, qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128,
        rope_theta=1e4, norm="rmsnorm", tie_embeddings=False,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-lite-smoke", family="moe",
        num_layers=3, d_model=64, num_heads=4, num_kv_heads=4,
        d_ff=128, vocab_size=256,
        prologue=("mla_mlp",), block_template=("mla_moe",),
        num_experts=4, num_experts_per_tok=2, num_shared_experts=1,
        moe_d_ff=32,
        kv_lora_rank=32, qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16,
        moe_capacity_factor=4.0, moe_group_size=64,
        tie_embeddings=False,
    )
