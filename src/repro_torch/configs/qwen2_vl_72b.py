"""qwen2-vl-72b [vlm]: M-RoPE, dynamic resolution. 80L d_model=8192 64H
(kv=8) d_ff=29568 vocab=152064.  [arXiv:2409.12191; hf]

Backbone only per the assignment: the vision frontend is a STUB —
``input_specs()`` provides precomputed patch embeddings (B,S,d_model) and
(t,h,w) M-RoPE position ids."""
from repro_torch.models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-72b", family="vlm",
        num_layers=80, d_model=8192, num_heads=64, num_kv_heads=8,
        d_ff=29568, vocab_size=152064, head_dim=128,
        block_template=("attn_mlp",), rope_theta=1e6, m_rope=True,
        norm="rmsnorm", input_mode="embeddings", tie_embeddings=False,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-smoke", family="vlm",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        d_ff=160, vocab_size=256, head_dim=16, m_rope=True,
        block_template=("attn_mlp",), input_mode="embeddings",
        tie_embeddings=False,
    )
