"""smollm-360m [dense]: llama-arch small. 32L d_model=960 15H (GQA kv=5)
d_ff=2560 vocab=49152.  [hf:HuggingFaceTB/SmolLM-360M; hf]"""
from repro_torch.models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="smollm-360m", family="dense",
        num_layers=32, d_model=960, num_heads=15, num_kv_heads=5,
        d_ff=2560, vocab_size=49152, head_dim=64,
        block_template=("attn_mlp",), rope_theta=1e4,
        norm="rmsnorm", tie_embeddings=True,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="smollm-360m-smoke", family="dense",
        num_layers=2, d_model=48, num_heads=3, num_kv_heads=1,
        d_ff=128, vocab_size=256, head_dim=16,
        block_template=("attn_mlp",), tie_embeddings=True,
    )
