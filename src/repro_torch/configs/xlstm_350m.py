"""xlstm-350m [ssm]: sLSTM + mLSTM blocks (7:1 ratio). 24L d_model=1024 4H
d_ff=0 vocab=50304.  [arXiv:2405.04517; unverified]"""
from repro_torch.models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="xlstm-350m", family="ssm",
        num_layers=24, d_model=1024, num_heads=4, num_kv_heads=4,
        d_ff=0, vocab_size=50304,
        block_template=("slstm",) + ("mlstm",) * 7,   # xLSTM[7:1] × 3
        ssm_expand=2, norm="rmsnorm", tie_embeddings=True,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="xlstm-smoke", family="ssm",
        num_layers=2, d_model=64, num_heads=2, num_kv_heads=2,
        d_ff=0, vocab_size=256,
        block_template=("slstm", "mlstm"),
        ssm_expand=2, tie_embeddings=True,
    )
