"""Model zoo, ported from ``repro.models``: dense GQA / MoE / MLA / xLSTM /
Mamba2 / hybrid LM backbones as `torch.nn.Module`s, on the reference's
parameter layouts."""
from repro_torch.models.common import ModelConfig
from repro_torch.models import lm, blocks, attention, mlp, ssm, common  # noqa: F401

__all__ = ["ModelConfig", "lm", "blocks", "attention", "mlp", "ssm",
           "common"]
