"""Training, ported from ``repro.train``: AdamW with its schedule,
clipping and int8 error-feedback compression
(`repro_torch.train.optimizer`) and the train step with its FGW
distillation term (`repro_torch.train.loop`)."""
