"""Checkpointing, ported from ``repro.checkpoint``: atomic, async
checkpoints with keep-k GC and restore onto any device
(`repro_torch.checkpoint.manager`)."""
