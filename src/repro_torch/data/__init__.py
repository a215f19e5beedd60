"""Data pipeline, ported from ``repro.data``: the deterministic synthetic
token stream and memmap token shards (`repro_torch.data.pipeline`)."""
