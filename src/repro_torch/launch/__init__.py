"""Launch layer, ported from ``repro.launch``: the serving driver
(`repro_torch.launch.serve`).  The reference's mesh, specs, dry-run and
train drivers come with the LM substrate."""
