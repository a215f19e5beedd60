"""Launch layer, ported from ``repro.launch``: the serving driver
(`repro_torch.launch.serve`, LM generation and GW serving).  The
reference's train, mesh, specs, dry-run, flops and collectives modules
come with the trainer."""
