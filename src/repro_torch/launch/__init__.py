"""Launch layer, ported from ``repro.launch``: the serving driver
(`repro_torch.launch.serve`, LM generation and GW serving), the training
driver (`repro_torch.launch.train`), the FLOP and byte accounting
(`repro_torch.launch.flops`), the mesh factories
(`repro_torch.launch.mesh`), the collectives of a profiled window
(`repro_torch.launch.collectives`, from a ``torch.profiler`` trace where
the reference parses HLO), the input stand-ins on the ``meta`` device
(`repro_torch.launch.specs`) and the production dry run
(`repro_torch.launch.dryrun`: one rank's real shards of each cell's step
on a fake group of 256 or 512 ranks).  The reference's ``compat.py``
shims JAX versions; the port has nothing to shim.
"""
