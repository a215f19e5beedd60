"""Launch layer, ported from ``repro.launch``: the serving driver
(`repro_torch.launch.serve`, LM generation and GW serving), the training
driver (`repro_torch.launch.train`), the FLOP accounting
(`repro_torch.launch.flops`), the mesh factories
(`repro_torch.launch.mesh`) and the collectives of a profiled window
(`repro_torch.launch.collectives`, from a ``torch.profiler`` trace where
the reference parses HLO).

Not ported, because each has no counterpart without XLA: ``dryrun.py``
(lowers for 512 forced XLA host devices; its serve cell, prefill and
decode on a mesh, runs as `repro_torch.models.lm` on ``DTensor``s).
``specs.py``'s ``ShapeDtypeStruct`` stand-ins are, in the port, a model on
the ``meta`` device (`repro_torch.launch.flops.meta_shapes`, as
`repro_torch.convert.lm_model` builds one).  The reference's
``compat.py`` shims JAX versions; the port has nothing to shim.
"""
