"""Launch layer, ported from ``repro.launch``: the serving driver
(`repro_torch.launch.serve`, LM generation and GW serving), the training
driver (`repro_torch.launch.train`) and the FLOP accounting
(`repro_torch.launch.flops`).

Not ported, because each has no counterpart without a process group or
XLA: ``mesh.py`` (a ``DeviceMesh`` needs a process group; it comes with
applying `repro_torch.distributed.sharding`'s specs), ``dryrun.py``
(lowers for 512 forced XLA host devices), ``collectives.py`` (parses XLA
HLO text, which the port does not emit; counting NCCL calls in a profiler
trace comes with a multi-chip path).  ``specs.py``'s ``ShapeDtypeStruct``
stand-ins are, in the port, a model on the ``meta`` device
(`repro_torch.launch.flops.meta_shapes`, as `repro_torch.convert.lm_model`
builds one).  The reference's ``compat.py`` shims JAX versions; the port
has nothing to shim.
"""
