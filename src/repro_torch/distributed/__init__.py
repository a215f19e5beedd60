"""Distribution, ported from ``repro.distributed``: the sharding rule
engine and its application to ``DTensor``s on a ``DeviceMesh``
(`repro_torch.distributed.sharding`) and the fault-tolerance primitives
(`repro_torch.distributed.fault_tolerance`)."""
