"""Distribution, ported from ``repro.distributed``: the sharding rule
engine (`repro_torch.distributed.sharding`, specs only: nothing applies
them yet) and the fault-tolerance primitives
(`repro_torch.distributed.fault_tolerance`)."""
