"""The benchmark of the PyTorch/CUDA port (``repro_torch``).

One cell is one entry of ``workloads`` in ``BENCHMARK.json``: a
configuration under a traffic mix.  Everything that belongs to one of them
sits in a file of its own, found by its name:

  configs/<config>.json     the geometry, dtype and solver settings run,
                            the guarantees stated and the control's path
  traffic/<mix>.json        the parameters of one mix and the driver kind
                            that runs it (``drivers/<kind>.py``)
  limits/<cell>.json        the limit of each number ``correct`` compares
  metrics/<metric>.py       one per-layer metric: ``read(ctx)`` returns a
                            number, or None where the run has nothing to read

The yardstick lives here too: `work` counts a solve's operations and bytes
from shapes and iteration counts, `peaks` holds the card's published peaks,
`trace` reduces a profiler trace, `reference` is the plain reference that
decides ``correct`` and `check` compares with it.  Nothing here imports JAX,
``repro`` or ``benchmarks``; `reference` imports nothing of ``repro_torch``.

Run a cell with ``python3 gwbench/run.py --workload <cell> --seed <n>
--seconds <s> --trace <0|1>``.
"""
