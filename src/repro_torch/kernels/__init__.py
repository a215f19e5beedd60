"""Hand-written Hopper kernels (``csrc/*.cu``) and their plain versions.

Reference: ``repro/kernels``.  ``ops`` holds the public wrappers and their
launch counters, ``build`` compiles the CUDA sources at first use.
"""
