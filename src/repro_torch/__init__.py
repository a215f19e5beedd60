"""PyTorch/CUDA port of the FGC-GW system (reference: the ``repro`` package).

``repro_torch.core`` holds the solvers, ``repro_torch.kernels`` the
hand-written CUDA kernels with their plain PyTorch versions, and
``repro_torch.convert`` carries the reference's objects across.  The port
imports neither JAX nor ``repro``.
"""
