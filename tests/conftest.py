"""Test config: x64 for solver precision (paper validates to ~1e-15).

NOTE: XLA_FLAGS / device-count overrides are deliberately NOT set here —
smoke tests and benches must see the real single device; only
launch/dryrun.py (a subprocess in tests) requests 512 host devices.
"""
import jax

jax.config.update("jax_enable_x64", True)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card and nvcc (the port's CUDA "
        "kernels); skips without one")
