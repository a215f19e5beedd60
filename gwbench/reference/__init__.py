"""The plain reference that decides ``correct``: entropic GW by mirror
descent written from the paper's equations in plain PyTorch, with dense
distance matrices and dense products.  It imports nothing of the program
(``repro_torch``), nor JAX, nor ``repro``."""
from gwbench.reference.gw import (Problem, Settings, Solution,  # noqa: F401
                                  energy, solve)
