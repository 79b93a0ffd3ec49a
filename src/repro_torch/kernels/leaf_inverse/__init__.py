from . import ops, ref
from .kernel import (blocked_leaf_inverse_cuda, default_panel, leaf_inverse_cuda,
                     triangular_solve_cuda)

__all__ = ["ops", "ref", "leaf_inverse_cuda", "blocked_leaf_inverse_cuda",
           "triangular_solve_cuda", "default_panel"]
