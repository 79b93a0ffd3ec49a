from . import ops, ref
from .kernel import matmul_cuda, schur_update_cuda

__all__ = ["ops", "ref", "matmul_cuda", "schur_update_cuda"]
