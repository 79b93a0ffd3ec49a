from . import ops, ref
from .kernel import SUPPORTED_HEAD_DIMS, flash_attention_cuda

__all__ = ["ops", "ref", "flash_attention_cuda", "SUPPORTED_HEAD_DIMS"]
