from . import ops, ref
from .kernel import (SUPPORTED_HEAD_DIMS, FlashAttentionFn,
                     flash_attention_bwd_cuda, flash_attention_cuda)

__all__ = ["ops", "ref", "flash_attention_cuda", "flash_attention_bwd_cuda",
           "FlashAttentionFn", "SUPPORTED_HEAD_DIMS"]
