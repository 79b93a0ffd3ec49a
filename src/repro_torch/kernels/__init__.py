"""Hand-written CUDA kernels of the port, with their plain PyTorch versions.

Every wrapper follows one rule: a tensor on the CPU goes to the kernel's
plain PyTorch version (``ref.py``); a CUDA tensor launches the kernel,
built from ``csrc/`` on first use (see `build`), or the wrapper raises.
There is no fallback from a failed launch to the plain version. Each
launch adds one to the wrapper's entry in `LAUNCHES`.
"""

from __future__ import annotations

import functools

import torch

__all__ = ["LAUNCHES", "launch_counts", "reset_launch_counts", "DTYPE_CODES",
           "check_operand", "stream_of", "sm_count"]

# Launches of each kernel since the last reset, by wrapper.
# `gemm_tensor_core` and `gemm_ffma` count the launches of `matmul` and
# `schur_update` again, by the GEMM body that ran them.
LAUNCHES: dict[str, int] = {"matmul": 0, "schur_update": 0,
                            "gemm_tensor_core": 0, "gemm_ffma": 0,
                            "gauss_jordan": 0, "blocked_gauss_jordan": 0,
                            "triangular_solve": 0, "flash_attention": 0,
                            "flash_attention_bwd": 0}

# Element types the kernels take, by their code in csrc/gemm_tile.cuh.
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def launch_counts() -> dict[str, int]:
    return dict(LAUNCHES)


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def check_operand(t: torch.Tensor, name: str, ndim: int) -> None:
    """Raise unless `t` is an operand some kernel or its plain version takes."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got {type(t).__name__}")
    if t.ndim != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got {tuple(t.shape)}")
    if t.dtype not in DTYPE_CODES:
        raise ValueError(f"{name} has dtype {t.dtype}; the kernels take "
                         f"{sorted(str(d) for d in DTYPE_CODES)}")
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} lies on {t.device}; want cpu or cuda")


def stream_of(t: torch.Tensor) -> int:
    """The handle of PyTorch's current stream on `t`'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """Streaming multiprocessors of card `index`."""
    return torch.cuda.get_device_properties(index).multi_processor_count
