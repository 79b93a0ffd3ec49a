"""Hand-written CUDA kernels of the port, with their plain PyTorch versions.

Every wrapper follows one rule: a tensor on the CPU goes to the kernel's
plain PyTorch version (``ref.py``); a CUDA tensor launches the kernel,
built from ``csrc/`` on first use (see `build`), or the wrapper raises.
There is no fallback from a failed launch to the plain version. Each
launch adds one to the wrapper's entry in `LAUNCHES`.

The flash attention wrappers also take ``meta`` tensors (shapes and
dtypes, no storage), for the dry run (`launch.dryrun`): they return empty
outputs of the kernel's shapes and dtypes and book the work the kernel
would do in `BOOKED` (calls, operations, bytes); nothing is built or
launched, and `LAUNCHES` does not move. No other wrapper takes them.
"""

from __future__ import annotations

import functools

import torch

__all__ = ["LAUNCHES", "launch_counts", "reset_launch_counts", "BOOKED", "book",
           "booked", "reset_booked", "DTYPE_CODES", "check_operand", "stream_of",
           "sm_count"]

# Launches of each kernel since the last reset, by wrapper.
# `gemm_tensor_core` and `gemm_ffma` count the launches of `matmul` and
# `schur_update` again, by the GEMM body that ran them.
LAUNCHES: dict[str, int] = {"matmul": 0, "schur_update": 0,
                            "gemm_tensor_core": 0, "gemm_ffma": 0,
                            "gauss_jordan": 0, "blocked_gauss_jordan": 0,
                            "triangular_solve": 0, "flash_attention": 0,
                            "flash_attention_bwd": 0}

# Work booked by the meta branches since the last reset, by wrapper.
BOOKED: dict[str, dict[str, int]] = {
    name: {"calls": 0, "flops": 0, "bytes": 0}
    for name in ("flash_attention", "flash_attention_bwd")}

# Element types the kernels take, by their code in csrc/gemm_tile.cuh.
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def launch_counts() -> dict[str, int]:
    return dict(LAUNCHES)


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def book(name: str, flops: int, nbytes: int) -> None:
    """Book one call of `name`'s kernel on meta operands."""
    entry = BOOKED[name]
    entry["calls"] += 1
    entry["flops"] += flops
    entry["bytes"] += nbytes


def booked() -> dict[str, dict[str, int]]:
    return {name: dict(entry) for name, entry in BOOKED.items()}


def reset_booked() -> None:
    for entry in BOOKED.values():
        for key in entry:
            entry[key] = 0


def check_operand(t: torch.Tensor, name: str, ndim: int, meta_ok: bool = False) -> None:
    """Raise unless `t` is an operand some kernel or its plain version takes
    (a ``meta`` tensor only where `meta_ok`)."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got {type(t).__name__}")
    if t.ndim != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got {tuple(t.shape)}")
    if t.dtype not in DTYPE_CODES:
        raise ValueError(f"{name} has dtype {t.dtype}; the kernels take "
                         f"{sorted(str(d) for d in DTYPE_CODES)}")
    if t.device.type not in ("cpu", "cuda") and not (meta_ok and t.device.type == "meta"):
        raise ValueError(f"{name} lies on {t.device}; want cpu or cuda")


def stream_of(t: torch.Tensor) -> int:
    """The handle of PyTorch's current stream on `t`'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """Streaming multiprocessors of card `index`."""
    return torch.cuda.get_device_properties(index).multi_processor_count
