"""Device resolution for the port's entry points.

Every entry point takes ``device=`` and defaults to ``"cuda"``. When the
card is missing the call raises: the port never slips onto the CPU unless
the caller asked for it by passing ``device="cpu"``. The ``meta`` device
(shapes and dtypes, no storage) is accepted only where a caller names it
and the callee says it takes it (``allow_meta=True``): a mesh of ``meta``
devices for the dry run (`launch.dryrun`). No entry point resolves to it.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device", "DEFAULT_DEVICE"]

DEFAULT_DEVICE = "cuda"


def resolve_device(device: str | torch.device = DEFAULT_DEVICE, *,
                   allow_meta: bool = False) -> torch.device:
    """The torch device to run on; raises when CUDA is asked for but absent.
    `meta` passes only with `allow_meta=True`."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available on this machine; pass device='cpu' to "
            "run the plain PyTorch versions on the CPU")
    if dev.type == "meta" and allow_meta:
        return dev
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; want 'cuda' or 'cpu'")
    return dev
