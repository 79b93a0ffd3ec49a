"""repro_torch.optim — AdamW and SPIN-Shampoo (whose factor inversions run
through the SPIN kernels), and the LR schedules."""

from .adamw import AdamWConfig, AdamWState, adamw_init, adamw_update, global_norm
from .spin_shampoo import (SpinShampooConfig, SpinShampooState, invert_spd,
                           spin_shampoo_init, spin_shampoo_update)
from . import schedule

__all__ = ["AdamWConfig", "AdamWState", "adamw_init", "adamw_update",
           "global_norm", "SpinShampooConfig", "SpinShampooState",
           "spin_shampoo_init", "spin_shampoo_update", "invert_spd", "schedule"]
