from .registry import ArchConfig, MoEConfig, SSMConfig, get_arch, list_archs
from .shapes import SHAPES, ShapeConfig, cell_status

__all__ = ["ArchConfig", "MoEConfig", "SSMConfig", "get_arch", "list_archs",
           "SHAPES", "ShapeConfig", "cell_status"]
