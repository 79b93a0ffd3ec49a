from . import ops

__all__ = ["ops"]
