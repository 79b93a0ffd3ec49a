from . import attention, embedding, layers, transformer

__all__ = ["attention", "embedding", "layers", "transformer"]
