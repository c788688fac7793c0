from . import quant

__all__ = ["quant"]
