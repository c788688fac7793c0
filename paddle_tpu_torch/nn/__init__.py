from . import functional, layer, quant

__all__ = ["functional", "layer", "quant"]
