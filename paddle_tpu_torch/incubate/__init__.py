"""Counterpart of ``paddle_tpu.incubate``: the fused functional API and
layers (:mod:`.nn`) and the softmax calls of :mod:`.extras`."""
from . import nn
from .extras import softmax_mask_fuse, softmax_mask_fuse_upper_triangle

__all__ = ["nn", "softmax_mask_fuse", "softmax_mask_fuse_upper_triangle"]
