"""Counterpart of ``paddle_tpu.optimizer`` for eager training: ``Adam`` and
``AdamW``."""

from .optimizers import Adam, AdamW

__all__ = ["Adam", "AdamW"]
