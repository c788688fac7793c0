from . import functional
from .layer import (FusedBiasDropoutResidualLayerNorm, FusedDropout,
                    FusedDropoutAdd, FusedFeedForward, FusedLinear,
                    FusedMultiHeadAttention, FusedMultiTransformer,
                    FusedTransformer, FusedTransformerEncoderLayer)

__all__ = ["functional", "FusedMultiHeadAttention", "FusedFeedForward",
           "FusedTransformerEncoderLayer", "FusedLinear", "FusedDropout",
           "FusedDropoutAdd", "FusedBiasDropoutResidualLayerNorm",
           "FusedMultiTransformer", "FusedTransformer"]
