"""Serving-side quantization (counterpart of the serving part of
``paddle_tpu/quantization``): the engine's ``quant_config`` and the PTQ
export of a parameter tree.  The layer-graph PTQ / QAT of the JAX package
is not ported."""

from .serve import (ServeQuantConfig, calibrate_weight_thresholds,  # noqa: F401
                    dequantize_block_weight, quantize_params_for_serving,
                    quantized_leaf_names)

__all__ = ["ServeQuantConfig", "quantize_params_for_serving",
           "calibrate_weight_thresholds", "dequantize_block_weight",
           "quantized_leaf_names"]
