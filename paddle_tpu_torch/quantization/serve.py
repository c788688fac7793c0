"""Serving-side quantization: the PTQ export the engine consumes
(counterpart of ``paddle_tpu/quantization/serve.py``).

* :class:`ServeQuantConfig` — the engine's ``quant_config``: weight
  storage (int8 / int4, per output channel or groups of 64 / 128 input
  rows) and the paged-KV pool's storage (int8).
* :func:`quantize_params_for_serving` — a parameter tree -> the
  ``<name>__q`` (int8 codes; int4 halves-packed) / ``<name>__s`` (fp32
  scales) leaf layout that ``ops.decode_block`` reads.  The export runs in
  torch on the parameters' own device, one layer's matrix at a time, so a
  7B tree exports in seconds on the card.  Its codes and scales equal the
  JAX package's numpy export (``_quantize_matrix``) bit for bit: fp32
  absmax, ``max(absmax, 1e-8) / qmax`` by an IEEE division, round half to
  even, clip to ``[-qmax - 1, qmax]``, int4 packed in halves.

Weight-only means exactly that: norms, the embedding and the head stay at
the model dtype; only the block matmul weights are stored as codes.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from ..nn.quant import absmax_of, codes_of, weight_dequantize

__all__ = ["ServeQuantConfig", "quantize_params_for_serving",
           "calibrate_weight_thresholds", "dequantize_block_weight",
           "quantized_leaf_names"]

_WEIGHT_DTYPES = (None, "int8", "int4")
_KV_DTYPES = (None, "int8")
_GROUP_SIZES = (-1, 64, 128)


@dataclasses.dataclass(frozen=True)
class ServeQuantConfig:
    """The engine's quantization knob.

    ``weight_dtype``: None (full width) / "int8" / "int4" — storage of
    the block matmul weights (``__q`` codes + ``__s`` fp32 scales).
    ``group_size``: -1 = one scale per output channel; 64 / 128 = one
    scale per (input-row group, channel).
    ``kv_dtype``: None / "int8" — paged-KV pool storage; int8 pools carry
    one fp32 scale per (token, head) (``ops.paged_kv.QuantizedKVPool``).
    """
    weight_dtype: Optional[str] = None
    group_size: int = -1
    kv_dtype: Optional[str] = None

    def __post_init__(self):
        if self.weight_dtype not in _WEIGHT_DTYPES:
            raise ValueError(f"weight_dtype must be one of "
                             f"{_WEIGHT_DTYPES}, got {self.weight_dtype!r}")
        if self.kv_dtype not in _KV_DTYPES:
            raise ValueError(f"kv_dtype must be one of {_KV_DTYPES}, "
                             f"got {self.kv_dtype!r}")
        if self.group_size not in _GROUP_SIZES:
            raise ValueError(f"group_size must be one of {_GROUP_SIZES},"
                             f" got {self.group_size}")
        if self.weight_dtype is None and self.group_size != -1:
            raise ValueError("group_size without weight_dtype is "
                             "meaningless — set weight_dtype")

    @property
    def quantized_weights(self) -> bool:
        return self.weight_dtype is not None

    @property
    def quantized_kv(self) -> bool:
        return self.kv_dtype is not None

    @property
    def algo(self) -> Optional[str]:
        """The ``nn.quant.weight_quantize`` algo string."""
        if self.weight_dtype is None:
            return None
        return f"weight_only_{self.weight_dtype}"

    def describe(self) -> Dict[str, object]:
        """A stable dict of the three fields."""
        return {"weight_dtype": self.weight_dtype,
                "group_size": self.group_size,
                "kv_dtype": self.kv_dtype}


def quantized_leaf_names(name: str):
    """(codes, scales) leaf names for a quantized matmul weight."""
    return name + "__q", name + "__s"


def _is_block_matmul(name: str, v) -> bool:
    """A quantizable block leaf: a stacked matmul weight, not a norm gain,
    a bias or an already-quantized leaf."""
    return (name.endswith("_w") and v.ndim >= 3
            and not name.startswith("ln") and "__" not in name)


def _layers(v: torch.Tensor) -> torch.Tensor:
    """A stacked ``[*lead, K, N]`` weight as ``[L, K, N]``."""
    return v.reshape((-1,) + tuple(v.shape[-2:]))


@torch.no_grad()
def calibrate_weight_thresholds(params) -> Dict[str, torch.Tensor]:
    """The per-channel absmax of every quantizable block weight, one row a
    layer: ``{leaf name: [L, N] fp32}`` — the statistic the JAX package's
    ``PerChannelAbsMaxObserver`` takes over each layer's matrix (absmax
    over the input rows; weight-only PTQ calibrates on the weights)."""
    out: Dict[str, torch.Tensor] = {}
    for name, v in params["blocks"].items():
        if _is_block_matmul(name, v):
            out[name] = torch.stack([w.abs().amax(dim=0).float()
                                     for w in _layers(v)])
    return out


def _quantize_matrix(w: torch.Tensor, config: ServeQuantConfig,
                     thresholds=None):
    """One ``[K, N]`` matrix -> ``(codes, fp32 scales)`` under ``config``.

    ``thresholds``: a calibrated per-channel absmax ``[N]``, taken for
    per-channel int8 only (grouped and int4 scales re-derive the absmax of
    each group)."""
    wf = w.float()
    gs = config.group_size
    int4 = config.weight_dtype == "int4"
    if thresholds is not None and not int4 and gs == -1:
        th = thresholds if isinstance(thresholds, torch.Tensor) else \
            torch.from_numpy(np.asarray(thresholds, np.float32))
        absmax = th.to(device=wf.device, dtype=torch.float32).reshape(-1)
    else:
        absmax = absmax_of(wf, gs)
    qmax = 7.0 if int4 else 127.0
    # an IEEE division by a tensor, as numpy divides: a Python scalar
    # divisor may become a product with its reciprocal on the card
    scale = absmax.clamp_min(1e-8) / torch.full_like(absmax, qmax)
    return codes_of(wf, scale, gs, int4), scale


@torch.no_grad()
def quantize_params_for_serving(params, config: ServeQuantConfig,
                                thresholds: Optional[Dict] = None):
    """PTQ export: a parameter tree -> the engine's quantized tree.

    Every stacked block matmul weight ``<name>`` (``[*lead, K, N]``) is
    replaced by ``<name>__q`` (int8 codes; int4 halves-packed ``[*lead,
    ceil(K/2), N]``) and ``<name>__s`` (fp32 ``[*lead, N]`` or grouped
    ``[*lead, G, N]``), on the weight's device; every other leaf passes
    through untouched.  ``thresholds`` (:func:`calibrate_weight_thresholds`,
    or the JAX package's, ``[L, N]`` a leaf) replaces the raw absmax of
    per-channel int8.  The identity when the config quantizes no weight.
    """
    if not config.quantized_weights:
        return params
    out = {k: v for k, v in params.items() if k != "blocks"}
    qblocks = {}
    for name, v in params["blocks"].items():
        if not _is_block_matmul(name, v):
            qblocks[name] = v
            continue
        lead = tuple(v.shape[:-2])
        th = (thresholds or {}).get(name)
        qs, ss = [], []
        for i, w in enumerate(_layers(v)):
            q, s = _quantize_matrix(w, config, None if th is None else th[i])
            qs.append(q)
            ss.append(s)
        qn, sn = quantized_leaf_names(name)
        qblocks[qn] = torch.stack(qs).reshape(lead + tuple(qs[0].shape))
        qblocks[sn] = torch.stack(ss).reshape(lead + tuple(ss[0].shape))
    out["blocks"] = qblocks
    return out


def dequantize_block_weight(q, s, config: ServeQuantConfig, k: int):
    """One layer's exported weight (``[K', N]`` codes + scales) back to
    fp32 ``[K, N]``."""
    return weight_dequantize(q, s, algo=config.algo, k=k,
                             group_size=config.group_size)
