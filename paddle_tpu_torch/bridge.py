"""Hand a JAX parameter tree or train state to the port.

The JAX train step stores blocks pipeline-stacked ``[S, per, ...]``;
:func:`params_from_numpy` takes that tree as numpy arrays (or anything
``numpy.asarray`` accepts), collapses the blocks to ``[L, ...]`` as the
JAX engine's ``_collapse_blocks`` does, and returns torch tensors, so
both packages compute with the same numbers.  :func:`state_from_numpy`
does the same for a whole one-device train state, Adam moments included.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .device import resolve_device
from .models.generation import _collapse_blocks
from .models.llama import torch_dtype

__all__ = ["params_from_numpy", "state_from_numpy"]


def _to_torch(a, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    arr = np.asarray(a)
    if arr.dtype.name == "bfloat16":      # ml_dtypes arrays from JAX
        arr = arr.astype(np.float32)
    return torch.from_numpy(np.array(arr, order="C", copy=True)).to(
        device=device, dtype=dtype)


def params_from_numpy(tree: Dict[str, object], dtype="float32",
                      device=None) -> Dict[str, object]:
    """``{"wte", "head", "lnf_w", "blocks": {name: [S, per, ...]}}`` ->
    the port's tree with blocks ``[L, ...]`` in ``dtype`` on ``device``."""
    dev = resolve_device(device)
    dt = torch_dtype(dtype)
    blocks = {k: _to_torch(v, dt, dev) for k, v in tree["blocks"].items()}
    out = {k: _to_torch(tree[k], dt, dev) for k in ("wte", "head", "lnf_w")}
    out["blocks"] = {k: v.contiguous()
                     for k, v in _collapse_blocks(blocks).items()}
    return out


def state_from_numpy(state: Dict[str, object], dtype="float32",
                     device=None) -> Dict[str, object]:
    """A one-device JAX train state ``{"params", "opt": {"m", "v", "t"}}``
    -> the port's: params through :func:`params_from_numpy`; each flat
    ZeRO moment ``[1, 1, numel]`` (fp32) reshaped to its param's shape,
    fp32; ``t`` an int."""
    dev = resolve_device(device)
    params = params_from_numpy(state["params"], dtype, dev)

    def moments(tree):
        out = {k: _to_torch(tree[k], torch.float32, dev).reshape(
            params[k].shape) for k in ("wte", "head", "lnf_w")}
        out["blocks"] = {k: _to_torch(v, torch.float32, dev).reshape(
            params["blocks"][k].shape) for k, v in tree["blocks"].items()}
        return out
    opt = state["opt"]
    return {"params": params, "opt": {"m": moments(opt["m"]),
                                      "v": moments(opt["v"]),
                                      "t": int(np.asarray(opt["t"]))}}
