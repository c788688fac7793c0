"""Hand a JAX parameter tree or train state to the port.

The JAX train steps store blocks pipeline-stacked ``[S, per, ...]``;
:func:`params_from_numpy` takes such a tree (Llama's ``wte``, ``head``,
``lnf_w``; GPT's ``wte``, ``wpe``, ``lnf_w``, ``lnf_b``; and ``blocks``) as
numpy arrays (or anything ``numpy.asarray`` accepts), collapses the blocks
to ``[L, ...]`` as the JAX engine's ``_collapse_blocks`` does, and returns
torch tensors, so both packages compute with the same numbers.
:func:`state_from_numpy` does the same for a whole one-device train state,
Adam moments included.  :func:`state_dict_from_numpy` takes an eager JAX
model's ``state_dict()`` (name -> array) for ``module.load_state_dict``
of the port's eager model of the same config.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from .device import resolve_device
from .models.generation import _collapse_blocks
from .models.llama import torch_dtype

__all__ = ["params_from_numpy", "state_from_numpy", "state_dict_from_numpy"]


def _to_torch(a, dtype: Optional[torch.dtype],
              device: torch.device) -> torch.Tensor:
    """A torch copy of ``a`` in ``dtype``, or in its own dtype when None
    (ml_dtypes bfloat16 arrays from JAX become torch.bfloat16)."""
    arr = np.asarray(a)
    bf16 = arr.dtype.name == "bfloat16"
    t = torch.from_numpy(np.array(arr.astype(np.float32) if bf16 else arr,
                                  order="C", copy=True))
    if dtype is None:
        dtype = torch.bfloat16 if bf16 else t.dtype
    return t.to(device=device, dtype=dtype)


def _leaf_dtype(name: str, a, dt: Optional[torch.dtype]):
    """``dt`` for a float weight; None (keep) for integer leaves (the
    ``__q`` codes of a quantized tree) and the fp32 ``__s`` scales."""
    if dt is None or name.endswith("__s") or \
            np.issubdtype(np.asarray(a).dtype, np.integer):
        return None
    return dt


def params_from_numpy(tree: Dict[str, object], dtype=None,
                      device=None) -> Dict[str, object]:
    """``{top-level leaves..., "blocks": {name: [S, per, ...]}}`` -> the
    port's tree with blocks ``[L, ...]`` on ``device``.  Every float leaf
    is cast to ``dtype`` when one is given, else keeps its own dtype (GPT's
    fp32 ``lnf_w`` / ``lnf_b`` beside bf16 weights); the integer codes
    (``<name>__q``) and fp32 scales (``<name>__s``) of a weight-only
    quantized tree always keep theirs."""
    dev = resolve_device(device)
    dt = None if dtype is None else torch_dtype(dtype)
    out = {k: _to_torch(v, _leaf_dtype(k, v, dt), dev)
           for k, v in tree.items() if k != "blocks"}
    blocks = {k: _to_torch(v, _leaf_dtype(k, v, dt), dev)
              for k, v in tree["blocks"].items()}
    out["blocks"] = {k: v.contiguous()
                     for k, v in _collapse_blocks(blocks).items()}
    return out


def state_from_numpy(state: Dict[str, object], dtype=None,
                     device=None) -> Dict[str, object]:
    """A one-device JAX train state ``{"params", "opt": {"m", "v", "t"}}``
    -> the port's: params through :func:`params_from_numpy`; each flat
    ZeRO moment ``[1, 1, numel]`` (fp32) reshaped to its param's shape,
    fp32; ``t`` an int."""
    dev = resolve_device(device)
    params = params_from_numpy(state["params"], dtype, dev)

    def moments(tree):
        out = {k: _to_torch(v, torch.float32, dev).reshape(params[k].shape)
               for k, v in tree.items() if k != "blocks"}
        out["blocks"] = {k: _to_torch(v, torch.float32, dev).reshape(
            params["blocks"][k].shape) for k, v in tree["blocks"].items()}
        return out
    opt = state["opt"]
    return {"params": params, "opt": {"m": moments(opt["m"]),
                                      "v": moments(opt["v"]),
                                      "t": int(np.asarray(opt["t"]))}}


def state_dict_from_numpy(sd: Dict[str, object], dtype=None,
                          device=None) -> Dict[str, torch.Tensor]:
    """An eager JAX ``state_dict()`` (name -> array, or anything
    ``numpy.asarray`` accepts, such as the JAX package's ``Parameter``) ->
    name -> torch tensor on ``device``, each in ``dtype`` when one is given,
    else in its own dtype; the names are kept (the port's eager models
    use the JAX attribute names)."""
    dev = resolve_device(device)
    dt = None if dtype is None else torch_dtype(dtype)
    return {k: _to_torch(v, dt, dev) for k, v in sd.items()}
