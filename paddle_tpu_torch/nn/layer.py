"""The eager layers the models are built from: ``Linear``, ``Embedding``,
``LayerNorm``, ``RMSNorm``, ``Dropout`` and ``Tanh`` as
``torch.nn.Module``s.

Counterparts of ``paddle_tpu/nn/layer/common.py``, ``norm.py`` and
``activation.py``, with their parameter names and layouts, so a
``state_dict`` maps one to one:
``Linear.weight`` is Paddle's ``[in, out]`` (``y = x @ weight + bias``),
``Embedding.weight`` ``[num, dim]``, the norms' ``weight`` / ``bias``
``[H]``.  Parameters are fp32 (the JAX layers' default dtype; cast a
model with ``.to(torch.bfloat16)``) and are drawn with the JAX layers'
distributions from ``generator`` (the default generator of ``device``
when None): ``Linear`` weights Xavier-uniform over ``(in, out)``, biases
zero, ``Embedding`` normal with std ``std`` (1 by default), norm gains
one.  ``device=None`` means CUDA (:func:`..device.resolve_device`).
``Linear`` takes JAX's positional ``(in_features, out_features,
weight_attr, bias_attr)``; a ``ParamAttr`` (anything but None or
``False``) raises ``NotImplementedError``.

``RMSNorm.forward`` always takes the fused op (the JAX layer's TPU
branch): the ``rms_norm_fwd`` kernel on CUDA, its plain version on the
CPU.  ``LayerNorm.forward`` is the jnp-reference chain, as in the JAX
package, where only GPT's block epilogues use the fused LayerNorm ops.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ..device import resolve_device
from ..incubate.nn import functional as IF
from . import functional as F

__all__ = ["Linear", "Embedding", "LayerNorm", "RMSNorm", "Dropout",
           "Tanh"]


class Linear(torch.nn.Module):
    def __init__(self, in_features: int, out_features: int,
                 weight_attr=None, bias_attr=None, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        named = [k for k, v in (("weight_attr", weight_attr),
                                ("bias_attr", bias_attr))
                 if v is not None and v is not False]
        if named:
            raise NotImplementedError(
                f"Linear: ParamAttr arguments ({', '.join(named)}) are not "
                f"ported to paddle_tpu_torch yet (ROADMAP queue 1 item 20)")
        dev = resolve_device(device)
        self.in_features, self.out_features = in_features, out_features
        limit = math.sqrt(6.0 / (in_features + out_features))
        self.weight = torch.nn.Parameter(torch.empty(
            (in_features, out_features), device=dev).uniform_(
                -limit, limit, generator=generator))
        self.bias = None if bias_attr is False else torch.nn.Parameter(
            torch.zeros(out_features, device=dev))

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)

    def extra_repr(self):
        return (f"in_features={self.in_features}, "
                f"out_features={self.out_features}")


class Embedding(torch.nn.Module):
    def __init__(self, num_embeddings: int, embedding_dim: int,
                 padding_idx: Optional[int] = None, *, std: float = 1.0,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        dev = resolve_device(device)
        self.num_embeddings, self.embedding_dim = num_embeddings, \
            embedding_dim
        self.padding_idx = padding_idx if padding_idx is None or \
            padding_idx >= 0 else num_embeddings + padding_idx
        w = torch.empty((num_embeddings, embedding_dim), device=dev).normal_(
            0.0, std, generator=generator)
        if self.padding_idx is not None:
            w[self.padding_idx] = 0.0
        self.weight = torch.nn.Parameter(w)

    def forward(self, x):
        return F.embedding(x, self.weight, self.padding_idx)

    def extra_repr(self):
        return f"{self.num_embeddings}, {self.embedding_dim}"


class LayerNorm(torch.nn.Module):
    def __init__(self, normalized_shape, epsilon: float = 1e-5,
                 bias_attr=None, *, device=None):
        super().__init__()
        dev = resolve_device(device)
        if isinstance(normalized_shape, int):
            normalized_shape = (normalized_shape,)
        self.normalized_shape = tuple(normalized_shape)
        self.epsilon = epsilon
        self.weight = torch.nn.Parameter(torch.ones(self.normalized_shape,
                                                    device=dev))
        self.bias = None if bias_attr is False else torch.nn.Parameter(
            torch.zeros(self.normalized_shape, device=dev))

    def forward(self, x):
        return F.layer_norm(x, self.normalized_shape, self.weight, self.bias,
                            self.epsilon)

    def extra_repr(self):
        return f"normalized_shape={self.normalized_shape}"


class RMSNorm(torch.nn.Module):
    def __init__(self, hidden_size: int, epsilon: float = 1e-6, *,
                 device=None):
        super().__init__()
        self.hidden_size, self.epsilon = hidden_size, epsilon
        self.weight = torch.nn.Parameter(torch.ones(
            hidden_size, device=resolve_device(device)))

    def forward(self, x):
        return IF.fused_rms_norm(x, self.weight, None, self.epsilon)


class Dropout(torch.nn.Module):
    """``F.dropout`` in training mode (``self.training``), the identity in
    eval mode; masks drawn from ``generator``."""

    def __init__(self, p: float = 0.5, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.p, self.generator = p, generator

    def forward(self, x):
        return F.dropout(x, self.p, training=self.training,
                         generator=self.generator)

    def extra_repr(self):
        return f"p={self.p}"


class Tanh(torch.nn.Module):
    def forward(self, x):
        return F.tanh(x)
