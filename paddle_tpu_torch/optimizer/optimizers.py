"""``Adam`` and ``AdamW`` as ``torch.optim.Optimizer`` subclasses.

Counterpart of ``paddle_tpu/optimizer/optimizers.py:47-139`` (with the
eager ``step`` of ``optimizer.py:212-256``), with Paddle's argument names
and the JAX update's arithmetic:

* fp32 moments ``moment1`` / ``moment2`` (and ``moment2_max`` with
  ``amsgrad``) per parameter;
* the gradient cast to the parameter's dtype, plus ``weight_decay * p``
  (Adam's L2 decay), then to fp32; ``m = b1 m + (1 - b1) g``, ``v = b2 v +
  (1 - b2) g^2``, bias corrections ``1 - b^t`` in fp32 from the
  optimizer's step count ``t`` (one per ``step()``, shared by all
  parameters), ``p = p - lr * mhat / (sqrt(vhat) + eps)`` in fp32 and cast
  back to the parameter's dtype;
* AdamW: the decoupled decay ``p *= 1 - lr * coeff`` in fp32 (cast back)
  before the update, for the parameters ``apply_decay_param_fun(name)``
  accepts (all when None).

Parameters and their moments are updated in place.  ``parameters`` takes
tensors or ``(name, tensor)`` pairs (``net.named_parameters()``); the
names are what ``apply_decay_param_fun`` sees (``param_<i>`` for a bare
tensor).  Only parameters with a gradient move.  ``clear_grad()`` is
``zero_grad()``.  ``grad_clip``, a learning-rate scheduler and
``multi_precision`` raise ``NotImplementedError`` (ROADMAP queue 1 item
17).
"""

from __future__ import annotations

import numbers
from typing import Callable, Optional

import numpy as np
import torch

__all__ = ["Adam", "AdamW"]


def _refuse(what: str):
    raise NotImplementedError(
        f"{what} is not ported to paddle_tpu_torch yet (ROADMAP queue 1 "
        f"item 17: training runtime, optimizer/)")


class Adam(torch.optim.Optimizer):
    def __init__(self, learning_rate=0.001, beta1: float = 0.9,
                 beta2: float = 0.999, epsilon: float = 1e-8,
                 parameters=None, weight_decay=None, grad_clip=None,
                 lazy_mode: bool = False, multi_precision: bool = False,
                 use_multi_tensor: bool = False, amsgrad: bool = False,
                 name=None):
        if parameters is None:
            raise ValueError("eager optimizers need parameters")
        if not isinstance(learning_rate, numbers.Real):
            _refuse("a learning-rate scheduler")
        if grad_clip is not None:
            _refuse("grad_clip")
        if multi_precision:
            _refuse("multi_precision (fp32 master weights)")
        params, names = [], []
        for i, p in enumerate(parameters):
            n, p = p if isinstance(p, tuple) else (f"param_{i}", p)
            names.append(n)
            params.append(p)
        super().__init__([{"params": params, "names": names}],
                         dict(lr=float(learning_rate)))
        self._beta1, self._beta2, self._eps = beta1, beta2, epsilon
        self._amsgrad = amsgrad
        self._wd = float(getattr(weight_decay, "_coeff", weight_decay)
                         or 0.0)
        self._step_count = 0

    def get_lr(self) -> float:
        return self.param_groups[0]["lr"]

    def set_lr(self, value: float) -> None:
        for g in self.param_groups:
            g["lr"] = float(value)

    def _decay_applies(self, name: str) -> bool:
        return True

    def _slots(self, p):
        st = self.state[p]
        if not st:
            keys = ("moment1", "moment2") + (
                ("moment2_max",) if self._amsgrad else ())
            for k in keys:
                st[k] = torch.zeros(p.shape, dtype=torch.float32,
                                    device=p.device)
        return st

    def _pre_update(self, p, name: str, lr: float) -> None:
        """AdamW's decoupled decay; nothing for Adam."""

    @torch.no_grad()
    def step(self, closure: Optional[Callable] = None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        self._step_count += 1
        t = np.float32(self._step_count)
        b1, b2 = self._beta1, self._beta2
        # bias corrections 1 - b^t in fp32, as the JAX update computes them
        bc1 = float(np.float32(1) - np.float32(b1) ** t)
        bc2 = float(np.float32(1) - np.float32(b2) ** t)
        for group in self.param_groups:
            lr = group["lr"]
            for p, name in zip(group["params"], group["names"]):
                if p.grad is None:
                    continue
                self._pre_update(p, name, lr)
                st = self._slots(p)
                g32 = p.grad.to(p.dtype)
                if self._wd and self._decay_applies(name):
                    g32 = g32 + self._wd * p
                g32 = g32.float()
                m = b1 * st["moment1"] + (1 - b1) * g32
                v = b2 * st["moment2"] + (1 - b2) * g32.square()
                st["moment1"].copy_(m)
                st["moment2"].copy_(v)
                if self._amsgrad:
                    v = torch.maximum(st["moment2_max"], v)
                    st["moment2_max"].copy_(v)
                upd = (m / bc1) / ((v / bc2).sqrt() + self._eps)
                p.copy_((p.float() - lr * upd).to(p.dtype))
        return loss

    def clear_grad(self, set_to_zero: bool = False) -> None:
        self.zero_grad(set_to_none=not set_to_zero)

    clear_gradients = clear_grad


class AdamW(Adam):
    """Adam with decoupled weight decay ``p *= 1 - lr * weight_decay`` (in
    fp32, cast back) before the update, where ``apply_decay_param_fun``
    (called with the parameter's name) allows."""

    def __init__(self, learning_rate=0.001, beta1: float = 0.9,
                 beta2: float = 0.999, epsilon: float = 1e-8,
                 parameters=None, weight_decay=0.01, lr_ratio=None,
                 apply_decay_param_fun=None, grad_clip=None,
                 lazy_mode: bool = False, multi_precision: bool = False,
                 amsgrad: bool = False, name=None):
        if lr_ratio is not None:
            _refuse("lr_ratio")
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         None, grad_clip, lazy_mode, multi_precision,
                         amsgrad=amsgrad)
        self._coeff = float(weight_decay) if weight_decay is not None \
            else 0.0
        self._apply_decay_param_fun = apply_decay_param_fun

    def _decay_applies(self, name: str) -> bool:
        fun = self._apply_decay_param_fun
        return True if fun is None else bool(fun(name))

    def _pre_update(self, p, name: str, lr: float) -> None:
        if self._coeff and self._decay_applies(name):
            keep = float(np.float32(1) - np.float32(lr)
                         * np.float32(self._coeff))
            p.copy_((p.float() * keep).to(p.dtype))
