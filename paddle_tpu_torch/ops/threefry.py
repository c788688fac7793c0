"""Counter-based random bits for the dropout kernels: Threefry-2x32.

The TPU dropout kernel (``paddle_tpu/ops/pallas/fused.py:156-163``) seeds
the TPU's own PRNG with ``seed + program_id``, so its bits depend on the
block size and cannot be repeated off the TPU (there is no CPU rule for
``prng_seed``).  The port picks its own generator: Threefry-2x32 with 20
rounds (Salmon et al., SC'11; the generator of ``jax.random``), keyed by
``(seed mod 2^32, seed >> 32 mod 2^32)`` — ``(seed, 0)`` for the seeds the
ops draw — over the flat element index: element ``i`` takes word
``i & 1`` of the block at counter ``i >> 1``.  It needs only 32-bit adds,
rotates and xors, which are exact in int64 torch ops under
``& 0xFFFFFFFF``, so :func:`dropout_bits` here and the device function in
``kernels/csrc/fused_ops.cu`` give the same bits, and the kernel's output
equals its plain version's bit for bit.  (Philox, the usual GPU choice,
needs a 32x32 -> 64-bit ``mulhi`` that int64 ops cannot repeat exactly.)
"""

from __future__ import annotations

import torch

__all__ = ["threefry2x32", "dropout_bits", "keep_mask"]

_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(v, r):
    return ((v << r) & _M32) | (v >> (32 - r))


def threefry2x32(k0: int, k1: int, c0, c1):
    """The two output words of Threefry-2x32-20 for key ``(k0, k1)`` at the
    counters ``(c0, c1)`` (int64 tensors of 32-bit values); int64 tensors
    of 32-bit values."""
    k0, k1 = int(k0) & _M32, int(k1) & _M32
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0, x1 = (c0 + ks[0]) & _M32, (c1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def dropout_bits(seed: int, n: int, device=None) -> torch.Tensor:
    """The 32-bit random word of each of ``n`` elements under ``seed``, as
    an int64 tensor ``[n]``."""
    seed = int(seed)
    c = torch.arange((n + 1) // 2, dtype=torch.int64, device=device)
    w0, w1 = threefry2x32(seed & _M32, (seed >> 32) & _M32, c & _M32,
                          (c >> 32) & _M32)
    return torch.stack((w0, w1), -1).reshape(-1)[:n]


def keep_mask(seed: int, shape, p: float, device=None) -> torch.Tensor:
    """The dropout kernel's keep mask: element ``i`` (row-major) is kept
    where ``(bits_i >> 8) * 2^-24 >= p`` (the TPU kernel's 24-bit rule)."""
    n = 1
    for s in shape:
        n *= int(s)
    u = (dropout_bits(seed, n, device) >> 8).to(torch.float64) * 2.0 ** -24
    return (u >= float(torch.tensor(p, dtype=torch.float32))).reshape(shape)
