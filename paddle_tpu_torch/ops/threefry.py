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

The serving sampler and generation draw from the same core the way
``jax.random`` does with ``jax_threefry_partitionable`` on (JAX's
default): :func:`prng_key`, :func:`fold_in`, :func:`split`,
:func:`random_bits`, :func:`uniform` and :func:`gumbel` repeat
``jax.random.key``, ``fold_in``, ``split``, the raw bits of a draw of any
shape, ``uniform(minval=tiny)`` and the low-range Gumbel noise of
``jax.random.categorical``.
"""

from __future__ import annotations

import torch

__all__ = ["threefry2x32", "dropout_bits", "keep_mask", "prng_key",
           "fold_in", "split", "random_bits", "uniform", "gumbel"]

_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(v, r):
    return ((v << r) & _M32) | (v >> (32 - r))


def threefry2x32(k0, k1, c0, c1):
    """The two output words of Threefry-2x32-20 for key ``(k0, k1)`` at the
    counters ``(c0, c1)``: ints, or int64 tensors of 32-bit values that
    broadcast together (a key per row, a counter per column)."""
    if not isinstance(k0, torch.Tensor):
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


# ------------------------------------------------ jax.random's key chain
_TINY = 1.1754943508222875e-38          # float32's smallest normal


def prng_key(seed: int):
    """``jax.random.key(seed)``'s two words in JAX's default 32-bit mode:
    ``(0, seed mod 2^32)`` (the seed is cut to its low 32 bits, negative
    ones included, so the high word is 0)."""
    return 0, int(seed) & _M32


def fold_in(key, data: int):
    """``jax.random.fold_in(key, data)``: Threefry of the key over the
    counter words ``(0, data mod 2^32)``."""
    return threefry2x32(key[0], key[1], 0, int(data) & _M32)


def split(key, num: int = 2):
    """``jax.random.split(key, num)``'s keys as ``num`` word pairs: key
    ``i`` is both Threefry words of ``key`` at the counters ``(0, i)``
    (the partitionable layout: the counters are the 64-bit index ``i``'s
    high and low words)."""
    return [threefry2x32(key[0], key[1], (i >> 32) & _M32, i & _M32)
            for i in range(int(num))]


def random_bits(k0, k1, n, device=None) -> torch.Tensor:
    """The 32-bit words of a draw of shape ``n`` (an int or a tuple) under
    key ``(k0, k1)`` (JAX's partitionable layout: element ``i`` of the
    row-major order is the xor of both Threefry words at the counters
    ``(i >> 32, i mod 2^32)``).  ``k0`` / ``k1`` are ints or ``[r, 1]``
    int64 tensors (one key a row of a 1-D draw, bits ``[r, n]``);
    int64."""
    shape = (int(n),) if isinstance(n, int) else tuple(int(d) for d in n)
    total = 1
    for d in shape:
        total *= d
    c = torch.arange(total, dtype=torch.int64, device=device)
    w0, w1 = threefry2x32(k0, k1, c >> 32, c & _M32)
    return (w0 ^ w1).reshape(w0.shape[:-1] + shape)


def uniform(bits: torch.Tensor) -> torch.Tensor:
    """``jax.random.uniform(minval=tiny, maxval=1)`` in float32 from its
    words: the top 23 bits as the mantissa of a float in [1, 2), minus
    one, plus float32's smallest normal, floored there (``1 - tiny``
    rounds to 1 in float32, so the scale is exact)."""
    m = ((bits >> 9) | 0x3F800000).to(torch.int32)
    f = m.view(torch.float32) - 1.0
    return torch.clamp_min(f + _TINY, _TINY)


def gumbel(bits: torch.Tensor) -> torch.Tensor:
    """The low-range Gumbel noise of ``jax.random.gumbel`` /
    ``categorical``: ``-log(-log(u))`` in float32."""
    return -torch.log(-torch.log(uniform(bits)))
