"""The plain version of the serving chain's ``rope_kv_write`` against the
JAX package.

``rope_kv_write_ref`` (``ops/cuda/kernels.py``), which the card's kernel
equals bit for bit, ropes q and k and writes the roped k row and the v
row of each decode slot into its page of the pool.  The JAX decode block
ropes with ``q * cos + _rot_half(q) * sin`` in fp32
(``paddle_tpu/ops/pallas/decode_block.py``) and ``paged_append``
(``paddle_tpu/ops/paged_kv.py``) scatters the rows, dropping a slot whose
page is unmapped (-1), past its table or outside the pool.  The same
inputs, made with numpy from a seed, go to both packages at the GQA
shapes the layer takes (head_dim 32 / 64 / 128, 1 / 2 / 4 / 8 q heads a
kv head).  Tolerance: fp32 1e-5 (the same operations); bf16 2e-2 (the
port rounds each product and the sum to bf16 as the chain's torch ops
do, the JAX block computes in fp32 and rounds once)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas.decode_block import _rot_half
from paddle_tpu.ops.paged_kv import paged_append
from paddle_tpu_torch.ops.cuda import kernels as K

HKV, BS, NB, MB = 2, 4, 12, 3
TOL = {torch.float32: dict(rtol=1e-5, atol=1e-5),
       torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}
GD = [(D, G) for D in (32, 64, 128) for G in (1, 2, 4, 8)]


def _inputs(D, G, seed=3):
    """Five decode slots: two that write (lengths 5 and 0), an inactive
    one (table all -1), one whose length is past its table and one whose
    page lies outside the pool."""
    rng = np.random.default_rng(seed)
    rows = 5
    bt = np.full((rows, MB), -1, np.int32)
    bt[0, :2] = (3, 7)
    bt[1, 0] = 9
    bt[3] = (1, 2, 4)
    bt[4, 0] = NB + 2
    lengths = np.array([5, 0, 0, MB * BS, 2], np.int32)
    f = rng.standard_normal
    return dict(q=f((rows, HKV * G * D)), k=f((rows, HKV * D)),
                v=f((rows, HKV * D)), cos=f((rows, D)), sin=f((rows, D)),
                pool_k=f((NB, BS, HKV, D)), pool_v=f((NB, BS, HKV, D)),
                bt=bt, lengths=lengths)


def _jax(c, D, dt):
    """The JAX block's rotation in fp32 on the inputs as rounded to the
    working dtype, then paged_append into pools of that dtype."""
    jdt = jnp.bfloat16 if dt == torch.bfloat16 else jnp.float32
    rows = c["q"].shape[0]

    def arr(a):
        return jnp.asarray(a, jnp.float32).astype(jdt).astype(jnp.float32)
    cos, sin = arr(c["cos"])[:, None], arr(c["sin"])[:, None]

    def rope(t):
        t = arr(t).reshape(rows, -1, D)
        return t * cos + _rot_half(t) * sin
    q, k = rope(c["q"]), rope(c["k"])
    pk, pv = paged_append(
        jnp.asarray(c["pool_k"], jdt), jnp.asarray(c["pool_v"], jdt),
        k.astype(jdt), arr(c["v"]).reshape(rows, HKV, D).astype(jdt),
        c["bt"], c["lengths"], BS)
    return [np.asarray(jnp.asarray(t, jnp.float32))
            for t in (q.reshape(rows, -1), k.reshape(rows, -1), pk, pv)]


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("D,G", GD, ids=[f"D{d}-G{g}" for d, g in GD])
def test_rope_kv_write_ref_matches_jax(dt, D, G):
    c = _inputs(D, G)

    def t(name):
        return torch.from_numpy(np.ascontiguousarray(c[name], np.float32)).to(
            dt)
    pk, pv = t("pool_k"), t("pool_v")
    pk0 = pk.clone()
    q, k = K.rope_kv_write_ref(
        t("q"), t("k"), t("v"), t("cos"), t("sin"), pk, pv, head_dim=D,
        block_table=torch.from_numpy(c["bt"]),
        lengths=torch.from_numpy(c["lengths"]))
    for got, ref in zip((q, k, pk, pv), _jax(c, D, dt)):
        np.testing.assert_allclose(got.float().numpy(), ref, **TOL[dt])
    # only slots 0 and 1 wrote: page 7 offset 1, page 9 offset 0
    moved = (pk != pk0).flatten(2).any(-1).nonzero().tolist()
    assert moved == [[7, 1], [9, 0]]
