"""The port's weight-only quantization against the JAX package's.

* ``nn.quant.weight_quantize``: int8 and int4 codes and fp32 scales
  identical to the JAX package's on the same fp32 weight, per channel and
  in groups of 64 and 128, odd K included; ``weight_dequantize`` equal.
* ``ops.quant_linear`` plain versions against the JAX XLA tier (the jnp
  dequantize-and-matmul of ``weight_only_linear``, fp32 scales in fp32):
  1e-5 in fp32, per channel, groups of 64 and 128, odd K for int4, with a
  bias through ``weight_only_linear``;
* and against the JAX Pallas kernels run in interpret mode, bf16 x:
  2e-2 (the same rounding points: codes in bf16, fp32 partial products,
  the fp32 scale per group of 128 or per channel, the weight dequantized
  in bf16 for groups of 64).

The CPU tests use the plain versions; the kernels are checked on the card
(tests/test_torch_cuda_kernels.py, chip_smoke.py).
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from paddle_tpu.nn import quant as jq
from paddle_tpu.ops.pallas import quant_linear as jql
from paddle_tpu_torch.nn import quant as tq
from paddle_tpu_torch.ops import quant_linear as tql

ALGOS = {"int8": "weight_only_int8", "int4": "weight_only_int4"}
# (width, K, N, group_size)
CASES = [("int8", 200, 48, -1), ("int8", 256, 32, 64), ("int8", 300, 32, 128),
         ("int4", 256, 32, -1), ("int4", 255, 48, 64), ("int4", 256, 32, 128),
         ("int4", 301, 32, 128)]
IDS = [f"{w}-K{k}-g{g}" for w, k, _, g in CASES]


def _val(t):
    return np.asarray(t._value if hasattr(t, "_value") else t)


def _weights(K, N, seed=0):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((K, N)) * 0.05).astype(np.float32)
    w[:, 3] *= 20.0                      # one loud channel
    return w


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_weight_quantize_codes_and_scales_identical_to_jax(case):
    width, K, N, gs = case
    w = _weights(K, N)
    jcodes, jscale = (_val(t) for t in jq.weight_quantize(
        jnp.asarray(w), ALGOS[width], group_size=gs))
    codes, scale = tq.weight_quantize(torch.from_numpy(w.copy()),
                                      ALGOS[width], group_size=gs)
    assert codes.dtype == torch.int8 and scale.dtype == torch.float32
    np.testing.assert_array_equal(codes.numpy(), jcodes)
    np.testing.assert_array_equal(scale.numpy(), jscale)
    jdeq = _val(jq.weight_dequantize(jnp.asarray(jcodes), jnp.asarray(jscale),
                                     ALGOS[width], k=K, group_size=gs))
    deq = tq.weight_dequantize(codes, scale, ALGOS[width], k=K,
                               group_size=gs)
    np.testing.assert_array_equal(deq.numpy(), jdeq)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_weight_only_linear_matches_jax_xla_tier_fp32(case):
    width, K, N, gs = case
    w = _weights(K, N, seed=1)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 3, K)).astype(np.float32)
    bias = rng.standard_normal(N).astype(np.float32)
    codes, scale = (_val(t) for t in jq.weight_quantize(
        jnp.asarray(w), ALGOS[width], group_size=gs))
    ref = _val(jq.weight_only_linear(
        jnp.asarray(x), jnp.asarray(codes), jnp.asarray(bias),
        weight_scale=jnp.asarray(scale), weight_dtype=width,
        group_size=gs))
    got = tq.weight_only_linear(
        torch.from_numpy(x), torch.from_numpy(codes), torch.from_numpy(bias),
        weight_scale=torch.from_numpy(scale), weight_dtype=width,
        group_size=gs)
    assert got.shape == (2, 3, N)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)


# one interpret-mode grid per rounding rule: per channel, post-multiplied
# groups of 128, the dequantized tile of groups of 64, and odd K
KERNEL_CASES = [CASES[0], CASES[1], CASES[4], CASES[5]]


@pytest.fixture
def pallas_interpret():
    from paddle_tpu.core.flags import FLAGS, set_flags
    old = FLAGS.pallas_interpret
    set_flags({"pallas_interpret": True})
    yield
    set_flags({"pallas_interpret": old})


@pytest.mark.parametrize("case", KERNEL_CASES,
                         ids=[IDS[CASES.index(c)] for c in KERNEL_CASES])
def test_plain_matches_jax_interpret_kernels_bf16(case, pallas_interpret):
    width, K, N, gs = case
    w = _weights(K, N, seed=3)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((8, K)).astype(ml_dtypes.bfloat16)
    codes, scale = (_val(t) for t in jq.weight_quantize(
        jnp.asarray(w), ALGOS[width], group_size=gs))
    fn = jql.weight_only_matmul_int4 if width == "int4" else \
        jql.weight_only_matmul
    ref = np.asarray(fn(jnp.asarray(x), jnp.asarray(codes),
                        jnp.asarray(scale), group_size=gs)).astype(np.float32)
    tfn = tql.weight_only_matmul_int4_ref if width == "int4" else \
        tql.weight_only_matmul_ref
    got = tfn(torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16),
              torch.from_numpy(codes), torch.from_numpy(scale),
              group_size=gs)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=2e-2,
                               atol=2e-2)


def test_scale_rules_follow_the_pallas_tier():
    """Groups of 64 dequantize the tile in x's dtype; per channel and
    groups of 128 post-multiply in fp32; int4 groups not aligned to the
    nibble planes take the tile rule."""
    assert tql.scale_mode(-1) == tql.scale_mode(128) == "post"
    assert tql.scale_mode(64) == "tile"
    assert tql.scale_mode(128, int4_half=128) == "post"
    assert tql.scale_mode(128, int4_half=151) == "tile"
    # bf16: the tile rule rounds the scaled weight to bf16 first
    codes = torch.tensor([[3], [-7]], dtype=torch.int8).repeat(64, 16)
    scale = torch.full((2, 16), 0.0123456, dtype=torch.float32)
    x = torch.ones(1, 128, dtype=torch.bfloat16)
    got = tql.weight_only_matmul_ref(x, codes, scale, group_size=64)
    w = (codes.to(torch.bfloat16) * scale[0, 0].to(torch.bfloat16)).float()
    assert torch.equal(got.float(), (x.float() @ w).to(torch.bfloat16).float())


@pytest.mark.parametrize("bad", ["group", "scale rows", "algo", "int4 rows"])
def test_malformed_inputs_raise(bad):
    x = torch.zeros(2, 64)
    codes = torch.zeros(64, 16, dtype=torch.int8)
    with pytest.raises(ValueError):
        if bad == "group":
            tql.weight_only_matmul(x, codes, torch.ones(16), group_size=32)
        elif bad == "scale rows":
            tql.weight_only_matmul(x, codes, torch.ones(16), group_size=64)
        elif bad == "algo":
            tq.weight_quantize(torch.zeros(4, 4), "weight_only_int2")
        else:
            tql.weight_only_matmul_int4(x, codes, torch.ones(16))
