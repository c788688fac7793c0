"""The engine's ``fused_decode_block=`` / ``fused_prefill=`` keywords
against the JAX engine's on ``llama_tiny``: the port takes both, keeps
them as attributes, and on the CPU runs the plain chain either way, so
its greedy ids equal the JAX engine's built with the same keywords (the
JAX reference tier runs the fused op as its per-op chain).  False on CUDA
raises; that refusal is pinned by the card tests
(``tests/test_torch_cuda_kernels.py``)."""

import jax
import numpy as np
import pytest

from paddle_tpu import parallel as dist
from paddle_tpu.inference.serving import ContinuousBatchingEngine as JEngine
from paddle_tpu.models import llama as jllama
from paddle_tpu.parallel.topology import HybridTopology, set_topology
from paddle_tpu_torch.bridge import params_from_numpy
from paddle_tpu_torch.inference.serving import ContinuousBatchingEngine
from paddle_tpu_torch.models import llama as tllama

PROMPT_LENS = (5, 20)
BUDGETS = (4, 3)


@pytest.fixture(scope="module")
def model():
    cfg = jllama.llama_tiny()
    topo = dist.init_topology(devices=jax.devices()[:1])
    _, init_fn = jllama.build_llama_train_step(cfg, topo, num_microbatches=1)
    params = init_fn(0)["params"]
    set_topology(HybridTopology())
    return cfg, params, jax.tree_util.tree_map(np.asarray, params)


def _run(eng, prompts):
    for p, n in zip(prompts, BUDGETS):
        eng.add_request(p, n)
    return eng.run_to_completion()


@pytest.mark.parametrize("fused_decode_block,fused_prefill",
                         [(True, True), (False, True), (True, False),
                          (False, False)])
def test_fused_keywords_greedy_ids_match_jax(model, fused_decode_block,
                                             fused_prefill):
    cfg, params, np_tree = model
    kw = dict(max_batch=2, prefill_buckets=(16,), enable_prefix_caching=False,
              enable_preemption=False, fused_decode_block=fused_decode_block,
              fused_prefill=fused_prefill)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, cfg.vocab_size, (n,)).astype(np.int32)
               for n in PROMPT_LENS]
    jres = _run(JEngine(cfg, params, **kw), prompts)
    teng = ContinuousBatchingEngine(
        tllama.llama_tiny(), params_from_numpy(np_tree, cfg.dtype, "cpu"),
        device="cpu", **kw)
    assert teng.fused_decode_block is fused_decode_block
    assert teng.fused_prefill is fused_prefill
    tres = _run(teng, prompts)
    assert sorted(tres) == sorted(jres) == [0, 1]
    for rid in jres:
        np.testing.assert_array_equal(tres[rid], jres[rid])
