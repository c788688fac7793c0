"""The PyTorch port imports no JAX: no module of ``paddle_tpu_torch``, not
``chip_smoke.py`` and not the port's A/B tools (``PORT_TOOLS``) may import
``jax``, ``jaxlib`` or the JAX package ``paddle_tpu`` — checked on the
source (every import statement) and by importing the whole port in a
process where ``jax`` cannot load.  The
port's entry points default to CUDA and refuse to run without it unless
the caller asks for the CPU."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "paddle_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "paddle_tpu")
PORT_TOOLS = ("dattn_ab.py", "flash_fwd_ab.py", "gemm_ab.py", "lce_ab.py",
              "paired_steps.py", "pattn_ab.py", "rope_softmax_ab.py",
              "wo_ab.py")


def _sources():
    files = (sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
             + [ROOT / "tools" / n for n in PORT_TOOLS])
    assert len(files) > 10
    return files


def _imported(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_jax_package_import(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [m for m in _imported(tree)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


_PROBE = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None
sys.modules["jaxlib"] = None
sys.modules["paddle_tpu"] = None
import paddle_tpu_torch
names = [m.name for m in pkgutil.walk_packages(paddle_tpu_torch.__path__,
                                               "paddle_tpu_torch.")]
for n in names:
    importlib.import_module(n)
import torch
assert not torch.cuda.is_available()
from paddle_tpu_torch.inference.serving import ContinuousBatchingEngine
from paddle_tpu_torch.models.llama import llama_tiny, init_params
from paddle_tpu_torch.device import make_generator
cfg = llama_tiny()
params = init_params(cfg, make_generator(0, "cpu"), device="cpu")
from paddle_tpu_torch.parallel import build_llama_train_step
from paddle_tpu_torch.models.generation import gpt_generate, llama_generate
from paddle_tpu_torch.models.gpt import gpt_tiny, init_params as gpt_init
from paddle_tpu_torch.models.llama import LlamaForCausalLM
from paddle_tpu_torch.models.gpt import GPTForCausalLM
from paddle_tpu_torch.nn.layer import Embedding, LayerNorm, Linear, RMSNorm
from paddle_tpu_torch.incubate.nn import (FusedFeedForward,
                                          FusedMultiHeadAttention,
                                          FusedTransformerEncoderLayer)
ids = [[1, 2, 3]]
gparams = gpt_init(gpt_tiny(), make_generator(0, "cpu"), device="cpu")
for call in (lambda: ContinuousBatchingEngine(cfg, params),
             lambda: init_params(cfg, make_generator(0, "cpu")),
             lambda: make_generator(0),
             lambda: build_llama_train_step(llama_tiny(fused_head=False)),
             lambda: llama_generate(params, cfg, ids, 2),
             lambda: gpt_generate(gparams, gpt_tiny(), ids, 2),
             lambda: LlamaForCausalLM(cfg), lambda: GPTForCausalLM(gpt_tiny()),
             lambda: Linear(2, 3), lambda: Embedding(4, 2),
             lambda: LayerNorm(2), lambda: RMSNorm(2),
             lambda: FusedMultiHeadAttention(4, 2),
             lambda: FusedFeedForward(4, 8),
             lambda: FusedTransformerEncoderLayer(4, 2, 8)):
    try:
        call()
    except RuntimeError as e:
        assert "device='cpu'" in str(e), e
    else:
        raise SystemExit("an entry point ran without CUDA and without "
                         "device='cpu'")
ContinuousBatchingEngine(cfg, params, device="cpu")
enc = FusedTransformerEncoderLayer(4, 2, 8, device="cpu").eval()
assert enc(torch.zeros(1, 3, 4)).shape == (1, 3, 4)
assert llama_generate(params, cfg, ids, 2, device="cpu").shape == (1, 5)
import torch
assert LlamaForCausalLM(cfg, device="cpu")(torch.tensor(ids)).shape == (
    1, 3, cfg.vocab_size)
for mod in ("paddle_tpu_torch.ops.decode_attention",
            "paddle_tpu_torch.ops.quant_linear", "paddle_tpu_torch.nn.quant",
            "paddle_tpu_torch.ops.cuda.decode_attention",
            "paddle_tpu_torch.ops.cuda.quant_linear",
            "paddle_tpu_torch.ops.norms", "paddle_tpu_torch.ops.fused",
            "paddle_tpu_torch.ops.cuda.norms",
            "paddle_tpu_torch.ops.cuda.fused",
            "paddle_tpu_torch.nn.functional", "paddle_tpu_torch.nn.layer",
            "paddle_tpu_torch.incubate.nn.functional",
            "paddle_tpu_torch.optimizer.optimizers",
            "paddle_tpu_torch.ops.rope", "paddle_tpu_torch.ops.threefry",
            "paddle_tpu_torch.ops.cuda.rope",
            "paddle_tpu_torch.incubate.nn.layer",
            "paddle_tpu_torch.incubate.extras"):
    assert mod in names, mod
print("OK", len(names))
"""


def test_port_imports_and_defaults_to_cuda_without_jax():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    r = subprocess.run([sys.executable, "-c", _PROBE], cwd=str(ROOT),
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert r.stdout.startswith("OK")
    assert int(r.stdout.split()[1]) >= 34
