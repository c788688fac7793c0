"""PyTorch + CUDA port of ``paddle_tpu`` for NVIDIA Hopper.

The JAX package ``paddle_tpu`` stays the reference; this package is its
counterpart for one H100.  It covers Llama serving through the
continuous-batching engine (:class:`inference.serving.ContinuousBatchingEngine`
at the JAX engine's defaults: greedy and sampled requests, the prefix
cache and priority preemption of :mod:`serving`; chunk prefill through
the ``prefill_block`` op, the batched paged-KV decode step through the
``decode_block`` op) and the one-device
Llama and GPT train steps (:func:`parallel.build_llama_train_step`,
:func:`parallel.build_gpt_train_step`: attention through the
``flash_attention`` op, the head through the logits-free
``linear_cross_entropy`` op), KV-cache generation
(:mod:`models.generation`) and eager training of
:class:`models.llama.LlamaForCausalLM` / :class:`models.gpt.GPTForCausalLM`
with :class:`optimizer.AdamW` (the fused norm and SwiGLU ops of
:mod:`ops.norms` / :mod:`ops.fused`), and the incubate fused API
(:mod:`incubate`: the ``Fused*`` layers and fused calls over the RoPE,
softmax-mask, bias-activation and dropout-add ops of :mod:`ops.rope` /
:mod:`ops.fused`).  On a CUDA tensor the ops launch
hand-written kernels (``kernels/csrc``); on a CPU tensor they run their
plain PyTorch versions, which the tests hold against the JAX package.

Entry points run on the card unless the caller passes ``device="cpu"``
(:mod:`paddle_tpu_torch.device`).  The package imports no JAX.
"""

from .device import resolve_device, make_generator

__all__ = ["resolve_device", "make_generator"]
