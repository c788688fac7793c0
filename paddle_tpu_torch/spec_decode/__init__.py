"""Speculative decoding for the continuous-batching engine (counterpart
of ``paddle_tpu/spec_decode/``, ROADMAP.md queue 1 item 12).

Decode is step-latency-bound: every generated token costs one full
target-model decode step.  Speculative decoding amortizes that cost — a
small DRAFT model proposes K tokens per active request, and the VERIFY
runs the engine's own decode step over all K+1 positions against the
target model's paged KV, so each engine step can commit several tokens.

The subsystem is lossless by construction:

* greedy requests: a proposal is accepted iff it equals the target's
  argmax at that position, and the verify IS the engine's decode step,
  called K+1 times — its logits are bit-identical to sequential
  baseline decode, so the emitted stream is too;
* sampled requests: proposals are verified with rejection sampling
  (`sampling.py`), which preserves the target distribution for ANY
  proposal distribution — the draft can only change speed, never
  outputs.

Wiring: ``ContinuousBatchingEngine(spec_config=SpecDecodeConfig(...))``
routes every decode iteration through :class:`SpecDecodeRunner`;
rejected tails roll back by length (their KV writes fall beyond the
committed length, are masked by every later attention, and get
overwritten by the next append at the same positions), while the
refcounted page pool keeps its exactly-once release accounting through
cancels and retires mid-speculation (``kv_leak_report`` stays zero).

The draft and the verify are the engine's ``spec_draft`` and
``spec_verify`` programs: captured CUDA graphs on the card, exported by
``aot.export_engine`` as the JAX engine exports them.  Not ported: the
serve telemetry counters (``observability.REGISTRY``, item 13).
"""

from .config import SpecDecodeConfig
from .draft import build_draft_program
from .runner import SpecDecodeRunner
from .sampling import spec_sample_chain, warp_probs
from .verify import build_verify_program

__all__ = [
    "SpecDecodeConfig", "SpecDecodeRunner", "build_draft_program",
    "build_verify_program", "spec_sample_chain", "warp_probs",
]
