"""Speculation knobs: which draft model, how far to speculate
(counterpart of ``paddle_tpu/spec_decode/config.py``, copied: the port
imports nothing of the JAX package).

The config is engine-level (one draft serves every request in the
batch): the verify is the engine's decode step run ``k + 1`` times over
the whole ``[max_batch]`` batch, so one ``k`` holds for every request.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict

__all__ = ["SpecDecodeConfig"]


@dataclass
class SpecDecodeConfig:
    """Draft/verify speculation parameters.

    draft_cfg / draft_params:
        A Llama-family config + parameter tree (``wte``/``head``/``lnf_w``
        + ``blocks`` stacked ``[L, ...]``, as ``models.llama.init_params``
        or ``bridge.params_from_numpy`` give it) for the DRAFT model, on
        the engine's device.  Must share the target's vocabulary — draft
        token ids are fed straight into the target's verify.  The draft
        runs as a windowed dense recompute (``draft.py``), so it needs no
        KV pool of its own and no per-request state; a cancel or rollback
        costs nothing on the draft side.
    k:
        Draft tokens proposed per engine step (the verify width is
        ``k + 1``: the fed token plus k proposals).
    window:
        Draft context window in tokens.  The draft re-reads only the
        last ``window`` tokens of prompt+output each proposal — a
        fixed ``[max_batch, window]`` geometry.
    enabled:
        Master switch; False constructs the runner but decodes through
        the baseline single-token step (A/B and incident rollback knob).
    """

    draft_cfg: Any
    draft_params: Any
    k: int = 4
    window: int = 16
    enabled: bool = True

    def __post_init__(self):
        if self.k < 1:
            raise ValueError(f"spec_decode k must be >= 1, got {self.k}")
        if self.window < 2:
            raise ValueError(
                f"spec_decode window must be >= 2, got {self.window} "
                "(the draft needs at least the fed token plus context)")

    def validate_against(self, target_cfg) -> None:
        """The one compatibility rule that matters: token ids the draft
        emits must mean the same thing to the target."""
        if self.draft_cfg.vocab_size != target_cfg.vocab_size:
            raise ValueError(
                f"draft vocab ({self.draft_cfg.vocab_size}) != target "
                f"vocab ({target_cfg.vocab_size}) — speculative proposals "
                "would be meaningless token ids")
        if (self.draft_cfg.max_position_embeddings
                < target_cfg.max_position_embeddings):
            raise ValueError(
                "draft max_position_embeddings "
                f"({self.draft_cfg.max_position_embeddings}) < target's "
                f"({target_cfg.max_position_embeddings}) — the windowed "
                "draft rotates by ABSOLUTE position, so its RoPE table "
                "must cover every position the target can serve")

    def manifest(self) -> Dict[str, Any]:
        """The spec geometry: ``k``, ``window`` and the draft's config
        (the draft's parameter values are not part of it)."""
        return {
            "k": self.k,
            "window": self.window,
            "draft_model": dataclasses.asdict(self.draft_cfg),
        }
