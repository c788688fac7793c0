"""Host-side draft/verify/commit orchestration for one engine
(counterpart of ``paddle_tpu/spec_decode/runner.py``).

One :class:`SpecDecodeRunner` hangs off a ``ContinuousBatchingEngine``
(constructed when ``spec_config=`` is passed) and replaces the engine's
single-token decode iteration:

    draft xK  ──►  verify (K+1 decode steps)  ──►  commit/rollback

Commit is per-slot host logic: greedy slots accept a proposal iff it
equals the target argmax at that position (bit-identical stream —
verify logits ARE baseline step logits, see ``verify.py``); sampled
slots run the rejection chain of ``sampling.py`` against the warped
target law.  Emission respects the exact baseline stop rules (first
EOS, ``max_new_tokens``) token by token.

State machine per decode iteration:

    DRAFT    k greedy proposals per active slot (windowed recompute;
             inactive slots ride along as masked rows): one fixed
             [B, window] program run k times
    VERIFY   the engine's decode step K+1 times writes K+1 KV positions
             per slot and returns the K+1 next-token logit rows, copied
             to the host once: one fixed [B, K+1] program, the lengths
             advanced on the device inside it
    COMMIT   per slot: accepted prefix + one correction/bonus token is
             appended (stopping at EOS/budget); ``lengths`` advances by
             exactly the appended count
    ROLLBACK the rejected tail's KV writes sit beyond the committed
             length: masked by every later attention, overwritten by
             the next append — pages stay owned by the slot, so the
             refcount pool never moves on rollback

The JAX runner also feeds ``observability.REGISTRY`` (``_record``); the
port has no registry yet (ROADMAP.md queue 1 item 13), so ``stats``
carries the same counts.
"""

from __future__ import annotations

import weakref
from typing import Dict, List, Optional

import numpy as np

from ..aot.serve import SPEC_DRAFT, SPEC_VERIFY
from .config import SpecDecodeConfig
from .draft import assemble_windows, build_draft_program, check_draft_params
from .sampling import spec_sample_chain, warp_probs
from .verify import build_verify_program

__all__ = ["SpecDecodeRunner"]


class SpecDecodeRunner:
    """Speculative decode driver bound to one engine instance.  Its plain
    programs are ``draft_program`` on the engine's device
    (``build_draft_program``) and ``verify_program`` over the engine's
    decode step (``build_verify_program``); the engine runs them as its
    ``spec_draft`` / ``spec_verify`` programs (replays of captured graphs
    on CUDA, as the JAX runner runs them jitted).  ``draft(win, ctx)``
    and ``verify(block_table, lengths, tokens)`` take the host arrays and
    return device tensors: the seams to wrap (timers, spies).  The runner
    holds its engine through a weak proxy: the engine holds the runner,
    and a cycle would keep both (and the pools) alive until a
    garbage-collector pass."""

    def __init__(self, engine, config: SpecDecodeConfig):
        config.validate_against(engine.cfg)
        self.draft_program = build_draft_program(
            config.draft_cfg, config.window, engine.device)
        check_draft_params(config.draft_cfg, config.draft_params,
                           engine.device)
        eng = weakref.proxy(engine)
        self.engine = eng
        self.config = config
        self.verify_program = build_verify_program(
            lambda tokens, lengths, bt: eng._decode_step(tokens, lengths,
                                                         bt))
        self.draft = lambda win, ctx: eng._run(SPEC_DRAFT, win=win, ctx=ctx)
        self.verify = lambda bt, lengths, tokens: eng._run(
            SPEC_VERIFY, bt=bt, lengths=lengths, tokens=tokens)
        self.stats: Dict[str, int] = {
            "spec_steps": 0, "proposed": 0, "accepted": 0,
            "emitted": 0, "rollback_pages": 0,
        }

    @property
    def acceptance_rate(self) -> Optional[float]:
        if self.stats["proposed"] == 0:
            return None
        return self.stats["accepted"] / self.stats["proposed"]

    # -- one decode iteration ------------------------------------------
    def run_decode(self, active: List[int]) -> None:
        """Advance every active slot by 1..K+1 tokens (in place of the
        engine's single-token decode)."""
        eng = self.engine
        K = self.config.k

        # DRAFT: K greedy proposals per slot off the windowed recompute
        seqs: List[List[int]] = []
        for s in range(eng.B):
            req = eng.slots[s]
            seqs.append([] if req is None
                        else req.prompt.tolist() + req.out)
        proposals = np.zeros((eng.B, K), np.int32)
        for i in range(K):
            win, ctx = assemble_windows(seqs, self.config.window, eng.B)
            tok = self.draft(win, ctx).cpu().numpy()
            proposals[:, i] = tok
            for s in active:
                seqs[s].append(int(tok[s]))

        # VERIFY: the decode step K+1 times appends K+1 KV positions per
        # slot and scores them against the target
        tokens_mat = np.zeros((eng.B, K + 1), np.int64)
        tokens_mat[:, 0] = eng.tokens
        tokens_mat[:, 1:] = proposals
        pre_lengths = eng.lengths.copy()
        logits = self.verify(eng.block_table, pre_lengths, tokens_mat)
        logits = logits.cpu().numpy()                   # [B, K+1, V]
        eng.last_logits = logits[:, 0]

        # COMMIT / ROLLBACK per slot
        for s in active:
            req = eng.slots[s]
            ell = int(pre_lengths[s])
            if (req.temperature or 0.0) > 0.0:
                p_dists = [warp_probs(logits[s, i], req.temperature,
                                      req.top_k, req.top_p)
                           for i in range(K + 1)]
                emitted, _ = spec_sample_chain(
                    p_dists, proposals[s].tolist(), seed=req.seed,
                    start_position=ell + 1)
            else:
                emitted = []
                for i in range(K + 1):
                    want = int(logits[s, i].argmax())
                    emitted.append(want)
                    if i == K or want != int(proposals[s, i]):
                        break
            appended = 0
            for t in emitted:
                eng._append_tok(req, int(t))
                appended += 1
                if req.eos_pos is not None \
                        or len(req.out) >= req.max_new_tokens:
                    break
            # commit: KV is live for the fed token plus the first
            # appended-1 emitted tokens; everything past that is the
            # rolled-back tail
            eng.lengths[s] = ell + appended
            eng.tokens[s] = int(req.out[-1])
            accepted = sum(1 for i in range(min(appended, K))
                           if emitted[i] == int(proposals[s, i]))
            self.stats["proposed"] += K
            self.stats["accepted"] += accepted
            self.stats["emitted"] += appended
            self.stats["rollback_pages"] += self._stale_pages(
                ell + appended, ell + K + 1, eng.BS)
        self.stats["spec_steps"] += 1

    @staticmethod
    def _stale_pages(committed_end: int, written_end: int,
                     block_size: int) -> int:
        """Pages containing KV positions [committed_end, written_end)
        that the commit rolled back (stale until overwritten)."""
        if written_end <= committed_end:
            return 0
        return (written_end - 1) // block_size \
            - committed_end // block_size + 1
