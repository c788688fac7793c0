"""Losslessness-preserving rejection sampling for speculative decode
(counterpart of ``paddle_tpu/spec_decode/sampling.py``; numpy there and
here, so the port's copy is bit-equal: the same inputs give the same
emitted ids and the same accepted count).

The identity this module is built on (Leviathan et al., "Fast Inference
from Transformers via Speculative Decoding"): given a target
distribution ``p`` and a proposal ``x ~ q``, accepting ``x`` with
probability ``min(1, p(x)/q(x))`` and otherwise emitting a sample from
the residual ``norm(max(p - q, 0))`` yields a token distributed EXACTLY
as ``p`` — for any ``q``.  Chaining it over K proposals (stopping at
the first rejection, plus one bonus token from the position after the
accepted prefix) therefore emits tokens whose joint law equals baseline
ancestral sampling from the target, no matter how good or bad the draft
is.  The draft moves the ACCEPTANCE RATE, never the distribution.

The engine's draft proposes greedily, so its proposal law is a one-hot
``q``; the chain then degenerates to: accept ``x`` w.p. ``p(x)``, else
sample from ``p`` with ``x`` masked out (renormalized) — still exactly
``p`` in law (substitute the one-hot into the identity above).

Randomness: each decision draws from a counter-based Philox generator
keyed by ``(request seed, absolute position)`` — deterministic per
(seed, content), independent of batch composition and host wall-clock,
the same reproducibility contract as the engine's seeded sampler (which
keys ``fold_in(key(seed), position)``).  Greedy requests never touch
this module.

``warp_probs`` mirrors ``inference.serving.build_sampler``'s HF
sequential-warper semantics (temperature, then top-k, then top-p over
the top-k-FILTERED mass) so the target law the rejection test preserves
is the very law the baseline sampler draws from.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["warp_probs", "position_rng", "spec_sample_chain"]


def warp_probs(logits: np.ndarray, temperature: float,
               top_k: Optional[int], top_p: Optional[float]) -> np.ndarray:
    """The engine sampler's categorical law as an explicit probability
    vector: softmax(logits/T) restricted to the sequential top-k /
    top-p keep-set.  Matches ``build_sampler`` cutoff conventions
    (kth-largest inclusive; smallest prefix with cum >= top_p)."""
    x = np.asarray(logits, np.float64) / float(temperature)
    keep = np.ones(x.shape, bool)
    if top_k and top_k > 0:
        kth = np.sort(x)[::-1][max(int(top_k), 1) - 1]
        keep &= x >= kth
    if top_p and top_p > 0.0:
        xf = np.where(keep, x, -np.inf)
        srt = np.sort(xf)[::-1]
        probs = _softmax(srt)
        cum = np.cumsum(probs)
        cutoff = srt[int(np.sum(cum < top_p))]
        keep &= xf >= cutoff
    p = _softmax(np.where(keep, x, -np.inf))
    return p


def _softmax(x: np.ndarray) -> np.ndarray:
    m = np.max(x)
    e = np.exp(x - m)
    return e / np.sum(e)


def position_rng(seed: int, position: int) -> np.random.Generator:
    """Counter-based generator for one (request, position) decision —
    reproducible across processes and independent of call order."""
    return np.random.Generator(
        np.random.Philox(key=np.uint64(np.uint32(seed)) << np.uint64(32)
                         | np.uint64(np.uint32(position))))


def spec_sample_chain(p_dists: Sequence[np.ndarray],
                      proposals: Sequence[int],
                      q_dists: Optional[Sequence[np.ndarray]] = None, *,
                      seed: int = 0, start_position: int = 0
                      ) -> Tuple[List[int], int]:
    """Run the rejection chain over K proposals plus the bonus position.

    Args:
      p_dists: K+1 target distributions (``p_dists[i]`` is the law of
        the token at position ``start_position + i``).
      proposals: the K draft tokens.
      q_dists: per-position proposal distributions; ``None`` means
        one-hot at ``proposals[i]`` (the greedy-draft case).
      seed / start_position: the Philox key inputs; position ``i``'s
        decision uses ``position_rng(seed, start_position + i)``.

    Returns ``(emitted tokens, accepted proposal count)``; emitted has
    ``accepted + 1`` entries — the accepted prefix plus either the
    residual sample at the first rejection or the bonus token.
    """
    if len(p_dists) != len(proposals) + 1:
        raise ValueError(
            f"need K+1 target dists for K proposals, got "
            f"{len(p_dists)} vs {len(proposals)}")
    emitted: List[int] = []
    for i, x in enumerate(proposals):
        p = np.asarray(p_dists[i], np.float64)
        rng = position_rng(seed, start_position + i)
        if q_dists is None:
            q_x = 1.0
            residual = p.copy()
            residual[x] = 0.0
        else:
            q = np.asarray(q_dists[i], np.float64)
            q_x = q[x]
            residual = np.maximum(p - q, 0.0)
        accept_p = 1.0 if q_x <= 0.0 else min(1.0, p[x] / q_x)
        if rng.random() < accept_p:
            emitted.append(int(x))
            continue
        z = residual.sum()
        if z <= 0.0:
            # p(x) == 1: rejection has probability zero; numerical
            # underflow can still land here — emit from p itself
            residual, z = p, p.sum()
        emitted.append(int(rng.choice(len(p), p=residual / z)))
        return emitted, i
    # every proposal accepted: bonus token from the K+1-th distribution
    p = np.asarray(p_dists[-1], np.float64)
    rng = position_rng(seed, start_position + len(proposals))
    emitted.append(int(rng.choice(len(p), p=p / p.sum())))
    return emitted, len(proposals)
