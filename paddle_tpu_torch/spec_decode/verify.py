"""The verify program: K+1 target-model decode positions
(counterpart of ``paddle_tpu/spec_decode/verify.py``).

Bit-identity is the whole design.  Greedy speculative decode must emit
EXACTLY the baseline greedy stream, and the only way to guarantee that
on every device is to make the verify compute the SAME floating-point
operations as the baseline decode step — so ``build_verify_program``
takes the engine's own decode step (``ContinuousBatchingEngine.
_decode_step``) and calls it K+1 times.  Each call appends one token's
KV through the layer kernels and returns the decode-step logits for the
next position, so logits and pool contents match sequential baseline
decode bit for bit, provided each row's result depends only on its own
token, length and pages (the serving kernels' plans read the batch size
and the table's width, never the lengths).

What this buys: one host round trip per K+1 positions instead of per
token, and one SCHEDULER iteration per accepted run — engine steps per
token drop below 1.0.  On the card the K+1 steps are one captured CUDA
graph (the engine's ``spec_verify`` program, one launch from the host),
as the JAX verify is one compiled program.  What it does not buy:
parallelism across the K+1 positions (the steps run one after another).

Rollback contract: the verify ALWAYS writes K+1 positions of KV per
slot; the host commits only the accepted prefix by advancing
``lengths`` that far.  Rejected-tail writes land at positions >= the
committed length, which every later attention masks out and the next
append overwrites — the pages themselves stay owned by the slot (the
engine maps a request's full page budget at admission), so rollback
never touches the refcount pool.  Writes past a slot's table are
dropped by the kernels and by ``ops.paged_kv.paged_append``.
"""

from __future__ import annotations

import torch

__all__ = ["build_verify_program"]


def build_verify_program(step_fn):
    """Wrap a decode step (``ContinuousBatchingEngine._decode_step``:
    ``step_fn(tokens [B] int64, lengths [B] int32, block_table [B, MB]
    int32) -> logits [B, V] fp32``, writing the tokens' KV into the
    engine's pools in place) into ``verify(block_table, lengths, tokens
    [B, K+1]) -> logits [B, K+1, V]``, every tensor on the engine's
    device.

    ``tokens[:, 0]`` is each slot's fed token (the engine's
    ``tokens``), columns 1..K the draft proposals; ``logits[:, i]`` is
    the target's next-token distribution after consuming
    ``tokens[:, :i+1]`` — exactly what ``step_fn`` returns on the i-th
    sequential call.  ``lengths`` stays on the device: call i sees
    ``lengths + i``, and the caller's tensor is not changed."""

    def verify(block_table, lengths, tokens):
        rows = []
        for i in range(tokens.shape[1]):
            rows.append(step_fn(tokens[:, i], lengths, block_table))
            lengths = lengths + 1
        return torch.stack(rows, 1)

    return verify
