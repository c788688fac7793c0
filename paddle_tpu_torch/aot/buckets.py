"""Declared prefill chunk buckets (host-only copy of the JAX package's
``aot/buckets.py``).

A :class:`ShapeBucketRegistry` declares a fixed set of prefill CHUNK
lengths; any prompt is decomposed into a sequence of declared chunks,
the last one zero-padded to its bucket.  Decomposition is greedy
largest-first; a remainder smaller than the smallest bucket pads the
smallest bucket.  A chunk whose ``valid`` count equals its bucket size is
a hit, a padded chunk a miss; both are counted.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

__all__ = ["ShapeBucketRegistry", "DEFAULT_CHUNK_BUCKETS"]

#: chunk lengths that cover short prompts exactly and long prompts with
#: <= smallest-bucket padding waste per request
DEFAULT_CHUNK_BUCKETS = (16, 64, 256)


class ShapeBucketRegistry:
    """Declared (chunk_sizes, max_batch) serve buckets + hit/miss
    accounting."""

    def __init__(self, chunk_sizes, max_batch: Optional[int] = None):
        sizes = sorted({int(c) for c in chunk_sizes})
        if not sizes or sizes[0] < 1:
            raise ValueError(f"chunk_sizes must be positive: {chunk_sizes}")
        self.chunk_sizes: Tuple[int, ...] = tuple(sizes)
        self.max_batch = None if max_batch is None else int(max_batch)
        self.hits = 0
        self.misses = 0
        self.padded_tokens = 0

    def plan_chunks(self, n: int) -> List[Tuple[int, int]]:
        """Decompose a prefill of ``n`` tokens into [(bucket, valid)]
        with sum(valid) == n and every bucket declared.  Updates the
        hit/miss counters."""
        if n < 1:
            raise ValueError("cannot plan an empty prefill")
        out: List[Tuple[int, int]] = []
        rem = n
        while rem > 0:
            size = self.chunk_sizes[0]
            for c in reversed(self.chunk_sizes):
                if c <= rem:
                    size = c
                    break
            valid = min(size, rem)
            out.append((size, valid))
            rem -= valid
            if valid == size:
                self.hits += 1
            else:
                self.misses += 1
                self.padded_tokens += size - valid
        return out

    def stats(self) -> Dict[str, int]:
        return {"bucket_hits": self.hits, "bucket_misses": self.misses,
                "bucket_padded_tokens": self.padded_tokens}

    # -- manifest round-trip -------------------------------------------
    def to_manifest(self) -> Dict[str, Any]:
        return {"chunk_sizes": list(self.chunk_sizes),
                "max_batch": self.max_batch}

    @classmethod
    def from_manifest(cls, m: Dict[str, Any]) -> "ShapeBucketRegistry":
        return cls(m["chunk_sizes"], max_batch=m.get("max_batch"))
