"""KV spill and restore for priority preemption (counterpart of the
spill part of ``paddle_tpu/serving/resilience.py``).

``snapshot_slot`` reads a running slot's committed KV pages off the
device and CRC32-stamps them; ``restore_into_slot`` verifies the
checksums and writes the exact bytes into the slot's fresh pages.  The
decode step reads KV only through the block table and the sampler is
keyed by (seed, absolute position), so a preempt / restore cycle gives
the tokens an unpreempted run gives.  :class:`SpillTier` bounds the host
RAM the snapshots hold; a snapshot evicted past its cap demotes its
request to replay from its committed tokens.

Unlike the JAX module, which moves the whole pool through numpy (a
device gather there is a compile per page count), only the used pages
move: ``index_select`` on the page axis of each pool (and of its scales)
on the device, then one copy to the host; a restore copies the pages to
the device and writes them into the slot's pages in place.  The host
copies are CPU tensors of the pool's dtype, page-major as the JAX
snapshot's numpy arrays: ``[L, pages, BS, Hkv, D]`` codes or values,
``[L, pages, BS, Hkv]`` fp32 scales.  The CRCs chain over the values
(or codes) then the scales, as there.
"""

from __future__ import annotations

import collections
import zlib
from dataclasses import dataclass
from typing import List, Optional

import torch

from ..ops.paged_kv import is_quantized_pool

__all__ = ["KVSnapshot", "ResilienceError", "SpillCorruptError",
           "SpillTier", "page_crc", "read_pages", "restore_into_slot",
           "snapshot_slot", "write_pages"]


class ResilienceError(RuntimeError):
    """Base for typed resilience failures."""


class SpillCorruptError(ResilienceError):
    """A spilled KV snapshot (or an offloaded prefix block) failed its
    CRC check, or its quantization does not match the pool it would
    restore into.  The engine drops the snapshot and its request (a
    supervisor replays it from its committed tokens); a prefix block
    falls back to recomputing the suffix."""


def _host_bytes(t: torch.Tensor):
    """The bytes of a CPU tensor, row-major, as a numpy uint8 view."""
    return t.contiguous().reshape(-1).view(torch.uint8).numpy()


def page_crc(pages: torch.Tensor, scale: Optional[torch.Tensor]) -> int:
    """CRC32 over the pages' bytes, then over the scales' when given."""
    crc = zlib.crc32(_host_bytes(pages))
    if scale is not None:
        crc = zlib.crc32(_host_bytes(scale), crc)
    return crc


def read_pages(engine, pages: List[int]):
    """Host copies ``(k, v, k_scale, v_scale)`` of the pool pages
    ``pages`` (the scales None for a full-width pool): one device gather
    a tensor, one copy to the host."""
    idx = torch.tensor(pages, dtype=torch.long, device=engine.device)
    out = []
    for pool in (engine.pool_k, engine.pool_v):
        data = pool.data if is_quantized_pool(pool) else pool
        out.append(data.index_select(1, idx).cpu())
    for pool in (engine.pool_k, engine.pool_v):
        out.append(pool.scale.index_select(1, idx).cpu()
                   if is_quantized_pool(pool) else None)
    return tuple(out)


def write_pages(engine, pages: List[int], k, v, k_scale=None,
                v_scale=None) -> None:
    """Write host page copies into the pool pages ``pages``, in place."""
    idx = torch.tensor(pages, dtype=torch.long, device=engine.device)
    for pool, src, scale in ((engine.pool_k, k, k_scale),
                             (engine.pool_v, v, v_scale)):
        if is_quantized_pool(pool):
            pool.data.index_copy_(1, idx, src.to(engine.device))
            pool.scale.index_copy_(1, idx, scale.to(engine.device))
        else:
            pool.index_copy_(1, idx, src.to(engine.device))


@dataclass
class KVSnapshot:
    """One preempted request's committed serving state in host RAM: the
    exact bytes of its committed KV pages plus the decode cursor
    (committed length and pending fed token)."""

    req_id: int
    length: int                # committed KV positions
    next_token: int            # pending fed token (decode cursor)
    num_blocks: int            # full table width to re-acquire
    k_pages: torch.Tensor      # [L, used_pages, BS, Hkv, D], on the host
    v_pages: torch.Tensor
    k_scale: Optional[torch.Tensor] = None   # [L, used_pages, BS, Hkv]
    v_scale: Optional[torch.Tensor] = None
    crc_k: int = 0
    crc_v: int = 0

    def __post_init__(self):
        if not self.crc_k and not self.crc_v:
            self.crc_k = page_crc(self.k_pages, self.k_scale)
            self.crc_v = page_crc(self.v_pages, self.v_scale)

    @property
    def nbytes(self) -> int:
        n = _nbytes(self.k_pages) + _nbytes(self.v_pages)
        if self.k_scale is not None:
            n += _nbytes(self.k_scale) + _nbytes(self.v_scale)
        return n

    def verify(self) -> None:
        """Raise :class:`SpillCorruptError` unless the page bytes still
        match their spill-time checksums."""
        if page_crc(self.k_pages, self.k_scale) != self.crc_k or \
                page_crc(self.v_pages, self.v_scale) != self.crc_v:
            raise SpillCorruptError(
                f"spilled KV snapshot for request {self.req_id} failed "
                "its CRC check — host-RAM bit-rot or a write raced the "
                "spill; the request must be replayed from its committed "
                "token prefix")


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def snapshot_slot(engine, slot: int) -> KVSnapshot:
    """Copy the committed KV pages of a RUNNING slot to the host and
    CRC-stamp them.  Only pages holding committed positions
    (``ceil(length / block_size)``) are copied: the reserved tail holds
    nothing the decode reads (``lengths`` masks it, as on a fresh
    slot)."""
    req = engine.slots[slot]
    length = int(engine.lengths[slot])
    used = -(-length // engine.BS)
    pages = engine.slot_pages[slot]
    k, v, ks, vs = read_pages(engine, pages[:used])
    return KVSnapshot(req_id=req.req_id, length=length,
                      next_token=int(engine.tokens[slot]),
                      num_blocks=len(pages), k_pages=k, v_pages=v,
                      k_scale=ks, v_scale=vs)


def restore_into_slot(engine, slot: int, snap: KVSnapshot) -> None:
    """Verify a snapshot and write its page bytes into the slot's freshly
    acquired pages (``engine.slot_pages[slot]``), in place."""
    snap.verify()
    quant = is_quantized_pool(engine.pool_k)
    if (snap.k_scale is not None) != quant:
        raise SpillCorruptError(
            f"KV snapshot for request {snap.req_id} "
            f"{'carries' if snap.k_scale is not None else 'lacks'} "
            "quantization scales but the engine's pool "
            f"{'is' if quant else 'is not'} quantized — the snapshot "
            "cannot scatter; replay from the committed token prefix")
    used = snap.k_pages.shape[1]
    write_pages(engine, engine.slot_pages[slot][:used], snap.k_pages,
                snap.v_pages, snap.k_scale, snap.v_scale)


class SpillTier:
    """Bounded host-RAM store for spilled :class:`KVSnapshot` objects.

    ``capacity_bytes`` caps the tier (None: unbounded); inserting past
    the cap evicts the oldest snapshots (``policy="evict-oldest"``).  An
    evicted request is not lost: the engine replays its KV from its
    committed tokens at re-admission.  The dict-like surface
    (``tier[rid]``, ``rid in tier``, ``pop``, ``del``) is a plain dict's;
    only :meth:`put` checks the capacity."""

    def __init__(self, capacity_bytes: Optional[int] = None,
                 policy: str = "evict-oldest"):
        if policy != "evict-oldest":
            raise ValueError(f"unknown spill policy {policy!r} "
                             "(have: evict-oldest)")
        if capacity_bytes is not None and capacity_bytes < 0:
            raise ValueError("capacity_bytes must be >= 0 or None")
        self.capacity_bytes = capacity_bytes
        self.policy = policy
        self._snaps: "collections.OrderedDict[int, KVSnapshot]" = \
            collections.OrderedDict()
        self.evictions = 0

    @property
    def nbytes(self) -> int:
        return sum(s.nbytes for s in self._snaps.values())

    def put(self, req_id: int, snap: KVSnapshot) -> list:
        """Insert a snapshot; returns the req_ids evicted to make room
        (``req_id`` itself when one snapshot alone exceeds the cap)."""
        self._snaps[req_id] = snap
        evicted = []
        if self.capacity_bytes is not None:
            while self._snaps and self.nbytes > self.capacity_bytes:
                rid, _ = self._snaps.popitem(last=False)
                evicted.append(rid)
                self.evictions += 1
        return evicted

    def get(self, req_id: int, default=None):
        return self._snaps.get(req_id, default)

    def pop(self, req_id: int, *default):
        return self._snaps.pop(req_id, *default)

    def values(self):
        return self._snaps.values()

    def keys(self):
        return self._snaps.keys()

    def __getitem__(self, req_id: int) -> KVSnapshot:
        return self._snaps[req_id]

    def __delitem__(self, req_id: int) -> None:
        del self._snaps[req_id]

    def __contains__(self, req_id: int) -> bool:
        return req_id in self._snaps

    def __len__(self) -> int:
        return len(self._snaps)
