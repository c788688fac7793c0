"""Cross-request prefix cache: a radix tree over committed KV pages,
with a bounded CRC-checked host-RAM offload tier (counterpart of
``paddle_tpu/serving/prefix_cache.py``).

* One node per token block, keyed by the chained block digest
  (:func:`block_keys`, ``key_b = sha1(key_{b-1} || tokens_b)``, byte for
  byte the JAX package's), so walking the tree along a prompt's keys
  gives its longest cached page-aligned prefix.  A node parks either a
  resident pool page (the cache holds one ``_RefPool`` reference, taken
  and released by the engine) or an offloaded host copy of its page.
* Under pool pressure the engine evicts the least recently used node
  whose page only the cache holds, leaf first.  With an offload budget
  (``PrefixCacheConfig.offload_capacity_bytes``) the victim's exact page
  bytes park on the host, CRC32-stamped as spill snapshots are
  (``serving/resilience.py``); past the budget the oldest host block is
  dropped.  An offloaded block restores by writing its bytes into a
  fresh page; a CRC failure then is a :class:`SpillCorruptError` that
  the engine turns into a recompute of the rest of the suffix.
* :meth:`PrefixCache.match_blocks` answers how many leading blocks of a
  chain are cached without touching the LRU order.

The host copies are CPU tensors of the pool's dtype, one page each:
``[L, BS, Hkv, D]`` values or int8 codes, ``[L, BS, Hkv]`` fp32 scales.
"""

from __future__ import annotations

import collections
import hashlib
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from .resilience import SpillCorruptError, page_crc

__all__ = ["PrefixCache", "PrefixCacheConfig", "block_keys"]

# the key scheme's name, as the JAX package records it
SCHEME = "sha1-chain/v1"


def block_keys(tokens, n: int, block_size: int) -> List[bytes]:
    """Chained per-block digests over the first ``n`` blocks of
    ``tokens`` (int32 bytes): ``key_b = sha1(key_{b-1} || block_b)``."""
    tokens = np.asarray(tokens, np.int32)
    keys: List[bytes] = []
    prev = b""
    for b in range(n):
        h = hashlib.sha1(
            prev + tokens[b * block_size:(b + 1) * block_size].tobytes())
        prev = h.digest()
        keys.append(prev)
    return keys


@dataclass(frozen=True)
class PrefixCacheConfig:
    """Policy of the prefix cache.

    offload_capacity_bytes:
        Host-RAM budget of the offload tier.  0 (the default) disables
        offload: eviction under pool pressure drops the prefix, and the
        next hit recomputes it.  Past the budget the oldest offloaded
        block is dropped.
    """

    offload_capacity_bytes: int = 0

    def __post_init__(self):
        if self.offload_capacity_bytes < 0:
            raise ValueError("offload_capacity_bytes must be >= 0")


def _nbytes(t: Optional[torch.Tensor]) -> int:
    return 0 if t is None else t.numel() * t.element_size()


@dataclass
class _Node:
    """One cached token block: RESIDENT (``phys`` set), OFFLOADED
    (``k_bytes`` / ``v_bytes`` set, CRC-stamped), or a bare placeholder
    kept only while it has children (lookups stop at it)."""

    key: bytes
    parent: Optional["_Node"]
    depth: int
    children: Dict[bytes, "_Node"] = field(default_factory=dict)
    phys: Optional[int] = None
    k_bytes: Optional[torch.Tensor] = None
    v_bytes: Optional[torch.Tensor] = None
    # int8 pools: the per-(token, head) fp32 scales, CRC'd after the codes
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None
    crc_k: int = 0
    crc_v: int = 0

    @property
    def resident(self) -> bool:
        return self.phys is not None

    @property
    def offloaded(self) -> bool:
        return self.k_bytes is not None

    @property
    def host_nbytes(self) -> int:
        return (_nbytes(self.k_bytes) + _nbytes(self.v_bytes)
                + _nbytes(self.k_scale) + _nbytes(self.v_scale))

    def verify(self) -> None:
        """Raise :class:`SpillCorruptError` unless the offloaded bytes
        still match their offload-time checksums."""
        if page_crc(self.k_bytes, self.k_scale) != self.crc_k or \
                page_crc(self.v_bytes, self.v_scale) != self.crc_v:
            raise SpillCorruptError(
                f"offloaded prefix block {self.key.hex()[:12]} (depth "
                f"{self.depth}) failed its CRC check — host-RAM bit-rot; "
                "the suffix must be recomputed from the last good block")


class PrefixCache:
    """Radix tree over committed KV pages, keyed by token-block content.

    The engine owns the refcount pool; this class records which page a
    resident node parks and hands victims back for the engine to
    release.

    Args:
      block_size: the engine's KV page size in tokens.
      config: :class:`PrefixCacheConfig`.
    """

    SCHEME = SCHEME

    def __init__(self, block_size: int,
                 config: Optional[PrefixCacheConfig] = None):
        self.BS = int(block_size)
        self.config = config or PrefixCacheConfig()
        self._root = _Node(key=b"", parent=None, depth=-1)
        # keyed by id(node): a dropped-and-reinserted chain must not
        # collide with a detached twin
        self._lru: "collections.OrderedDict[int, _Node]" = \
            collections.OrderedDict()
        self._host_lru: "collections.OrderedDict[int, _Node]" = \
            collections.OrderedDict()
        self.host_bytes = 0
        self.stats: Dict[str, int] = {
            "lookups": 0, "hits": 0, "hit_blocks": 0, "hit_tokens": 0,
            "inserts": 0, "evictions": 0, "offloads": 0, "restores": 0,
            "restore_failures": 0, "offload_drops": 0,
        }

    # -- introspection --------------------------------------------------
    @property
    def resident_blocks(self) -> int:
        return len(self._lru)

    @property
    def offloaded_blocks(self) -> int:
        return len(self._host_lru)

    @property
    def wants_offload(self) -> bool:
        """Whether eviction should capture page bytes."""
        return self.config.offload_capacity_bytes > 0

    def resident_items(self) -> List[Tuple[bytes, int]]:
        """(key, phys) of every resident node, oldest first."""
        return [(n.key, n.phys) for n in self._lru.values()]

    def keys_for(self, prompt, n: int) -> List[bytes]:
        return block_keys(prompt, n, self.BS)

    # -- lookup ---------------------------------------------------------
    def walk(self, keys: List[bytes]) -> Tuple[List[int], List["_Node"]]:
        """Longest cached chain prefix for ``keys``: ``(resident_pages,
        offloaded_nodes)``, residents first; stops at the first uncached
        or placeholder node.  Refreshes the recency of every node
        visited."""
        pages: List[int] = []
        off: List[_Node] = []
        node = self._root
        for key in keys:
            child = node.children.get(key)
            if child is None:
                break
            if child.resident:
                if off:
                    break   # never hand out a torn chain
                pages.append(child.phys)
                self._lru.move_to_end(id(child))
            elif child.offloaded:
                off.append(child)
                self._host_lru.move_to_end(id(child))
            else:
                break       # placeholder: chain broken here
            node = child
        return pages, off

    def match_blocks(self, keys: List[bytes]) -> int:
        """Longest cached chain prefix, without touching the LRU order."""
        node, n = self._root, 0
        for key in keys:
            child = node.children.get(key)
            if child is None or not (child.resident or child.offloaded):
                break
            n += 1
            node = child
        return n

    # -- insert ---------------------------------------------------------
    def insert(self, keys: List[bytes], pages: List[int]) -> List[int]:
        """Register ``keys[i] -> pages[i]`` as resident nodes; returns the
        pages the cache took new custody of (the caller takes one pool
        reference on each).  A block already resident keeps its page; an
        offloaded twin is superseded by the fresh page."""
        node = self._root
        took: List[int] = []
        for key, phys in zip(keys, pages):
            child = node.children.get(key)
            if child is None:
                child = _Node(key=key, parent=node, depth=node.depth + 1)
                node.children[key] = child
            if child.resident:
                self._lru.move_to_end(id(child))
            else:
                if child.offloaded:
                    self._drop_host(child, detach=False)
                child.phys = phys
                self._lru[id(child)] = child
                took.append(phys)
                self.stats["inserts"] += 1
            node = child
        return took

    # -- eviction / offload ---------------------------------------------
    def evictable(self, refcount: Callable[[int], int]
                  ) -> Optional["_Node"]:
        """The next victim: the least recently used resident node whose
        page only the cache holds (``refcount(phys) == 1``), preferring
        nodes with no resident children; else the oldest mid-chain one.
        None when nothing can be freed."""
        fallback: Optional[_Node] = None
        for node in self._lru.values():
            if refcount(node.phys) != 1:
                continue
            if any(c.resident for c in node.children.values()):
                if fallback is None:
                    fallback = node
                continue
            return node
        return fallback

    def evict(self, node: "_Node",
              k_bytes: Optional[torch.Tensor] = None,
              v_bytes: Optional[torch.Tensor] = None,
              k_scale: Optional[torch.Tensor] = None,
              v_scale: Optional[torch.Tensor] = None) -> int:
        """Drop ``node``'s residency and return its page for the caller
        to release.  With page bytes (and an offload budget) the block
        parks on the host, CRC-stamped, the oldest host block dropped
        past the budget."""
        phys = node.phys
        node.phys = None
        del self._lru[id(node)]
        self.stats["evictions"] += 1
        if k_bytes is not None and self.wants_offload:
            node.k_bytes, node.v_bytes = k_bytes, v_bytes
            node.k_scale, node.v_scale = k_scale, v_scale
            node.crc_k = page_crc(k_bytes, k_scale)
            node.crc_v = page_crc(v_bytes, v_scale)
            self._host_lru[id(node)] = node
            self.host_bytes += node.host_nbytes
            self.stats["offloads"] += 1
            cap = self.config.offload_capacity_bytes
            while self.host_bytes > cap and self._host_lru:
                oldest = next(iter(self._host_lru.values()))
                self._drop_host(oldest)
                self.stats["offload_drops"] += 1
        else:
            self._detach_if_bare(node)
        return phys

    def promote(self, node: "_Node", phys: int) -> None:
        """An offloaded node's bytes went into fresh page ``phys``: make it
        resident again (the caller takes the cache's pool reference)."""
        self._drop_host(node, detach=False)
        node.phys = phys
        self._lru[id(node)] = node
        self.stats["restores"] += 1

    def drop_host(self, node: "_Node") -> None:
        """Discard an offloaded node's bytes (CRC failure at restore)."""
        self.stats["restore_failures"] += 1
        self._drop_host(node)

    # -- internals ------------------------------------------------------
    def _drop_host(self, node: "_Node", detach: bool = True) -> None:
        if node.offloaded:
            self.host_bytes -= node.host_nbytes
            node.k_bytes = node.v_bytes = None
            node.k_scale = node.v_scale = None
            node.crc_k = node.crc_v = 0
            self._host_lru.pop(id(node), None)
        if detach:
            self._detach_if_bare(node)

    def _detach_if_bare(self, node: "_Node") -> None:
        """Unlink payload-less childless nodes, walking up while the
        parent becomes bare too."""
        while node is not self._root and node.parent is not None \
                and not node.resident and not node.offloaded \
                and not node.children:
            parent = node.parent
            if parent.children.get(node.key) is node:
                del parent.children[node.key]
            node.parent = None
            node = parent
