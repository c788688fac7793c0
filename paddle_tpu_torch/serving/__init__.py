"""Serving pieces below the engine: the cross-request prefix cache and
the KV spill tier of priority preemption (counterparts of
``paddle_tpu/serving/prefix_cache.py`` and the spill part of
``paddle_tpu/serving/resilience.py``).  The serving stack above the
engine (frontend, metrics, loadgen, fleet, http, the supervised engine)
is ROADMAP queue 1 item 13."""

from .prefix_cache import PrefixCache, PrefixCacheConfig, block_keys
from .resilience import (KVSnapshot, ResilienceError, SpillCorruptError,
                         SpillTier, restore_into_slot, snapshot_slot)

__all__ = ["KVSnapshot", "PrefixCache", "PrefixCacheConfig",
           "ResilienceError", "SpillCorruptError", "SpillTier",
           "block_keys", "restore_into_slot", "snapshot_slot"]
