"""Bounded LRU cache: the ONE cache implementation shared by the engine.

:class:`~repro_torch.aqp.engine.FastFrame` keeps three of these: the
device materialization caches (value columns, predicate masks, group-code
columns). A copy of :mod:`repro.core.lru`, kept in the port so that it
imports nothing of the JAX package.

Semantics: ``get_or_build`` is a read-through cache with
recency-refresh-on-hit; inserting past ``capacity`` evicts the least
recently used entry. Eviction only drops the cache's reference — callers
holding a direct reference (e.g. an in-flight scan holding a device
buffer, or a running compiled loop) are never invalidated.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Callable, Hashable, TypeVar

V = TypeVar("V")

__all__ = ["LRUCache"]


class LRUCache:
    """Bounded mapping with least-recently-used eviction.

    Example::

        cache = LRUCache(capacity=32)
        buf = cache.get_or_build(key, lambda: expensive_build())
    """

    def __init__(self, capacity: int):
        if capacity < 1:
            raise ValueError(f"LRUCache capacity must be >= 1, "
                             f"got {capacity}")
        self.capacity = int(capacity)
        self._data: "OrderedDict[Hashable, object]" = OrderedDict()
        self.misses = 0   # builds: the lookups that found no entry

    def get_or_build(self, key: Hashable, build: Callable[[], V]) -> V:
        """Return the cached value for ``key`` (refreshing its recency),
        building, inserting and LRU-bounding on a miss."""
        hit = self._data.get(key)
        if hit is not None:
            self._data.move_to_end(key)
            return hit
        self.misses += 1
        val = self._data[key] = build()
        while len(self._data) > self.capacity:
            self._data.popitem(last=False)
        return val

    def __getitem__(self, key: Hashable):
        """Plain lookup (KeyError on miss); does NOT refresh recency —
        use :meth:`get_or_build` on hot paths."""
        return self._data[key]

    def __len__(self) -> int:
        return len(self._data)

    def __contains__(self, key: Hashable) -> bool:
        return key in self._data

    def keys(self):
        return self._data.keys()

    def clear(self) -> None:
        self._data.clear()
