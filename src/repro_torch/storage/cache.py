"""LRU page cache — models the OS page cache under a cgroup memory budget.

Used by the mmap/swap baselines so latency vs memory budget is *emergent*
from cache dynamics rather than hardcoded hit rates.
"""
from __future__ import annotations

from collections import OrderedDict

from repro_torch.storage.ssd import DEFAULT_BLOCK


class PageCache:
    def __init__(self, capacity_bytes: int, block: int = DEFAULT_BLOCK):
        self.capacity_pages = max(0, int(capacity_bytes // block))
        self.block = block
        self._lru: OrderedDict[int, None] = OrderedDict()
        self.hits = 0
        self.misses = 0

    def access(self, page: int) -> bool:
        """Touch one page; returns True on hit."""
        if page in self._lru:
            self._lru.move_to_end(page)
            self.hits += 1
            return True
        self.misses += 1
        self.insert(page)
        return False

    def insert(self, page: int):
        if self.capacity_pages == 0:
            return
        self._lru[page] = None
        self._lru.move_to_end(page)
        while len(self._lru) > self.capacity_pages:
            self._lru.popitem(last=False)

    def access_many(self, pages) -> tuple[int, int]:
        """Returns (hits, misses) for a sequence of page ids."""
        h = 0
        for p in pages:
            if self.access(p):
                h += 1
        return h, len(pages) - h

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0
