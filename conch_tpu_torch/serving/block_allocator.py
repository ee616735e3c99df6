# Copyright 2026 Conch-TPU authors.
# SPDX-License-Identifier: Apache-2.0

"""Paged KV-cache block allocator with refcounts (counterpart of
``conch_tpu/serving/block_allocator.py``).

The host-side memory manager of the serving engine: free-list
allocation and per-page refcounts for shared pages: prefix-cached pages
and a parallel-sampling group's full prompt pages (``fork``); the engine
copies a group's partial tail page for each sibling.
"""

from __future__ import annotations


class BlockAllocator:
    """Free-list page allocator with refcounting."""

    def __init__(self, num_pages: int) -> None:
        self.num_pages = num_pages
        self._free: list[int] = list(range(num_pages - 1, -1, -1))
        self._refcount = [0] * num_pages

    @property
    def num_free(self) -> int:
        return len(self._free)

    def allocate(self) -> int:
        """Allocate one page (refcount 1). Raises if exhausted."""
        if not self._free:
            msg = "Out of KV-cache pages"
            raise MemoryError(msg)
        page = self._free.pop()
        self._refcount[page] = 1
        return page

    def can_allocate(self, n: int) -> bool:
        return len(self._free) >= n

    def free(self, page: int) -> None:
        """Drop one reference; the page returns to the free list at zero."""
        if self._refcount[page] <= 0:
            msg = f"double free of page {page}"
            raise RuntimeError(msg)
        self._refcount[page] -= 1
        if self._refcount[page] == 0:
            self._free.append(page)

    def fork(self, page: int) -> None:
        """Share a page: bump its refcount."""
        if self._refcount[page] <= 0:
            msg = f"fork of free page {page}"
            raise RuntimeError(msg)
        self._refcount[page] += 1
