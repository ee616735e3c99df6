# Copyright 2026 Conch-TPU authors.
# SPDX-License-Identifier: Apache-2.0

"""Paged KV-cache block allocator with refcounts (counterpart of
``conch_tpu/serving/block_allocator.py``).

The host-side memory manager of the serving engine: free-list
allocation and per-page refcounts for shared pages: prefix-cached pages,
a parallel-sampling group's full prompt pages and beam search's shared
pages (``fork``); the engine copies a partial tail page for each sibling or
beam. ``native.NativeBlockAllocator`` has the same interface in C++.
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

    def refcount(self, page: int) -> int:
        return self._refcount[page]

    def is_shared(self, page: int) -> bool:
        return self._refcount[page] > 1

    def cow(self, page: int) -> tuple[int, bool]:
        """A writable page for ``page``: itself if not shared, else a fresh
        page (the caller copies) while ``page`` drops one reference."""
        if not self.is_shared(page):
            return page, False
        new_page = self.allocate()
        self._refcount[page] -= 1
        return new_page, True
