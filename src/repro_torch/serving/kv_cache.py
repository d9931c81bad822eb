"""Paged KV-cache accounting + page pool.

The allocator owns the HBM page budget: pages not claimed by resident weights
are available for KV. This is the mechanism behind the paper's Fig. 14 —
smaller offloading interval => fewer resident weight bytes => more pages =>
larger max allocatable length. Execution-side, the page pool backs the Pallas
paged decode kernel (block tables per request): the serving engine's jitted
decode computes directly through these frames — the accounting pool and the
compute pool are one object (see serving.engine).
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class PageConfig:
    page_size: int = 16          # tokens per page
    bytes_per_token: int = 0     # whole-model KV bytes for one token


class PagedKVAllocator:
    """Page pool with per-page refcounts: a frame may be referenced by more
    than one request (cross-request prefix dedup / copy-on-write sharing).
    ``alloc_pages`` hands out private frames (refcount 1); ``share_pages``
    adds another owner to a live frame; a frame returns to the free list only
    when its last reference drops."""

    def __init__(self, total_bytes: int, pcfg: PageConfig):
        assert pcfg.bytes_per_token > 0
        self.pcfg = pcfg
        self.page_bytes = pcfg.page_size * pcfg.bytes_per_token
        self.total_pages = max(int(total_bytes // self.page_bytes), 0)
        self._free = list(range(self.total_pages - 1, -1, -1))
        self._by_req: dict[int, list[int]] = {}
        self._rc: dict[int, int] = {}
        self.used_peak = 0

    # ---- queries -------------------------------------------------------------
    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def used_pages(self) -> int:
        """Unique frames in use (a shared frame counts once)."""
        return self.total_pages - len(self._free)

    def refcount(self, page: int) -> int:
        return self._rc.get(page, 0)

    def max_allocatable_tokens(self) -> int:
        """Paper Fig. 14's 'max length' metric."""
        return self.free_pages * self.pcfg.page_size

    def pages_for(self, tokens: int) -> int:
        return -(-tokens // self.pcfg.page_size)

    def pages_of(self, rid: int) -> list[int]:
        return list(self._by_req.get(rid, []))

    # ---- allocation ----------------------------------------------------------
    def alloc_pages(self, rid: int, n: int) -> list[int] | None:
        """Claim ``n`` specific pages for ``rid`` (n == 0 is a valid no-op)."""
        if n > self.free_pages:
            return None
        pages = [self._free.pop() for _ in range(n)]
        if pages:
            self._by_req.setdefault(rid, []).extend(pages)
            for p in pages:
                self._rc[p] = 1
        self.used_peak = max(self.used_peak, self.used_pages)
        return pages

    def share_pages(self, rid: int, pages: list[int]) -> None:
        """Add ``rid`` as another owner of live frames (prefix dedup):
        refcount += 1, no new frame is claimed. Raises if a page is free."""
        for p in pages:
            if self._rc.get(p, 0) < 1:
                raise ValueError(f"cannot share free page {p}")
            self._rc[p] += 1
        if pages:
            self._by_req.setdefault(rid, []).extend(pages)

    def release_pages(self, rid: int, pages: list[int]) -> list[int]:
        """Drop ``rid``'s reference to specific pages; a frame returns to the
        free list only when its last reference drops (returned list). Raises
        if a page is not owned by ``rid`` — the free list must never hold
        duplicates."""
        owned = self._by_req.get(rid, [])
        freed: list[int] = []
        for p in pages:
            owned.remove(p)      # ValueError on foreign/double release
            self._rc[p] -= 1
            if self._rc[p] == 0:
                del self._rc[p]
                self._free.append(p)
                freed.append(p)
        if not owned:
            self._by_req.pop(rid, None)
        return freed

    def alloc(self, rid: int, tokens: int) -> list[int] | None:
        return self.alloc_pages(rid, self.pages_for(tokens))

    def extend(self, rid: int, new_total_tokens: int) -> bool:
        have = len(self._by_req.get(rid, []))
        need = self.pages_for(new_total_tokens) - have
        if need <= 0:
            return True
        return self.alloc_pages(rid, need) is not None

    def free(self, rid: int) -> list[int]:
        """Drop every reference ``rid`` holds; double-free is a no-op.
        Returns the frames whose last reference dropped (now free) — the
        tiered allocator uses this to evict dead prefix-index entries."""
        freed: list[int] = []
        for p in self._by_req.pop(rid, []):
            self._rc[p] -= 1
            if self._rc[p] == 0:
                del self._rc[p]
                self._free.append(p)
                freed.append(p)
        return freed

    def check_invariants(self) -> None:
        """Free list and held frames partition [0, total_pages); every held
        frame's refcount equals its reference multiplicity across requests."""
        free = self._free
        assert len(set(free)) == len(free), "duplicate pages in free list"
        held = [p for pages in self._by_req.values() for p in pages]
        counts: dict[int, int] = {}
        for p in held:
            counts[p] = counts.get(p, 0) + 1
        assert counts == self._rc, "refcounts out of sync with references"
        assert all(c >= 1 for c in counts.values())
        assert not set(free) & set(counts), "page both free and owned"
        assert len(free) + len(counts) == self.total_pages

    def block_table(self, rid: int, max_pages: int) -> np.ndarray:
        """Padded block table row for the paged decode kernel. Raises when the
        request holds more pages than ``max_pages`` — silent truncation would
        make the kernel attend through the wrong frames."""
        return padded_block_table(self._by_req.get(rid, []), max_pages, rid)


def padded_block_table(pages: list[int], max_pages: int, rid: int
                       ) -> np.ndarray:
    """Zero-padded [max_pages] int32 table row; raises instead of truncating
    (shared by the device allocator and the tiered allocator)."""
    if len(pages) > max_pages:
        raise ValueError(
            f"request {rid} holds {len(pages)} pages > max_pages="
            f"{max_pages}: block table would truncate the context")
    out = np.zeros((max_pages,), np.int32)
    out[: len(pages)] = pages
    return out
