"""The paged KV pool: slab storage + the canonical page allocator
(``repro.serving.cache``).

One pool serves every sequence; a sequence owns a *page table*, the list
of slab ids its view reads through.  Slab ``t`` is rows ``[t * page, (t +
1) * page)`` of the per-layer ``(L, pool_tokens, KV, hd)`` storage.

The free list is a min-heap: allocation hands out the LOWEST free slab, so
which slabs a sequence gets depends only on the pool's occupancy, never on
the order past sequences freed them.

Unlike the reference, whose arrays are immutable and threaded back through
``update``, the pool tensors here are updated IN PLACE: ``write_prefill``
copies a prompt's K/V into its slabs and every decode step writes its new
rows directly into ``pools["k"]`` / ``pools["v"]``.
"""
from __future__ import annotations

import heapq

import torch

from repro_torch.configs.common import ArchConfig
from repro_torch.models import transformer


class OutOfPages(RuntimeError):
    """The pool cannot satisfy an allocation — the engine's cue to evict."""


def pages_needed(tokens: int, page: int) -> int:
    """Pages covering ``tokens`` cache rows."""
    return -(-tokens // page)


class PagePool:
    """Slab storage for one model + the free-slab heap.

    ``pools`` holds the tensors (``{"k", "v"}``, each ``(L, pool_pages *
    page, KV, hd)``) on ``device``.  Allocation is pure bookkeeping over
    slab ids — no tensor traffic."""

    def __init__(self, cfg: ArchConfig, pool_pages: int, page: int,
                 dtype=torch.float32, device="cuda"):
        if pool_pages < 1 or page < 1:
            raise ValueError(f"need pool_pages >= 1 and page >= 1, got "
                             f"{pool_pages}/{page}")
        self.page = int(page)
        self.pool_pages = int(pool_pages)
        self.pools = transformer.init_paged_pools(
            cfg, self.pool_pages * self.page, dtype, device)
        self._free = list(range(self.pool_pages))

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def used_pages(self) -> int:
        return self.pool_pages - len(self._free)

    def alloc(self, n: int) -> list[int]:
        """Take the ``n`` lowest free slabs."""
        if n < 0:
            raise ValueError(f"cannot allocate {n} pages")
        if n > len(self._free):
            raise OutOfPages(
                f"need {n} page(s), {len(self._free)} free of "
                f"{self.pool_pages}")
        return [heapq.heappop(self._free) for _ in range(n)]

    def free(self, slabs) -> None:
        """Return slabs to the heap."""
        for s in slabs:
            if not 0 <= s < self.pool_pages:
                raise ValueError(f"slab {s} outside pool "
                                 f"[0, {self.pool_pages})")
            if s in self._free:
                raise ValueError(f"double free of slab {s}")
            heapq.heappush(self._free, s)

    def write_prefill(self, cache_kv, slabs: list[int], s0: int) -> None:
        """Copy a prefill cache (forward layout ``(L, 1, s0, KV, hd)`` per
        leaf) into the allocated slabs, in place: the one copy at the
        prefill -> paged-decode layout transition."""
        page = self.page
        k, v = self.pools["k"], self.pools["v"]
        for vpg, slab in enumerate(slabs):
            lo = vpg * page
            if lo >= s0:
                break
            hi = min(s0, lo + page)
            row = slab * page
            k[:, row:row + (hi - lo)] = cache_kv.k[:, 0, lo:hi].to(k.dtype)
            v[:, row:row + (hi - lo)] = cache_kv.v[:, 0, lo:hi].to(v.dtype)
