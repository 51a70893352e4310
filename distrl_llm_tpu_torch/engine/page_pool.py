"""Host-side KV page allocator for the refill scheduler's page budget.

Counterpart of the JAX package's ``engine/page_pool.py::PagePool`` on its
unshared path (plain numpy; the port keeps its own copy). vLLM sizes its KV
block pool from ``gpu_memory_utilization`` and admits and preempts
sequences against that budget. The page pools are allocated once at the
budgeted size; which pages a slot owns is data, so this class tracks
ownership and builds the ``[R, width]`` page-table rows on the host. The
device sees only the table.

Layout contract (shared with ``engine/paged_engine.py``):

* shared prompt pages occupy ids ``[0, b · prompt_pages)``, written once by
  the prefill, a static region the pool never tracks;
* pool pages occupy ``[first_page, first_page + n_pages)``; page
  ``first_page`` is the SCRATCH page: every dead slot's table row points
  all its columns at it, so dead slots' writes land where no live row
  reads;
* a slot's row is: its prompt's full pages below ``full`` columns, then its
  owned pages (the copy of the partial prompt page first), trailing columns
  clamped to the last owned page (beyond every read window).

Not ported yet (ROADMAP queue 1 item 7): prefix sharing (refcounted
copy-on-write prompt chains), the radix prefix cache and the host page
store; their arguments raise ``NotImplementedError``.
"""

from __future__ import annotations

import numpy as np

_ITEM = ("ROADMAP queue 1 item 7: prefix sharing, radix cache and host spill "
         "on the refill scheduler")


class PagePool:
    """Free-list page allocator that writes the page table (host, numpy)."""

    def __init__(self, *, first_page: int, n_pages: int, r_slots: int,
                 width: int, page_size: int, prompt_pages: int,
                 prefix_sharing: bool = False, radix=None, store=None):
        if prefix_sharing or radix is not None or store is not None:
            raise NotImplementedError(f"only the unshared page pool is ported ({_ITEM})")
        if n_pages < 2:
            raise ValueError(f"pool needs >= 2 pages (scratch + 1), got {n_pages}")
        self.scratch = first_page
        self.page_size = page_size
        self.prompt_pages = prompt_pages
        self.n_pages = n_pages
        # LIFO free list: recently released pages are granted first
        self.free: list[int] = list(range(first_page + n_pages - 1, first_page, -1))
        self.owned: list[list[int]] = [[] for _ in range(r_slots)]
        self.full = np.zeros(r_slots, np.int32)  # shared full prompt pages per slot
        self.table = np.full((r_slots, width), self.scratch, np.int32)
        self.peak_pages_used = 0
        self.preemptions = 0
        self.total_admissions = 0

    @property
    def universe_pages(self) -> int:
        """Allocatable pages (scratch excluded)."""
        return self.n_pages - 1

    @property
    def free_pages(self) -> int:
        return len(self.free)

    @property
    def used_pages(self) -> int:
        return self.universe_pages - len(self.free)

    def check_invariants(self) -> None:
        """free + owned must tile the pool exactly, each page tracked once."""
        expected = list(range(self.scratch + 1, self.scratch + self.n_pages))
        tracked = sorted(self.free + [p for o in self.owned for p in o])
        assert tracked == expected, (
            f"pool accounting broken: {len(tracked)} tracked vs {len(expected)} "
            f"expected (free={len(self.free)})")

    def pages_to_cover(self, slot: int, last_position: int) -> int:
        """Owned pages required for the slot's writes through
        ``last_position`` (positions below full · ps live in shared pages)."""
        return max(last_position // self.page_size - int(self.full[slot]) + 1, 1)

    def _reserve(self, need: int) -> None:
        """The pressure valve that evicts radix-cache pages before an
        allocation; without the cache there is nothing to evict."""

    def admit(self, slot: int, prompt_idx: int, real_len: int, last_position: int,
              donor: int | None = None) -> bool:
        """Claim pages for an admission covering writes through
        ``last_position`` and build the slot's table row; False, with no
        state change, when the free list cannot cover it."""
        if donor is not None:
            raise NotImplementedError(f"donor aliasing is prefix sharing ({_ITEM})")
        assert not self.owned[slot], f"slot {slot} admitted while owning pages"
        full = real_len // self.page_size
        self.full[slot] = full
        need = self.pages_to_cover(slot, last_position)
        self._reserve(need)
        if need > len(self.free):
            return False
        grant = [self.free.pop() for _ in range(need)]
        self.owned[slot] = grant
        row = self.table[slot]
        row[:] = self.scratch
        row[:full] = prompt_idx * self.prompt_pages + np.arange(full)
        row[full:full + need] = grant
        row[full + need:] = grant[-1]
        self.total_admissions += 1
        self.peak_pages_used = max(self.peak_pages_used, self.used_pages)
        return True

    def ensure(self, slot: int, last_position: int) -> int:
        """Grow the slot's grant to cover writes through ``last_position``.
        Returns the number of pages still MISSING (0 = fully granted)."""
        owned = self.owned[slot]
        assert owned, f"ensure() on unowned slot {slot}"
        need = self.pages_to_cover(slot, last_position)
        missing = need - len(owned)
        self._reserve(max(missing, 0))
        take = min(max(missing, 0), len(self.free))
        if take:
            full = int(self.full[slot])
            grant = [self.free.pop() for _ in range(take)]
            row = self.table[slot]
            row[full + len(owned):full + len(owned) + take] = grant
            owned.extend(grant)
            row[full + len(owned):] = owned[-1]
            self.peak_pages_used = max(self.peak_pages_used, self.used_pages)
        return max(missing - take, 0)

    def release(self, slot: int) -> None:
        """Return the slot's pages to the free list and point its table row
        at scratch (its later garbage writes must not land in pages another
        slot may be granted)."""
        self.free.extend(reversed(self.owned[slot]))
        self.owned[slot] = []
        self.table[slot, :] = self.scratch
