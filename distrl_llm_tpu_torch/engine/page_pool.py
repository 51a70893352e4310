"""Host-side KV page allocator for the refill scheduler's page budget,
with prefix sharing, the radix prefix cache and the host page store.

Counterpart of the JAX package's ``engine/page_pool.py`` (plain Python and
numpy; the port keeps its own copy). vLLM sizes its KV block pool from
``gpu_memory_utilization`` and admits and preempts sequences against that
budget. The page pools are allocated once at the budgeted size; which pages
a slot owns is data, so this class tracks ownership and builds the
``[R, width]`` page-table rows on the host. The device sees only the table.

Layout contract (shared with ``engine/paged_engine.py``):

* shared prompt pages occupy ids ``[0, b · prompt_pages)``, written once by
  the prefill. Unshared, they are a static region the pool never tracks;
  with ``prefix_sharing`` they are registered as refcounted prefix chains
  (below) and return to the free list when their group finishes;
* pool pages occupy ``[first_page, first_page + n_pages)``; page
  ``first_page`` is the SCRATCH page: every dead slot's table row points
  all its columns at it, so dead slots' writes land where no live row
  reads;
* a slot's row is: its prompt's full pages below ``full`` columns, then its
  owned pages (the copy of the partial prompt page first), trailing columns
  clamped to the last owned page (beyond every read window).

Prefix sharing (vLLM's copy-on-write prefix caching): a prompt's page chain
is registered once per group (``register_prefix``, ``alloc_prefix``) with a
refcount hold; every admitted candidate aliases the chain's full pages
(refcount + 1 each), and the partial tail page, which decode extends in
place, is attached copy-on-write: the first write into it (``note_write``,
or the ``first_write`` hint ``admit`` takes) splits it into a freshly
granted private page, the device copy queued for the caller
(``take_copy``). ``release`` only decrements; a page returns to the free
list when its refcount reaches zero, so a group's prompt KV is resident
about once instead of once per candidate.

The tiered cache: ``RadixCache`` indexes finished chains' full pages by
their exact token ids (SGLang's RadixAttention), so a later admission with
the same prefix aliases them and prefills only its suffix; unpinned nodes
are evicted least recently used under page pressure. ``HostPageStore``
parks evicted and preempted pages in pinned host memory (the JAX package
converts them on a background thread; here the copy is enqueued on the
device's stream behind an event, see the class). The JAX package's pool
gauges and counters feed its telemetry registry, which the port has not
(ROADMAP queue 1 item 11); the same figures are the pool's attributes and
the engine's ``last_pool_stats``.
"""

from __future__ import annotations

import numpy as np
import torch


def _tensors(x):
    """Every tensor of a payload (nested dicts, lists and tuples)."""
    if isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)
    elif isinstance(x, torch.Tensor):
        yield x


def _payload_map(fn, x):
    """``fn`` over every tensor of a payload, structure kept."""
    if isinstance(x, dict):
        return {k: _payload_map(fn, v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_payload_map(fn, v) for v in x)
    return fn(x) if isinstance(x, torch.Tensor) else x


def _to_host(t: torch.Tensor) -> torch.Tensor:
    """A copy of ``t`` in host memory: from the device, an asynchronous
    copy into pinned memory enqueued on the current stream; on the CPU, a
    clone."""
    if t.device.type != "cuda":
        return t.clone()
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    return host


class HostPageStore:
    """Host-memory KV page store (tier 2): parked pages live here between
    their eviction or preemption and their restore. ``put`` takes a payload
    of tensors the caller gathered on the device (independent buffers,
    never views into the pools), enqueues their copy into pinned host
    memory on the current stream and records an event: the copy is ordered
    after the gather and before any later write to those pages by the
    stream, so a page granted to another slot right after cannot change
    what was parked. ``get`` waits on the event, and only then. A byte cap
    drops the least recently used payloads; a resume that finds its
    payload gone recomputes (the JAX package's semantics)."""

    def __init__(self, max_bytes: int = 0):
        # insertion order doubles as LRU order (refreshed on get)
        self._data: dict = {}
        self._nbytes: dict = {}
        self._events: dict = {}
        self.max_bytes = int(max_bytes)
        self.used_bytes = 0
        self.dropped_payloads = 0  # byte-cap LRU evictions

    def put(self, key, payload) -> None:
        """Park ``payload`` under ``key``; nothing here waits for the copy."""
        self.drop(key)
        self._data[key] = _payload_map(_to_host, payload)
        event = None
        if any(t.device.type == "cuda" for t in _tensors(payload)):
            event = torch.cuda.Event()
            event.record()
        self._events[key] = event
        n = sum(t.numel() * t.element_size() for t in _tensors(self._data[key]))
        self._nbytes[key] = n
        self.used_bytes += n
        if self.max_bytes:
            while self.used_bytes > self.max_bytes and self._data:
                self.drop(next(iter(self._data)))
                self.dropped_payloads += 1

    def get(self, key):
        """The parked payload once its copy has finished, or None when the
        key was never stored or has been dropped."""
        payload = self._data.get(key)
        if payload is None:
            return None
        event = self._events.get(key)
        if event is not None:
            event.synchronize()
            self._events[key] = None
        self._data[key] = self._data.pop(key)  # LRU refresh
        return payload

    def contains(self, key) -> bool:
        return key in self._data

    def drop(self, key) -> None:
        if key in self._data:
            del self._data[key]
            del self._events[key]
            self.used_bytes -= self._nbytes.pop(key)


class _RadixNode:
    """One full KV page of a cached prefix: ``key`` is the page's exact
    ``page_size`` token ids, ``page`` its round-scoped device page id when
    resident (None when spilled), ``store_key`` its host-store payload key
    when one exists. Content is immutable — a full prefix page is never
    written again — so residency and spill state are the only mutables."""

    __slots__ = ("key", "parent", "children", "page", "store_key",
                 "last_use", "nid")

    def __init__(self, key, parent, nid):
        self.key = key
        self.parent = parent
        self.children: dict = {}
        self.page: int | None = None
        self.store_key = None
        self.last_use = 0
        self.nid = nid


class RadixCache:
    """Cross-request radix prefix index (tier 1, SGLang RadixAttention
    style): a tree keyed on exact token ids at full-page granularity. The
    cache object is ENGINE-owned and outlives the per-round ``PagePool`` —
    device page ids on nodes are round-scoped, so the engine flushes
    residency to the host store at round end and the tree persists across
    rounds as a host-resident index. All tree transitions run through the
    pool (it owns the free list and refcounts)."""

    def __init__(self, page_size: int):
        self.page_size = page_size
        self.root = _RadixNode(None, None, -1)
        self._resident: dict[int, _RadixNode] = {}  # nid -> node
        self._tick = 0
        self._next_nid = 0
        # cumulative counters (engine snapshots per-round deltas for bench)
        self.lookup_tok = 0
        self.hit_tok = 0
        self.prefill_tok_saved = 0
        self.evictions = 0
        self.spilled_pages = 0
        self.restored_pages = 0

    def touch(self, node: _RadixNode) -> None:
        self._tick += 1
        node.last_use = self._tick

    def new_node(self, key, parent) -> _RadixNode:
        node = _RadixNode(key, parent, self._next_nid)
        self._next_nid += 1
        parent.children[key] = node
        return node

    @property
    def resident_pages(self) -> int:
        return len(self._resident)

    def node_count(self) -> int:
        n, stack = 0, list(self.root.children.values())
        while stack:
            cur = stack.pop()
            n += 1
            stack.extend(cur.children.values())
        return n

    def reset_residency(self) -> None:
        """Forget device residency WITHOUT spilling (defensive: a prior
        round aborted before its flush — page ids are stale, and nodes
        with no stored payload will be pruned at their next match)."""
        for node in self._resident.values():
            node.page = None
        self._resident.clear()

    def snapshot(self) -> dict[str, int]:
        """Cumulative counters — callers diff two snapshots for per-round
        figures."""
        return {
            "lookup_tok": self.lookup_tok,
            "hit_tok": self.hit_tok,
            "prefill_tok_saved": self.prefill_tok_saved,
            "evictions": self.evictions,
            "spilled_pages": self.spilled_pages,
            "restored_pages": self.restored_pages,
        }


class PagePool:
    """Free-list page allocator that writes the page table (host, numpy)."""

    def __init__(
        self,
        *,
        first_page: int,  # == b·prompt_pages (pool starts after shared region)
        n_pages: int,  # pool size INCLUDING the scratch page
        r_slots: int,
        width: int,  # table columns (prompt_pages + private_pages)
        page_size: int,
        prompt_pages: int,
        prefix_sharing: bool = False,  # refcounted CoW prefix chains
        radix: RadixCache | None = None,  # tier-1 cross-request index
        store: HostPageStore | None = None,  # tier-2 host-RAM spill
    ):
        if n_pages < 2:
            raise ValueError(f"pool needs >= 2 pages (scratch + 1), got {n_pages}")
        if radix is not None and not prefix_sharing:
            raise ValueError("prefix_cache rides the prefix-sharing chain "
                             "machinery; pass prefix_sharing=True")
        self.scratch = first_page
        self.page_size = page_size
        self.prompt_pages = prompt_pages
        self.n_pages = n_pages
        self.prefix_sharing = prefix_sharing
        # LIFO free list: recently-released pages are re-granted first (their
        # tiles are warm in whatever cache level still holds them)
        self.free: list[int] = list(
            range(first_page + n_pages - 1, first_page, -1)
        )
        self.owned: list[list[int]] = [[] for _ in range(r_slots)]
        self.full = np.zeros(r_slots, np.int32)  # shared full pages per slot
        self.table = np.full((r_slots, width), self.scratch, np.int32)
        self.peak_pages_used = 0
        self.preemptions = 0
        # ---- prefix-sharing state (all empty / inert when sharing is off)
        # per-page refcount for SHARED pages only (chain holds + slot
        # aliases); privately owned pages are implicitly refcount 1
        self.ref: dict[int, int] = {}
        # prompt -> (chain page ids, full-page count). len(chain) > full
        # means the last entry is the pristine partial TAIL page.
        self.chains: dict[int, tuple[list[int], int]] = {}
        # per-slot aliased full-prefix pages (leading table columns)
        self.shared: list[list[int]] = [[] for _ in range(r_slots)]
        # per-slot tail page still attached copy-on-write (pre-split)
        self.tail_shared: list[int | None] = [None] * r_slots
        # per-slot queued (src -> owned[slot][0]) CoW copy from the last
        # admit/split; the engine drains it into the admit dispatch
        self.copy_src: list[int | None] = [None] * r_slots
        # pages outside [first_page, first_page + n_pages) the pool has
        # adopted (a static prompt region registered/reclaimed into it)
        self.adopted: set[int] = set()
        # stats the engine reports
        self.cow_splits = 0
        self.peak_shared_pages = 0
        self.prefix_admissions = 0
        self.total_admissions = 0
        # ---- tiered KV cache (both None when the cache is off).
        # The radix tree and host store are ENGINE-owned and outlive this
        # per-round pool; node device-page ids are round-scoped, so a tree
        # arriving with stale residency (a prior round aborted before its
        # flush) is defensively reset.
        self.radix = radix
        self.store = store
        # engine-installed closure: page id -> gathered device payload
        # (independent buffers, never views into the pools)
        self.spill_fn = None
        if radix is not None and radix._resident:
            radix.reset_residency()

    # -- accounting --------------------------------------------------------

    @property
    def universe_pages(self) -> int:
        """Allocatable physical pages (scratch excluded, adoptions included)."""
        return self.n_pages - 1 + len(self.adopted)

    @property
    def free_pages(self) -> int:
        return len(self.free)

    @property
    def used_pages(self) -> int:
        """Physical pages in use, each counted ONCE however many owners
        reference it (refcount-aware: equals the per-slot sum on unshared
        pools, where ownership is disjoint by construction)."""
        return self.universe_pages - len(self.free)

    @property
    def shared_pages(self) -> int:
        """Distinct pages currently referenced by >= 2 owners (a chain hold
        counts as an owner — a held chain page aliased by one slot is
        physically one page serving two futures)."""
        return sum(1 for c in self.ref.values() if c >= 2)

    @property
    def occupancy(self) -> float:
        """Fraction of allocatable pages (scratch excluded) currently owned."""
        return self.used_pages / max(self.universe_pages, 1)

    def _note_peaks(self) -> None:
        self.peak_pages_used = max(self.peak_pages_used, self.used_pages)
        if self.prefix_sharing:
            self.peak_shared_pages = max(
                self.peak_shared_pages, self.shared_pages
            )

    def check_invariants(self) -> None:
        """free + private owned + shared/held must tile the pool exactly —
        each physical page tracked exactly once — and every refcount must
        equal its recomputed owner count (test hook; O(pool) but pools are
        small on the host)."""
        expected = sorted(
            set(range(self.scratch + 1, self.scratch + self.n_pages))
            | self.adopted
        )
        private = [p for o in self.owned for p in o]
        tracked = sorted(self.free + private + list(self.ref))
        assert tracked == expected, (
            f"pool accounting broken: {len(tracked)} tracked vs "
            f"{len(expected)} expected (free={len(self.free)}, "
            f"private={len(private)}, shared={len(self.ref)})"
        )
        # refcount conservation: recompute every shared page's owner count
        # from the chains + per-slot alias lists and compare
        recount: dict[int, int] = {}
        for pages, _full in self.chains.values():
            for p in pages:
                recount[p] = recount.get(p, 0) + 1
        for slot_pages in self.shared:
            for p in slot_pages:
                recount[p] = recount.get(p, 0) + 1
        for p in self.tail_shared:
            if p is not None:
                recount[p] = recount.get(p, 0) + 1
        # tiered cache: every RESIDENT radix node holds exactly
        # one cache reference on its page, and the tree's resident page set
        # must be disjoint from the free list (a cached page granted to a
        # slot would serve two owners' writes)
        if self.radix is not None:
            res_pages: list[int] = []
            for node in self.radix._resident.values():
                assert node.page is not None, (
                    f"non-resident node {node.nid} in the resident index"
                )
                recount[node.page] = recount.get(node.page, 0) + 1
                res_pages.append(node.page)
            assert len(res_pages) == len(set(res_pages)), (
                f"radix page double-tracked: {sorted(res_pages)}"
            )
            overlap = set(res_pages) & set(self.free)
            assert not overlap, (
                f"radix-resident pages on the free list: {sorted(overlap)}"
            )
        assert recount == self.ref, (
            f"refcount drift: recomputed {recount} vs tracked {self.ref}"
        )
        assert all(c >= 1 for c in self.ref.values()), (
            f"zero-ref residue in shared table: {self.ref}"
        )

    # -- sizing helpers ----------------------------------------------------

    def pages_to_cover(self, slot: int, last_position: int) -> int:
        """Owned pages required for the slot's writes through
        ``last_position`` (positions below full·ps live in shared pages)."""
        return max(last_position // self.page_size - int(self.full[slot]) + 1, 1)

    # -- prefix chains (prefix_sharing only) -------------------------------

    def register_prefix(self, prompt_idx: int, pages: list[int],
                        full_count: int) -> None:
        """Adopt ``pages`` as prompt ``prompt_idx``'s prefix chain with a
        refcount HOLD: ``full_count`` leading full pages (never written
        again) plus, when ``len(pages) > full_count``, the pristine partial
        tail page. Pages outside the pool range (a static prefill region)
        are adopted into the pool's universe — they return to the free list
        when the chain drops and every alias releases."""
        assert self.prefix_sharing, "register_prefix needs prefix_sharing"
        assert prompt_idx not in self.chains, f"prompt {prompt_idx} re-registered"
        assert len(pages) in (full_count, full_count + 1), (
            f"chain length {len(pages)} vs full_count {full_count}"
        )
        for p in pages:
            if not (self.scratch < p < self.scratch + self.n_pages):
                self.adopted.add(p)
            self.ref[p] = self.ref.get(p, 0) + 1
        self.chains[prompt_idx] = (list(pages), full_count)
        self._note_peaks()

    def alloc_prefix(self, prompt_idx: int, n_chain: int,
                     full_count: int) -> list[int] | None:
        """Allocate a prompt's prefix chain FROM the pool (continuous
        admission: prefill writes into pool pages) and register it. None —
        and no state change — when the free list can't cover it."""
        assert self.prefix_sharing, "alloc_prefix needs prefix_sharing"
        self._reserve(n_chain)
        if n_chain > len(self.free):
            return None
        pages = [self.free.pop() for _ in range(n_chain)]
        self.register_prefix(prompt_idx, pages, full_count)
        return pages

    def reclaim(self, pages: list[int]) -> None:
        """Feed unused static-region pages (a dead prompt's region, the
        slack beyond a short prompt's real chain) into the free list as
        decode capacity."""
        assert self.prefix_sharing, "reclaim needs prefix_sharing"
        for p in pages:
            assert p not in self.ref and p not in self.free, f"page {p} live"
            if not (self.scratch < p < self.scratch + self.n_pages):
                self.adopted.add(p)
            self.free.append(p)

    def drop_prefix(self, prompt_idx: int) -> None:
        """Release the group hold: every chain page loses one reference and
        frees when (and only when) no admitted slot still aliases it."""
        pages, _full = self.chains.pop(prompt_idx)
        for p in pages:
            self._deref(p)

    def _deref(self, page: int) -> None:
        c = self.ref[page] - 1
        if c:
            self.ref[page] = c
        else:
            del self.ref[page]
            self.free.append(page)

    # -- tiered KV cache (radix is None when the cache is off) ---

    def radix_match(self, tokens) -> tuple[list[_RadixNode], int]:
        """Longest cached prefix of ``tokens`` at full-page granularity,
        capped so at least ONE suffix token stays un-cached — its forward
        pass produces the sampling logits the admit needs, and because the
        hit therefore never covers position real_len-1, no suffix prefill
        write ever lands in a cached page. Returns the matched node path
        (contiguous from the root) and the hit length in tokens. Nodes that
        are neither resident nor restorable (payload aged out of the host
        store) are pruned on sight."""
        r = self.radix
        assert r is not None, "radix_match needs a prefix cache"
        ps = self.page_size
        toks = [int(t) for t in tokens]
        max_full = (len(toks) - 1) // ps
        r.lookup_tok += len(toks)
        nodes: list[_RadixNode] = []
        cur = r.root
        for i in range(max_full):
            key = tuple(toks[i * ps:(i + 1) * ps])
            child = cur.children.get(key)
            if child is None:
                break
            if child.page is None and (
                child.store_key is None
                or self.store is None
                or not self.store.contains(child.store_key)
            ):
                self._prune(child)
                break
            nodes.append(child)
            cur = child
        hit = len(nodes) * ps
        r.hit_tok += hit
        for node in nodes:
            r.touch(node)
        return nodes, hit

    def restore_nodes(
        self, nodes: list[_RadixNode],
    ) -> tuple[list[_RadixNode], list[tuple[_RadixNode, int, object]]]:
        """Ensure device residency for a matched node path. Returns
        ``(resident, uploads)``: the contiguous resident prefix of the path
        (truncated at the first node that cannot be restored — payload aged
        out, or the pool cannot free a page for it) and the ``(node, page,
        payload)`` uploads the ENGINE must scatter into the device pools
        before any slot reads through the chain. The whole matched path is
        protected from being evicted to make room for its own restores."""
        protect = {node.nid for node in nodes}
        resident: list[_RadixNode] = []
        uploads: list[tuple[_RadixNode, int, object]] = []
        for node in nodes:
            if node.page is not None:
                resident.append(node)
                continue
            payload = (
                self.store.get(node.store_key)
                if self.store is not None and node.store_key is not None
                else None
            )
            if payload is None:
                break
            self._reserve(1, protect=protect)
            if not self.free:
                break
            page = self.free.pop()
            node.page = page
            self.ref[page] = self.ref.get(page, 0) + 1  # cache hold
            self.radix._resident[node.nid] = node
            self.radix.restored_pages += 1
            uploads.append((node, page, payload))
            resident.append(node)
        if uploads:
            self._note_peaks()
        return resident, uploads

    def note_restored(self, n_pages: int) -> None:
        """Counter twin of ``note_spilled`` for pages reloaded from the
        host store OUTSIDE the radix path (tier-2 preempt resumes —
        ``restore_nodes`` counts its own uploads itself)."""
        if n_pages:
            self.radix.restored_pages += n_pages

    def note_spilled(self, n_pages: int) -> None:
        """Single emission site for the spilled-pages counter (tier-2
        preempt spills ride through here; tier-1 evictions call it from
        ``_evict``/``flush_cache``)."""
        if n_pages:
            self.radix.spilled_pages += n_pages

    def admit_cached(
        self, prompt_idx: int, nodes: list[_RadixNode], n_chain: int,
        full_count: int,
    ) -> list[int] | None:
        """Register prompt ``prompt_idx``'s chain with its leading pages
        ALIASED from resident radix nodes — those pages' prefill is skipped
        entirely — and the un-cached remainder freshly granted. None (and
        no state change) when the free list can't cover the remainder.
        Chain registration adds a chain hold on every page, so cached pages
        are pinned (cache hold + chain hold) for the group's lifetime."""
        assert len(nodes) <= full_count, "cache hit overran the full prefix"
        fresh_need = n_chain - len(nodes)
        self._reserve(fresh_need, protect={node.nid for node in nodes})
        if fresh_need > len(self.free):
            return None
        fresh = [self.free.pop() for _ in range(fresh_need)]
        pages = [node.page for node in nodes] + fresh
        self.register_prefix(prompt_idx, pages, full_count)
        saved = len(nodes) * self.page_size
        if saved:
            self.radix.prefill_tok_saved += saved
        return pages

    def cache_chain(self, prompt_idx: int, tokens) -> None:
        """Retire prompt ``prompt_idx``'s finished chain INTO the radix
        tree instead of dropping it: each full page's chain hold transfers
        to a cache hold on its radix node (no refcount churn on fresh
        nodes). A page duplicating an already-resident node derefs — the
        tree keeps one physical copy per distinct prefix — and a spilled
        node re-materialized by a fresh chain adopts the fresh page (page
        content is deterministic in (tokens, adapter), so any stored
        payload stays valid). The mutable partial tail page always derefs:
        only immutable full pages are cacheable."""
        r = self.radix
        assert r is not None, "cache_chain needs a prefix cache"
        ps = self.page_size
        toks = [int(t) for t in tokens]
        pages, full = self.chains.pop(prompt_idx)
        assert full * ps <= len(toks), (
            f"chain covers {full} full pages but only {len(toks)} tokens "
            f"were provided"
        )
        cur = r.root
        for i in range(full):
            page = pages[i]
            key = tuple(toks[i * ps:(i + 1) * ps])
            child = cur.children.get(key)
            if child is None:
                child = r.new_node(key, cur)
                child.page = page  # chain hold becomes the cache hold
                r._resident[child.nid] = child
            elif child.page is None:
                child.page = page
                r._resident[child.nid] = child
            else:
                self._deref(page)  # duplicate of a resident node
            r.touch(child)
            cur = child
        if len(pages) > full:
            self._deref(pages[full])

    def _reserve(self, need: int, protect: set | frozenset = frozenset()) -> None:
        """Best-effort pressure valve: evict LRU UNPINNED radix nodes until
        ``need`` pages are free (a node is unpinned when the cache hold is
        its page's only reference). Runs before every allocation path so
        the warm cache can never starve admission; a no-op when the cache
        is off. Eviction spills the page payload to the host store first
        (unless the store already holds it), so evicted prefixes stay
        restorable."""
        r = self.radix
        if r is None:
            return
        while len(self.free) < need:
            victim = None
            for node in r._resident.values():
                if node.nid in protect or self.ref.get(node.page, 0) != 1:
                    continue
                if victim is None or node.last_use < victim.last_use:
                    victim = node
            if victim is None:
                break  # nothing evictable: callers decline on capacity
            self._evict(victim)

    def _evict(self, node: _RadixNode) -> None:
        r = self.radix
        if node.store_key is None or self.store is None or (
            not self.store.contains(node.store_key)
        ):
            if self.spill_fn is None or self.store is None:
                # no spill path: forget the subtree rather than leak it
                self._prune(node)
                return
            if node.store_key is None:
                node.store_key = ("radix", node.nid)
            self.store.put(node.store_key, self.spill_fn(node.page))
            self.note_spilled(1)
        page = node.page
        node.page = None
        del r._resident[node.nid]
        self._deref(page)
        r.evictions += 1

    def _prune(self, node: _RadixNode) -> None:
        """Unlink ``node`` (and its whole subtree) from the tree, releasing
        any resident pages and dropping any stored payloads."""
        r = self.radix
        if node.parent is not None:
            node.parent.children.pop(node.key, None)
            node.parent = None
        stack = [node]
        while stack:
            cur = stack.pop()
            if cur.page is not None:
                self._deref(cur.page)
                cur.page = None
                r._resident.pop(cur.nid, None)
                r.evictions += 1
            if cur.store_key is not None and self.store is not None:
                self.store.drop(cur.store_key)
                cur.store_key = None
            stack.extend(cur.children.values())
            cur.children.clear()

    def flush_cache(self) -> None:
        """Round-end flush: every resident node's payload moves to the host
        store and its device page frees — the tree survives the round as a
        host-resident index (device page ids are round-scoped and die with
        this pool). Spills here count as spilled pages, NOT evictions (the
        node wasn't pushed out by pressure). Nodes with no spill path are
        pruned."""
        r = self.radix
        if r is None:
            return
        for node in list(r._resident.values()):
            if node.nid not in r._resident:
                continue  # pruned as part of an earlier node's subtree
            if self.spill_fn is None or self.store is None:
                self._prune(node)
                continue
            if node.store_key is None or not self.store.contains(
                node.store_key
            ):
                if node.store_key is None:
                    node.store_key = ("radix", node.nid)
                self.store.put(node.store_key, self.spill_fn(node.page))
                self.note_spilled(1)
            page = node.page
            node.page = None
            del r._resident[node.nid]
            self._deref(page)

    def invalidate_cache(self) -> None:
        """Drop the WHOLE cache — every node, resident or spilled. The
        engine calls this when the adapter identity changes (cached KV is
        only exact under the adapter that wrote it); chains still aliased
        by running groups keep their chain holds and free normally when
        the groups finish."""
        r = self.radix
        if r is None:
            return
        for child in list(r.root.children.values()):
            self._prune(child)

    # -- transitions -------------------------------------------------------

    def admit(
        self, slot: int, prompt_idx: int, real_len: int, last_position: int,
        donor: int | None = None, first_write: int | None = None,
    ) -> bool:
        """Claim pages for an admission covering writes through
        ``last_position``; build the slot's table row. False (and no state
        change) when the free list can't cover it.

        With a registered prefix chain (or a ``donor`` slot of the same
        prompt), the chain's full pages are ALIASED (refcount++) instead of
        granted, and the partial tail page is attached copy-on-write: when
        ``first_write`` (the scheduler's imminent first decode write —
        always ``real_len`` in the engine) lands inside it, the split runs
        as part of admission (``copy_src[slot]`` carries the device copy
        source for the caller's admit dispatch); otherwise the tail stays
        shared until ``note_write`` — except a tail sourced from a donor's
        PRIVATE page (its chain already dropped), which always splits
        immediately: that page is mutable and owned-tracked, never
        refcount-attachable. ``donor`` aliases that slot's prefix
        columns — by construction the same physical pages as the chain's —
        and exists so a group sibling can donate even in pools driven
        without a chain ledger (property tests)."""
        assert not self.owned[slot], f"slot {slot} admitted while owning pages"
        assert not self.shared[slot] and self.tail_shared[slot] is None
        full = real_len // self.page_size
        self.full[slot] = full
        need = self.pages_to_cover(slot, last_position)
        self._reserve(need)
        self.copy_src[slot] = None

        prefix: list[int] | None = None
        tail_page: int | None = None
        # a tail sourced from a donor's PRIVATE page is copy-only: it is
        # mutable (the donor's decode extends it) and already tracked as
        # owned, so attaching it refcount-shared would double-track one
        # physical page as both private and shared
        tail_is_private = False
        if self.prefix_sharing:
            chain = self.chains.get(prompt_idx)
            if chain is not None:
                pages, full_count = chain
                assert full_count == full, (
                    f"chain full_count {full_count} vs real_len-derived {full}"
                )
                prefix = pages[:full]
                tail_page = pages[full] if len(pages) > full else None
            elif donor is not None:
                # donor-slot aliasing without a ledger: the donor's prefix
                # columns ARE the prompt's chain; its first private page
                # holds a pristine copy of the prompt tail (the donor only
                # ever wrote positions >= real_len, beyond every read
                # window a fresh candidate can reach before overwriting)
                assert int(self.full[donor]) == full, (
                    f"donor slot {donor} full {int(self.full[donor])} vs {full}"
                )
                prefix = list(self.shared[donor])
                if self.tail_shared[donor] is not None:
                    tail_page = self.tail_shared[donor]
                elif real_len % self.page_size:
                    tail_page = self.owned[donor][0]
                    tail_is_private = True
        if prefix is None:
            # unshared: the historical path, bit-for-bit (the static prompt
            # region holds the prefix; the partial-page copy source is
            # derived device-side by _admit_tables)
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
            self._note_peaks()
            return True

        split_now = tail_page is not None and (
            # the scheduler's imminent first write lands in the tail block
            (first_write is not None
             and first_write // self.page_size == full)
            # …or the source is donor-private (copy-only — see above)
            or tail_is_private
        )
        # private demand: every covered block, minus the tail block while it
        # stays attached shared (a split consumes the page the tail block
        # would have, so the split case needs exactly the unshared count)
        priv_need = need - (1 if (tail_page is not None and not split_now) else 0)
        if priv_need > len(self.free):
            return False
        grant = [self.free.pop() for _ in range(priv_need)]
        self.owned[slot] = grant
        self.shared[slot] = list(prefix)
        for p in prefix:
            self.ref[p] = self.ref.get(p, 0) + 1
        row = self.table[slot]
        row[:] = self.scratch
        row[:full] = prefix
        if tail_page is not None and not split_now:
            self.ref[tail_page] = self.ref.get(tail_page, 0) + 1
            self.tail_shared[slot] = tail_page
            row[full] = tail_page
            row[full + 1:full + 1 + priv_need] = grant
            row[full + 1 + priv_need:] = grant[-1] if grant else tail_page
        else:
            if split_now:
                # copy-on-write: the first decode write lands in the
                # prompt's partial tail page — split it into the slot's
                # first private page, the device copy riding the caller's
                # admit dispatch (no refcount churn: alias + immediate
                # split nets out to a plain grant + copy)
                self.cow_splits += 1
                self.copy_src[slot] = tail_page
            row[full:full + priv_need] = grant
            row[full + priv_need:] = grant[-1] if grant else (
                prefix[-1] if prefix else self.scratch
            )
        self.total_admissions += 1
        self.prefix_admissions += 1
        self._note_peaks()
        return True

    def note_write(self, slot: int, position: int) -> tuple[int, int] | None:
        """Copy-on-write hook: a write at ``position`` is about to land in
        the slot's pages. Writes into privately owned pages are free; a
        write into the shared tail page SPLITS it — a fresh page is granted,
        the (src, dst) device copy is returned (and queued on
        ``copy_src[slot]``), and the shared page loses this slot's
        reference. Writes below the shared full-prefix region are a
        contract violation (full pages are immutable by construction).
        Returns None when no split was needed; raises when the free list
        cannot back a required split (callers gate admission on capacity)."""
        block = position // self.page_size
        full = int(self.full[slot])
        assert block >= full, (
            f"write at {position} lands in slot {slot}'s immutable shared "
            f"full-prefix region (block {block} < full {full})"
        )
        tail = self.tail_shared[slot]
        if tail is None or block != full:
            return None
        self._reserve(1)
        if not self.free:
            raise RuntimeError(
                f"CoW split for slot {slot} needs a free page and the pool "
                f"is dry — admission must reserve split capacity"
            )
        new = self.free.pop()
        self.cow_splits += 1
        self.copy_src[slot] = tail
        self.tail_shared[slot] = None
        self._deref(tail)
        self.owned[slot].insert(0, new)
        row = self.table[slot]
        row[full] = new
        # re-clamp trailing columns (they may have clamped onto the tail)
        used = full + len(self.owned[slot])
        row[used:] = self.owned[slot][-1]
        self._note_peaks()
        return (tail, new)

    def slot_alias_info(self, slot: int) -> dict[str, int | bool]:
        """Chain-alias facts for one slot's CURRENT admission, as the
        serving ledger records them: how many full prefix pages
        the slot aliases, whether its tail page is still attached
        copy-on-write, and whether a CoW copy is queued for the caller's
        admit dispatch. Read-only — a reporting view, not a transition.
        Read it BETWEEN ``admit`` and ``take_copy``: draining the copy
        source resets ``cow_queued``."""
        return {
            "shared_pages": len(self.shared[slot]),
            "tail_shared": self.tail_shared[slot] is not None,
            "cow_queued": self.copy_src[slot] is not None,
        }

    def take_copy(self, slot: int) -> int | None:
        """Drain the slot's queued CoW copy source (the caller fuses the
        src -> owned[slot][0] page copy into its admit dispatch)."""
        src = self.copy_src[slot]
        self.copy_src[slot] = None
        return src

    def ensure(self, slot: int, last_position: int) -> int:
        """Grow the slot's grant to cover writes through ``last_position``.
        Returns the number of pages still MISSING (0 = fully granted)."""
        owned = self.owned[slot]
        assert owned, f"ensure() on unowned slot {slot}"
        assert self.tail_shared[slot] is None, (
            f"ensure() on slot {slot} with an unsplit shared tail"
        )
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
            self._note_peaks()
        return max(missing - take, 0)

    def release(self, slot: int) -> None:
        """Return the slot's private pages to the free list and drop its
        shared references (a shared page frees only when its refcount hits
        zero — the CoW release discipline); redirect its table row to
        scratch (the slot's post-mortem garbage writes must not land in
        pages another slot may be granted)."""
        self.free.extend(reversed(self.owned[slot]))
        self.owned[slot] = []
        for p in self.shared[slot]:
            self._deref(p)
        self.shared[slot] = []
        if self.tail_shared[slot] is not None:
            self._deref(self.tail_shared[slot])
            self.tail_shared[slot] = None
        self.copy_src[slot] = None
        self.table[slot, :] = self.scratch
