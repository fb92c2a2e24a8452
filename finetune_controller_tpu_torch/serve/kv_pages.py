"""Block-granular KV page pool for the serve engine (docs/serving.md §Paged KV).

A copy of the reference's ``serve/kv_pages.py``, which is free of JAX; the
port keeps its own copy so that it imports nothing of the reference package.
The one change: :class:`HostPagePool` stores its pages in pinned torch
buffers, and a write returns only once the device-to-host copy is complete.

An unpaged engine reserves a full ``cache_len`` KV lane per decode slot at
admit time, so HBM — not compute — caps concurrency: a 12-token request holds
the same bytes as a 640-token one.  This module is the vLLM-style answer
(PAPERS.md): the device KV cache becomes a pool of fixed-size pages
(``page_tokens`` sequence positions each, all layers of one page id move
together) and every lane holds only the pages its tokens actually occupy,
growing page-by-page as it decodes.

This class is the HOST-side allocator and accountant; the device tensors
live in the engine's ``PagedKV`` pools (``models/llama.py`` paged path) and
are addressed through per-lane page tables the engine passes into every
forward call.  Single-threaded by contract — the batcher's drive loop already
serializes every engine call that touches it.

Page id 0 is the SCRATCH page: parked lanes and unmaterialized page-table
slots point at it, so their throwaway writes land somewhere harmlessly
in-bounds (reads of scratch positions are always masked to an exact-zero
softmax contribution).  It is never allocated.

Reference counting, because pages are shared copy-on-write:

* ``lane_refs`` — decode lanes holding the page (a prefix-cache splice refs
  the shared whole pages; a lane only ever WRITES pages it created itself,
  never shared ones — the page containing the reuse boundary is copied);
* ``cache_refs`` — prefix-cache entries holding the page (one count per
  entry; byte accounting charges a page once, on 0→1).

A page returns to the free list when both hit zero.

Admission control, so growth can never OOM mid-flight: ``reserve`` books the
worst case pages a request could still need (``ceil((prompt + max_new - 1) /
page_tokens)`` minus what it shares) before the lane is admitted, and
``alloc_reserved`` spends reservations one page at a time as the lane grows.
``slack`` counts free pages plus cache-only pages (evictable on demand) minus
outstanding reservations — the invariant ``slack >= 0`` means a reserved
page can always be materialized, evicting least-recently-used prefix-cache
entries if the free list is momentarily empty.
"""

from __future__ import annotations

import dataclasses

import torch


class PoolExhausted(RuntimeError):
    """Not enough free/evictable pages to admit this request NOW — transient
    backpressure (the batcher keeps it queued; a full queue becomes a 429
    with a derived ``Retry-After``), never an OOM mid-decode."""


@dataclasses.dataclass(frozen=True)
class PageRun:
    """A prefix-cache entry's pages, in logical order: page ``i`` holds
    sequence positions ``[i*page_tokens, (i+1)*page_tokens)`` of the prompt
    whose key the entry is stored under."""

    pages: tuple[int, ...]
    n_tokens: int


@dataclasses.dataclass(frozen=True)
class HostRun:
    """A demoted prefix-cache entry: the same logical page run as a
    :class:`PageRun`, but the KV bytes live in :class:`HostPagePool` slots
    instead of device pool pages.  Self-contained by construction — demotion
    snapshots EVERY page of the run (shared ones included), so restoring
    never depends on pages other entries or lanes still hold."""

    slots: tuple[int, ...]
    n_tokens: int


class HostPagePool:
    """Host-RAM page tier behind the device :class:`KVPagePool`
    (docs/serving.md §KV tiering).

    A flat pool of ``capacity = budget_bytes // page_bytes`` host page
    slots.  Storage is one torch buffer per K/V cache leaf, shaped
    ``(capacity,) + page_slice_shape`` and pinned when the pages come from
    a CUDA card, allocated by :meth:`allocate` (the engine calls it when it
    starts, so no demotion pays for a pinned allocation; the first write
    allocates otherwise).  Single-threaded by the same contract as the
    device pool — the engine's lock serializes every caller.

    The unit of transfer is one whole page id across every layer's K and V
    leaves — exactly the device pool's accounting unit, so device and host
    byte budgets (``serve_prefix_cache_mb`` vs ``serve_kv_host_pool_mb``)
    are directly comparable.
    """

    def __init__(self, budget_bytes: int, page_bytes: int):
        if page_bytes <= 0:
            raise ValueError("HostPagePool needs a positive page_bytes")
        self.page_bytes = int(page_bytes)
        self.capacity = max(0, int(budget_bytes) // self.page_bytes)
        # ascending hand-out order, like the device pool: deterministic slot
        # reuse keeps demote/restore tests reproducible
        self._free = list(range(self.capacity - 1, -1, -1))
        #: per-leaf host buffers, keyed by leaf ordinal in the engine's
        #: fixed K/V traversal order; created on first write
        self._buffers: list[torch.Tensor] | None = None
        # counters for /metrics + tests (units: PAGES moved, not calls)
        self.demotions_total = 0
        self.restores_total = 0

    # ---- accounting -------------------------------------------------------

    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def used_count(self) -> int:
        return self.capacity - len(self._free)

    def can_hold(self, n: int) -> bool:
        return n <= len(self._free)

    # ---- slot lifecycle ---------------------------------------------------

    def alloc(self, n: int) -> list[int]:
        """Take ``n`` host slots (caller checks :meth:`can_hold` first — a
        full host tier is a soft condition, the entry just stays on
        device)."""
        if n > len(self._free):
            raise PoolExhausted(
                f"host kv tier exhausted: need {n} slot(s), "
                f"free {len(self._free)} of {self.capacity}"
            )
        return [self._free.pop() for _ in range(n)]

    def free(self, slots) -> None:
        for slot in slots:
            assert 0 <= slot < self.capacity, f"bad host slot {slot}"
            self._free.append(slot)
        assert len(self._free) <= self.capacity, "host slot accounting broke"

    # ---- page bytes -------------------------------------------------------

    def allocate(self, pages: list[torch.Tensor]) -> None:
        """Create the per-leaf buffers for pages shaped like ``pages``
        (pinned when they lie on a CUDA card); a no-op once allocated."""
        if self._buffers is None:
            pin = pages[0].is_cuda
            self._buffers = [
                torch.empty((self.capacity,) + tuple(p.shape), dtype=p.dtype,
                            pin_memory=pin)
                for p in pages
            ]

    def write(self, slot: int, pages: list[torch.Tensor]) -> None:
        """Store one device page's per-leaf slices into host ``slot``.  The
        copies are queued on the device's current stream and waited for
        before this returns, so the slot counts as filled only once its
        bytes have landed."""
        self.allocate(pages)
        for buf, page in zip(self._buffers, pages):
            buf[slot].copy_(page, non_blocking=True)
        if pages[0].is_cuda:
            torch.cuda.current_stream(pages[0].device).synchronize()

    def read(self, slot: int) -> list[torch.Tensor]:
        """The per-leaf page slices stored in ``slot`` (same order as the
        :meth:`write` that filled it)."""
        assert self._buffers is not None, "read before any write"
        return [buf[slot] for buf in self._buffers]

    # ---- observability ----------------------------------------------------

    def stats(self) -> dict[str, int]:
        return {
            "tier_host_pages_total": self.capacity,
            "tier_host_pages_used": self.used_count,
            "tier_host_bytes": self.used_count * self.page_bytes,
            "demotions_total": self.demotions_total,
            "restores_total": self.restores_total,
        }


class KVPagePool:
    """Free-list allocator + refcounts over ``num_pages`` device pages.

    ``page_bytes`` is the physical size of one page id across every layer's
    K and V pool leaves — the unit the prefix cache's physical-byte LRU and
    the ``ftc_serve_kv_pages_*`` gauges account in.
    """

    SCRATCH = 0

    def __init__(self, num_pages: int, page_tokens: int, page_bytes: int = 0):
        if num_pages < 2:
            raise ValueError("KVPagePool needs >= 2 pages (page 0 is scratch)")
        if page_tokens < 1:
            raise ValueError("page_tokens must be >= 1")
        self.num_pages = int(num_pages)
        self.page_tokens = int(page_tokens)
        self.page_bytes = int(page_bytes)
        # pop() hands out ascending ids — deterministic allocation order is
        # what makes evict-refill reuse tests (and failures) reproducible
        self._free = list(range(self.num_pages - 1, 0, -1))
        self._lane_refs = [0] * self.num_pages
        self._cache_refs = [0] * self.num_pages
        #: pages held ONLY by prefix-cache entries — evictable on demand, so
        #: they count toward admission slack
        self._cache_only = 0
        #: reserved-but-unmaterialized pages across all admitted lanes
        self.reserved_outstanding = 0
        # counters for /metrics + tests
        self.allocs_total = 0
        self.cow_copies_total = 0
        self.exhaustions_total = 0

    # ---- accounting -------------------------------------------------------

    @property
    def usable_pages(self) -> int:
        return self.num_pages - 1

    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def used_count(self) -> int:
        return self.usable_pages - len(self._free)

    @property
    def shared_count(self) -> int:
        """Pages with more than one holder (lanes + cache entries) — the
        copy-on-write savings gauge."""
        return sum(
            1 for p in range(1, self.num_pages)
            if self._lane_refs[p] + self._cache_refs[p] >= 2
        )

    def slack(self) -> int:
        """Pages still promisable to a new admission: free + evictable
        cache-only, minus reservations already promised to admitted lanes."""
        return len(self._free) + self._cache_only - self.reserved_outstanding

    def pages_for(self, n_tokens: int) -> int:
        return -(-max(0, int(n_tokens)) // self.page_tokens)

    def can_reserve(self, n: int) -> bool:
        return n <= self.slack()

    # ---- lane side --------------------------------------------------------

    def reserve(self, n: int) -> None:
        """Book ``n`` pages for a lane being admitted (raises
        :class:`PoolExhausted` past the slack)."""
        if n > self.slack():
            self.exhaustions_total += 1
            raise PoolExhausted(
                f"kv page pool exhausted: need {n} page(s), "
                f"slack {self.slack()} (free {len(self._free)}, "
                f"evictable {self._cache_only}, "
                f"reserved {self.reserved_outstanding})"
            )
        self.reserved_outstanding += n

    def unreserve(self, n: int) -> None:
        self.reserved_outstanding -= n
        assert self.reserved_outstanding >= 0, "reservation accounting broke"

    def alloc_reserved(self, evict_one=None) -> int:
        """Materialize one previously reserved page.  When the free list is
        empty, ``evict_one()`` (the engine's hook into the prefix cache's
        LRU) is called until a cache-only page frees — guaranteed to
        terminate by the ``slack`` invariant."""
        while not self._free:
            if evict_one is None or not evict_one():
                raise RuntimeError(
                    "kv page pool invariant broken: a reserved page could "
                    "not be materialized (free list empty, nothing evictable)"
                )
        page = self._free.pop()
        self._lane_refs[page] = 1
        self.reserved_outstanding -= 1
        assert self.reserved_outstanding >= 0, "reservation accounting broke"
        self.allocs_total += 1
        return page

    def lane_ref(self, page: int) -> None:
        """A lane takes a read-only share of an existing page (prefix
        splice)."""
        assert page != self.SCRATCH
        if self._lane_refs[page] == 0 and self._cache_refs[page] > 0:
            self._cache_only -= 1
        self._lane_refs[page] += 1

    def lane_release(self, pages, unused_reserved: int = 0) -> None:
        """Lane finished/evicted: drop its refs and return its unspent
        reservation."""
        for page in pages:
            if page == self.SCRATCH:
                continue
            self._lane_refs[page] -= 1
            assert self._lane_refs[page] >= 0, f"lane ref underflow p{page}"
            if self._lane_refs[page] == 0:
                if self._cache_refs[page] > 0:
                    self._cache_only += 1
                else:
                    self._free.append(page)
        if unused_reserved:
            self.unreserve(unused_reserved)

    # ---- prefix-cache side ------------------------------------------------

    def cache_ref(self, pages) -> int:
        """A prefix-cache entry takes refs on ``pages``; returns how many
        became cache-referenced for the FIRST time — the entry's physical
        byte charge is that count times ``page_bytes`` (shared pages are
        charged once, on their first referencing entry)."""
        newly = 0
        for page in pages:
            assert page != self.SCRATCH
            self._cache_refs[page] += 1
            if self._cache_refs[page] == 1:
                newly += 1
                if self._lane_refs[page] == 0:
                    self._cache_only += 1
        return newly

    def cache_release(self, pages) -> int:
        """Inverse of :meth:`cache_ref`; returns how many pages dropped their
        LAST cache reference (the byte credit)."""
        freed = 0
        for page in pages:
            self._cache_refs[page] -= 1
            assert self._cache_refs[page] >= 0, f"cache ref underflow p{page}"
            if self._cache_refs[page] == 0:
                freed += 1
                if self._lane_refs[page] == 0:
                    self._cache_only -= 1
                    self._free.append(page)
        return freed

    # ---- observability ----------------------------------------------------

    def stats(self) -> dict[str, int]:
        return {
            "pages_total": self.usable_pages,
            "pages_free": self.free_count,
            "pages_used": self.used_count,
            "pages_shared": self.shared_count,
            "pages_reserved": self.reserved_outstanding,
            "page_tokens": self.page_tokens,
            "page_bytes": self.page_bytes,
            "page_allocs_total": self.allocs_total,
            "cow_copies_total": self.cow_copies_total,
            "pool_exhaustions_total": self.exhaustions_total,
        }
