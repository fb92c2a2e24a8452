"""Radix-trie prefix cache over prompt token ids (docs/serving.md).

A copy of the reference's ``serve/prefix_cache.py``; its one JAX use, the
byte count of an unpaged snapshot, is a sum of ``tensor.nbytes`` here.  The
port's engine is paged, so its entries are page runs into the shared pool.

Production fine-tuned models are overwhelmingly served behind one shared
system prompt, yet a vanilla continuous-batching engine re-runs the full
prefill for every request.  This cache stores the B=1 KV snapshot a prefill
produces — full ``cache_len`` shape, exactly what ``BatchEngine._insert``
splices into a decode lane — keyed by the prompt's token ids in a
path-compressed radix trie, so ``admit()`` can resolve the longest cached
prefix of a new prompt and prefill only the suffix (``fill_from``).

Why a *trie* and not an exact-match dict: causality.  The KV at position
``i`` depends only on tokens ``[0, i]``, so a snapshot stored for prompt
``K`` is a bit-exact KV source for ANY prompt sharing a prefix with ``K`` —
restricted to the shared positions.  The useful lookup is therefore
"longest common prefix with any stored key", which a radix walk answers in
O(len(prompt)).  The classic case: one snapshot for ``[system; user_A]``
serves ``[system; user_B]``'s whole system prompt.

Budgeting: snapshots are device-resident (HBM alongside the serving
weights), so the cache holds a strict **byte budget** and evicts least
recently used entries past it.  Entries larger than the whole budget are
refused outright.  Eviction only drops references: in paged mode a lane
holds its own refs on the pages it spliced, so evicting an entry mid-flight
cannot free pages a request is still decoding from.

Thread-safety: none needed — the cache is owned by a ``BatchEngine``, whose
accesses the batcher's single drive loop already serializes (same contract
as the engine's ``_slots``).
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Any, Callable

from .kv_pages import HostRun


def resolve_reuse_length(
    match_len: int,
    prompt_len: int,
    buckets: tuple[int, ...],
    cache_len: int,
) -> int:
    """Bucket-granular reuse length for a raw trie match of ``match_len``.

    Two constraints shrink the raw match:

    * at least one real suffix token must remain — the engine needs a
      forward over ``[L, prompt_len)`` to produce last-position logits, so
      a full-prompt hit reuses ``prompt_len - 1`` tokens and prefills one;
    * the suffix is right-padded to a prompt bucket ``b``, and the padded
      chunk must fit the lane: ``L + b <= cache_len``.

    For each bucket the feasible reuse is the range
    ``[prompt_len - b, min(match_len, prompt_len - 1, cache_len - b)]``
    (lower bound: the suffix must fit the bucket; upper bound: the trie
    match, the one-real-token rule, and the lane end).  The answer is the
    largest feasible L over all buckets — when bucket rounding overshoots
    the lane, this reuses *less* so a bigger padded suffix still fits
    (any prefix of the match is a valid KV source).

    Returns 0 when no usable reuse remains (treat as a miss).
    """
    best = 0
    for bucket in buckets:
        candidate = min(match_len, prompt_len - 1, cache_len - bucket)
        if candidate >= max(1, prompt_len - bucket):
            best = max(best, candidate)
    return best


@dataclasses.dataclass
class _Entry:
    key: tuple[int, ...]
    cache: Any               # B=1 device KV pytree, a kv_pages.PageRun, or
    #                          a kv_pages.HostRun (demoted to the host tier)
    nbytes: int
    node: "_Node"
    #: adapter namespace (docs/serving.md §Multi-tenant adapters): KV depends
    #: on the weights that produced it, so a cache key is (base model,
    #: adapter id, token ids) — a hit under one tenant's adapter must never
    #: splice into another tenant's lane
    ns: str = ""
    #: residency: "device" (cache is a KV pytree or PageRun), "host" (cache
    #: is a HostRun), or "in-flight" (a restore is mid-transfer — the entry
    #: is pinned against demotion/eviction until the swap lands)
    tier: str = "device"


class _Node:
    """Radix-trie node; edges are (label, child) keyed by the label's first
    token.  ``n_entries`` counts stored snapshots in the subtree (self
    included) so lookups can steer toward a live entry without scanning."""

    __slots__ = ("edges", "entry", "parent", "n_entries")

    def __init__(self, parent: "_Node | None" = None):
        self.edges: dict[int, tuple[tuple[int, ...], "_Node"]] = {}
        self.entry: _Entry | None = None
        self.parent = parent
        self.n_entries = 0


def _lcp(a: tuple[int, ...], b: tuple[int, ...]) -> int:
    n = min(len(a), len(b))
    i = 0
    while i < n and a[i] == b[i]:
        i += 1
    return i


class PrefixCache:
    """LRU byte-budgeted radix trie of KV snapshots, one trie per adapter
    namespace.

    Two storage flavors share the structure:

    * **unpaged** (``pool=None``): entries are full-shape B=1 device KV
      pytrees, charged their logical ``nbytes``;
    * **paged** (``pool`` = the engine's :class:`~.kv_pages.KVPagePool`): entries are :class:`~.kv_pages.PageRun` references into the shared pool, charged
      PHYSICAL bytes — a page shared copy-on-write by several entries (or
      still held by the lane that wrote it) is charged once, on its first
      cache reference, and credited when its last cache reference drops.
    """

    def __init__(self, budget_bytes: int, *, pool: Any = None):
        if budget_bytes <= 0:
            raise ValueError("PrefixCache needs a positive byte budget "
                             "(disable the cache instead of zeroing it)")
        self.budget_bytes = int(budget_bytes)
        self._pool = pool
        self._roots: dict[str, _Node] = {}
        self._lru: OrderedDict[tuple, _Entry] = OrderedDict()
        self.total_bytes = 0
        self.evictions_total = 0
        # host tier (docs/serving.md §KV tiering) — wired by the paged
        # engine via enable_tier(); unpaged caches never tier
        self._host_pool: Any = None
        self._demote_fn: Callable | None = None
        self._restore_fn: Callable | None = None

    def enable_tier(self, host_pool: Any, demote_fn: Callable,
                    restore_fn: Callable) -> None:
        """Arm the host-RAM tier: past the device byte budget, LRU entries
        DEMOTE to host slots instead of evicting, and a lookup hit on a
        demoted entry restores it on touch.

        ``demote_fn(PageRun) -> HostRun | None`` copies every page of a run
        into host slots (None when the host tier is full — the entry then
        falls through to plain eviction); ``restore_fn(HostRun) -> PageRun |
        None`` allocates fresh device pages (admission-style: reserve +
        alloc, holding synthetic lane refs this cache immediately converts
        to cache refs) and uploads the bytes (None when the device pool
        cannot host the run right now — the hit is treated as a miss and
        the entry stays demoted).  Both run in admission paths, never
        inside the transfer-guarded decode dispatch.
        """
        self._host_pool = host_pool
        self._demote_fn = demote_fn
        self._restore_fn = restore_fn

    def __len__(self) -> int:
        return len(self._lru)

    # ---- lookup -----------------------------------------------------------

    def lookup(self, tokens: list[int] | tuple[int, ...],
               namespace: str = "") -> tuple[int, Any]:
        """Longest common prefix with any key stored under ``namespace``.

        Returns ``(match_len, cache)``; ``(0, None)`` on a miss.  The hit
        entry is refreshed in the LRU order.
        """
        query = tuple(tokens)
        root = self._roots.get(namespace)
        if root is None:
            return 0, None
        node, depth = root, 0
        while depth < len(query):
            edge = node.edges.get(query[depth])
            if edge is None:
                break
            label, child = edge
            shared = _lcp(label, query[depth:])
            depth += shared
            node = child
            if shared < len(label):
                # diverged mid-edge: everything below child still shares
                # `depth` tokens with the query, nothing shares more
                break
        if depth == 0:
            return 0, None
        entry = self._pick(node)
        if entry is None:  # pragma: no cover - n_entries invariant
            return 0, None
        self._lru.move_to_end((entry.ns, entry.key))
        if isinstance(entry.cache, HostRun):
            # restore-on-touch: page the demoted run back into fresh device
            # pages before the caller splices it.  A failed restore (device
            # pool full right now) is a miss — the entry stays on host for
            # a later, less contended touch.
            if not self._restore(entry):
                return 0, None
        return depth, entry.cache

    def _restore(self, entry: _Entry) -> bool:
        if self._restore_fn is None:  # pragma: no cover - host entries only
            return False              # exist after enable_tier()
        host_run = entry.cache
        entry.tier = "in-flight"  # pin: restore's own allocations may demote
        try:                      # or evict OTHER entries, never this one
            new_run = self._restore_fn(host_run)
        finally:
            entry.tier = "host"
        if new_run is None:
            return False
        # the engine handed us pages holding synthetic admission (lane)
        # refs; convert them to cache refs, then drop the synthetic ones
        charged = self._pool.cache_ref(new_run.pages)
        self._pool.lane_release(new_run.pages)
        self.total_bytes += charged * self._pool.page_bytes
        entry.nbytes = charged * self._pool.page_bytes
        entry.cache = new_run
        entry.tier = "device"
        self._host_pool.free(host_run.slots)
        self._host_pool.restores_total += len(host_run.slots)
        # restoring may overshoot the device budget: shed LRU entries (to
        # host when possible) so the budget invariant holds after every
        # public call.  One sanctioned exception: an entry BIGGER than the
        # whole device budget (born demoted at insert) overshoots while it
        # is the only device-resident entry — it re-demotes as the LRU
        # victim of the next shed instead
        self._shrink(exclude=(entry.ns, entry.key))
        return True

    def _pick(self, node: _Node) -> _Entry | None:
        """Any live entry in ``node``'s subtree (they all share the resolved
        prefix); prefer the shallowest so the walk stays O(depth)."""
        while node is not None and node.n_entries:
            if node.entry is not None:
                return node.entry
            node = next(
                (child for _, child in node.edges.values() if child.n_entries),
                None,
            )
        return None

    # ---- insert / evict ---------------------------------------------------

    def insert(self, tokens: list[int] | tuple[int, ...], cache: Any,
               nbytes: int | None = None, namespace: str = "") -> bool:
        """Store ``cache`` under ``(namespace, tokens)``; returns False when
        refused (empty key, or the snapshot alone exceeds the budget).
        Re-inserting an existing key refreshes its LRU slot and keeps the
        stored snapshot (equal content by construction — same prompt, same
        weights, same adapter)."""
        key = tuple(tokens)
        if not key:
            return False
        existing = self._lru.get((namespace, key))
        if existing is not None:
            self._lru.move_to_end((namespace, key))
            return True
        if self._pool is not None:
            # paged: refuse by the entry's worst-case physical footprint;
            # the actual charge (below) counts already-shared pages once
            if len(cache.pages) * self._pool.page_bytes > self.budget_bytes:
                # tier armed: an entry too big for the DEVICE budget is
                # born demoted — snapshotted straight to host slots, zero
                # device charge (its pages stay lane-held until the writing
                # lane drains, then free).  This is what stops long-context
                # KV competing with hot decode for device pages: the entry
                # is still hittable, it just pages in on touch.
                if self._demote_fn is None:
                    return False
                host_run = self._demote_fn(cache)
                if host_run is None:
                    return False
                self._host_pool.demotions_total += len(host_run.slots)
                node = self._attach(key, namespace)
                entry = _Entry(key=key, cache=host_run, nbytes=0, node=node,
                               ns=namespace, tier="host")
                self._link(node, entry)
                return True
        else:
            if nbytes is None:
                nbytes = _tree_nbytes(cache)
            if nbytes > self.budget_bytes:
                return False
        node = self._attach(key, namespace)
        if self._pool is not None:
            nbytes = self._pool.cache_ref(cache.pages) * self._pool.page_bytes
        entry = _Entry(key=key, cache=cache, nbytes=nbytes, node=node,
                       ns=namespace)
        self._link(node, entry)
        self.total_bytes += nbytes
        self._shrink(exclude=(namespace, key))
        return True

    def _link(self, node: _Node, entry: _Entry) -> None:
        node.entry = entry
        walk = node
        while walk is not None:
            walk.n_entries += 1
            walk = walk.parent
        self._lru[(entry.ns, entry.key)] = entry

    def _shrink(self, exclude: tuple | None = None) -> None:
        """Enforce the DEVICE byte budget: demote LRU device entries to the
        host tier while one is available, evict otherwise.  ``exclude``
        protects the entry that triggered the shrink (just inserted or just
        restored — by definition MRU and within budget by itself)."""
        while self.total_bytes > self.budget_bytes:
            if not self._shed_one(exclude):
                break

    def _shed_one(self, exclude: tuple | None = None) -> bool:
        """Move one LRU device entry off the device: demote when the host
        tier accepts it, evict otherwise.  Returns False when nothing
        device-resident remains to shed."""
        victim = next(
            (e for e in self._lru.values()
             if e.tier == "device" and (e.ns, e.key) != exclude),
            None,
        )
        if victim is None:
            return False
        if self._demote_fn is not None:
            host_run = self._demote_fn(victim.cache)
            if host_run is not None:
                freed = self._pool.cache_release(victim.cache.pages)
                self.total_bytes -= freed * self._pool.page_bytes
                victim.nbytes = 0
                victim.cache = host_run
                victim.tier = "host"
                self._host_pool.demotions_total += len(host_run.slots)
                return True
        self._evict(victim)
        return True

    def demote_or_evict(self) -> bool:
        """The paged engine's page-pressure hook (``alloc_reserved``'s
        ``evict_one``) with the tier armed: shed the LRU device entry —
        demote when possible, so "evicting" under admission pressure stops
        destroying reusable KV — falling back to plain eviction (host full,
        or only host-resident entries left, whose eviction frees host
        slots but no device page; the ``slack`` invariant guarantees a
        device page frees before the LRU drains)."""
        if self._shed_one():
            return True
        return self.evict_oldest()

    def _attach(self, key: tuple[int, ...], namespace: str = "") -> _Node:
        """Walk/extend the trie to the node for ``key``, splitting edges."""
        node = self._roots.get(namespace)
        if node is None:
            node = self._roots[namespace] = _Node()
        i = 0
        while i < len(key):
            edge = node.edges.get(key[i])
            if edge is None:
                child = _Node(parent=node)
                node.edges[key[i]] = (key[i:], child)
                return child
            label, child = edge
            shared = _lcp(label, key[i:])
            if shared == len(label):
                node, i = child, i + shared
                continue
            # split the edge at the divergence point
            mid = _Node(parent=node)
            mid.n_entries = child.n_entries
            mid.edges[label[shared]] = (label[shared:], child)
            child.parent = mid
            node.edges[key[i]] = (label[:shared], mid)
            if shared == len(key) - i:
                return mid
            leaf = _Node(parent=mid)
            mid.edges[key[i + shared]] = (key[i + shared:], leaf)
            return leaf
        return node

    def evict_oldest(self) -> bool:
        """Evict the least recently used entry (any namespace) — the paged
        engine's hook for freeing pool pages under admission pressure.
        In-flight entries (a restore mid-transfer) are pinned."""
        victim = next(
            (e for e in self._lru.values() if e.tier != "in-flight"), None
        )
        if victim is None:
            return False
        self._evict(victim)
        return True

    def drop_namespace(self, namespace: str) -> int:
        """Evict every entry stored under ``namespace`` — an unloaded
        adapter's KV must never be spliceable again (its slot id may be
        reused by a different tenant)."""
        victims = [e for e in self._lru.values() if e.ns == namespace]
        for entry in victims:
            self._evict(entry)
        self._roots.pop(namespace, None)
        return len(victims)

    def _evict(self, entry: _Entry) -> None:
        self._lru.pop((entry.ns, entry.key), None)
        if isinstance(entry.cache, HostRun):
            # host-resident: the device was credited at demotion; dropping
            # the entry only returns its host slots
            self._host_pool.free(entry.cache.slots)
        elif self._pool is not None:
            # physical credit: only pages dropping their LAST cache
            # reference (shared pages stay charged to the surviving entries)
            self.total_bytes -= (
                self._pool.cache_release(entry.cache.pages)
                * self._pool.page_bytes
            )
        else:
            self.total_bytes -= entry.nbytes
        self.evictions_total += 1
        node = entry.node
        node.entry = None
        walk = node
        while walk is not None:
            walk.n_entries -= 1
            walk = walk.parent
        # prune now-dead branches so the trie never outgrows the live entries
        while (node.parent is not None and node.entry is None
               and not node.edges):
            parent = node.parent
            for first, (_, child) in list(parent.edges.items()):
                if child is node:
                    del parent.edges[first]
                    break
            node = parent
        for ns, root in list(self._roots.items()):
            if root.n_entries == 0 and not root.edges:
                del self._roots[ns]

    def stats(self) -> dict[str, int]:
        return {
            "entries": len(self._lru),
            "entries_host": sum(
                1 for e in self._lru.values() if e.tier == "host"
            ),
            "bytes": self.total_bytes,
            "budget_bytes": self.budget_bytes,
            "evictions_total": self.evictions_total,
            "namespaces": len(self._roots),
        }


def _tree_nbytes(cache: Any) -> int:
    """Bytes of an unpaged snapshot: a tensor or a (nested) list, tuple or
    dict of tensors."""
    if isinstance(cache, dict):
        return sum(_tree_nbytes(v) for v in cache.values())
    if isinstance(cache, (list, tuple)):
        return sum(_tree_nbytes(v) for v in cache)
    return cache.nbytes
