"""Slot-based continuous-batching decode engine.

Counterpart of the reference's ``serve/engine.py``.  A fixed batch of
``slots`` decode lanes runs one single-token step, and requests are admitted
into free lanes between steps.  Two memory regimes for the KV cache:

* **paged** (``page_tokens > 0``, the default): a shared pool of fixed-size
  pages per layer (``models/llama.py`` ``PagedKV``) addressed through
  per-lane page tables; a lane materializes pages as its tokens arrive
  (prompt pages at admit, one page per ``page_tokens`` decode steps after),
  eviction frees them at once, and the prefix cache stores page runs shared
  copy-on-write.  Admission reserves a request's worst-case page count up
  front, so a pool too full to host a request is backpressure
  (:class:`~.kv_pages.PoolExhausted`, the batcher keeps it queued), never a
  crash mid-flight.  Attention runs the paged-attention kernel on the card;
* **unpaged** (``page_tokens=0``): every lane owns a contiguous
  ``cache_len`` stripe of a dense cache (``DenseKV``); a prefill runs B=1
  into its own stripe, which is copied into the lane (and kept whole by the
  prefix cache as a snapshot).  Attention is plain torch here, as the
  reference runs XLA attention in this mode.

Multi-tenant unmerged-LoRA serving (``tenant_slots > 0``): the engine owns
tenant stacks (``models/lora.py`` ``TenantStacks``) and a per-lane adapter
slot vector that rides into every forward beside the page table, so N
fine-tuned tenants decode in one batch on one base model; the prefix cache
keys namespaces by adapter id, so one tenant's KV never splices into
another's.  A batch whose lanes are all on the base (slot 0) skips the
tenant branch, whose delta would be an exact 0.0.

Host KV tier (``host_pool_bytes > 0``, paged with the prefix cache):
prefix-cache entries past the device budget, or shed under page pressure,
demote to pinned host pages and restore on touch.  Both directions run on
the admission path, never inside a decode step.

Threads: the batcher runs :meth:`admit` and :meth:`step` one after the
other in a worker thread, and the fleet installs adapters and drops prefix
namespaces from other threads.  Every public method that touches the
engine's host state or its device stacks takes the engine's lock, so an
adapter install, a tier copy and a decode step never overlap: the install
writes a slot in place only while no forward can read it.

Differences from the reference, by design:

* the KV caches are updated in place; the reference rebuilt the cache tree
  on every jitted call;
* the per-lane cache index lives on the host and rides into every forward
  as a (slots,) int32 tensor beside the page table and the RoPE positions.

The reference's compile-count contract holds as it is, armed with
``analysis/recompile_guard.py``: the prefill forwards count one signature
per **prompt bucket** (plus one more per bucket for the unpaged
prefix-reuse suffix prefill when the cache is on; paged, one prefill serves
fresh prompts and suffix continuations alike) and the decode step **one**,
so the default budget is ``len(prompt_buckets) + 1`` (``2 x buckets + 1``
unpaged with the prefix cache), and the engine raises past it.  PyTorch
compiles nothing, but a new signature is still new launch shapes and new
allocator blocks on the serve path.

The decode dispatch runs in the reference's transfer-guard window
(``FTC_TRANSFER_GUARD=raise|warn``, ``analysis/transfer_guard.py``): every
per-step input is copied to the device explicitly before the window, and
the (slots,) token vector is fetched after it.

The decode step keeps on-device token selection: it returns a ``(slots,)``
integer tensor, never the logits.  Sampled lanes draw from a per-request
``torch.Generator`` on the device, seeded from ``GenRequest.seed``.
"""

from __future__ import annotations

import dataclasses
import functools
import itertools
import logging
import threading
import time

import numpy as np
import torch

from ..analysis.recompile_guard import RecompileGuard, signature_of
from ..analysis.transfer_guard import TransferGuard, device_get
from ..models.generate import _sample
from ..models.llama import DenseKV, PagedKV, tenant_stacks
from .adapters import AdapterRegistry, UnknownAdapter, install_into
from .kv_pages import HostPagePool, HostRun, KVPagePool, PageRun, PoolExhausted
from .prefix_cache import PrefixCache, resolve_reuse_length

logger = logging.getLogger(__name__)

__all__ = ["BatchEngine", "EngineBusy", "EngineConfig", "GenRequest", "GenResult",
           "PromptTooLong", "UnknownAdapter", "warm_engine"]


class PromptTooLong(ValueError):
    """Prompt exceeds the largest configured prefill bucket."""


class EngineBusy(RuntimeError):
    """No free slot (the batcher queues instead of surfacing this)."""


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Shape of the serving batch."""

    #: fixed decode lanes (the physical batch); every step runs all of them
    slots: int = 8
    #: prefill pad targets, ascending
    prompt_buckets: tuple[int, ...] = (32, 128, 512)
    #: per-request cap on generated tokens; also sizes a lane
    max_new_tokens: int = 128
    #: byte budget for the prefix-reuse cache (0 = disabled)
    prefix_cache_bytes: int = 0
    #: sequence positions per KV page; 0 keeps the unpaged contiguous lanes
    page_tokens: int = 16
    #: total pool pages including the scratch page; 0 = auto-size to
    #: ``slots * pages_per_lane + 1``
    pool_pages: int = 0
    #: multi-tenant adapter stack slots INCLUDING base slot 0; 0 = off
    tenant_slots: int = 0
    #: stacked adapter rank ceiling (tenants zero-pad up to it)
    tenant_rank: int = 0
    #: host-RAM KV tier byte budget; 0 = off (paged + prefix cache only)
    host_pool_bytes: int = 0
    #: signature budget: defaults to len(prompt_buckets) + 1 (the decode
    #: step), or 2*len(prompt_buckets) + 1 with the prefix cache on AND
    #: paging off (fill AND fill_from per bucket); the guard RAISES past it
    #: — an unexpected new shape on the serve path is a latency bug
    recompile_budget: int = 0

    @property
    def cache_len(self) -> int:
        return max(self.prompt_buckets) + self.max_new_tokens

    @property
    def paged(self) -> bool:
        return self.page_tokens > 0

    @property
    def pages_per_lane(self) -> int:
        """Page-table width: pages covering one full-length lane."""
        return -(-self.cache_len // self.page_tokens) if self.page_tokens else 0

    @property
    def effective_pool_pages(self) -> int:
        if not self.paged:
            return 0
        return self.pool_pages or (self.slots * self.pages_per_lane + 1)

    def bucket_for(self, prompt_len: int) -> int:
        for b in self.prompt_buckets:
            if prompt_len <= b:
                return b
        raise PromptTooLong(
            f"prompt length {prompt_len} exceeds the largest prefill bucket "
            f"{max(self.prompt_buckets)}"
        )


@dataclasses.dataclass
class GenRequest:
    request_id: str
    tokens: list[int]                  # prompt token ids
    max_new_tokens: int = 32
    temperature: float = 0.0           # 0 = greedy
    top_k: int = 0
    eos_id: int | None = None
    seed: int = 0                      # sampling stream (temperature > 0)
    #: multi-tenant serving: which loaded adapter decodes this request
    #: ("" = the base model, stack slot 0)
    adapter_id: str = ""


@dataclasses.dataclass
class GenResult:
    request_id: str
    prompt_tokens: list[int]
    generated: list[int]               # includes the eos token when hit
    finish_reason: str                 # "length" | "eos" | "evicted"
    steps: int                         # decode steps this request rode
    admitted_at: float = 0.0
    finished_at: float = 0.0
    #: which fleet replica decoded this request (set by the router; "" when
    #: the engine is driven directly)
    replica_id: str = ""


@dataclasses.dataclass
class _Slot:
    lane: int = 0                      # this slot's row in the batch
    req: GenRequest | None = None
    next_pos: int = 0                  # sequence position of the token to feed
    last_token: int = 0                # token to feed at next_pos
    generated: list[int] = dataclasses.field(default_factory=list)
    generator: torch.Generator | None = None  # per-request sampling stream
    admitted_at: float = 0.0
    pages: list[int] = dataclasses.field(default_factory=list)
    reserved: int = 0                  # booked-but-unmaterialized pages
    adapter_id: str = ""

    @property
    def active(self) -> bool:
        return self.req is not None


def _locked(method):
    """Run ``method`` under the engine's lock (see the module note)."""

    @functools.wraps(method)
    def wrapper(self, *args, **kwargs):
        with self._lock:
            return method(self, *args, **kwargs)

    return wrapper


class BatchEngine:
    """Continuous-batching decode over the port's ``LlamaForCausalLM``.

    Host-driven: :meth:`admit` fills a free lane, :meth:`step` advances every
    active lane one token and returns whatever finished.  The asyncio layer
    (``serve/batcher.py``) owns queuing and deadlines; this class owns the
    device state and the numerics.  The engine runs on the model's device
    and never writes the model: replicas of a fleet share one model, each
    with its own KV cache, page pool, prefix cache and tenant stacks.
    """

    def __init__(self, model, config: EngineConfig | None = None,
                 adapters: AdapterRegistry | None = None):
        cfg = model.cfg
        # the reference engine's refusals (``engine.py:237-243``); an int4
        # base serves, dequantized inside each projection
        if getattr(cfg, "n_experts", 0):
            raise ValueError(
                "BatchEngine does not serve MoE configs: expert-capacity "
                "routing couples batch rows, breaking batching invariance"
            )
        if getattr(cfg, "vision", None) is not None:
            raise ValueError("BatchEngine serves text-only models (no pixels)")
        self.config = config or EngineConfig()
        self.model = model
        self.device = model.device
        self._lock = threading.RLock()
        # --- multi-tenant adapters -----------------------------------------
        if adapters is None and self.config.tenant_slots > 0:
            adapters = AdapterRegistry(self.config.tenant_slots,
                                       max(1, self.config.tenant_rank))
        self.adapters = adapters
        self._tenants = (tenant_stacks(cfg, adapters.capacity, adapters.max_rank, self.device)
                         if adapters is not None else None)
        # --- KV cache --------------------------------------------------------
        self._pool: KVPagePool | None = None
        if self.config.paged:
            pool_pages = self.config.effective_pool_pages
            if pool_pages - 1 < self.config.pages_per_lane:
                raise ValueError(
                    f"kv page pool too small: {pool_pages} pages cannot hold "
                    f"one full lane ({self.config.pages_per_lane} pages of "
                    f"{self.config.page_tokens} tokens)"
                )
            self.kv = PagedKV.zeros(cfg, pool_pages, self.config.page_tokens, self.device)
            self._pool = KVPagePool(pool_pages, self.config.page_tokens, self.kv.page_bytes)
        else:
            self.kv = DenseKV.zeros(cfg, self.config.slots, self.config.cache_len, self.device)
        self._slots = [_Slot(lane=i) for i in range(self.config.slots)]
        self._prefix_cache = (
            PrefixCache(self.config.prefix_cache_bytes, pool=self._pool)
            if self.config.prefix_cache_bytes > 0 else None
        )
        # host-RAM KV tier: needs paging (the page is the transfer unit)
        # and the prefix cache (its entries are what demotes)
        self._host_pool: HostPagePool | None = None
        if (self.config.host_pool_bytes > 0 and self._pool is not None
                and self._prefix_cache is not None):
            self._host_pool = HostPagePool(self.config.host_pool_bytes, self._pool.page_bytes)
            self._host_pool.allocate([self.kv.k[:, 0], self.kv.v[:, 0]])
            self._prefix_cache.enable_tier(self._host_pool, self._demote_run, self._restore_run)
        # host masters of the per-call inputs: lane page tables, cache
        # indexes and adapter slots (int32, shipped into every forward)
        self._tables = np.zeros((self.config.slots, max(1, self.config.pages_per_lane)),
                                np.int32)
        self._index = np.zeros((self.config.slots,), np.int32)
        self._adapter_slots = np.zeros((self.config.slots,), np.int32)
        if self.adapters is not None:
            self.sync_adapters()
        per_bucket = 2 if self.config.prefix_cache_bytes > 0 and not self.config.paged else 1
        budget = self.config.recompile_budget or (
            per_bucket * len(self.config.prompt_buckets) + 1)
        self.guard = RecompileGuard(budget, on_excess="raise", name="serve-engine")
        # the decode window's transfer guard; it arms the CUDA sync-debug
        # mode only when the engine is stepped on the main thread
        self._transfer_guard = TransferGuard.from_env(name="serve-decode")
        # counters the /metrics gauges read
        self.steps_total = 0
        self.tokens_generated_total = 0
        self.requests_finished_total = 0
        self.prefix_hits_total = 0
        self.prefix_misses_total = 0
        self.prefill_tokens_saved_total = 0
        #: per-tenant token counters ("" = base model)
        self.tokens_by_tenant: dict[str, int] = {}
        #: host-clock seconds spent copying pages to and from the host tier
        self.tier_seconds = {"demote": 0.0, "restore": 0.0}
        self._prefix_warned = False

    # ---- mode helpers -----------------------------------------------------

    @property
    def paged(self) -> bool:
        return self._pool is not None

    @property
    def compilations(self) -> int:
        """Distinct forward signatures so far (the reference's compiles)."""
        return self.guard.compilations

    # ---- adapters ---------------------------------------------------------

    @_locked
    def install_adapter(self, adapter_id: str) -> None:
        """Write one registered tenant's (rank-padded) stacks into this
        engine's slot for it.  Under the engine's lock, so no forward reads
        the stacks while the slot is written."""
        entry = self.adapters.get(adapter_id)
        if entry is None:
            raise UnknownAdapter(f"adapter {adapter_id!r} is not registered")
        install_into(self._tenants, entry.slot, entry.tree, entry.alpha, entry.rank)

    @_locked
    def remove_adapter(self, adapter_id: str, slot: int) -> None:
        """Zero a departed tenant's slot and drop its prefix-cache namespace
        (the slot id may be reused by a different tenant)."""
        install_into(self._tenants, slot, None, 0.0, 1)
        self.drop_prefix_namespace(adapter_id)

    @_locked
    def drop_prefix_namespace(self, adapter_id: str) -> None:
        """Evict every prefix-cache entry computed under ``adapter_id`` —
        required whenever the tenant's weights change (unload, and the
        in-place refresh of a tenant rollover): KV produced by the old
        deltas must never splice into lanes decoding with the new ones."""
        if self._prefix_cache is not None:
            self._prefix_cache.drop_namespace(adapter_id)

    def sync_adapters(self) -> None:
        """Install every registered tenant — fresh replicas and rollover
        generations call this before taking traffic."""
        for entry in self.adapters.entries():
            self.install_adapter(entry.adapter_id)

    def active_by_tenant(self) -> dict[str, int]:
        out: dict[str, int] = {}
        for slot in self._slots:
            if slot.active:
                out[slot.adapter_id] = out.get(slot.adapter_id, 0) + 1
        return out

    # ---- slot management --------------------------------------------------

    @property
    def free_slots(self) -> int:
        return sum(1 for s in self._slots if not s.active)

    @property
    def active_requests(self) -> int:
        return self.config.slots - self.free_slots

    @property
    def prefix_cache_bytes(self) -> int:
        return self._prefix_cache.total_bytes if self._prefix_cache else 0

    @property
    def prefix_cache_entries(self) -> int:
        return len(self._prefix_cache) if self._prefix_cache else 0

    def kv_page_stats(self) -> dict[str, int]:
        """Pool gauges (empty when unpaged); with the host tier armed, its
        gauges and transfer counters ride along."""
        if self._pool is None:
            return {}
        stats = self._pool.stats()
        if self._host_pool is not None:
            stats.update(self._host_pool.stats())
        return stats

    def kv_slack_pages(self) -> int | None:
        """Pages still promisable to new admissions (None when unpaged) —
        the router's page-aware routing signal."""
        return self._pool.slack() if self._pool is not None else None

    def _request_span(self, req: GenRequest) -> int:
        """Last written sequence position + 1: the prompt plus every decode
        step's write (the final token is recorded, not written)."""
        return len(req.tokens) + max(0, req.max_new_tokens - 1)

    def admission_pages(self, req: GenRequest) -> int:
        """Worst-case pages admitting ``req`` reserves (0 when unpaged)."""
        if self._pool is None:
            return 0
        return self._pool.pages_for(self._request_span(req))

    def can_admit(self, req: GenRequest, pending_pages: int = 0) -> bool:
        """Whether :meth:`admit` would succeed now.  Conservative: ignores
        prefix sharing.  Permanently impossible requests return True so
        ``admit`` raises their real error."""
        if self.free_slots == 0:
            return False
        if self._pool is None:
            return True
        need = self._pool.pages_for(self._request_span(req))
        if need > self._pool.usable_pages:
            return True
        return self._pool.can_reserve(need + pending_pages)

    def _resolve_adapter(self, req: GenRequest) -> tuple[int, str]:
        """(stack slot, prefix-cache namespace) for the request's tenant."""
        if not req.adapter_id:
            return 0, ""
        if self.adapters is None:
            raise UnknownAdapter(
                f"request {req.request_id} names adapter "
                f"{req.adapter_id!r} but this engine has no adapter "
                "registry (serve_max_adapters=0)"
            )
        return self.adapters.resolve(req.adapter_id), req.adapter_id

    def _resolve_prefix(self, tokens: list[int], plen: int, ns: str):
        match_len, run = self._prefix_cache.lookup(tokens, namespace=ns)
        if run is None:
            return 0, None
        reuse = resolve_reuse_length(
            match_len, plen, self.config.prompt_buckets, self.config.cache_len
        )
        if reuse <= 0:
            return 0, None
        return reuse, run

    @_locked
    @torch.no_grad()
    def admit(self, req: GenRequest) -> GenResult | None:
        """Prefill ``req`` into a free lane.  Raises :class:`EngineBusy`,
        :class:`PromptTooLong`, :class:`UnknownAdapter` or
        :class:`~.kv_pages.PoolExhausted` (gate with :meth:`can_admit`).
        With the prefix cache on, the longest cached prefix of the prompt
        under the request's adapter is spliced in and only the suffix runs a
        forward.  Returns a :class:`GenResult` when the request finishes on
        admission (eos, or ``max_new_tokens == 1``)."""
        slot_id = next((i for i, s in enumerate(self._slots) if not s.active), None)
        if slot_id is None:
            raise EngineBusy("all decode slots are busy")
        plen = len(req.tokens)
        if plen < 1:
            raise ValueError("empty prompt")
        if req.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        cap = self.config.max_new_tokens
        if req.max_new_tokens > cap:
            raise ValueError(f"max_new_tokens {req.max_new_tokens} > engine cap {cap}")
        a_slot, ns = self._resolve_adapter(req)
        self.config.bucket_for(plen)  # PromptTooLong before any allocation
        if self.paged:
            logits = self._prefill_paged(req, slot_id, plen, a_slot, ns)
        else:
            logits = self._prefill_unpaged(req, slot_id, plen, a_slot, ns)
        self._adapter_slots[slot_id] = a_slot
        slot = self._slots[slot_id]
        slot.req = req
        slot.generated = []
        slot.next_pos = plen
        slot.adapter_id = req.adapter_id
        slot.generator = None
        if req.temperature > 0.0:
            slot.generator = torch.Generator(device=self.device).manual_seed(req.seed)
        slot.admitted_at = time.monotonic()
        tok = int(_sample(logits, temperature=req.temperature, top_k=req.top_k,
                          generator=slot.generator)[0])
        return self._record(slot, tok)

    def _adapter_ids(self, slots: np.ndarray) -> torch.Tensor | None:
        """The per-row adapter slots as a device tensor, or None when every
        row is on the base (slot 0: the tenant delta is an exact 0.0)."""
        if self._tenants is None or not slots.any():
            return None
        return torch.from_numpy(slots).to(self.device)

    def _inputs(self, label: str, tokens: np.ndarray, positions: np.ndarray,
                index: np.ndarray, adapter_slots: np.ndarray,
                table: np.ndarray | None) -> tuple:
        """Count the call's signature under ``label`` (the recompile guard
        raises past the budget), then copy its host int32 inputs to the
        device: (tokens, positions, index, adapter ids or None, table or
        None)."""
        self.guard.check(label, signature_of(tokens, positions, index, adapter_slots, table))
        dev = self.device
        return (torch.from_numpy(tokens).to(dev, torch.long), torch.from_numpy(positions).to(dev),
                torch.from_numpy(index).to(dev), self._adapter_ids(adapter_slots),
                None if table is None else torch.from_numpy(table).to(dev))

    def _forward(self, tokens, positions, index, adapter_ids, table, last_idx: int, *,
                 kv=None, fresh: bool = False) -> torch.Tensor:
        """One forward on device inputs (:meth:`_inputs`): (B, V) f32 logits
        at chunk offset ``last_idx``.  Paged when ``table`` is given (the
        chunk's K/V go into the pools), else against the dense ``kv`` (the
        engine's own lanes unless a B=1 prefill cache is passed)."""
        tenant = dict(adapter_ids=adapter_ids, tenants=self._tenants)
        if table is not None:
            logits = self.model.forward_paged(tokens, positions, self.kv, table, index,
                                              last_idx=last_idx, **tenant)
        else:
            logits = self.model.forward_cached(tokens, positions, self.kv if kv is None else kv,
                                               index, fresh=fresh, last_idx=last_idx, **tenant)
        return logits.to(torch.float32)

    # ---- unpaged prefill --------------------------------------------------

    def _prefill_unpaged(self, req: GenRequest, slot_id: int, plen: int, a_slot: int,
                         ns: str) -> torch.Tensor:
        reuse, snapshot = (
            self._resolve_prefix(req.tokens, plen, ns)
            if self._prefix_cache is not None else (0, None)
        )
        ids = np.array([a_slot], np.int32)
        if snapshot is not None:
            # suffix prefill over a copy of the cached B=1 snapshot: the
            # first `reuse` positions are reused as they are
            suffix = req.tokens[reuse:]
            sbucket = self.config.bucket_for(len(suffix))
            one = snapshot.clone()
            padded = np.zeros((1, sbucket), np.int32)
            padded[0, :len(suffix)] = suffix
            positions = (reuse + np.arange(sbucket, dtype=np.int32))[None, :]
            inputs = self._inputs("fill_from", padded, positions,
                                  np.array([reuse], np.int32), ids, None)
            logits = self._forward(*inputs, len(suffix) - 1, kv=one)
            self.prefix_hits_total += 1
            self.prefill_tokens_saved_total += reuse
        else:
            bucket = self.config.bucket_for(plen)
            one = DenseKV.zeros(self.model.cfg, 1, self.config.cache_len, self.device)
            padded = np.zeros((1, bucket), np.int32)
            padded[0, :plen] = req.tokens
            positions = np.arange(bucket, dtype=np.int32)[None, :]
            inputs = self._inputs("fill", padded, positions, np.zeros((1,), np.int32), ids,
                                  None)
            logits = self._forward(*inputs, plen - 1, kv=one, fresh=True)
            if self._prefix_cache is not None:
                self.prefix_misses_total += 1
        if self._prefix_cache is not None:
            # the hit path's `one` holds the full prompt too, so every
            # admission leaves its prompt resolvable for the next request
            if not self._prefix_cache.insert(tuple(req.tokens), one, nbytes=one.nbytes,
                                             namespace=ns) and not self._prefix_warned:
                self._prefix_warned = True
                logger.warning(
                    "prefix cache cannot hold a single KV snapshot (%d B > "
                    "budget %d B) — every admission will miss; raise "
                    "serve_prefix_cache_mb or disable the cache",
                    one.nbytes, self._prefix_cache.budget_bytes,
                )
        self.kv.k[:, slot_id] = one.k[:, 0]
        self.kv.v[:, slot_id] = one.v[:, 0]
        self._index[slot_id] = plen
        return logits

    # ---- paged prefill ----------------------------------------------------

    def _evict_hook(self):
        if self._prefix_cache is None:
            return None
        if self._host_pool is not None:
            # tier armed: page pressure demotes LRU entries to host RAM
            # instead of destroying them (eviction when the host is full)
            return self._prefix_cache.demote_or_evict
        return self._prefix_cache.evict_oldest

    # ---- host KV tier transfers -------------------------------------------
    #
    # Both directions run on admission paths (prefix lookup and insert, page
    # growth), under the engine's lock, never inside a decode step.

    def _demote_run(self, run: PageRun) -> HostRun | None:
        """Copy every page of ``run`` into host slots (device state is not
        touched — the prefix cache releases the device refs after the
        swap).  None when the host tier cannot hold the run."""
        hp = self._host_pool
        if hp is None or not hp.can_hold(len(run.pages)):
            return None
        t0 = time.perf_counter()
        slots = hp.alloc(len(run.pages))
        for slot_id, page in zip(slots, run.pages):
            hp.write(slot_id, [self.kv.k[:, page], self.kv.v[:, page]])
        self.tier_seconds["demote"] += time.perf_counter() - t0
        return HostRun(slots=tuple(slots), n_tokens=run.n_tokens)

    def _restore_run(self, host_run: HostRun) -> PageRun | None:
        """Upload a demoted run back into freshly allocated device pages:
        reserve first (None on exhaustion: the caller treats the hit as a
        miss), then allocate and write page by page, releasing what was
        taken if anything fails.  The returned pages hold synthetic lane
        refs the prefix cache converts to cache refs."""
        pool = self._pool
        n = len(host_run.slots)
        try:
            pool.reserve(n)
        except PoolExhausted:
            return None
        t0 = time.perf_counter()
        pages: list[int] = []
        try:
            for slot_id in host_run.slots:
                phys = pool.alloc_reserved(self._evict_hook())
                pages.append(phys)
                k, v = self._host_pool.read(slot_id)
                # blocking copies: the host slot may be reused once this
                # returns, and the device bytes are in place for the splice
                self.kv.k[:, phys].copy_(k)
                self.kv.v[:, phys].copy_(v)
        except BaseException:
            pool.lane_release(pages, n - len(pages))
            raise
        self.tier_seconds["restore"] += time.perf_counter() - t0
        return PageRun(pages=tuple(pages), n_tokens=host_run.n_tokens)

    def _prefill_paged(self, req: GenRequest, slot_id: int, plen: int, a_slot: int,
                       ns: str) -> torch.Tensor:
        pool, t = self._pool, self._pool.page_tokens
        need_total = pool.pages_for(self._request_span(req))
        if need_total > pool.usable_pages:
            raise ValueError(
                f"request {req.request_id} needs {need_total} kv pages but "
                f"the pool holds {pool.usable_pages} — raise "
                "serve_kv_pool_pages or shrink the request"
            )
        reuse, run = (
            self._resolve_prefix(req.tokens, plen, ns)
            if self._prefix_cache is not None else (0, None)
        )
        shared = list(run.pages[: reuse // t]) if run is not None else []
        pool.reserve(need_total - len(shared))  # PoolExhausted backpressure
        for page in shared:
            pool.lane_ref(page)
        slot = self._slots[slot_id]
        slot.pages = list(shared)
        slot.reserved = need_total - len(shared)
        row = np.zeros((self._tables.shape[1],), np.int32)
        row[: len(shared)] = shared
        try:
            # materialize the pages the prompt writes now; decode growth
            # spends the rest of the reservation page by page
            for i in range(len(shared), pool.pages_for(plen)):
                phys = pool.alloc_reserved(self._evict_hook())
                row[i] = phys
                slot.pages.append(phys)
                slot.reserved -= 1
            if run is not None and reuse % t:
                # copy-on-write boundary: the page holding position `reuse`
                # keeps the entry's prefix KV but this lane's suffix writes
                # into it — it must be a private copy
                self.kv.copy_page(int(row[reuse // t]), int(run.pages[reuse // t]))
                pool.cow_copies_total += 1
            start = reuse if run is not None else 0
            suffix = req.tokens[start:]
            sbucket = self.config.bucket_for(len(suffix))
            padded = np.zeros((1, sbucket), np.int32)
            padded[0, :len(suffix)] = suffix
            positions = (start + np.arange(sbucket, dtype=np.int32))[None, :]
            inputs = self._inputs("fill_paged", padded, positions,
                                  np.array([start], np.int32), np.array([a_slot], np.int32),
                                  row[None, :])
            logits = self._forward(*inputs, len(suffix) - 1)
        except BaseException:
            # roll the lane's pool state back so a failed prefill never
            # leaks pages (its writes landed only in pages it owned, or in
            # the scratch page)
            pool.lane_release(slot.pages, slot.reserved)
            slot.pages, slot.reserved = [], 0
            raise
        self._index[slot_id] = plen
        self._tables[slot_id, :] = row
        if self._prefix_cache is not None:
            if run is not None:
                self.prefix_hits_total += 1
                self.prefill_tokens_saved_total += start
            else:
                self.prefix_misses_total += 1
            run_new = PageRun(
                pages=tuple(int(x) for x in row[:pool.pages_for(plen)]), n_tokens=plen,
            )
            if not self._prefix_cache.insert(tuple(req.tokens), run_new, namespace=ns) \
                    and not self._prefix_warned:
                self._prefix_warned = True
                logger.warning(
                    "prefix cache cannot hold a single page run (%d pages x "
                    "%d B > budget %d B) — every admission will miss; raise "
                    "serve_prefix_cache_mb or disable the cache",
                    len(run_new.pages), pool.page_bytes, self._prefix_cache.budget_bytes,
                )
        return logits

    @_locked
    def evict(self, request_id: str) -> GenResult | None:
        """Drop an in-flight request; frees its lane (and its pages) at once
        and parks its cache index at 0 (see :meth:`_finish`)."""
        for slot in self._slots:
            if slot.active and slot.req.request_id == request_id:
                return self._finish(slot, "evicted")
        return None

    def _record(self, slot: _Slot, tok: int) -> GenResult | None:
        """Host bookkeeping for one selected token: eos/length latching."""
        req = slot.req
        slot.generated.append(tok)
        slot.last_token = tok
        self.tokens_generated_total += 1
        self.tokens_by_tenant[slot.adapter_id] = self.tokens_by_tenant.get(slot.adapter_id, 0) + 1
        if req.eos_id is not None and tok == req.eos_id:
            return self._finish(slot, "eos")
        if len(slot.generated) >= req.max_new_tokens:
            return self._finish(slot, "length")
        return None

    def _finish(self, slot: _Slot, reason: str) -> GenResult:
        req = slot.req
        result = GenResult(
            request_id=req.request_id,
            prompt_tokens=list(req.tokens),
            generated=list(slot.generated),
            finish_reason=reason,
            steps=len(slot.generated),
            admitted_at=slot.admitted_at,
            finished_at=time.monotonic(),
        )
        slot.req = None
        slot.generated = []
        slot.generator = None
        slot.last_token = 0
        slot.next_pos = 0
        slot.adapter_id = ""
        self._adapter_slots[slot.lane] = 0
        if self.paged:
            # free the lane's pages (shared refs drop; pages still held by
            # prefix-cache entries stay resident) and return the unspent
            # reservation
            self._pool.lane_release(slot.pages, slot.reserved)
            slot.pages = []
            slot.reserved = 0
            self._tables[slot.lane, :] = 0
        # park the lane: it still rides every decode step, writing throwaway
        # tokens at benign in-bounds positions (the scratch page when paged)
        self._index[slot.lane] = 0
        self.requests_finished_total += 1
        return result

    # ---- the decode loop --------------------------------------------------

    def _grow_pages(self) -> None:
        """Materialize the page each active lane's next write lands in, when
        it has not been allocated yet (reservation-backed)."""
        t = self._pool.page_tokens
        width = self._tables.shape[1]
        for slot in self._slots:
            if not slot.active:
                continue
            page_idx = slot.next_pos // t
            if page_idx < width and self._tables[slot.lane, page_idx] == 0:
                phys = self._pool.alloc_reserved(self._evict_hook())
                self._tables[slot.lane, page_idx] = phys
                slot.pages.append(phys)
                slot.reserved -= 1

    def _decode(self, tokens, positions, index, adapter_ids, table) -> torch.Tensor:
        """One batched decode step on device inputs with on-device token
        selection: (slots,) next tokens.  Greedy lanes take the argmax;
        sampled lanes draw from their own generator, so a request's stream
        does not depend on its batch-mates' draws."""
        logits = self._forward(tokens, positions, index, adapter_ids, table, 0)
        next_tokens = torch.argmax(logits, dim=-1)
        for i, slot in enumerate(self._slots):
            if slot.active and slot.req.temperature > 0.0:
                next_tokens[i] = _sample(
                    logits[i:i + 1], temperature=slot.req.temperature,
                    top_k=slot.req.top_k, generator=slot.generator,
                )[0]
        return next_tokens

    @_locked
    @torch.no_grad()
    def step(self) -> list[GenResult]:
        """One batched decode step; returns requests that finished on it.
        The host receives a (slots,) token vector, never the logits."""
        if self.active_requests == 0:
            return []
        if self.paged:
            self._grow_pages()
        tokens = np.zeros((self.config.slots, 1), np.int32)
        positions = np.zeros((self.config.slots, 1), np.int32)
        for i, slot in enumerate(self._slots):
            if slot.active:
                tokens[i, 0] = slot.last_token
                positions[i, 0] = slot.next_pos
        # the per-step inputs go to the device BEFORE the guarded window:
        # they are the decode step's whole intended transfer, and anything
        # else crossing inside the dispatch trips the transfer guard
        inputs = self._inputs("decode_step", tokens, positions, self._index,
                              self._adapter_slots, self._tables if self.paged else None)
        if self._transfer_guard is not None:
            next_tokens = self._transfer_guard.run("decode", self._decode, *inputs)
        else:
            next_tokens = self._decode(*inputs)
        next_tokens = device_get(next_tokens).tolist()
        # every lane (parked ones too) advanced its index by one, saturating
        # at the lane capacity
        lane_cap = (self._tables.shape[1] * self._pool.page_tokens if self.paged
                    else self.config.cache_len)
        self._index = np.minimum(self._index + 1, lane_cap)
        self.steps_total += 1
        finished: list[GenResult] = []
        for i, slot in enumerate(self._slots):
            if not slot.active:
                continue
            slot.next_pos += 1
            done = self._record(slot, int(next_tokens[i]))
            if done is not None:
                finished.append(done)
        return finished

    def run(self, requests: list[GenRequest]) -> dict[str, GenResult]:
        """Synchronous loop (tests/bench): admit everything — overflow waits
        for a lane or for pool pages — and step until the batch drains."""
        results: dict[str, GenResult] = {}
        pending = list(requests)
        guard_steps = itertools.count()
        limit = sum(r.max_new_tokens for r in requests) + len(requests) + 8
        while pending or self.active_requests:
            while pending and self.free_slots and self.can_admit(pending[0]):
                done = self.admit(pending.pop(0))
                if done is not None:
                    results[done.request_id] = done
            if pending and not self.active_requests and not self.can_admit(pending[0]):
                raise PoolExhausted(
                    f"request {pending[0].request_id} can never admit: the "
                    "kv page pool is exhausted with no work in flight"
                )
            for done in self.step():
                results[done.request_id] = done
            if next(guard_steps) > limit:  # pragma: no cover - safety valve
                raise RuntimeError("engine.run failed to converge")
        missing = [r.request_id for r in requests if r.request_id not in results]
        if missing:  # pragma: no cover - engine invariant
            raise RuntimeError(f"requests did not finish: {missing}")
        return results


def warm_engine(engine: BatchEngine, *, warm_new: int | None = None) -> None:
    """Run one dummy request per prompt bucket plus decode steps before the
    engine takes traffic (first-use costs: CUDA context, kernel build and
    load, allocator growth), then zero the counters."""
    new_tokens = warm_new if warm_new is not None else min(2, engine.config.max_new_tokens)
    for bucket in engine.config.prompt_buckets:
        engine.run([GenRequest(request_id=f"_warm-{bucket}", tokens=[1] * bucket,
                               max_new_tokens=new_tokens)])
    engine.steps_total = 0
    engine.tokens_generated_total = 0
    engine.requests_finished_total = 0
    engine.prefix_hits_total = 0
    engine.prefix_misses_total = 0
    engine.prefill_tokens_saved_total = 0
    engine.tokens_by_tenant = {}
