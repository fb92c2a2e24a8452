"""Asyncio admission layer over :class:`~.engine.BatchEngine`.

A copy of the reference's ``serve/batcher.py`` (free of JAX), kept by the
port so that it imports nothing of the reference package.  Its
``compilations`` stat is the engine's count of distinct forward signatures
(the port compiles nothing; the reference counts its XLA compiles there).

The engine is host-driven and synchronous; this wraps it in the control
plane's event loop:

* requests enter a bounded queue — **backpressure**: past ``max_queue`` the
  caller gets :class:`QueueFull` (the service maps it to HTTP 429) instead of
  unbounded memory growth;
* a single drive task admits queued requests into free lanes between decode
  steps (``max_batch`` lanes; a request joins mid-flight, never waits for the
  batch to drain) and runs the decode step in a worker thread so the loop
  stays responsive;
* **deadlines**: a request that waited in the queue past its deadline is
  dropped with :class:`DeadlineExceeded` before ever touching the engine; an
  admitted request past its deadline is evicted between steps.  A caller may
  pass an ABSOLUTE ``deadline`` instead of a relative timeout — the fleet
  router (``serve/router.py``) uses this so a failover re-enqueue keeps the
  request's ORIGINAL deadline rather than minting a fresh one;
* ``max_wait_ms`` is the idle park interval: with nothing queued and nothing
  in flight the drive loop sleeps that long between re-checks rather than
  spinning.  Submissions wake it immediately (the ``_wake`` event), so the
  knob only bounds how stale the fallback re-check can go — floored at 1 ms
  so a zero can never busy-spin the loop;
* **drain** (docs/serving.md §Fleet): :meth:`drain` stops admissions, bounces
  still-queued requests with :class:`ReplicaUnavailable` (retryable on a
  survivor — they never touched a lane) and lets in-flight lanes finish
  before closing — the zero-downtime half of checkpoint rollover and of
  scheduler-driven scale-down;
* **per-tenant fairness** (docs/serving.md §Multi-tenant adapters): the
  queue is one FIFO per tenant (``GenRequest.adapter_id``; "" = the base
  model) admitted by deficit round robin — each round every waiting tenant
  earns ``drr_quantum_tokens`` of credit and admits requests while its
  credit covers their token cost (prompt + max_new), so one hot tenant
  flooding the queue cannot starve the others, while a single-tenant
  workload degenerates to the original FIFO exactly;
* the engine's :meth:`~.engine.BatchEngine.can_admit` gates admission, so paged-KV pool pressure keeps requests
  QUEUED (and a full queue 429s with a derived ``Retry-After``) instead of
  failing them mid-admission.
"""

from __future__ import annotations

import asyncio
import collections
import dataclasses
import logging
import time
from typing import Any

from .engine import BatchEngine, GenRequest, GenResult
from .kv_pages import PoolExhausted

logger = logging.getLogger(__name__)


class QueueFull(RuntimeError):
    """Admission queue at capacity — shed load (HTTP 429).

    ``retry_after_s`` (when known) is the batcher's drain-time estimate; the
    HTTP layer surfaces it as a ``Retry-After`` header so callers back off
    for a useful interval instead of guessing.
    """

    def __init__(self, message: str, retry_after_s: float | None = None):
        super().__init__(message)
        self.retry_after_s = retry_after_s


class DeadlineExceeded(RuntimeError):
    """The request's deadline passed before it finished."""


class ReplicaUnavailable(RuntimeError):
    """The replica serving this request died or is draining.

    The request did NOT complete (queued requests never touched a lane;
    in-flight lanes were evicted), so it is safe for the router to re-enqueue
    it on a surviving replica — the exactly-once contract holds because the
    failed attempt produced no result.
    """


@dataclasses.dataclass
class _Pending:
    req: GenRequest
    future: asyncio.Future
    enqueued_at: float
    deadline: float | None  # monotonic instant, None = no deadline


class Batcher:
    """One drive loop per served model; owns the engine between steps."""

    def __init__(
        self,
        engine: BatchEngine,
        *,
        max_queue: int = 64,
        max_wait_ms: float = 1000.0,
        default_timeout_s: float = 60.0,
        ttft_observe=None,
        drr_quantum_tokens: float = 256.0,
    ):
        self.engine = engine
        self.max_queue = max_queue
        self.max_wait_ms = max_wait_ms
        self.default_timeout_s = default_timeout_s
        #: time-to-first-token callback (seconds) — the obs hub's
        #: ``ftc_serve_ttft_seconds`` histogram (docs/observability.md);
        #: observed at admission: the prefill that admits a request also
        #: produces its first token
        self.ttft_observe = ttft_observe
        #: deficit-round-robin quantum: token-cost credit every waiting
        #: tenant earns per admission round (``serve_drr_quantum_tokens``)
        self.drr_quantum_tokens = max(1.0, drr_quantum_tokens)
        #: one FIFO per tenant, admitted by deficit round robin
        self._queues: collections.OrderedDict[
            str, collections.deque[_Pending]
        ] = collections.OrderedDict()
        self._deficit: dict[str, float] = {}
        self._inflight: dict[str, _Pending] = {}
        self._wake = asyncio.Event()
        self._task: asyncio.Task | None = None
        self._closed = False
        self._draining = False
        # counters surfaced by /metrics
        self.rejected_total = 0
        self.deadline_drops_total = 0
        self.completed_total = 0
        #: decode-step faults the drive loop survived (fleet health checks
        #: read this: a replica whose steps fault is torn down + restarted)
        self.step_errors_total = 0
        self.last_step_error: BaseException | None = None
        #: recent decode-step completion instants (monotonic) — the decode
        #: rate half of the Retry-After estimate
        self._step_stamps: collections.deque[float] = collections.deque(maxlen=64)
        #: EMA of decode steps per completed request — the work-per-request
        #: half of the Retry-After estimate
        self._avg_request_steps: float | None = None

    # ---- public surface ---------------------------------------------------

    @property
    def queue_depth(self) -> int:
        return sum(len(q) for q in self._queues.values())

    def queue_depth_by_tenant(self) -> dict[str, int]:
        return {t: len(q) for t, q in self._queues.items() if q}

    def queued(self) -> list[_Pending]:
        """Snapshot of everything queued, in per-tenant FIFO order."""
        return [p for q in self._queues.values() for p in q]

    def inflight_by_tenant(self) -> dict[str, int]:
        """Requests registered in-flight (admitted OR mid-admission in the
        worker thread) per tenant — the engine's lane view alone misses the
        admission window, which matters to adapter-unload busy checks."""
        out: dict[str, int] = {}
        for p in self._inflight.values():
            tenant = p.req.adapter_id or ""
            out[tenant] = out.get(tenant, 0) + 1
        return out

    def _drain_queues(self) -> list[_Pending]:
        """Pop everything queued (drain/close paths)."""
        out: list[_Pending] = []
        for q in self._queues.values():
            out.extend(q)
        self._queues.clear()
        self._deficit.clear()
        return out

    @property
    def slots_busy(self) -> int:
        return self.engine.active_requests

    @property
    def _park_timeout_s(self) -> float:
        """Idle re-check interval of :meth:`_drive` — ``max_wait_ms`` with a
        1 ms floor (pinned in ``tests/test_serve.py``)."""
        return max(self.max_wait_ms, 1.0) / 1000.0

    def start(self) -> None:
        # restart a dead drive task too: a crashed loop (engine fault) must
        # not leave the batcher permanently accepting-but-never-serving
        if self._task is None or self._task.done():
            self._task = asyncio.get_running_loop().create_task(self._drive())

    async def close(self, exc: BaseException | None = None) -> None:
        """Tear down; pending futures fail with ``exc`` (default: the
        shutdown :class:`DeadlineExceeded` — a fleet teardown passes
        :class:`ReplicaUnavailable` instead so the router can fail over)."""
        self._closed = True
        self._wake.set()
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None
        for p in self._drain_queues() + list(self._inflight.values()):
            if not p.future.done():
                p.future.set_exception(
                    exc if exc is not None
                    else DeadlineExceeded("server shutting down")
                )
        self._inflight.clear()

    async def drain(self, timeout_s: float = 30.0) -> bool:
        """Graceful shutdown: refuse new admissions, bounce still-QUEUED
        requests with :class:`ReplicaUnavailable` (they never touched a lane
        — a router retries them on a survivor), let IN-FLIGHT lanes finish,
        then close.  Returns True when every in-flight request completed
        within ``timeout_s`` (stragglers past it fail retryably too)."""
        self._draining = True
        bounced = self._drain_queues()
        for p in bounced:
            if not p.future.done():
                p.future.set_exception(ReplicaUnavailable(
                    f"request {p.req.request_id} bounced: replica draining"
                ))
        deadline = time.monotonic() + max(0.0, timeout_s)
        while self._inflight and time.monotonic() < deadline:
            self._wake.set()
            await asyncio.sleep(0.005)
        drained = not self._inflight
        if not drained:
            logger.warning(
                "drain timed out with %d request(s) still in flight; "
                "failing them over", len(self._inflight),
            )
        await self.close(ReplicaUnavailable("replica drained away"))
        return drained

    @property
    def draining(self) -> bool:
        return self._draining

    async def health_probe(self) -> dict[str, Any]:
        """Liveness + decode-progress snapshot, the fleet health check's ONE
        input (docs/serving.md §Fleet).  Async so the in-process Batcher and
        a cross-process replica (where this is an RPC with a heartbeat-lease
        check in front) share a surface — the fleet cannot tell them apart."""
        return {
            "steps_total": self.engine.steps_total,
            "slots_busy": self.slots_busy,
            "queue_depth": self.queue_depth,
            "step_errors_total": self.step_errors_total,
            "last_step_error": (
                str(self.last_step_error)
                if self.last_step_error is not None else None
            ),
            "draining": self._draining,
            "inflight_by_tenant": self.inflight_by_tenant(),
        }

    async def tenant_busy(self, adapter_id: str) -> int:
        """Requests queued or in flight for one tenant — the adapter-unload
        busy check.  Async for the same transport-symmetry reason as
        :meth:`health_probe` (remote replicas answer with a fresh RPC, not a
        stale cache)."""
        tenant = adapter_id or ""
        return (
            self.inflight_by_tenant().get(tenant, 0)
            + self.queue_depth_by_tenant().get(tenant, 0)
        )

    def retry_after_s(self, extra_requests: int = 1) -> float:
        """Estimated seconds until ``extra_requests`` more requests queued NOW
        would complete — queue depth × observed steps-per-request over the
        observed decode-step rate (lanes run in parallel, so the work
        amortises over ``slots``).  The number behind the ``Retry-After``
        header on 429s; clamped to [1, 120] and 1.0 before any signal exists.
        """
        if not self._avg_request_steps or len(self._step_stamps) < 2:
            return 1.0
        span = self._step_stamps[-1] - self._step_stamps[0]
        if span <= 0:
            return 1.0
        steps_per_s = (len(self._step_stamps) - 1) / span
        lanes = max(1, self.engine.config.slots)
        work_steps = (self.queue_depth + extra_requests) * self._avg_request_steps
        eta = work_steps / (steps_per_s * lanes)
        return min(120.0, max(1.0, eta))

    async def submit(
        self,
        req: GenRequest,
        *,
        timeout_s: float | None = None,
        deadline: float | None = None,
    ) -> GenResult:
        """Queue a request and await its result (raises :class:`QueueFull`
        immediately at capacity).  ``deadline`` is an absolute
        ``time.monotonic`` instant that wins over ``timeout_s`` — failover
        re-enqueues pass the ORIGINAL deadline through it."""
        if self._draining:
            raise ReplicaUnavailable("replica is draining")
        if self._closed:
            raise QueueFull("batcher is closed")
        if self.queue_depth >= self.max_queue:
            self.rejected_total += 1
            raise QueueFull(
                f"admission queue at capacity ({self.max_queue}); retry later",
                retry_after_s=self.retry_after_s(),
            )
        now = time.monotonic()
        if deadline is None:
            timeout = self.default_timeout_s if timeout_s is None else timeout_s
            deadline = None if timeout <= 0 else now + timeout
        pending = _Pending(
            req=req,
            future=asyncio.get_running_loop().create_future(),
            enqueued_at=now,
            deadline=deadline,
        )
        tenant = req.adapter_id or ""
        if tenant not in self._queues:
            self._queues[tenant] = collections.deque()
        self._queues[tenant].append(pending)
        self.start()
        self._wake.set()
        return await pending.future

    # ---- drive loop -------------------------------------------------------

    def _drop_expired(self) -> None:
        now = time.monotonic()
        for tenant, q in list(self._queues.items()):
            keep = collections.deque()
            for p in q:
                if p.deadline is not None and now > p.deadline:
                    self.deadline_drops_total += 1
                    if not p.future.done():
                        p.future.set_exception(DeadlineExceeded(
                            f"request {p.req.request_id} spent its deadline "
                            "queued"
                        ))
                else:
                    keep.append(p)
            if keep:
                self._queues[tenant] = keep
            else:
                self._queues.pop(tenant, None)
                self._deficit.pop(tenant, None)
        for rid, p in list(self._inflight.items()):
            if p.deadline is not None and now > p.deadline:
                result = self.engine.evict(rid)
                self._inflight.pop(rid, None)
                self.deadline_drops_total += 1
                if not p.future.done():
                    p.future.set_exception(DeadlineExceeded(
                        f"request {rid} exceeded its deadline mid-decode"
                    ))
                if result is not None:
                    logger.info("evicted %s after %d tokens", rid, result.steps)

    @staticmethod
    def _cost(req: GenRequest) -> float:
        """DRR token cost: the work a request buys (prompt prefill + decode
        budget)."""
        return float(len(req.tokens) + req.max_new_tokens)

    def _select_admissions(self, budget: int) -> list[_Pending]:
        """Deficit-round-robin pick of up to ``budget`` admittable requests.

        Every round, each tenant with queued work earns ``drr_quantum_tokens``
        of credit and admits head-of-line requests while the credit covers
        their cost AND the engine can take them (free lane + paged-pool
        slack) — a blocked head (pool pressure) stays queued without
        consuming credit, and the rotation moves on so other tenants keep
        flowing.  A tenant's credit resets when its queue empties: deficits
        only ever accumulate toward the NEXT request in line, never into a
        burst allowance.
        """
        picked: list[_Pending] = []
        if budget <= 0:
            return picked
        quantum = self.drr_quantum_tokens
        # pages already promised to this batch: the engine only RESERVES at
        # admit time (in the worker thread), so the gate must account for
        # the whole batch, not each request against the same free pool
        planned_pages = 0
        while len(picked) < budget:
            progress = False
            blocked_only = True
            for tenant in list(self._queues.keys()):
                q = self._queues.get(tenant)
                if not q:
                    continue
                served = False
                self._deficit[tenant] = self._deficit.get(tenant, 0.0) + quantum
                while q and len(picked) < budget:
                    head = q[0]
                    cost = self._cost(head.req)
                    if self._deficit[tenant] < cost:
                        blocked_only = False  # still earning credit
                        break
                    if not self.engine.can_admit(head.req, planned_pages):
                        # pool/lane pressure: stays queued, credit capped to
                        # the head's cost so waiting never banks a burst
                        self._deficit[tenant] = min(self._deficit[tenant], cost)
                        break
                    q.popleft()
                    self._deficit[tenant] -= cost
                    planned_pages += self.engine.admission_pages(head.req)
                    picked.append(head)
                    progress = True
                    served = True
                if not q:
                    self._queues.pop(tenant, None)
                    self._deficit.pop(tenant, None)
                elif served:
                    # rotate a served tenant to the tail so the round robin
                    # PERSISTS across drive iterations — with a small slot
                    # budget per iteration, restarting the rotation from the
                    # same tenant every time would starve the rest
                    self._queues.move_to_end(tenant)
            if not self._queues:
                break
            if not progress and blocked_only:
                break  # every head is engine-blocked; wait for a step
        return picked

    def _admit_and_step(self, to_admit: list[_Pending]):
        """Worker-thread body: admissions (prefill — a device forward over
        the whole prompt, far too heavy for the event loop) and one
        decode step.  Exceptions are RETURNED, never raised: the drive loop
        must outlive any engine fault."""
        admitted: list[tuple[_Pending, Any, BaseException | None]] = []
        for p in to_admit:
            try:
                admitted.append((p, self.engine.admit(p.req), None))
            # ftc: ignore[silent-except] -- not swallowed: the failure is forwarded to the submitting caller via future.set_exception
            except Exception as e:  # PromptTooLong / bad request params
                admitted.append((p, None, e))
        step_err: BaseException | None = None
        finished: list[GenResult] = []
        if self.engine.active_requests:
            try:
                finished = self.engine.step()
            # ftc: ignore[silent-except] -- not swallowed: returned to the drive loop, which fails every in-flight future with it and logs
            except Exception as e:
                step_err = e
        return admitted, finished, step_err

    async def _drive(self) -> None:
        """Admit → step → resolve, forever; parks when fully idle.  All
        engine work (prefill admissions AND the decode step) runs in a
        worker thread so the control plane's event loop stays responsive."""
        while not self._closed:
            self._drop_expired()
            to_admit = self._select_admissions(self.engine.free_slots)
            if not to_admit and not self._inflight:
                self._wake.clear()
                try:
                    await asyncio.wait_for(
                        self._wake.wait(), timeout=self._park_timeout_s
                    )
                except asyncio.TimeoutError:
                    continue
                continue
            # register admissions as IN-FLIGHT before the worker thread runs:
            # while the thread admits them they are in neither _queue nor
            # _inflight otherwise, and a concurrent drain()/close() would
            # see an idle batcher and strand their futures forever
            for p in to_admit:
                self._inflight[p.req.request_id] = p
            steps_before = self.engine.steps_total
            admitted, finished, step_err = await asyncio.to_thread(
                self._admit_and_step, to_admit
            )
            if self.engine.steps_total > steps_before:
                self._step_stamps.append(time.monotonic())
            if self.ttft_observe is not None:
                now = time.monotonic()
                for p, _done, exc in admitted:
                    if exc is None:
                        try:
                            self.ttft_observe(now - p.enqueued_at)
                        except Exception:
                            logger.debug("ttft observe failed", exc_info=True)
            bounced: list[_Pending] = []
            for p, done, exc in admitted:
                rid = p.req.request_id
                if isinstance(exc, PoolExhausted):
                    # defense in depth: the selection gate should prevent
                    # this, but a transient exhaustion is BACKPRESSURE, not
                    # a request failure — put it back at the head of its
                    # tenant's queue and let pages free up
                    self._inflight.pop(rid, None)
                    if not p.future.done():
                        bounced.append(p)
                elif exc is not None:
                    self._inflight.pop(rid, None)
                    if not p.future.done():
                        p.future.set_exception(exc)
                elif done is not None:  # finished on admission (eos/max_new=1)
                    self._inflight.pop(rid, None)
                    self.completed_total += 1
                    self._observe_request_steps(done)
                    if not p.future.done():
                        p.future.set_result(done)
                elif p.future.done():
                    # resolved while the thread was admitting it (deadline
                    # drop or shutdown): free the lane the thread just
                    # filled — nobody is waiting on it
                    self._inflight.pop(rid, None)
                    self.engine.evict(rid)
            # reinsert pool-bounced requests at the head of their tenant
            # queues IN ARRIVAL ORDER (reversed appendleft: the first
            # bounced request must end up first in line again)
            for p in reversed(bounced):
                tenant = p.req.adapter_id or ""
                if tenant not in self._queues:
                    self._queues[tenant] = collections.deque()
                self._queues[tenant].appendleft(p)
            for result in finished:
                p = self._inflight.pop(result.request_id, None)
                self.completed_total += 1
                self._observe_request_steps(result)
                if p is not None and not p.future.done():
                    p.future.set_result(result)
            if step_err is not None:
                # the decode step died (OOM, CUDA fault, kernel launch error):
                # every in-flight request is lost — fail them LOUDLY instead
                # of hanging clients, free the lanes, keep serving.  The
                # error is also counted: a fleet health check treats a
                # faulting replica as crashed (teardown + restart with
                # backoff, docs/serving.md §Fleet).
                self.step_errors_total += 1
                self.last_step_error = step_err
                logger.exception("decode step failed; failing %d in-flight "
                                 "request(s)", len(self._inflight),
                                 exc_info=step_err)
                for rid, p in list(self._inflight.items()):
                    self.engine.evict(rid)
                    if not p.future.done():
                        p.future.set_exception(step_err)
                self._inflight.clear()

    # ---- observability ----------------------------------------------------

    def _observe_request_steps(self, result: GenResult) -> None:
        """EMA of decode steps per completed request (Retry-After input)."""
        steps = max(1, result.steps)
        if self._avg_request_steps is None:
            self._avg_request_steps = float(steps)
        else:
            self._avg_request_steps = (
                0.8 * self._avg_request_steps + 0.2 * steps
            )

    def stats(self) -> dict[str, Any]:
        pages = self.engine.kv_page_stats()
        return {
            "queue_depth": self.queue_depth,
            "slots_busy": self.slots_busy,
            "slots_total": self.engine.config.slots,
            "steps_total": self.engine.steps_total,
            "tokens_generated_total": self.engine.tokens_generated_total,
            "requests_completed_total": self.completed_total,
            "requests_rejected_total": self.rejected_total,
            "deadline_drops_total": self.deadline_drops_total,
            "step_errors_total": self.step_errors_total,
            "compilations": self.engine.compilations,
            # prefix-reuse KV cache (docs/serving.md) — all zeros when off
            "prefix_hits_total": self.engine.prefix_hits_total,
            "prefix_misses_total": self.engine.prefix_misses_total,
            "prefill_tokens_saved_total": self.engine.prefill_tokens_saved_total,
            "prefix_cache_bytes": self.engine.prefix_cache_bytes,
            "prefix_cache_entries": self.engine.prefix_cache_entries,
            # paged KV pool (docs/serving.md §Paged KV) — zeros when unpaged
            "kv_pages_total": pages.get("pages_total", 0),
            "kv_pages_free": pages.get("pages_free", 0),
            "kv_pages_used": pages.get("pages_used", 0),
            "kv_pages_shared": pages.get("pages_shared", 0),
            "kv_page_bytes": pages.get("page_bytes", 0),
            "kv_cow_copies_total": pages.get("cow_copies_total", 0),
            "kv_pool_exhaustions_total": pages.get(
                "pool_exhaustions_total", 0),
            # host KV tier (docs/serving.md §KV tiering) — zeros when off
            "kv_tier_host_pages_total": pages.get(
                "tier_host_pages_total", 0),
            "kv_tier_host_pages_used": pages.get("tier_host_pages_used", 0),
            "kv_tier_host_bytes": pages.get("tier_host_bytes", 0),
            "kv_demotions_total": pages.get("demotions_total", 0),
            "kv_restores_total": pages.get("restores_total", 0),
            # multi-tenant adapters (docs/serving.md §Multi-tenant adapters)
            "adapters_loaded": (
                len(self.engine.adapters)
                if self.engine.adapters is not None else 0
            ),
            "queue_depth_by_tenant": self.queue_depth_by_tenant(),
            "lanes_by_tenant": self.engine.active_by_tenant(),
            "tokens_by_tenant": dict(self.engine.tokens_by_tenant),
        }
