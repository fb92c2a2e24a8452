"""Request router over a replica fleet: spread, fail over, shed.

A copy of the reference's ``serve/router.py`` for the port's fleet (in
process or worker processes).  One router per served job.  Every request flows

    submit → pick replica (healthy, newest generation, least loaded)
           → replica batcher → result

with three robustness layers the single-engine plane never had:

* **failover**: a request whose replica dies mid-decode (or is draining)
  comes back as :class:`ReplicaUnavailable` — the router re-enqueues it on a
  survivor, excluding replicas it already failed on, up to a bounded retry
  budget and always under the request's ORIGINAL deadline (a failover must
  not silently extend an SLO).  Decode-step faults are classified with the
  resilience layer's :func:`classify_failure` — retryable classes fail over,
  deterministic per-request errors surface immediately;
* **exactly-once**: the per-request id is idempotent.  A duplicate submit of
  an id already in flight ATTACHES to the running attempt (one decode, one
  result); an id that already completed returns the cached result without
  touching an engine.  A failed attempt never produced a result (the dead
  replica evicted its lanes), so a retry can never double-complete;
* **load shedding**: when every healthy replica's queue is full — or a
  request's deadline provably cannot survive the current queue — the router
  sheds with :class:`QueueFull` carrying a ``Retry-After`` estimate derived
  from observed queue depth and decode rate, instead of letting doomed work
  pile onto the fleet.
"""

from __future__ import annotations

import asyncio
import collections
import logging
import time
from typing import Any

from ..resilience.policy import RETRYABLE, classify_failure
from .batcher import DeadlineExceeded, QueueFull, ReplicaUnavailable
from .engine import GenRequest, GenResult
from .fleet import Replica, ReplicaFleet

logger = logging.getLogger(__name__)


class FleetUnavailable(RuntimeError):
    """No healthy replica can take the request (HTTP 503 + Retry-After)."""

    def __init__(self, message: str, retry_after_s: float = 1.0):
        super().__init__(message)
        self.retry_after_s = retry_after_s


class ReplicaRouter:
    """Routes generate requests over a :class:`ReplicaFleet`."""

    def __init__(
        self,
        fleet: ReplicaFleet,
        *,
        default_timeout_s: float = 60.0,
        failover_retries: int = 2,
        completed_cache: int = 1024,
    ):
        self.fleet = fleet
        self.default_timeout_s = default_timeout_s
        #: extra attempts after the first (each on a replica not yet tried)
        self.failover_retries = max(0, failover_retries)
        #: request_id -> GenResult, bounded LRU — the double-completion fence
        self._completed: collections.OrderedDict[str, GenResult] = (
            collections.OrderedDict()
        )
        self._completed_cache = max(1, completed_cache)
        #: request_id -> future of the in-flight attempt (duplicate ids attach)
        self._inflight: dict[str, asyncio.Future] = {}
        # counters (/metrics + GET /admin/serve)
        self.routed_total = 0
        self.failovers_total = 0
        self.duplicates_suppressed_total = 0
        self.shed_total = 0
        self.completed_total = 0

    # ---- picking -----------------------------------------------------------

    def _pick(self, exclude: set[str],
              req: GenRequest | None = None) -> Replica | None:
        """Healthy, not yet tried, newest generation first (rollover traffic
        shift), then replicas whose KV page pool can host the request NOW
        (paged engines: a replica with slack decodes immediately where a
        page-starved one would queue), then least loaded."""
        candidates = [
            r for r in self.fleet.healthy_replicas()
            if r.replica_id not in exclude
        ]
        if not candidates:
            return None
        newest = max(r.generation for r in candidates)
        preferred = [r for r in candidates if r.generation == newest]

        def starved(r: Replica) -> int:
            if req is None:
                return 0
            slack = r.engine.kv_slack_pages()
            if slack is None:
                return 0
            return 0 if r.engine.admission_pages(req) <= slack else 1

        return min(preferred,
                   key=lambda r: (starved(r), r.load(), r.replica_id))

    def retry_after_s(self) -> float:
        """The fleet-wide backoff hint: the LEAST loaded healthy replica's
        drain estimate (that is where the retried request would land)."""
        healthy = self.fleet.healthy_replicas()
        if not healthy:
            return 1.0
        return min(r.batcher.retry_after_s() for r in healthy)

    # ---- submission --------------------------------------------------------

    def _record_completed(self, result: GenResult) -> None:
        self._completed[result.request_id] = result
        self._completed.move_to_end(result.request_id)
        while len(self._completed) > self._completed_cache:
            self._completed.popitem(last=False)

    async def submit(
        self, req: GenRequest, *, timeout_s: float | None = None
    ) -> GenResult:
        done = self._completed.get(req.request_id)
        if done is not None:
            # idempotent replay: the request already completed — never
            # decode it twice
            self.duplicates_suppressed_total += 1
            return done
        racing = self._inflight.get(req.request_id)
        if racing is not None:
            # same id already decoding: attach to the in-flight attempt
            self.duplicates_suppressed_total += 1
            return await asyncio.shield(racing)
        timeout = self.default_timeout_s if timeout_s is None else timeout_s
        deadline = None if timeout <= 0 else time.monotonic() + timeout
        future = asyncio.get_running_loop().create_future()
        self._inflight[req.request_id] = future
        try:
            result = await self._run(req, deadline)
            self._record_completed(result)
            self.completed_total += 1
            if not future.done():
                future.set_result(result)
            return result
        except BaseException as exc:
            if not future.done():
                future.set_exception(exc)
                future.exception()  # attached waiters or nobody: mark seen
            raise
        finally:
            self._inflight.pop(req.request_id, None)

    async def _run(self, req: GenRequest, deadline: float | None) -> GenResult:
        tried: set[str] = set()
        attempts = 0
        while True:
            if deadline is not None and time.monotonic() >= deadline:
                raise DeadlineExceeded(
                    f"request {req.request_id} spent its deadline failing over"
                )
            replica = self._pick(tried, req)
            if replica is None:
                if tried:
                    # every healthy replica was tried and refused/died
                    self.shed_total += 1
                    raise QueueFull(
                        "all healthy replicas are at capacity; retry later",
                        retry_after_s=self.retry_after_s(),
                    )
                raise FleetUnavailable(
                    f"no healthy replica for job {self.fleet.job_id!r}",
                    retry_after_s=2.0,
                )
            # early shed: with a queue already formed and a measured decode
            # rate, a request whose deadline cannot survive the wait is
            # doomed work — bounce it NOW with a useful Retry-After instead
            # of letting it time out in line
            if deadline is not None and replica.batcher.queue_depth > 0:
                eta = replica.batcher.retry_after_s()
                if eta > 1.0 and time.monotonic() + eta > deadline:
                    self.shed_total += 1
                    raise QueueFull(
                        f"estimated queue wait {eta:.1f}s exceeds the "
                        "request deadline; shedding", retry_after_s=eta,
                    )
            self.routed_total += 1
            try:
                # timeout_s=0 when deadline is None: an explicitly
                # unlimited request must not have the batcher re-mint its
                # default deadline
                result = await replica.batcher.submit(
                    req, deadline=deadline,
                    timeout_s=0 if deadline is None else None,
                )
                result.replica_id = replica.replica_id
                return result
            except (ReplicaUnavailable, ConnectionError) as exc:
                # the replica died or drained before delivering a result (in
                # process, or as a worker process whose socket broke), so
                # failover is safe
                tried.add(replica.replica_id)
                attempts += 1
                if attempts > self.failover_retries:
                    raise
                self.failovers_total += 1
                logger.warning(
                    "request %s failing over (attempt %d/%d): %s",
                    req.request_id, attempts, self.failover_retries, exc,
                )
                continue
            except QueueFull:
                # this replica is full — try a less loaded survivor; the
                # all-full case surfaces via the _pick(None)+tried branch
                tried.add(replica.replica_id)
                continue
            except (DeadlineExceeded, ValueError):
                raise  # per-request: a retry would fail identically
            except Exception as exc:
                # decode-step fault delivered to this request's future —
                # classify like any other failure: retryable classes fail
                # over (the work is fine, the replica was not), terminal
                # ones surface
                tried.add(replica.replica_id)
                attempts += 1
                failure = classify_failure(None, str(exc))
                if failure in RETRYABLE and attempts <= self.failover_retries:
                    self.failovers_total += 1
                    logger.warning(
                        "request %s failing over after %s fault (attempt "
                        "%d/%d): %s", req.request_id, failure.value,
                        attempts, self.failover_retries, exc,
                    )
                    continue
                raise

    # ---- observability -----------------------------------------------------

    def stats(self) -> dict[str, Any]:
        return {
            "routed_total": self.routed_total,
            "failovers_total": self.failovers_total,
            "duplicates_suppressed_total": self.duplicates_suppressed_total,
            "shed_total": self.shed_total,
            "router_completed_total": self.completed_total,
        }
