"""Replica fleet: N health-checked engine replicas behind one served job.

Counterpart of the reference's ``serve/fleet.py``.  Promoted checkpoints
are immutable artifacts, so replicas are cattle; this module owns the herd
for one job:

* each :class:`Replica` is a full serving stack, in one of two modes:
  - in process (``transport=None``): its own :class:`~.engine.BatchEngine`
    + :class:`~.batcher.Batcher`.  Replicas share ONE model's weights:
    every engine holds the same ``model`` and owns only its KV cache, page
    pool, prefix cache and tenant stacks, so two replicas of an 8B model do
    not hold two copies of its 16 GB.  An engine never writes the model, so
    a replica that fails leaves nothing of it half-changed, and a respawn
    builds a new engine around the same module;
  - a worker process each (``transport=`` a
    :class:`~..transport.process.ProcessTransport`): the replica's
    ``batcher`` is a :class:`~..transport.client.RemoteReplica` with the
    same surface; each worker rebuilds the model from the transport's
    payload (a staged deploy dir) in its own process, and the control
    plane holds no weights;
* **health**: a replica with work in flight whose engine stops completing
  decode steps for ``stall_timeout_s`` — or whose drive loop survives a
  decode-step fault — is marked unhealthy, torn down (its requests fail
  with :class:`~.batcher.ReplicaUnavailable`, which the router retries on a
  survivor), and restarted with the resilience layer's seeded
  decorrelated-jitter backoff (``resilience/policy.py::RetryPolicy``) under
  a bounded attempt budget;
* **drain** is the only way capacity leaves the fleet voluntarily: new
  admissions stop, queued requests bounce retryably, in-flight lanes finish
  (checkpoint rollover and scale-down both go through it, never a kill);
* **rollover** spins replicas on the NEW model first, shifts traffic (the
  router prefers the newest generation), and only then drains the old
  generation — no stop-the-world swap;
* the seeded chaos hand (``resilience/faults.py::ServeFaultInjector``) can
  kill or wedge a chosen replica at a chosen decode step.
"""

from __future__ import annotations

import asyncio
import dataclasses
import enum
import itertools
import logging
import time
from typing import Any, Awaitable, Callable

from ..resilience.faults import ServeFaultInjector
from ..resilience.policy import RETRYABLE, RetryPolicy, classify_failure
from .batcher import Batcher, ReplicaUnavailable
from .engine import BatchEngine, EngineConfig, warm_engine

logger = logging.getLogger(__name__)


class AdapterBusy(RuntimeError):
    """Unload refused: the tenant still has requests queued or in flight."""


class ReplicaState(str, enum.Enum):
    HEALTHY = "healthy"
    DRAINING = "draining"
    FAILED = "failed"
    STOPPED = "stopped"


@dataclasses.dataclass
class Replica:
    """One serving stack inside the fleet — in process (``batcher`` is a
    :class:`Batcher`) or a worker process (``batcher`` is a
    :class:`~..transport.client.RemoteReplica`, which has the same
    surface)."""

    replica_id: str
    generation: int
    batcher: Any
    remote: bool = False
    state: ReplicaState = ReplicaState.HEALTHY
    started_at: float = 0.0
    #: clock reading when the engine last made observable progress (a decode
    #: step completed, or the replica was verifiably idle) — the health lease
    last_progress: float = 0.0
    last_steps_total: int = 0
    last_step_errors: int = 0

    @property
    def engine(self) -> BatchEngine:
        return self.batcher.engine

    @property
    def healthy(self) -> bool:
        return self.state is ReplicaState.HEALTHY

    def load(self) -> int:
        """Routing weight: queued + decoding requests on this replica."""
        return self.batcher.queue_depth + self.batcher.slots_busy

    def stats(self) -> dict[str, Any]:
        return {
            "state": self.state.value,
            "generation": self.generation,
            **self.batcher.stats(),
        }


@dataclasses.dataclass
class _PendingRestart:
    due_at: float
    prev_delay_s: float
    reason: str


class ReplicaFleet:
    """The replica set for one served job.

    ``model`` is the loaded serving model, shared by every in-process
    replica; engine construction (cache allocation, warm-up) runs in a
    worker thread.  With ``transport`` the replicas are worker processes and
    ``model`` is None: the control plane never holds serving weights.
    ``event_cb`` (async, best-effort) lands fleet lifecycle events on the
    job's timeline (the serve manager passes one).
    """

    #: per-replica stats that are cumulative COUNTERS: folded into
    #: ``_retired_totals`` when a replica leaves so aggregates never regress
    _COUNTER_KEYS = (
        "steps_total", "tokens_generated_total", "requests_completed_total",
        "requests_rejected_total", "deadline_drops_total",
        "step_errors_total", "prefix_hits_total", "prefix_misses_total",
        "prefill_tokens_saved_total", "kv_cow_copies_total",
        "kv_pool_exhaustions_total", "kv_demotions_total",
        "kv_restores_total",
    )
    #: point-in-time gauges: summed over LIVE replicas only
    _GAUGE_KEYS = (
        "queue_depth", "slots_busy", "slots_total", "compilations",
        "prefix_cache_bytes", "prefix_cache_entries",
        "kv_pages_total", "kv_pages_free", "kv_pages_used",
        "kv_pages_shared", "kv_tier_host_pages_total",
        "kv_tier_host_pages_used", "kv_tier_host_bytes",
    )
    #: per-tenant counter DICTS ({adapter_id: n}): folded like the scalar
    #: counters so retired replicas' tenant tokens never regress
    _DICT_COUNTER_KEYS = ("tokens_by_tenant",)
    #: per-tenant gauge dicts: summed over live replicas only
    _DICT_GAUGE_KEYS = ("queue_depth_by_tenant", "lanes_by_tenant")

    def __init__(
        self,
        job_id: str,
        model: Any,
        engine_config: EngineConfig,
        *,
        replicas: int = 1,
        batcher_kwargs: dict[str, Any] | None = None,
        stall_timeout_s: float = 15.0,
        drain_timeout_s: float = 30.0,
        restart_policy: RetryPolicy | None = None,
        fault: ServeFaultInjector | None = None,
        warm_start: bool = True,
        adapters: "Any | None" = None,
        event_cb: Callable[..., Awaitable[Any]] | None = None,
        transport: "Any | None" = None,
        reward_spec: "dict[str, Any] | None" = None,
    ):
        self.job_id = job_id
        #: the spec section every spawn gets when the served job is a
        #: ``task: reward`` model: its workers load the head and answer the
        #: batched ``reward_score`` RPC (``prefs/rollout_plane.py::
        #: RewardScorer``).  Process mode only: in-process replicas have no
        #: RPC surface to answer it on
        self.reward_spec = dict(reward_spec) if reward_spec else None
        #: cross-process mode: a ``transport/process.py::ProcessTransport``
        #: (or anything with its ``spawn``/``mode`` surface)
        self.transport = transport
        if transport is None and model is None:
            raise ValueError(
                "an in-process fleet needs a model; pass a transport for "
                "process-mode replicas"
            )
        #: the serving model every replica's engine shares
        self._model = model
        self._engine_config = engine_config
        #: shared multi-tenant adapter registry (serve/adapters.py); every
        #: replica engine holds its own stacks, synced here on
        #: register/unregister/spawn/rollover
        self.adapters = adapters
        self.target_replicas = max(1, replicas)
        self._batcher_kwargs = dict(batcher_kwargs or {})
        self.stall_timeout_s = stall_timeout_s
        self.drain_timeout_s = drain_timeout_s
        #: restart budget + backoff for crashed/stuck replicas — the same
        #: policy shape the training retry supervisor runs
        self.restart_policy = restart_policy or RetryPolicy()
        self._fault = fault if fault is not None \
            else ServeFaultInjector.from_env()
        #: pay every first-use cost at spawn, BEFORE the replica takes
        #: traffic (``engine.warm_engine``)
        self.warm_start = warm_start
        self.generation = 0
        self._replicas: dict[str, Replica] = {}
        self._seq = itertools.count()
        self._restarts_pending: list[_PendingRestart] = []
        #: consecutive failed/stuck replicas since the fleet last looked
        #: fully healthy — the restart policy's attempt counter
        self._failure_streak = 0
        #: last backoff delay handed out this streak — feeds next_delay so
        #: the decorrelated-jitter schedule actually grows across a crash
        #: loop (reset when the streak resets)
        self._last_restart_delay: float | None = None
        self._health_task: asyncio.Task | None = None
        self._closed = False
        self._event_cb = event_cb
        # counters (/metrics + GET /admin/serve)
        self.replica_restarts_total = 0
        self.replicas_failed_total = 0
        self.drains_total = 0
        self.rollovers_total = 0
        #: counter totals folded in from replicas that left the fleet —
        #: the aggregate /metrics counters must stay monotonic across
        #: drains/restarts/rollovers
        self._retired_totals: dict[str, int] = {
            k: 0 for k in self._COUNTER_KEYS
        }
        self._retired_dict_totals: dict[str, dict[str, int]] = {
            k: {} for k in self._DICT_COUNTER_KEYS
        }

    # ---- events ------------------------------------------------------------

    async def _event(self, event: str, **attrs) -> None:
        if self._event_cb is None:
            return
        try:
            await self._event_cb(event, **attrs)
        # logged: a timeline write must never fail the fleet operation
        except Exception:
            logger.debug("fleet event %s failed", event, exc_info=True)

    # ---- lifecycle ---------------------------------------------------------

    async def start(self) -> None:
        """Spawn the initial replica set.  Worker processes spawn
        CONCURRENTLY (each builds in its own process: the wall clock is one
        spawn, not the fleet size times one); in-process engines build one
        after another."""
        if self.transport is not None:
            await asyncio.gather(
                *(self.spawn_replica() for _ in range(self.target_replicas))
            )
            return
        for _ in range(self.target_replicas):
            await self.spawn_replica()

    def _build_engine(self) -> BatchEngine:
        """Worker-thread body: construct and (by default) warm an engine
        around the shared model."""
        engine = BatchEngine(self._model, self._engine_config, adapters=self.adapters)
        if self.warm_start:
            warm_engine(engine)
        return engine

    async def spawn_replica(self) -> Replica:
        """Put one replica in service: build an engine in a worker thread
        (it syncs the adapter registry while it is built), or spawn and
        handshake a worker process (transport) and sync the adapter
        registry onto it."""
        rid = f"r{next(self._seq)}"
        if self.transport is not None:
            batcher = await self.transport.spawn(
                rid, self.generation,
                engine_config=self._engine_config,
                batcher_kwargs=self._batcher_kwargs,
                adapters=self.adapters,
                warm_start=self.warm_start,
                reward=self.reward_spec,
            )
            if self.adapters is not None and len(self.adapters):
                try:
                    from .adapters import entry_to_wire

                    wires = await asyncio.to_thread(
                        lambda: [entry_to_wire(e) for e in self.adapters.entries()]
                    )
                    await batcher.stack_sync(wires)
                except BaseException:
                    # the worker is alive but not in _replicas yet: nothing
                    # else would ever kill it
                    await batcher.close()
                    raise
            remote = True
        else:
            engine = await asyncio.to_thread(self._build_engine)
            if self._fault is not None and self._fault.arm(rid, engine):
                logger.warning("replica %s armed with a serve fault", rid)
            batcher = Batcher(engine, **self._batcher_kwargs)
            remote = False
        now = time.monotonic()
        replica = Replica(
            replica_id=rid, generation=self.generation, batcher=batcher,
            remote=remote, started_at=now, last_progress=now,
        )
        self._replicas[rid] = replica
        await self._event(
            "serve-replica-started", replica=rid, generation=self.generation,
            transport=self.transport_mode,
        )
        logger.info("serve replica %s started (job=%s gen=%d transport=%s)", rid,
                    self.job_id, self.generation, self.transport_mode)
        return replica

    @property
    def transport_mode(self) -> str:
        return getattr(self.transport, "mode", None) or "inproc"

    # ---- multi-tenant adapters ---------------------------------------------

    async def register_adapter(self, adapter_id: str, lora_tree: Any,
                               alpha: float, rank: int,
                               meta: dict[str, Any] | None = None) -> int:
        """Register a tenant and install its stacks on EVERY live replica
        (each install runs in a worker thread under that engine's lock, so
        no decode step reads a half-written slot).  Replicas spawned or
        rolled over later sync from the registry at build time."""
        if self.adapters is None:
            raise RuntimeError(
                "fleet has no adapter registry (serve_max_adapters=0)"
            )
        refresh = self.adapters.get(adapter_id) is not None
        entry = self.adapters.register(adapter_id, lora_tree, alpha, rank,
                                       meta=meta)
        entry_wire = None
        if any(r.remote for r in self._replicas.values()):
            from .adapters import entry_to_wire

            entry_wire = await asyncio.to_thread(entry_to_wire, entry)
        for replica in list(self._replicas.values()):
            if replica.remote:
                # registry-sync RPC: the worker registers, installs and (on
                # refresh) drops the namespace itself, in this order
                await replica.batcher.adapter_register(entry_wire, refresh=refresh)
                continue
            await asyncio.to_thread(replica.engine.install_adapter, adapter_id)
            if refresh:
                # tenant rollover: the deltas changed, so KV cached under
                # the old weights is poison for the new ones.  Drop AFTER
                # the install: an admission racing the drop can only
                # re-seed the namespace with new-weight KV
                await asyncio.to_thread(replica.engine.drop_prefix_namespace, adapter_id)
        await self._event(
            "serve-adapter-loaded", adapter=adapter_id, slot=entry.slot,
            rank=rank,
        )
        logger.info("adapter %s installed on %d replica(s) (job=%s slot=%d)",
                    adapter_id, len(self._replicas), self.job_id, entry.slot)
        return entry.slot

    async def unregister_adapter(self, adapter_id: str) -> None:
        """Remove a tenant: refuses while the tenant has queued or decoding
        requests anywhere in the fleet (its slot id may be reused — evicting
        live lanes would hand their KV to a stranger), then zeroes the slot
        and drops the tenant's prefix-cache namespace on every replica."""
        if self.adapters is None:
            raise RuntimeError(
                "fleet has no adapter registry (serve_max_adapters=0)"
            )
        busy = 0
        for replica in self._replicas.values():
            # tenant_busy covers the admission window the engine's lane view
            # misses (a request mid-admit in the worker thread has no lane
            # yet but HAS already resolved its adapter slot)
            busy += await replica.batcher.tenant_busy(adapter_id)
        if busy:
            raise AdapterBusy(
                f"adapter {adapter_id!r} has {busy} request(s) in flight or "
                "queued; drain them (or wait) before unloading"
            )
        entry = self.adapters.unregister(adapter_id)
        for replica in list(self._replicas.values()):
            if replica.remote:
                await replica.batcher.adapter_unregister(adapter_id)
                continue
            await asyncio.to_thread(
                replica.engine.remove_adapter, adapter_id, entry.slot
            )
        await self._event("serve-adapter-unloaded", adapter=adapter_id)

    def healthy_replicas(self) -> list[Replica]:
        return [r for r in self._replicas.values() if r.healthy]

    @property
    def replicas(self) -> dict[str, Replica]:
        return self._replicas

    async def drain_replica(self, replica_id: str, *, reason: str) -> bool:
        """Graceful removal: no new admissions, queued requests bounce
        retryably, in-flight lanes finish (bounded by ``drain_timeout_s``).
        The ONLY path scale-down and rollover use — never a kill."""
        replica = self._replicas.get(replica_id)
        if replica is None or replica.state in (
            ReplicaState.DRAINING, ReplicaState.STOPPED
        ):
            return False
        replica.state = ReplicaState.DRAINING
        self.drains_total += 1
        drained = await replica.batcher.drain(self.drain_timeout_s)
        replica.state = ReplicaState.STOPPED
        self._retire(replica)
        self._replicas.pop(replica_id, None)
        await self._event(
            "serve-replica-drained", replica=replica_id, reason=reason,
            clean=drained,
        )
        logger.info("serve replica %s drained (%s, clean=%s)",
                    replica_id, reason, drained)
        return drained

    async def fail_replica(
        self, replica_id: str, *, error: str, restart: bool = True
    ) -> None:
        """Immediate teardown of a crashed/stuck replica: its requests fail
        with :class:`ReplicaUnavailable` (the router re-enqueues them on a
        survivor) and a restart is scheduled with backoff when the attempt
        budget allows."""
        replica = self._replicas.pop(replica_id, None)
        if replica is None:
            return
        replica.state = ReplicaState.FAILED
        self.replicas_failed_total += 1
        self._retire(replica)
        await replica.batcher.close(ReplicaUnavailable(
            f"replica {replica_id} torn down: {error}"
        ))
        failure = classify_failure(None, error)
        self._failure_streak += 1
        await self._event(
            "serve-replica-unhealthy", replica=replica_id, error=error,
            failure_class=failure.value,
        )
        if not restart or self._closed:
            return
        if failure in RETRYABLE \
                and self._failure_streak <= self.restart_policy.max_attempts:
            delay = self.restart_policy.next_delay(self._last_restart_delay)
            self._last_restart_delay = delay
            self._restarts_pending.append(_PendingRestart(
                due_at=time.monotonic() + delay, prev_delay_s=delay, reason=error,
            ))
            logger.warning(
                "serve replica %s failed (%s); restart in %.1fs "
                "(streak %d/%d)", replica_id, error, delay,
                self._failure_streak, self.restart_policy.max_attempts,
            )
        elif not self._replicas and not self._restarts_pending:
            # budget spent AND the fleet just hit ZERO replicas: a fully
            # dead fleet with no pending restart would 503 forever (and,
            # under autoscale, hold its admitted chips against training
            # indefinitely).  Keep exactly one slow revival probe pending
            # at the backoff ceiling — bounded cadence, never a storm.
            delay = self.restart_policy.max_delay_s
            self._last_restart_delay = delay
            self._restarts_pending.append(_PendingRestart(
                due_at=time.monotonic() + delay, prev_delay_s=delay,
                reason=f"revival probe after: {error}",
            ))
            logger.error(
                "serve replica %s failed (%s); restart budget exhausted "
                "(%d/%d) and no replicas remain — probing revival every "
                "%.0fs", replica_id, error, self._failure_streak,
                self.restart_policy.max_attempts, delay,
            )
        else:
            logger.error(
                "serve replica %s failed (%s); restart budget exhausted "
                "(%d/%d) — fleet degraded to %d replica(s)",
                replica_id, error, self._failure_streak,
                self.restart_policy.max_attempts, len(self._replicas),
            )

    # ---- health ------------------------------------------------------------

    async def health_tick(self) -> dict[str, list[str]]:
        """One health pass: catch faulted and stalled replicas, run due
        restarts.  Returns the actions taken (tests assert on them).  Every
        replica answers ONE :meth:`~.batcher.Batcher.health_probe`."""
        now = time.monotonic()
        actions: dict[str, list[str]] = {"failed": [], "restarted": []}
        checked = [r for r in list(self._replicas.values()) if r.healthy]

        async def probe_one(replica: Replica):
            try:
                return await replica.batcher.health_probe(), None
            # not swallowed: a failed probe fails the replica below
            except Exception as exc:
                return None, exc

        probes = await asyncio.gather(*(probe_one(r) for r in checked))
        for replica, (probe, probe_err) in zip(checked, probes):
            if replica.replica_id not in self._replicas \
                    or not replica.healthy:
                # removed by an earlier failure this tick, or a concurrent
                # drain flipped it mid-probe (failing it here would
                # double-retire its counters and queue a spurious restart)
                continue
            if probe_err is not None:
                # the replica cannot prove liveness: fail + restart it
                actions["failed"].append(replica.replica_id)
                await self.fail_replica(
                    replica.replica_id,
                    error=f"liveness probe failed: {probe_err}",
                )
                continue
            if probe["step_errors_total"] > replica.last_step_errors:
                # the drive loop survived a decode fault (it keeps serving),
                # but a faulting engine is a crashed replica from the
                # fleet's point of view: tear down + restart with backoff
                actions["failed"].append(replica.replica_id)
                await self.fail_replica(
                    replica.replica_id,
                    error=f"decode step fault: {probe['last_step_error']}",
                )
                continue
            if probe["steps_total"] > replica.last_steps_total \
                    or probe["slots_busy"] == 0:
                replica.last_steps_total = probe["steps_total"]
                replica.last_progress = now
            elif now - replica.last_progress > self.stall_timeout_s:
                # work in flight, no decode step completing: the
                # stuck-decode shape — the replica holds lanes forever and
                # only this active check can reclaim them
                actions["failed"].append(replica.replica_id)
                await self.fail_replica(
                    replica.replica_id,
                    error=(
                        f"stuck decode: no step completed in "
                        f"{now - replica.last_progress:.1f}s with "
                        f"{probe['slots_busy']} request(s) in flight"
                    ),
                )
                continue
        if not self._restarts_pending \
                and len(self._replicas) >= self.target_replicas \
                and all(r.healthy for r in self._replicas.values()):
            # fleet fully healthy again: a future failure is a fresh
            # incident, not attempt N+1 of this one
            self._failure_streak = 0
            self._last_restart_delay = None
        due = [p for p in self._restarts_pending if p.due_at <= now]
        for pending in due:
            self._restarts_pending.remove(pending)
            if self._closed or len(self._replicas) >= self.target_replicas:
                continue
            try:
                replica = await self.spawn_replica()
            # not swallowed: logged and rescheduled with grown backoff
            except Exception:
                # a spawn can itself fail (out of device memory for a new
                # cache); reschedule the restart with the next backoff step
                # instead of silently dropping the slot from the fleet
                delay = self.restart_policy.next_delay(self._last_restart_delay)
                self._last_restart_delay = delay
                self._restarts_pending.append(_PendingRestart(
                    due_at=time.monotonic() + delay, prev_delay_s=delay,
                    reason=f"respawn failed after: {pending.reason}",
                ))
                logger.exception(
                    "serve replica respawn failed (job=%s); retrying in "
                    "%.1fs", self.job_id, delay,
                )
                continue
            self.replica_restarts_total += 1
            if replica.remote:
                from ..transport import incr as transport_incr

                transport_incr("worker_respawns_total")
            actions["restarted"].append(replica.replica_id)
            await self._event(
                "serve-replica-restarted", replica=replica.replica_id,
                after=pending.reason,
            )
        return actions

    def start_health_loop(self, interval_s: float) -> None:
        """Background health checks at ``interval_s`` (restarted if dead)."""
        if self._health_task is None or self._health_task.done():
            self._health_task = asyncio.get_running_loop().create_task(
                self._health_loop(max(0.05, interval_s))
            )

    async def _health_loop(self, interval_s: float) -> None:
        while not self._closed:
            try:
                await self.health_tick()
            # logged: the health loop must outlive any single tick's failure
            except Exception:
                logger.exception("fleet health tick failed (job=%s)",
                                 self.job_id)
            await asyncio.sleep(interval_s)

    # ---- rollover ----------------------------------------------------------

    async def rollover(self, model: Any, *, reason: str = "checkpoint rollover") -> None:
        """Zero-downtime model swap: spin up the new generation FIRST
        around ``model``, shift traffic (the router prefers the newest
        generation), then drain the old generation — in-flight lanes finish
        on the weights they started on.

        Process mode: the caller repoints the transport's payload (a freshly
        staged deploy dir) BEFORE calling this with ``model=None``; the new
        generation's workers rebuild from it."""
        old = [r for r in self._replicas.values() if r.healthy]
        if self.transport is None:
            self._model = model
        self.generation += 1
        self.rollovers_total += 1
        await self._event(
            "serve-rollover-started", generation=self.generation,
            reason=reason, old_replicas=len(old),
        )
        if self.transport is not None:
            await asyncio.gather(
                *(self.spawn_replica() for _ in range(max(1, len(old))))
            )
        else:
            for _ in range(max(1, len(old))):
                await self.spawn_replica()
        await asyncio.gather(*(
            self.drain_replica(r.replica_id, reason=reason) for r in old
        ))
        await self._event(
            "serve-rollover-completed", generation=self.generation,
        )

    async def close(self) -> None:
        self._closed = True
        if self._health_task is not None:
            self._health_task.cancel()
            try:
                await self._health_task
            except asyncio.CancelledError:
                pass
            self._health_task = None
        for replica in list(self._replicas.values()):
            await replica.batcher.close()
        self._replicas.clear()

    # ---- observability -----------------------------------------------------

    @staticmethod
    def _sum_dicts(into: dict[str, int], add: dict[str, int]) -> dict[str, int]:
        for k, v in (add or {}).items():
            into[k] = into.get(k, 0) + v
        return into

    def _retire(self, replica: Replica) -> None:
        stats = replica.batcher.stats()
        for key in self._COUNTER_KEYS:
            self._retired_totals[key] += stats.get(key, 0)
        for key in self._DICT_COUNTER_KEYS:
            self._sum_dicts(self._retired_dict_totals[key], stats.get(key))

    def stats(self) -> dict[str, Any]:
        """The PR-4 aggregate stats shape every existing consumer reads —
        counters are monotonic (retired replicas' totals folded in), gauges
        sum over live replicas — plus the per-replica rows."""
        replicas = {rid: r.stats() for rid, r in self._replicas.items()}
        agg: dict[str, Any] = {
            k: sum(r.get(k, 0) for r in replicas.values())
            for k in self._GAUGE_KEYS
        }
        for k in self._COUNTER_KEYS:
            agg[k] = self._retired_totals[k] + sum(
                r.get(k, 0) for r in replicas.values()
            )
        for k in self._DICT_COUNTER_KEYS:
            total = dict(self._retired_dict_totals[k])
            for r in replicas.values():
                self._sum_dicts(total, r.get(k) or {})
            agg[k] = total
        for k in self._DICT_GAUGE_KEYS:
            total: dict[str, int] = {}
            for r in replicas.values():
                self._sum_dicts(total, r.get(k) or {})
            agg[k] = total
        agg["adapters_loaded"] = (
            len(self.adapters) if self.adapters is not None else 0
        )
        agg["adapters"] = (
            self.adapters.stats()["adapters"]
            if self.adapters is not None else {}
        )
        agg.update({
            "replicas": replicas,
            "replicas_total": len(replicas),
            "replicas_healthy": sum(
                1 for r in self._replicas.values() if r.healthy
            ),
            "replicas_draining": sum(
                1 for r in self._replicas.values()
                if r.state is ReplicaState.DRAINING
            ),
            "generation": self.generation,
            "target_replicas": self.target_replicas,
            "transport": self.transport_mode,
            "worker_pids": sorted(
                r.batcher.pid for r in self._replicas.values() if r.remote
            ),
            "replica_restarts_total": self.replica_restarts_total,
            "replicas_failed_total": self.replicas_failed_total,
            "drains_total": self.drains_total,
            "rollovers_total": self.rollovers_total,
            "restarts_pending": len(self._restarts_pending),
        })
        return agg
