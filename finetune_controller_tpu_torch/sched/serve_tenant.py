"""Serve capacity as a first-class, preemptible scheduler tenant.

Training already competes for chips through the fair-share scheduler; this
module makes serving compete the same way instead of squatting outside the
quota math (docs/scheduling.md §Serve tenant, docs/serving.md §Autoscale):

* every fleet replica is one scheduler :class:`Workload` tagged
  ``owner="serve"`` in a (by default low-priority) serve queue — training
  tenants can preempt it, and its chips count against a real queue's share;
* the **autoscaler** (:class:`ServeScalePolicy`) watches router/fleet stats:
  sustained queue-depth pressure grows the fleet one replica at a time (each
  grow is a scheduler submit — it only materialises when admitted), and a
  sustained idle window shrinks it back toward the floor, returning chips to
  training;
* **shrink goes through drain, never kill**: a scale-down (or a training
  tenant preempting a serve workload) drains the replica — in-flight lanes
  finish — and only then releases the workload, so the chips a training job
  reclaims were freed gracefully and are admittable on the very next
  scheduler tick.

The tenant is deliberately pull-based: :meth:`ServeTenant.tick` is called
from the fleet's health cadence (or a test), reads the scheduler's decisions
(``take_preemptions(owner="serve")``, ``is_admitted``) and converges the
fleet toward them.  With ``drive_admission=True`` (standalone use, tests)
the tenant runs ``try_admit`` itself; when sharing a backend's scheduler the
backend's own tick does the admitting and the tenant just polls.
"""

from __future__ import annotations

import dataclasses
import itertools
import logging
from typing import Any

logger = logging.getLogger(__name__)

#: default tenant queue serve replicas land in (auto-registers at weight 1.0
#: unless named in FTC_SCHED_QUEUES)
SERVE_QUEUE = "serve"

#: default queue for remote rlhf rollout actor workloads (``owner="rollout"``
#: — the disaggregated data plane's serve-fleet tenants,
#: docs/preference.md §Disaggregated rollouts)
ROLLOUT_QUEUE = "rollout"


class ServeScalePolicy:
    """Queue-depth pressure → target replica count, with hysteresis.

    Pressure = queued requests per healthy replica at or above
    ``scale_up_queue_depth`` for ``sustain_ticks`` consecutive ticks → +1
    replica.  A fully idle fleet (no queue, no busy slots) for
    ``idle_ticks`` consecutive ticks → -1 replica.  Both counters reset on
    any contrary observation, so a single traffic blip neither grows nor
    shrinks the fleet — scale moves cost real chips and real drains.
    """

    def __init__(
        self,
        *,
        min_replicas: int = 1,
        max_replicas: int = 4,
        scale_up_queue_depth: int = 8,
        sustain_ticks: int = 2,
        idle_ticks: int = 3,
    ):
        if min_replicas < 1 or max_replicas < min_replicas:
            raise ValueError(
                f"need 1 <= min_replicas <= max_replicas, got "
                f"{min_replicas}..{max_replicas}"
            )
        self.min_replicas = min_replicas
        self.max_replicas = max_replicas
        self.scale_up_queue_depth = scale_up_queue_depth
        self.sustain_ticks = max(1, sustain_ticks)
        self.idle_ticks = max(1, idle_ticks)
        self._pressure = 0
        self._idle = 0

    def decide(
        self, *, healthy: int, queue_depth: int, slots_busy: int
    ) -> int:
        """Target replica count given the current fleet observation."""
        current = max(healthy, 1)
        per_replica = queue_depth / current
        if per_replica >= self.scale_up_queue_depth:
            self._pressure += 1
            self._idle = 0
        elif queue_depth == 0 and slots_busy == 0:
            self._idle += 1
            self._pressure = 0
        else:
            self._pressure = 0
            self._idle = 0
        target = healthy
        if self._pressure >= self.sustain_ticks:
            target = healthy + 1
            self._pressure = 0
        elif self._idle >= self.idle_ticks:
            target = healthy - 1
            self._idle = 0
        return min(self.max_replicas, max(self.min_replicas, target))


@dataclasses.dataclass
class _ReplicaWorkload:
    workload_id: str
    #: fleet replica id once the admitted workload materialised (None =
    #: still pending admission, or spawn in flight)
    replica_id: str | None = None


class ServeTenant:
    """Binds one :class:`~finetune_controller_tpu_torch.serve.fleet.ReplicaFleet`
    to a :class:`~finetune_controller_tpu_torch.sched.FairShareScheduler`."""

    def __init__(
        self,
        scheduler,
        fleet,
        *,
        flavor: str,
        queue: str = SERVE_QUEUE,
        priority: object = "low",
        policy: ServeScalePolicy | None = None,
        drive_admission: bool = False,
        queue_depth_fn=None,
        owner: str = "serve",
    ):
        self.scheduler = scheduler
        self.fleet = fleet
        self.flavor = flavor
        self.queue = queue
        self.priority = priority
        #: scheduler workload tag — ``take_preemptions(owner=...)`` routes
        #: reclaim decisions to the tenant that owns them; the rollout
        #: tenant reuses this class's machinery under ``owner="rollout"``
        self.owner = owner
        self.policy = policy or ServeScalePolicy()
        #: run ``try_admit`` inside :meth:`tick` (standalone scheduler);
        #: False when a backend's own tick drives admission
        self.drive_admission = drive_admission
        #: optional override for the observed queue depth (a router exposes
        #: fleet-wide depth; default reads the fleet's aggregate stats)
        self._queue_depth_fn = queue_depth_fn
        self._workloads: dict[str, _ReplicaWorkload] = {}
        self._wl_seq = itertools.count()
        # counters (GET /admin/serve, docs/serving.md §Autoscale)
        self.scale_ups_total = 0
        self.scale_downs_total = 0
        self.preempted_total = 0

    # ---- bookkeeping -------------------------------------------------------

    def _bound(self) -> int:
        """Replica workloads submitted (pending or admitted)."""
        return len(self._workloads)

    def _observe(self) -> dict[str, int]:
        stats = self.fleet.stats()
        depth = (
            self._queue_depth_fn() if self._queue_depth_fn is not None
            else stats["queue_depth"]
        )
        return {
            "healthy": stats["replicas_healthy"],
            "queue_depth": int(depth),
            "slots_busy": stats["slots_busy"],
        }

    async def attach_initial(self) -> None:
        """Register workloads for replicas the fleet already runs (the fleet
        starts before the tenant; its floor capacity must still be
        accounted against the serve queue's share)."""
        for replica in self.fleet.healthy_replicas():
            wid = self._submit_workload()
            self._workloads[wid].replica_id = replica.replica_id

    def _submit_workload(self) -> str:
        wid = f"{self.owner}-{self.fleet.job_id}-w{next(self._wl_seq)}"
        self.scheduler.submit(
            wid, self.flavor, 1,
            queue=self.queue, priority=self.priority, owner=self.owner,
        )
        self._workloads[wid] = _ReplicaWorkload(workload_id=wid)
        return wid

    # ---- the reconcile tick ------------------------------------------------

    async def tick(self) -> dict[str, Any]:
        """One reconcile pass: handle preemptions, materialise admitted
        grows, converge toward the policy's target.  Returns a summary for
        logging/tests."""
        summary: dict[str, Any] = {
            "preempted": [], "spawned": [], "drained": [], "target": None,
        }
        # 1. preemptions aimed at serve workloads: drain (never kill), then
        #    release so the preemptor admits on the next scheduler pass
        take = getattr(self.scheduler, "take_preemptions", None)
        if take is not None:
            for decision in take(owner=self.owner):
                await self._drain_workload(
                    decision.job_id,
                    reason=f"preempted for {decision.preemptor_id or 'reclaim'}",
                )
                self.preempted_total += 1
                summary["preempted"].append(decision.job_id)
        # 2. admission: standalone tenants drive it; shared schedulers are
        #    ticked by their backend, and serve workloads skipped there stay
        #    admitted for us to observe
        if self.drive_admission:
            self.scheduler.try_admit()
        # a crashed replica restarts under a NEW id (fleet health loop):
        # rebind its workload to an unbound healthy replica so the chips
        # accounting follows the restart instead of double-spawning
        bound_ids = {wl.replica_id for wl in self._workloads.values()}
        for wl in self._workloads.values():
            if wl.replica_id is not None \
                    and wl.replica_id not in self.fleet.replicas:
                replacement = next(
                    (r.replica_id for r in self.fleet.healthy_replicas()
                     if r.replica_id not in bound_ids), None,
                )
                if replacement is not None:
                    wl.replica_id = replacement
                    bound_ids.add(replacement)
        for wl in list(self._workloads.values()):
            if wl.replica_id is None \
                    and self.scheduler.is_admitted(wl.workload_id):
                replica = await self.fleet.spawn_replica()
                wl.replica_id = replica.replica_id
                summary["spawned"].append(replica.replica_id)
        # keep the fleet's restart ceiling in step with what the scheduler
        # actually granted
        self.fleet.target_replicas = max(1, sum(
            1 for wl in self._workloads.values() if wl.replica_id is not None
        ))
        # 3. autoscale toward the policy target
        obs = self._observe()
        target = self.policy.decide(**obs)
        summary["target"] = target
        if target > self._bound():
            self._submit_workload()
            self.scale_ups_total += 1
            logger.info(
                "serve autoscale: +1 replica for %s (queue_depth=%d over %d "
                "healthy)", self.fleet.job_id, obs["queue_depth"],
                obs["healthy"],
            )
        elif target < self._bound():
            victim = self._pick_shrink_victim()
            if victim is not None:
                await self._drain_workload(victim, reason="idle scale-down")
                self.scale_downs_total += 1
                summary["drained"].append(victim)
        return summary

    def _pick_shrink_victim(self) -> str | None:
        """Prefer a workload still pending admission (free to cancel), else
        the newest materialised replica."""
        for wl in self._workloads.values():
            if wl.replica_id is None:
                return wl.workload_id
        for wl in self._workloads.values():
            # dead binding (replica crashed away, no rebind candidate):
            # the chips are already idle — releasing this one costs nothing
            if wl.replica_id not in self.fleet.replicas:
                return wl.workload_id
        live = [
            (wl, self.fleet.replicas[wl.replica_id])
            for wl in self._workloads.values()
        ]
        live = [(wl, r) for wl, r in live if r.healthy]
        if not live:
            return None
        return max(live, key=lambda p: p[1].started_at)[0].workload_id

    async def _drain_workload(self, workload_id: str, *, reason: str) -> None:
        """Drain the workload's replica (if materialised), then release the
        chips — the order that makes a reclaim graceful AND prompt."""
        wl = self._workloads.pop(workload_id, None)
        if wl is not None and wl.replica_id is not None:
            await self.fleet.drain_replica(wl.replica_id, reason=reason)
        # forget (not release): a drained serve workload never resubmits at
        # a new size, so any reservation must die with it
        getattr(self.scheduler, "forget", self.scheduler.release)(workload_id)

    async def close(self) -> None:
        for wid in list(self._workloads):
            wl = self._workloads.pop(wid)
            getattr(self.scheduler, "forget", self.scheduler.release)(
                wl.workload_id
            )

    def stats(self) -> dict[str, Any]:
        def pid_of(replica_id: str | None) -> int | None:
            """Real process placement for transport fleets: the admitted
            workload's chips are held by THIS worker pid (docs/serving.md
            §Cross-process transport) — '-' for in-process replicas."""
            replica = (
                self.fleet.replicas.get(replica_id)
                if replica_id is not None else None
            )
            if replica is None or not replica.remote:
                return None
            return replica.batcher.pid

        return {
            "workloads": {
                wid: wl.replica_id for wid, wl in self._workloads.items()
            },
            "worker_pids": {
                wid: pid_of(wl.replica_id)
                for wid, wl in self._workloads.items()
            },
            "transport": self.fleet.transport_mode,
            "queue": self.queue,
            "flavor": self.flavor,
            "scale_ups_total": self.scale_ups_total,
            "scale_downs_total": self.scale_downs_total,
            "preempted_total": self.preempted_total,
        }


class RolloutTenant:
    """Remote rlhf rollout actors as ``owner="rollout"`` scheduler tenants.

    The :class:`~finetune_controller_tpu_torch.prefs.rollout_plane.RolloutPlane`
    owns worker LIFECYCLE (spawn, respawn, policy push); this tenant owns
    only their chips accounting: one workload per rollout worker in the
    rollout queue, preemptible like serve capacity.  No autoscale policy —
    the worker count is the job spec's ``rollout_workers`` — so the tick is
    just preemption intake: a reclaimed workload's worker id is handed back
    for the plane to stop (its learner keeps stepping on buffered pairs;
    respawn happens when the scheduler re-admits).
    """

    def __init__(self, scheduler, job_id: str, *, flavor: str,
                 queue: str = ROLLOUT_QUEUE, priority: object = "low"):
        self.scheduler = scheduler
        self.job_id = job_id
        self.flavor = flavor
        self.queue = queue
        self.priority = priority
        #: workload id → worker id, one per remote rollout actor
        self._workloads: dict[str, str] = {}
        self.preempted_total = 0

    def submit(self, worker_id: str) -> str:
        wid = f"rollout-{self.job_id}-{worker_id}"
        self.scheduler.submit(
            wid, self.flavor, 1,
            queue=self.queue, priority=self.priority, owner="rollout",
        )
        self._workloads[wid] = worker_id
        return wid

    def is_admitted(self, worker_id: str) -> bool:
        return self.scheduler.is_admitted(
            f"rollout-{self.job_id}-{worker_id}"
        )

    def tick(self) -> dict[str, Any]:
        """Preemption intake: worker ids whose chips the scheduler reclaimed
        this tick, plus the currently-admitted set."""
        preempted: list[str] = []
        take = getattr(self.scheduler, "take_preemptions", None)
        if take is not None:
            for decision in take(owner="rollout"):
                worker = self._workloads.get(decision.job_id)
                if worker is not None:
                    preempted.append(worker)
                    self.preempted_total += 1
                getattr(self.scheduler, "forget", self.scheduler.release)(
                    decision.job_id
                )
                self._workloads.pop(decision.job_id, None)
        admitted = [
            worker for wid, worker in self._workloads.items()
            if self.scheduler.is_admitted(wid)
        ]
        return {"preempted": preempted, "admitted": admitted}

    def close(self) -> None:
        for wid in list(self._workloads):
            getattr(self.scheduler, "forget", self.scheduler.release)(wid)
            self._workloads.pop(wid, None)

    def stats(self) -> dict[str, Any]:
        return {
            "workloads": dict(self._workloads),
            "queue": self.queue,
            "flavor": self.flavor,
            "preempted_total": self.preempted_total,
        }
