"""Weighted dominant-resource fair sharing + the FairShareScheduler.

The drop-in replacement for the best-effort-FIFO ``GangScheduler``
(``controller/backends/scheduler.py``): same surface (``submit`` /
``try_admit`` / ``release`` / ``pending`` / ``position`` / ``usage``) so the
local backend and the admin routes keep working, plus the multi-tenant
machinery the ROADMAP's "heavy traffic" north star needs:

- **ordering**: pending workloads rank by priority class (desc), then their
  queue's *weighted dominant share* (asc — the DRF rule: serve the tenant
  farthest below its entitlement first), then submission sequence;
- **borrowing**: nominal shares divide each flavor's quota among the queues
  with *demand* on it — an idle queue is simply absent from the denominator,
  so its quota is lendable and reclaimable (via preemption) the moment it
  wakes up;
- **preemption → resize**: a blocked higher-priority or under-share head
  plans shrinks-then-evictions (``preemption.plan_preemption``,
  docs/elasticity.md), the backend SIGTERMs the victims through the
  resilience loop, and the freed chips are *reserved* for the preemptor
  (and a shrinking victim's surviving slices for its own resubmit) — no
  admission race;
- **elastic admission + grow**: a blocked multi-slice head with no
  preemption path starts shrunk within its fair share instead of idling a
  reservation, and shrunk workloads grow back once the flavor has been
  tenant-quiet for ``grow_delay_s``;
- **backfill**: later-ranked workloads admit only into capacity provably in
  excess of the head's reservation (``backfill.backfill_capacity``).

Everything is synchronous and in-memory (trivially testable, like the seed
scheduler); the clock is injected so the simulator (``sched/sim.py``) can
drive it on virtual time.
"""

from __future__ import annotations

import collections
import itertools
import logging
import time
from typing import Iterable

from ..controller.devices import DeviceCatalog
from .backfill import backfill_capacity
from .preemption import ResizeDecision, plan_preemption
from .queues import (
    DEFAULT_PRIORITY,
    DEFAULT_QUEUE,
    QueueConfig,
    QueueSet,
    Workload,
    parse_priority,
)

logger = logging.getLogger(__name__)


def jain_index(values: Iterable[float]) -> float:
    """Jain's fairness index: 1.0 = perfectly even, 1/n = maximally unfair.

    Computed over *entitlement-normalised* allocations (caller divides each
    tenant's allocation by its weight first).
    """
    xs = [float(v) for v in values]
    if not xs:
        return 1.0
    total = sum(xs)
    sq = sum(x * x for x in xs)
    if sq == 0:
        return 1.0  # nobody got anything: degenerate but not "unfair"
    return (total * total) / (len(xs) * sq)


class FairShareScheduler:
    """Quota-based admission with weighted fair sharing and preemption."""

    def __init__(
        self,
        catalog: DeviceCatalog,
        queues: list[QueueConfig] | dict[str, float] | None = None,
        *,
        clock=time.monotonic,
        resize: bool = True,
        grow_delay_s: float = 60.0,
        reservation_ttl_s: float = 300.0,
    ):
        self._catalog = catalog
        self.queues = QueueSet(queues)
        self._clock = clock
        #: resize-instead-of-evict (docs/elasticity.md): shrink multi-slice
        #: victims to their fair share before full evictions, and grow them
        #: back when chips free.  False degrades to the evict-only
        #: behavior (FTC_SCHED_RESIZE=false).
        self.resize = resize
        #: the flavor must be TENANT-QUIET this long — no demand from any
        #: queue other than the shrunk workloads' own — before the grow
        #: pass restarts one at a larger size (and the workload itself must
        #: have run this long since admission).  Growing costs a restart,
        #: so growing into a momentary gap between tenant arrivals would
        #: thrash (shrink, grow, shrink again) and claw back chips the
        #: contending tenants are entitled to.
        self.grow_delay_s = grow_delay_s
        #: flavor -> clock reading when it last became tenant-quiet
        #: (absent = other-tenant demand present); the grow pass's lull timer
        self._quiet_since: dict[str, float] = {}
        #: resize reservations expire after this long: if the resubmit never
        #: arrives (job cancelled mid-resize, controller crash), the chips
        #: must not stay fenced off forever
        self.reservation_ttl_s = reservation_ttl_s
        self._workloads: dict[str, Workload] = {}
        #: per-scheduler sequence (the satellite fix: the seed's module-global
        #: counter made queue positions depend on unrelated instances)
        self._seq = itertools.count()
        #: preemptor job_id -> victim job_ids still exiting on its behalf
        self._claims: dict[str, list[str]] = {}
        #: decisions selected but not yet delivered to the backend
        self._pending_preemptions: list[ResizeDecision] = []
        #: job_id -> (flavor, chips, deadline): chips fenced off for a
        #: resized workload's own resubmit — a shrink frees only the shed
        #: slices to the preemptor; the rest must survive the exit/requeue
        #: window or the victim would strand behind whoever grabbed them
        self._resize_reservations: dict[str, tuple[str, int, float]] = {}
        # observability
        self.preemptions_total = 0
        self.preemptions_by_queue: dict[str, int] = {}
        self.resizes_total = 0
        self.shrinks_total = 0
        self.grows_total = 0
        #: workloads started below their requested size (elastic admission);
        #: in resize_history these are the "shrink" entries with no preemptor
        self.admitted_shrunk_total = 0
        self.resizes_by_queue: dict[str, int] = {}
        #: recent resize decisions (GET /admin/scheduler, ftc-ctl queue)
        self.resize_history: collections.deque = collections.deque(maxlen=50)

    # -- submission / release ------------------------------------------------

    def submit(
        self,
        job_id: str,
        flavor_name: str,
        num_slices: int = 1,
        *,
        queue: str | None = None,
        priority: object | None = None,
        requested_slices: int | None = None,
        min_slices: int = 1,
        owner: str = "train",
    ) -> Workload:
        """Register a suspended workload under a tenant queue + priority.

        ``owner`` tags which plane runs the workload ("train" = the backend
        spawns a trainer; "serve" = a serve-tenant replica) — admission and
        preemption delivery filter on it so each plane only ever handles its
        own workloads (docs/scheduling.md §Serve tenant).

        ``requested_slices`` (>= ``num_slices``) is the topology the job
        originally asked for; a resized resubmit runs at ``num_slices`` and
        the grow pass restores it toward ``requested_slices`` when chips
        free.  Defaults to ``num_slices`` (a job at its full size).

        ``min_slices`` floors every shrink: an atomic gang (RLHF
        actor+learner, ``spec.atomic_gang``) submits with
        ``min_slices == num_slices`` and is then only ever admitted whole
        or fully evicted — never resized.
        """
        if job_id in self._workloads:
            raise ValueError(f"workload {job_id!r} already queued")
        flavor = self._catalog.get_worker(flavor_name)
        num_slices = max(1, num_slices)
        requested = max(num_slices, requested_slices or num_slices)
        need = flavor.total_chips * num_slices
        quota = self._catalog.quota_for(flavor.name)
        if need > quota:
            # an inadmissible head would hold its flavor's reservation
            # forever (strict anti-starvation means nothing passes it) —
            # refuse at submit, where it surfaces as a 400, not a wedge
            raise ValueError(
                f"workload {job_id!r} needs {need} chips of {flavor.name!r} "
                f"but the quota is {quota}: it can never be admitted"
            )
        w = Workload(
            job_id=job_id,
            flavor=flavor.name,
            chips=need,
            queue=queue or DEFAULT_QUEUE,
            priority=parse_priority(
                priority if priority is not None else DEFAULT_PRIORITY
            ),
            seq=next(self._seq),
            submitted_at=self._clock(),
            num_slices=num_slices,
            requested_slices=requested,
            min_slices=max(1, min(min_slices, num_slices)),
            owner=owner,
        )
        self._workloads[job_id] = w
        return w

    def release(self, job_id: str) -> None:
        """Free a workload's quota (finished, deleted, or preempted-and-exited).

        A resize reservation deliberately SURVIVES release: the victim's
        exit is exactly when its chips must stay fenced for the resubmit.
        Reservations die on admission, on :meth:`forget`, or at their TTL.
        """
        self._workloads.pop(job_id, None)
        self._claims.pop(job_id, None)  # it was a preemptor: drop its claim
        for victims in self._claims.values():
            if job_id in victims:
                victims.remove(job_id)

    def forget(self, job_id: str) -> None:
        """Release + drop any resize reservation — the job is gone for good
        (cancelled/terminal), not coming back at a new size."""
        self.release(job_id)
        self._resize_reservations.pop(job_id, None)

    # -- share math ----------------------------------------------------------

    def _used_chips(self, flavor: str) -> int:
        return sum(
            w.chips for w in self._workloads.values()
            if w.admitted and w.flavor == flavor
        )

    def _queue_used(self, queue: str, flavor: str) -> int:
        return sum(
            w.chips for w in self._workloads.values()
            if w.admitted and w.flavor == flavor and w.queue == queue
        )

    def _active_queues(self, flavor: str) -> set[str]:
        """Queues with demand (pending or admitted) on a flavor — the cohort
        sharing that flavor's quota.  Idle queues are absent, which is
        exactly what makes their share lendable."""
        return {
            w.queue for w in self._workloads.values() if w.flavor == flavor
        }

    def nominal_share(self, queue: str, flavor: str) -> float:
        """``quota * weight / sum(weights of the flavor's active cohort)``."""
        active = self._active_queues(flavor)
        if queue not in active:
            active = active | {queue}
        total_w = self.queues.total_weight(active)
        if total_w <= 0:
            return 0.0
        quota = self._catalog.quota_for(flavor)
        return quota * self.queues.weight(queue) / total_w

    def _over_share(self, flavor: str) -> dict[str, float]:
        """Per-queue chips above nominal share on a flavor (<=0 = within)."""
        return {
            q: self._queue_used(q, flavor) - self.nominal_share(q, flavor)
            for q in self._active_queues(flavor)
        }

    def weighted_dominant_share(self, queue: str) -> float:
        """DRF: the queue's largest per-flavor usage fraction, normalised by
        its weight.  Low = under-served, admitted first."""
        dom = 0.0
        for f in self._catalog.flavors:
            quota = self._catalog.quota_for(f.name)
            if quota <= 0:
                continue
            dom = max(dom, self._queue_used(queue, f.name) / quota)
        return dom / self.queues.weight(queue)

    # -- admission -----------------------------------------------------------

    def _rank_key(self, w: Workload, wds: dict[str, float]):
        return (-w.priority, wds[w.queue], w.seq)

    def _incoming_chips(self, preemptor: Workload) -> int:
        """Chips of in-flight victims SIGTERMed on this preemptor's behalf —
        still admitted (held) but guaranteed to free within the resilience
        loop's exit grace.  A shrinking victim contributes only its shed
        slices; the rest is its own resubmit's reservation."""
        return sum(
            self._workloads[v].freed_chips()
            for v in self._claims.get(preemptor.job_id, ())
            if v in self._workloads and self._workloads[v].preempting
        )

    def _reserve(self, job_id: str, flavor: str, chips: int) -> None:
        self._resize_reservations[job_id] = (
            flavor, chips, self._clock() + self.reservation_ttl_s
        )

    def _reserved_chips(self, flavor: str, *, exclude: str | None = None) -> int:
        """Unexpired resize-reservation chips on a flavor, excluding one
        job's own reservation (a workload may always consume its own).

        A reservation whose job is still ADMITTED (a victim that has not
        exited yet, or a grow target still running at its old size) only
        counts for the chips BEYOND what the job currently holds —
        ``_used_chips`` already covers the held part, and double-counting it
        would drive free capacity negative and trigger spurious extra
        preemptions for a head whose shortfall is in fact covered."""
        now = self._clock()
        total = 0
        for job_id in list(self._resize_reservations):
            f, chips, deadline = self._resize_reservations[job_id]
            if deadline < now:
                logger.warning(
                    "resize reservation for %s (%d chips of %s) expired "
                    "unconsumed; releasing", job_id, chips, f,
                )
                del self._resize_reservations[job_id]
                continue
            if f != flavor or job_id == exclude:
                continue
            live = self._workloads.get(job_id)
            if live is not None and live.admitted:
                total += max(0, chips - live.chips)
            else:
                total += chips
        return total

    def _own_reservation(self, w: Workload) -> int:
        res = self._resize_reservations.get(w.job_id)
        if res is None or res[0] != w.flavor:
            return 0
        return res[1]

    def try_admit(self) -> list[Workload]:
        """Admit every pending workload the fair-share policy allows.

        Returns the newly admitted workloads (the backend starts them).
        Preemption/resize victims selected during the pass are queued for
        :meth:`take_preemptions` — the backend SIGTERMs them and their chips
        stay reserved for the blocked head (and, on a shrink, for the
        victim's own resubmit) until they exit.  A final grow pass restores
        shrunk workloads toward their requested size from leftover capacity.
        """
        now = self._clock()
        wds = {
            q: self.weighted_dominant_share(q)
            for q in {w.queue for w in self._workloads.values()}
        }
        pend = sorted(
            (w for w in self._workloads.values() if not w.admitted),
            key=lambda w: self._rank_key(w, wds),
        )
        free: dict[str, int] = {}
        admitted: list[Workload] = []
        head_blocked: dict[str, Workload] = {}
        for w in pend:
            f = w.flavor
            if f not in free:
                # free = physically unused minus OTHER jobs' resize
                # reservations; a workload's own reservation is added back
                # per-candidate below
                free[f] = (
                    self._catalog.quota_for(f)
                    - self._used_chips(f)
                    - self._reserved_chips(f)
                )
            own = self._own_reservation(w)
            head = head_blocked.get(f)
            if head is not None:
                # behind a blocked head: only provably-excess chips admit,
                # and only chips that are PHYSICALLY free right now — the
                # capacity formula counts in-flight victim chips the head
                # will consume, which nobody else may start on.  A
                # candidate's OWN resize reservation is exempt from the
                # head's claim (those chips were fenced for exactly this
                # resubmit), so it adds to the excess, not to the pool the
                # head may take.
                cap = own + backfill_capacity(
                    free[f], self._incoming_chips(head), head.chips
                )
                if 0 < w.chips <= min(cap, free[f] + own):
                    self._admit(w, now, admitted, free)
                continue
            avail = free[f] + own
            if w.chips <= avail:
                self._admit(w, now, admitted, free)
                continue
            if self._maybe_preempt(w, avail):
                # victims are exiting (or already incoming) on this head's
                # behalf: it stays pending with its chips reserved
                head_blocked[f] = w
                continue
            # ELASTIC ADMISSION (docs/elasticity.md): no preemption can
            # cover the shortfall — rather than park as a blocked head whose
            # anti-starvation reservation idles every chip that frees, a
            # multi-slice workload starts SHRUNK on what is free right now;
            # the grow pass restores it when capacity returns.  Checkpoints
            # are topology-portable, so a resumed job lands here too.
            # Fair-share cap: the shrunk admission must keep the queue
            # STRICTLY within its nominal share (floored to slice
            # granularity) — uncapped, a deep queue would absorb every idle
            # chip during contention and crowd the tenants the share math
            # protects.  A queue whose whole share is already in use (or
            # whose share rounds below one slice) parks as a blocked head
            # exactly as before.
            cps = w.chips_per_slice
            if self.resize and w.num_slices > 1 and cps > 0 and avail >= cps:
                share_room = (
                    self.nominal_share(w.queue, f)
                    - self._queue_used(w.queue, f)
                )
                share_slices = int(max(0.0, share_room) // cps)
                fit = min(w.num_slices - 1, avail // cps, share_slices)
                # an atomic gang (min_slices == num_slices) never admits
                # partially — a gang missing its actor (or learner) slice
                # cannot make progress at all
                if fit >= max(1, w.min_slices):
                    d = ResizeDecision(
                        job_id=w.job_id, preemptor_id=None,
                        from_slices=w.num_slices, to_slices=fit,
                    )
                    w.num_slices = fit
                    w.chips = fit * cps
                    self._record_resize(d, w)
                    self.admitted_shrunk_total += 1
                    logger.info(
                        "elastic admission: %s starts at %d/%d slices "
                        "(%d chips of %s free)",
                        w.job_id, fit, w.requested_slices, avail, w.flavor,
                    )
                    self._admit(w, now, admitted, free)
                    continue
            head_blocked[f] = w
        if self.resize:
            self._grow_pass(now, free, head_blocked)
        return admitted

    def _admit(self, w: Workload, now: float, admitted: list[Workload],
               free: dict[str, int]) -> None:
        w.admitted = True
        w.admitted_at = now
        own = 0
        if w.job_id in self._resize_reservations:
            own = self._own_reservation(w)
            del self._resize_reservations[w.job_id]  # consumed
        free[w.flavor] -= max(0, w.chips - own)
        self._claims.pop(w.job_id, None)  # reservation consumed
        admitted.append(w)
        logger.info(
            "admitted %s (%d chips of %s, queue=%s prio=%d, slices=%d/%d)",
            w.job_id, w.chips, w.flavor, w.queue, w.priority,
            w.num_slices, w.requested_slices,
        )

    def _maybe_preempt(self, w: Workload, free_chips: int) -> bool:
        """Plan shrinks/evictions covering the head's shortfall (beyond
        chips already incoming from earlier preemptions) and reserve them
        for it (docs/elasticity.md: resize-instead-of-evict).  Returns True
        when the head's full size is covered (victims exiting or already
        incoming) — i.e. it should stay pending rather than admit shrunk."""
        shortfall = w.chips - free_chips - self._incoming_chips(w)
        if shortfall <= 0:
            return True
        over = self._over_share(w.flavor)
        # RECLAIM-ONLY fairness trigger: a queue may fairness-preempt (same
        # priority, victim queue over share) only when it stays within its
        # own nominal share after admission.  A borrower preempting would
        # oscillate: post-swap the roles reverse and the displaced queue
        # preempts right back — reclaim-only makes the swap a fixed point.
        under = (
            self._queue_used(w.queue, w.flavor) + w.chips
            <= self.nominal_share(w.queue, w.flavor) + 1e-9
        )
        candidates = [
            c for c in self._workloads.values()
            if c.admitted and c.flavor == w.flavor
        ]
        plans = plan_preemption(
            w, candidates, shortfall,
            over_share=over, preemptor_under_share=under, resize=self.resize,
        )
        if not plans:
            return False
        claim = self._claims.setdefault(w.job_id, [])
        for d in plans:
            v = self._workloads[d.job_id]
            v.preempting = True
            v.resize_to = d.to_slices or None
            claim.append(v.job_id)
            self._pending_preemptions.append(d)
            if d.kind == "evict":
                self.preemptions_total += 1
                self.preemptions_by_queue[v.queue] = (
                    self.preemptions_by_queue.get(v.queue, 0) + 1
                )
            else:
                # the shrunk victim's surviving slices are fenced for its
                # own resubmit — without this, whoever admits first during
                # the exit/backoff window strands the victim
                self._record_resize(d, v)
                self._reserve(
                    v.job_id, v.flavor, d.to_slices * v.chips_per_slice
                )
            logger.info(
                "%s %s (queue=%s prio=%d, %d chips, slices %d->%s) for %s "
                "(queue=%s prio=%d)",
                d.kind, v.job_id, v.queue, v.priority, v.chips,
                d.from_slices, d.to_slices or "none",
                w.job_id, w.queue, w.priority,
            )
        return True

    def _record_resize(self, d: ResizeDecision, v: Workload) -> None:
        self.resizes_total += 1
        if d.kind == "shrink":
            self.shrinks_total += 1
        else:
            self.grows_total += 1
        self.resizes_by_queue[v.queue] = self.resizes_by_queue.get(v.queue, 0) + 1
        self.resize_history.append({
            "job_id": d.job_id,
            "kind": d.kind,
            "from_slices": d.from_slices,
            "to_slices": d.to_slices,
            "preemptor": d.preemptor_id,
            "queue": v.queue,
            "at": self._clock(),
        })

    def _grow_pass(self, now: float, free: dict[str, int],
                   head_blocked: dict[str, Workload]) -> None:
        """Restore shrunk workloads toward their requested size from chips
        nobody pending could use.  Runs only for flavors with NO blocked
        head (a blocked head's reservation owns the leftovers) and only for
        workloads that have run at least ``grow_delay_s`` since admission —
        growing costs a checkpoint restart, so it must not thrash."""
        shrunk = [
            w for w in self._workloads.values()
            if w.shrunk and not w.preempting
        ]
        # quiet timer per flavor: the flavor must be free of OTHER tenants'
        # demand for a sustained window before a grow restart is worth
        # paying — update it for every flavor a shrunk workload lives on,
        # even when the grow below is skipped
        shrunk_queues: dict[str, set] = {}
        for w in shrunk:
            shrunk_queues.setdefault(w.flavor, set()).add(w.queue)
        for f, queues in shrunk_queues.items():
            if f not in free:
                free[f] = (
                    self._catalog.quota_for(f)
                    - self._used_chips(f)
                    - self._reserved_chips(f)
                )
            others = any(
                x.flavor == f and x.queue not in queues
                for x in self._workloads.values()
            )
            if others or f in head_blocked:
                self._quiet_since.pop(f, None)
            else:
                self._quiet_since.setdefault(f, now)
        # most-shrunk-first, then oldest: the workload farthest below its
        # request has waited hardest for its chips back
        shrunk.sort(key=lambda w: (
            -(w.requested_slices - w.num_slices), w.admitted_at or 0.0, w.seq
        ))
        for w in shrunk:
            f = w.flavor
            if f in head_blocked:
                continue
            lull_start = self._quiet_since.get(f)
            if lull_start is None or now - lull_start < self.grow_delay_s:
                continue
            if now - (w.admitted_at or 0.0) < self.grow_delay_s:
                continue
            cps = w.chips_per_slice
            if cps <= 0:
                continue
            delta = min(w.requested_slices - w.num_slices, free[f] // cps)
            if delta < 1:
                continue
            to = w.num_slices + delta
            d = ResizeDecision(
                job_id=w.job_id, preemptor_id=None,
                from_slices=w.num_slices, to_slices=to,
            )
            w.preempting = True
            w.resize_to = to
            # fence the grown size: current chips free at exit, the delta
            # comes out of free now
            self._reserve(w.job_id, f, to * cps)
            free[f] -= delta * cps
            self._pending_preemptions.append(d)
            self._record_resize(d, w)
            logger.info(
                "grow %s (queue=%s) slices %d->%d (%d free chips of %s)",
                w.job_id, w.queue, d.from_slices, d.to_slices,
                free[f] + delta * cps, f,
            )

    def take_preemptions(self, owner: str | None = None) -> list[ResizeDecision]:
        """Drain the :class:`ResizeDecision`s selected since the last call —
        the backend SIGTERMs each victim; the resilience loop (checkpoint →
        RETRYING → resume, at ``to_slices`` when the decision is a resize)
        does the rest.

        ``owner`` filters by the victim workload's owner tag, leaving the
        rest pending: the training backend drains ``owner="train"`` (SIGTERM
        → retry supervisor), the serve tenant drains ``owner="serve"``
        (graceful replica drain — never a kill).  ``None`` keeps the legacy
        take-everything behavior for single-plane callers.
        """
        if owner is None:
            out, self._pending_preemptions = self._pending_preemptions, []
            return out
        out, keep = [], []
        for d in self._pending_preemptions:
            victim = self._workloads.get(d.job_id)
            victim_owner = victim.owner if victim is not None else "train"
            (out if victim_owner == owner else keep).append(d)
        self._pending_preemptions = keep
        return out

    # -- introspection (GangScheduler-compatible + the tenant view) ----------

    def pending(self) -> list[str]:
        """Pending job ids in *admission rank* order (priority, share, seq) —
        the order they would actually admit, which is what a queue-position
        display must show."""
        wds = {
            q: self.weighted_dominant_share(q)
            for q in {w.queue for w in self._workloads.values()}
        }
        return [
            w.job_id
            for w in sorted(
                (w for w in self._workloads.values() if not w.admitted),
                key=lambda w: self._rank_key(w, wds),
            )
        ]

    def position(self, job_id: str) -> int | None:
        pend = self.pending()
        return pend.index(job_id) + 1 if job_id in pend else None

    def is_admitted(self, job_id: str) -> bool:
        w = self._workloads.get(job_id)
        return bool(w and w.admitted)

    def workload(self, job_id: str) -> Workload | None:
        return self._workloads.get(job_id)

    def usage(self) -> dict[str, dict[str, int]]:
        """Per-flavor quota usage — the GangScheduler admin/debug shape."""
        out: dict[str, dict[str, int]] = {}
        for f in self._catalog.flavors:
            out[f.name] = {
                "used_chips": self._used_chips(f.name),
                "nominal_chips": self._catalog.quota_for(f.name),
                "pending": sum(
                    1 for w in self._workloads.values()
                    if not w.admitted and w.flavor == f.name
                ),
            }
        return out

    def snapshot(self) -> dict:
        """The tenant-facing view (``GET /admin/scheduler``, ``ftc-ctl
        queue``): per-queue usage, weighted share, borrowed chips, depth,
        and pending positions, plus cluster-wide counters."""
        pend_order = self.pending()
        queues: dict[str, dict] = {}
        # configured queues + queues with LIVE workloads only: ad-hoc queue
        # names are user-supplied, and emitting a /metrics series per name
        # ever seen would be an unbounded-cardinality leak
        names = set(self.queues.names()) | {
            w.queue for w in self._workloads.values()
        }
        for q in sorted(names):
            used = {
                f.name: self._queue_used(q, f.name)
                for f in self._catalog.flavors
                if self._queue_used(q, f.name)
            }
            borrowed = 0.0
            for f in self._catalog.flavors:
                u = self._queue_used(q, f.name)
                if u:
                    borrowed += max(0.0, u - self.nominal_share(q, f.name))
            pending_jobs = [
                {"job_id": j, "position": pend_order.index(j) + 1}
                for j in pend_order
                if self._workloads[j].queue == q
            ]
            queues[q] = {
                "weight": self.queues.weight(q),
                "running": sum(
                    1 for w in self._workloads.values()
                    if w.admitted and w.queue == q
                ),
                "depth": len(pending_jobs),
                "used_chips": used,
                "used_chips_total": sum(used.values()),
                "dominant_share": round(self.weighted_dominant_share(q), 4),
                "borrowed_chips": round(borrowed, 2),
                "preemptions": self.preemptions_by_queue.get(q, 0),
                "resizes": self.resizes_by_queue.get(q, 0),
                "pending": pending_jobs,
            }
        shrunk = {
            w.job_id: {
                "queue": w.queue,
                "num_slices": w.num_slices,
                "requested_slices": w.requested_slices,
            }
            for w in self._workloads.values() if w.shrunk
        }
        return {
            "policy": "fairshare",
            "resize_enabled": self.resize,
            "queues": queues,
            "flavors": self.usage(),
            "preemptions_total": self.preemptions_total,
            "resizes_total": self.resizes_total,
            "shrinks_total": self.shrinks_total,
            "grows_total": self.grows_total,
            "resize_history": list(self.resize_history),
            "shrunk_workloads": shrunk,
            "reservations": {
                p: list(v) for p, v in self._claims.items() if v
            },
            "resize_reservations": {
                j: {"flavor": f, "chips": c}
                for j, (f, c, _) in self._resize_reservations.items()
            },
        }
