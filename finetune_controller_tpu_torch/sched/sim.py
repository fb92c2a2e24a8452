"""Seeded, clock-injected cluster simulator for scheduler properties.

Real preemption tests cost minutes of wall clock (subprocesses, training,
checkpoints); the scheduler's *policy* properties — fairness, starvation
freedom, quota safety, preempt→resume latency — are pure control-flow and
deserve millisecond-scale deterministic proofs.  This module replays a
workload trace against any scheduler with the GangScheduler surface
(``submit``/``try_admit``/``release`` + optionally ``take_preemptions``)
on a virtual clock:

- a **preempted** job models the resilience loop: it keeps its chips for
  ``preempt_exit_s`` (SIGTERM → checkpoint → exit), loses progress since its
  last checkpoint (``checkpoint_every_s`` granularity), waits out
  ``requeue_delay_s`` (the retry backoff), then resubmits and later resumes;
- per-queue **chip-seconds** are integrated over the contention window
  (>= 2 tenants with arrived-but-unfinished demand) so Jain's fairness
  index is computed on entitlement-normalised allocations;
- every event is totally ordered (time, then a tie-break counter), so a
  seeded trace replays bit-identically — the property tests and
  scheduler comparisons both lean on this.
"""

from __future__ import annotations

import dataclasses
import heapq
import random
from typing import Callable

from ..controller.devices import DeviceCatalog, DeviceFlavor, FlavorQuota
from .fairshare import jain_index
from .queues import DEFAULT_QUEUE


@dataclasses.dataclass
class SimJob:
    """One trace entry: a job with a known (virtual) runtime."""

    job_id: str
    flavor: str
    duration_s: float
    arrival_s: float = 0.0
    queue: str = DEFAULT_QUEUE
    priority: object = "normal"
    num_slices: int = 1
    #: checkpoint cadence: a preemption rounds completed work down to this
    checkpoint_every_s: float = 30.0


@dataclasses.dataclass
class JobOutcome:
    job_id: str
    queue: str
    chips: int  # at the REQUESTED size (the small-job filter keys off this)
    arrival_s: float
    first_admit_s: float | None = None
    finish_s: float | None = None
    preempted_at: list[float] = dataclasses.field(default_factory=list)
    resumed_at: list[float] = dataclasses.field(default_factory=list)
    #: slice-count trajectory across resizes (for debugging/assertions)
    sizes: list[int] = dataclasses.field(default_factory=list)

    @property
    def queue_wait_s(self) -> float | None:
        if self.first_admit_s is None:
            return None
        return self.first_admit_s - self.arrival_s


@dataclasses.dataclass
class SimReport:
    makespan_s: float
    outcomes: dict[str, JobOutcome]
    preemptions: int
    resizes: int
    preempt_resume_latencies_s: list[float]
    #: per-queue chip-seconds integrated while >= 2 queues had live demand
    contention_chip_seconds: dict[str, float]
    jain_fairness: float
    #: chip-seconds of completed work discarded at preemption/resize exits
    #: (progress since the victim's last periodic checkpoint; 0 under the
    #: save-on-SIGTERM model — see ``ClusterSim.preempt_saves``)
    replay_lost_chip_seconds: float
    #: chip-seconds spent inside exit graces (SIGTERM → checkpoint → exit):
    #: the chips are held but produce no progress — every extra restart a
    #: policy causes pays this, which is what keeps resize churn honest
    exit_overhead_chip_seconds: float
    #: chip-seconds of capacity that sat idle while some job wanted chips it
    #: did not have (pending, or running shrunk below its request) — under
    #: eviction this is dominated by anti-starvation reservations holding
    #: partial capacity for a big readmit; resize keeps those chips training
    idle_demand_chip_seconds: float

    @property
    def progress_lost_chip_seconds(self) -> float:
        """The resize gate's metric: chip-seconds of progress the cluster
        lost to capacity churn — work discarded to checkpoint replay, exit-
        grace overhead, and demanded-but-idle capacity.  Resize must beat
        full eviction on this."""
        return (
            self.replay_lost_chip_seconds
            + self.exit_overhead_chip_seconds
            + self.idle_demand_chip_seconds
        )

    def waits(self, *, max_chips: int | None = None) -> list[float]:
        """Queue waits (s), optionally only for jobs at most ``max_chips``."""
        return [
            o.queue_wait_s
            for o in self.outcomes.values()
            if o.queue_wait_s is not None
            and (max_chips is None or o.chips <= max_chips)
        ]


def percentile(xs: list[float], p: float) -> float:
    """Nearest-rank percentile, dependency-free (the sim must not need numpy)."""
    if not xs:
        return 0.0
    xs = sorted(xs)
    k = max(0, min(len(xs) - 1, int(round(p / 100.0 * (len(xs) - 1)))))
    return xs[k]


class ClusterSim:
    """Event-driven replay of a trace against one scheduler instance."""

    def __init__(
        self,
        catalog: DeviceCatalog,
        scheduler_factory: Callable,
        *,
        preempt_exit_s: float = 1.0,
        requeue_delay_s: float = 2.0,
        queue_weights: dict[str, float] | None = None,
        preempt_saves: bool = True,
        tick_interval_s: float = 5.0,
    ):
        self.catalog = catalog
        self.now = 0.0
        #: factory receives the sim clock; FIFO factories may ignore it
        self.scheduler = scheduler_factory(lambda: self.now)
        self.preempt_exit_s = preempt_exit_s
        self.requeue_delay_s = requeue_delay_s
        #: entitlements used to NORMALISE the Jain index.  Explicit so both
        #: legs of an A/B (FIFO vs fair-share) are judged against the SAME
        #: entitlements — a weight-blind scheduler must not get its fairness
        #: scored against flat weights while the other leg uses the trace's.
        self.queue_weights = queue_weights
        #: True models the trainer's SIGTERM contract: the victim CHECKPOINTS AT
        #: ITS CURRENT STEP before exiting (save-on-preempt, proven
        #: step-continuous in the trainer's tests), so a scheduler-driven
        #: exit replays nothing — its cost is the exit grace itself plus the
        #: requeue window.  False is the legacy pessimistic model (progress
        #: rounds down to the last periodic checkpoint — the SIGKILL-
        #: escalation/crash shape).
        self.preempt_saves = preempt_saves
        #: periodic reconcile cadence (the monitor's ``scheduler_tick``):
        #: without it the grow pass would only run on job arrival/exit edges
        #: and a drained queue could leave shrunk jobs small forever
        self.tick_interval_s = tick_interval_s

    def run(self, jobs: list[SimJob], *, horizon_s: float = 10_000_000.0) -> SimReport:
        jobs_by_id = {j.job_id: j for j in jobs}
        if len(jobs_by_id) != len(jobs):
            raise ValueError("duplicate job_id in trace")
        outcomes = {
            j.job_id: JobOutcome(
                job_id=j.job_id, queue=j.queue, arrival_s=j.arrival_s,
                chips=self._chips(j),
            )
            for j in jobs
        }
        #: remaining work in CHIP-SECONDS: a job's duration is defined at its
        #: requested size, so work = duration * requested_chips; running at
        #: c chips finishes the remainder in remaining/c seconds (the linear
        #: scaling a data-parallel trainer actually gets)
        remaining_cs = {j.job_id: j.duration_s * self._chips(j) for j in jobs}
        #: slice count each job runs (or will resubmit) at; shrinks/grows
        #: rewrite it when the decision is taken
        cur_slices = {j.job_id: max(1, j.num_slices) for j in jobs}
        #: chips the live attempt actually occupies (for integration)
        cur_chips: dict[str, int] = {}
        started_at: dict[str, float] = {}
        #: per-job attempt generation; bumped on every (re)start AND on
        #: preemption so stale finish events are recognisably dead
        attempt: dict[str, int] = {j.job_id: 0 for j in jobs}
        #: arrived-but-unfinished job ids per queue (live demand)
        live_by_queue: dict[str, set[str]] = {j.queue: set() for j in jobs}

        heap: list[tuple[float, int, str, str, int]] = []
        tie = 0

        def push(t: float, kind: str, job_id: str, att: int = 0) -> None:
            nonlocal tie
            heapq.heappush(heap, (t, tie, kind, job_id, att))
            tie += 1

        for j in jobs:
            push(j.arrival_s, "arrive", j.job_id)

        running_chips: dict[str, float] = {}  # per queue
        contention_cs: dict[str, float] = {}
        contended_queues: set[str] = set()
        last_t = 0.0
        preempt_latencies: list[float] = []
        first_arrival = min((j.arrival_s for j in jobs), default=0.0)
        makespan_end = first_arrival
        replay_lost = 0.0
        exit_overhead = 0.0
        idle_demand = 0.0
        resizes = 0
        evictions = 0
        total_quota = sum(
            self.catalog.quota_for(f.name) for f in self.catalog.flavors
        )
        req_chips = {j.job_id: self._chips(j) for j in jobs}

        def integrate(to_t: float) -> None:
            nonlocal last_t, idle_demand
            dt = to_t - last_t
            if dt > 0:
                live = {q for q, ids in live_by_queue.items() if ids}
                # Jain window: >= 2 queues with live demand
                if len(live) >= 2:
                    contended_queues.update(live)
                    for q in live:
                        r = running_chips.get(q, 0.0)
                        contention_cs[q] = contention_cs.get(q, 0.0) + r * dt
                # idle-under-demand: some live job wants chips it does not
                # have (pending, or running below its requested size) while
                # capacity sits free — counted up to the unmet amount
                unmet = sum(
                    max(0, req_chips[jid] - cur_chips.get(jid, 0))
                    for ids in live_by_queue.values() for jid in ids
                )
                if unmet > 0:
                    idle = max(0.0, total_quota - sum(running_chips.values()))
                    idle_demand += min(idle, float(unmet)) * dt
            last_t = to_t

        def on_decisions() -> None:
            nonlocal resizes, evictions
            take = getattr(self.scheduler, "take_preemptions", None)
            if take is None:
                return
            for d in take():
                victim_id, to_slices = self._decision(d)
                o = outcomes[victim_id]
                o.preempted_at.append(self.now)
                if to_slices:
                    resizes += 1
                    cur_slices[victim_id] = to_slices
                else:
                    evictions += 1
                # bump the generation so the victim's in-flight finish is
                # dead; the exit event carries the new generation
                attempt[victim_id] += 1
                push(self.now + self.preempt_exit_s, "exit", victim_id,
                     attempt[victim_id])

        def schedule() -> None:
            for w in self.scheduler.try_admit():
                j = jobs_by_id[w.job_id]
                o = outcomes[w.job_id]
                if o.first_admit_s is None:
                    o.first_admit_s = self.now
                if len(o.resumed_at) < len(o.preempted_at):
                    o.resumed_at.append(self.now)
                    preempt_latencies.append(self.now - o.preempted_at[-1])
                started_at[w.job_id] = self.now
                attempt[w.job_id] += 1
                cur_chips[w.job_id] = w.chips
                # the FIFO scheduler's minimal Workload has no slice count
                o.sizes.append(getattr(w, "num_slices", 1))
                running_chips[j.queue] = (
                    running_chips.get(j.queue, 0.0) + w.chips
                )
                push(self.now + remaining_cs[w.job_id] / max(w.chips, 1),
                     "finish", w.job_id, attempt[w.job_id])
            on_decisions()

        # the monitor's periodic reconcile: without ticks, a drained queue
        # would leave the grow pass (and reservation TTLs) waiting for the
        # next job edge that may never come.  Only schedulers that resize
        # need it — FIFO/evict replays stay identical event-for-event.
        ticking = bool(getattr(self.scheduler, "resize", False))
        if ticking and jobs:
            push(first_arrival + self.tick_interval_s, "tick", jobs[0].job_id)

        while heap:
            t, _, kind, job_id, att = heapq.heappop(heap)
            if t > horizon_s:
                raise RuntimeError(
                    f"simulation passed the horizon ({horizon_s}s) with "
                    f"unfinished jobs — likely a starved or thrashing schedule"
                )
            integrate(t)
            self.now = t
            if kind == "tick":
                if any(o.finish_s is None for o in outcomes.values()):
                    push(t + self.tick_interval_s, "tick", job_id)
                    schedule()
                continue
            j = jobs_by_id[job_id]
            o = outcomes[job_id]
            if kind == "arrive":
                live_by_queue[j.queue].add(job_id)
                self.scheduler.submit(
                    job_id, j.flavor, j.num_slices,
                    queue=j.queue, priority=j.priority,
                )
            elif kind == "resubmit":
                self._resubmit(j, cur_slices[job_id])
            elif kind == "finish":
                if att != attempt[job_id]:
                    continue  # stale: this attempt was preempted
                self.scheduler.release(job_id)
                running_chips[j.queue] = (
                    running_chips.get(j.queue, 0.0) - cur_chips.pop(job_id, 0)
                )
                remaining_cs[job_id] = 0.0
                live_by_queue[j.queue].discard(job_id)
                o.finish_s = t
                makespan_end = max(makespan_end, t)
            elif kind == "exit":
                # the victim's process exited: progress rounds down to the
                # last checkpoint BEFORE the SIGTERM, chips free, and the job
                # requeues after its retry backoff (a resized victim at its
                # new size — the reservation inside the scheduler holds its
                # chips through this window)
                if att != attempt[job_id]:
                    continue
                chips = cur_chips.pop(job_id, 0)
                run_s = max(0.0, o.preempted_at[-1] - started_at[job_id])
                if self.preempt_saves:
                    # the SIGTERM contract: checkpoint AT the current step,
                    # then exit — nothing replays
                    saved_s = run_s
                else:
                    ckpt = max(j.checkpoint_every_s, 1e-9)
                    saved_s = min(run_s, (run_s // ckpt) * ckpt)
                remaining_cs[job_id] = max(
                    0.0, remaining_cs[job_id] - saved_s * chips
                )
                replay_lost += (run_s - saved_s) * chips
                # the exit grace holds the chips while saving/tearing down
                exit_overhead += max(0.0, t - o.preempted_at[-1]) * chips
                self.scheduler.release(job_id)
                running_chips[j.queue] = (
                    running_chips.get(j.queue, 0.0) - chips
                )
                push(t + self.requeue_delay_s, "resubmit", job_id)
            schedule()

        alloc = [
            contention_cs.get(q, 0.0) / max(self._queue_weight(q), 1e-9)
            for q in sorted(contended_queues)
        ]
        return SimReport(
            makespan_s=makespan_end - first_arrival,
            outcomes=outcomes,
            preemptions=evictions + resizes,
            resizes=resizes,
            preempt_resume_latencies_s=preempt_latencies,
            contention_chip_seconds=contention_cs,
            jain_fairness=jain_index(alloc),
            replay_lost_chip_seconds=replay_lost,
            exit_overhead_chip_seconds=exit_overhead,
            idle_demand_chip_seconds=idle_demand,
        )

    # -- internals -----------------------------------------------------------

    def _chips(self, j: SimJob) -> int:
        flavor = self.catalog.get_worker(j.flavor)
        return flavor.total_chips * max(1, j.num_slices)

    @staticmethod
    def _decision(d) -> tuple[str, int]:
        """Normalise a scheduler decision to ``(victim_id, to_slices)`` —
        accepts both ResizeDecision objects and legacy (victim, preemptor)
        pairs (to_slices 0 = full eviction)."""
        to = getattr(d, "to_slices", None)
        if to is not None:
            return d.job_id, int(to)
        victim_id, _preemptor = d
        return victim_id, 0

    def _resubmit(self, j: SimJob, slices: int) -> None:
        kwargs = dict(queue=j.queue, priority=j.priority)
        if slices != max(1, j.num_slices):
            # only resized resubmits pass requested_slices (the FIFO
            # scheduler never resizes, so it never sees the kwarg)
            kwargs["requested_slices"] = max(1, j.num_slices)
        self.scheduler.submit(j.job_id, j.flavor, slices, **kwargs)

    def _queue_weight(self, queue: str) -> float:
        if self.queue_weights is not None:
            return self.queue_weights.get(queue, 1.0)
        queues = getattr(self.scheduler, "queues", None)
        return queues.weight(queue) if queues is not None else 1.0


# ---------------------------------------------------------------------------
# Canonical trace + catalog for tests and scheduler comparisons
# ---------------------------------------------------------------------------


def sim_catalog(chips: int = 8, flavor: str = "sim-chip") -> DeviceCatalog:
    """A one-flavor virtual cluster: 1 chip per slice, ``chips`` quota."""
    return DeviceCatalog(
        flavors=[DeviceFlavor(
            name=flavor, generation="cpu", hosts=1, chips_per_host=1,
            runtime="cpu", queue="sim-queue",
        )],
        quotas=[FlavorQuota(flavor=flavor, nominal_chips=chips)],
        default_flavor=flavor,
    )


def synthetic_trace(
    seed: int = 0,
    *,
    flavor: str = "sim-chip",
    n_big: int = 4,
    n_small: int = 24,
) -> list[SimJob]:
    """The head-of-line-blocking trace: long low-priority multi-chip batch
    jobs saturate the cluster early, then a stream of short 1-chip jobs from
    two higher-entitlement tenants arrives.  FIFO strands the small jobs
    behind the saturated quota for the batch jobs' full runtime; fair-share
    preempts (checkpoint-aware) and lets them flow."""
    rng = random.Random(seed)
    jobs: list[SimJob] = []
    for i in range(n_big):
        jobs.append(SimJob(
            job_id=f"batch-{i}", flavor=flavor, num_slices=4,
            duration_s=rng.uniform(500.0, 700.0),
            arrival_s=rng.uniform(0.0, 2.0),
            queue="batch", priority="low", checkpoint_every_s=60.0,
        ))
    for i in range(n_small):
        q, prio = (("prod", "high") if i % 2 == 0 else ("research", "normal"))
        jobs.append(SimJob(
            job_id=f"small-{i}", flavor=flavor, num_slices=1,
            duration_s=rng.uniform(20.0, 45.0),
            arrival_s=10.0 + i * rng.uniform(2.0, 6.0),
            queue=q, priority=prio, checkpoint_every_s=30.0,
        ))
    return jobs


#: queue weights for the canonical trace (prod is the paying tenant)
TRACE_QUEUES = {"batch": 1.0, "research": 2.0, "prod": 4.0}


def elastic_trace(
    seed: int = 0,
    *,
    flavor: str = "sim-chip",
    xl_slices: int = 8,
    n_small: int = 16,
) -> list[SimJob]:
    """The capacity-reclaim trace — the scenario resize exists for ("losing
    chips means a job either waits for the original topology or loses all
    progress").

    A whole-cluster XL batch job saturates the quota; then a high-priority
    4-slice reclaim (the quota-reclaim / maintenance shape) and a stream of
    1-chip tenant jobs arrive.  Under full eviction the XL job cannot run
    again until ALL of its chips are simultaneously free, so its
    anti-starvation reservation idles every chip that frees before the last
    arrival drains; under resize it degrades onto the leftovers and grows
    back.  The resize-vs-evict progress-loss comparison runs here.
    """
    rng = random.Random(seed)
    jobs: list[SimJob] = [
        SimJob(
            job_id="xl-0", flavor=flavor, num_slices=xl_slices,
            duration_s=600.0, arrival_s=0.0,
            queue="batch", priority="low", checkpoint_every_s=60.0,
        ),
        SimJob(
            job_id="reclaim-0", flavor=flavor, num_slices=4,
            duration_s=rng.uniform(150.0, 200.0), arrival_s=20.0,
            queue="prod", priority="high", checkpoint_every_s=60.0,
        ),
    ]
    for i in range(n_small):
        q, prio = (("prod", "high") if i % 2 == 0 else ("research", "normal"))
        jobs.append(SimJob(
            job_id=f"small-{i}", flavor=flavor, num_slices=1,
            duration_s=rng.uniform(20.0, 45.0),
            arrival_s=10.0 + i * rng.uniform(4.0, 10.0),
            queue=q, priority=prio, checkpoint_every_s=30.0,
        ))
    return jobs
