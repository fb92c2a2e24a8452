"""Victim selection for checkpoint-aware preemption — resize before evict.

Preemption is *cheap* here because the resilience subsystem already
turned SIGTERM into "checkpoint, exit 143, classify as preemption, requeue
with backoff, resume from the committed checkpoint" — so evicting a workload
costs it at most ``checkpoint_every`` steps of progress, not the whole run.
Since checkpoints are topology-portable (``train/elastic.py``), the planner
can do one better: **shrink** a multi-slice victim instead of evicting it —
the victim checkpoints, exits, and resumes at a reduced slice count within a
monitor tick, so capacity loss degrades its throughput instead of parking
its progress (VirtualFlow's decouple-model-from-hardware move, PAPERS.md).

Who may be preempted (two triggers):

- a **higher-priority** workload that cannot fit may evict strictly-lower-
  priority victims regardless of queue shares;
- an **under-share** workload may evict same-priority victims whose queue is
  *over* its nominal share — the fair-share reclaim.  The caller only sets
  ``preemptor_under_share`` when the preemptor's queue stays within its
  nominal share *after* admission (reclaim-only): a borrower preempting
  would oscillate — post-swap the roles reverse and the displaced queue
  preempts right back.

Plan order: **shrink-to-fair-share plans before full-eviction
plans.**  Pass 1 walks the eligible victims in expendability order (lowest
priority, most-over-share queue, youngest) and shrinks each multi-slice
victim — down to its queue's nominal share when the queue is borrowing,
deeper (to the 1-slice floor) when the shortfall demands it.  Shrinking past
the immediate shortfall when the victim's queue is over share is deliberate:
the freed headroom absorbs the *next* arrivals without re-paying a
checkpoint restart per arrival.  Pass 2 escalates to full evictions (again
in expendability order, upgrading planned shrinks) only for whatever
shortfall the shrinks could not cover.  Selection stays all-or-nothing: if
the eligible set cannot cover the shortfall, nobody is touched.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Iterable

from .queues import Workload


@dataclasses.dataclass(frozen=True)
class ResizeDecision:
    """One planned action on a running workload.

    ``to_slices == 0`` is a full eviction; ``to_slices < from_slices`` a
    shrink; ``to_slices > from_slices`` a grow (emitted by the scheduler's
    grow pass, not by this planner).  ``preemptor_id`` is None for grows.
    """

    job_id: str
    preemptor_id: str | None
    from_slices: int
    to_slices: int

    @property
    def kind(self) -> str:
        if self.to_slices == 0:
            return "evict"
        return "grow" if self.to_slices > self.from_slices else "shrink"

    @property
    def pair(self) -> tuple[str, str | None]:
        """(victim, preemptor) — the evict-only shape, for logs and tests."""
        return (self.job_id, self.preemptor_id)


def _eligible(
    preemptor: Workload,
    candidates: Iterable[Workload],
    *,
    over_share: dict[str, float],
    preemptor_under_share: bool,
) -> list[Workload]:
    out: list[Workload] = []
    for w in candidates:
        if w.preempting or not w.admitted or w.job_id == preemptor.job_id:
            continue
        if w.priority < preemptor.priority:
            out.append(w)
        elif (
            preemptor_under_share
            and w.priority == preemptor.priority
            and over_share.get(w.queue, 0.0) > 0
        ):
            out.append(w)
    # lowest priority, most-over-share queue, youngest first — deterministic
    out.sort(key=lambda w: (w.priority, -over_share.get(w.queue, 0.0), -w.seq))
    return out


def plan_preemption(
    preemptor: Workload,
    candidates: Iterable[Workload],
    shortfall: int,
    *,
    over_share: dict[str, float],
    preemptor_under_share: bool,
    resize: bool = True,
) -> list[ResizeDecision]:
    """Plan shrinks (preferred) and evictions freeing ``shortfall`` chips.

    ``over_share`` maps queue name -> chips above its weighted nominal share
    (<= 0 means at-or-under) — it doubles as the shrink-to-fair-share
    target: shedding a queue's excess lands it at its share;
    ``resize=False`` degrades to the evict-only planner.  Returns
    ``[]`` when the eligible set cannot cover the shortfall
    (all-or-nothing).
    """
    if shortfall <= 0:
        return []
    eligible = _eligible(
        preemptor, candidates,
        over_share=over_share, preemptor_under_share=preemptor_under_share,
    )
    plans: dict[str, ResizeDecision] = {}
    freed = 0
    #: chips each victim queue still holds above its share, decremented as
    #: shrinks are planned so one pass doesn't over-shrink a queue
    excess = {q: max(0.0, v) for q, v in over_share.items()}
    if resize:
        for w in eligible:
            # a victim already at (or below) its shrink floor can only be
            # fully evicted — min_slices == num_slices is how atomic gangs
            # (RLHF actor+learner) opt out of partial shrinks entirely
            floor = max(1, w.min_slices)
            if w.num_slices <= floor:
                continue
            cps = w.chips_per_slice
            if cps <= 0:
                continue
            # slices still needed for the preemptor's shortfall
            need = max(0, math.ceil((shortfall - freed) / cps))
            # fair-share deepening: shed the victim's share of its queue's
            # borrowed chips too, so the next arrival doesn't cost another
            # checkpoint restart
            fair = int(excess.get(w.queue, 0.0) // cps)
            take = min(w.num_slices - floor, max(need, fair))
            if take <= 0:
                continue
            plans[w.job_id] = ResizeDecision(
                job_id=w.job_id,
                preemptor_id=preemptor.job_id,
                from_slices=w.num_slices,
                to_slices=w.num_slices - take,
            )
            freed += take * cps
            excess[w.queue] = excess.get(w.queue, 0.0) - take * cps
    if freed < shortfall:
        # pass 2: escalate to full evictions in the same expendability
        # order — a planned shrink upgrades to an eviction (its remaining
        # slices free too)
        for w in eligible:
            if freed >= shortfall:
                break
            prior = plans.get(w.job_id)
            already = 0
            if prior is not None:
                already = (prior.from_slices - prior.to_slices) * w.chips_per_slice
            plans[w.job_id] = ResizeDecision(
                job_id=w.job_id,
                preemptor_id=preemptor.job_id,
                from_slices=w.num_slices,
                to_slices=0,
            )
            freed += w.chips - already
    if freed < shortfall:
        return []
    return list(plans.values())


def select_victims(
    preemptor: Workload,
    candidates: Iterable[Workload],
    shortfall: int,
    *,
    over_share: dict[str, float],
    preemptor_under_share: bool,
) -> list[Workload]:
    """Compatibility shim: the evict-only planner, returning the victim
    workloads themselves (tests and external callers)."""
    by_id = {w.job_id: w for w in candidates}
    plans = plan_preemption(
        preemptor, by_id.values(), shortfall,
        over_share=over_share, preemptor_under_share=preemptor_under_share,
        resize=False,
    )
    return [by_id[p.job_id] for p in plans]
