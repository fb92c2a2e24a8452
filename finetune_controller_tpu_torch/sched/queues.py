"""Tenant queues, priority classes, and the scheduler's Workload record.

The reference delegates all of this to Kueue's ClusterQueue/LocalQueue CRs
(SURVEY.md §2.2); here a queue is a named tenant with a *weight* — its
entitlement to the cluster relative to its siblings — and every workload
carries a *priority class* that orders admission and gates preemption
(Kueue's ``WorkloadPriorityClass``).

The Workload sequence number is **per-scheduler** (each scheduler owns an
``itertools.count``): the seed's module-global counter leaked ordering
across scheduler instances, which made queue positions test-order-dependent.
"""

from __future__ import annotations

import dataclasses

#: the tenant queue a submission lands in when it names none
DEFAULT_QUEUE = "default"

#: named priority classes (Kueue WorkloadPriorityClass equivalents).  Higher
#: admits first; a workload can only preempt strictly-lower-priority victims
#: (see preemption.py for the fairness-triggered same-priority case).
PRIORITY_CLASSES: dict[str, int] = {
    "low": 0,
    "normal": 50,
    "high": 100,
}

DEFAULT_PRIORITY = "normal"


def parse_priority(value: object) -> int:
    """Resolve a priority class name or integer to its numeric value.

    Accepts the named classes (``low``/``normal``/``high``), ints, and
    int-shaped strings (an escape hatch for finer-grained orderings).
    Raises ``ValueError`` on anything else — surfaced at submit time as a
    400, never inside the admission loop.
    """
    if isinstance(value, bool):  # bool is an int subclass; reject explicitly
        raise ValueError(f"priority must be a class name or integer, got {value!r}")
    if isinstance(value, int):
        return value
    if isinstance(value, str):
        key = value.strip().lower()
        if key in PRIORITY_CLASSES:
            return PRIORITY_CLASSES[key]
        try:
            return int(key)
        except ValueError:
            raise ValueError(
                f"unknown priority {value!r}; one of "
                f"{sorted(PRIORITY_CLASSES)} or an integer"
            ) from None
    raise ValueError(f"priority must be a class name or integer, got {value!r}")


def priority_name(value: int) -> str:
    """Best-effort display name for a numeric priority."""
    for name, num in PRIORITY_CLASSES.items():
        if num == value:
            return name
    return str(value)


@dataclasses.dataclass
class QueueConfig:
    """One tenant queue (Kueue ClusterQueue equivalent, minus the CRD)."""

    name: str
    #: relative entitlement: a queue's nominal share of every flavor's quota
    #: is ``quota * weight / sum(weights of queues with demand)``
    weight: float = 1.0

    def __post_init__(self) -> None:
        if self.weight <= 0:
            raise ValueError(f"queue {self.name!r} weight must be > 0")


class QueueSet:
    """The configured tenant queues.

    Unknown queue names resolve to an equal-share default (weight 1.0)
    WITHOUT being stored — tenant onboarding must not require a config
    push, and an unknown name failing the submission would be a worse
    failure mode than an equal-share default.  Not storing them is load-
    bearing: queue names are user-supplied, so registration on first use
    would let any submitter grow controller memory (and /metrics label
    cardinality) without bound by minting unique names.
    """

    def __init__(self, queues: list[QueueConfig] | dict[str, float] | None = None):
        self._queues: dict[str, QueueConfig] = {}
        if isinstance(queues, dict):
            queues = [QueueConfig(name=n, weight=w) for n, w in queues.items()]
        for q in queues or []:
            self._queues[q.name] = q
        self._queues.setdefault(DEFAULT_QUEUE, QueueConfig(name=DEFAULT_QUEUE))

    def get(self, name: str) -> QueueConfig:
        q = self._queues.get(name)
        return q if q is not None else QueueConfig(name=name)

    def weight(self, name: str) -> float:
        return self.get(name).weight

    def names(self) -> list[str]:
        """CONFIGURED queue names only (ad-hoc queues are not stored)."""
        return sorted(self._queues)

    def total_weight(self, names: set[str] | None = None) -> float:
        """Sum of weights over ``names`` (default: every configured queue)."""
        if names is None:
            return sum(q.weight for q in self._queues.values())
        return sum(self.get(n).weight for n in names)


@dataclasses.dataclass
class Workload:
    """One queued/admitted job (Kueue ``Workload`` CR equivalent).

    ``seq`` is assigned by the owning scheduler from its per-instance
    counter — never from a module global (the satellite fix).
    """

    job_id: str
    flavor: str
    chips: int
    queue: str = DEFAULT_QUEUE
    priority: int = PRIORITY_CLASSES[DEFAULT_PRIORITY]
    seq: int = 0
    admitted: bool = False
    #: which plane owns this workload's lifecycle: "train" (the backend
    #: starts/stops a trainer process for it) or "serve" (a
    #: ``sched/serve_tenant.py`` replica — the backend must NOT try to start
    #: a process for it, and its preemption decisions route to the serve
    #: tenant, which drains the replica instead of SIGTERMing anything)
    owner: str = "train"
    #: victim of an in-flight preemption/resize: SIGTERM sent, chips still
    #: held until the process exits and the backend releases the workload
    preempting: bool = False
    #: clock reading at submit (scheduler-injected clock; sim uses virtual time)
    submitted_at: float = 0.0
    admitted_at: float | None = None
    #: slice count this workload currently runs at (chips = num_slices *
    #: chips_per_slice); changes across shrink/grow resubmits
    num_slices: int = 1
    #: slice count the job originally asked for — the grow pass restores a
    #: shrunk workload toward this when chips free (docs/elasticity.md)
    requested_slices: int = 1
    #: smallest slice count this workload can RUN at.  1 for ordinary elastic
    #: jobs; equal to ``requested_slices`` for atomic gangs (the RLHF
    #: actor+learner pair, docs/preference.md) — the shrink planner and
    #: elastic admission never go below it, so a gang is only ever admitted
    #: whole or fully preempted
    min_slices: int = 1
    #: slice count an in-flight resize will resubmit this workload at
    #: (None = full eviction or no resize pending)
    resize_to: int | None = None

    @property
    def chips_per_slice(self) -> int:
        return self.chips // max(1, self.num_slices)

    @property
    def shrunk(self) -> bool:
        return self.admitted and self.num_slices < self.requested_slices

    def freed_chips(self) -> int:
        """Chips this (preempting) workload hands to its preemptor when it
        exits: everything on a full eviction, the shed slices on a shrink
        (the rest is reserved for the workload's own resubmit)."""
        if self.resize_to is None:
            return self.chips
        return self.chips - self.resize_to * self.chips_per_slice
