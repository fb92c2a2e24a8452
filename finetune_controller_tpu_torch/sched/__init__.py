"""Multi-tenant fair-share scheduling (docs/scheduling.md).

The in-repo replacement for the best-effort-FIFO :class:`GangScheduler`
(``controller/backends/scheduler.py``): named tenant queues with weights,
priority classes on every workload, weighted dominant-resource fair sharing
over the per-flavor chip quotas in the :class:`DeviceCatalog`, cohort
borrowing, checkpoint-aware preemption through the resilience loop, and
reservation-protected backfill.

Modules:

- :mod:`.queues` — tenant queues, priority classes, the Workload record;
- :mod:`.fairshare` — the :class:`FairShareScheduler` itself plus the
  weighted-DRF share math and the Jain fairness index;
- :mod:`.preemption` — the resize-before-evict planner (shrink to fair
  share first, full eviction as the fallback; docs/elasticity.md) and the
  victim ordering (lowest priority, most-over-share, youngest first);
- :mod:`.backfill` — the reservation-protected backfill gate;

The reference's ``serve_tenant.py`` (serve replicas as preemptible
workloads) and ``sim.py`` (the seeded cluster simulator) are not ported yet
(ROADMAP Queue A item 3a-rest).
"""

from .backfill import backfill_capacity
from .fairshare import FairShareScheduler, jain_index
from .preemption import ResizeDecision, plan_preemption, select_victims
from .queues import (
    DEFAULT_QUEUE,
    PRIORITY_CLASSES,
    QueueConfig,
    QueueSet,
    Workload,
    parse_priority,
)

__all__ = [
    "DEFAULT_QUEUE",
    "PRIORITY_CLASSES",
    "FairShareScheduler",
    "QueueConfig",
    "QueueSet",
    "Workload",
    "ResizeDecision",
    "backfill_capacity",
    "jain_index",
    "parse_priority",
    "plan_preemption",
    "select_victims",
]
