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
- :mod:`.serve_tenant` — serve replicas as preemptible ``owner="serve"``
  workloads with queue-depth autoscaling; shrink and preemption go through
  graceful drain;
- :mod:`.sim` — a seeded, clock-injected cluster simulator so fairness /
  starvation / preemption / progress-loss properties are provable in fast
  deterministic tests.
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
from .serve_tenant import (
    ROLLOUT_QUEUE,
    SERVE_QUEUE,
    RolloutTenant,
    ServeScalePolicy,
    ServeTenant,
)

__all__ = [
    "DEFAULT_QUEUE",
    "PRIORITY_CLASSES",
    "FairShareScheduler",
    "QueueConfig",
    "QueueSet",
    "ROLLOUT_QUEUE",
    "RolloutTenant",
    "SERVE_QUEUE",
    "ServeScalePolicy",
    "ServeTenant",
    "Workload",
    "ResizeDecision",
    "backfill_capacity",
    "jain_index",
    "parse_priority",
    "plan_preemption",
    "select_victims",
]
