"""Gang scheduler — the in-repo Kueue.

The reference delegates admission control to the external Kueue operator
(SURVEY.md §2.2): jobs are created **suspended** with a queue label
(``PyTorchJobDeployer.py:66-68,179-185``) and Kueue flips ``suspend`` off when
the ClusterQueue has quota; queue order is derived by listing workloads with
``QuotaReserved=False`` sorted by creation time (``kueue_helpers.py:19-46``).

This module is that state machine, in-process and synchronous (trivially
testable): flavors carry nominal chip quotas (``crds/kueue/cluster-queue.yaml:13-22``),
a workload reserves ``flavor.total_chips * num_slices``, admission is
best-effort FIFO (a small job may pass a blocked large one — Kueue's
``BestEffortFIFO`` default), and gang semantics hold because a workload's chips
are reserved atomically or not at all.
"""

from __future__ import annotations

import dataclasses
import itertools
import logging

from ..devices import DeviceCatalog

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class Workload:
    """One queued/admitted job (Kueue ``Workload`` CR equivalent)."""

    job_id: str
    flavor: str
    chips: int
    queue: str
    seq: int = 0
    admitted: bool = False


class GangScheduler:
    """Quota-based all-or-nothing admission over the device catalog."""

    def __init__(self, catalog: DeviceCatalog):
        self._catalog = catalog
        self._workloads: dict[str, Workload] = {}
        # per-scheduler sequence: the previous module-global counter leaked
        # submission ordering across instances, making queue positions
        # depend on which tests (or sibling backends) ran first
        self._seq = itertools.count()

    # -- bookkeeping ---------------------------------------------------------

    def _used_chips(self, flavor: str) -> int:
        return sum(
            w.chips for w in self._workloads.values() if w.admitted and w.flavor == flavor
        )

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
    ) -> Workload:
        """Register a suspended workload (``runPolicy.suspend: true`` until
        admitted — ``PyTorchJobDeployer.py:179-185``).

        ``queue``/``priority``/``requested_slices``/``min_slices`` are accepted for
        signature parity with the fair-share scheduler
        (``sched/``) and deliberately ignored: this
        is the documented FIFO escape hatch (``FTC_SCHED_POLICY=fifo``),
        which has no tenant semantics and never resizes.
        """
        if job_id in self._workloads:
            raise ValueError(f"workload {job_id!r} already queued")
        flavor = self._catalog.get_worker(flavor_name)
        w = Workload(
            job_id=job_id,
            flavor=flavor.name,
            chips=flavor.total_chips * max(1, num_slices),
            queue=flavor.queue,
            seq=next(self._seq),
        )
        self._workloads[job_id] = w
        return w

    def try_admit(self) -> list[Workload]:
        """Admit every pending workload that fits, FIFO by submission order.

        Returns the newly admitted workloads; the backend starts them.
        """
        admitted: list[Workload] = []
        for w in sorted(self._workloads.values(), key=lambda w: w.seq):
            if w.admitted:
                continue
            quota = self._catalog.quota_for(w.flavor)
            if self._used_chips(w.flavor) + w.chips <= quota:
                w.admitted = True
                admitted.append(w)
                logger.info(
                    "admitted %s (%d chips of %s, %d/%d used)",
                    w.job_id, w.chips, w.flavor, self._used_chips(w.flavor), quota,
                )
        return admitted

    def release(self, job_id: str) -> None:
        """Free a workload's quota (job finished or deleted)."""
        self._workloads.pop(job_id, None)

    # -- queue introspection (reference: kueue_helpers.py) -------------------

    def pending(self) -> list[str]:
        """Pending job ids in queue order (``get_kueue_queue``,
        ``kueue_helpers.py:19-46``: QuotaReserved=False sorted by creation)."""
        return [
            w.job_id
            for w in sorted(self._workloads.values(), key=lambda w: w.seq)
            if not w.admitted
        ]

    def position(self, job_id: str) -> int | None:
        """1-based queue position (``get_kueue_position``,
        ``kueue_helpers.py:49-81``); None when not pending."""
        pend = self.pending()
        return pend.index(job_id) + 1 if job_id in pend else None

    def is_admitted(self, job_id: str) -> bool:
        w = self._workloads.get(job_id)
        return bool(w and w.admitted)

    def usage(self) -> dict[str, dict[str, int]]:
        """Per-flavor quota usage (admin/debug surface)."""
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
