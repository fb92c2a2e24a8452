"""The retry supervisor: closes the controller half of the failure loop.

The trainer half of elastic recovery already exists (save-on-SIGTERM, atomic
checkpoints, resume from the latest); what was missing is the reconciler
that USES it: the reference monitor logs a warning on FAILED and walks away
(``app/core/monitor.py:187-191``), so no job is ever retried.

On a FAILED/UNKNOWN/stuck job the supervisor:

1. **classifies** the failure (``resilience/policy.py``) — infra/preemption
   is retryable, a deterministic user error is terminal;
2. **records the attempt** in the state store: the job moves to the new
   ``RETRYING`` status and its ``metadata.attempt_history`` gains an entry
   (attempt number, exit code, failure class, backoff delay) — the API
   serves this with the job document, so users see *why* their job is
   respawning;
3. **resubmits with resume**: after the backoff expires, the job is handed
   back to the backend with its original spec/flavor/dataset/artifacts URIs.
   The backend stages committed checkpoints back into the fresh substrate
   (``backends/local.py``), and the trainer's ``resume=True`` path continues
   from the latest committed step instead of restarting.

Crash-safety: the schedule lives in the job document (``retry_next_at``),
not in supervisor memory — a restarted control plane re-adopts every
RETRYING job on its first tick.
"""

from __future__ import annotations

import logging
import time
from typing import Any

from ..controller import registry
from ..controller.schemas import DatabaseStatus, JobInput, JobRecord
from ..obs import events as obs_events
from ..obs.events import append_event_safe
from .policy import FailureClass, RetryPolicy

logger = logging.getLogger(__name__)


class RetrySupervisor:
    """Reconciler woven into ``JobMonitor.tick`` (see controller/monitor.py)."""

    def __init__(
        self,
        state,
        backend,
        catalog,
        *,
        policy: RetryPolicy | None = None,
        obs=None,
        _clock=time.time,
    ):
        self.state = state
        self.backend = backend
        self.catalog = catalog
        self.policy = policy or RetryPolicy()
        #: observability hub (obs/prom.py) for the retry-latency histogram
        self.obs = obs
        #: async ``(job_id) -> None`` hook fired after any terminal FAILED
        #: write — the monitor wires its trace export here, because several
        #: of these writes happen on paths its report loop never revisits
        #: (lease-kill/sweep budgets, resubmit failures inside tick)
        self.on_terminal = None
        self._clock = _clock
        # observability (admin/resilience route)
        self.retries_scheduled = 0
        self.resubmits = 0
        self.terminal_failures = 0
        #: scheduler resizes routed through the retry loop (shrink + grow)
        self.resizes = 0
        #: resubmissions at a topology different from the previous attempt's
        #: — each one is a cross-topology (elastic) restore downstream
        self.elastic_restores = 0
        #: topologies downgraded because the recorded size no longer fits
        #: the device catalog (catalog shrank across a controller restart)
        self.topology_downgrades = 0

    # -- failure intake -------------------------------------------------------

    async def _event(self, job_id: str, event: str, *, key: str,
                     **attrs) -> None:
        """Best-effort timeline append (docs/observability.md) — the retry
        loop must never stall on the timeline."""
        await append_event_safe(self.state, job_id, event, key=key, **attrs)

    async def _terminal(self, job_id: str) -> None:
        """Fire the terminal hook (best-effort)."""
        if self.on_terminal is None:
            return
        try:
            await self.on_terminal(job_id)
        except Exception:
            logger.debug("terminal hook failed for %s", job_id, exc_info=True)

    async def on_job_failed(
        self,
        job: JobRecord,
        *,
        exit_code: int | None = None,
        message: str = "",
        resize_to: int | None = None,
        report_metadata: dict[str, Any] | None = None,
    ) -> bool:
        """Classify one failed attempt; schedule a retry or record the
        terminal failure.  Returns True when a retry was scheduled.

        ``resize_to`` marks a scheduler resize (docs/elasticity.md): the
        exit is deliberate (shrink or grow), so it neither burns the retry
        budget nor waits out a backoff — the resubmit topology is recorded
        crash-safe in ``metadata.current_num_slices`` and the job re-enters
        the queue immediately (its chips are reserved scheduler-side).
        """
        failure = self.policy.classify(exit_code, message)
        history = list(job.metadata.get("attempt_history") or [])
        # resizes are scheduler-initiated restarts, not failures: exempt
        # them from the attempt budget or steady contention churn would
        # terminally fail a healthy job
        attempt = 1 + sum(1 for h in history if not h.get("resize"))
        prev_delay = history[-1].get("delay_s") if history else None
        entry: dict[str, Any] = {
            "attempt": attempt,
            "ended_at": self._clock(),
            "exit_code": exit_code,
            "failure_class": failure.value,
            "message": message,
        }
        if resize_to is not None:
            entry["resize"] = True
            entry["resize_to_num_slices"] = int(resize_to)
        if resize_to is None and not self.policy.should_retry(failure, attempt):
            entry["delay_s"] = None
            history.append(entry)
            # timeline BEFORE the CAS (the monitor's event-before-write
            # rule): a crash in between re-runs the intake (the report is
            # still there) and the key folds the retry into one event; an
            # event appended AFTER a committed CAS would be lost forever on
            # a crash — the intake never re-runs once the status moved.
            # Events carry the DISPATCH number (1+prior history entries,
            # resizes included) — the numbering the monitor's running
            # event, FTC_ATTEMPT, and the trainer spans all use; `attempt`
            # above is the budget count, which excludes resizes
            await self._event(
                job.job_id, obs_events.FAILED,
                key=f"failed:i{len(history)}",
                attempt=len(history), failure_class=failure.value,
                exit_code=exit_code, message=message or None, terminal=True,
            )
            # compare-and-set from the status the caller snapshotted: a user
            # cancel interleaving inside the monitor tick's await windows
            # must win, not be overwritten by the failure transition (the
            # pre-appended event then records an intake that lost its race
            # — the failure itself still happened)
            ok = await self.state.transition_job_status(
                job.job_id,
                job.status,
                DatabaseStatus.FAILED,
                metadata={
                    "attempt_history": history,
                    "failure_class": failure.value,
                    "retry_next_at": None,
                },
                queue_position=None,
            )
            if not ok:
                logger.warning(
                    "job %s moved on during failure intake (user cancel?); "
                    "leaving it be", job.job_id,
                )
                return False
            self.terminal_failures += 1
            await self._terminal(job.job_id)
            logger.warning(
                "job %s failed terminally (class=%s attempt=%d/%d): %s",
                job.job_id, failure.value, attempt,
                self.policy.max_attempts, message,
            )
            return False
        if resize_to is not None:
            # deliberate resize: chips are reserved for the resubmit, so a
            # backoff would only idle them — resume on the next tick
            delay = 0.0
        else:
            delay = self.policy.next_delay(prev_delay)
        entry["delay_s"] = delay
        history.append(entry)
        # timeline BEFORE the CAS (docs/observability.md): a resize or
        # preemption instant, then the retrying transition — keyed per
        # intake so a crash-rerun of the intake stays exactly-once, while a
        # crash AFTER a committed CAS can no longer lose them (the intake
        # never re-runs once the job is RETRYING)
        n = len(history)
        report_metadata = report_metadata or {}
        if resize_to is not None:
            await self._event(
                job.job_id, obs_events.RESIZED, key=f"resized:i{n}",
                kind=report_metadata.get("resize_kind") or None,
                to_slices=int(resize_to),
                by=report_metadata.get("preempted_by") or None,
            )
        elif report_metadata.get("preempted") or job.metadata.get("preempted"):
            await self._event(
                job.job_id, obs_events.PREEMPTED, key=f"preempted:i{n}",
                by=(report_metadata.get("preempted_by")
                    or job.metadata.get("preempted_by") or None),
                exit_code=exit_code,
            )
        # `attempt=n`: the dispatch that just ended (1+prior history entries,
        # resizes included) — matches the monitor's running event,
        # FTC_ATTEMPT, and the trainer spans; the budget count (`attempt`
        # above, resize-exempt) stays in the log line and attempt_history
        await self._event(
            job.job_id, obs_events.RETRYING, key=f"retrying:i{n}",
            attempt=n, failure_class=failure.value, delay_s=delay,
            resize=bool(resize_to is not None) or None,
        )
        retry_metadata: dict[str, Any] = {
            "attempt_history": history,
            "failure_class": failure.value,
            "retry_next_at": self._clock() + delay,
        }
        if resize_to is not None:
            retry_metadata["current_num_slices"] = int(resize_to)
        ok = await self.state.transition_job_status(
            job.job_id,
            job.status,
            DatabaseStatus.RETRYING,
            metadata=retry_metadata,
            queue_position=None,
        )
        if not ok:
            logger.warning(
                "job %s moved on during failure intake (user cancel?); "
                "not scheduling a retry", job.job_id,
            )
            return False
        self.retries_scheduled += 1
        if resize_to is not None:
            self.resizes += 1
        # clear the substrate half now so the backoff window starts from a
        # clean slate (artifacts — including checkpoints — are already in
        # the object store; the final sync ran before FAILED became visible)
        try:
            await self.backend.delete_job(job.job_id)
        except Exception:
            logger.exception("substrate cleanup failed for %s", job.job_id)
        logger.warning(
            "job %s failed (class=%s, attempt %d/%d): retrying in %.1fs",
            job.job_id, failure.value, attempt, self.policy.max_attempts, delay,
        )
        return True

    # -- resubmission ---------------------------------------------------------

    async def tick(self) -> int:
        """Resubmit every RETRYING job whose backoff has expired; returns the
        number resubmitted.  Called from the monitor's reconcile pass."""
        now = self._clock()
        n = 0
        for job in await self.state.get_jobs_by_status(DatabaseStatus.RETRYING):
            due = job.metadata.get("retry_next_at")
            # a missing due time means a crash landed between the status
            # write and the metadata merge — treat as due NOW so the job
            # self-heals instead of sitting RETRYING forever
            if due is not None and due > now:
                continue
            if await self._resubmit(job):
                n += 1
        return n

    async def pending_retries(self) -> list[dict[str, Any]]:
        """Snapshot for the admin surface: jobs waiting out their backoff."""
        out = []
        for job in await self.state.get_jobs_by_status(DatabaseStatus.RETRYING):
            history = job.metadata.get("attempt_history") or []
            out.append({
                "job_id": job.job_id,
                "attempts": len(history),
                "failure_class": job.metadata.get("failure_class"),
                "retry_next_at": job.metadata.get("retry_next_at"),
            })
        return out

    async def _resubmit(self, job: JobRecord) -> bool:
        cls = registry.get_spec(job.model_name)
        if cls is None:
            # the model's spec class is gone (unloaded plugin): terminal —
            # there is nothing to render a submission from
            await self.state.update_job_status(
                job.job_id,
                DatabaseStatus.FAILED,
                metadata={
                    "failure_class": FailureClass.USER.value,
                    "retry_next_at": None,
                    "backend_message": (
                        f"model {job.model_name!r} is no longer registered"
                    ),
                },
                queue_position=None,
            )
            await self._terminal(job.job_id)
            return False
        current = await self.state.get_job(job.job_id)
        if current is None or current.status is not DatabaseStatus.RETRYING:
            # cancelled (or otherwise moved on) while waiting out the backoff
            return False
        try:
            spec = cls(training_arguments=job.arguments)
            flavor = self.catalog.get_worker(job.device)
            # topology selection (docs/elasticity.md): resume at the
            # resized topology when one is recorded, else the original ask
            target = int(job.metadata.get("current_num_slices") or job.num_slices)
            downgraded_from: int | None = None
            quota = self.catalog.quota_for(flavor.name)
            if flavor.total_chips * target > quota:
                # the recorded topology no longer fits the device catalog
                # (catalog shrank across a controller restart): requeue at
                # the largest feasible size instead of stranding the job in
                # a submit-reject loop
                # the port trains on one device (ROADMAP Queue A item 7):
                # the one feasible topology is one slice, if it fits
                feasible = 1 if 0 < flavor.total_chips <= quota else 0
                if feasible < 1:
                    await self.state.update_job_status(
                        job.job_id,
                        DatabaseStatus.FAILED,
                        metadata={
                            "failure_class": FailureClass.USER.value,
                            "retry_next_at": None,
                            "backend_message": (
                                f"device {flavor.name!r} quota ({quota} chips)"
                                f" no longer fits even one slice "
                                f"({flavor.total_chips} chips)"
                            ),
                        },
                        queue_position=None,
                    )
                    self.terminal_failures += 1
                    await self._terminal(job.job_id)
                    return False
                downgraded_from = target
                self.topology_downgrades += 1
                logger.warning(
                    "job %s: recorded topology %d slices of %s (%d chips) no "
                    "longer fits the quota (%d); downgrading to %d slices",
                    job.job_id, target, flavor.name,
                    flavor.total_chips * target, quota, feasible,
                )
                target = feasible
            prev_ran = int(job.metadata.get("last_ran_num_slices") or job.num_slices)
            attempt_no = 1 + len(job.metadata.get("attempt_history") or [])
            await self.backend.submit(
                JobInput(
                    job_id=job.job_id,
                    user_id=job.user_id,
                    model_name=job.model_name,
                    device=job.device,
                    num_slices=target,
                    requested_num_slices=job.num_slices,
                    arguments=job.arguments,
                    # a retried (or preempted) job re-enters its tenant
                    # queue at its original priority (docs/scheduling.md)
                    queue=job.metadata.get("queue") or "default",
                    priority=job.metadata.get("priority", "normal"),
                    # same trace across attempts; the attempt number stamps
                    # the trainer env/log stream (docs/observability.md)
                    trace_id=job.metadata.get("trace_id") or "",
                    attempt=attempt_no,
                ),
                spec,
                flavor,
                dataset_uri=job.dataset_uri,
                artifacts_uri=job.artifacts_uri,
            )
        except Exception as exc:
            logger.exception("resubmit of %s failed", job.job_id)
            # a failed resubmit is itself an infra failure: burn an attempt,
            # back off again (or land terminally once the budget is spent)
            await self.on_job_failed(
                job, exit_code=None, message=f"resubmit failed: {exc}"
            )
            return False
        resub_metadata: dict[str, Any] = {
            "retry_next_at": None,
            "current_num_slices": target,
            "last_ran_num_slices": target,
        }
        if downgraded_from is not None:
            resub_metadata["topology_downgraded"] = {
                "from_num_slices": downgraded_from,
                "to_num_slices": target,
                "at": self._clock(),
            }
        history = job.metadata.get("attempt_history") or []
        # event BEFORE the CAS (same rule as the failure intake): a crash in
        # between re-runs the resubmit and the key dedupes; after a
        # committed CAS the event could never be recovered
        await self._event(
            job.job_id, obs_events.RESUBMITTED,
            key=f"resubmitted:i{len(history)}",
            attempt=attempt_no, num_slices=target,
            downgraded_from=downgraded_from,
        )
        # compare-and-set: a user cancel can land inside submit's await
        # window, and resurrecting a job the user was told is cancelled
        # would be a silent override — on a lost race, roll the fresh
        # backend half back instead
        ok = await self.state.transition_job_status(
            job.job_id,
            DatabaseStatus.RETRYING,
            DatabaseStatus.QUEUED,
            metadata=resub_metadata,
            submitted_at=self._clock(),
            start_time=None,
            end_time=None,
            training_duration=None,
            queue_position=None,
        )
        if not ok:
            logger.warning(
                "job %s left RETRYING during resubmit (user cancel?); "
                "rolling the respawn back", job.job_id,
            )
            try:
                await self.backend.delete_job(job.job_id)
            except Exception:
                logger.exception("rollback of %s failed", job.job_id)
            return False
        self.resubmits += 1
        if self.obs is not None and history:
            # failure-to-resubmission latency (backoff + scheduling)
            ended = history[-1].get("ended_at")
            if isinstance(ended, (int, float)):
                self.obs.retry_latency_seconds.observe(
                    max(self._clock() - ended, 0.0)
                )
        if target != prev_ran:
            # the next attempt restores the checkpoint onto a different
            # topology — the elastic-restore path (train/elastic.py)
            self.elastic_restores += 1
            logger.info(
                "job %s resubmitted at %d slices (previous attempt ran %d): "
                "elastic restore", job.job_id, target, prev_ran,
            )
        logger.info(
            "job %s resubmitted (attempt %d)", job.job_id,
            len(job.metadata.get("attempt_history") or []) + 1,
        )
        return True
