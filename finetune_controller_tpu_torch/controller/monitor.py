"""Job monitor — the reconciliation loop of the control plane.

Capability parity with the reference's live monitor (``app/core/monitor.py``
— SURVEY.md §2 component 14, §3.2): every tick it snapshots the backend,
computes queue positions, maps backend state → DB status with metadata merge,
pulls training metrics out of the object store for running/finished jobs,
computes training duration, deletes *succeeded* jobs from the execution
substrate (artifacts already shipped), and leaves failed jobs in place for
forensics.

Reference warts fixed (SURVEY.md §7 step 3): the backend snapshot is async
(the reference makes a blocking SDK call inside the loop,
``app/core/monitor.py:131``) and DB lookups are batched instead of N+1
(``app/core/monitor.py:151-158``).

Beyond parity, the tick is also the attachment point for the resilience
subsystem (``resilience/``): FAILED and swept-lost
jobs are handed to the :class:`~..resilience.supervisor.RetrySupervisor`
(classify → backoff → resubmit-with-resume), RUNNING jobs are checked
against their liveness lease (``resilience/heartbeat.py``), and due retries
are resubmitted — closing the failure loop the reference leaves to an
operator runbook.
"""

from __future__ import annotations

import asyncio
import contextlib
import json
import logging
import time
from typing import Any

from ..obs import events as obs_events
from ..obs.events import (
    EVENTS_FILENAME,
    append_event_safe,
    make_event,
    parse_event_lines,
)
from ..obs.trace import export_trace
from ..resilience.policy import classify_failure
from .backends.base import TrainingBackend
from .objectstore import ObjectStore
from .schemas import (
    BackendJobReport,
    BackendJobState,
    DatabaseStatus,
    JobRecord,
    MetricsDocument,
    map_backend_state,
)
from .statestore import StateStore

logger = logging.getLogger(__name__)

#: DB status transition → timeline event name (docs/observability.md)
_STATUS_EVENTS = {
    DatabaseStatus.QUEUED: obs_events.QUEUED,
    DatabaseStatus.CREATED: obs_events.ADMITTED,
    DatabaseStatus.RUNNING: obs_events.RUNNING,
    DatabaseStatus.RESTARTING: obs_events.RESTARTING,
    DatabaseStatus.SUCCEEDED: obs_events.SUCCEEDED,
    DatabaseStatus.FAILED: obs_events.FAILED,
    DatabaseStatus.UNKNOWN: obs_events.LOST,
}


class JobMonitor:
    """Poll-loop reconciler (reference: ``JobMonitor``, ``core/monitor.py:124-197``)."""

    def __init__(
        self,
        state: StateStore,
        store: ObjectStore,
        backend: TrainingBackend,
        *,
        interval_s: float = 2.0,
        supervisor=None,
        lease=None,
        obs=None,
    ):
        self.state = state
        self.store = store
        self.backend = backend
        self.interval_s = interval_s
        #: resilience attachments (None = reference-parity behavior: FAILED
        #: jobs are logged and left in place, no liveness enforcement)
        self.supervisor = supervisor  # resilience.supervisor.RetrySupervisor
        if supervisor is not None:
            # the supervisor writes terminal FAILED on paths the report loop
            # never revisits (budget spent via lease-kill/sweep, resubmit
            # failures inside its tick) — hook its terminal writes so those
            # jobs still get their trace exported
            supervisor.on_terminal = self._export_trace
        self.lease = lease  # resilience.heartbeat.LeaseChecker
        #: observability hub (obs/prom.py): queue-wait + step-phase
        #: histograms observe into it; None = no histogram observation
        self.obs = obs
        self._task: asyncio.Task | None = None
        self._stop = asyncio.Event()
        self.ticks = 0  # observability: total reconcile passes
        self.lease_kills = 0  # jobs declared stuck by the liveness lease
        #: per-job high-water mark (step) for phase-histogram observation —
        #: the stored record COUNT is not a safe watermark: the resume
        #: replay-truncation shrinks the metrics doc, and a count would
        #: observe the re-logged windows a second time
        self._phase_step_hwm: dict[str, float] = {}
        #: per-job events.jsonl byte size at the last successful ingest — a
        #: cheap stat short-circuit so an unchanged file costs no read/tick
        self._events_size: dict[str, int] = {}

    # -- lifecycle (reference: core/monitor.py:207-224) ----------------------

    def start(self) -> None:
        if self._task is not None and not self._task.done():
            return
        self._stop.clear()
        self._task = asyncio.get_running_loop().create_task(self._loop())
        logger.info("job monitor started (interval=%.1fs)", self.interval_s)

    async def stop(self) -> None:
        self._stop.set()
        if self._task is not None:
            with contextlib.suppress(asyncio.CancelledError):
                await self._task
            self._task = None
        logger.info("job monitor stopped")

    async def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                await self.tick()
            except Exception:
                logger.exception("monitor tick failed")  # keep reconciling
            with contextlib.suppress(asyncio.TimeoutError):
                await asyncio.wait_for(self._stop.wait(), timeout=self.interval_s)

    # -- one reconcile pass (reference: core/monitor.py:124-197) -------------

    #: a non-final DB job absent from the backend snapshot for longer than
    #: this is declared lost (covers the record-before-submit window)
    lost_job_grace_s: float = 30.0

    async def tick(self) -> None:
        self.ticks += 1
        reports = await self.backend.list_jobs()
        await self._sweep_lost_jobs({r.job_id for r in reports})
        if self.supervisor is not None:
            # resubmit retries whose backoff expired — runs even on an empty
            # snapshot (a RETRYING job has, by design, no backend half)
            await self.supervisor.tick()
        sched_tick = getattr(self.backend, "scheduler_tick", None)
        if sched_tick is not None:
            # tick-driven admission (docs/scheduling.md): re-evaluate
            # admission/preemption even without a submit/release edge, and
            # within the same tick that resubmitted due retries — a
            # preemptor must be admitted within one monitor tick of its
            # victims' chips freeing
            sched_tick()
        if not reports:
            return
        pending = await self.backend.queue_snapshot()  # queue order (kueue_helpers.py:19-46)
        db_jobs = await self.state.get_jobs_by_ids([r.job_id for r in reports])
        for report in reports:
            job = db_jobs.get(report.job_id)
            if job is None:
                # backend knows a job the DB doesn't — externally created or
                # the record was deleted; nothing to reconcile into
                continue
            if job.status.is_final:
                # settled: the per-job observation watermarks have no more
                # rows to gate (bounded memory across a long-lived monitor)
                self._phase_step_hwm.pop(job.job_id, None)
                self._events_size.pop(job.job_id, None)
                # skip already-final jobs (core/monitor.py:150-155); a job the
                # user cancelled still needs its backend half cleaned up —
                # including any resize reservation (it is not coming back)
                if job.status is DatabaseStatus.CANCELLED:
                    await self.backend.delete_job(
                        report.job_id, forget_reservations=True
                    )
                if job.artifacts_uri and not job.metadata.get("trace_exported"):
                    # settled outside the report loop (user cancel, a
                    # terminal write that raced this tick) while its report
                    # lingers: export the trace before the report disappears
                    await self._export_trace(job.job_id)
                continue
            if job.status is DatabaseStatus.RETRYING:
                # waiting out its backoff: the supervisor owns this job and
                # already tore the backend half down — a report that lingers
                # (delete raced/failed) is stale and must not re-enter the
                # failure path (it would burn an attempt per tick)
                continue
            # for a FAILED report the supervisor owns the status transition
            # (RETRYING or terminal FAILED) — persisting FAILED here first
            # would open a crash window in which a retryable job is stuck
            # terminally FAILED with no attempt recorded; persist the timing
            # fields/metadata under the CURRENT status instead
            keep_status = (
                report.state is BackendJobState.FAILED
                and self.supervisor is not None
            )
            await self._update_job_status(
                job, report, pending, keep_status=keep_status
            )
            status = map_backend_state(report.state)
            if status in (DatabaseStatus.RUNNING,) or status.is_final:
                await self._process_job_metrics(job)
                # trainer-side lifecycle events (checkpoint-committed, ...)
                # ride events.jsonl through the artifact channel; fold new
                # rows into the job document's timeline
                await self._ingest_trainer_events(job)
            if report.state is BackendJobState.SUCCEEDED:
                await self._export_trace(job.job_id)
                # artifacts are in the object store; free the substrate
                # (core/monitor.py:182-186), reservations included — a
                # finished job's pending grow/shrink is moot
                await self.backend.delete_job(
                    report.job_id, forget_reservations=True
                )
            elif report.state is BackendJobState.FAILED:
                await self._handle_failed(job, report)
                # terminal failures (retry budget spent / user error) freeze
                # the timeline — export the assembled trace next to the
                # artifacts while the spans are still fresh
                await self._export_trace(job.job_id)
            elif report.state is BackendJobState.RUNNING:
                await self._check_lease(job, report)

    async def _handle_failed(self, job: JobRecord, report: BackendJobReport) -> None:
        """Failure intake: classify + persist forensics, then either hand the
        job to the retry supervisor or (reference behavior) leave it FAILED
        in place for inspection (core/monitor.py:187-191)."""
        exit_code = report.metadata.get("exit_code")
        if self.supervisor is not None:
            await self.supervisor.on_job_failed(
                job, exit_code=exit_code, message=report.message,
                # a scheduler resize rides the failure path (SIGTERM → 143)
                # but resubmits at a DIFFERENT topology (docs/elasticity.md)
                resize_to=report.metadata.get("resize_to_num_slices"),
                # preemption/resize context for the timeline events the
                # supervisor appends (docs/observability.md)
                report_metadata=report.metadata,
            )
            return
        # no supervisor: still persist the failure class so users (and a
        # later-enabled supervisor) can tell an OOM from bad hyperparameters
        failure = classify_failure(exit_code, report.message)
        await self.state.update_job_status(
            job.job_id,
            DatabaseStatus.FAILED,
            metadata={"failure_class": failure.value},
        )
        logger.warning(
            "job %s failed (class=%s): %s",
            report.job_id, failure.value, report.message,
        )

    async def _check_lease(self, job: JobRecord, report: BackendJobReport) -> None:
        """Liveness lease (resilience/heartbeat.py): a RUNNING job whose
        heartbeat went stale is stuck — kill it and route it through the
        failure path like any infra failure."""
        if self.lease is None:
            return
        if not await self.lease.expired(job, report):
            return
        self.lease_kills += 1
        # the last heartbeat names where the job got stuck — log it and put
        # it on the timeline so a post-mortem starts from the right step
        last_hb = getattr(self.lease, "last_heartbeat", None) or {}
        last_step = last_hb.get("last_step", last_hb.get("step"))
        message = (
            f"liveness lease expired: no heartbeat for >{self.lease.lease_s:.0f}s"
            + (f" (last known step {last_step})" if last_step is not None else "")
        )
        logger.warning("job %s declared stuck (%s); killing", job.job_id, message)
        await self._event(
            job, obs_events.LEASE_KILLED, last_step=last_step,
            lease_s=self.lease.lease_s,
        )
        await self.backend.delete_job(job.job_id)
        if self.supervisor is not None:
            await self.supervisor.on_job_failed(job, exit_code=None, message=message)
        else:
            await self.state.update_job_status(
                job.job_id,
                DatabaseStatus.FAILED,
                metadata={
                    "backend_message": message,
                    "failure_class": classify_failure(None, message).value,
                },
                end_time=time.time(),
                queue_position=None,
            )
        # the kill deleted the backend half, so the report loop never sees a
        # FAILED report for this job — export here if the kill was terminal
        # (no-op while a retry is scheduled: the job is not final yet)
        await self._export_trace(job.job_id)

    async def _sweep_lost_jobs(self, backend_ids: set[str]) -> None:
        """Mark non-final DB jobs the backend has forgotten as UNKNOWN (or
        hand them straight to the retry supervisor).

        The reference never needed this — its substrate (the cluster) is
        durable. An in-memory backend forgets everything on process restart,
        so without the sweep a QUEUED/RUNNING record would stay live forever.
        RETRYING jobs are exempt: their backend half was deliberately torn
        down while they wait out a backoff window.
        """
        for job in await self.state.get_active_jobs():
            if job.job_id in backend_ids or job.status in (
                DatabaseStatus.UNKNOWN, DatabaseStatus.RETRYING,
            ):
                continue
            if time.time() - job.submitted_at < self.lost_job_grace_s:
                continue  # may still be inside the submit path
            message = "job no longer tracked by the backend"
            if self.supervisor is not None:
                # a vanished job is an infra failure (substrate restart, node
                # loss): hand it straight to the supervisor, which CAS-es
                # from the CURRENT status to RETRYING/FAILED in one write —
                # an UNKNOWN stopover would open a crash window in which the
                # job parks in UNKNOWN forever (the sweep skips UNKNOWN)
                logger.warning("job %s vanished from backend; supervising",
                               job.job_id)
                await self.supervisor.on_job_failed(
                    job, exit_code=None, message=message
                )
                continue
            logger.warning("job %s vanished from backend; marking unknown", job.job_id)
            await self._event(job, obs_events.LOST, message=message)
            await self.state.update_job_status(
                job.job_id,
                DatabaseStatus.UNKNOWN,
                metadata={"backend_message": message},
                queue_position=None,
            )

    async def _update_job_status(
        self,
        job: JobRecord,
        report: BackendJobReport,
        pending: list[str],
        *,
        keep_status: bool = False,
    ) -> None:
        """Map + persist one job's state (reference: ``core/monitor.py:97-122``).

        ``keep_status`` persists the fields/metadata but leaves the status
        untouched — used when a downstream owner (the retry supervisor) will
        write the real transition atomically."""
        status = job.status if keep_status else map_backend_state(report.state)
        fields: dict[str, Any] = {}
        if report.start_time is not None:
            fields["start_time"] = report.start_time
        if report.completion_time is not None:
            fields["end_time"] = report.completion_time
            if report.start_time is not None:
                # training duration (reference: core/monitor.py:56-69)
                fields["training_duration"] = report.completion_time - report.start_time
        queue_position = (
            pending.index(report.job_id) + 1 if report.job_id in pending else None
        )
        fields["queue_position"] = queue_position
        metadata: dict[str, Any] = {}
        if report.message:
            metadata["backend_message"] = report.message
        if report.metadata:
            metadata.update(report.metadata)
        changed = (
            status != job.status
            or queue_position != job.queue_position
            or "end_time" in fields
            or ("start_time" in fields and job.start_time is None)
        )
        if status != job.status:
            # timeline event BEFORE the status write: a crash in between
            # re-observes the same transition next tick and the idempotency
            # key folds the retry into exactly one event.  The key carries a
            # transition sequence number that only advances WITH the status
            # write below — so a crash-retry reuses the key (exactly-once)
            # while a genuine repeat within one attempt (pod restart →
            # RESTARTING → RUNNING recovery) gets a fresh one instead of
            # being dropped as a duplicate
            seq = int(job.metadata.get("obs_transition_seq") or 0)
            metadata["obs_transition_seq"] = seq + 1
            event = _STATUS_EVENTS.get(status)
            if event is not None:
                attempt = 1 + len(job.metadata.get("attempt_history") or [])
                attrs: dict[str, Any] = {}
                if event == obs_events.RUNNING:
                    attrs["slices"] = report.metadata.get("last_ran_num_slices")
                if report.message and event in (
                    obs_events.FAILED, obs_events.LOST,
                ):
                    attrs["message"] = report.message
                await self._event(
                    job, event, key=f"{event}:a{attempt}:t{seq}", **attrs
                )
            if (
                self.obs is not None
                and status is DatabaseStatus.RUNNING
                and job.status in (DatabaseStatus.QUEUED, DatabaseStatus.CREATED)
            ):
                # queue wait: submit (or requeue — submitted_at resets on
                # resubmission) to execution, per attempt
                started = report.start_time or time.time()
                self.obs.queue_wait_seconds.observe(
                    max(started - job.submitted_at, 0.0)
                )
        if changed:
            await self.state.update_job_status(
                job.job_id, status, metadata=metadata or None, **fields
            )

    async def _process_job_metrics(self, job: JobRecord) -> None:
        """Metrics CSV → DB records (reference: ``core/monitor.py:34-95`` +
        ``S3Handler.py:237-292``): newest ``*metrics*.csv`` under the
        artifacts prefix wins."""
        if not job.artifacts_uri:
            return
        try:
            result = await self.store.get_metrics_records(job.artifacts_uri)
        except Exception:
            logger.exception("metrics fetch failed for %s", job.job_id)
            return
        if result is None:
            return
        records, source_uri = result
        existing = await self.state.get_metrics(job.job_id)
        if existing is not None and existing.records == records:
            return  # unchanged (content compare: rewritten rows with the same
            # count must still propagate)
        if self.obs is not None:
            # step-phase histograms (docs/observability.md): each row's
            # phase_*_ms columns are one observation per phase, exactly once
            # per step — gated on a per-process step high-water mark.  The
            # stored record count is NOT a safe watermark: a crash-resume
            # truncates replayed rows from the CSV (MetricsWriter's
            # replay-drop), the doc shrinks, and a count would observe the
            # re-logged windows a second time, inflating every bucket.
            hwm = self._phase_step_hwm.get(job.job_id)
            if hwm is None:
                # first sight since this monitor started: rows already in
                # the doc belong to a previous process's histograms — only
                # genuinely new rows observe into this one
                hwm = max(
                    (
                        float(r["step"]) for r in
                        (existing.records if existing is not None else [])
                        if isinstance(r.get("step"), (int, float))
                    ),
                    default=float("-inf"),
                )
            for row in records:
                step = row.get("step")
                if not isinstance(step, (int, float)) or float(step) <= hwm:
                    continue
                self.obs.observe_step_phases(row)
                # rows are step-ascending within one CSV; max() keeps a
                # ragged row from rolling the mark backwards
                hwm = max(hwm, float(step))
            self._phase_step_hwm[job.job_id] = hwm
        await self.state.upsert_metrics(
            MetricsDocument(
                job_id=job.job_id,
                records=records,
                source_uri=source_uri,
                updated_at=time.time(),
            )
        )

    # -- observability (docs/observability.md) -------------------------------

    async def _event(self, job: JobRecord, event: str, *,
                     key: str | None = None, **attrs: Any) -> None:
        """Append a timeline event for ``job``, keyed per supervisor attempt
        so re-observed transitions stay exactly-once; best-effort — the
        timeline must never stall reconciliation.  Status transitions pass
        an episode-scoped ``key`` (see ``_update_job_status``) because the
        per-attempt default would fold a second same-attempt episode (pod
        restart → recovery) into the first."""
        attempt = 1 + len(job.metadata.get("attempt_history") or [])
        await append_event_safe(
            self.state, job.job_id, event,
            key=key or f"{event}:a{attempt}", attempt=attempt, **attrs,
        )

    async def _ingest_trainer_events(self, job: JobRecord) -> None:
        """Fold new ``events.jsonl`` rows (trainer-side lifecycle:
        train-started, checkpoint-committed, profile-captured, ...) into the
        job document's timeline.  The watermark in the job metadata is an
        optimization only — the per-line idempotency key (scoped by attempt,
        see below) is what guarantees exactly-once.  All new rows of a tick
        land in ONE batched document write."""
        if not job.artifacts_uri:
            return
        uri = f"{job.artifacts_uri}/{EVENTS_FILENAME}"
        try:
            size = await self.store.size(uri)
            if size is not None and size == self._events_size.get(job.job_id):
                return  # unchanged since the last successful ingest
            if size is None and not await self.store.exists(uri):
                return  # store can't stat cheaply; fall back to exists+read
            rows = parse_event_lines(await self.store.get_bytes(uri))
        except FileNotFoundError:
            return  # no events file yet
        except Exception:
            logger.debug("trainer-event read failed for %s", job.job_id,
                         exc_info=True)
            return
        n0 = int(job.metadata.get("obs_events_ingested") or 0)
        # Restart detection: a fresh sandbox on a backend that does not
        # stage events.jsonl back (e.g. a k8s retry pod) re-begins the file
        # at line 0 and the sidecar overwrites the stored copy — the
        # positional watermark is void.  The first line is the fingerprint
        # (append-only files never change it); a length check alone would
        # miss a restarted file that has already grown past the watermark,
        # silently dropping the new attempt's first n0 rows.  The
        # attempt-scoped keys below keep the re-scan from colliding with
        # (and being dropped as) the old attempt's lines.
        head = (
            json.dumps(rows[0], sort_keys=True) if rows else None
        )
        stored_head = job.metadata.get("obs_events_head")
        if n0 and (
            len(rows) < n0
            or (stored_head is not None and head != stored_head)
        ):
            n0 = 0
        if len(rows) <= n0:
            if size is not None:
                self._events_size[job.job_id] = size
            return
        events = []
        for idx in range(n0, len(rows)):
            row = rows[idx]
            attrs = {
                k: v for k, v in (row.get("attrs") or {}).items()
                # the file is untrusted input: an attr named after one of
                # make_event's own parameters would raise a TypeError
                if isinstance(k, str) and k not in ("event", "ts", "key")
            }
            try:
                # key on (attempt, line index): the line index alone would
                # make a restarted file's row idx collide with a prior
                # attempt's already-ingested key and silently drop the event
                attempt = attrs.get("attempt")
                attempt = (
                    int(attempt) if isinstance(attempt, (int, float)) else 0
                )
                # a garbage ts must not poison the ingest every tick — fall
                # back to make_event's now-stamp
                ts = row.get("ts")
                events.append(
                    make_event(row["event"],
                               ts=ts if isinstance(ts, (int, float)) else None,
                               key=f"trainer:a{attempt}:{idx}", **attrs)
                )
            except Exception:
                # one corrupt row (NaN attempt, ...) must not abort the
                # reconcile pass — skip it, keep the rest of the batch
                logger.debug("skipping corrupt events.jsonl row %d for %s",
                             idx, job.job_id, exc_info=True)
        try:
            await self.state.append_job_events(job.job_id, events)
            await self.state.merge_job_metadata(
                job.job_id,
                {"obs_events_ingested": len(rows), "obs_events_head": head},
            )
        except Exception:
            # best-effort (the module contract: the timeline must never
            # stall reconciliation) — the size cache stays stale so the
            # next tick retries, and the per-event keys keep that idempotent
            logger.debug("trainer-event ingest write failed for %s",
                         job.job_id, exc_info=True)
            return
        if size is not None:
            self._events_size[job.job_id] = size

    async def _export_trace(self, job_id: str) -> None:
        """Persist the assembled span tree next to the artifacts when a job
        settles — traces survive control-plane restarts and substrate
        cleanup, like the archived logs."""
        await export_trace(self.state, self.store, job_id)
