"""The job-lifecycle event timeline (docs/observability.md §Timeline).

Every plane that moves a job appends a structured event to the job document
(``StateStore.append_job_event``): the API on submit/cancel/promote, the
monitor on every observed status transition, the retry supervisor on
preempt/resize/retry/resubmit, the serve manager on load/unload.  The trainer
— which has no state-store access — appends to ``events.jsonl`` in its
artifacts dir instead; the artifact sidecar ships it and the monitor ingests
new rows into the job document (the same channel ``heartbeat.json`` rides).

Exactly-once: every emitter stamps an idempotency ``key`` and
``append_job_event`` drops duplicates, so an emitter that retries after a
crash (the monitor appends the event BEFORE the status write it describes)
converges to one event per transition instance.

Event dict shape (the timeline API serves these verbatim)::

    {"ts": 1722700000.0, "event": "running", "key": "running:a1",
     "attrs": {"attempt": 1, "slices": 2}}
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Any

logger = logging.getLogger(__name__)

EVENTS_FILENAME = "events.jsonl"

# ---------------------------------------------------------------------------
# Canonical event names (the catalog docs/observability.md documents).
# Controller-side lifecycle:
SUBMITTED = "submitted"            # API accepted the job (task_builder)
QUEUED = "queued"                  # re-entered the queue (monitor)
ADMITTED = "admitted"              # scheduler granted chips (monitor)
RUNNING = "running"                # attempt is executing (monitor)
RESTARTING = "restarting"          # backend-local restart (monitor)
PREEMPTED = "preempted"            # evicted for a preemptor (supervisor)
RESIZED = "resized"                # scheduler shrink/grow (supervisor)
RETRYING = "retrying"              # waiting out a backoff (supervisor)
RESUBMITTED = "resubmitted"        # handed back to the backend (supervisor)
SUCCEEDED = "succeeded"
FAILED = "failed"
CANCELLED = "cancelled"
LOST = "lost"                      # vanished from the backend (monitor)
LEASE_KILLED = "lease-killed"      # liveness lease expired (monitor)
PROMOTION_STARTED = "promotion-started"
PROMOTED = "promoted"
PROMOTION_FAILED = "promotion-failed"
UNPROMOTED = "unpromoted"
SERVE_LOADED = "serve-loaded"
SERVE_UNLOADED = "serve-unloaded"
PROFILE_REQUESTED = "profile-requested"
# Trainer-side (via events.jsonl → monitor ingest):
TRAIN_STARTED = "train-started"
CHECKPOINT_COMMITTED = "checkpoint-committed"
PROFILE_CAPTURED = "profile-captured"
PREEMPT_EXIT = "preempt-exit"
TRAIN_FINISHED = "train-finished"


def make_event(
    event: str,
    *,
    ts: float | None = None,
    key: str | None = None,
    **attrs: Any,
) -> dict[str, Any]:
    """One timeline event; ``key`` is the exactly-once idempotency handle."""
    doc: dict[str, Any] = {
        "ts": time.time() if ts is None else float(ts),
        "event": event,
        "attrs": {k: v for k, v in attrs.items() if v is not None},
    }
    if key:
        doc["key"] = key
    return doc


async def append_event_safe(
    state, job_id: str, event: str, *, key: str | None = None,
    ts: float | None = None, **attrs: Any,
) -> bool:
    """Best-effort timeline append shared by every control-plane emitter
    (monitor, supervisor, API, serve) — observability must never stall the
    plane that carries it.  ``state`` is duck-typed (StateStore)."""
    try:
        await state.append_job_event(
            job_id, make_event(event, key=key, ts=ts, **attrs)
        )
        return True
    except Exception:
        logger.debug("timeline append (%s) failed for %s", event, job_id,
                     exc_info=True)
        return False


class EventLogWriter:
    """Trainer-side lifecycle events, appended to ``events.jsonl`` in the
    artifacts dir (rank 0 only; stdlib-only — runs inside pods).

    Crash-safe by construction: one flushed JSON line per event, append-only.
    The file is RESTORED into a fresh sandbox on resume (``backends/local.py``
    stages it back with the checkpoints) so the line index — the monitor's
    ingest watermark — stays monotonic across attempts.
    """

    def __init__(
        self,
        artifacts_dir: str,
        *,
        trace_id: str = "",
        attempt: int = 0,
        enabled: bool = True,
    ):
        self.path = os.path.join(artifacts_dir, EVENTS_FILENAME)
        self.trace_id = trace_id
        self.attempt = attempt
        self.enabled = enabled
        self.write_failures = 0

    def emit(self, event: str, *, force: bool = False, **attrs: Any) -> bool:
        """``force=True`` writes even when the tracing kill switch disabled
        the writer — for confirmations of explicitly operator-requested
        actions (an armed profile window must never complete silently)."""
        if not (self.enabled or force):
            return False
        doc = make_event(event, **attrs)
        if self.trace_id:
            doc["trace_id"] = self.trace_id
        if self.attempt:
            doc["attrs"].setdefault("attempt", self.attempt)
        try:
            with open(self.path, "a") as f:
                f.write(json.dumps(doc) + "\n")
                f.flush()
        except OSError:
            # observability must never crash the run it observes (the
            # heartbeat writer's contract)
            self.write_failures += 1
            level = logging.WARNING if self.write_failures == 1 else logging.DEBUG
            logger.log(level, "event write to %s failed (%d so far)",
                       self.path, self.write_failures, exc_info=True)
            return False
        return True


def parse_event_lines(raw: bytes | str) -> list[dict[str, Any]]:
    """Decode an ``events.jsonl`` payload; torn/garbage lines are skipped
    (a crash mid-append must not poison the whole timeline)."""
    if isinstance(raw, bytes):
        raw = raw.decode(errors="replace")
    out: list[dict[str, Any]] = []
    for line in raw.splitlines():
        line = line.strip()
        if not line:
            continue
        try:
            doc = json.loads(line)
        except ValueError:
            continue
        if isinstance(doc, dict) and isinstance(doc.get("event"), str):
            out.append(doc)
    return out
