"""Job-lifecycle tracing: trace ids, OTel-compatible spans, trace assembly.

A ``trace_id`` is minted once at submit (``task_builder``) and rides the job
document, the backend dispatch env (``FTC_TRACE_ID``), supervisor
resubmissions, and serve loads — every attempt and every plane stamps the
same id, so one id names the job's whole life.

Spans are plain dicts in OTel shape (name, trace/span/parent ids, start/end
nanoseconds, attributes) so they can be shipped to any OTLP-speaking backend
without translation.  Two sources:

* the **trainer** records spans crash-safe to ``trace/trainer.jsonl`` in its
  artifacts dir (one flushed line per finished span — ``SpanRecorder``); the
  artifact sidecar ships them;
* the **controller** derives its spans from the job's event timeline
  (``build_trace``): the timeline is already recorded crash-safe in the job
  document, so the controller's span tree needs no second persistence path —
  pending/attempt/backoff/promotion/serve phases are reconstructed from the
  events they bracket, which also makes the tree gap-free by construction
  (every lifecycle event falls inside the phase span it delimits).

``GET /jobs/{id}/trace`` assembles both sources; the monitor exports the
same assembly to ``{artifacts_uri}/trace/trace.json`` when a job reaches a
terminal state, so traces survive control-plane restarts.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
import uuid
from typing import Any

logger = logging.getLogger(__name__)

TRACE_DIRNAME = "trace"
TRAINER_SPANS_FILENAME = "trainer.jsonl"

#: nesting tolerance when validating child ⊆ parent intervals — events and
#: spans share one host clock, but float epoch→ns round-trips deserve slack
_EPS_NS = int(1e6)  # 1 ms


def new_trace_id() -> str:
    """128-bit lowercase hex trace id (the OTel wire width)."""
    return uuid.uuid4().hex


def new_span_id() -> str:
    """64-bit lowercase hex span id."""
    return uuid.uuid4().hex[:16]


def make_span(
    name: str,
    trace_id: str,
    *,
    start_ns: int,
    end_ns: int | None = None,
    parent_span_id: str | None = None,
    span_id: str | None = None,
    status: str = "ok",
    **attrs: Any,
) -> dict[str, Any]:
    return {
        "name": name,
        "trace_id": trace_id,
        "span_id": span_id or new_span_id(),
        "parent_span_id": parent_span_id,
        "start_ns": int(start_ns),
        "end_ns": None if end_ns is None else int(end_ns),
        "status": status,
        "attributes": {k: v for k, v in attrs.items() if v is not None},
    }


class SpanRecorder:
    """Trainer-side span log: one flushed JSONL line per FINISHED span
    (crash-safe — a kill mid-run loses at most the spans still open).

    Stdlib-only (runs inside pods).  Thread-safe: the async-checkpoint
    thread and the fit loop may both finish spans.
    """

    def __init__(
        self,
        artifacts_dir: str,
        trace_id: str,
        *,
        service: str = "trainer",
        attempt: int = 0,
        enabled: bool = True,
        _clock_ns=time.time_ns,
    ):
        self.dir = os.path.join(artifacts_dir, TRACE_DIRNAME)
        self.path = os.path.join(self.dir, TRAINER_SPANS_FILENAME)
        self.trace_id = trace_id
        self.service = service
        self.attempt = attempt
        self.enabled = enabled and bool(trace_id)
        self._clock_ns = _clock_ns
        self._lock = threading.Lock()
        self.write_failures = 0

    def start(self, name: str, *, parent: dict | None = None,
              **attrs: Any) -> dict[str, Any]:
        span = make_span(
            name, self.trace_id,
            start_ns=self._clock_ns(),
            parent_span_id=parent["span_id"] if parent else None,
            service=self.service, attempt=self.attempt or None, **attrs,
        )
        return span

    def finish(self, span: dict[str, Any], *, status: str = "ok",
               **attrs: Any) -> None:
        span["end_ns"] = self._clock_ns()
        span["status"] = status
        if attrs:
            span["attributes"].update(
                {k: v for k, v in attrs.items() if v is not None}
            )
        if not self.enabled:
            return
        try:
            with self._lock:
                os.makedirs(self.dir, exist_ok=True)
                with open(self.path, "a") as f:
                    f.write(json.dumps(span) + "\n")
                    f.flush()
        except OSError:
            with self._lock:  # finish() races itself across threads
                self.write_failures += 1
                failures = self.write_failures
            level = logging.WARNING if failures == 1 else logging.DEBUG
            logger.log(level, "span write to %s failed (%d so far)",
                       self.path, failures, exc_info=True)

    def record(self, name: str, *, start_ns: int, end_ns: int,
               status: str = "ok", **attrs: Any) -> dict[str, Any]:
        """Append an already-timed span (e.g. one a rollout worker stamped
        with its own ``time.time_ns`` and shipped over the transport) — same
        crash-safe JSONL write as :meth:`finish`, but the interval is the
        caller's, not this recorder's clock."""
        span = make_span(
            name, self.trace_id,
            start_ns=int(start_ns), end_ns=int(end_ns), status=status,
            service=self.service, attempt=self.attempt or None, **attrs,
        )
        if not self.enabled:
            return span
        try:
            with self._lock:
                os.makedirs(self.dir, exist_ok=True)
                with open(self.path, "a") as f:
                    f.write(json.dumps(span) + "\n")
                    f.flush()
        except OSError:
            with self._lock:
                self.write_failures += 1
                failures = self.write_failures
            level = logging.WARNING if failures == 1 else logging.DEBUG
            logger.log(level, "span write to %s failed (%d so far)",
                       self.path, failures, exc_info=True)
        return span

    class _SpanCtx:
        def __init__(self, recorder: "SpanRecorder", span: dict):
            self.recorder, self.span = recorder, span

        def __enter__(self):
            return self.span

        def __exit__(self, exc_type, exc, tb):
            self.recorder.finish(
                self.span, status="error" if exc_type else "ok"
            )
            return False

    def span(self, name: str, *, parent: dict | None = None, **attrs: Any):
        """``with recorder.span("checkpoint", step=40): ...``"""
        return self._SpanCtx(self, self.start(name, parent=parent, **attrs))


def parse_span_lines(raw: bytes | str) -> list[dict[str, Any]]:
    """Decode a span JSONL payload; torn lines are skipped."""
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
        if isinstance(doc, dict) and "span_id" in doc and "start_ns" in doc:
            out.append(doc)
    return out


# ---------------------------------------------------------------------------
# Controller-side trace assembly
# ---------------------------------------------------------------------------

#: events that end the "pending" phase — it runs submit → execution (the
#: "admitted" instant stays INSIDE it so admitted→running is never a gap)
_PENDING_ENDERS = {"running", "failed", "cancelled", "succeeded"}
#: events that end an attempt span (the job left execution)
_ATTEMPT_ENDERS = {
    "retrying", "failed", "succeeded", "cancelled", "lost", "lease-killed",
}


def _ns(ts: float) -> int:
    return int(float(ts) * 1e9)


def build_trace(
    job: dict[str, Any],
    trainer_spans: list[dict[str, Any]] | None = None,
    *,
    now: float | None = None,
) -> dict[str, Any]:
    """Assemble the job's span tree from its event timeline + trainer spans.

    ``job`` is the job document (``JobRecord.model_dump()``): ``events``,
    ``metadata.trace_id``, ``submitted_at``, ``end_time``.  Returns
    ``{"trace_id", "job_id", "spans": [...], "problems": [...]}`` where
    ``problems`` is ``validate_trace``'s verdict (empty = well-formed,
    gap-free).  Phases still open when assembled are closed at ``now`` and
    marked ``in_progress``.
    """
    now = time.time() if now is None else now
    events = sorted(
        (e for e in (job.get("events") or []) if isinstance(e.get("ts"), (int, float))),
        key=lambda e: e["ts"],
    )
    trace_id = (job.get("metadata") or {}).get("trace_id") or ""
    first_ts = events[0]["ts"] if events else job.get("submitted_at") or now
    start_ts = min(first_ts, job.get("submitted_at") or first_ts)
    last_ts = events[-1]["ts"] if events else start_ts
    end_ts = job.get("end_time") or None
    root_open = end_ts is None and (job.get("status") or "") not in (
        "succeeded", "failed", "cancelled",
    )
    root_end = max(filter(None, (end_ts, last_ts, now if root_open else None)))
    root = make_span(
        "job", trace_id,
        start_ns=_ns(start_ts), end_ns=_ns(root_end),
        service="controller", job_id=job.get("job_id"),
        status_final=job.get("status"), in_progress=root_open or None,
    )
    spans: list[dict[str, Any]] = [root]

    def phase(name: str, start: float, end: float | None, **attrs):
        open_ = end is None
        spans.append(make_span(
            name, trace_id,
            start_ns=_ns(start), end_ns=_ns(root_end if open_ else end),
            parent_span_id=root["span_id"], service="controller",
            in_progress=open_ or None, **attrs,
        ))
        return spans[-1]

    pending_since: float | None = None
    attempt_since: float | None = None
    attempt_no = 0
    promo_since: float | None = None
    serve_since: float | None = None
    for e in events:
        name, ts, attrs = e["event"], e["ts"], e.get("attrs") or {}
        if name in ("submitted", "resubmitted", "queued") and pending_since is None \
                and attempt_since is None:
            pending_since = ts
        if name in _PENDING_ENDERS and pending_since is not None:
            phase("pending", pending_since, ts, attempt=attempt_no + 1)
            pending_since = None
        if name == "running" and attempt_since is None:
            attempt_no = int(attrs.get("attempt") or attempt_no + 1)
            attempt_since = ts
        if name in _ATTEMPT_ENDERS and attempt_since is not None:
            phase(f"attempt-{attempt_no}", attempt_since, ts,
                  attempt=attempt_no, ended_by=name)
            attempt_since = None
        if name == "retrying" and pending_since is None and attempt_since is None:
            pending_since = ts  # backoff + requeue until it runs again
        if name == "promotion-started":
            promo_since = ts
        if name in ("promoted", "promotion-failed", "unpromoted"):
            # a settle without a recorded start — an unpromote (nothing
            # precedes it) or a failed unpromote — still gets an
            # instantaneous span so the event is covered, not a "gap"
            phase("promotion", ts if promo_since is None else promo_since,
                  ts, outcome=name)
            promo_since = None
        if name.startswith("serve-") and name != "serve-unloaded" \
                and serve_since is None:
            # any serve-plane event opens the phase: the fleet emits
            # replica-started events while the session is still being
            # assembled, BEFORE serve-loaded lands (docs/serving.md §Fleet)
            serve_since = ts
        if name == "serve-unloaded" and serve_since is not None:
            phase("serve", serve_since, ts)
            serve_since = None
    # close still-open phases at the root's end
    if pending_since is not None:
        phase("pending", pending_since, None, attempt=attempt_no + 1)
    if attempt_since is not None:
        phase(f"attempt-{attempt_no}", attempt_since, None, attempt=attempt_no)
    if promo_since is not None:
        phase("promotion", promo_since, None)
    if serve_since is not None:
        phase("serve", serve_since, None)

    # graft trainer spans under their attempt span (matched by attempt attr;
    # unmatched spans hang off the root so nothing is dropped)
    by_attempt = {
        s["attributes"].get("attempt"): s
        for s in spans
        if s["name"].startswith("attempt-")
    }
    trainer_ids = {s.get("span_id") for s in trainer_spans or []}
    for ts_span in trainer_spans or []:
        grafted = dict(ts_span)
        if trace_id:
            grafted["trace_id"] = trace_id
        pid = grafted.get("parent_span_id")
        if pid is None or pid not in trainer_ids:
            # no recorded parent, or the parent never landed — a kill loses
            # the spans still open (the crash-safe JSONL holds FINISHED
            # spans only), so a killed job's children would dangle off the
            # lost fit span: graft under the attempt/root instead
            parent = by_attempt.get(grafted.get("attributes", {}).get("attempt"))
            grafted["parent_span_id"] = (parent or root)["span_id"]
        spans.append(grafted)

    return {
        "trace_id": trace_id,
        "job_id": job.get("job_id"),
        "spans": spans,
        "problems": validate_trace(spans, events),
    }


def validate_trace(
    spans: list[dict[str, Any]],
    events: list[dict[str, Any]] | None = None,
) -> list[str]:
    """Structural checks: every parent resolves, every child's interval nests
    inside its parent's, and (when ``events`` are given) every event instant
    is covered by at least one non-root span — the "gap-free" property the
    e2e timeline test gates on.  Returns human-readable problems; [] = ok."""
    problems: list[str] = []
    by_id = {s["span_id"]: s for s in spans}
    for s in spans:
        pid = s.get("parent_span_id")
        if pid is not None:
            parent = by_id.get(pid)
            if parent is None:
                problems.append(f"span {s['name']!r}: unknown parent {pid}")
                continue
            if s["start_ns"] < parent["start_ns"] - _EPS_NS:
                problems.append(
                    f"span {s['name']!r} starts before parent {parent['name']!r}"
                )
            if s.get("end_ns") is not None and parent.get("end_ns") is not None \
                    and s["end_ns"] > parent["end_ns"] + _EPS_NS:
                problems.append(
                    f"span {s['name']!r} ends after parent {parent['name']!r}"
                )
        if s.get("end_ns") is not None and s["end_ns"] + _EPS_NS < s["start_ns"]:
            problems.append(f"span {s['name']!r} ends before it starts")
    for e in events or []:
        ts_ns = _ns(e["ts"])
        covered = any(
            s.get("parent_span_id") is not None
            and s["start_ns"] - _EPS_NS <= ts_ns
            and (s.get("end_ns") is None or ts_ns <= s["end_ns"] + _EPS_NS)
            for s in spans
        )
        if not covered:
            problems.append(
                f"event {e['event']!r} at ts={e['ts']} not covered by any span"
            )
    return problems


async def export_trace(state, store, job_id: str) -> bool:
    """Assemble and persist ``trace/trace.json`` next to a settled job's
    artifacts — traces survive control-plane restarts and substrate cleanup.

    Best-effort and idempotent (``metadata.trace_exported`` is the latch), so
    EVERY path that settles a job calls it: the monitor's succeeded/failed
    branches, the supervisor's terminal-failure writes, the lease-kill path,
    and the API's cancel handler.  ``state``/``store`` are duck-typed
    (StateStore/ObjectStore) to keep this module dependency-free.
    """
    try:
        job = await state.get_job(job_id)
        if job is None or not job.status.is_final or not job.artifacts_uri:
            return False
        if job.metadata.get("trace_exported"):
            return False
        spans_uri = (
            f"{job.artifacts_uri}/{TRACE_DIRNAME}/{TRAINER_SPANS_FILENAME}"
        )
        trainer_spans = []
        if await store.exists(spans_uri):
            trainer_spans = parse_span_lines(await store.get_bytes(spans_uri))
        trace = build_trace(job.model_dump(mode="json"), trainer_spans)
        await store.put_bytes(
            f"{job.artifacts_uri}/{TRACE_DIRNAME}/trace.json",
            json.dumps(trace, indent=2).encode(),
        )
        await state.merge_job_metadata(job_id, {"trace_exported": True})
        return True
    except Exception:
        logger.debug("trace export failed for %s", job_id, exc_info=True)
        return False
