"""The trainer's half of job-lifecycle tracing (a copy of the reference's
``obs/trace.py`` up to its controller-side assembly).

A ``trace_id`` is minted once at submit and reaches the trainer through
``FTC_TRACE_ID``.  Spans are plain dicts in OTel shape (name, trace/span/
parent ids, start/end nanoseconds, attributes); the trainer records them
crash-safe to ``trace/trainer.jsonl`` in its artifacts dir, one flushed line
per finished span (``SpanRecorder``).  The controller's ``build_trace`` and
``validate_trace`` read that file; their port waits with the controller's.
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
