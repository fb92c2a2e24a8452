"""WebSocket training-log streaming.

The port's copy of the reference module, unchanged but for this note: the
WebSocket it writes to is ``controller/web.py``'s ``WebSocketResponse``
(anything with ``send_str`` and ``closed`` does).

Capability parity with the reference's ``LogStreamManager``
(``app/utils/stream_logger.py:18-514`` — SURVEY.md §2 component 17, §3.3):

- wait-for-start with timeout, polling the DB until the job leaves the queue
  (terminal states pass straight through) — reference ``:53-109``;
- historical logs in chunks, live follow with liveness probing, last-N mode —
  reference ``:204-398`` (the per-line tail + liveness lives in
  ``TrainingBackend.read_logs``, our pod-log seam);
- a **search-string gate** that suppresses output until a marker (e.g.
  ``"Epoch"``) appears — reference ``:404-433``, default from settings
  (``LOG_STREAM_SEARCH_STRING``, ``config.py:26``).

The reference resolves the *master pod* for logs (``:138-169``); in the
multi-controller JAX runtime every worker runs the same program, so the
backend elects rank-0's log stream instead (SURVEY.md §7 hard parts).
"""

from __future__ import annotations

import asyncio
import logging
import time
from typing import Any

from .backends.base import BackendError, TrainingBackend
from .schemas import DatabaseStatus
from .statestore import StateStore

logger = logging.getLogger(__name__)


class LogStreamManager:
    """One WS session worth of log streaming."""

    def __init__(
        self,
        ws: Any,  # web.WebSocketResponse (anything with .send_str/.closed)
        job_id: str,
        state: StateStore,
        backend: TrainingBackend,
        *,
        follow: bool = True,
        last_lines: int | None = None,
        search_string: str = "",
        start_timeout_s: float = 300.0,
        start_poll_s: float = 2.0,
        chunk_lines: int = 100,
    ):
        self.ws = ws
        self.job_id = job_id
        self.state = state
        self.backend = backend
        self.follow = follow
        self.last_lines = last_lines
        self.search_string = search_string
        self.start_timeout_s = start_timeout_s
        self.start_poll_s = start_poll_s
        self.chunk_lines = chunk_lines
        self._gate_open = not search_string
        #: per-line attribution prefix (docs/observability.md): the job's
        #: trace id (short form) + attempt number, so a multi-attempt stream
        #: — retries append to the same log file — stays attributable.  The
        #: attempt number moves while a follow stream is attached (the
        #: supervisor resubmits into the same log), so the prefix is
        #: re-resolved from the DB on a poll cadence, not frozen at start
        self._prefix = ""
        self._prefix_at = 0.0  # monotonic time of the last prefix resolve

    # -- helpers -------------------------------------------------------------

    async def _send(self, text: str) -> bool:
        if getattr(self.ws, "closed", False):
            return False
        try:
            await self.ws.send_str(text)
            return True
        except Exception:
            # a dead peer ends the stream; the cause still goes somewhere
            logger.debug("ws send to %s failed; ending stream", self.job_id,
                         exc_info=True)
            return False

    def _filter(self, line: str) -> str | None:
        """Search-string gate (reference: ``stream_logger.py:404-433``):
        swallow everything until the marker appears once, then stream all.
        Passed lines gain the trace/attempt attribution prefix."""
        if self._gate_open:
            return self._prefix + line
        if self.search_string in line:
            self._gate_open = True
            return self._prefix + line
        return None

    def _set_prefix(self, job) -> None:
        self._prefix_at = time.monotonic()
        trace = ((job.metadata or {}).get("trace_id") or "")[:8]
        if trace:
            attempt = 1 + len((job.metadata or {}).get("attempt_history") or [])
            self._prefix = f"[{trace}#a{attempt}] "

    async def _refresh_prefix(self) -> None:
        """Re-resolve the attempt number mid-stream (throttled to the start
        poll cadence): lines appended by a retry attempt must carry ITS
        number — a frozen prefix would label every post-retry line with the
        attempt that was live when the stream attached."""
        if time.monotonic() - self._prefix_at < self.start_poll_s:
            return
        # re-arm the throttle BEFORE the lookup: a gone record (or an
        # erroring store) must not turn every streamed line into a DB query
        self._prefix_at = time.monotonic()
        try:
            job = await self.state.get_job(self.job_id)
        except Exception:
            # attribution must not kill a healthy stream
            logger.debug("prefix refresh failed for %s", self.job_id,
                         exc_info=True)
            return
        if job is not None:
            self._set_prefix(job)

    async def _wait_for_job_start(self) -> DatabaseStatus | None:
        """Poll the DB until the job is running or terminal (reference:
        ``stream_logger.py:53-109``). Returns the status reached, or None on
        timeout / unknown job."""
        deadline = time.monotonic() + self.start_timeout_s
        while time.monotonic() < deadline:
            job = await self.state.get_job(self.job_id)
            if job is None:
                await self._send(f"error: job {self.job_id} not found")
                return None
            if job.status in (
                DatabaseStatus.RUNNING,
                DatabaseStatus.RESTARTING,
                *DatabaseStatus.final_states(),
            ):
                self._set_prefix(job)
                return job.status
            pos = f" (queue position {job.queue_position})" if job.queue_position else ""
            await self._send(f"waiting: job is {job.status.value}{pos}")
            await asyncio.sleep(self.start_poll_s)
        await self._send("error: timed out waiting for job to start")
        return None

    # -- main ----------------------------------------------------------------

    async def run(self) -> None:
        """Reference: ``LogStreamManager.run``, ``stream_logger.py:449-514``."""
        status = await self._wait_for_job_start()
        if status is None:
            return
        follow = self.follow and status not in DatabaseStatus.final_states()
        try:
            lines = await self.backend.read_logs(
                self.job_id, follow=follow, last_lines=self.last_lines
            )
        except BackendError as e:
            # terminal job already cleaned from the substrate: logs are gone
            # (the reference has the same property once pods are deleted)
            await self._send(f"logs unavailable: {e}")
            return
        sent = 0
        buffer: list[str] = []
        # live follow sends per line; historical bulk sends chunked
        # (reference :204-250 vs :286-341)
        chunk = 1 if follow else self.chunk_lines
        try:
            async for line in lines:
                if follow:
                    # a retry lands well after the backoff, so the throttled
                    # refresh settles on the new attempt before its first line
                    await self._refresh_prefix()
                filtered = self._filter(line)
                if filtered is None:
                    continue
                buffer.append(filtered)
                if len(buffer) >= chunk:
                    if not await self._send("\n".join(buffer)):
                        return
                    sent += len(buffer)
                    buffer.clear()
                    await asyncio.sleep(0)
            if buffer and await self._send("\n".join(buffer)):
                sent += len(buffer)
        finally:
            logger.debug("log stream for %s done (%d lines)", self.job_id, sent)
