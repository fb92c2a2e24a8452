"""Trainer liveness: heartbeat emission + the monitor-side lease check (a
copy of the reference's ``resilience/heartbeat.py``).

A job can stop making progress without exiting — a deadlocked collective, a
host stuck in disk wait, an input pipeline waiting on a dead socket.  The
backend sees a healthy process; the user sees a flat metrics curve and a
burning TPU reservation.  The reference has nothing for this (its monitor
maps pod phases only).

The loop closed here:

- the **trainer** writes ``heartbeat.json`` (step + wall-clock timestamp)
  into the artifacts dir on a throttle (``HeartbeatWriter``); the artifact
  sidecar ships it with everything else, so the heartbeat rides the existing
  artifact channel — no new transport, and it works on any backend whose
  artifacts sync;
- the **monitor** checks the lease (``LeaseChecker``): a RUNNING job whose
  latest heartbeat is older than ``lease_s`` is declared stuck, killed, and
  handed to the retry supervisor like any infra failure.

Safety property: a job that never emitted a heartbeat (older trainer image,
heartbeats disabled) is NEVER declared stuck — the lease only binds once the
trainer has proven it knows how to beat.  A heartbeat older than the current
attempt's start time is likewise ignored (it is the previous attempt's dying
breath, restored or re-synced).

Writer side is stdlib-only on purpose: the trainer imports it inside pods
that carry none of the controller extras.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Any

logger = logging.getLogger(__name__)

HEARTBEAT_FILENAME = "heartbeat.json"


class HeartbeatWriter:
    """Throttled atomic heartbeat file writer (trainer side, rank 0 only)."""

    def __init__(
        self,
        artifacts_dir: str,
        interval_s: float = 10.0,
        *,
        _clock=time.time,
    ):
        self.path = os.path.join(artifacts_dir, HEARTBEAT_FILENAME)
        self.interval_s = interval_s
        self._clock = _clock
        self._started = _clock()
        self._last_write: float | None = None
        self.beats = 0  # observability / tests
        self.write_failures = 0

    def beat(self, step: int, *, step_ms: float | None = None,
             force: bool = False) -> bool:
        """Record liveness at ``step``; returns True when a write happened.

        ``step_ms`` is the most recent step's wall time — with ``last_step``
        it gives the monitor a per-job progress RATE, not just "alive"
        (``GET /admin/resilience`` surfaces both).

        Throttled to one write per ``interval_s`` so a milliseconds-scale
        step loop doesn't turn the heartbeat into an I/O hot path.  The write
        is tmp-then-rename atomic: the artifact sidecar must never ship a
        torn JSON file.
        """
        now = self._clock()
        if (
            not force
            and self._last_write is not None
            and now - self._last_write < self.interval_s
        ):
            return False
        payload = {
            "step": int(step),
            # explicit alias: consumers (admin surface, lease kill logs)
            # read last_step without knowing the writer's vintage
            "last_step": int(step),
            "ts": now,
            "wall_time_s": now - self._started,
            "pid": os.getpid(),
        }
        if step_ms is not None:
            payload["last_step_ms"] = round(float(step_ms), 3)
        tmp = f"{self.path}.tmp"
        try:
            with open(tmp, "w") as f:
                json.dump(payload, f)
            os.replace(tmp, self.path)
        except OSError:
            # best-effort liveness aid: a transient ENOSPC/NFS blip must not
            # crash the training run it exists to protect — the lease side
            # already tolerates staleness up to lease_s
            self.write_failures += 1
            level = logging.WARNING if self.write_failures == 1 else logging.DEBUG
            logger.log(level, "heartbeat write to %s failed (%d so far)",
                       self.path, self.write_failures, exc_info=True)
            return False
        self._last_write = now
        self.beats += 1
        return True


def parse_heartbeat(raw: bytes | str) -> dict[str, Any] | None:
    """Decode a heartbeat document; None when torn/invalid (never raises)."""
    try:
        doc = json.loads(raw)
    except (ValueError, TypeError):
        return None
    if not isinstance(doc, dict) or not isinstance(doc.get("ts"), (int, float)):
        return None
    return doc


class LeaseChecker:
    """Monitor-side liveness lease over the object store.

    ``lease_s`` must comfortably exceed the artifact sync cadence (the
    heartbeat's freshness through the store is bounded by it) plus the
    heartbeat interval; the runtime wiring enforces a floor.
    """

    def __init__(self, store, *, lease_s: float = 300.0, _clock=time.time):
        self.store = store
        self.lease_s = lease_s
        self._clock = _clock
        #: the most recent heartbeat document :meth:`expired` parsed — the
        #: monitor reads ``last_step``/``last_step_ms`` from it when it kills
        #: a stuck job, and ``GET /admin/resilience`` renders progress from it
        self.last_heartbeat: dict[str, Any] | None = None

    async def expired(self, job, report) -> bool:
        """True when ``job`` (a RUNNING JobRecord) holds an expired lease.

        ``report`` is the backend's current BackendJobReport — its
        ``start_time`` anchors the current attempt so heartbeats from a
        previous attempt can't keep a stuck respawn alive (or kill a healthy
        one).
        """
        artifacts_uri = getattr(job, "artifacts_uri", None)
        if not artifacts_uri or self.lease_s <= 0:
            return False
        uri = f"{artifacts_uri}/{HEARTBEAT_FILENAME}"
        try:
            if not await self.store.exists(uri):
                return False  # trainer never beat: the lease does not bind
            raw = await self.store.get_bytes(uri)
        except Exception:
            # a store hiccup must not kill a healthy job
            logger.warning("lease check: heartbeat read failed for %s",
                           job.job_id, exc_info=True)
            return False
        hb = parse_heartbeat(raw)
        if hb is None:
            return False
        self.last_heartbeat = hb
        start = report.start_time if report.start_time is not None else (
            getattr(job, "start_time", None) or 0.0
        )
        if hb["ts"] < start:
            return False  # previous attempt's heartbeat — current one has grace
        return self._clock() - hb["ts"] > self.lease_s


def read_heartbeat_file(path: str) -> dict[str, Any] | None:
    """Read + parse a LOCAL heartbeat file (the serve-worker liveness path,
    docs/serving.md §Cross-process transport — the trainer/monitor pair reads
    through the object store instead, :class:`LeaseChecker`).  None when the
    file is missing, torn, or unreadable: the caller's lease must never bind
    on a beat the worker has not proven it can write.  Synchronous — async
    callers wrap it in ``asyncio.to_thread``."""
    try:
        with open(path, "rb") as f:
            raw = f.read()
    except OSError:
        return None
    return parse_heartbeat(raw)
