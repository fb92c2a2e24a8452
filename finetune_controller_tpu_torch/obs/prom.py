"""Prometheus histogram support for the ``/metrics`` exporters.

The controller's exporter (``controller/server.py::prometheus_metrics``) only
spoke gauges and counters; latency questions ("what's the p99 queue wait?",
"how is step time split across phases?") need *histograms*.  This module is
the shared implementation: cumulative ``_bucket{le=...}`` series plus
``_sum``/``_count``, rendered in the text exposition format, with bounded
label cardinality (labels are fixed small sets like the step phase — never
per-request ids).

:class:`ObsHub` is the process-wide registry a runtime carries: the monitor
observes queue waits and step phases into it, the retry supervisor observes
retry latency, the serve batcher observes TTFT, and both the API server's
``/metrics`` and the standalone monitor daemon's metrics listener render it —
alongside ``ftc_build_info`` and ``ftc_uptime_seconds`` for the process.
"""

from __future__ import annotations

import math
import time
from typing import Any, Iterable


def escape_label(value: Any) -> str:
    """Escape a label VALUE per the exposition format: backslash, double
    quote, and newline must be escaped or a hostile job_id/flavor name
    breaks the whole scrape.  The single implementation for the whole
    /metrics payload (the server aliases it as ``prom_escape``) — it lives
    here because the stdlib-only obs layer must not import the
    aiohttp-bearing server module."""
    return (
        str(value)
        .replace("\\", "\\\\")
        .replace('"', '\\"')
        .replace("\n", "\\n")
    )


def _fmt(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    out = f"{v:g}"
    return out


class Histogram:
    """One Prometheus histogram family, optionally labelled.

    ``buckets`` are the finite upper bounds (ascending); ``+Inf`` is implicit.
    ``label_names`` is a fixed tuple — every observation must supply exactly
    those labels, keeping cardinality a design-time decision.
    """

    def __init__(
        self,
        name: str,
        help_text: str,
        buckets: Iterable[float],
        label_names: tuple[str, ...] = (),
    ):
        self.name = name
        self.help_text = help_text
        self.buckets = tuple(sorted(float(b) for b in buckets))
        if not self.buckets:
            raise ValueError("histogram needs at least one finite bucket")
        self.label_names = tuple(label_names)
        #: label-values tuple -> [per-bucket counts..., +Inf count]
        self._counts: dict[tuple, list[int]] = {}
        self._sums: dict[tuple, float] = {}

    def observe(self, value: float, **labels: Any) -> None:
        if set(labels) != set(self.label_names):
            raise ValueError(
                f"{self.name}: expected labels {self.label_names}, "
                f"got {tuple(labels)}"
            )
        key = tuple(str(labels[n]) for n in self.label_names)
        counts = self._counts.get(key)
        if counts is None:
            counts = self._counts[key] = [0] * (len(self.buckets) + 1)
            self._sums[key] = 0.0
        value = float(value)
        for i, le in enumerate(self.buckets):
            if value <= le:
                counts[i] += 1
                break
        else:
            counts[-1] += 1
        self._sums[key] += value

    def count(self, **labels: Any) -> int:
        key = tuple(str(labels[n]) for n in self.label_names)
        return sum(self._counts.get(key, ()))

    def render(self) -> list[str]:
        """Text-exposition lines (``le`` buckets are CUMULATIVE per the
        format; an empty histogram renders only its TYPE/HELP header so
        scrapers learn the family exists)."""
        lines = [
            f"# HELP {self.name} {self.help_text}",
            f"# TYPE {self.name} histogram",
        ]
        for key in sorted(self._counts):
            base = ",".join(
                f'{n}="{escape_label(v)}"'
                for n, v in zip(self.label_names, key)
            )
            cum = 0
            for le, n in zip(
                self.buckets + (math.inf,), self._counts[key]
            ):
                cum += n
                label = f'{base},le="{_fmt(le)}"' if base else f'le="{_fmt(le)}"'
                lines.append(f"{self.name}_bucket{{{label}}} {cum}")
            suffix = f"{{{base}}}" if base else ""
            lines.append(f"{self.name}_sum{suffix} {self._sums[key]:g}")
            lines.append(f"{self.name}_count{suffix} {cum}")
        return lines


#: step-phase bucket bounds in MILLISECONDS — sub-ms CPU test steps through
#: multi-second large-model steps (docs/observability.md documents these)
STEP_PHASE_BUCKETS_MS = (
    0.5, 1, 2.5, 5, 10, 25, 50, 100, 250, 500, 1000, 2500, 5000, 10000, 30000,
)
#: queue wait / retry latency bounds in SECONDS
WAIT_BUCKETS_S = (0.1, 0.5, 1, 2, 5, 10, 30, 60, 120, 300, 600, 1800, 3600)
#: serve time-to-first-token bounds in SECONDS
TTFT_BUCKETS_S = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1, 2.5, 5, 10)

#: metrics-CSV column -> histogram phase label (what the monitor ingests)
PHASE_COLUMNS = {
    "phase_input_ms": "input",
    "phase_compute_ms": "compute",
    "phase_checkpoint_ms": "checkpoint",
    "phase_sync_ms": "sync",
    "phase_eval_ms": "eval",
}


class ObsHub:
    """The process's observability registry: histograms + identity series.

    One per control-plane process (``Runtime.obs``); components receive it at
    construction and observe into it, the metrics handlers render it.
    """

    def __init__(self, *, _clock=time.time):
        self._clock = _clock
        self.started_at = _clock()
        self.step_phase_ms = Histogram(
            "ftc_step_phase_ms",
            "Per-step time by trainer phase (ms), from synced metrics rows",
            STEP_PHASE_BUCKETS_MS, ("phase",),
        )
        self.queue_wait_seconds = Histogram(
            "ftc_queue_wait_seconds",
            "Submit (or requeue) to RUNNING, per attempt",
            WAIT_BUCKETS_S,
        )
        self.retry_latency_seconds = Histogram(
            "ftc_retry_latency_seconds",
            "Attempt failure to resubmission (backoff + queue)",
            WAIT_BUCKETS_S,
        )
        self.serve_ttft_seconds = Histogram(
            "ftc_serve_ttft_seconds",
            "Serve request submit to first generated token",
            TTFT_BUCKETS_S,
        )

    def observe_step_phases(self, row: dict[str, Any]) -> int:
        """Feed one metrics-CSV row's ``phase_*_ms`` columns; returns the
        number of phases observed (0 = the row carries no phase data)."""
        n = 0
        for column, phase in PHASE_COLUMNS.items():
            raw = row.get(column)
            if raw in (None, ""):
                continue
            try:
                value = float(raw)
            except (TypeError, ValueError):
                continue
            self.step_phase_ms.observe(value, phase=phase)
            n += 1
        return n

    def render(self) -> list[str]:
        lines: list[str] = []
        for hist in (
            self.step_phase_ms,
            self.queue_wait_seconds,
            self.retry_latency_seconds,
            self.serve_ttft_seconds,
        ):
            lines.extend(hist.render())
        return lines

    def render_process_info(
        self, *, process: str, version: str, backend: str
    ) -> list[str]:
        """``ftc_build_info`` (constant 1, identity in labels) and
        ``ftc_uptime_seconds`` for this process."""
        labels = (
            f'process="{escape_label(process)}",'
            f'version="{escape_label(version)}",'
            f'backend="{escape_label(backend)}"'
        )
        return [
            "# TYPE ftc_build_info gauge",
            f"ftc_build_info{{{labels}}} 1",
            "# TYPE ftc_uptime_seconds gauge",
            f'ftc_uptime_seconds{{process="{escape_label(process)}"}} '
            f"{self._clock() - self.started_at:.3f}",
        ]
