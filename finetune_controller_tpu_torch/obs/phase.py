"""The trainer's step-phase clock (a copy of the reference's
``obs/phase.py``): where does a training step's time go?

Every logging window is split into **input-wait**, **checkpoint** (host
copy + save), **sync** (heartbeat), **eval**, and the residual **compute**
(the window wall clock the other phases don't claim).  Per-step averages
land in the metrics CSV as ``phase_*_ms`` columns.

Measurement is host-side ``perf_counter`` bracketing — a handful of calls
per step, no device syncs added.  The port launches CUDA work
asynchronously, so the device time of a step lands in the residual at the
point where the trainer reads the step's metrics back (``train/trainer.py``
says where).
"""

from __future__ import annotations

import time


class PhaseClock:
    """Accumulates named phase seconds over one logging window."""

    #: phases measured directly; "compute" is the residual
    MEASURED = ("input", "checkpoint", "sync", "eval")

    def __init__(self, *, _clock=time.perf_counter):
        self._clock = _clock
        self._acc: dict[str, float] = {}

    def add(self, phase: str, seconds: float) -> None:
        self._acc[phase] = self._acc.get(phase, 0.0) + seconds

    class _PhaseCtx:
        __slots__ = ("clock", "phase", "t0")

        def __init__(self, clock: "PhaseClock", phase: str):
            self.clock, self.phase = clock, phase

        def __enter__(self):
            self.t0 = self.clock._clock()
            return self

        def __exit__(self, *exc):
            self.clock.add(self.phase, self.clock._clock() - self.t0)
            return False

    def phase(self, name: str) -> "_PhaseCtx":
        """``with clock.phase("checkpoint"): ...``"""
        return self._PhaseCtx(self, name)

    def window_row(self, *, steps: int, wall_s: float) -> dict[str, float]:
        """Per-step averages (ms) for the window, then reset.

        ``compute`` is the residual ``wall - sum(measured phases)`` clamped
        at 0 — with async dispatch the device work completes inside the wall
        clock even though no single bracket captured it."""
        steps = max(steps, 1)
        measured = sum(self._acc.values())
        row = {
            f"phase_{name}_ms": self._acc.get(name, 0.0) / steps * 1000.0
            for name in self.MEASURED
        }
        row["phase_compute_ms"] = max(wall_s - measured, 0.0) / steps * 1000.0
        self._acc.clear()
        return row

    @staticmethod
    def columns() -> tuple[str, ...]:
        """CSV columns :meth:`window_row` emits — declared up front so the
        MetricsWriter header includes them (``train/trainer.py``)."""
        return tuple(
            f"phase_{name}_ms" for name in PhaseClock.MEASURED
        ) + ("phase_compute_ms",)
