"""Training-metrics CSV writer (a copy of the reference's ``train/metrics.py``).

Contract with the control plane (mirrors the reference's convention — model
writes ``*metrics*.csv`` under the artifacts dir, monitor syncs the newest
match into the DB; reference ``app/utils/S3Handler.py:252-258``,
``app/core/monitor.py:34-95``): one header row, one row per logging step,
flushed on every write so the monitor sees fresh data mid-run.

Standard trainer columns (``train/trainer.py`` writes them every log step):
``timestamp``, ``step``, ``loss``, ``accuracy``, ``tokens_per_sec``, and the
input-pipeline observability pair — ``input_ms`` (host time the training
thread waited per step for its next batch; with the default background
prefetch this is residual stall, not the overlapped build time) and
``input_fraction`` (that wait as a share of the logging window: ~0 means
device-bound/healthy, toward 1 means input-bound — raise the prefetch depth
or move host work off the loader). An MoE run adds ``moe_aux`` (the
weighted load-balancing term in the objective) to every row. Eval-cadence
columns (``eval_*``, including ``eval_input_ms``) are declared via
``extra_fields``.
"""

from __future__ import annotations

import csv
import os
import time
from typing import IO, Any, Mapping


class MetricsWriter:
    def __init__(
        self,
        artifacts_dir: str,
        filename: str = "metrics.csv",
        append: bool = False,
        extra_fields: tuple[str, ...] = (),
        resume_step: int | None = None,
    ):
        """``extra_fields`` declares columns that may appear only on LATER
        rows (e.g. eval metrics written on their own cadence): the header is
        pinned at the first write, so anything not present in the first row
        must be declared up front or it would be silently dropped.

        ``resume_step`` (with ``append``) is the step the run resumed FROM:
        rows past it are dropped before appending.  A crash between a logged
        row and its checkpoint's commit (SIGKILL mid-save — the chaos tests
        hit exactly this) makes the resumed run REPLAY those steps; without
        the truncation each replayed row would appear twice."""
        os.makedirs(artifacts_dir, exist_ok=True)
        self.path = os.path.join(artifacts_dir, filename)
        self._file: IO[str] | None = None
        self._writer: csv.DictWriter | None = None
        self._extra_fields = extra_fields
        self._resume_fields: list[str] | None = None
        if append and os.path.exists(self.path):
            with open(self.path) as f:
                header = f.readline().strip()
            if header:
                self._resume_fields = header.split(",")
                if resume_step is not None and "step" in self._resume_fields:
                    self._truncate_past(resume_step)

    def _truncate_past(self, resume_step: int) -> None:
        """Drop rows whose step exceeds the resume point (atomic rewrite)."""
        with open(self.path, newline="") as f:
            rows = list(csv.DictReader(f))
        kept = [
            r for r in rows
            if not r.get("step") or float(r["step"]) <= resume_step
        ]
        if len(kept) == len(rows):
            return
        tmp_path = self.path + ".tmp"
        with open(tmp_path, "w", newline="") as f:
            rewriter = csv.DictWriter(f, fieldnames=self._resume_fields)
            rewriter.writeheader()
            rewriter.writerows(kept)
        os.replace(tmp_path, self.path)

    def write(self, row: Mapping[str, Any]) -> None:
        row = {"timestamp": round(time.time(), 3), **row}
        if self._writer is None:
            if self._resume_fields is not None:
                missing = [
                    f for f in self._extra_fields if f not in self._resume_fields
                ]
                if missing:
                    # Resumed run gained new columns (e.g. eval enabled after
                    # the first leg): rewrite the file under the union header
                    # so the new columns aren't silently dropped.
                    with open(self.path, newline="") as f:
                        old_rows = list(csv.DictReader(f))
                    self._resume_fields = self._resume_fields + missing
                    # Atomic swap: a crash mid-rewrite must not lose the
                    # run's whole metrics history.
                    tmp_path = self.path + ".tmp"
                    with open(tmp_path, "w", newline="") as f:
                        rewriter = csv.DictWriter(f, fieldnames=self._resume_fields)
                        rewriter.writeheader()
                        for old in old_rows:
                            rewriter.writerow(
                                {k: old.get(k, "") for k in self._resume_fields}
                            )
                    os.replace(tmp_path, self.path)
                # Preemption-resume: keep prior rows, reuse the existing header.
                self._file = open(self.path, "a", newline="")
                self._writer = csv.DictWriter(self._file, fieldnames=self._resume_fields)
            else:
                fields = list(row.keys()) + [
                    f for f in self._extra_fields if f not in row
                ]
                self._file = open(self.path, "w", newline="")
                self._writer = csv.DictWriter(self._file, fieldnames=fields)
                self._writer.writeheader()
        self._writer.writerow({k: row.get(k, "") for k in self._writer.fieldnames})
        self._file.flush()

    def close(self) -> None:
        if self._file is not None:
            self._file.close()
            self._file = None
            self._writer = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
