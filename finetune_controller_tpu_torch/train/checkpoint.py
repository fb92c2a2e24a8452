"""Training checkpoints in the port's own format.

Each checkpoint is a directory ``<root>/step_N/`` holding one ``state.pt``
(``torch.save`` of ``{"step", "trainable", "opt_state"}``, tensors on the
CPU).  A save writes a temporary directory beside it, syncs the file and
renames the directory into place, so a reader sees a whole checkpoint or
none.  The newest ``keep`` checkpoints stay.  The reference's orbax layout
is not read (ROADMAP Queue A item 3).
"""

from __future__ import annotations

import os
import re
import shutil
from pathlib import Path

import torch

_STEP_DIR = re.compile(r"^step_(\d+)$")


class CheckpointManager:
    def __init__(self, directory: str | os.PathLike, keep: int = 3):
        self.directory = Path(directory)
        self.keep = max(1, keep)

    def steps(self) -> list[int]:
        if not self.directory.is_dir():
            return []
        found = (_STEP_DIR.match(p.name) for p in self.directory.iterdir() if p.is_dir())
        return sorted(int(m.group(1)) for m in found if m)

    def latest_step(self) -> int | None:
        steps = self.steps()
        return steps[-1] if steps else None

    def path(self, step: int) -> Path:
        return self.directory / f"step_{step}"

    def save(self, step: int, state: dict) -> Path:
        self.directory.mkdir(parents=True, exist_ok=True)
        final = self.path(step)
        tmp = self.directory / f".step_{step}.tmp-{os.getpid()}"
        shutil.rmtree(tmp, ignore_errors=True)
        tmp.mkdir()
        with open(tmp / "state.pt", "wb") as f:
            torch.save(state, f)
            f.flush()
            os.fsync(f.fileno())
        if final.exists():  # a replayed step overwrites its earlier save
            shutil.rmtree(final)
        os.replace(tmp, final)
        for old in self.steps()[:-self.keep]:
            shutil.rmtree(self.path(old), ignore_errors=True)
        return final

    def restore(self, step: int) -> dict:
        return torch.load(self.path(step) / "state.pt", map_location="cpu", weights_only=True)
