"""Shared artifact-sync core used by the local backend's sidecar task and the
pod-side storage CLI — one implementation of the ``aws s3 sync`` semantics the
reference delegated to its sidecar container
(``app/jobs/kubeflow/PyTorchJobDeployer.py:121-168``): glob-pattern selection
(``store_asset_patterns``, ``finetuning.py:94-97``) + (mtime, size) change
detection so unchanged bytes are never re-uploaded.  A checkpoint's
uncommitted staging is never shipped: the trainer renames it into place
once it is whole, and a copy taken mid-write would stay in the store as a
partial checkpoint.  Nor is any other write still in flight: the trainer
writes ``metrics.csv``, ``heartbeat.json``, the profiler's trace and its
exports to ``<name>.tmp`` and renames them, and a ``.tmp`` caught by a
sync would stay in the store beside the file it became.
"""

from __future__ import annotations

import re
from pathlib import Path

from .objectstore import ObjectStore


#: a checkpoint save's staging, by the names ``train/checkpoint.py``'s
#: sweep removes: ``step_N.tmp``, ``step_N.manifest.tmp``, orbax's
#: ``step_N.orbax-checkpoint-tmp-<ts>`` and the port's earlier
#: ``.step_N.tmp-<pid>``; and any ``<name>.tmp``, an atomic write not yet
#: renamed into place
STAGING_RE = re.compile(
    r"^(step_\d+\.orbax-checkpoint-tmp-.*|\.step_\d+\.tmp-\d+|.+\.tmp)$"
)


def _staged(path: Path, src_dir: Path) -> bool:
    return any(STAGING_RE.match(part) for part in path.relative_to(src_dir).parts)


def matched_files(src_dir: Path, patterns: list[str] | None) -> list[Path]:
    if not src_dir.is_dir():
        return []
    if not patterns:
        found = {p for p in src_dir.rglob("*") if p.is_file()}
    else:
        found = set()
        for pattern in patterns:
            found.update(p for p in src_dir.glob(pattern) if p.is_file())
    return sorted(p for p in found if not _staged(p, src_dir))


async def sync_dir_to_store(
    store: ObjectStore,
    src_dir: Path,
    dest_uri: str,
    *,
    patterns: list[str] | None = None,
    synced: dict[str, tuple[float, int]] | None = None,
) -> int:
    """Upload changed files matching ``patterns`` under ``src_dir`` to
    ``dest_uri``; mutates ``synced`` (path → (mtime, size)) for change
    detection across calls. Returns files uploaded."""
    synced = synced if synced is not None else {}
    n = 0
    for path in matched_files(src_dir, patterns):
        rel = path.relative_to(src_dir).as_posix()
        st = path.stat()
        stamp = (st.st_mtime, st.st_size)
        if synced.get(rel) == stamp:
            continue
        await store.put_file(f"{dest_uri}/{rel}", path)
        synced[rel] = stamp
        n += 1
    return n
