"""Shared artifact-sync core used by the local backend's sidecar task and the
pod-side storage CLI — one implementation of the ``aws s3 sync`` semantics the
reference delegated to its sidecar container
(``app/jobs/kubeflow/PyTorchJobDeployer.py:121-168``): glob-pattern selection
(``store_asset_patterns``, ``finetuning.py:94-97``) + (mtime, size) change
detection so unchanged bytes are never re-uploaded.
"""

from __future__ import annotations

from pathlib import Path

from .objectstore import ObjectStore


def matched_files(src_dir: Path, patterns: list[str] | None) -> list[Path]:
    if not src_dir.is_dir():
        return []
    if not patterns:
        return sorted(p for p in src_dir.rglob("*") if p.is_file())
    out: set[Path] = set()
    for pattern in patterns:
        out.update(p for p in src_dir.glob(pattern) if p.is_file())
    return sorted(out)


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
