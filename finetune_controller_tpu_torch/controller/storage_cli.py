"""Storage CLI for job pods: dataset fetch + artifact sync.

The in-repo replacement for the ``amazon/aws-cli`` init/sidecar containers the
reference injects into every training pod
(``app/jobs/kubeflow/PyTorchJobDeployer.py:70-91`` dataset ``s3 cp``;
``:121-168`` artifact ``s3 sync`` loop with ``done.txt`` termination):

    python -m finetune_controller_tpu_torch.controller.storage_cli get obj://... /data/x
    python -m finetune_controller_tpu_torch.controller.storage_cli sync /data/artifacts \
        obj://artifacts/... --interval 60 --until-done-file /data/artifacts/done.txt

(``sync`` with ``--until-done-file`` also makes its final pass on SIGTERM and
exits 0: see :func:`cmd_sync`.)

The store comes from the settings: ``FTC_OBJECT_STORE_BACKEND=local`` with
``FTC_OBJECT_STORE_ROOT`` (a shared volume / NFS mount in-cluster), ``s3``
(``FTC_S3_ENDPOINT``, ``FTC_S3_REGION``, ``FTC_S3_BUCKET_PREFIX`` and the
``AWS_*`` credentials) or ``gcs`` (``FTC_GCS_ENDPOINT``,
``FTC_GCS_BUCKET_PREFIX``), behind the same
:class:`~finetune_controller_tpu_torch.controller.objectstore.ObjectStore`
seam.  The port's copy of the reference module.
"""

from __future__ import annotations

import argparse
import asyncio
import contextlib
import logging
import signal
from pathlib import Path

from .config import get_settings
from .objectstore import ObjectStore, build_object_store
from .syncer import sync_dir_to_store

logger = logging.getLogger(__name__)


def _store() -> ObjectStore:
    """Backend comes from env (``FTC_OBJECT_STORE_BACKEND=local|gcs|s3``) — the
    pod-side selection the round-1 build lacked (it assumed a shared
    filesystem mount, which does not survive a real GKE cluster)."""
    return build_object_store(get_settings())


async def cmd_get(uri: str, dest: str) -> int:
    store = _store()
    try:
        n = await store.get_file(uri, dest)
    finally:
        await store.close()
    logger.info("fetched %s -> %s (%d bytes)", uri, dest, n)
    return 0


async def cmd_sync(
    src: str, dest_uri: str, *, interval: float, until_done_file: str | None,
    patterns: list[str] | None,
) -> int:
    """One pass (no ``until_done_file``), or the sidecar's loop: a pass
    every ``interval`` until the done file exists, then a final pass.

    In the loop SIGTERM ends the wait at once and runs the final pass, then
    exits 0.  The kubelet SIGTERMs a native sidecar when the trainer
    container exits, most likely while the sidecar sleeps between passes:
    the reference's sidecar dies on the signal there, and the trainer's
    last files and ``done.txt`` never reach the store (ROADMAP Queue C)."""
    store = _store()
    src_path = Path(src)
    synced: dict[str, tuple[float, int]] = {}
    done = Path(until_done_file) if until_done_file else None
    stop = asyncio.Event()
    loop = asyncio.get_running_loop()
    if done is not None:
        loop.add_signal_handler(signal.SIGTERM, stop.set)
    try:
        while True:
            try:
                n = await sync_dir_to_store(
                    store, src_path, dest_uri, patterns=patterns, synced=synced
                )
                if n:
                    logger.info("synced %d file(s) -> %s", n, dest_uri)
            except Exception:
                if done is None:
                    # one-shot mode has no retry: a swallowed failure would
                    # exit 0 and the caller would treat a failed upload as
                    # success
                    logger.exception("one-shot sync failed")
                    return 1
                logger.exception("sync pass failed; retrying")
            if done is not None and (done.exists() or stop.is_set()):
                await sync_dir_to_store(  # final pass
                    store, src_path, dest_uri, patterns=patterns, synced=synced
                )
                logger.info("%s; exiting after final sync",
                            "SIGTERM" if stop.is_set() else "done-file present")
                return 0
            if done is None:
                return 0  # one-shot mode
            with contextlib.suppress(TimeoutError):
                await asyncio.wait_for(stop.wait(), interval)
    finally:
        if done is not None:
            loop.remove_signal_handler(signal.SIGTERM)
        await store.close()


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(prog="ftc-storage")
    sub = parser.add_subparsers(dest="cmd", required=True)
    g = sub.add_parser("get", help="fetch one object to a local path")
    g.add_argument("uri")
    g.add_argument("dest")
    s = sub.add_parser("sync", help="sync a directory to an object prefix")
    s.add_argument("src")
    s.add_argument("dest_uri")
    s.add_argument("--interval", type=float, default=60.0)
    s.add_argument("--until-done-file", default=None)
    s.add_argument(
        "--pattern", action="append", default=None,
        help="glob pattern to include (repeatable); default: everything",
    )
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO, force=True)
    if args.cmd == "get":
        return asyncio.run(cmd_get(args.uri, args.dest))
    return asyncio.run(
        cmd_sync(
            args.src, args.dest_uri,
            interval=args.interval, until_done_file=args.until_done_file,
            patterns=args.pattern,
        )
    )


if __name__ == "__main__":
    raise SystemExit(main())
