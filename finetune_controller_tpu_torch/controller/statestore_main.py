"""Shared state-service daemon entrypoint.

``python -m finetune_controller_tpu_torch.controller.statestore_main`` — the
process API×N replicas and the monitor point ``state_backend=remote`` at
(the role MongoDB plays for the reference, ``app/database/db.py:51``).

Env: ``FTC_STATE_TOKEN`` (bearer token the clients must present; strongly
recommended outside local dev).

The port's copy serves on ``controller/web.py``; SIGINT or SIGTERM stops it
cleanly (exit 0) with the database closed.
"""

from __future__ import annotations

import argparse
import logging
import os


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="ftc-statestore")
    p.add_argument("--state-dir", required=True,
                   help="directory for the backing sqlite-WAL database")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8081)
    args = p.parse_args(argv)
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname)s %(name)s: %(message)s",
    )

    from . import web
    from .statestore import StateStore
    from .statestore_service import build_state_app

    store = StateStore(args.state_dir, backend="sqlite")
    token = os.environ.get("FTC_STATE_TOKEN", "")
    if not token:
        logging.getLogger(__name__).warning(
            "FTC_STATE_TOKEN unset: the state service accepts unauthenticated "
            "requests — fine for local dev, not for a cluster"
        )
    app = build_state_app(store, token)

    async def connect(app) -> None:
        await store.connect()

    async def close(app) -> None:
        await store.close()

    # the database opens and closes on the serving loop
    app.on_startup.append(connect)
    app.on_cleanup.append(close)
    web.run_app(app, host=args.host, port=args.port)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
