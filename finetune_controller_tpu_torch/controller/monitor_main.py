"""Standalone monitor daemon: ``python -m finetune_controller_tpu_torch.controller.monitor_main``.

Capability parity with the reference's monitor entrypoint
(``app/monitor_main.py:19-89`` — SURVEY.md §2 component 15): an asyncio
service with signal handlers and clean shutdown, running the reconciler
forever. Meaningful for cluster-shared backends (k8s); with the in-process
local backend the monitor instead runs inside the API process
(``Settings.monitor_in_process``, reference ``DEV_LOCAL_JOB_MONITOR``
``app/main.py:91-99``).

Observability (docs/observability.md): with ``FTC_MONITOR_METRICS_PORT > 0``
the daemon serves the same ``/metrics`` exposition as the API server —
``ftc_build_info{process="monitor"}`` / ``ftc_uptime_seconds`` plus the
histograms THIS process observes (queue wait, retry latency, step phases) —
so a split deployment scrapes both halves of the control plane.

The port's copy serves ``/metrics`` on ``controller/web.py``.  The local
backend keeps its job handles in the process that started the job, so a
daemon beside an API process on the local backend reconciles none of that
process's live jobs: the split layout runs on the k8s backend
(``FTC_BACKEND=k8s``), whose jobs live in the cluster.
"""

from __future__ import annotations

import asyncio
import logging
import signal

from . import web
from .logging_config import setup_logging
from .runtime import build_runtime

logger = logging.getLogger(__name__)


async def _start_metrics_listener(runtime, port: int):
    """Mount the server module's /metrics handler on a bare app — one
    exposition implementation for both processes, labelled by PROCESS_KEY."""
    from .server import PROCESS_KEY, RUNTIME_KEY, prometheus_metrics

    app = web.Application()
    app[RUNTIME_KEY] = runtime
    app[PROCESS_KEY] = "monitor"
    app.router.add_get("/metrics", prometheus_metrics)
    runner = web.AppRunner(app)
    await runner.setup()
    site = web.TCPSite(runner, "0.0.0.0", port)
    await site.start()
    logger.info("monitor /metrics listening on :%d", port)
    return runner


async def amain() -> None:
    # ftc: ignore[blocking-io-in-async-transitive] -- startup path: the device-catalog read runs once, before the loop serves anything
    runtime = build_runtime()
    stop = asyncio.Event()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGINT, signal.SIGTERM):
        # reference: shutdown handlers, monitor_main.py:19-32
        loop.add_signal_handler(sig, stop.set)
    await runtime.start(with_monitor=True)
    metrics_runner = None
    if runtime.settings.monitor_metrics_port > 0:
        metrics_runner = await _start_metrics_listener(
            runtime, runtime.settings.monitor_metrics_port
        )
    logger.info("monitor daemon up (backend=%s)", runtime.settings.backend)
    try:
        await stop.wait()
    finally:
        if metrics_runner is not None:
            await metrics_runner.cleanup()
        await runtime.close()
        logger.info("monitor daemon shut down")


def main() -> int:
    setup_logging()
    asyncio.run(amain())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
