"""Runtime assembly: settings → wired control-plane components.

The reference wires its singletons at import time — kube config, settings
reading a k8s Secret, S3 handler (``SURVEY.md`` §3.5), its biggest
testability wart. Here, assembly is an explicit factory: nothing touches the
filesystem or spawns tasks until :func:`build_runtime` is called, and every
component can be swapped in tests.

The port assembles the sqlite (or jsonl/memory) state store or the remote
state service's client (``state_backend="remote"``), the local, S3 or GCS
object store and the local or k8s backend; the k8s backend's pods get the
server's object-store settings and credentials
(:func:`~.backends.k8s.object_store_env`).
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Any

from ..obs.prom import ObsHub
from ..resilience.heartbeat import LeaseChecker
from ..resilience.policy import RetryPolicy
from ..resilience.supervisor import RetrySupervisor
from ..sched import FairShareScheduler
from .backends.base import TrainingBackend
from .backends.local import LocalProcessBackend
from .config import Settings, get_settings
from .devices import DeviceCatalog, load_catalog
from .monitor import JobMonitor
from .objectstore import ObjectStore, Presigner, build_object_store
from .registry import load_model_modules
from .statestore import StateStore

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class Runtime:
    """Everything a control-plane process needs (API server or monitor daemon)."""

    settings: Settings
    state: StateStore
    store: ObjectStore
    catalog: DeviceCatalog
    backend: TrainingBackend
    monitor: JobMonitor
    presigner: Presigner
    #: inference sessions over promoted checkpoints (serve/service.py);
    #: lazily populated — nothing loads until a generate/load request
    serve: Any = None
    #: the process's observability hub (obs/prom.py): latency histograms +
    #: build info/uptime, rendered by /metrics (docs/observability.md)
    obs: Any = None

    async def start(self, *, with_monitor: bool | None = None) -> None:
        await self.state.connect()
        run_monitor = (
            self.settings.monitor_in_process if with_monitor is None else with_monitor
        )
        if run_monitor:
            self.monitor.start()
        prewarm = getattr(self.backend, "prewarm", None)
        if prewarm is not None:
            # local backend: spawn the warm trainer pool for the default
            # flavor so the FIRST submission already warm-starts
            await prewarm()

    async def close(self) -> None:
        if self.serve is not None:
            await self.serve.close()
        await self.monitor.stop()
        await self.backend.close()
        await self.state.close()
        await self.store.close()


def build_runtime(
    settings: Settings | None = None,
    *,
    plugin_dir: str | None = None,
) -> Runtime:
    """Assemble a runtime from settings (reference startup flow §3.5, made lazy)."""
    settings = settings or get_settings()
    load_model_modules(plugin_dir)
    if settings.state_backend == "remote":
        # the shared state service: N API replicas + the monitor see one
        # consistent store (and rate limits become cluster-scope)
        from .statestore_service import RemoteStateStore

        state: StateStore = RemoteStateStore(  # type: ignore[assignment]
            settings.state_service_url, token=settings.state_service_token
        )
    else:
        state = StateStore(settings.state_path, backend=settings.state_backend)
    store = build_object_store(settings)
    catalog = load_catalog(settings.device_config_file or None)
    backend: TrainingBackend
    if settings.backend == "local":
        sched_queues = None
        if settings.sched_queues:
            import json

            parsed = json.loads(settings.sched_queues)
            if not isinstance(parsed, dict):
                raise ValueError(
                    "FTC_SCHED_QUEUES must be a JSON object of "
                    "queue-name -> weight"
                )
            sched_queues = {str(k): float(v) for k, v in parsed.items()}
        backend = LocalProcessBackend(
            settings.state_path / "sandboxes",
            store,
            catalog,
            sync_interval_s=settings.artifact_sync_interval_s,
            warm_workers=settings.warm_workers,
            sched_policy=settings.sched_policy,
            sched_queues=sched_queues,
            sched_resize=settings.sched_resize,
            sched_grow_delay_s=settings.sched_grow_delay_s,
        )
    elif settings.backend == "k8s":
        from .backends.k8s import K8sJobSetBackend, object_store_env

        # the pods' storage CLI reads and writes the store this server
        # reads (the reference's runtime passes no store env: ROADMAP Queue C)
        backend = K8sJobSetBackend(
            catalog, settings, object_store_env=object_store_env(settings)
        )
    else:
        raise ValueError(f"unknown backend {settings.backend!r}")
    # resilience attachments (docs/resilience.md): the retry supervisor
    # closes the failure loop the reference leaves to operators, the lease
    # checker catches silently-stuck jobs. Either can be disabled via
    # settings (reference-parity behavior).
    # one observability hub per process (docs/observability.md): the monitor,
    # supervisor and serve batchers observe into it; /metrics renders it
    obs = ObsHub()
    supervisor = None
    if settings.retry_max_attempts > 0:
        supervisor = RetrySupervisor(
            state, backend, catalog,
            policy=RetryPolicy(
                max_attempts=settings.retry_max_attempts,
                base_delay_s=settings.retry_base_delay_s,
                max_delay_s=settings.retry_max_delay_s,
            ),
            obs=obs,
        )
    lease = None
    if settings.liveness_lease_s > 0:
        # floor: heartbeat freshness through the store is bounded by the
        # artifact sync cadence — a lease tighter than that would kill
        # healthy jobs between syncs
        lease = LeaseChecker(
            store,
            lease_s=max(
                settings.liveness_lease_s, 3 * settings.artifact_sync_interval_s
            ),
        )
    monitor = JobMonitor(
        state, store, backend,
        interval_s=settings.job_monitor_interval_s,
        supervisor=supervisor, lease=lease, obs=obs,
    )
    presigner = Presigner(settings.presign_secret, settings.presign_expiry_s)
    from ..serve.service import ServeManager

    return Runtime(
        settings=settings,
        state=state,
        store=store,
        catalog=catalog,
        backend=backend,
        monitor=monitor,
        presigner=presigner,
        # the fair-share scheduler handle (local backend) makes serve an
        # autoscaling preemptible tenant when FTC_SERVE_AUTOSCALE is on;
        # FIFO/k8s backends serve statically-sized fleets.
        # serve_transport=process puts worker sandboxes on the backend's
        # substrate
        serve=ServeManager(
            state, store, settings, obs=obs,
            scheduler=(
                backend.scheduler
                if isinstance(getattr(backend, "scheduler", None),
                              FairShareScheduler)
                else None
            ),
            backend=backend,
        ),
        obs=obs,
    )
