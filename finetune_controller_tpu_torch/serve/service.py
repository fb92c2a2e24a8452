"""HTTP serving surface, mounted on the controller server.

Routes (``controller/server.py::build_app`` mounts them; the app's auth/CORS
middlewares apply — a bearer token that can read a job can generate from it):

* ``POST {prefix}/jobs/{job_id}/generate`` — generate from a promoted job's
  checkpoint (auto-loads on first use when ``serve_autoload`` is on);
* ``POST {prefix}/admin/serve/{job_id}/load`` / ``.../unload`` — explicit
  model lifecycle (admin).  ``load`` on an ALREADY-loaded job is the
  zero-downtime rollover trigger: if the promotion now points at a newer
  checkpoint, replicas spin up on it, traffic shifts, and the old replicas
  drain after their in-flight lanes finish (docs/serving.md §Fleet);
* ``GET {prefix}/admin/serve`` — per-model fleet/router stats (admin).

Every served job runs a :class:`~finetune_controller_tpu_torch.serve.fleet.
ReplicaFleet` behind a :class:`~finetune_controller_tpu_torch.serve.router.
ReplicaRouter` (``serve_replicas`` controls the floor; 1 keeps the
single-engine footprint but with health checks and drains).

The manager refuses jobs whose promotion is not COMPLETED
(``serve/loader.py::resolve_promoted``) — serving a half-copied or deleted
deploy prefix would decode garbage with a 200 status.

The port loads promoted models on the control plane's ``device`` setting
(``FTC_DEVICE``, default ``cuda``).  ``serve_transport=inproc`` runs the
replicas in this process around one loaded model; ``process`` stages the
promoted prefix once per generation and gives every replica a worker
process of its own, which rebuilds the model from the staged dir on the
same device (``transport/``); the control plane then holds no weights.  A
reward job in process mode gets reward workers, which also answer the
batched ``reward_score`` RPC with the job's head over the staged prefix
(``prefs/rollout_plane.py::RewardScorer``).  With ``serve_autoscale`` on
and the backend's fair-share scheduler at hand, every replica is a
preemptible ``owner="serve"`` scheduler workload
(``sched/serve_tenant.py``): queue-depth pressure grows the fleet through
scheduler submits, and a training job reclaims a replica by drain, never by
kill.  The shard-audit block of ``GET {prefix}/admin/serve`` reports the
audit as not ported (it needs DTensor placements).
"""

from __future__ import annotations

import asyncio
import dataclasses
import json
import logging
import time
import uuid
from pathlib import Path
from typing import Any

from ..controller import web
from ..resilience.policy import RetryPolicy
from .adapters import AdapterError, AdapterRegistry, UnknownAdapter
from .batcher import DeadlineExceeded, QueueFull, ReplicaUnavailable
from .engine import EngineConfig, GenRequest, GenResult, PromptTooLong
from .fleet import AdapterBusy, ReplicaFleet
from .loader import (
    ServeLoadError,
    load_adapter as load_adapter_deltas,
    load_promoted,
    resolve_promoted,
)
from .router import FleetUnavailable, ReplicaRouter

logger = logging.getLogger(__name__)

SERVE_KEY = web.AppKey("serve", object)


@dataclasses.dataclass
class _Session:
    job_id: str
    fleet: ReplicaFleet
    router: ReplicaRouter
    meta: dict[str, Any]
    loaded_at: float
    #: multiplexed tenant adapters by job id (docs/serving.md §Multi-tenant
    #: adapters) — metas only; the weights live in the fleet's registry
    adapters: dict[str, dict[str, Any]] = dataclasses.field(
        default_factory=dict)
    #: process transport: the staged deploy prefix this generation's worker
    #: processes rebuild their weights from (removed on unload/rollover)
    worker_stage_dir: str | None = None
    tenant: Any = None  # sched/serve_tenant.py when autoscale is on
    tenant_task: Any = None  # the tenant's reconcile loop (cancelled on unload)


class ServeManager:
    """Loaded serving sessions, one replica fleet + router per promoted job."""

    def __init__(self, state, store, settings, *, obs=None, scheduler=None,
                 backend=None):
        self.state = state
        self.store = store
        self.settings = settings
        #: the backend's fair-share scheduler (serve-as-a-tenant autoscale);
        #: None = static fleets
        self.scheduler = scheduler
        #: observability hub (obs/prom.py): serve TTFT histogram + timeline
        #: events on load/unload (docs/observability.md)
        self.obs = obs
        #: the training backend: with ``serve_transport=process`` worker
        #: sandboxes live under its substrate (``backend.serve_worker_root``);
        #: None falls back to the state dir
        self.backend = backend
        self.sessions: dict[str, _Session] = {}
        #: per-job single-flight loads: the dict insert is the CAS — exactly
        #: one racing ``load`` wins and does the work, the rest await its
        #: future (the loader-staleness fix, with the staging race
        #: itself removed by unique stage dirs in ``loader.load_promoted``)
        self._loading: dict[str, asyncio.Future] = {}
        #: tenant job id → base session job id: POST /jobs/{tenant}/generate
        #: routes to the base fleet with the tenant's adapter selected
        self._adapter_routes: dict[str, str] = {}
        self.work_dir = Path(settings.state_path) / "serve_cache"

    async def _event(self, job_id: str, event: str, **attrs) -> None:
        from ..obs.events import append_event_safe

        await append_event_safe(self.state, job_id, event, **attrs)

    def _engine_config(self) -> EngineConfig:
        s = self.settings
        return EngineConfig(
            slots=s.serve_slots,
            prompt_buckets=tuple(s.serve_prompt_buckets),
            max_new_tokens=s.serve_max_new_tokens,
            prefix_cache_bytes=(
                int(s.serve_prefix_cache_mb) * (1 << 20)
                if s.serve_prefix_cache else 0
            ),
            page_tokens=(s.serve_kv_page_tokens if s.serve_paged_kv else 0),
            pool_pages=(s.serve_kv_pool_pages if s.serve_paged_kv else 0),
            host_pool_bytes=(
                int(s.serve_kv_host_pool_mb) * (1 << 20)
                if s.serve_paged_kv else 0
            ),
        )

    def _batcher_kwargs(self) -> dict[str, Any]:
        return dict(
            max_queue=self.settings.serve_max_queue,
            max_wait_ms=self.settings.serve_max_wait_ms,
            default_timeout_s=self.settings.serve_request_timeout_s,
            drr_quantum_tokens=float(self.settings.serve_drr_quantum_tokens),
            ttft_observe=(
                self.obs.serve_ttft_seconds.observe
                if self.obs is not None else None
            ),
        )

    @property
    def _multi_tenant(self) -> bool:
        return self.settings.serve_max_adapters > 0

    @property
    def _transport_mode(self) -> str:
        mode = (self.settings.serve_transport or "inproc").strip().lower()
        if mode not in ("inproc", "process"):
            raise ServeLoadError(
                f"unknown serve_transport {mode!r} (expected 'inproc' or "
                "'process')", status=500,
            )
        return mode

    def _make_transport(self, job_id: str, payload_kwargs: dict[str, Any]):
        """Process-mode replica substrate: sandboxes under the backend's
        work dir when it offers one (the local backend does), else the state
        dir — one dir per worker with spec, log, heartbeat and socket file."""
        from ..transport.process import ProcessTransport

        s = self.settings
        root = None
        if self.backend is not None:
            root = self.backend.serve_worker_root(job_id)
        if root is None:
            root = Path(s.state_path) / "serve_workers" / job_id
            root.mkdir(parents=True, exist_ok=True)
        return ProcessTransport(
            job_id=job_id,
            root=root,
            payload={"builder": "deploy_dir", "kwargs": payload_kwargs},
            port_base=s.serve_worker_port_base,
            spawn_timeout_s=s.serve_worker_spawn_timeout_s,
            heartbeat_interval_s=s.serve_worker_heartbeat_s,
            probe_timeout_s=max(10.0, s.serve_health_interval_s * 5),
        )

    def _adapter_registry(self) -> AdapterRegistry | None:
        if not self._multi_tenant:
            return None
        return AdapterRegistry(
            self.settings.serve_max_adapters + 1,  # + the base slot 0
            self.settings.serve_adapter_rank,
        )

    @staticmethod
    def _reward_spec(transport, meta) -> dict[str, Any] | None:
        """A reward job's workers restore its head from the staged prefix
        the ``deploy_dir`` builder reads."""
        if transport is None or meta.get("task") != "reward":
            return None
        staged = (transport.payload.get("kwargs") or {}).get("dir")
        return {"artifacts_dir": str(staged)} if staged else None

    async def _build_session(self, job_id, model, meta, *, transport=None) -> _Session:
        s = self.settings
        fleet = ReplicaFleet(
            job_id, model, self._engine_config(),
            replicas=s.serve_replicas,
            batcher_kwargs=self._batcher_kwargs(),
            adapters=self._adapter_registry(),
            transport=transport,
            reward_spec=self._reward_spec(transport, meta),
            stall_timeout_s=s.serve_replica_stall_s,
            drain_timeout_s=s.serve_drain_timeout_s,
            restart_policy=RetryPolicy(
                max_attempts=s.serve_replica_restart_attempts,
                base_delay_s=s.retry_base_delay_s,
                max_delay_s=s.retry_max_delay_s,
            ),
            event_cb=(
                lambda event, **attrs: self._event(job_id, event, **attrs)
            ),
        )
        try:
            await fleet.start()
        except BaseException:
            # a worker that came up before another failed its spawn must
            # not outlive the failed load
            await fleet.close()
            raise
        router = ReplicaRouter(
            fleet,
            default_timeout_s=s.serve_request_timeout_s,
            failover_retries=s.serve_failover_retries,
        )
        session = _Session(
            job_id=job_id, fleet=fleet, router=router, meta=meta,
            loaded_at=time.time(),
        )
        if s.serve_autoscale and self.scheduler is not None:
            from ..sched.serve_tenant import ServeScalePolicy, ServeTenant

            flavor = s.serve_flavor or getattr(
                getattr(self.scheduler, "_catalog", None), "default_flavor", ""
            )
            if flavor:
                session.tenant = ServeTenant(
                    self.scheduler, fleet,
                    flavor=flavor, queue=s.serve_queue,
                    policy=ServeScalePolicy(
                        min_replicas=s.serve_min_replicas,
                        max_replicas=s.serve_max_replicas,
                        scale_up_queue_depth=s.serve_scale_up_queue_depth,
                        sustain_ticks=s.serve_scale_sustain_ticks,
                    ),
                )
                await session.tenant.attach_initial()
        fleet.start_health_loop(s.serve_health_interval_s)
        if session.tenant is not None:
            self._start_tenant_loop(session)
        return session

    def _start_tenant_loop(self, session: _Session) -> None:
        async def loop():
            while session.tenant is not None \
                    and self.sessions.get(session.job_id) is session:
                try:
                    await session.tenant.tick()
                # logged: the autoscale loop must outlive a single tick's failure
                except Exception:
                    logger.exception("serve tenant tick failed for %s",
                                     session.job_id)
                await asyncio.sleep(self.settings.serve_health_interval_s)

        session.tenant_task = asyncio.get_running_loop().create_task(loop())

    async def load(self, job_id: str) -> dict[str, Any]:
        """Load a promoted job for serving (idempotent), or — when it is
        already loaded and its promotion points at a NEWER checkpoint —
        perform a zero-downtime rollover onto it."""
        racing = self._loading.get(job_id)
        if racing is not None:
            return await asyncio.shield(racing)
        future = asyncio.get_running_loop().create_future()
        self._loading[job_id] = future  # the CAS: we are the winner now
        try:
            meta = await self._load_or_rollover(job_id)
            future.set_result(meta)
            return meta
        except BaseException as exc:
            if not future.done():
                future.set_exception(exc)
                future.exception()  # losers or nobody: mark retrieved
            raise
        finally:
            self._loading.pop(job_id, None)

    async def _peek_latest_step(self, promotion_uri: str) -> int | None:
        """Newest ``checkpoints/step_N`` under the deploy prefix — a store
        LISTING, not a download: the cheap already-serving-this pre-check."""
        prefix = promotion_uri.rstrip("/") + "/"
        try:
            objs = await self.store.list_prefix(promotion_uri)
        except Exception:
            logger.debug("peek of %s failed; falling back to a full load",
                         promotion_uri, exc_info=True)
            return None
        steps = []
        for obj in objs:
            rel = obj.get("uri", "")[len(prefix):]
            if rel.startswith("checkpoints/step_"):
                raw = rel.split("/", 2)[1].rpartition("_")[2]
                if raw.isdigit():
                    steps.append(int(raw))
        return max(steps) if steps else None

    async def _load_or_rollover_process(self, job_id: str) -> dict[str, Any]:
        """The ``serve_transport=process`` load path: the control plane
        STAGES the promoted prefix once and reads its meta, but never loads
        the weights — each worker process rebuilds them from the staged dir
        (``transport/builders.py::deploy_dir``).  A rollover stages the new
        checkpoint, repoints the transport's payload, and lets the fleet
        spin the next worker generation on it before draining the old."""
        import shutil

        from .loader import _load_adapter_tree, stage_for_workers

        existing = self.sessions.get(job_id)
        if existing is not None:
            job = await resolve_promoted(self.state, job_id)
            if job.promotion_uri == existing.meta.get("promotion_uri"):
                peek = await self._peek_latest_step(job.promotion_uri)
                if peek is not None \
                        and peek == existing.meta.get("checkpoint_step"):
                    return existing.meta
        merge = self.settings.serve_merge_lora and not self._multi_tenant
        stage_dir, meta = await stage_for_workers(
            self.state, self.store, job_id, self.work_dir, merge_lora=merge,
        )
        base_adapter = None
        if self._multi_tenant:
            meta["lora_merged"] = False
            meta["multi_tenant"] = True
            meta["self_adapter"] = meta.get("lora_rank", 0) > 0
            if meta["self_adapter"]:
                # the job's own fine-tune serves as tenant #1; only the
                # DELTAS load here — the base stays in the workers
                lora_tree, ameta = await asyncio.to_thread(_load_adapter_tree, stage_dir)
                base_adapter = (lora_tree, ameta["lora_alpha"], ameta["lora_rank"])
        payload_kwargs = {
            "dir": str(stage_dir), "merge_lora": merge,
            "multi_tenant": self._multi_tenant, "device": str(self.settings.device),
        }
        if existing is not None:
            same = (
                existing.meta.get("checkpoint_step") == meta.get("checkpoint_step")
                and existing.meta.get("promotion_uri") == meta.get("promotion_uri")
            )
            if same:
                await asyncio.to_thread(shutil.rmtree, stage_dir, ignore_errors=True)
                return existing.meta
            await self._event(
                job_id, "serve-rollover-requested",
                from_step=existing.meta.get("checkpoint_step"),
                to_step=meta.get("checkpoint_step"),
            )
            existing.fleet.transport.set_payload("deploy_dir", payload_kwargs)
            # the next generation's reward head comes from the new stage
            # (the reference keeps the old stage's, which it then deletes)
            existing.fleet.reward_spec = self._reward_spec(existing.fleet.transport, meta)
            old_stage = existing.worker_stage_dir
            await existing.fleet.rollover(None)
            if base_adapter is not None:
                await existing.fleet.register_adapter(
                    job_id, *base_adapter,
                    meta={"checkpoint_step": meta.get("checkpoint_step")},
                )
            existing.meta = meta
            existing.worker_stage_dir = str(stage_dir)
            if old_stage:
                # the old generation drained inside rollover(): nothing
                # reads the superseded stage anymore
                await asyncio.to_thread(shutil.rmtree, old_stage, ignore_errors=True)
            logger.info("serve rollover completed for %s (process): %s", job_id, meta)
            return meta
        transport = self._make_transport(job_id, payload_kwargs)
        try:
            session = await self._build_session(job_id, None, meta, transport=transport)
        except BaseException:
            await asyncio.to_thread(shutil.rmtree, stage_dir, ignore_errors=True)
            raise
        session.worker_stage_dir = str(stage_dir)
        self.sessions[job_id] = session
        if base_adapter is not None:
            await session.fleet.register_adapter(
                job_id, *base_adapter,
                meta={"checkpoint_step": meta.get("checkpoint_step")},
            )
        await self._event(
            job_id, "serve-loaded",
            checkpoint_step=meta.get("checkpoint_step"),
            lora_merged=meta.get("lora_merged"),
            replicas=session.fleet.target_replicas,
            transport="process",
        )
        logger.info("serve session loaded for %s (process workers): %s", job_id, meta)
        return meta

    async def _load_or_rollover(self, job_id: str) -> dict[str, Any]:
        if self._transport_mode == "process":
            return await self._load_or_rollover_process(job_id)
        existing = self.sessions.get(job_id)
        if existing is not None:
            # cheap idempotence check BEFORE staging gigabytes: same deploy
            # prefix and no newer checkpoint step means the live session
            # already serves this exact artifact
            job = await resolve_promoted(self.state, job_id)
            if job.promotion_uri == existing.meta.get("promotion_uri"):
                peek = await self._peek_latest_step(job.promotion_uri)
                if peek is not None \
                        and peek == existing.meta.get("checkpoint_step"):
                    return existing.meta
        model, meta = await load_promoted(
            self.state, self.store, job_id, self.work_dir,
            # multi-tenant fleets need the pristine base: the job's own
            # adapter is stripped below and served as tenant #1 instead
            merge_lora=(self.settings.serve_merge_lora
                        and not self._multi_tenant),
            device=self.settings.device,
        )
        base_adapter = None
        if self._multi_tenant:
            from .loader import strip_lora_for_multitenant

            model, lora_tree, alpha, rank = \
                await asyncio.to_thread(strip_lora_for_multitenant, model)
            meta["lora_merged"] = False
            meta["multi_tenant"] = True
            meta["self_adapter"] = lora_tree is not None
            if lora_tree is not None:
                base_adapter = (lora_tree, alpha, rank)
        if existing is not None:
            same = (
                existing.meta.get("checkpoint_step") == meta.get("checkpoint_step")
                and existing.meta.get("promotion_uri") == meta.get("promotion_uri")
            )
            if same:
                # already serving exactly this artifact — idempotent
                return existing.meta
            await self._event(
                job_id, "serve-rollover-requested",
                from_step=existing.meta.get("checkpoint_step"),
                to_step=meta.get("checkpoint_step"),
            )
            await existing.fleet.rollover(model)
            if base_adapter is not None:
                # the job's own adapter moved with the checkpoint: refresh
                # tenant #1 AFTER the rollover so the new generation serves
                # the new deltas (the registry slot is reused in place)
                await existing.fleet.register_adapter(
                    job_id, *base_adapter,
                    meta={"checkpoint_step": meta.get("checkpoint_step")},
                )
            existing.meta = meta
            logger.info("serve rollover completed for %s: %s", job_id, meta)
            return meta
        session = await self._build_session(job_id, model, meta)
        self.sessions[job_id] = session
        if base_adapter is not None:
            await session.fleet.register_adapter(
                job_id, *base_adapter,
                meta={"checkpoint_step": meta.get("checkpoint_step")},
            )
        await self._event(
            job_id, "serve-loaded",
            checkpoint_step=meta.get("checkpoint_step"),
            lora_merged=meta.get("lora_merged"),
            replicas=session.fleet.target_replicas,
        )
        logger.info("serve session loaded for %s: %s", job_id, meta)
        return meta

    async def load_adapter(self, base_job_id: str,
                           adapter_job_id: str) -> dict[str, Any]:
        """Stage a promoted LoRA job's deltas onto an already-loaded base
        fleet as a multiplexed tenant (docs/serving.md §Multi-tenant
        adapters) — a device write per replica, never a fleet rebuild.
        Re-loading a tenant whose promotion moved refreshes its slot in
        place (the tenant-rollover path)."""
        if not self._multi_tenant:
            raise ServeLoadError(
                "multi-tenant serving is off (serve_max_adapters=0)",
                status=409,
            )
        session = self.sessions.get(base_job_id)
        if session is None:
            raise ServeLoadError(
                f"base job {base_job_id!r} is not loaded; "
                f"POST /admin/serve/{base_job_id}/load first", status=409,
            )
        if adapter_job_id == base_job_id:
            raise ServeLoadError(
                f"job {base_job_id!r} is the base of this fleet — its own "
                "adapter is already tenant #1", status=409,
            )
        routed = self._adapter_routes.get(adapter_job_id)
        if routed is not None and routed != base_job_id:
            raise ServeLoadError(
                f"adapter {adapter_job_id!r} is already multiplexed on base "
                f"{routed!r}; unload it there first", status=409,
            )
        lora_tree, meta = await load_adapter_deltas(
            self.state, self.store, adapter_job_id, self.work_dir,
            base_meta=session.meta,
        )
        try:
            slot = await session.fleet.register_adapter(
                adapter_job_id, lora_tree, meta["lora_alpha"],
                meta["lora_rank"],
                meta={"checkpoint_step": meta.get("checkpoint_step")},
            )
        except AdapterError as e:
            raise ServeLoadError(str(e), status=409) from e
        meta["slot"] = slot
        meta["base_job_id"] = base_job_id
        session.adapters[adapter_job_id] = meta
        self._adapter_routes[adapter_job_id] = base_job_id
        logger.info("adapter %s multiplexed onto %s: %s",
                    adapter_job_id, base_job_id, meta)
        return meta

    async def unload_adapter(self, base_job_id: str,
                             adapter_job_id: str) -> bool:
        session = self.sessions.get(base_job_id)
        if session is None or adapter_job_id not in session.adapters:
            return False
        try:
            await session.fleet.unregister_adapter(adapter_job_id)
        except AdapterBusy as e:
            raise ServeLoadError(str(e), status=409) from e
        session.adapters.pop(adapter_job_id, None)
        self._adapter_routes.pop(adapter_job_id, None)
        return True

    async def unload(self, job_id: str) -> bool:
        session = self.sessions.pop(job_id, None)
        if session is None:
            return False
        for tenant_id, base_id in list(self._adapter_routes.items()):
            if base_id == job_id:
                self._adapter_routes.pop(tenant_id, None)
        if session.tenant_task is not None:
            session.tenant_task.cancel()
        if session.tenant is not None:
            await session.tenant.close()
            session.tenant = None
        await session.fleet.close()
        if session.worker_stage_dir:
            import shutil

            await asyncio.to_thread(
                shutil.rmtree, session.worker_stage_dir, ignore_errors=True
            )
        await self._event(job_id, "serve-unloaded")
        logger.info("serve session unloaded for %s", job_id)
        return True

    async def generate(
        self, job_id: str, req: GenRequest, *, timeout_s: float | None = None
    ) -> tuple[GenResult, dict[str, Any]]:
        session = self.sessions.get(job_id)
        if session is None and not req.adapter_id:
            # a tenant job id routes to the base fleet multiplexing it
            base_id = self._adapter_routes.get(job_id)
            if base_id is not None:
                session = self.sessions.get(base_id)
                if session is not None:
                    req.adapter_id = job_id
        if session is None:
            if not self.settings.serve_autoload:
                raise ServeLoadError(
                    f"job {job_id!r} is not loaded for serving; "
                    f"POST /admin/serve/{job_id}/load first", status=409,
                )
            await self.load(job_id)
            session = self.sessions.get(job_id)
            if session is None:  # admin unloaded while we were loading
                raise ServeLoadError(
                    f"job {job_id!r} was unloaded while loading; retry",
                    status=409,
                )
        if not req.adapter_id and session.meta.get("self_adapter"):
            # multi-tenant base: the job's own fine-tune is tenant #1, so a
            # plain generate keeps serving the promoted behavior (slot 0
            # would be the raw pretrained base)
            req.adapter_id = session.job_id
        if req.adapter_id and req.adapter_id != session.job_id \
                and req.adapter_id not in session.adapters:
            raise UnknownAdapter(
                f"adapter {req.adapter_id!r} is not loaded on base "
                f"{session.job_id!r} (loaded: "
                f"{sorted(session.adapters) or 'none'})"
            )
        result = await session.router.submit(req, timeout_s=timeout_s)
        meta = session.meta
        if req.adapter_id and req.adapter_id in session.adapters:
            meta = {**meta, "adapter": req.adapter_id,
                    "adapter_checkpoint_step":
                        session.adapters[req.adapter_id].get(
                            "checkpoint_step")}
        return result, meta

    def stats(self) -> dict[str, Any]:
        out: dict[str, Any] = {}
        for job_id, session in self.sessions.items():
            stats = session.fleet.stats()
            stats.update(session.router.stats())
            if session.tenant is not None:
                stats["autoscale"] = session.tenant.stats()
            if session.adapters:
                stats["adapter_jobs"] = {
                    tid: {"slot": m.get("slot"),
                          "checkpoint_step": m.get("checkpoint_step")}
                    for tid, m in session.adapters.items()
                }
            out[job_id] = stats
        return out

    async def close(self) -> None:
        for job_id in list(self.sessions):
            await self.unload(job_id)


# ---------------------------------------------------------------------------
# Handlers (lazy-import the server module: it imports us at build time)
# ---------------------------------------------------------------------------


def _json_error(status: int, detail: Any) -> web.Response:
    return web.json_response({"detail": detail}, status=status)


def _parse_gen_request(body: dict[str, Any], settings) -> GenRequest:
    tokens = body.get("tokens")
    if not isinstance(tokens, list) or not tokens \
            or not all(isinstance(t, int) and t >= 0 for t in tokens):
        raise ValueError("'tokens' must be a non-empty list of token ids")
    max_new = body.get("max_new_tokens", settings.serve_default_max_new_tokens)
    if not isinstance(max_new, int) or max_new < 1:
        raise ValueError("'max_new_tokens' must be a positive integer")
    temperature = float(body.get("temperature", 0.0))
    top_k = int(body.get("top_k", 0))
    eos_id = body.get("eos_id")
    if eos_id is not None and not isinstance(eos_id, int):
        raise ValueError("'eos_id' must be an integer token id")
    adapter = body.get("adapter", "")
    if adapter and not isinstance(adapter, str):
        raise ValueError("'adapter' must be a job id string")
    return GenRequest(
        request_id=body.get("request_id") or f"gen-{uuid.uuid4().hex[:12]}",
        tokens=tokens,
        max_new_tokens=max_new,
        temperature=temperature,
        top_k=top_k,
        eos_id=eos_id,
        seed=int(body.get("seed", 0)),
        adapter_id=adapter or "",
    )


async def generate_job(request: web.Request) -> web.Response:
    """POST /jobs/{job_id}/generate — tokens in, tokens out."""
    from ..controller.server import (
        LIMITER_KEY,
        RUNTIME_KEY,
        _json_body,
        _owned_job,
    )

    rt = request.app[RUNTIME_KEY]
    limiter = request.app[LIMITER_KEY]
    user = request.get("user")
    uid = user.user_id if user else request.remote or "anon"
    if not await limiter.check(uid, "generate"):
        return _json_error(429, "rate limit exceeded (generate)")
    job = await _owned_job(request, request.match_info["job_id"])
    body = await _json_body(request)
    manager: ServeManager = request.app[SERVE_KEY]
    try:
        req = _parse_gen_request(body, rt.settings)
        timeout_raw = body.get("timeout_s")
        timeout_s = None if timeout_raw is None else float(timeout_raw)
    except (TypeError, ValueError) as e:
        return _json_error(400, str(e))
    t0 = time.monotonic()
    try:
        result, meta = await manager.generate(
            job.job_id, req, timeout_s=timeout_s
        )
    except QueueFull as e:
        # Retry-After derived from observed queue depth and decode rate
        # (serve/batcher.py::retry_after_s) — callers back off for a useful
        # interval instead of guessing from a bare 429
        retry_after = max(1, round(e.retry_after_s or 1.0))
        return web.Response(
            status=429, headers={"Retry-After": str(retry_after)},
            body=json.dumps({
                "detail": str(e), "retry_after_s": retry_after,
            }).encode(),
            content_type="application/json",
        )
    except (FleetUnavailable, ReplicaUnavailable) as e:
        retry_after = max(1, round(getattr(e, "retry_after_s", None) or 2.0))
        return web.Response(
            status=503, headers={"Retry-After": str(retry_after)},
            body=json.dumps({"detail": str(e)}).encode(),
            content_type="application/json",
        )
    except DeadlineExceeded as e:
        return _json_error(504, str(e))
    except UnknownAdapter as e:
        return _json_error(404, str(e))
    except (PromptTooLong, ValueError) as e:
        return _json_error(400, str(e))
    except ServeLoadError as e:
        return _json_error(e.status, str(e))
    return web.json_response(
        {
            "job_id": job.job_id,
            "request_id": result.request_id,
            "prompt_tokens": result.prompt_tokens,
            "tokens": result.generated,
            "finish_reason": result.finish_reason,
            "latency_ms": round((time.monotonic() - t0) * 1000, 2),
            "replica_id": result.replica_id,
            "model": {
                "checkpoint_step": meta.get("checkpoint_step"),
                "lora_merged": meta.get("lora_merged"),
                "adapter": meta.get("adapter") or req.adapter_id or None,
            },
        }
    )


async def admin_serve_load(request: web.Request) -> web.Response:
    from ..controller.server import _admin

    _admin(request)
    manager: ServeManager = request.app[SERVE_KEY]
    try:
        meta = await manager.load(request.match_info["job_id"])
    except ServeLoadError as e:
        return _json_error(e.status, str(e))
    return web.json_response({"message": "loaded", "model": meta})


async def admin_serve_unload(request: web.Request) -> web.Response:
    from ..controller.server import _admin

    _admin(request)
    manager: ServeManager = request.app[SERVE_KEY]
    if not await manager.unload(request.match_info["job_id"]):
        return _json_error(404, "job is not loaded")
    return web.json_response({"message": "unloaded"})


async def admin_adapter_load(request: web.Request) -> web.Response:
    """POST /admin/serve/{job_id}/adapters/{adapter_job_id}/load — stage a
    promoted LoRA job's deltas onto the base fleet as a multiplexed tenant
    (docs/serving.md §Multi-tenant adapters)."""
    from ..controller.server import _admin

    _admin(request)
    manager: ServeManager = request.app[SERVE_KEY]
    try:
        meta = await manager.load_adapter(
            request.match_info["job_id"],
            request.match_info["adapter_job_id"],
        )
    except ServeLoadError as e:
        return _json_error(e.status, str(e))
    return web.json_response({"message": "adapter loaded", "adapter": meta})


async def admin_adapter_unload(request: web.Request) -> web.Response:
    from ..controller.server import _admin

    _admin(request)
    manager: ServeManager = request.app[SERVE_KEY]
    try:
        ok = await manager.unload_adapter(
            request.match_info["job_id"],
            request.match_info["adapter_job_id"],
        )
    except ServeLoadError as e:
        return _json_error(e.status, str(e))
    if not ok:
        return _json_error(404, "adapter is not loaded on this base")
    return web.json_response({"message": "adapter unloaded"})


async def admin_serve_status(request: web.Request) -> web.Response:
    from ..controller.server import _admin

    _admin(request)
    manager: ServeManager = request.app[SERVE_KEY]
    return web.json_response({
        "sessions": manager.stats(),
        "shard_audit": "not ported yet (ROADMAP Queue A item 9)",
    })


def add_serve_routes(app: web.Application, prefix: str) -> None:
    app.router.add_post(f"{prefix}/jobs/{{job_id}}/generate", generate_job)
    app.router.add_post(
        f"{prefix}/admin/serve/{{job_id}}/load", admin_serve_load
    )
    app.router.add_post(
        f"{prefix}/admin/serve/{{job_id}}/unload", admin_serve_unload
    )
    app.router.add_post(
        f"{prefix}/admin/serve/{{job_id}}/adapters/{{adapter_job_id}}/load",
        admin_adapter_load,
    )
    app.router.add_post(
        f"{prefix}/admin/serve/{{job_id}}/adapters/{{adapter_job_id}}/unload",
        admin_adapter_unload,
    )
    app.router.add_get(f"{prefix}/admin/serve", admin_serve_status)
