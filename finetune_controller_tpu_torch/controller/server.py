"""The control-plane HTTP API, on the port's stdlib server
(``controller/web.py``).

The port's copy keeps the reference's handlers and routes, the WebSocket
log follow (``GET {prefix}/logs/{job_id}``, ``controller/stream_logger.py``)
included; ``web`` offers the part of ``aiohttp.web`` they use, so this file
diffs cleanly against the reference's.  Not ported yet, and reported so:
the shard-audit counters of ``/metrics`` (ROADMAP Queue A item 9).

The reference's description:

Capability parity with the reference's FastAPI app (``app/main.py`` 1,355 LoC
— SURVEY.md §2 component 1) plus its middleware wiring (component 20) and
OpenAPI customization (component 21). Route-by-route mapping to the reference
is cited on each handler. Differences by design:

- a small asyncio server instead of FastAPI (the image's standard library);
- the execution substrate is the backend seam, not raw Kubernetes clients;
- nothing global: the app is built from an injected :class:`Runtime`
  (reference wires singletons at import, SURVEY.md §3.5 wart).
"""

from __future__ import annotations

import asyncio
import json
import logging
import tempfile
import time
from pathlib import Path
from typing import Any
from urllib.parse import urlencode

from pydantic import ValidationError

from ..obs import events as obs_events
from ..obs.events import append_event_safe, make_event
from ..obs.prom import ObsHub, escape_label
from ..obs.trace import (
    TRACE_DIRNAME,
    TRAINER_SPANS_FILENAME,
    build_trace,
    export_trace,
    parse_span_lines,
)
from ..sched.queues import parse_priority
from . import registry
from .config import Settings
from .promotion import PromotionTask, promotion_destination
from .runtime import Runtime, build_runtime
from .schemas import DatabaseStatus, JobInput, PromotionStatus
from .config import DEFAULT_JWT_SECRET
from .security import (
    TokenValidator,
    build_auth_middleware,
    build_cors_middleware,
    dev_generate_token,
)
from . import web
from .statestore import generate_short_uuid
from .stream_logger import LogStreamManager
from .task_builder import DatasetInput, TaskBuildError, task_builder

logger = logging.getLogger(__name__)

RUNTIME_KEY = web.AppKey("runtime", Runtime)
PROMOTION_KEY = web.AppKey("promotion", PromotionTask)
LIMITER_KEY = web.AppKey("limiter", object)
BG_TASKS_KEY = web.AppKey("bg_tasks", set)
#: which process is serving /metrics — "server" here, "monitor" when the
#: standalone monitor daemon mounts the same handler (monitor_main.py)
PROCESS_KEY = web.AppKey("process_name", str)


# ---------------------------------------------------------------------------
# Rate limiting (reference: slowapi limiter, app/api/middleware.py:18,
# limits at app/main.py:377,525,714)
# ---------------------------------------------------------------------------


class RateLimiter:
    """Sliding-window per-user, per-class limiter, enforced in the STATE
    STORE's consistency domain (``StateStore.rate_limit_acquire``): memory
    store → per-process (dev), sqlite → every worker sharing the state dir,
    remote state service → the whole cluster. The reference's slowapi limits
    are per-process, so ``--workers N`` silently multiplies them
    (``app/main.py:377,525,714``); here the scope follows the store."""

    def __init__(self, state, limits_per_min: dict[str, int]):
        self.state = state
        self.limits = limits_per_min

    async def check(self, user_id: str, bucket: str) -> bool:
        limit = self.limits.get(bucket)
        if not limit:
            return True
        return await self.state.rate_limit_acquire(
            f"rl/{bucket}/{user_id}", limit, 60.0
        )


def _limited(bucket: str):
    """Decorator enforcing a rate-limit class on a handler."""

    def deco(handler):
        async def wrapped(request: web.Request):
            limiter: RateLimiter = request.app[LIMITER_KEY]
            user = request.get("user")
            uid = user.user_id if user else request.remote or "anon"
            if not await limiter.check(uid, bucket):
                raise web.HTTPTooManyRequests(
                    text=json.dumps({"detail": f"rate limit exceeded ({bucket})"}),
                    content_type="application/json",
                )
            return await handler(request)

        wrapped.__name__ = handler.__name__
        wrapped.__doc__ = handler.__doc__
        return wrapped

    return deco


# ---------------------------------------------------------------------------
# Helpers
# ---------------------------------------------------------------------------


def _json_error(status: int, detail: Any) -> web.Response:
    return web.json_response({"detail": detail}, status=status)


def _bad_request(detail: str) -> web.HTTPBadRequest:
    return web.HTTPBadRequest(
        text=json.dumps({"detail": detail}), content_type="application/json"
    )


def _int_param(q, name: str, default: int) -> int:
    raw = q.get(name)
    if raw is None or raw == "":
        return default
    try:
        return int(raw)
    except ValueError:
        raise _bad_request(f"query parameter {name!r} must be an integer")


def _status_param(q) -> DatabaseStatus | None:
    raw = q.get("status")
    if not raw:
        return None
    try:
        return DatabaseStatus(raw)
    except ValueError:
        raise _bad_request(
            f"unknown status {raw!r}; one of {[s.value for s in DatabaseStatus]}"
        )


async def _json_body(request: web.Request) -> dict[str, Any]:
    try:
        body = await request.json()
    except Exception:
        raise _bad_request("request body must be valid JSON")
    if not isinstance(body, dict):
        raise _bad_request("request body must be a JSON object")
    return body


def _signed_download_url(rt: Runtime, uri: str) -> str:
    """Presigned, URL-encoded download link (unencoded URIs with spaces/&
    would self-invalidate the signature)."""
    query = urlencode({"uri": uri, "sig": rt.presigner.sign(uri)})
    return f"{rt.settings.api_prefix}/download?{query}"


@web.middleware
async def error_middleware(request: web.Request, handler):
    """Uniform JSON error shapes (reference: FastAPI exception handlers)."""
    try:
        return await handler(request)
    except web.HTTPException:
        raise
    except TaskBuildError as e:
        return _json_error(e.status, str(e))
    except ValidationError as e:
        # reference renders a per-field list on submit validation
        # (app/main.py:437-471)
        errors = [
            {"field": ".".join(str(p) for p in err["loc"]), "message": err["msg"]}
            for err in e.errors()
        ]
        return _json_error(400, errors)
    except Exception:
        logger.exception("unhandled error on %s %s", request.method, request.path)
        return _json_error(500, "internal server error")


def _user(request: web.Request):
    user = request.get("user")
    if user is None:
        raise web.HTTPUnauthorized(
            text=json.dumps({"detail": "not authenticated"}),
            content_type="application/json",
        )
    return user


async def _owned_job(request: web.Request, job_id: str):
    """Fetch a job and enforce ownership (reference: ``app/main.py:725-726``;
    admins see everything, as in the reference's admin routes)."""
    rt = request.app[RUNTIME_KEY]
    user = _user(request)
    job = await rt.state.get_job(job_id)
    if job is None or (job.user_id != user.user_id and not user.is_admin):
        raise web.HTTPNotFound(
            text=json.dumps({"detail": f"job {job_id!r} not found"}),
            content_type="application/json",
        )
    return job


def _spawn_bg(app: web.Application, coro) -> None:
    """Track background tasks so shutdown can await them (reference used
    FastAPI BackgroundTasks, ``app/main.py:776-781``)."""
    task = asyncio.get_running_loop().create_task(coro)
    app[BG_TASKS_KEY].add(task)
    task.add_done_callback(app[BG_TASKS_KEY].discard)


# ---------------------------------------------------------------------------
# Handlers — models & form schema
# ---------------------------------------------------------------------------


async def health(request: web.Request) -> web.Response:
    return web.json_response({"status": "ok"})


async def list_models(request: web.Request) -> web.Response:
    """Entitled models (reference: ``user_available_models``,
    ``app/main.py:1323-1341``)."""
    rt = request.app[RUNTIME_KEY]
    user = _user(request)
    names = user.entitled_models(sorted(registry.JOB_MANIFESTS))
    out = []
    for name in names:
        cls = registry.JOB_MANIFESTS[name]
        out.append(
            {
                "name": name,
                "description": cls.description,
                "task": cls.task.value,
                "framework": cls.framework.value,
                "default_device": cls.default_device,
                "devices": rt.catalog.names(),
                "dataset": cls.dataset.model_dump(),
            }
        )
    return web.json_response({"models": out})


async def model_schema(request: web.Request) -> web.Response:
    """Submission-form JSON schema (reference: ``app/main.py:244-281`` —
    the pydantic Field metadata IS the form)."""
    user = _user(request)
    name = request.match_info["model_name"]
    cls = registry.get_spec(name)
    if cls is None or name not in user.entitled_models(list(registry.JOB_MANIFESTS)):
        return _json_error(404, f"model {name!r} not found")
    rt = request.app[RUNTIME_KEY]
    return web.json_response(
        {
            "model": name,
            "arguments_schema": cls.arguments_schema(),
            "devices": rt.catalog.names(),
            "default_device": cls.default_device,
            "default_num_slices": cls.default_num_slices,
        }
    )


# ---------------------------------------------------------------------------
# Handlers — job submission (reference: start_job, app/main.py:376-502, §3.1)
# ---------------------------------------------------------------------------


def _parse_arguments(raw: Any) -> dict[str, Any]:
    """Reference: ``_parse_arguments_input``, ``app/main.py:505-511``."""
    if raw is None or raw == "":
        return {}
    if isinstance(raw, dict):
        return raw
    try:
        parsed = json.loads(raw)
    except json.JSONDecodeError as e:
        raise TaskBuildError(f"arguments is not valid JSON: {e}") from e
    if not isinstance(parsed, dict):
        raise TaskBuildError("arguments must be a JSON object")
    return parsed


async def _stream_part_to_dataset(request: web.Request, part) -> str:
    """Stream a multipart file part straight into the object store as a
    dataset record (no whole-file buffering); returns the dataset id."""
    from .datasets import upload_dataset_stream

    rt = request.app[RUNTIME_KEY]
    user = _user(request)

    async def chunks():
        while chunk := await part.read_chunk(1 << 20):
            yield chunk

    record = await upload_dataset_stream(
        rt.store, rt.state,
        user_id=user.user_id,
        filename=part.filename or "dataset.jsonl",
        chunks=chunks(),
        bucket=rt.settings.datasets_bucket,
        content_type=part.headers.get("Content-Type"),
    )
    return record.dataset_id


async def _read_submission(request: web.Request) -> tuple[dict[str, Any], DatasetInput]:
    """Accept JSON or multipart (file upload) submissions."""
    ds = DatasetInput()
    if request.content_type == "multipart/form-data":
        fields: dict[str, Any] = {}
        async for part in await request.multipart():
            if part.name == "dataset_file":
                # uploaded file becomes a first-class dataset record; the job
                # then references it by id (streams, never buffers)
                ds.dataset_id = await _stream_part_to_dataset(request, part)
            else:
                fields[part.name] = (await part.read(decode=True)).decode()
    else:
        fields = await _json_body(request)
    ds.dataset_id = fields.pop("dataset_id", None) or ds.dataset_id
    ds.url = fields.pop("dataset_url", None) or None
    return fields, ds


@_limited("submit")
async def start_job(request: web.Request) -> web.Response:
    rt = request.app[RUNTIME_KEY]
    user = _user(request)
    fields, ds = await _read_submission(request)

    # unknown fields are rejected, not ignored: a typo'd "training_arguments"
    # silently training 100 default steps is far costlier than a 400
    known = {"model_name", "model", "arguments", "task", "device",
             "num_slices", "queue", "priority"}
    unknown = sorted(set(fields) - known)
    if unknown:
        return _json_error(
            400, f"unknown submission fields {unknown}; accepted: {sorted(known)}"
        )

    model_name = fields.get("model_name") or fields.get("model")
    if not model_name:
        return _json_error(400, "model_name is required")
    cls = registry.get_spec(model_name)
    if cls is None:
        return _json_error(404, f"model {model_name!r} not found")
    # entitlement check (reference: app/main.py:408-416)
    if model_name not in user.entitled_models(list(registry.JOB_MANIFESTS)):
        return _json_error(403, f"not entitled to model {model_name!r}")

    arguments = _parse_arguments(fields.get("arguments"))
    # pydantic-validates the typed hyperparameters; ValidationError → 400 list
    spec = cls(training_arguments=arguments)

    # task validation (reference: app/main.py:455-459, hardened): an unknown
    # task value is a 400 NAMING the known tasks — previously any string
    # passed as long as it didn't collide with the model's task
    task = fields.get("task")
    if task:
        from .specs import known_tasks

        known_task_values = known_tasks()
        if task not in known_task_values:
            return _json_error(
                400,
                f"unknown task {task!r}; known tasks: {known_task_values}",
            )
        if task != cls.task.value:
            return _json_error(
                400,
                f"model {model_name!r} is a {cls.task.value} model, "
                f"not {task!r}",
            )

    device = fields.get("device") or cls.default_device
    flavor = rt.catalog.get(device)
    if flavor is None:
        return _json_error(
            400,
            f"unknown device {device!r}; available: {rt.catalog.names()}",
        )
    try:
        num_slices = int(fields.get("num_slices") or cls.default_num_slices)
    except (TypeError, ValueError):
        return _json_error(400, "num_slices must be an integer")
    need = flavor.total_chips * max(1, num_slices)
    quota = rt.catalog.quota_for(device)
    if need > quota:
        # the fair-share scheduler refuses never-fitting workloads (they
        # would wedge their flavor's reservation); surface that as a 400
        # with the quota named instead of a 500 from the backend
        return _json_error(
            400,
            f"request needs {need} chips of {device!r} but the quota is "
            f"{quota}; reduce num_slices or pick a larger flavor",
        )

    # tenant queue + priority class (docs/scheduling.md): validated here so
    # a bad priority is a 400 at submit, never a failure inside admission
    queue = str(fields.get("queue") or "default").strip()
    if not queue or len(queue) > 64:
        return _json_error(400, "queue must be a non-empty name (<= 64 chars)")
    priority = fields.get("priority", "normal")
    try:
        parse_priority(priority)
    except ValueError as exc:
        return _json_error(400, str(exc))

    job_id = f"{model_name}-{generate_short_uuid()}"  # reference: app/main.py:422
    job = JobInput(
        job_id=job_id,
        user_id=user.user_id,
        model_name=model_name,
        device=device,
        num_slices=num_slices,
        arguments=arguments,
        queue=queue,
        priority=priority,
    )
    await task_builder(
        job, spec, ds,
        state=rt.state, store=rt.store, backend=rt.backend, catalog=rt.catalog,
        datasets_bucket=rt.settings.datasets_bucket,
        artifacts_bucket=rt.settings.artifacts_bucket,
    )
    # reference response shape: app/main.py:488
    return web.json_response({"message": "Job started successfully", "job_id": job_id})


# ---------------------------------------------------------------------------
# Handlers — job reads
# ---------------------------------------------------------------------------


@_limited("read")
async def get_jobs_page(request: web.Request) -> web.Response:
    """Paginated job table (reference: ``get_user_jobs_page``,
    ``app/main.py:524-613``)."""
    rt = request.app[RUNTIME_KEY]
    user = _user(request)
    q = request.query
    page = await rt.state.get_user_jobs(
        user.user_id,
        page=_int_param(q, "page", 1),
        page_size=min(_int_param(q, "page_size", 20), 100),
        status=_status_param(q),
        search=q.get("search"),
        sort_by=q.get("sort_by", "submitted_at"),
        descending=q.get("descending", "true").lower() != "false",
    )
    return web.json_response(page.model_dump(mode="json"))


async def get_job(request: web.Request) -> web.Response:
    job = await _owned_job(request, request.match_info["job_id"])
    return web.json_response(job.model_dump(mode="json"))


async def get_job_metrics(request: web.Request) -> web.Response:
    """Last 100 metric rows reversed + presigned CSV link (reference:
    ``app/main.py:660-709``)."""
    rt = request.app[RUNTIME_KEY]
    job = await _owned_job(request, request.match_info["job_id"])
    doc = await rt.state.get_metrics(job.job_id)
    records = (doc.records if doc else [])[-100:][::-1]
    csv_url = _signed_download_url(rt, doc.source_uri) if doc and doc.source_uri else None
    return web.json_response(
        {"job_id": job.job_id, "records": records, "csv_url": csv_url}
    )


async def get_job_artifacts(request: web.Request) -> web.Response:
    """Artifact zip download (reference: ``S3Handler.py:294-373`` streamed
    through the API)."""
    rt = request.app[RUNTIME_KEY]
    job = await _owned_job(request, request.match_info["job_id"])
    if not job.artifacts_uri:
        return _json_error(404, "job has no artifacts")
    objs = await rt.store.list_prefix(job.artifacts_uri)
    if not objs:
        return _json_error(404, "no artifacts found")
    if request.query.get("list"):
        # JSON inventory instead of the zip — how clients discover e.g. the
        # profiler trace under profile/ without downloading everything
        prefix_len = len(job.artifacts_uri.rstrip("/")) + 1
        return web.json_response(
            {
                "job_id": job.job_id,
                "artifacts": [
                    {"path": o["uri"][prefix_len:], "size": o["size"]}
                    for o in objs
                ],
            }
        )
    # spool the zip to disk and stream it out — multi-GB checkpoint prefixes
    # must not be materialised in RAM per download
    with tempfile.NamedTemporaryFile(suffix=".zip", delete=False) as tmp:
        tmp_path = Path(tmp.name)
    try:
        await rt.store.zip_prefix_to_path(job.artifacts_uri, tmp_path)
        resp = web.StreamResponse(
            headers={
                "Content-Type": "application/zip",
                "Content-Disposition": (
                    f'attachment; filename="{job.job_id}_artifacts.zip"'
                ),
                "Content-Length": str(tmp_path.stat().st_size),
            }
        )
        await resp.prepare(request)
        # ftc: ignore[blocking-io-in-async] -- open() of a local tmp file is metadata-only; the reads below go through to_thread
        with open(tmp_path, "rb") as f:
            while chunk := await asyncio.to_thread(f.read, 1 << 20):
                await resp.write(chunk)
        await resp.write_eof()
        return resp
    finally:
        tmp_path.unlink(missing_ok=True)


async def download(request: web.Request) -> web.Response:
    """Presigned-URL fulfillment (LocalObjectStore's stand-in for S3
    presigned GETs, reference ``S3Handler.py:168``)."""
    rt = request.app[RUNTIME_KEY]
    uri, sig = request.query.get("uri", ""), request.query.get("sig", "")
    if not uri or not rt.presigner.verify(uri, sig):
        return _json_error(403, "invalid or expired signature")
    if not await rt.store.exists(uri):
        return _json_error(404, "object not found")
    data = await rt.store.get_bytes(uri)
    return web.Response(
        body=data,
        content_type="application/octet-stream",
        headers={
            "Content-Disposition": f'attachment; filename="{uri.rsplit("/", 1)[-1]}"'
        },
    )


# ---------------------------------------------------------------------------
# Handlers — observability (docs/observability.md)
# ---------------------------------------------------------------------------


async def _append_event(rt: Runtime, job_id: str, event: str,
                        key: str | None = None, **attrs: Any) -> None:
    """Best-effort timeline append from a request handler."""
    await append_event_safe(rt.state, job_id, event, key=key, **attrs)


async def get_job_timeline(request: web.Request) -> web.Response:
    """The job's lifecycle event timeline, oldest first — the data behind
    ``ftc-ctl timeline`` (docs/observability.md §Timeline)."""
    job = await _owned_job(request, request.match_info["job_id"])
    events = sorted(job.events, key=lambda e: e.get("ts") or 0)
    return web.json_response(
        {
            "job_id": job.job_id,
            "trace_id": (job.metadata or {}).get("trace_id"),
            "status": job.status.value,
            "events": events,
        }
    )


async def get_job_trace(request: web.Request) -> web.Response:
    """The assembled span tree (controller phases derived from the timeline
    + trainer spans from the artifact channel), OTel-compatible dicts."""
    rt = request.app[RUNTIME_KEY]
    job = await _owned_job(request, request.match_info["job_id"])
    trainer_spans: list[dict[str, Any]] = []
    if job.artifacts_uri:
        uri = f"{job.artifacts_uri}/{TRACE_DIRNAME}/{TRAINER_SPANS_FILENAME}"
        try:
            if await rt.store.exists(uri):
                trainer_spans = parse_span_lines(await rt.store.get_bytes(uri))
        except Exception:
            logger.debug("trainer span read failed for %s", job.job_id,
                         exc_info=True)
    return web.json_response(
        build_trace(job.model_dump(mode="json"), trainer_spans)
    )


async def request_job_profile(request: web.Request) -> web.Response:
    """Arm an on-demand ``jax.profiler`` trace window on a LIVE job — no
    restart: the request rides the artifact channel in reverse
    (``backend.deliver_file`` → ``profile_request.json`` → the trainer's
    fit loop polls for it at the preemption-sync cadence and captures N
    steps into ``profile/``, shipped with the artifacts).  The poll is
    independent of the tracing kill switch (a ``FTC_TRACE=0`` job still
    profiles); only ``FTC_PROFILE=0`` in the trainer env opts out, in which
    case the delivered request is never consumed."""
    rt = request.app[RUNTIME_KEY]
    job = await _owned_job(request, request.match_info["job_id"])
    if job.status is not DatabaseStatus.RUNNING:
        return _json_error(
            409, f"job is {job.status.value}; profiling needs a running job"
        )
    body = await _json_body(request) if request.can_read_body else {}
    steps = body.get("steps", 5)
    if not isinstance(steps, int) or not 1 <= steps <= 1000:
        return _json_error(400, "steps must be an integer in [1, 1000]")
    payload = json.dumps(
        {"steps": steps, "requested_at": time.time()}
    ).encode()
    delivered = await rt.backend.deliver_file(
        job.job_id, "profile_request.json", payload
    )
    if not delivered:
        return _json_error(
            501, "this backend cannot deliver control files to running jobs"
        )
    await _append_event(
        rt, job.job_id, obs_events.PROFILE_REQUESTED, steps=steps,
    )
    return web.json_response(
        {
            "message": f"profiler window armed for {steps} steps",
            "artifact": "profile/ (fetch via GET /jobs/{id}/artifacts?list=1)",
        },
        status=202,
    )


# ---------------------------------------------------------------------------
# Handlers — lifecycle mutations
# ---------------------------------------------------------------------------


@_limited("promote")
async def promote_job(request: web.Request) -> web.Response:
    """Reference: ``promote_job``, ``app/main.py:713-794`` (§3.4), with the
    same guards."""
    rt = request.app[RUNTIME_KEY]
    job = await _owned_job(request, request.match_info["job_id"])
    if job.promotion_status is PromotionStatus.IN_PROGRESS:
        return web.json_response(
            {"detail": "promotion already in progress"}, status=202
        )
    if not job.status.is_final:
        return _json_error(400, "cannot promote a running job")
    if job.status is not DatabaseStatus.SUCCEEDED:
        return _json_error(400, f"cannot promote a {job.status.value} job")
    if not job.artifacts_uri or not await rt.store.list_prefix(job.artifacts_uri):
        return _json_error(404, "job has no artifacts to promote")
    cls = registry.get_spec(job.model_name)
    promotion_path = cls.promotion_path if cls else "models"
    destination = promotion_destination(
        rt.settings.deploy_bucket, promotion_path, job.job_id
    )
    promo = request.app[PROMOTION_KEY]
    # Compare-and-set claim: concurrent promote requests race on the awaits
    # between the guard above and here, so the IN_PROGRESS transition itself
    # must be atomic — only the request that wins the CAS spawns the copy.
    # expect_from pins the legal sources: a promote landing while an
    # unpromote is DELETING (or any state the guards above didn't see) loses
    # in the store, not in these stale-read guards.
    if not await rt.state.begin_promotion(
        job.job_id, PromotionStatus.IN_PROGRESS, destination,
        expect_from=[
            PromotionStatus.NOT_PROMOTED,
            PromotionStatus.FAILED,
            PromotionStatus.COMPLETED,  # re-promote refreshes the deploy copy
        ],
    ):
        return web.json_response(
            {"detail": "promotion already in progress"}, status=202
        )
    await _append_event(
        rt, job.job_id, obs_events.PROMOTION_STARTED, destination=destination
    )
    _spawn_bg(
        request.app,
        promo.promote_job_task(job.job_id, job.artifacts_uri, destination),
    )
    return web.json_response(
        {"message": "promotion started", "destination": destination}, status=202
    )


@_limited("promote")
async def unpromote_job(request: web.Request) -> web.Response:
    """Reference: ``unpromote_job``, ``app/main.py:798-835``."""
    rt = request.app[RUNTIME_KEY]
    job = await _owned_job(request, request.match_info["job_id"])
    if job.promotion_status not in (PromotionStatus.COMPLETED, PromotionStatus.FAILED):
        return _json_error(400, "job is not promoted")
    if not job.promotion_uri:
        return _json_error(404, "no promotion destination recorded")
    promo = request.app[PROMOTION_KEY]
    # Same CAS claim as promote: only the winning request spawns the cleanup,
    # and only from a settled promoted/failed state (never mid-promote).
    if not await rt.state.begin_promotion(
        job.job_id, PromotionStatus.DELETING, job.promotion_uri,
        expect_from=[PromotionStatus.COMPLETED, PromotionStatus.FAILED],
    ):
        return web.json_response(
            {"detail": "unpromotion already in progress"}, status=202
        )
    _spawn_bg(request.app, promo.unpromote_job_task(job.job_id, job.promotion_uri))
    return web.json_response({"message": "unpromotion started"}, status=202)


async def cancel_job(request: web.Request) -> web.Response:
    """Reference: ``cancel_job``, ``app/main.py:839-903``: stop the backend
    half, mark CANCELLED."""
    rt = request.app[RUNTIME_KEY]
    job = await _owned_job(request, request.match_info["job_id"])
    if job.status.is_final:
        return _json_error(400, f"job already {job.status.value}")
    await rt.backend.delete_job(job.job_id)
    # fixed key: two racing cancel requests must fold into ONE timeline
    # event, or the second lands outside every span and poisons the
    # exported trace's gap-free verdict
    await _append_event(rt, job.job_id, obs_events.CANCELLED, key="cancelled")
    await rt.state.update_job_status(
        job.job_id, DatabaseStatus.CANCELLED, end_time=time.time(), queue_position=None
    )
    # the backend half is gone, so the monitor's report loop may never see
    # this job again — export the trace here (docs/observability.md promises
    # an export for EVERY terminal state, cancels included)
    _spawn_bg(request.app, export_trace(rt.state, rt.store, job.job_id))
    return web.json_response({"message": "job cancelled", "job_id": job.job_id})


async def delete_job(request: web.Request) -> web.Response:
    """Reference: ``delete_job``, ``app/main.py:907-946``: archive-on-delete;
    running jobs must be cancelled first."""
    rt = request.app[RUNTIME_KEY]
    job = await _owned_job(request, request.match_info["job_id"])
    if not job.status.is_final and job.status is not DatabaseStatus.UNKNOWN:
        return _json_error(400, "cancel the job before deleting it")
    await rt.backend.delete_job(job.job_id)
    await rt.state.delete_job(job.job_id)
    return web.json_response({"message": "job deleted", "job_id": job.job_id})


# ---------------------------------------------------------------------------
# Handlers — datasets (reference: app/main.py:953-1060)
# ---------------------------------------------------------------------------


async def upload_dataset(request: web.Request) -> web.Response:
    from .datasets import stream_dataset_url

    rt = request.app[RUNTIME_KEY]
    user = _user(request)
    if request.content_type == "multipart/form-data":
        async for part in await request.multipart():
            if part.name in ("file", "dataset_file"):
                dataset_id = await _stream_part_to_dataset(request, part)
                record = await rt.state.get_dataset(dataset_id)
                return web.json_response(record.model_dump(mode="json"), status=201)
        return _json_error(400, "multipart field 'file' is required")
    body = await _json_body(request)
    url = body.get("url")
    if not url:
        return _json_error(400, "provide a multipart file or a JSON body with 'url'")
    record = await stream_dataset_url(
        rt.store, rt.state,
        user_id=user.user_id, url=url, bucket=rt.settings.datasets_bucket,
    )
    return web.json_response(record.model_dump(mode="json"), status=201)


async def list_datasets(request: web.Request) -> web.Response:
    rt = request.app[RUNTIME_KEY]
    user = _user(request)
    records = await rt.state.get_user_datasets(user.user_id)
    return web.json_response(
        {"datasets": [r.model_dump(mode="json") for r in records]}
    )


async def get_dataset(request: web.Request) -> web.Response:
    rt = request.app[RUNTIME_KEY]
    user = _user(request)
    record = await rt.state.get_dataset(request.match_info["dataset_id"])
    if record is None or (record.user_id != user.user_id and not user.is_admin):
        return _json_error(404, "dataset not found")
    out = record.model_dump(mode="json")
    out["download_url"] = _signed_download_url(rt, record.uri)
    return web.json_response(out)


async def delete_dataset(request: web.Request) -> web.Response:
    rt = request.app[RUNTIME_KEY]
    user = _user(request)
    record = await rt.state.get_dataset(request.match_info["dataset_id"])
    if record is None or (record.user_id != user.user_id and not user.is_admin):
        return _json_error(404, "dataset not found")
    await rt.store.delete_prefix(record.uri.rsplit("/", 1)[0])
    await rt.state.delete_dataset(record.dataset_id)
    return web.json_response({"message": "dataset deleted"})


# ---------------------------------------------------------------------------
# Handlers — WebSocket log streaming (reference: app/main.py:340-366, §3.3)
# ---------------------------------------------------------------------------


async def stream_logs_ws(request: web.Request) -> web.WebSocketResponse:
    rt = request.app[RUNTIME_KEY]
    job_id = request.match_info["job_id"]
    # ownership check before accepting (the reference checks inside the
    # manager via DB reads; checking here fails fast)
    await _owned_job(request, job_id)
    q = request.query
    # validate query params BEFORE hijacking the connection — a 400 must go
    # out as HTTP, not onto a prepared WebSocket
    follow = q.get("follow", "true").lower() != "false"
    last_lines = _int_param(q, "last_lines", 0) or None
    search_string = q.get("search_string", rt.settings.log_stream_search_string)
    ws = web.WebSocketResponse(heartbeat=30)
    await ws.prepare(request)
    manager = LogStreamManager(
        ws, job_id, rt.state, rt.backend,
        follow=follow,
        last_lines=last_lines,
        search_string=search_string,
        start_timeout_s=rt.settings.log_stream_start_timeout_s,
    )
    try:
        await manager.run()
    finally:
        await ws.close()
    return ws


async def get_job_logs(request: web.Request) -> web.Response:
    """REST log read (reference admin pod-log route ``app/main.py:1214-1252``)."""
    rt = request.app[RUNTIME_KEY]
    job = await _owned_job(request, request.match_info["job_id"])
    last = _int_param(request.query, "last_lines", 0) or None
    try:
        lines_iter = await rt.backend.read_logs(
            job.job_id, follow=False, last_lines=last
        )
        lines = [line async for line in lines_iter]
    except Exception:
        # substrate cleaned up: serve the archived copy from the artifacts
        # (capability the reference lacks — pod logs die with the pods)
        logger.debug("live log read failed for %s; trying archived copy",
                     job.job_id, exc_info=True)
        archived = f"{job.artifacts_uri}/logs.txt" if job.artifacts_uri else None
        if not archived or not await rt.store.exists(archived):
            return _json_error(404, "logs unavailable")
        text = (await rt.store.get_bytes(archived)).decode(errors="replace")
        lines = text.splitlines()
        if last:
            lines = lines[-last:]
    return web.json_response({"job_id": job.job_id, "lines": lines})


# ---------------------------------------------------------------------------
# Handlers — admin (reference: app/main.py:1099-1297)
# ---------------------------------------------------------------------------


def _admin(request: web.Request):
    user = _user(request)
    if not user.is_admin:
        raise web.HTTPForbidden(
            text=json.dumps({"detail": "admin only"}), content_type="application/json"
        )
    return user


async def admin_jobs(request: web.Request) -> web.Response:
    """All users' jobs (reference: admin job table, ``app/main.py:1099-1150``)."""
    rt = request.app[RUNTIME_KEY]
    _admin(request)
    q = request.query
    page = await rt.state.get_user_jobs(
        None,
        page=_int_param(q, "page", 1),
        page_size=min(_int_param(q, "page_size", 20), 100),
        status=_status_param(q),
        search=q.get("search"),
    )
    return web.json_response(page.model_dump(mode="json"))


async def admin_queue(request: web.Request) -> web.Response:
    """Queue order + quota usage (reference: Kueue introspection,
    ``app/utils/kueue_helpers.py``)."""
    rt = request.app[RUNTIME_KEY]
    _admin(request)
    pending = await rt.backend.queue_snapshot()
    usage = None
    scheduler = getattr(rt.backend, "scheduler", None)
    if scheduler is not None:
        usage = scheduler.usage()
    return web.json_response({"pending": pending, "usage": usage})


async def admin_job_events(request: web.Request) -> web.Response:
    """Pod-events debug digest (reference: ``app/main.py:1214-1252``,
    ``kube_helpers.py:26-95``)."""
    rt = request.app[RUNTIME_KEY]
    _admin(request)
    events = await rt.backend.job_events(request.match_info["job_id"])
    return web.json_response({"events": events})


async def admin_scheduler(request: web.Request) -> web.Response:
    """Fair-share scheduler introspection (docs/scheduling.md): per-queue
    usage, weighted shares, borrowed chips, pending positions, preemption
    counters — the tenant view ``ftc-ctl queue`` renders."""
    rt = request.app[RUNTIME_KEY]
    _admin(request)
    scheduler = getattr(rt.backend, "scheduler", None)
    if scheduler is None:
        return web.json_response({"policy": None, "queues": {}, "flavors": {}})
    snapshot = getattr(scheduler, "snapshot", None)
    if snapshot is None:
        # the FIFO escape hatch has no tenant view; serve what it knows
        return web.json_response({
            "policy": "fifo", "queues": {}, "flavors": scheduler.usage(),
            "pending": scheduler.pending(),
        })
    return web.json_response(snapshot())


async def admin_backend_jobs(request: web.Request) -> web.Response:
    rt = request.app[RUNTIME_KEY]
    _admin(request)
    reports = await rt.backend.list_jobs()
    return web.json_response(
        {"jobs": [r.model_dump(mode="json") for r in reports]}
    )


async def admin_resilience(request: web.Request) -> web.Response:
    """Retry-supervisor + liveness-lease state (docs/resilience.md): the
    active policy, jobs waiting out a backoff, and lease-kill counters."""
    rt = request.app[RUNTIME_KEY]
    _admin(request)
    supervisor = rt.monitor.supervisor
    lease = rt.monitor.lease
    body: dict[str, Any] = {
        "enabled": supervisor is not None,
        "lease_enabled": lease is not None,
        "lease_kills": rt.monitor.lease_kills,
    }
    if supervisor is not None:
        body["policy"] = {
            "max_attempts": supervisor.policy.max_attempts,
            "base_delay_s": supervisor.policy.base_delay_s,
            "max_delay_s": supervisor.policy.max_delay_s,
        }
        body["counters"] = {
            "retries_scheduled": supervisor.retries_scheduled,
            "resubmits": supervisor.resubmits,
            "terminal_failures": supervisor.terminal_failures,
            # elasticity (docs/elasticity.md)
            "resizes": supervisor.resizes,
            "elastic_restores": supervisor.elastic_restores,
            "topology_downgrades": supervisor.topology_downgrades,
        }
        body["pending_retries"] = await supervisor.pending_retries()
    if lease is not None:
        body["lease_s"] = lease.lease_s
    # per-job progress (docs/observability.md): each RUNNING job's newest
    # heartbeat now carries last_step/last_step_ms — rate, not just liveness
    from ..resilience.heartbeat import HEARTBEAT_FILENAME, parse_heartbeat

    async def _job_progress(job) -> dict[str, Any] | None:
        uri = f"{job.artifacts_uri}/{HEARTBEAT_FILENAME}"
        try:
            if not await rt.store.exists(uri):
                return None
            hb = parse_heartbeat(await rt.store.get_bytes(uri))
        except Exception:
            logger.debug("heartbeat read failed for %s", job.job_id,
                         exc_info=True)
            return None
        if hb is None:
            return None
        step_ms = hb.get("last_step_ms")
        return {
            "job_id": job.job_id,
            "last_step": hb.get("last_step", hb.get("step")),
            "last_step_ms": step_ms,
            "steps_per_min": (
                round(60000.0 / step_ms, 2) if step_ms else None
            ),
            "heartbeat_age_s": round(max(time.time() - hb["ts"], 0.0), 1),
        }

    # the per-job reads are independent remote round-trips — run them
    # concurrently so the endpoint costs the slowest read, not the sum
    running = [
        job for job in await rt.state.get_jobs_by_status(DatabaseStatus.RUNNING)
        if job.artifacts_uri
    ]
    body["progress"] = [
        p for p in await asyncio.gather(*(_job_progress(j) for j in running))
        if p is not None
    ]
    return web.json_response(body)


# ---------------------------------------------------------------------------
# Handlers — auth + observability
# ---------------------------------------------------------------------------


async def mint_dev_token(request: web.Request) -> web.Response:
    """Dev-mode token mint (reference: ``dev_generate_token``,
    ``app/core/security.py:347-389``); disabled in production."""
    rt = request.app[RUNTIME_KEY]
    # the mint route is reachable unauthenticated, so it must only exist in
    # the local env — in any deployed environment an open mint + the HS256
    # verify fallback would hand out admin tokens to anyone
    if rt.settings.environment != "local":
        return _json_error(403, "dev tokens are only available in the local environment")
    body = await _json_body(request)
    token = dev_generate_token(
        body.get("user_id", "dev-user"),
        rt.settings.jwt_secret,
        scopes=body.get("scopes"),
        is_admin=bool(body.get("is_admin", False)),
        email=body.get("email", ""),
    )
    return web.json_response({"access_token": token, "token_type": "bearer"})


#: the Prometheus text exposition content type (version 0.0.4) — scrapers
#: key parsing off it; a bare text/plain is accepted but ambiguous
PROMETHEUS_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


# one escaping implementation for the whole /metrics payload: a rule added
# to one copy but not another would render the same label value differently
# between the gauge and histogram sections, forking series identity
prom_escape = escape_label


async def prometheus_metrics(request: web.Request) -> web.Response:
    """Controller self-metrics in Prometheus text format — a gap in the
    reference (SURVEY.md §5.5: 'No Prometheus/metrics endpoint')."""
    rt = request.app[RUNTIME_KEY]
    lines = [
        "# TYPE ftc_monitor_ticks_total counter",
        f"ftc_monitor_ticks_total {rt.monitor.ticks}",
    ]
    counts: dict[str, int] = {}
    active_jobs = await rt.state.get_active_jobs()
    for job in active_jobs:
        counts[job.status.value] = counts.get(job.status.value, 0) + 1
    lines.append("# TYPE ftc_jobs_active gauge")
    for status, n in sorted(counts.items()):
        lines.append(f'ftc_jobs_active{{status="{prom_escape(status)}"}} {n}')
    scheduler = getattr(rt.backend, "scheduler", None)
    if scheduler is not None:
        lines.append("# TYPE ftc_quota_chips gauge")
        for flavor, u in scheduler.usage().items():
            f = prom_escape(flavor)
            lines.append(
                f'ftc_quota_chips{{flavor="{f}",kind="used"}} {u["used_chips"]}'
            )
            lines.append(
                f'ftc_quota_chips{{flavor="{f}",kind="nominal"}} {u["nominal_chips"]}'
            )
    if scheduler is not None and hasattr(scheduler, "snapshot"):
        # fair-share tenant gauges (docs/scheduling.md)
        snap = scheduler.snapshot()
        sched_gauges = (
            ("ftc_sched_queue_depth", "gauge", "depth"),
            ("ftc_sched_queue_running", "gauge", "running"),
            ("ftc_sched_queue_used_chips", "gauge", "used_chips_total"),
            ("ftc_sched_queue_dominant_share", "gauge", "dominant_share"),
            ("ftc_sched_queue_borrowed_chips", "gauge", "borrowed_chips"),
            ("ftc_sched_queue_preemptions_total", "counter", "preemptions"),
            ("ftc_sched_queue_resizes_total", "counter", "resizes"),
        )
        for metric, kind, stat_key in sched_gauges:
            lines.append(f"# TYPE {metric} {kind}")
            for qname, q in sorted(snap["queues"].items()):
                lines.append(
                    f'{metric}{{queue="{prom_escape(qname)}"}} '
                    f"{q.get(stat_key, 0)}"
                )
        lines.append("# TYPE ftc_sched_preemptions_total counter")
        lines.append(f"ftc_sched_preemptions_total {snap['preemptions_total']}")
        # resize-instead-of-evict (docs/elasticity.md)
        lines.append("# TYPE ftc_sched_resizes_total counter")
        lines.append(f"ftc_sched_resizes_total {snap.get('resizes_total', 0)}")
        lines.append("# TYPE ftc_sched_shrunk_workloads gauge")
        lines.append(
            f"ftc_sched_shrunk_workloads {len(snap.get('shrunk_workloads') or {})}"
        )
    supervisor = rt.monitor.supervisor
    if supervisor is not None:
        # cross-topology restores executed by the retry loop
        lines.append("# TYPE ftc_elastic_restores_total counter")
        lines.append(
            f"ftc_elastic_restores_total {supervisor.elastic_restores}"
        )
        lines.append("# TYPE ftc_topology_downgrades_total counter")
        lines.append(
            f"ftc_topology_downgrades_total {supervisor.topology_downgrades}"
        )
    # the runtime shard audit's counters (reference analysis/shard_audit.py)
    lines.append(
        "# ftc_shard_audit_*: the shard audit is not ported yet "
        "(ROADMAP Queue A item 9)"
    )
    if rt.serve is not None:
        sessions = rt.serve.stats()
        serve_gauges = (
            ("ftc_serve_queue_depth", "gauge", "queue_depth"),
            ("ftc_serve_slots_busy", "gauge", "slots_busy"),
            ("ftc_serve_slots_total", "gauge", "slots_total"),
            ("ftc_serve_tokens_generated_total", "counter",
             "tokens_generated_total"),
            ("ftc_serve_requests_completed_total", "counter",
             "requests_completed_total"),
            ("ftc_serve_requests_rejected_total", "counter",
             "requests_rejected_total"),
            ("ftc_serve_decode_steps_total", "counter", "steps_total"),
            ("ftc_serve_compilations", "gauge", "compilations"),
            # prefix-reuse KV cache (docs/serving.md)
            ("ftc_serve_prefix_hits_total", "counter", "prefix_hits_total"),
            ("ftc_serve_prefix_misses_total", "counter",
             "prefix_misses_total"),
            ("ftc_serve_prefill_tokens_saved_total", "counter",
             "prefill_tokens_saved_total"),
            ("ftc_serve_prefix_cache_bytes", "gauge", "prefix_cache_bytes"),
            # replica fleet + router (docs/serving.md §Fleet)
            ("ftc_serve_replica_total", "gauge", "replicas_total"),
            ("ftc_serve_replica_healthy", "gauge", "replicas_healthy"),
            ("ftc_serve_replica_draining", "gauge", "replicas_draining"),
            ("ftc_serve_replica_generation", "gauge", "generation"),
            ("ftc_serve_replica_restarts_total", "counter",
             "replica_restarts_total"),
            ("ftc_serve_replica_failed_total", "counter",
             "replicas_failed_total"),
            ("ftc_serve_drains_total", "counter", "drains_total"),
            ("ftc_serve_rollovers_total", "counter", "rollovers_total"),
            ("ftc_serve_failovers_total", "counter", "failovers_total"),
            ("ftc_serve_duplicates_suppressed_total", "counter",
             "duplicates_suppressed_total"),
            ("ftc_serve_shed_total", "counter", "shed_total"),
            ("ftc_serve_step_errors_total", "counter", "step_errors_total"),
            # paged KV pool (docs/serving.md §Paged KV) — zeros when unpaged
            ("ftc_serve_kv_pages_total", "gauge", "kv_pages_total"),
            ("ftc_serve_kv_pages_free", "gauge", "kv_pages_free"),
            ("ftc_serve_kv_pages_used", "gauge", "kv_pages_used"),
            ("ftc_serve_kv_pages_shared", "gauge", "kv_pages_shared"),
            ("ftc_serve_kv_cow_copies_total", "counter",
             "kv_cow_copies_total"),
            ("ftc_serve_kv_pool_exhaustions_total", "counter",
             "kv_pool_exhaustions_total"),
            # host KV tier (docs/serving.md §KV tiering) — zeros when off
            ("ftc_serve_kv_tier_host_pages_total", "gauge",
             "kv_tier_host_pages_total"),
            ("ftc_serve_kv_tier_host_pages_used", "gauge",
             "kv_tier_host_pages_used"),
            ("ftc_serve_kv_tier_host_bytes", "gauge", "kv_tier_host_bytes"),
            ("ftc_serve_kv_demotions_total", "counter", "kv_demotions_total"),
            ("ftc_serve_kv_restores_total", "counter", "kv_restores_total"),
            # multi-tenant adapters (docs/serving.md §Multi-tenant adapters)
            ("ftc_serve_adapters_loaded", "gauge", "adapters_loaded"),
        )
        lines.append("# TYPE ftc_serve_models_loaded gauge")
        lines.append(f"ftc_serve_models_loaded {len(sessions)}")
        for metric, kind, stat_key in serve_gauges:
            lines.append(f"# TYPE {metric} {kind}")
            for job_id, stats in sorted(sessions.items()):
                lines.append(
                    f'{metric}{{job_id="{prom_escape(job_id)}"}} '
                    f"{stats.get(stat_key, 0)}"
                )
        # per-tenant series — bounded cardinality: loaded adapters only
        # ("" = the base model, labeled "base")
        tenant_gauges = (
            ("ftc_serve_tenant_tokens_total", "counter", "tokens_by_tenant"),
            ("ftc_serve_tenant_lanes", "gauge", "lanes_by_tenant"),
            ("ftc_serve_tenant_queue_depth", "gauge",
             "queue_depth_by_tenant"),
        )
        for metric, kind, stat_key in tenant_gauges:
            series = [
                (job_id, tenant, value)
                for job_id, stats in sorted(sessions.items())
                for tenant, value in sorted(
                    (stats.get(stat_key) or {}).items())
            ]
            if not series:
                continue
            lines.append(f"# TYPE {metric} {kind}")
            for job_id, tenant, value in series:
                lines.append(
                    f'{metric}{{job_id="{prom_escape(job_id)}",'
                    f'adapter="{prom_escape(tenant or "base")}"}} {value}'
                )
        # cross-process transport: process-wide RPC, byte and respawn
        # counters shared by every process-mode fleet of this control plane
        from ..transport import metrics_snapshot as transport_snapshot

        tsnap = transport_snapshot()
        for metric, key in (
            ("ftc_serve_transport_rpcs_total", "rpcs_total"),
            ("ftc_serve_transport_rpc_errors_total", "rpc_errors_total"),
            ("ftc_serve_transport_worker_respawns_total", "worker_respawns_total"),
            ("ftc_serve_transport_bytes_total", "bytes_total"),
        ):
            lines.append(f"# TYPE {metric} counter")
            lines.append(f"{metric} {tsnap.get(key, 0)}")
    # preference-optimization gauges (docs/preference.md): surfaced from the
    # newest synced metrics row of every ACTIVE dpo/rlhf job — reward margin
    # is the number a healthy DPO run drives up, and the rollout triple
    # (buffer depth, staleness, actor tok/s) is the actor/learner loop's
    # health check.  Bounded cardinality: active preference jobs only.
    dpo_jobs = [
        j for j in active_jobs
        if (j.metadata or {}).get("task") in ("dpo", "rlhf", "reward")
    ]
    if dpo_jobs:
        dpo_gauges = (
            ("ftc_dpo_reward_margin", "reward_margin"),
            ("ftc_dpo_accuracy", "dpo_accuracy"),
            ("ftc_dpo_rollout_buffer_depth", "rollout_buffer_depth"),
            ("ftc_dpo_rollout_staleness", "rollout_staleness"),
            ("ftc_dpo_actor_tokens_per_sec", "actor_tokens_per_sec"),
            # disaggregated data plane (docs/preference.md §Disaggregated
            # rollouts): remote-actor fleet health, absent on in-process
            # rlhf rows and skipped by the column guard below
            ("ftc_rollout_workers_alive", "rollout_workers_alive"),
            ("ftc_rollout_respawns_total", "rollout_respawns_total"),
            ("ftc_rollout_dup_pairs_total", "rollout_dup_pairs_total"),
            ("ftc_rollout_actor_version", "actor_version"),
        )
        rows: dict[str, dict] = {}
        for job in dpo_jobs:
            doc = await rt.state.get_metrics(job.job_id)
            if doc is not None and doc.records:
                rows[job.job_id] = doc.records[-1]
        for metric, column in dpo_gauges:
            samples = []
            for job_id, row in sorted(rows.items()):
                try:
                    value = float(row.get(column, ""))
                except (TypeError, ValueError):
                    continue  # column absent (e.g. rollout_* on a plain DPO job)
                samples.append(
                    f'{metric}{{job_id="{prom_escape(job_id)}"}} {value:g}'
                )
            if samples:
                lines.append(f"# TYPE {metric} gauge")
                lines.extend(samples)
    # observability layer (docs/observability.md): latency histograms (step
    # phases, queue wait, retry latency, serve TTFT) + process identity
    obs = getattr(rt, "obs", None)
    if obs is not None:
        from .. import __version__

        lines.extend(obs.render())
        lines.extend(obs.render_process_info(
            process=request.app.get(PROCESS_KEY) or "server",
            version=__version__,
            backend=rt.settings.backend,
        ))
    return web.Response(
        body=("\n".join(lines) + "\n").encode("utf-8"),
        headers={"Content-Type": PROMETHEUS_CONTENT_TYPE},
    )


def _openapi_schema(app: web.Application, settings: Settings) -> dict[str, Any]:
    """Minimal OpenAPI doc with BearerAuth on every API path (reference:
    ``custom_openapi_jwt_auth``, ``app/api/custom_openapi.py:6-31``)."""
    paths: dict[str, Any] = {}
    for route in app.router.routes():
        info = route.resource.get_info() if route.resource else {}
        path = info.get("path") or info.get("formatter")
        if not path or not path.startswith(settings.api_prefix):
            continue
        method = route.method.lower()
        if method in ("head", "options", "*"):
            continue
        entry = paths.setdefault(path, {})
        entry[method] = {
            "summary": (route.handler.__doc__ or "").strip().split("\n")[0],
            "security": [{"BearerAuth": []}],
            "responses": {"200": {"description": "OK"}},
        }
    return {
        "openapi": "3.1.0",
        "info": {"title": "finetune-controller-tpu", "version": "0.1.0"},
        "paths": paths,
        "components": {
            "securitySchemes": {
                "BearerAuth": {"type": "http", "scheme": "bearer", "bearerFormat": "JWT"}
            }
        },
    }


async def openapi_json(request: web.Request) -> web.Response:
    rt = request.app[RUNTIME_KEY]
    return web.json_response(_openapi_schema(request.app, rt.settings))


# ---------------------------------------------------------------------------
# App assembly (reference: setup_middleware app/api/middleware.py:59-66 +
# lifespan app/main.py:78-105)
# ---------------------------------------------------------------------------


def build_app(runtime: Runtime, *, with_monitor: bool | None = None) -> web.Application:
    settings = runtime.settings
    # The default jwt_secret is a PUBLIC string: with auth enabled and no
    # real validation source configured, anyone could forge admin tokens.
    # Refuse to start outside the local environment; warn inside it.
    # (reference warns when prod auth is unconfigured, middleware.py:28-30)
    secret_unset = settings.jwt_secret in ("", DEFAULT_JWT_SECRET)
    real_source = bool(settings.introspection_url or settings.jwks_url)
    if settings.auth_enabled and secret_unset and not real_source:
        msg = (
            "auth_enabled=True but no introspection URL, no JWKS URL, and the "
            "JWT secret is the well-known default — tokens would be forgeable"
        )
        if settings.environment != "local":
            raise RuntimeError(msg)
        logger.warning("%s (allowed only because environment=local)", msg)
    # With a real validation source configured, the well-known default secret
    # must not remain a valid HS256 fallback — neutralise it so only the real
    # source can authenticate tokens.
    effective_secret = "" if (secret_unset and real_source) else settings.jwt_secret
    validator = TokenValidator(
        jwt_secret=effective_secret,
        introspection_url=settings.introspection_url,
        introspection_client_id=settings.introspection_client_id,
        introspection_client_secret=settings.introspection_client_secret,
        jwks_url=settings.jwks_url,
        audience=settings.jwt_audience,
    )
    app = web.Application(
        middlewares=[
            build_cors_middleware(settings.cors_origins),
            error_middleware,
            build_auth_middleware(
                validator,
                enabled=settings.auth_enabled,
                api_prefix=settings.api_prefix,
            ),
        ],
        client_max_size=1 << 30,  # dataset uploads
    )
    app[RUNTIME_KEY] = runtime
    app[PROMOTION_KEY] = PromotionTask(runtime.state, runtime.store)
    app[LIMITER_KEY] = RateLimiter(
        runtime.state,
        {
            "submit": settings.rate_limit_submit_per_min,
            "read": settings.rate_limit_read_per_min,
            "promote": settings.rate_limit_promote_per_min,
            "generate": settings.rate_limit_generate_per_min,
        },
    )
    app[BG_TASKS_KEY] = set()
    app[PROCESS_KEY] = "server"
    # observability hub (docs/observability.md): runtimes assembled outside
    # build_runtime (tests) get one here, and components constructed without
    # one adopt it so their observations reach /metrics
    if getattr(runtime, "obs", None) is None:
        runtime.obs = ObsHub()
    if runtime.monitor is not None and getattr(runtime.monitor, "obs", None) is None:
        runtime.monitor.obs = runtime.obs
    supervisor = getattr(runtime.monitor, "supervisor", None)
    if supervisor is not None and getattr(supervisor, "obs", None) is None:
        supervisor.obs = runtime.obs
    # inference over promoted checkpoints (serve/service.py); runtimes built
    # outside build_runtime (tests) get a manager here so the routes work
    from ..serve.service import SERVE_KEY, ServeManager, add_serve_routes

    if runtime.serve is None:
        runtime.serve = ServeManager(
            runtime.state, runtime.store, settings, obs=runtime.obs,
            backend=runtime.backend,
        )
    elif getattr(runtime.serve, "obs", None) is None:
        runtime.serve.obs = runtime.obs
    app[SERVE_KEY] = runtime.serve

    p = settings.api_prefix
    app.router.add_get(f"{p}/health", health)
    app.router.add_get(f"{p}/models", list_models)
    app.router.add_get(f"{p}/models/{{model_name}}/schema", model_schema)
    app.router.add_post(f"{p}/jobs", start_job)
    app.router.add_get(f"{p}/jobs", get_jobs_page)
    app.router.add_get(f"{p}/jobs/{{job_id}}", get_job)
    app.router.add_get(f"{p}/jobs/{{job_id}}/metrics", get_job_metrics)
    app.router.add_get(f"{p}/jobs/{{job_id}}/timeline", get_job_timeline)
    app.router.add_get(f"{p}/jobs/{{job_id}}/trace", get_job_trace)
    app.router.add_post(f"{p}/jobs/{{job_id}}/profile", request_job_profile)
    app.router.add_get(f"{p}/jobs/{{job_id}}/artifacts", get_job_artifacts)
    app.router.add_get(f"{p}/jobs/{{job_id}}/logs", get_job_logs)
    app.router.add_post(f"{p}/jobs/{{job_id}}/promote", promote_job)
    app.router.add_post(f"{p}/jobs/{{job_id}}/unpromote", unpromote_job)
    app.router.add_post(f"{p}/jobs/{{job_id}}/cancel", cancel_job)
    app.router.add_delete(f"{p}/jobs/{{job_id}}", delete_job)
    app.router.add_get(f"{p}/logs/{{job_id}}", stream_logs_ws)  # WS
    app.router.add_post(f"{p}/datasets", upload_dataset)
    app.router.add_get(f"{p}/datasets", list_datasets)
    app.router.add_get(f"{p}/datasets/{{dataset_id}}", get_dataset)
    app.router.add_delete(f"{p}/datasets/{{dataset_id}}", delete_dataset)
    app.router.add_get(f"{p}/download", download)
    app.router.add_get(f"{p}/admin/jobs", admin_jobs)
    app.router.add_get(f"{p}/admin/queue", admin_queue)
    app.router.add_get(f"{p}/admin/scheduler", admin_scheduler)
    app.router.add_get(f"{p}/admin/jobs/{{job_id}}/events", admin_job_events)
    app.router.add_get(f"{p}/admin/backend/jobs", admin_backend_jobs)
    app.router.add_get(f"{p}/admin/resilience", admin_resilience)
    app.router.add_post(f"{p}/auth/dev-token", mint_dev_token)
    app.router.add_get(f"{p}/openapi.json", openapi_json)
    app.router.add_get("/metrics", prometheus_metrics)
    add_serve_routes(app, p)

    async def on_startup(app: web.Application) -> None:
        await runtime.start(with_monitor=with_monitor)
        # crash recovery: promotions interrupted by a previous shutdown
        await app[PROMOTION_KEY].recover_interrupted()
        logger.info(
            "control plane up: backend=%s monitor_in_process=%s",
            settings.backend,
            settings.monitor_in_process if with_monitor is None else with_monitor,
        )

    async def on_cleanup(app: web.Application) -> None:
        for task in list(app[BG_TASKS_KEY]):
            task.cancel()
        await runtime.close()

    app.on_startup.append(on_startup)
    app.on_cleanup.append(on_cleanup)
    return app


def main(argv: list[str] | None = None) -> int:
    """``python -m finetune_controller_tpu_torch.controller.server --port 8787``
    (reference: ``uvicorn app.main:app``, ``Dockerfile:28``).

    ``--workers N`` serves from N processes sharing the port via
    ``SO_REUSEPORT`` — the reference's ``uvicorn --workers 4``.  Requires the
    k8s backend (stateless against the apiserver; job/dataset state shared
    through the sqlite WAL store, which is multi-process-safe on one host).
    The local fake-cluster backend holds per-process job handles, so it
    refuses to fan out.  The monitor runs in worker 0 only.
    """
    import argparse
    import os
    import signal

    from .config import get_settings
    from .logging_config import setup_logging

    parser = argparse.ArgumentParser(prog="ftc-serve")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8787)
    parser.add_argument("--plugin-dir", default=None, help="model plugin directory")
    parser.add_argument("--workers", type=int, default=1,
                        help="server processes sharing the port (k8s backend only)")
    args = parser.parse_args(argv)
    setup_logging()

    workers = max(1, args.workers)
    settings = get_settings()
    if workers > 1 and settings.backend == "local":
        parser.error(
            "--workers > 1 requires FTC_BACKEND=k8s: the local backend's "
            "job handles live in one process"
        )
    if workers > 1 and settings.state_backend != "sqlite":
        parser.error("--workers > 1 requires FTC_STATE_BACKEND=sqlite")

    worker_idx, children = 0, []
    for i in range(1, workers):
        pid = os.fork()
        if pid == 0:
            worker_idx, children = i, []
            break
        children.append(pid)

    if children:
        # reap + log dead workers so an OOM-killed child is neither a silent
        # capacity loss nor a zombie for the parent's lifetime
        def _reap(signum, frame):
            while True:
                try:
                    pid, status = os.waitpid(-1, os.WNOHANG)
                except ChildProcessError:
                    return
                if pid == 0:
                    return
                if pid in children:
                    children.remove(pid)
                    logger.error(
                        "worker %d died (status %d): serving capacity reduced",
                        pid, status,
                    )

        signal.signal(signal.SIGCHLD, _reap)

    try:
        # each worker builds its own runtime AFTER the fork (no shared
        # fds/locks); the try covers the build too — a parent-side build
        # failure must not orphan already-forked children on the port
        runtime = build_runtime(plugin_dir=args.plugin_dir)
        # monitor in worker 0 only — and only if the operator wants an
        # in-process monitor at all (a separate monitor deployment sets it
        # false)
        with_monitor = (
            None if workers == 1
            else (worker_idx == 0 and settings.monitor_in_process)
        )
        app = build_app(runtime, with_monitor=with_monitor)
        web.run_app(
            app, host=args.host, port=args.port, reuse_port=workers > 1
        )
    finally:
        if children:
            signal.signal(signal.SIGCHLD, signal.SIG_DFL)
        for pid in list(children):
            try:
                os.kill(pid, signal.SIGTERM)
            except ProcessLookupError:
                continue
        deadline = time.monotonic() + 10
        for pid in list(children):
            try:
                while time.monotonic() < deadline:
                    done, _ = os.waitpid(pid, os.WNOHANG)
                    if done:
                        break
                    time.sleep(0.1)
                else:
                    os.kill(pid, signal.SIGKILL)
                    os.waitpid(pid, 0)
            except (ChildProcessError, ProcessLookupError):
                continue  # already reaped by the SIGCHLD handler
    return 0


if __name__ == "__main__":
    # `python -m ...controller.server` loads this file as `__main__`, a
    # SECOND module instance with its own AppKey objects. Handlers that
    # import the module by its canonical name (serve/service.py) would then
    # look up different keys than build_app stored and 500. Delegate to the
    # canonical instance so there is exactly one set of keys.
    from finetune_controller_tpu_torch.controller.server import main as _main

    raise SystemExit(_main())
