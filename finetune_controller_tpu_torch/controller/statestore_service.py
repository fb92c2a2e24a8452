"""Shared state service: the control plane's EXTERNAL store.

The reference scales its API to N replicas because every replica and the
monitor talk to one external MongoDB (``app/database/db.py:51``); our default
sqlite-WAL engine shares state only between processes on ONE node. This
module closes that gap without adding a database dependency: a small HTTP
daemon (:func:`build_state_app` on the port's ``controller/web.py``,
entrypoint ``python -m finetune_controller_tpu_torch.controller.statestore_main``)
hosts the
real :class:`~.statestore.StateStore` (sqlite engine) and exposes its DOMAIN
methods as JSON RPCs, and :class:`RemoteStateStore` implements the same
interface over HTTP — so ``state_backend=remote`` turns the API×N + monitor
layout into a true HA control plane, and rate limits enforced through
``rate_limit_acquire`` become cluster-scope.

The RPC surface is the domain API, not the collection primitives: domain
calls take JSON-serializable arguments, while collection operations take
Python predicates that cannot cross a wire. Auth is a static bearer token
(``FTC_STATE_TOKEN``) — this is an in-cluster service, not a user surface.

The port's copy of the reference module: the same RPC names, arguments and
JSON bodies (a reference client talks to this service and the reference
service to this client), the client on the port's stdlib HTTP client
(``controller/httpclient.py``).
"""

from __future__ import annotations

import asyncio
import hmac
import logging
from typing import Any, Awaitable, Callable

from .schemas import (
    DatabaseStatus,
    DatasetRecord,
    JobRecord,
    MetricsDocument,
    PaginatedTableResponse,
)
from .statestore import StateStore

logger = logging.getLogger(__name__)

_RPC: dict[str, Callable[[StateStore, dict], Awaitable[Any]]] = {}


def _rpc(name: str):
    def deco(fn):
        _RPC[name] = fn
        return fn

    return deco


def _dump(model) -> Any:
    return model.model_dump(mode="json") if model is not None else None


@_rpc("create_job")
async def _create_job(store, p):
    await store.create_job(JobRecord(**p["job"]))


@_rpc("get_job")
async def _get_job(store, p):
    return _dump(await store.get_job(p["job_id"]))


@_rpc("get_jobs_by_ids")
async def _get_jobs_by_ids(store, p):
    jobs = await store.get_jobs_by_ids(p["job_ids"])
    return {k: _dump(v) for k, v in jobs.items()}


@_rpc("get_active_jobs")
async def _get_active_jobs(store, p):
    return [_dump(j) for j in await store.get_active_jobs()]


@_rpc("get_jobs_by_status")
async def _get_jobs_by_status(store, p):
    jobs = await store.get_jobs_by_status(DatabaseStatus(p["status"]))
    return [_dump(j) for j in jobs]


@_rpc("update_job_status")
async def _update_job_status(store, p):
    return await store.update_job_status(
        p["job_id"], DatabaseStatus(p["status"]),
        metadata=p.get("metadata"), **(p.get("fields") or {}),
    )


@_rpc("transition_job_status")
async def _transition_job_status(store, p):
    return await store.transition_job_status(
        p["job_id"], DatabaseStatus(p["expect"]), DatabaseStatus(p["status"]),
        metadata=p.get("metadata"), **(p.get("fields") or {}),
    )


@_rpc("update_job_promotion")
async def _update_job_promotion(store, p):
    return await store.update_job_promotion(
        p["job_id"], p["promotion_status"], p.get("promotion_uri")
    )


@_rpc("begin_promotion")
async def _begin_promotion(store, p):
    return await store.begin_promotion(
        p["job_id"], p["promotion_status"], p["promotion_uri"],
        expect_from=p.get("expect_from"),
    )


@_rpc("transition_job_promotion")
async def _transition_job_promotion(store, p):
    return await store.transition_job_promotion(
        p["job_id"], p["expect"], p["promotion_status"],
        p.get("promotion_uri"),
    )


@_rpc("update_job_fields")
async def _update_job_fields(store, p):
    return await store.update_job_fields(p["job_id"], **(p.get("fields") or {}))


@_rpc("append_job_event")
async def _append_job_event(store, p):
    return await store.append_job_event(p["job_id"], p["event"])


@_rpc("append_job_events")
async def _append_job_events(store, p):
    return await store.append_job_events(p["job_id"], p.get("events") or [])


@_rpc("merge_job_metadata")
async def _merge_job_metadata(store, p):
    return await store.merge_job_metadata(p["job_id"], p.get("patch") or {})


@_rpc("find_jobs_with_promotion_in")
async def _find_jobs_with_promotion_in(store, p):
    return [_dump(j) for j in await store.find_jobs_with_promotion_in(p["states"])]


@_rpc("get_user_jobs")
async def _get_user_jobs(store, p):
    res = await store.get_user_jobs(
        p.get("user_id"),
        page=p.get("page", 1),
        page_size=p.get("page_size", 20),
        status=DatabaseStatus(p["status"]) if p.get("status") else None,
        search=p.get("search"),
        sort_by=p.get("sort_by", "submitted_at"),
        descending=p.get("descending", True),
    )
    return _dump(res)


@_rpc("purge_job")
async def _purge_job(store, p):
    return await store.purge_job(p["job_id"])


@_rpc("delete_job")
async def _delete_job(store, p):
    return await store.delete_job(p["job_id"])


@_rpc("upsert_metrics")
async def _upsert_metrics(store, p):
    await store.upsert_metrics(MetricsDocument(**p["metrics"]))


@_rpc("get_metrics")
async def _get_metrics(store, p):
    return _dump(await store.get_metrics(p["job_id"]))


@_rpc("insert_dataset")
async def _insert_dataset(store, p):
    await store.insert_dataset(DatasetRecord(**p["dataset"]))


@_rpc("get_dataset")
async def _get_dataset(store, p):
    return _dump(await store.get_dataset(p["dataset_id"]))


@_rpc("get_user_datasets")
async def _get_user_datasets(store, p):
    return [_dump(d) for d in await store.get_user_datasets(p["user_id"])]


@_rpc("add_dataset_job_ref")
async def _add_dataset_job_ref(store, p):
    return await store.add_dataset_job_ref(p["dataset_id"], p["job_id"])


@_rpc("delete_dataset")
async def _delete_dataset(store, p):
    return await store.delete_dataset(p["dataset_id"])


@_rpc("rate_limit_acquire")
async def _rate_limit_acquire(store, p):
    return await store.rate_limit_acquire(
        p["key"], p["limit"], p.get("window_s", 60.0)
    )


def build_state_app(store: StateStore, token: str = ""):
    """The application serving the state RPCs (+ ``/healthz``), on the
    port's ``controller/web.py``."""
    from . import web

    async def rpc_handler(request: web.Request) -> web.Response:
        # constant-time comparison: a plain != short-circuits on the first
        # differing byte, leaking token prefixes to an in-cluster attacker
        # who can measure latency. Compare as bytes — compare_digest on str
        # raises TypeError for non-ASCII input, which would turn a garbage
        # Authorization header into a 500 instead of a 401.
        presented = request.headers.get("Authorization", "")
        if token and not hmac.compare_digest(
            presented.encode("utf-8", "surrogateescape"),
            f"Bearer {token}".encode(),
        ):
            return web.json_response({"error": "unauthorized"}, status=401)
        method = request.match_info["method"]
        handler = _RPC.get(method)
        if handler is None:
            return web.json_response(
                {"error": f"unknown method {method!r}"}, status=404
            )
        try:
            payload = await request.json() if request.can_read_body else {}
        except ValueError:
            return web.json_response({"error": "bad json"}, status=400)
        try:
            result = await handler(store, payload)
        except (KeyError, ValueError, TypeError) as exc:
            return web.json_response(
                {"error": f"{type(exc).__name__}: {exc}"}, status=400
            )
        except Exception:
            logger.exception("state rpc %s failed", method)
            return web.json_response({"error": "internal"}, status=500)
        return web.json_response({"result": result})

    async def healthz(request: web.Request) -> web.Response:
        return web.json_response({"ok": True})

    # metrics documents for long jobs exceed the default 1 MiB body cap —
    # same override the API server uses (server.py)
    app = web.Application(client_max_size=1 << 30)
    app.router.add_post("/rpc/{method}", rpc_handler)
    app.router.add_get("/healthz", healthz)
    return app


class RemoteStateStore:
    """``StateStore``-compatible client for the shared state service.

    Drop-in for every control-plane consumer (server, monitor, promotion,
    task builder) — same domain methods, same pydantic return types. Writes
    are single-attempt (a retried mutation could double-apply); reads retry
    once on transient transport errors.
    """

    def __init__(self, url: str, *, token: str = ""):
        if not url:
            raise ValueError(
                "state_backend=remote needs state_service_url (the shared "
                "state service endpoint)"
            )
        self.url = url.rstrip("/")
        self._token = token
        self._session = None
        self._connected = False

    async def _http(self):
        from . import httpclient

        if self._session is None or self._session.closed:
            headers = (
                {"Authorization": f"Bearer {self._token}"} if self._token else {}
            )
            self._session = httpclient.ClientSession(
                timeout=httpclient.ClientTimeout(total=60, connect=10),
                headers=headers,
            )
        return self._session

    async def connect(self) -> None:
        session = await self._http()
        async with session.get(f"{self.url}/healthz") as resp:
            if resp.status != 200:
                raise IOError(
                    f"state service unhealthy ({resp.status}) at {self.url}"
                )
        self._connected = True

    async def close(self) -> None:
        if self._session is not None and not self._session.closed:
            await self._session.close()
        self._connected = False

    async def _call(self, method: str, retry_reads: bool = False, **payload):
        from .httpclient import ClientError

        session = await self._http()
        attempts = 2 if retry_reads else 1
        for attempt in range(attempts):
            try:
                async with session.post(
                    f"{self.url}/rpc/{method}", json=payload
                ) as resp:
                    body = await resp.json()
                    if resp.status >= 500 and attempt < attempts - 1:
                        continue
                    if resp.status >= 300:
                        raise IOError(
                            f"state rpc {method} failed ({resp.status}): "
                            f"{body.get('error')}"
                        )
                    return body.get("result")
            except (ClientError, asyncio.TimeoutError):
                if attempt >= attempts - 1:
                    raise
        raise AssertionError("unreachable")

    # -- domain surface (mirrors StateStore) ---------------------------------

    async def create_job(self, job: JobRecord) -> None:
        await self._call("create_job", job=job.model_dump(mode="json"))

    async def get_job(self, job_id: str) -> JobRecord | None:
        doc = await self._call("get_job", retry_reads=True, job_id=job_id)
        return JobRecord(**doc) if doc else None

    async def get_jobs_by_ids(self, job_ids: list[str]) -> dict[str, JobRecord]:
        docs = await self._call(
            "get_jobs_by_ids", retry_reads=True, job_ids=list(job_ids)
        )
        return {k: JobRecord(**v) for k, v in docs.items()}

    async def get_active_jobs(self) -> list[JobRecord]:
        docs = await self._call("get_active_jobs", retry_reads=True)
        return [JobRecord(**d) for d in docs]

    async def get_jobs_by_status(self, status) -> list[JobRecord]:
        docs = await self._call(
            "get_jobs_by_status", retry_reads=True,
            status=DatabaseStatus(status).value,
        )
        return [JobRecord(**d) for d in docs]

    async def update_job_status(
        self,
        job_id: str,
        status: DatabaseStatus,
        *,
        metadata: dict[str, Any] | None = None,
        **fields: Any,
    ) -> bool:
        return await self._call(
            "update_job_status", job_id=job_id,
            status=DatabaseStatus(status).value, metadata=metadata,
            fields=fields,
        )

    async def transition_job_status(
        self,
        job_id: str,
        expect,
        status,
        *,
        metadata: dict[str, Any] | None = None,
        **fields: Any,
    ) -> bool:
        return await self._call(
            "transition_job_status", job_id=job_id,
            expect=DatabaseStatus(expect).value,
            status=DatabaseStatus(status).value,
            metadata=metadata, fields=fields,
        )

    async def update_job_promotion(
        self, job_id, promotion_status, promotion_uri=None
    ) -> bool:
        from .schemas import PromotionStatus

        return await self._call(
            "update_job_promotion", job_id=job_id,
            promotion_status=PromotionStatus(promotion_status).value,
            promotion_uri=promotion_uri,
        )

    async def begin_promotion(
        self, job_id, promotion_status, promotion_uri, expect_from=None
    ) -> bool:
        from .schemas import PromotionStatus

        return await self._call(
            "begin_promotion", job_id=job_id,
            promotion_status=PromotionStatus(promotion_status).value,
            promotion_uri=promotion_uri,
            expect_from=(
                None if expect_from is None
                else [PromotionStatus(s).value for s in expect_from]
            ),
        )

    async def transition_job_promotion(
        self, job_id, expect, promotion_status, promotion_uri=None
    ) -> bool:
        from .schemas import PromotionStatus

        return await self._call(
            "transition_job_promotion", job_id=job_id,
            expect=[PromotionStatus(s).value for s in expect],
            promotion_status=PromotionStatus(promotion_status).value,
            promotion_uri=promotion_uri,
        )

    async def update_job_fields(self, job_id: str, **fields: Any) -> bool:
        return await self._call(
            "update_job_fields", job_id=job_id, fields=fields
        )

    async def append_job_event(self, job_id: str, event: dict[str, Any]) -> bool:
        return await self._call("append_job_event", job_id=job_id, event=event)

    async def append_job_events(
        self, job_id: str, events: list[dict[str, Any]]
    ) -> int:
        if not events:
            return 0
        return await self._call(
            "append_job_events", job_id=job_id, events=events
        )

    async def merge_job_metadata(self, job_id: str, patch: dict[str, Any]) -> bool:
        return await self._call("merge_job_metadata", job_id=job_id, patch=patch)

    async def find_jobs_with_promotion_in(self, states) -> list[JobRecord]:
        from .schemas import PromotionStatus

        docs = await self._call(
            "find_jobs_with_promotion_in", retry_reads=True,
            states=[PromotionStatus(s).value for s in states],
        )
        return [JobRecord(**d) for d in docs]

    async def get_user_jobs(
        self,
        user_id: str | None,
        *,
        page: int = 1,
        page_size: int = 20,
        status: DatabaseStatus | None = None,
        search: str | None = None,
        sort_by: str = "submitted_at",
        descending: bool = True,
    ) -> PaginatedTableResponse:
        res = await self._call(
            "get_user_jobs", retry_reads=True, user_id=user_id, page=page,
            page_size=page_size,
            status=DatabaseStatus(status).value if status else None,
            search=search, sort_by=sort_by, descending=descending,
        )
        return PaginatedTableResponse(**res)

    async def purge_job(self, job_id: str) -> bool:
        return await self._call("purge_job", job_id=job_id)

    async def delete_job(self, job_id: str) -> bool:
        return await self._call("delete_job", job_id=job_id)

    async def upsert_metrics(self, metrics: MetricsDocument) -> None:
        await self._call(
            "upsert_metrics", metrics=metrics.model_dump(mode="json")
        )

    async def get_metrics(self, job_id: str) -> MetricsDocument | None:
        doc = await self._call("get_metrics", retry_reads=True, job_id=job_id)
        return MetricsDocument(**doc) if doc else None

    async def insert_dataset(self, dataset: DatasetRecord) -> None:
        await self._call(
            "insert_dataset", dataset=dataset.model_dump(mode="json")
        )

    async def get_dataset(self, dataset_id: str) -> DatasetRecord | None:
        doc = await self._call(
            "get_dataset", retry_reads=True, dataset_id=dataset_id
        )
        return DatasetRecord(**doc) if doc else None

    async def get_user_datasets(self, user_id: str) -> list[DatasetRecord]:
        docs = await self._call(
            "get_user_datasets", retry_reads=True, user_id=user_id
        )
        return [DatasetRecord(**d) for d in docs]

    async def add_dataset_job_ref(self, dataset_id: str, job_id: str) -> bool:
        return await self._call(
            "add_dataset_job_ref", dataset_id=dataset_id, job_id=job_id
        )

    async def delete_dataset(self, dataset_id: str) -> bool:
        return await self._call("delete_dataset", dataset_id=dataset_id)

    async def rate_limit_acquire(
        self, key: str, limit: int, window_s: float = 60.0
    ) -> bool:
        return await self._call(
            "rate_limit_acquire", key=key, limit=limit, window_s=window_s
        )
