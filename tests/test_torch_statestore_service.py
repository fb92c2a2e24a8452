"""The port's shared state service (``controller/statestore_service.py``,
``statestore_main.py``) against the reference's, wired both ways.

Three wirings run one script of every domain RPC (27 methods: jobs,
status and promotion CAS, events, metadata, metrics, datasets, the user
table, deletes and the cluster-scope rate limit): the reference's client
against the reference's service (the baseline), the port's client against
the reference's service, and the reference's client against the port's
service.  Each answer, dumped to JSON, and each service's final rows must
equal the baseline's (exact; wall-clock fields masked).  A wrong or
missing token is a 401, an unknown RPC a 404, a body that is not JSON a
400, from both services alike.  Then a ``tiny-test-lora`` job runs end to
end through the port's API server with ``state_backend=remote``, its state
in the port's ``statestore_main`` process, and the store keeps the record
after the service restarts on the same file.
"""

from __future__ import annotations

import asyncio
import json
import os
import socket
import subprocess
import sys
import time
import urllib.error
import urllib.request
from pathlib import Path

from aiohttp.test_utils import TestServer

from conftest import run_async as run
from finetune_controller_tpu.controller import schemas as ref_schemas
from finetune_controller_tpu.controller import statestore as ref_statestore
from finetune_controller_tpu.controller import statestore_service as ref_service
from finetune_controller_tpu.obs import make_event
from finetune_controller_tpu_torch.controller import schemas as port_schemas
from finetune_controller_tpu_torch.controller import statestore as port_statestore
from finetune_controller_tpu_torch.controller import statestore_service as port_service
from finetune_controller_tpu_torch.controller import web as port_web

ROOT = Path(__file__).resolve().parents[1]
TOKEN = "s3cret"
TIME_KEYS = {"submitted_at", "start_time", "end_time", "training_duration", "created_at",
             "updated_at", "archived_at", "ts", "queue_wait_s"}


def _mask(x):
    if isinstance(x, dict):
        return {k: ("<t>" if k in TIME_KEYS and v is not None else _mask(v))
                for k, v in x.items()}
    if isinstance(x, list):
        return [_mask(v) for v in x]
    return x


def _dump(x):
    if hasattr(x, "model_dump"):
        return _mask(x.model_dump(mode="json"))
    if isinstance(x, dict):
        return {k: _dump(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_dump(v) for v in x]
    return x


async def _ref_service(tmp: Path):
    store = ref_statestore.StateStore(tmp / "state", backend="sqlite")
    await store.connect()
    server = TestServer(ref_service.build_state_app(store, TOKEN))
    await server.start_server()

    async def close():
        await server.close()
        await store.close()

    return str(server.make_url("")).rstrip("/"), close


async def _port_service(tmp: Path):
    store = port_statestore.StateStore(tmp / "state", backend="sqlite")
    await store.connect()
    runner = port_web.AppRunner(port_service.build_state_app(store, TOKEN))
    await runner.setup()
    site = port_web.TCPSite(runner, "127.0.0.1", 0)
    await site.start()

    async def close():
        await runner.cleanup()
        await store.close()

    return f"http://127.0.0.1:{site.port}", close


async def _script(client, schemas) -> list:
    """Every RPC of the service, with the answers dumped."""
    S, P = schemas.DatabaseStatus, schemas.PromotionStatus

    def job(job_id, user="u"):
        return schemas.JobRecord(job_id=job_id, user_id=user, model_name="tiny-test-lora",
                                 device="cpu-test", arguments={"total_steps": 4})

    out = []
    add = out.append
    await client.connect()
    await client.create_job(job("j-1"))
    await client.create_job(job("j-2"))
    await client.create_job(job("j-3", user="v"))
    add(await client.get_job("j-1"))
    add(await client.get_job("missing"))
    add(await client.get_jobs_by_ids(["j-1", "j-3", "missing"]))
    add(await client.update_job_status("j-1", S.RUNNING, metadata={"node": "n1"},
                                       start_time=100.0))
    add(await client.transition_job_status("j-2", S.QUEUED, S.RUNNING, metadata={"a": 1}))
    add(await client.transition_job_status("j-2", S.QUEUED, S.FAILED))
    add(await client.get_active_jobs())
    add(await client.get_jobs_by_status(S.RUNNING))
    add(await client.update_job_fields("j-1", message="hello", queue_position=2))
    add(await client.append_job_event("j-1", make_event("running", key="running:a1", ts=5.0)))
    add(await client.append_job_event("j-1", make_event("running", key="running:a1", ts=5.0)))
    add(await client.append_job_events("j-1", [
        make_event("checkpoint-committed", key="trainer:a1:0", step=10, ts=6.0),
        make_event("checkpoint-committed", key="trainer:a1:0", step=10, ts=6.0),
        make_event("train-finished", key="trainer:a1:1", step=20, ts=7.0)]))
    add(await client.append_job_events("j-1", []))
    add(await client.merge_job_metadata("j-1", {"obs_events_ingested": 2, "nested": {"x": 1}}))
    add(await client.update_job_status("j-1", S.SUCCEEDED, end_time=200.0))
    add(await client.update_job_promotion("j-1", P.IN_PROGRESS, "obj://deploy/a"))
    add(await client.find_jobs_with_promotion_in([P.IN_PROGRESS]))
    add(await client.transition_job_promotion("j-1", [P.IN_PROGRESS], P.COMPLETED,
                                              "obj://deploy/a"))
    add(await client.begin_promotion("j-1", P.IN_PROGRESS, "obj://deploy/b",
                                     expect_from=[P.NOT_PROMOTED]))
    add(await client.begin_promotion("j-1", P.DELETING, "obj://deploy/a",
                                     expect_from=[P.COMPLETED]))
    add(await client.get_user_jobs("u", page=1, page_size=1))
    add(await client.get_user_jobs(None, page=1, page_size=10, status=S.SUCCEEDED))
    add(await client.get_user_jobs("u", search="j-2", sort_by="job_id", descending=False))
    await client.upsert_metrics(schemas.MetricsDocument(
        job_id="j-1", records=[{"step": 1, "loss": 2.0}, {"step": 2, "loss": None}]))
    add(await client.get_metrics("j-1"))
    add(await client.get_metrics("j-2"))
    await client.insert_dataset(schemas.DatasetRecord(
        dataset_id="d-1", user_id="u", name="train.jsonl", uri="obj://datasets/u/d-1/x",
        size_bytes=12))
    add(await client.get_dataset("d-1"))
    add(await client.add_dataset_job_ref("d-1", "j-1"))
    add(await client.get_user_datasets("u"))
    add(await client.delete_dataset("d-1"))
    add(await client.get_dataset("d-1"))
    add(await client.delete_job("j-2"))
    add(await client.get_job("j-2"))
    add(await client.purge_job("j-3"))
    add([await client.rate_limit_acquire("rl/submit/u", 3, 60.0) for _ in range(5)])
    await client.close()
    return _dump(out)


def _raw(url: str, path: str, body: bytes | None, token: str | None) -> tuple[int, dict]:
    headers = {"Authorization": f"Bearer {token}"} if token is not None else {}
    req = urllib.request.Request(url + path, data=body, method="POST" if body is not None
                                 else "GET", headers=headers)
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _errors(url: str) -> list:
    return [
        _raw(url, "/healthz", None, None),
        _raw(url, "/rpc/get_job", b'{"job_id": "j-1"}', None),
        _raw(url, "/rpc/get_job", b'{"job_id": "j-1"}', "wrong"),
        _raw(url, "/rpc/nope", b"{}", TOKEN),
        _raw(url, "/rpc/get_job", b"not json", TOKEN),
        _raw(url, "/rpc/get_job", b"{}", TOKEN),  # KeyError -> 400
        _raw(url, "/rpc/get_jobs_by_status", b'{"status": "bogus"}', TOKEN),
    ]


def test_both_cross_wirings_answer_as_the_reference(tmp_path):
    async def wiring(name, service, client_mod, schemas):
        url, close = await service(tmp_path / name)
        try:
            answers = await _script(client_mod.RemoteStateStore(url, token=TOKEN), schemas)
            errors = await asyncio.to_thread(_errors, url)
            rows = await _script_rows(url, client_mod)
        finally:
            await close()
        return answers, errors, rows

    async def _script_rows(url, client_mod):
        client = client_mod.RemoteStateStore(url, token=TOKEN)
        rows = _dump([await client.get_job(j) for j in ("j-1", "j-2", "j-3")])
        await client.close()
        return rows

    async def go():
        base = await wiring("ref_ref", _ref_service, ref_service, ref_schemas)
        port_client = await wiring("port_client", _ref_service, port_service, port_schemas)
        port_svc = await wiring("port_service", _port_service, ref_service, ref_schemas)
        port_port = await wiring("port_port", _port_service, port_service, port_schemas)
        return base, port_client, port_svc, port_port

    base, port_client, port_svc, port_port = run(asyncio.wait_for(go(), 60))
    assert port_client == base
    assert port_svc == base
    assert port_port == base
    answers, errors, _ = base
    assert [s for s, _ in errors] == [200, 401, 401, 404, 400, 400, 400]
    assert answers[-1] == [True, True, True, False, False]


def test_port_client_returns_the_port_types(tmp_path):
    async def go():
        url, close = await _port_service(tmp_path)
        try:
            client = port_service.RemoteStateStore(url, token=TOKEN)
            from finetune_controller_tpu_torch.controller.schemas import JobRecord

            await client.create_job(JobRecord(job_id="t-1", user_id="u", model_name="m",
                                              device="h100"))
            job = await client.get_job("t-1")
            bad = port_service.RemoteStateStore(url, token="wrong")
            try:
                await bad.get_job("t-1")
                raise AssertionError("expected auth rejection")
            except IOError as e:
                assert "401" in str(e)
            await bad.close()
            await client.close()
            return job
        finally:
            await close()

    job = run(asyncio.wait_for(go(), 30))
    assert type(job).__module__ == "finetune_controller_tpu_torch.controller.schemas"
    assert job.job_id == "t-1"
    try:
        port_service.RemoteStateStore("")
        raise AssertionError("expected a missing-url error")
    except ValueError as e:
        assert "state_service_url" in str(e)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _start_service(state_dir: Path, port: int) -> subprocess.Popen:
    env = dict(os.environ, FTC_STATE_TOKEN=TOKEN, PYTHONPATH=str(ROOT))
    proc = subprocess.Popen(
        [sys.executable, "-m", "finetune_controller_tpu_torch.controller.statestore_main",
         "--state-dir", str(state_dir), "--host", "127.0.0.1", "--port", str(port)],
        env=env, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    deadline = time.time() + 30
    while True:
        try:
            if _raw(f"http://127.0.0.1:{port}", "/healthz", None, None)[0] == 200:
                return proc
        except OSError:
            pass
        assert proc.poll() is None and time.time() < deadline, "state service never came up"
        time.sleep(0.1)


def _stop_service(proc: subprocess.Popen) -> int:
    proc.terminate()
    return proc.wait(timeout=10)


def test_port_api_job_on_the_remote_state_service(tmp_path):
    """A job end to end with ``state_backend=remote``; the record survives
    a restart of ``statestore_main`` on the same file, which exits 0 on
    SIGTERM."""
    from finetune_controller_tpu_torch.controller import registry
    from finetune_controller_tpu_torch.controller.config import Settings
    from finetune_controller_tpu_torch.controller.runtime import build_runtime
    from finetune_controller_tpu_torch.controller.statestore_service import RemoteStateStore
    from test_torch_api import SUBMIT, _Served, _wait, http
    from finetune_controller_tpu_torch.controller.server import build_app

    port = _free_port()
    proc = _start_service(tmp_path / "service", port)
    served = None
    try:
        registry.reset()
        settings = Settings(
            state_backend="remote", state_service_url=f"http://127.0.0.1:{port}",
            state_service_token=TOKEN, state_dir=str(tmp_path / "api"),
            object_store_root=str(tmp_path / "objects"), job_monitor_interval_s=0.1,
            artifact_sync_interval_s=0.2, device="cpu", rate_limit_read_per_min=1000)
        rt = build_runtime(settings)
        assert isinstance(rt.state, RemoteStateStore)
        served = _Served(build_app(rt), port_web)
        status, resp = http(served.base, "POST", "/jobs", fields={
            "model_name": SUBMIT["model_name"], "device": SUBMIT["device"],
            "arguments": json.dumps(SUBMIT["arguments"])})
        assert status == 200, resp
        job = _wait(served.base, resp["job_id"], lambda j: j["status"] in (
            "succeeded", "failed", "cancelled"))
        assert job["status"] == "succeeded", job
        metrics = http(served.base, "GET", f"/jobs/{job['job_id']}/metrics")[1]
        assert [r["step"] for r in metrics["records"]] == [4, 3, 2, 1]
        served.close()
        served = None
        assert _stop_service(proc) == 0

        async def read_back():
            client = RemoteStateStore(f"http://127.0.0.1:{port}", token=TOKEN)
            record = await client.get_job(job["job_id"])
            rows = await client.get_metrics(job["job_id"])
            await client.close()
            return record, rows

        proc = _start_service(tmp_path / "service", port)
        record, rows = run(asyncio.wait_for(read_back(), 30))
        assert record.status.value == "succeeded"
        assert record.model_dump(mode="json")["metadata"] == job["metadata"]
        assert [r["step"] for r in rows.records] == [1, 2, 3, 4]  # the API serves them newest first
    finally:
        if served is not None:
            served.close()
        if proc.poll() is None:
            assert _stop_service(proc) == 0
