"""The port's ``HttpKubeClient`` against the reference's ``AiohttpKubeClient``
on the same fake API server.

The seven contract cases of ``tests/test_kube_client_contract.py`` run for
each client against that file's scriptable aiohttp server (its recorded
JobSet, ``Status`` and pod-list payloads): create/get/list/delete, 503
then success, 429 with ``Retry-After``, 401 and the rotated token re-read
from the service-account directory, 409 adopting the existing object, a
terminal 403 with no retry, and a followed pod log read as lines.  Both
clients must give the same answers and make the same calls.  Tolerance:
exact (payloads, call sequences); the ``Retry-After`` wait is a lower
bound.
"""

from __future__ import annotations

import asyncio

import pytest
from aiohttp import web

from finetune_controller_tpu.controller.backends.base import BackendError as RefBackendError
from finetune_controller_tpu.controller.backends.k8s import AiohttpKubeClient
from finetune_controller_tpu_torch.controller.backends.base import BackendError
from finetune_controller_tpu_torch.controller.backends.k8s import HttpKubeClient
from test_kube_client_contract import JOBSET_OBJ, JOBSET_PATH, STATUS_409, _FakeApiServer, _serve

CLIENTS = {"ref": (AiohttpKubeClient, RefBackendError), "port": (HttpKubeClient, BackendError)}


def run(coro):
    return asyncio.run(asyncio.wait_for(coro, 60))


def _client(kind: str, url: str, token: str | None = "t0"):
    client = CLIENTS[kind][0](base_url=url, token=token)
    client.BASE_DELAY_S = 0.01  # keep retry backoff test-fast
    return client


async def _with_server(kind: str, script=(), body=None, token: str | None = "t0",
                       setup=None):
    fake = _FakeApiServer()
    fake.script = list(script)
    runner, url = await _serve(fake)
    client = _client(kind, url, token)
    if setup is not None:
        setup(fake, client)
    try:
        return await body(client), fake.calls
    finally:
        await client.close()
        await runner.cleanup()


@pytest.mark.parametrize("kind", CLIENTS)
def test_create_get_list_delete_roundtrip(kind):
    async def body(client):
        created = await client.create(JOBSET_PATH, {
            "apiVersion": "jobset.x-k8s.io/v1alpha2", "kind": "JobSet",
            "metadata": {"name": "tiny-abc123", "namespace": "default"}})
        return (created, await client.get(JOBSET_PATH, "tiny-abc123"),
                await client.get(JOBSET_PATH, "missing"),
                await client.list("/api/v1/namespaces/default/pods",
                                  label_selector="jobset.sigs.k8s.io/jobset-name=tiny-abc123"),
                await client.delete(JOBSET_PATH, "tiny-abc123"))

    out = run(_with_server(kind, body=body))
    created, got, missing, pods, deleted = out[0]
    assert created["metadata"]["uid"]
    assert got["status"]["conditions"][0]["type"] == "Completed"
    assert missing is None
    assert pods[0]["status"]["phase"] == "Running"
    assert deleted is True
    if kind == "port":
        assert out == run(_with_server("ref", body=body))


@pytest.mark.parametrize("kind", CLIENTS)
def test_retry_on_503_then_success(kind):
    def script():
        return [web.json_response({"kind": "Status", "code": 503}, status=503)
                for _ in range(2)]

    async def body(client):
        return await client.get(JOBSET_PATH, "tiny-abc123")

    got, calls = run(_with_server(kind, script=script(), body=body))
    assert got["metadata"]["name"] == "tiny-abc123"
    assert len(calls) == 3  # 2 failures + 1 success
    if kind == "port":
        assert (got, calls) == run(_with_server("ref", script=script(), body=body))


@pytest.mark.parametrize("kind", CLIENTS)
def test_retry_429_honors_retry_after(kind):
    async def body(client):
        t0 = asyncio.get_running_loop().time()
        got = await client.get(JOBSET_PATH, "tiny-abc123")
        return got, asyncio.get_running_loop().time() - t0

    (got, waited), calls = run(_with_server(kind, body=body, script=[web.json_response(
        {"kind": "Status", "code": 429}, status=429, headers={"Retry-After": "0.05"})]))
    assert got == JOBSET_OBJ and waited >= 0.05 and len(calls) == 2


@pytest.mark.parametrize("kind", CLIENTS)
def test_401_rereads_rotated_token(kind, tmp_path):
    (tmp_path / "token").write_text("fresh-token\n")

    def setup(fake, client):
        fake.auth_required = "fresh-token"
        client.SA_DIR = tmp_path  # projected SA dir with a rotated token on disk
        client._token = "stale-token"  # cached pre-rotation token
        client._token_read_at = 1e18  # cache looks fresh; only 401 invalidates

    async def body(client):
        return await client.get(JOBSET_PATH, "tiny-abc123")

    got, calls = run(_with_server(kind, body=body, token=None, setup=setup))
    assert got["metadata"]["name"] == "tiny-abc123"
    assert len(calls) == 2  # the stale token rejected, the re-read one accepted


@pytest.mark.parametrize("kind", CLIENTS)
def test_create_409_adopts_existing(kind):
    async def body(client):
        return await client.create(JOBSET_PATH, {
            "metadata": {"name": "tiny-abc123", "namespace": "default"}})

    created, calls = run(_with_server(
        kind, body=body, script=[web.json_response(STATUS_409, status=409)]))
    assert created["metadata"]["uid"] == JOBSET_OBJ["metadata"]["uid"]
    assert [c[:2] for c in calls] == [("POST", JOBSET_PATH),
                                      ("GET", f"{JOBSET_PATH}/tiny-abc123")]


@pytest.mark.parametrize("kind", CLIENTS)
def test_terminal_error_raises_with_status_body(kind):
    async def body(client):
        with pytest.raises(CLIENTS[kind][1]) as ei:
            await client.get(JOBSET_PATH, "tiny-abc123")
        return str(ei.value)

    message, calls = run(_with_server(kind, body=body, script=[web.json_response(
        {"kind": "Status", "code": 403, "reason": "Forbidden",
         "message": "jobsets is forbidden"}, status=403)]))
    assert "403" in message and "jobsets is forbidden" in message
    assert len(calls) == 1  # terminal: no retry burn


@pytest.mark.parametrize("kind", CLIENTS)
def test_pod_log_follow_stream(kind):
    async def body(client):
        lines = [line async for line in await client.pod_log_lines(
            "default", "tiny-abc123-workers-0-0-abcde", container="trainer", follow=True,
            tail_lines=10)]
        return lines

    lines, calls = run(_with_server(kind, body=body))
    assert lines == ["step 1 loss 5.9", "step 2 loss 5.1"]
    assert calls[-1][1].endswith("/pods/tiny-abc123-workers-0-0-abcde/log")
