"""The port's ``LogStreamManager`` (``controller/stream_logger.py``) against
the reference's, and the WebSocket log follow through the port's server.

Both managers stream the same fake job from the same fake backend into a
recording WebSocket, and must send the same frames (exact, text for
text): a queued job that starts, a terminal job (historical, chunked), the
search-string gate, ``last_lines``, a start timeout and an unknown job.
Then the reference's ``test_ws_log_streaming_with_search_gate`` flow
(``tests/test_api.py``) runs against the port's server: a ``tiny-test-lora``
job on the CPU, ``GET /api/v1/logs/{id}?search_string=trainer&follow=true``
opened right after the submit with ``aiohttp``'s client, read until the
server closes; the stream's payload lines, prefix removed, equal ``GET
/jobs/{id}/logs`` from the gate on.
"""

from __future__ import annotations

import asyncio
import json
import sys

import aiohttp
import pytest

from conftest import run_async as run
from finetune_controller_tpu.controller import schemas as ref_schemas
from finetune_controller_tpu.controller import stream_logger as ref_stream
from finetune_controller_tpu_torch.controller import schemas as port_schemas
from finetune_controller_tpu_torch.controller import stream_logger as port_stream
from finetune_controller_tpu_torch.controller.backends.base import BackendError as PortBackendError
from finetune_controller_tpu.controller.backends.base import BackendError as RefBackendError

PACKAGES = {
    "ref": (ref_stream, ref_schemas, RefBackendError),
    "port": (port_stream, port_schemas, PortBackendError),
}
LOG = [f"line {i} epoch {i // 50}" if i % 7 else f"line {i} trainer step {i}"
       for i in range(230)]


class _Ws:
    closed = False

    def __init__(self):
        self.sent: list[str] = []

    async def send_str(self, text: str) -> None:
        self.sent.append(text)


class _Job:
    def __init__(self, status, queue_position=None, trace="0123456789abcdef" * 2,
                 attempts=0):
        self.status = status
        self.queue_position = queue_position
        self.metadata = {"trace_id": trace, "attempt_history": [{}] * attempts}


class _State:
    """Answers ``get_job`` from a script of statuses (the last repeats)."""

    def __init__(self, schemas, script, **job_kw):
        self.script = [None if s is None else schemas.DatabaseStatus(s) for s in script]
        self.job_kw = job_kw
        self.calls = 0

    async def get_job(self, job_id):
        status = self.script[min(self.calls, len(self.script) - 1)]
        self.calls += 1
        return None if status is None else _Job(status, **self.job_kw)


class _Backend:
    def __init__(self, error_cls, lines, fail=False):
        self.error_cls = error_cls
        self.lines = lines
        self.fail = fail
        self.asked = None

    async def read_logs(self, job_id, follow=False, last_lines=None):
        self.asked = (follow, last_lines)
        if self.fail:
            raise self.error_cls(f"unknown job {job_id!r}")
        lines = self.lines[-last_lines:] if last_lines else self.lines

        async def gen():
            for line in lines:
                yield line

        return gen()


CASES = {
    "queued_then_starts": dict(script=["queued", "queued", "running"],
                               job_kw={"queue_position": 3}, follow=True),
    "terminal_job": dict(script=["succeeded"], follow=True),
    "search_gate": dict(script=["running"], follow=True, search_string="trainer step 14"),
    "gate_never_opens": dict(script=["failed"], follow=False, search_string="no such marker"),
    "last_lines": dict(script=["succeeded"], follow=False, last_lines=20),
    "start_timeout": dict(script=["queued"], follow=True, start_timeout_s=0.05,
                          start_poll_s=0.01),
    "unknown_job": dict(script=[None], follow=True),
    "logs_gone": dict(script=["succeeded"], follow=True, fail=True),
    "no_trace_id": dict(script=["running"], job_kw={"trace": ""}, follow=True),
}


def _frames(pkg: str, case: dict) -> tuple[list[str], tuple]:
    mod, schemas, error_cls = PACKAGES[pkg]
    ws = _Ws()
    backend = _Backend(error_cls, LOG, fail=case.get("fail", False))
    manager = mod.LogStreamManager(
        ws, "job-1", _State(schemas, case["script"], **case.get("job_kw", {})), backend,
        follow=case["follow"], last_lines=case.get("last_lines"),
        search_string=case.get("search_string", ""),
        start_timeout_s=case.get("start_timeout_s", 30.0),
        start_poll_s=case.get("start_poll_s", 0.0))
    run(asyncio.wait_for(manager.run(), 20))
    return ws.sent, backend.asked


@pytest.mark.parametrize("name", sorted(CASES))
def test_port_sends_the_reference_frames(name):
    ref, ref_asked = _frames("ref", CASES[name])
    port, port_asked = _frames("port", CASES[name])
    assert port == ref
    assert port_asked == ref_asked
    assert ref or name == "gate_never_opens"


def test_terminal_job_is_chunked_and_prefixed():
    frames, asked = _frames("port", CASES["terminal_job"])
    # a terminal job streams its history in 100-line chunks, never follows
    assert asked == (False, None)
    assert [len(f.split("\n")) for f in frames] == [100, 100, 30]
    assert frames[0].split("\n")[0] == "[01234567#a1] line 0 trainer step 0"


def test_ws_log_streaming_with_search_gate_through_the_port_server(tmp_path):
    """The reference's ``tests/test_api.py`` flow on the port's server."""
    from test_torch_api import SUBMIT, _runtime, _serve, _wait, http

    rt = _runtime("finetune_controller_tpu_torch", tmp_path, python=sys.executable,
                  device="cpu")
    served = _serve("finetune_controller_tpu_torch", rt)
    try:
        status, resp = http(served.base, "POST", "/jobs", fields={
            "model_name": SUBMIT["model_name"], "device": SUBMIT["device"],
            "arguments": json.dumps(SUBMIT["arguments"])})
        assert status == 200, resp
        job_id = resp["job_id"]
        url = (f"http://127.0.0.1:{served.port}/api/v1/logs/{job_id}"
               "?search_string=trainer&follow=true")

        async def follow() -> list[str]:
            collected = []
            async with aiohttp.ClientSession() as session:
                ws = await session.ws_connect(url)
                try:
                    while True:
                        msg = await ws.receive(timeout=120)
                        if msg.type.name in ("CLOSE", "CLOSED", "CLOSING", "ERROR"):
                            break
                        collected.append(msg.data)
                finally:
                    await ws.close()
            return collected

        collected = run(asyncio.wait_for(follow(), 150))
        text = "\n".join(collected)
        # the gate swallowed pre-marker lines; trainer logs flowed through
        assert "trainer" in text, text[:500]
        payload = [line for line in collected if not line.startswith("waiting:")]
        assert payload and "trainer" in payload[0]
        job = _wait(served.base, job_id, lambda j: j["status"] in (
            "succeeded", "failed", "cancelled"))
        assert job["status"] == "succeeded", job
        # payload lines are the REST log from the gate on, behind the prefix
        prefix = f"[{job['metadata']['trace_id'][:8]}#a1] "
        assert all(line.startswith(prefix) for line in payload)
        rest = http(served.base, "GET", f"/jobs/{job_id}/logs")[1]["lines"]
        gate = next(i for i, line in enumerate(rest) if "trainer" in line)
        assert [line[len(prefix):] for line in payload] == rest[gate:]
        # a WebSocket with no upgrade headers is a 400, sent as HTTP
        status, _ = http(served.base, "GET", f"/logs/{job_id}")
        assert status == 400
    finally:
        served.close()
