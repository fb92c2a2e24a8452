"""The port's standalone monitor daemon (``controller/monitor_main.py``)
against the reference's.

Each daemon starts as a subprocess (``python -m ...controller.monitor_main``)
with ``FTC_MONITOR_METRICS_PORT`` set, its state in a shared state service
(the port's ``statestore_main``, ``state_backend=remote``) and a local
object store; ``/metrics`` is scraped, the daemon gets SIGTERM and must
exit 0 within 10 s.  The port's exposition carries
``ftc_build_info{process="monitor",...}`` and the same metric families as
the reference's, less the shard audit's counters, which the port reports
as not ported (ROADMAP Queue A item 9).  The record of a finished job in
the shared store is the same after the daemon ran its ticks.  Exact.
"""

from __future__ import annotations

import asyncio
import os
import re
import signal
import socket
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

from conftest import run_async as run

ROOT = Path(__file__).resolve().parents[1]
TOKEN = "tok"


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _get(url: str) -> tuple[int, str]:
    with urllib.request.urlopen(url, timeout=5) as resp:
        return resp.status, resp.read().decode()


def _until_up(url: str, proc: subprocess.Popen, timeout: float = 60) -> str:
    deadline = time.time() + timeout
    while True:
        try:
            return _get(url)[1]
        except OSError:
            pass
        assert proc.poll() is None, proc.stdout.read()
        assert time.time() < deadline, f"{url} never answered"
        time.sleep(0.1)


def _families(text: str) -> set[str]:
    return {line.split()[2] for line in text.splitlines() if line.startswith("# TYPE ")}


def test_monitor_daemons_serve_metrics_and_stop_on_sigterm(tmp_path):
    from finetune_controller_tpu_torch.controller.schemas import DatabaseStatus, JobRecord
    from finetune_controller_tpu_torch.controller.statestore_service import RemoteStateStore

    state_port = _free_port()
    env = dict(os.environ, PYTHONPATH=str(ROOT), JAX_PLATFORMS="cpu", FTC_STATE_TOKEN=TOKEN)
    service = subprocess.Popen(
        [sys.executable, "-m", "finetune_controller_tpu_torch.controller.statestore_main",
         "--state-dir", str(tmp_path / "service"), "--host", "127.0.0.1",
         "--port", str(state_port)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    daemons = {}
    try:
        _until_up(f"http://127.0.0.1:{state_port}/healthz", service)
        url = f"http://127.0.0.1:{state_port}"

        async def seed():
            client = RemoteStateStore(url, token=TOKEN)
            await client.create_job(JobRecord(job_id="done-1", user_id="u",
                                              model_name="tiny-test-lora", device="cpu-test"))
            await client.update_job_status("done-1", DatabaseStatus.SUCCEEDED, end_time=5.0)
            record = await client.get_job("done-1")
            await client.close()
            return record

        before = run(asyncio.wait_for(seed(), 30))
        for pkg in ("finetune_controller_tpu", "finetune_controller_tpu_torch"):
            port = _free_port()
            daemon_env = dict(
                env, FTC_STATE_BACKEND="remote", FTC_STATE_SERVICE_URL=url,
                FTC_STATE_SERVICE_TOKEN=TOKEN, FTC_STATE_DIR=str(tmp_path / pkg / "state"),
                FTC_OBJECT_STORE_ROOT=str(tmp_path / pkg / "objects"),
                FTC_MONITOR_METRICS_PORT=str(port), FTC_JOB_MONITOR_INTERVAL_S="0.2",
                FTC_DEVICE="cpu")
            proc = subprocess.Popen(
                [sys.executable, "-m", f"{pkg}.controller.monitor_main"], env=daemon_env,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            daemons[pkg] = (proc, f"http://127.0.0.1:{port}/metrics")
        scraped = {}
        for pkg, (proc, metrics_url) in daemons.items():
            _until_up(metrics_url, proc)
            time.sleep(0.5)  # a couple of 0.2 s ticks
            status, text = _get(metrics_url)
            assert status == 200
            scraped[pkg] = text
        for pkg, (proc, _) in daemons.items():
            proc.send_signal(signal.SIGTERM)
            assert proc.wait(timeout=10) == 0, proc.stdout.read()

        async def read_back():
            client = RemoteStateStore(url, token=TOKEN)
            record = await client.get_job("done-1")
            await client.close()
            return record

        after = run(asyncio.wait_for(read_back(), 30))
    finally:
        for proc, _ in daemons.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        service.terminate()
        assert service.wait(timeout=10) == 0
    port_text = scraped["finetune_controller_tpu_torch"]
    assert re.search(r'^ftc_build_info\{process="monitor",', port_text, re.M), port_text[:2000]
    assert re.search(r"^ftc_monitor_ticks_total [1-9]", port_text, re.M)
    ref_families = _families(scraped["finetune_controller_tpu"])
    assert _families(port_text) == ref_families - {"ftc_shard_audit_checks_total",
                                                   "ftc_shard_audit_violations_total"}
    assert after.model_dump(mode="json") == before.model_dump(mode="json")
