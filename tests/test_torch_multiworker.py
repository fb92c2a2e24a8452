"""The port's multi-process API (``server.py --workers N`` over
``SO_REUSEPORT``) on the k8s backend.

The k8s cases of ``tests/test_multiworker.py``, against the port's server:
``--workers 2`` is refused on the local backend (its job handles live in
one process) and on a store other than sqlite, and with ``FTC_BACKEND=k8s``
two processes share the port and answer ``/health``.  The backend's client
is built lazily, so a fake in-cluster env (an API server that is never
called) is enough.  Tolerance: exact (exit status, the refusal's words,
the health answers).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

import pytest

from test_multiworker import _children_of, _free_port

ROOT = Path(__file__).resolve().parents[1]
SERVER = "finetune_controller_tpu_torch.controller.server"


def _env(tmp_path, **extra) -> dict[str, str]:
    return {**os.environ, "FTC_STATE_DIR": str(tmp_path / "state"),
            "FTC_OBJECT_STORE_ROOT": str(tmp_path / "objects"), "FTC_ENVIRONMENT": "local",
            "FTC_DEVICE": "cpu", "PYTHONPATH": str(ROOT),
            "KUBERNETES_SERVICE_HOST": "127.0.0.1", "KUBERNETES_SERVICE_PORT": "1", **extra}


@pytest.mark.parametrize("backend,state,words", [
    ("local", "sqlite", "FTC_BACKEND=k8s"),
    ("k8s", "jsonl", "FTC_STATE_BACKEND=sqlite"),
])
def test_workers_refused(tmp_path, backend, state, words):
    out = subprocess.run(
        [sys.executable, "-m", SERVER, "--port", str(_free_port()), "--workers", "2"],
        env=_env(tmp_path, FTC_BACKEND=backend, FTC_STATE_BACKEND=state),
        capture_output=True, text=True, timeout=60)
    assert out.returncode != 0
    assert words in out.stderr


@pytest.mark.skipif(sys.platform != "linux", reason="SO_REUSEPORT fan-out")
def test_two_workers_share_the_port_on_k8s(tmp_path):
    port = _free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", SERVER, "--port", str(port), "--workers", "2"],
        env=_env(tmp_path, FTC_BACKEND="k8s", FTC_MONITOR_IN_PROCESS="false"),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        url = f"http://127.0.0.1:{port}/api/v1/health"
        deadline = time.time() + 60
        up = False
        while time.time() < deadline and not up:
            try:
                with urllib.request.urlopen(url, timeout=2) as r:
                    up = json.load(r)["status"] == "ok"
            except OSError:
                assert proc.poll() is None, proc.stdout.read()
                time.sleep(0.5)
        assert up, "service never came up"
        for _ in range(5):  # SO_REUSEPORT fan-out: the shared port keeps answering
            with urllib.request.urlopen(url, timeout=5) as r:
                assert json.load(r)["status"] == "ok"
            time.sleep(0.2)
        assert proc.poll() is None
        assert len(_children_of(proc.pid)) >= 1, "expected a forked worker child"
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=15)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
