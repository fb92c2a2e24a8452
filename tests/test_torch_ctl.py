"""The port's ``ftc-ctl`` (``controller/ctl.py`` on ``urllib``) against the
port's server on a real socket: the two tests of ``tests/test_ctl.py``,
with a ``tiny-test-lora`` job that trains on the CPU (``device=cpu-test``)."""

from __future__ import annotations

import json
import sys
import zipfile

import pytest

from test_torch_api import _runtime, _serve

from finetune_controller_tpu_torch.controller import ctl

PKG = "finetune_controller_tpu_torch"


def _ctl(api: str, *argv: str) -> int:
    return ctl.run(ctl.build_parser().parse_args(["--api", api, *argv]))


@pytest.fixture
def served(tmp_path, monkeypatch):
    monkeypatch.setattr(ctl, "POLL_S", 0.2)
    rt = _runtime(PKG, tmp_path, python=sys.executable, device="cpu")
    served = _serve(PKG, rt)
    try:
        yield rt, served, f"http://127.0.0.1:{served.port}"
    finally:
        served.close()


def test_ctl_submit_watch_metrics_logs(served, tmp_path, capsys):
    _, _, api = served
    rc = _ctl(api, "submit", "tiny-test-lora",
              "--arg", "total_steps=2", "--arg", "batch_size=2",
              "--arg", "seq_len=16", "--arg", "lora_rank=2",
              "--arg", "warmup_steps=1",
              "--device", "cpu-test",
              "--task", "causal_lm",  # the optional task cross-check
              "--watch")
    assert rc == 0
    out = capsys.readouterr().out
    job_id = json.loads(out[: out.index("}\n") + 2])["job_id"]

    # an unknown --task is a 400 naming the known tasks
    with pytest.raises(ctl.ApiError, match="known tasks"):
        _ctl(api, "submit", "tiny-test-lora", "--task", "reinforcement")

    assert _ctl(api, "jobs") == 0
    jobs_out = capsys.readouterr().out
    assert job_id in jobs_out and "causal_lm" in jobs_out

    assert _ctl(api, "metrics", job_id) == 0
    rows = json.loads(capsys.readouterr().out)
    assert rows and "loss" in rows[-1]

    assert _ctl(api, "logs", job_id, "--follow") == 0
    assert "finished" in capsys.readouterr().out

    assert _ctl(api, "timeline", job_id) == 0
    tl = capsys.readouterr().out
    assert "trace=" in tl and "submitted" in tl
    assert "running" in tl and "succeeded" in tl
    assert "train-started" in tl  # the trainer's events were ingested

    assert _ctl(api, "artifacts", job_id) == 0
    inv = capsys.readouterr().out
    assert "metrics.csv" in inv and "done.txt" in inv
    zip_path = tmp_path / "artifacts.zip"
    assert _ctl(api, "artifacts", job_id, "-o", str(zip_path)) == 0
    with zipfile.ZipFile(zip_path) as zf:
        assert any("metrics" in n for n in zf.namelist())

    # an unknown job -> ApiError (main() maps it to exit 1)
    with pytest.raises(ctl.ApiError):
        _ctl(api, "status", "nope")
    assert ctl.main(["--api", api, "status", "nope"]) == 1


def test_ctl_queue_renders_tenant_table(served, capsys):
    """``ftc-ctl queue`` renders GET /admin/scheduler: per-queue usage, share
    and borrowed chips, plus pending positions."""
    from finetune_controller_tpu_torch.sched import FairShareScheduler

    rt, _, api = served
    sched = FairShareScheduler(rt.catalog, {"prod": 4.0, "batch": 1.0})
    sched.submit("q-run", "cpu-test", 2, queue="prod", priority="high")
    sched.try_admit()
    sched.submit("q-wait", "cpu-test", 1, queue="batch", priority="low")
    sched.try_admit()
    rt.backend.scheduler = sched

    assert _ctl(api, "queue") == 0
    out = capsys.readouterr().out
    assert "QUEUE" in out and "SHARE" in out and "BORROW" in out
    assert "prod" in out and "batch" in out
    assert "#1  q-wait  (batch)" in out
