"""The port trainer's profiler window (the reference's ``profile_steps`` /
``profile_start_step`` and the on-demand ``profile_request.json``).

A configured window opens a ``torch.profiler`` window over the steps the
reference's ``jax.profiler`` window covers (``train/trainer.py:1297-1392``
of the reference: from ``start + profile_start_step``, clamped into the run)
and writes a Chrome trace under ``profile/`` with a forced
``profile-captured`` event.  An on-demand request goes through the port's
server: ``POST /jobs/{id}/profile`` on a RUNNING job delivers
``profile_request.json`` and appends ``profile-requested``; the trainer
polls it at the reference's cadence, captures the steps asked for and
confirms with ``profile-captured``, which the monitor carries onto the
job's timeline.  The step numbers are exact (integer arithmetic).
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

import pytest
import torch

from finetune_controller_tpu_torch.data.synthetic import synthetic_batches
from finetune_controller_tpu_torch.models.llama import PRESETS
from finetune_controller_tpu_torch.models.lora import LoRAConfig
from finetune_controller_tpu_torch.obs.events import parse_event_lines
from finetune_controller_tpu_torch.train.trainer import (
    TrainConfig,
    Trainer,
    consume_profile_request,
)

from test_torch_api import _runtime, _serve, _wait, http

torch.set_num_threads(2)


def _fit(art: Path, **train_kw) -> list[dict]:
    cfg = PRESETS["tiny-test"].replace(lora=LoRAConfig(rank=2))
    tcfg = TrainConfig(batch_size=2, seq_len=16, warmup_steps=1, log_every=1,
                       checkpoint_every=100, prefetch=0, heartbeat_interval_s=0,
                       **train_kw)
    trainer = Trainer(cfg, tcfg, device="cpu")
    trainer.fit(synthetic_batches(2, 16, cfg.vocab_size), str(art))
    return parse_event_lines((art / "events.jsonl").read_bytes())


#: (profile_start_step, profile_steps, total_steps) -> the traced steps
#: [first, last), as the reference places its window
WINDOWS = {
    "from_start_step": ((1, 2, 5), (1, 3)),
    "start_past_the_run_clamps_to_the_first_step": ((10, 2, 5), (0, 2)),
    "end_clamped_to_the_run": ((3, 5, 5), (3, 5)),
}


@pytest.mark.parametrize("name", sorted(WINDOWS))
def test_configured_window_writes_a_trace_and_confirms(tmp_path, name):
    (start, steps, total), (first, last) = WINDOWS[name]
    events = _fit(tmp_path, profile_start_step=start, profile_steps=steps,
                  total_steps=total)
    traces = sorted((tmp_path / "profile").glob("*.json"))
    assert [t.name for t in traces] == [f"steps_{first}-{last}.pt.trace.json"]
    doc = json.loads(traces[0].read_text())
    assert doc["traceEvents"], "the trace holds no events"
    captured = [e["attrs"]["step"] for e in events if e["event"] == "profile-captured"]
    assert captured == [last]


def test_resumed_past_the_end_captures_nothing(tmp_path):
    _fit(tmp_path, total_steps=2)
    events = _fit(tmp_path, total_steps=2, profile_steps=2)
    assert not (tmp_path / "profile").exists()
    assert "profile-captured" not in [e["event"] for e in events]


def test_request_file_is_read_and_retired(tmp_path):
    path = tmp_path / "profile_request.json"
    path.write_text(json.dumps({"steps": 5000}))
    assert consume_profile_request(str(path)) == 1000
    assert not path.exists() and (tmp_path / "profile_request.json.consumed").exists()
    path.write_text("not json")
    assert consume_profile_request(str(path)) == 0
    assert not path.exists()


@pytest.mark.parametrize("poll_on", [True, False], ids=["poll", "FTC_PROFILE=0"])
def test_request_file_opens_a_window_unless_switched_off(tmp_path, monkeypatch, poll_on):
    if not poll_on:
        monkeypatch.setenv("FTC_PROFILE", "0")
    (tmp_path / "profile_request.json").write_text(json.dumps({"steps": 2}))
    events = _fit(tmp_path, total_steps=4)
    traces = [t.name for t in (tmp_path / "profile").glob("*.json")] \
        if (tmp_path / "profile").exists() else []
    captured = [e["attrs"]["step"] for e in events if e["event"] == "profile-captured"]
    if poll_on:
        assert traces == ["steps_0-2.pt.trace.json"] and captured == [2]
        assert not (tmp_path / "profile_request.json").exists()
    else:
        assert traces == [] and captured == []
        assert (tmp_path / "profile_request.json").exists()


@pytest.fixture(scope="module")
def on_demand(tmp_path_factory):
    """A long job on the port's server, profiled on demand while RUNNING."""
    tmp = tmp_path_factory.mktemp("on_demand")
    rt = _runtime("finetune_controller_tpu_torch", tmp, python=sys.executable, device="cpu")
    served = _serve("finetune_controller_tpu_torch", rt)
    out = {}
    try:
        status, resp = http(served.base, "POST", "/jobs", {
            "model_name": "tiny-test-lora", "device": "cpu-test",
            "arguments": {"total_steps": 3000, "batch_size": 2, "seq_len": 16,
                          "lora_rank": 2, "log_every": 1, "checkpoint_every": 1000}})
        assert status == 200, resp
        job_id = resp["job_id"]
        _wait(served.base, job_id, lambda j: j["status"] == "running", timeout=60)
        sandbox = rt.settings.state_path / "sandboxes" / job_id / "artifacts"
        deadline = time.time() + 60
        while not (sandbox / "metrics.csv").exists():  # the trainer is stepping
            assert time.time() < deadline
            time.sleep(0.1)
        out["request"] = http(served.base, "POST", f"/jobs/{job_id}/profile", {"steps": 2})
        out["job"] = _wait(served.base, job_id, lambda j: "profile-captured" in [
            e["event"] for e in j["events"]] or j["status"] != "running", timeout=60)
        deadline = time.time() + 30
        while True:  # the sidecar ships profile/ on its next sync
            listing = http(served.base, "GET", f"/jobs/{job_id}/artifacts?list=1")[1]
            out["profiles"] = [a["path"] for a in listing["artifacts"]
                               if a["path"].startswith("profile/")]
            if out["profiles"] or time.time() > deadline:
                break
            time.sleep(0.2)
        out["cancel"] = http(served.base, "POST", f"/jobs/{job_id}/cancel")
    finally:
        served.close()
    return out


def test_on_demand_request_is_accepted(on_demand):
    status, body = on_demand["request"]
    assert status == 202 and "2 steps" in body["message"]


def test_on_demand_window_is_captured_on_the_timeline(on_demand):
    job = on_demand["job"]
    assert job["status"] == "running", job["status"]
    events = [e["event"] for e in job["events"]]
    assert events.index("profile-requested") < events.index("profile-captured")
    captured = next(e for e in job["events"] if e["event"] == "profile-captured")
    requested = next(e for e in job["events"] if e["event"] == "profile-requested")
    assert requested["attrs"]["steps"] == 2 and captured["attrs"]["step"] >= 2


def test_on_demand_trace_ships_with_the_artifacts(on_demand):
    assert len(on_demand["profiles"]) == 1
    assert on_demand["profiles"][0].endswith(".pt.trace.json")
    assert on_demand["cancel"][0] == 200
