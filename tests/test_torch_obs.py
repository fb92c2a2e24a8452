"""The port's trainer observability, read by the reference's own readers.

A ``fit`` of ``tiny-test`` on the CPU writes ``heartbeat.json``,
``events.jsonl``, ``trace/trainer.jsonl`` and the ``phase_*_ms`` columns,
as the JAX trainer's ``fit`` does:

* the reference's ``parse_heartbeat`` and ``LeaseChecker`` read the
  heartbeat (a fresh lease holds, a stale one expires);
* ``parse_event_lines`` reads the events, whose names and steps equal the
  JAX ``fit``'s on the same run;
* ``parse_span_lines``, ``build_trace`` and ``validate_trace`` read the
  spans: ``fit`` with ``init``, ``restore`` and ``checkpoint`` children
  under the controller's attempt span, no problems;
* ``FTC_TRACE=0`` (and ``trace: false``) writes no events, spans or phase
  columns, and still beats;
* ``PhaseClock``, ``HeartbeatWriter`` and ``make_event`` equal the
  reference's on the same clock ticks.
"""

from __future__ import annotations

import asyncio
import csv
import json
import os
import types

import pytest
import torch

from finetune_controller_tpu.obs import events as jax_events
from finetune_controller_tpu.obs import phase as jax_phase
from finetune_controller_tpu.obs import trace as jax_trace
from finetune_controller_tpu.resilience import heartbeat as jax_heartbeat
from finetune_controller_tpu.train import cli as jax_cli
from finetune_controller_tpu_torch.obs import events, phase, trace
from finetune_controller_tpu_torch.resilience import heartbeat
from finetune_controller_tpu_torch.train import cli

torch.set_num_threads(1)

TRACE_ID = "0123456789abcdef0123456789abcdef"


def _spec(art, total_steps: int = 4, **training) -> dict:
    return {"job_id": "obs", "model": {"preset": "tiny-test", "lora": {"rank": 2},
                                       "overrides": {"dtype": "float32"}},
            "training": {"total_steps": total_steps, "batch_size": 2, "seq_len": 16,
                         "log_every": 1, "checkpoint_every": 2, "warmup_steps": 1,
                         "heartbeat_interval_s": 0.0001, **training},
            "dataset": {"synthetic": {"task": "increment"}}, "artifacts_dir": str(art)}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The port's CLI: 4 steps, then resumed to 6, under a controller's
    trace id and attempt."""
    art = tmp_path_factory.mktemp("obs")
    env = {"FTC_TRACE_ID": TRACE_ID, "FTC_ATTEMPT": "1"}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        cli.run_job(_spec(art, 4), "cpu")
        os.environ["FTC_ATTEMPT"] = "2"
        cli.run_job(_spec(art, 6), "cpu")
    finally:
        for k, v in saved.items():
            os.environ.pop(k) if v is None else os.environ.__setitem__(k, v)
    return art


class _Store:
    """The object-store calls ``LeaseChecker`` makes, over a local dir."""

    async def exists(self, uri):
        return os.path.exists(uri)

    async def get_bytes(self, uri):
        with open(uri, "rb") as f:
            return f.read()


def test_reference_readers_parse_the_heartbeat(run):
    doc = jax_heartbeat.parse_heartbeat((run / "heartbeat.json").read_bytes())
    assert doc["step"] == doc["last_step"] == 6 and doc["last_step_ms"] > 0
    job = types.SimpleNamespace(artifacts_uri=str(run), job_id="obs", start_time=0.0)
    report = types.SimpleNamespace(start_time=0.0)
    fresh = jax_heartbeat.LeaseChecker(_Store(), lease_s=300.0)
    stale = jax_heartbeat.LeaseChecker(_Store(), lease_s=300.0,
                                       _clock=lambda: doc["ts"] + 301.0)
    assert asyncio.run(fresh.expired(job, report)) is False
    assert asyncio.run(stale.expired(job, report)) is True
    assert stale.last_heartbeat["last_step"] == 6
    assert heartbeat.read_heartbeat_file(str(run / "heartbeat.json")) == doc


def test_event_names_equal_the_jax_fit_on_the_same_run(run, tmp_path):
    got = jax_events.parse_event_lines((run / "events.jsonl").read_bytes())
    assert [(e["event"], e["attrs"]["step"], e["attrs"]["attempt"], e["trace_id"])
            for e in got] == [
        ("train-started", 0, 1, TRACE_ID), ("checkpoint-committed", 2, 1, TRACE_ID),
        ("checkpoint-committed", 4, 1, TRACE_ID), ("train-finished", 4, 1, TRACE_ID),
        ("train-started", 4, 2, TRACE_ID), ("checkpoint-committed", 6, 2, TRACE_ID),
        ("train-finished", 6, 2, TRACE_ID)]
    assert got[4]["attrs"]["resumed_from"] == 4
    # the JAX trainer's fit on the same spec (its first run)
    spec = _spec(tmp_path / "jax", 4)
    spec["mesh"] = {"dp": 1, "fsdp": 1}
    jax_cli.run_job(spec)
    want = jax_events.parse_event_lines((tmp_path / "jax" / "events.jsonl").read_bytes())
    assert [(e["event"], e["attrs"]["step"]) for e in want] == \
        [(e["event"], e["attrs"]["step"]) for e in got[:4]]
    assert events.parse_event_lines((run / "events.jsonl").read_bytes()) == got


def test_reference_trace_assembly_validates_the_spans(run):
    spans = jax_trace.parse_span_lines((run / "trace" / "trainer.jsonl").read_bytes())
    assert trace.parse_span_lines((run / "trace" / "trainer.jsonl").read_bytes()) == spans
    names = [(s["name"], s["attributes"].get("attempt")) for s in spans]
    for name in ("fit", "init", "checkpoint"):
        assert (name, 1) in names and (name, 2) in names
    assert ("restore", 2) in names and ("restore", 1) not in names
    assert {s["trace_id"] for s in spans} == {TRACE_ID}
    fits = {s["attributes"]["attempt"]: s["span_id"] for s in spans if s["name"] == "fit"}
    assert all(s["parent_span_id"] == fits[s["attributes"]["attempt"]]
               for s in spans if s["name"] != "fit")
    # the controller's timeline around the two attempts
    evts = jax_events.parse_event_lines((run / "events.jsonl").read_bytes())
    first = min(s["start_ns"] for s in spans) / 1e9
    mid = max(s["end_ns"] for s in spans if s["attributes"]["attempt"] == 1) / 1e9
    second = min(s["start_ns"] for s in spans if s["attributes"]["attempt"] == 2) / 1e9
    last = max(s["end_ns"] for s in spans) / 1e9
    timeline = sorted([
        jax_events.make_event("submitted", ts=first - 2.0),
        jax_events.make_event("running", ts=first - 1.0, attempt=1),
        jax_events.make_event("retrying", ts=(mid + second) / 2),
        jax_events.make_event("running", ts=(mid + second) / 2 + 1e-4, attempt=2),
        jax_events.make_event("succeeded", ts=last + 1.0),
    ] + evts, key=lambda e: e["ts"])
    job = {"job_id": "obs", "status": "succeeded", "metadata": {"trace_id": TRACE_ID},
           "submitted_at": first - 2.0, "end_time": last + 1.0, "events": timeline}
    built = jax_trace.build_trace(job, spans)
    assert built["problems"] == []
    assert jax_trace.validate_trace(built["spans"], timeline) == []
    attempts = {s["span_id"]: s["name"] for s in built["spans"]
                if s["name"].startswith("attempt-")}
    grafted = [s for s in built["spans"] if s["name"] == "fit"]
    assert sorted(attempts[s["parent_span_id"]] for s in grafted) == ["attempt-1",
                                                                      "attempt-2"]


def test_phase_columns_ride_every_row(run):
    with open(run / "metrics.csv") as f:
        rows = list(csv.DictReader(f))
    assert [r["step"] for r in rows] == [str(i) for i in range(1, 7)]
    for col in jax_phase.PhaseClock.columns():
        assert all(float(r[col]) >= 0 for r in rows), col
    assert any(float(r["phase_checkpoint_ms"]) > 0 for r in rows)


@pytest.mark.parametrize("switch", ["FTC_TRACE=0", "trace: false"])
def test_tracing_kill_switch(tmp_path, monkeypatch, switch):
    if switch == "FTC_TRACE=0":
        monkeypatch.setenv("FTC_TRACE", "0")
        cli.run_job(_spec(tmp_path, 2), "cpu")
    else:
        cli.run_job(_spec(tmp_path, 2, trace=False), "cpu")
    assert not (tmp_path / "events.jsonl").exists()
    assert not (tmp_path / "trace").exists()
    with open(tmp_path / "metrics.csv") as f:
        header = f.readline()
    assert "phase_" not in header
    assert json.loads((tmp_path / "heartbeat.json").read_text())["step"] == 2


def test_spans_without_a_controller_trace_id_carry_their_own(tmp_path, monkeypatch):
    monkeypatch.delenv("FTC_TRACE_ID", raising=False)
    cli.run_job(_spec(tmp_path, 2), "cpu")
    spans = jax_trace.parse_span_lines((tmp_path / "trace" / "trainer.jsonl").read_bytes())
    ids = {s["trace_id"] for s in spans}
    assert len(ids) == 1 and len(ids.pop()) == 32
    assert "trace_id" not in jax_events.parse_event_lines(
        (tmp_path / "events.jsonl").read_bytes())[0]


class _Ticks:
    """A clock that returns the given readings in turn."""

    def __init__(self, readings):
        self.readings = list(readings)

    def __call__(self):
        return self.readings.pop(0)


def test_phase_clock_equals_the_reference_on_the_same_ticks():
    ticks = [0.0, 0.25, 1.0, 1.5, 2.0, 2.125]
    ours, ref = phase.PhaseClock(_clock=_Ticks(ticks)), jax_phase.PhaseClock(_clock=_Ticks(ticks))
    for clock in (ours, ref):
        clock.add("input", 0.004)
        with clock.phase("checkpoint"):
            pass
        with clock.phase("eval"):
            pass
        clock.add("sync", 0.001)
        with clock.phase("input"):
            pass
    assert ours.window_row(steps=3, wall_s=2.5) == ref.window_row(steps=3, wall_s=2.5)
    assert ours.window_row(steps=0, wall_s=0.0) == ref.window_row(steps=0, wall_s=0.0)
    assert phase.PhaseClock.columns() == jax_phase.PhaseClock.columns()


def test_heartbeat_and_event_copies_equal_the_reference(tmp_path):
    for name in ("TRAIN_STARTED", "CHECKPOINT_COMMITTED", "PREEMPT_EXIT", "TRAIN_FINISHED",
                 "PROFILE_CAPTURED", "EVENTS_FILENAME"):
        assert getattr(events, name) == getattr(jax_events, name)
    assert events.make_event("x", ts=1.5, key="k", a=1, b=None) == \
        jax_events.make_event("x", ts=1.5, key="k", a=1, b=None)
    raw = b'{"event": "a", "ts": 1}\nnot json\n{"ts": 2}\n\n{"event": "b"}\n'
    assert events.parse_event_lines(raw) == jax_events.parse_event_lines(raw)
    docs = []
    for module, sub in ((heartbeat, "port"), (jax_heartbeat, "jax")):
        (tmp_path / sub).mkdir()
        writer = module.HeartbeatWriter(str(tmp_path / sub), interval_s=10.0,
                                        _clock=_Ticks([100.0, 100.0, 105.0, 111.0]))
        wrote = [writer.beat(1, step_ms=12.3456), writer.beat(2), writer.beat(3)]
        docs.append((wrote, json.loads((tmp_path / sub / "heartbeat.json").read_text())))
    assert docs[0] == docs[1]
    for raw in (b"{}", b"torn", b'{"ts": 3, "step": 1}'):
        assert heartbeat.parse_heartbeat(raw) == jax_heartbeat.parse_heartbeat(raw)
