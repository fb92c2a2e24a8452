"""The port's HTTP control plane against the reference's, over real sockets.

Two servers run side by side, each on its own event-loop thread: the
reference app (``finetune_controller_tpu.controller.server`` on aiohttp)
and the port's (``finetune_controller_tpu_torch.controller.server`` on the
stdlib ``controller/web.py``), both with auth on, the default device
catalog and a local backend whose trainer command is a stub that sleeps
(a job stays RUNNING until cancelled).  One ``urllib`` client sends both
the same request sequence — health, models and schemas, dev tokens,
entitlements, the submit validation errors of ``tests/test_api.py``,
cancel/promote/profile guards, ownership isolation and the 429 rate limit
— and each response's status and body must be equal (exact; ids,
timestamps, tokens, the device catalog and model descriptions masked,
since the port names the H100 card where the reference names TPU slices).

Then one ``tiny-test-lora`` job runs the port's whole path on the CPU
(``device="cpu"``): a multipart submission with a dataset file as in the
Quickstart, SUCCEEDED, ``/metrics`` with the reference trainer's column set
and finite losses, ``/trace`` with no problems, promotion, and
``/generate`` unpaged and paged (the same greedy tokens).  The spec the
port's backend writes for it equals the reference backend's for the same
submission apart from paths; the reference's trainer CLI runs that spec
to give the column set.  Random initialisation through the API differs
between the two packages, so no losses are compared here (the trainer's
numbers are held against the JAX trainer in ``tests/test_torch_train.py``).
A ``tiny-dpo-test`` job (the DPO trainer of ``prefs/``) runs beside it:
SUCCEEDED, the ``ftc_dpo_*`` gauges on ``/metrics`` while it runs, promoted
and answering ``/generate``.  A ``tiny-rlhf-test`` job with
``rollout_workers: 1`` (the disaggregated rollout plane, refused before it
was ported) trains with a rollout worker process beside its trainer and
SUCCEEDS at its first attempt, the worker reaped.
"""

from __future__ import annotations

import asyncio
import json
import math
import os
import re
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]

SUBMIT = {"model_name": "tiny-test-lora", "device": "cpu-test",
          "arguments": {"total_steps": 4, "warmup_steps": 1, "batch_size": 2,
                        "seq_len": 16, "lora_rank": 2, "log_every": 1,
                        "checkpoint_every": 2}}
DATASET = b'{"text": "the quick brown fox jumps over the lazy dog"}\n' * 8
#: fields whose values are wall-clock times or per-run secrets
TIME_KEYS = {"ts", "submitted_at", "start_time", "end_time", "training_duration",
             "created_at", "updated_at", "archived_at", "access_token", "retry_next_at",
             "trace_id", "duration"}
#: fields that name the device catalog, which differs by design
DEVICE_KEYS = {"devices", "default_device", "description"}


class _Served:
    """An application served on its own event-loop thread."""

    def __init__(self, app, web_mod):
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever, daemon=True)
        self.thread.start()
        self.runner = web_mod.AppRunner(app)
        self.call(self.runner.setup())
        site = web_mod.TCPSite(self.runner, "127.0.0.1", 0)
        self.call(site.start())
        sock = (site._server.sockets[0] if getattr(site, "_server", None) is not None
                else None)
        self.port = sock.getsockname()[1]
        self.base = f"http://127.0.0.1:{self.port}/api/v1"

    def call(self, coro, timeout=120):
        return asyncio.run_coroutine_threadsafe(coro, self.loop).result(timeout)

    def close(self):
        try:
            self.call(self.runner.cleanup())
        finally:
            self.loop.call_soon_threadsafe(self.loop.stop)
            self.thread.join(10)
            self.loop.close()


def http(base, method, path, body=None, token=None, *, fields=None, files=None):
    headers = {"Authorization": f"Bearer {token}"} if token else {}
    data = None
    if fields is not None:
        boundary = "testboundary7d1"
        parts = [f'--{boundary}\r\nContent-Disposition: form-data; name="{k}"\r\n\r\n'
                 f'{v}\r\n'.encode() for k, v in fields.items()]
        for name, (filename, payload) in (files or {}).items():
            parts.append(f'--{boundary}\r\nContent-Disposition: form-data; name="{name}"; '
                         f'filename="{filename}"\r\nContent-Type: application/jsonl\r\n\r\n'
                         .encode() + payload + b"\r\n")
        data = b"".join(parts) + f"--{boundary}--\r\n".encode()
        headers["Content-Type"] = f"multipart/form-data; boundary={boundary}"
    elif body is not None:
        data = json.dumps(body).encode()
        headers["Content-Type"] = "application/json"
    req = urllib.request.Request(base + path, data=data, method=method, headers=headers)
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            status, raw = resp.status, resp.read()
    except urllib.error.HTTPError as e:
        status, raw = e.code, e.read()
    try:
        return status, json.loads(raw)
    except ValueError:
        return status, raw.decode(errors="replace")


def normalize(body):
    """Mask what legitimately differs between two runs and two catalogs."""
    text = json.dumps(body, sort_keys=True)
    text = re.sub(r"tiny-test-lora-[0-9a-f]{8}", "<job>", text)
    text = re.sub(r"available: \[[^\]]*\]", "available: <devices>", text)

    def walk(x):
        if isinstance(x, dict):
            return {k: ("<masked>" if k in TIME_KEYS and v is not None else walk(v))
                    for k, v in x.items() if k not in DEVICE_KEYS}
        if isinstance(x, list):
            return [walk(v) for v in x]
        return x

    return walk(json.loads(text))


def _settings_kwargs(tmp: Path, **kw):
    return dict(state_dir=str(tmp / "state"), object_store_root=str(tmp / "objects"),
                job_monitor_interval_s=0.1, artifact_sync_interval_s=0.2,
                rate_limit_submit_per_min=20, rate_limit_read_per_min=1000,
                rate_limit_promote_per_min=1000, **kw)


def _runtime(pkg: str, tmp: Path, *, python: str, **kw):
    """A runtime of ``pkg`` (the reference or the port) on the default catalog."""
    import importlib

    mod = lambda name: importlib.import_module(f"{pkg}.controller.{name}")  # noqa: E731
    registry = mod("registry")
    registry.reset()
    registry.load_builtin_models()
    settings = mod("config").Settings(**_settings_kwargs(tmp, **kw))
    state = mod("statestore").StateStore(settings.state_path)
    store = mod("objectstore").LocalObjectStore(settings.object_store_path)
    catalog = mod("devices").default_catalog()
    backend = importlib.import_module(f"{pkg}.controller.backends.local").LocalProcessBackend(
        settings.state_path / "sandboxes", store, catalog, sync_interval_s=0.2,
        python=python)
    supervisor = importlib.import_module(f"{pkg}.resilience.supervisor").RetrySupervisor(
        state, backend, catalog)
    monitor = mod("monitor").JobMonitor(state, store, backend, interval_s=0.1,
                                        supervisor=supervisor)
    return mod("runtime").Runtime(
        settings=settings, state=state, store=store, catalog=catalog, backend=backend,
        monitor=monitor, presigner=mod("objectstore").Presigner(settings.presign_secret))


def _serve(pkg: str, rt):
    import importlib

    server = importlib.import_module(f"{pkg}.controller.server")
    if pkg == "finetune_controller_tpu":
        from aiohttp import web as web_mod
    else:
        web_mod = importlib.import_module(f"{pkg}.controller.web")
    return _Served(server.build_app(rt), web_mod)


def _tokens(pkg: str, secret: str) -> dict[str, str]:
    import importlib

    mint = importlib.import_module(f"{pkg}.controller.security").dev_generate_token
    return {"alice": mint("alice", secret), "bob": mint("bob", secret),
            "carol": mint("carol", secret), "admin": mint("root", secret, is_admin=True),
            "scoped": mint("dan", secret, scopes=["llama3-8b-lora"]), "garbage": "garbage"}


def _bad(**kw):
    return {**SUBMIT, **kw}


#: (user, method, path, body): ``{A}`` is the job the sequence submits
SEQUENCE = [
    (None, "GET", "/health", None),
    (None, "GET", "/jobs", None),
    ("garbage", "GET", "/jobs", None),
    (None, "POST", "/auth/dev-token", {"user_id": "eve"}),
    ("alice", "GET", "/models", None),
    ("alice", "GET", "/models/tiny-test-lora/schema", None),
    ("alice", "GET", "/models/llama3-8b-lora/schema", None),
    ("alice", "GET", "/models/nope/schema", None),
    ("scoped", "GET", "/models", None),
    ("scoped", "POST", "/jobs", SUBMIT),
    ("alice", "POST", "/jobs", {}),
    ("alice", "POST", "/jobs", {"model_name": "ghost"}),
    ("alice", "POST", "/jobs", _bad(arguments={"learning_rate": -5})),
    ("alice", "POST", "/jobs", _bad(arguments={"nonsense_knob": 1})),
    ("alice", "POST", "/jobs", _bad(device="nope-1")),
    ("alice", "POST", "/jobs", _bad(task="classification")),
    ("alice", "POST", "/jobs", _bad(task="reinforcement")),
    ("alice", "POST", "/jobs", {"model_name": "tiny-test-lora",
                                "training_arguments": SUBMIT["arguments"]}),
    ("alice", "POST", "/jobs", _bad(priority="urgent")),
    ("alice", "POST", "/jobs", _bad(num_slices=99)),
    ("alice", "POST", "/jobs", _bad(queue="prod", priority="high")),  # submits {A}
    ("alice", "GET", "/jobs/{A}", None),
    ("alice", "GET", "/jobs?status=bogus", None),
    ("alice", "POST", "/jobs/{A}/promote", None),
    ("alice", "POST", "/jobs/{A}/unpromote", None),
    ("alice", "POST", "/jobs/{A}/profile", {"steps": 0}),
    ("bob", "GET", "/jobs/{A}", None),
    ("bob", "POST", "/jobs/{A}/cancel", None),
    ("bob", "POST", "/jobs/{A}/promote", None),
    ("bob", "GET", "/jobs/{A}/metrics", None),
    ("bob", "GET", "/jobs", None),
    ("alice", "GET", "/admin/scheduler", None),
    ("admin", "GET", "/admin/jobs", None),
    ("alice", "POST", "/jobs/{A}/cancel", None),
    ("alice", "POST", "/jobs/{A}/cancel", None),
    ("alice", "POST", "/jobs/{A}/promote", None),
    ("alice", "POST", "/jobs/{A}/profile", None),
    ("alice", "DELETE", "/jobs/{A}", None),
    ("alice", "GET", "/jobs/{A}", None),
    ("alice", "GET", "/jobs/nope-00000000/timeline", None),
    ("alice", "GET", "/datasets", None),
    ("alice", "GET", "/datasets/nope", None),
] + [("carol", "POST", "/jobs", {"model_name": "ghost"})] * 21


def _run_sequence(served, tokens):
    out, job = [], None
    for user, method, path, body in SEQUENCE:
        if "{A}" in path:
            path = path.replace("{A}", job)
        status, resp = http(served.base, method, path, body, tokens.get(user))
        if method == "POST" and path == "/jobs" and status == 200:
            job = resp["job_id"]
            deadline = time.time() + 30  # until the stub trainer runs
            while http(served.base, "GET", f"/jobs/{job}", None,
                       tokens["alice"])[1]["status"] != "running":
                assert time.time() < deadline
                time.sleep(0.05)
            # the monitor writes the status, then the tick's event and
            # metadata: let a few ticks (0.1 s each) settle the document
            time.sleep(0.5)
        out.append((status, normalize(resp)))
    return out, job


@pytest.fixture(scope="module")
def parity(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("parity")
    stub = tmp / "stub_trainer.sh"
    stub.write_text("#!/bin/sh\nexec sleep 60\n")
    stub.chmod(0o755)
    results, specs = {}, {}
    for pkg in ("finetune_controller_tpu", "finetune_controller_tpu_torch"):
        rt = _runtime(pkg, tmp / pkg, python=str(stub), auth_enabled=True)
        served = _serve(pkg, rt)
        try:
            tokens = _tokens(pkg, rt.settings.jwt_secret)
            results[pkg], _ = _run_sequence(served, tokens)
            # the trainer spec each backend writes for the lifecycle submission
            status, resp = http(served.base, "POST", "/jobs", None, tokens["admin"],
                                fields={"model_name": SUBMIT["model_name"],
                                        "device": SUBMIT["device"],
                                        "arguments": json.dumps(SUBMIT["arguments"])},
                                files={"dataset_file": ("train.jsonl", DATASET)})
            assert status == 200, resp
            sandbox = rt.settings.state_path / "sandboxes" / resp["job_id"]
            specs[pkg] = json.loads((sandbox / "job.json").read_text())
            http(served.base, "POST", f"/jobs/{resp['job_id']}/cancel", None, tokens["admin"])
        finally:
            served.close()
    return results, specs


@pytest.mark.parametrize("i", range(len(SEQUENCE)),
                         ids=[f"{i:02d}-{u}-{m}-{p}" for i, (u, m, p, _) in enumerate(SEQUENCE)])
def test_port_answers_as_the_reference(parity, i):
    ref, port = parity[0]["finetune_controller_tpu"][i], \
        parity[0]["finetune_controller_tpu_torch"][i]
    assert port == ref


def test_rate_limit_answers_429_after_the_limit(parity):
    statuses = [s for s, _ in parity[0]["finetune_controller_tpu_torch"][-21:]]
    assert statuses == [404] * 20 + [429]


def _spec_for_comparison(spec: dict) -> dict:
    spec = json.loads(json.dumps(spec))
    spec["job_id"] = "<job>"
    spec["artifacts_dir"] = "<artifacts>"
    spec["dataset"]["path"] = Path(spec["dataset"]["path"]).name
    return spec


def test_backends_write_the_reference_trainer_spec(parity):
    specs = parity[1]
    assert _spec_for_comparison(specs["finetune_controller_tpu_torch"]) == \
        _spec_for_comparison(specs["finetune_controller_tpu"])


# ---------------------------------------------------------------------------
# One job through the port's whole path on the CPU
# ---------------------------------------------------------------------------


def _wait(base, job_id, pred, timeout=120.0):
    deadline = time.time() + timeout
    while True:
        status, job = http(base, "GET", f"/jobs/{job_id}")
        assert status == 200, job
        if pred(job):
            return job
        assert time.time() < deadline, job
        time.sleep(0.1)


def _reference_columns(spec: dict, tmp: Path) -> subprocess.Popen:
    """The reference trainer CLI on the reference backend's spec (3 steps),
    in the background: its metrics.csv header is the reference column set."""
    spec = json.loads(json.dumps(spec))
    spec["artifacts_dir"] = str(tmp / "ref_artifacts")
    (tmp / "ref_job.json").write_text(json.dumps(spec))
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT),
               XLA_FLAGS="--xla_force_host_platform_device_count=1",
               JAX_COMPILATION_CACHE_DIR=str(ROOT / ".cache" / "xla"))
    return subprocess.Popen(
        [sys.executable, "-m", "finetune_controller_tpu.train.cli", "--spec",
         str(tmp / "ref_job.json")], cwd=tmp, env=env,
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)


@pytest.fixture(scope="module")
def lifecycle(parity, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("lifecycle")
    ref_proc = _reference_columns(parity[1]["finetune_controller_tpu"], tmp)
    rt = _runtime("finetune_controller_tpu_torch", tmp, python=sys.executable,
                  device="cpu", serve_prompt_buckets=[8, 16], serve_max_new_tokens=8,
                  serve_slots=2)
    served = _serve("finetune_controller_tpu_torch", rt)
    out = {"rt": rt}
    try:
        status, resp = http(served.base, "POST", "/jobs", fields={
            "model_name": SUBMIT["model_name"], "device": SUBMIT["device"],
            "arguments": json.dumps(SUBMIT["arguments"])},
            files={"dataset_file": ("train.jsonl", DATASET)})
        assert status == 200, resp
        job_id = out["job_id"] = resp["job_id"]
        status, dpo = http(served.base, "POST", "/jobs", {
            "model_name": "tiny-dpo-test", "arguments": {
                "total_steps": 20, "warmup_steps": 1, "batch_size": 2, "seq_len": 16,
                "lora_rank": 2, "log_every": 1, "beta": 0.2, "learning_rate": 0.005}})
        assert status == 200, dpo
        status, refused = http(served.base, "POST", "/jobs", {
            "model_name": "tiny-rlhf-test", "num_slices": 1, "arguments": {
                "total_steps": 2, "batch_size": 2, "seq_len": 16, "lora_rank": 2,
                "rollout_workers": 1}})
        assert status == 200, refused
        # the preference gauges exist while the job is active: scrape until
        # they carry its synced row or it has finished
        root = f"http://127.0.0.1:{served.port}"
        out["dpo_gauges"] = ""
        while "ftc_dpo_reward_margin{" not in out["dpo_gauges"]:
            job = http(served.base, "GET", f"/jobs/{dpo['job_id']}")[1]
            if job["status"] in ("succeeded", "failed", "cancelled"):
                break
            out["dpo_gauges"] = http(root, "GET", "/metrics")[1]
            time.sleep(0.05)
        out["job"] = _wait(served.base, job_id, lambda j: j["status"] in (
            "succeeded", "failed", "cancelled"))
        out["logs"] = http(served.base, "GET", f"/jobs/{job_id}/logs")
        out["metrics"] = http(served.base, "GET", f"/jobs/{job_id}/metrics")
        out["trace"] = http(served.base, "GET", f"/jobs/{job_id}/trace")
        out["promote"] = http(served.base, "POST", f"/jobs/{job_id}/promote")
        out["promoted"] = _wait(served.base, job_id,
                                lambda j: j["promotion_status"] in ("completed", "failed"))
        req = {"tokens": [1, 2, 3, 4, 5], "max_new_tokens": 6}
        out["unpaged"] = http(served.base, "POST", f"/jobs/{job_id}/generate", req)
        out["unload"] = http(served.base, "POST", f"/admin/serve/{job_id}/unload")
        rt.settings.serve_paged_kv = True  # the next load builds paged engines
        out["paged"] = http(served.base, "POST", f"/jobs/{job_id}/generate", req)
        out["paged_stats"] = http(served.base, "GET", "/admin/serve")
        out["dpo"] = _wait(served.base, dpo["job_id"],
                           lambda j: j["status"] in ("succeeded", "failed", "cancelled"))
        out["dpo_metrics"] = http(served.base, "GET", f"/jobs/{dpo['job_id']}/metrics")
        out["dpo_promote"] = http(served.base, "POST", f"/jobs/{dpo['job_id']}/promote")
        _wait(served.base, dpo["job_id"],
              lambda j: j["promotion_status"] in ("completed", "failed"))
        out["dpo_generate"] = http(served.base, "POST", f"/jobs/{dpo['job_id']}/generate", req)
        # FTC_DEVICE=cuda (the default) on a host without a card: the load
        # raises, it does not fall back to the CPU
        http(served.base, "POST", f"/admin/serve/{job_id}/unload")
        rt.settings.device = "cuda"
        out["cuda_load"] = http(served.base, "POST", f"/admin/serve/{job_id}/load")
        out["refused"] = _wait(served.base, refused["job_id"],
                               lambda j: j["status"] in ("succeeded", "failed", "cancelled"))
        out["refused_logs"] = http(served.base, "GET", f"/jobs/{refused['job_id']}/logs")
        out["refused_timeline"] = http(served.base, "GET",
                                       f"/jobs/{refused['job_id']}/timeline")
        assert ref_proc.wait(timeout=120) == 0
        ref_csv = (tmp / "ref_artifacts" / "metrics.csv").read_text().splitlines()
        out["ref_columns"] = ref_csv[0].split(",")
    finally:
        if ref_proc.poll() is None:
            ref_proc.kill()
            ref_proc.wait()
        served.close()
    return out


def test_lifecycle_job_succeeds(lifecycle):
    job = lifecycle["job"]
    assert job["status"] == "succeeded", job
    status, logs = lifecycle["logs"]
    assert status == 200 and any("finished" in line for line in logs["lines"])


def test_metrics_carry_the_reference_columns_and_finite_losses(lifecycle):
    status, body = lifecycle["metrics"]
    assert status == 200 and body["csv_url"]
    records = body["records"]
    assert [r["step"] for r in records] == [4, 3, 2, 1]
    assert all(math.isfinite(r["loss"]) for r in records)
    assert set(records[0]) == set(lifecycle["ref_columns"])


def test_trace_has_no_problems(lifecycle):
    status, trace = lifecycle["trace"]
    assert status == 200 and trace["problems"] == [] and trace["spans"]


def test_promotion_completes(lifecycle):
    assert lifecycle["promote"][0] == 202
    assert lifecycle["promoted"]["promotion_status"] == "completed"


def test_generate_unpaged_and_paged_give_the_same_tokens(lifecycle):
    (s1, unpaged), (s2, paged) = lifecycle["unpaged"], lifecycle["paged"]
    assert s1 == 200 and s2 == 200, (unpaged, paged)
    assert lifecycle["unload"][0] == 200
    assert len(unpaged["tokens"]) == 6 and unpaged["tokens"] == paged["tokens"]
    assert paged["model"]["checkpoint_step"] == 4 and paged["model"]["lora_merged"]
    stats = lifecycle["paged_stats"][1]["sessions"][lifecycle["job_id"]]
    # the engine's compile-count contract (serve/engine.py): two signatures,
    # the paged prefill at bucket 8 and the decode step — the warm-up's
    # 16-token prompt of ones hits the prefix cache on its 8-token one, so
    # its suffix prefill runs at bucket 8 too; the budget is 2 + 1
    assert stats["kv_pages_total"] > 0 and stats["compilations"] == 2


def test_refused_spec_fails_in_its_trainer_and_is_not_retried(lifecycle):
    """The spec this test held as refused (``rollout_workers: 1``) now runs:
    the trainer spawns its rollout worker, succeeds at its first attempt,
    and reaps the worker."""
    job = lifecycle["refused"]
    assert job["status"] == "succeeded", job
    lines = "\n".join(lifecycle["refused_logs"][1]["lines"])
    assert "NotImplementedError" not in lines
    spawned = re.search(r"serve worker rollout-0 spawned \(.*pid=(\d+)", lines)
    assert spawned, lines[-2000:]
    with pytest.raises(ProcessLookupError):
        os.kill(int(spawned.group(1)), 0)
    events = [e["event"] for e in lifecycle["refused_timeline"][1]["events"]]
    assert "retrying" not in events and "failed" not in events


def test_dpo_job_succeeds_promotes_and_serves(lifecycle):
    """``tiny-dpo-test`` through the port's controller: SUCCEEDED with the
    DPO columns, promoted, and ``/generate`` answering from its adapter."""
    job = lifecycle["dpo"]
    assert job["status"] == "succeeded", job
    status, body = lifecycle["dpo_metrics"]
    assert status == 200
    records = body["records"]
    assert records[0]["step"] == 20
    assert all(math.isfinite(r["loss"]) and math.isfinite(r["reward_margin"])
               for r in records)
    assert {"dpo_accuracy", "policy_chosen_logprob"} <= set(records[0])
    assert lifecycle["dpo_promote"][0] == 202
    status, answer = lifecycle["dpo_generate"]
    assert status == 200, answer
    assert len(answer["tokens"]) == 6
    assert answer["model"]["checkpoint_step"] == 20 and answer["model"]["lora_merged"]


def test_dpo_gauges_while_running(lifecycle):
    text = lifecycle["dpo_gauges"]
    job_id = lifecycle["dpo"]["job_id"]
    for gauge in ("ftc_dpo_reward_margin", "ftc_dpo_accuracy"):
        lines = [line for line in text.splitlines()
                 if line.startswith(f'{gauge}{{job_id="{job_id}"')]
        assert len(lines) == 1, (gauge, text[-2000:])
        assert math.isfinite(float(lines[0].rsplit(" ", 1)[1]))


def test_serving_on_the_default_device_without_a_card_raises(lifecycle):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    status, body = lifecycle["cuda_load"]
    assert status == 500 and body == {"detail": "internal server error"}
