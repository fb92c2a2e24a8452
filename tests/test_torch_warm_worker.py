"""The port's warm trainer pool (``train/warm_worker.py`` and the local
backend's pool) on the CPU.

* A job submitted to a backend with ``warm_workers=1`` starts in the
  prewarmed process (its ``Started`` event names the worker's pid), trains
  to SUCCEEDED with the losses of a cold-started run of the same spec (bit
  for bit: same process-independent seeds), and the pool is replenished
  with a new process after the job.
* The card choice: a pooled process was spawned before its job was
  admitted, so it must not touch CUDA before the request line has set the
  job's ``CUDA_VISIBLE_DEVICES``.  The pool is keyed without the card, the
  spawn env carries none, the request line carries the grant, and the
  worker's first line in the job log records the card it applied and that
  CUDA was uninitialised until then.
* A pool member lost between the claim and the handoff (a broken pipe)
  cold-spawns the job instead (``WarmWorkerLost``), as the reference does.

Every await is bounded and every process is reaped in ``finally``.
"""

from __future__ import annotations

import asyncio
import csv
import json
import os
import subprocess
import sys
import time
from pathlib import Path


from finetune_controller_tpu_torch.controller import registry
from finetune_controller_tpu_torch.controller.backends.local import (
    LocalProcessBackend,
    _JobHandle,
)
from finetune_controller_tpu_torch.controller.devices import (
    DeviceCatalog,
    DeviceFlavor,
    FlavorQuota,
)
from finetune_controller_tpu_torch.controller.examples import LoRASFTArguments, TinyTestLoRA
from finetune_controller_tpu_torch.controller.monitor import JobMonitor
from finetune_controller_tpu_torch.controller.objectstore import LocalObjectStore
from finetune_controller_tpu_torch.controller.schemas import DatabaseStatus, JobInput
from finetune_controller_tpu_torch.controller.statestore import StateStore
from finetune_controller_tpu_torch.controller.task_builder import DatasetInput, task_builder
from finetune_controller_tpu_torch.train import cli

ROOT = Path(__file__).resolve().parents[1]
AWAIT_S = 120.0
SPEC = {
    "job_id": "warm",
    "model": {"preset": "tiny-test", "lora": {"rank": 2}, "overrides": {"dtype": "float32"}},
    "training": {"total_steps": 3, "batch_size": 2, "seq_len": 16, "log_every": 1,
                 "checkpoint_every": 3, "warmup_steps": 1, "learning_rate": 0.05, "seed": 5},
    "dataset": {"synthetic": {"task": "increment"}},
}


def run(coro, timeout_s: float = 300.0):
    return asyncio.run(asyncio.wait_for(coro, timeout_s))


def _catalog(runtime: str = "cpu") -> DeviceCatalog:
    return DeviceCatalog(
        flavors=[DeviceFlavor(name="chip-1", generation="cpu", hosts=1, chips_per_host=1,
                              runtime=runtime, queue="q")],
        quotas=[FlavorQuota(flavor="chip-1", nominal_chips=2)],
        default_flavor="chip-1",
    )


def _losses(artifacts: Path) -> list[float]:
    with open(artifacts / "metrics.csv", newline="") as f:
        return [float(r["loss"]) for r in csv.DictReader(f)]


def test_warm_started_job_succeeds_and_the_pool_is_replenished(tmp_path):
    registry.reset()
    registry.load_builtin_models()
    state = StateStore(tmp_path / "state")
    store = LocalObjectStore(tmp_path / "objects")
    catalog = _catalog()
    backend = LocalProcessBackend(tmp_path / "sandboxes", store, catalog,
                                  sync_interval_s=0.2, warm_workers=1)
    monitor = JobMonitor(state, store, backend, interval_s=0.1)
    arguments = LoRASFTArguments(total_steps=3, warmup_steps=1, batch_size=2, seq_len=16,
                                 lora_rank=2, log_every=1, checkpoint_every=3)

    async def main():
        await state.connect()
        try:
            await asyncio.wait_for(backend.prewarm(wait_s=AWAIT_S), AWAIT_S + 10)
            (pool,) = backend._warm.values()
            (warm,) = pool
            assert warm.returncode is None
            await task_builder(
                JobInput(job_id="w1", user_id="u", model_name="tiny-test-lora",
                         device="chip-1", arguments=arguments.model_dump()),
                TinyTestLoRA(training_arguments=arguments), DatasetInput(),
                state=state, store=store, backend=backend, catalog=catalog,
                datasets_bucket="datasets", artifacts_bucket="artifacts",
            )
            handle = backend._handles["w1"]
            deadline = time.monotonic() + 240
            while True:
                await monitor.tick()
                rec = await state.get_job("w1")
                if rec.status.is_final:
                    break
                assert time.monotonic() < deadline, (rec.status, rec.metadata)
                await asyncio.sleep(0.1)
            assert rec.status is DatabaseStatus.SUCCEEDED, rec.metadata
            # the monitor deletes a succeeded job from the backend: read the
            # events off the handle
            started = [e["message"] for e in handle.events if e["reason"] == "Started"]
            assert started == [f"attempt 0: warm worker pid={warm.pid}"]
            assert await asyncio.wait_for(warm.wait(), 30) == 0
            log = (handle.sandbox / "logs.txt").read_text()
            assert f"warm worker pid={warm.pid}: CUDA_VISIBLE_DEVICES= applied with CUDA " \
                   "initialised before the request: False" in log
            # replenished after the job, with a new process
            for _ in range(100):
                live = [p for p in backend._warm[backend._env_key(handle.env)]
                        if p.returncode is None]
                if live:
                    break
                await asyncio.sleep(0.1)
            assert len(live) == 1 and live[0].pid != warm.pid
            return handle.artifacts_dir, json.loads(handle.spec_path.read_text())
        finally:
            await asyncio.wait_for(backend.close(), 60)
            await state.close()

    artifacts, spec = run(main())
    cold = tmp_path / "cold"
    spec = {**spec, "artifacts_dir": str(cold)}
    (tmp_path / "cold.json").write_text(json.dumps(spec))
    assert cli.main(["--spec", str(tmp_path / "cold.json"), "--device", "cpu"]) == 0
    assert _losses(artifacts) == _losses(cold)


def test_warm_worker_applies_the_requested_card_before_cuda(tmp_path):
    """The worker is started with one card in its env and handed another
    in the request line: the job runs with the requested card, and CUDA
    was not initialised before the request arrived."""
    art = tmp_path / "art"
    (tmp_path / "job.json").write_text(json.dumps({**SPEC, "artifacts_dir": str(art)}))
    ready = tmp_path / "ready"
    env = {**os.environ, "PYTHONPATH": str(ROOT), "CUDA_VISIBLE_DEVICES": "7",
           "FTC_WARM_READY_FILE": str(ready)}
    proc = subprocess.Popen(
        [sys.executable, "-m", "finetune_controller_tpu_torch.train.warm_worker"],
        stdin=subprocess.PIPE, stdout=subprocess.DEVNULL, stderr=subprocess.STDOUT,
        env=env, cwd=tmp_path)
    try:
        for _ in range(1200):
            if ready.exists() or proc.poll() is not None:
                break
            time.sleep(0.1)
        assert ready.exists(), f"the warm worker never became ready (exit {proc.poll()})"
        request = {"spec": str(tmp_path / "job.json"), "log": str(tmp_path / "logs.txt"),
                   "cwd": str(tmp_path), "env": {"CUDA_VISIBLE_DEVICES": "3"},
                   "argv": ["--device", "cpu"]}
        proc.stdin.write((json.dumps(request) + "\n").encode())
        proc.stdin.close()
        assert proc.wait(timeout=AWAIT_S) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    log = (tmp_path / "logs.txt").read_text()
    assert f"warm worker pid={proc.pid}: CUDA_VISIBLE_DEVICES=3 applied with CUDA " \
           "initialised before the request: False" in log
    assert not ready.exists()  # the worker removes its sentinel
    assert len(_losses(art)) == 3


class _FakeStdin:
    def __init__(self, broken: bool):
        self.broken = broken
        self.data = b""

    def write(self, data):
        if self.broken:
            raise BrokenPipeError("pool member died")
        self.data += data

    async def drain(self):
        return None

    def close(self):
        return None


class _FakeProc:
    """A claimed pool member: records the request line, exits 0."""

    pid = 424242
    returncode = None

    def __init__(self, broken: bool = False):
        self.stdin = _FakeStdin(broken)

    async def wait(self):
        self.returncode = 0
        return 0


def _handle(tmp_path, backend, runtime: str, card: str | None) -> _JobHandle:
    handle = _JobHandle("job", tmp_path / "job", "local://artifacts/job", [])
    handle.artifacts_dir.mkdir(parents=True)
    (handle.artifacts_dir / "done.txt").write_text("done")  # the sync loop ends at once
    handle.flavor_obj = _catalog(runtime).flavors[0]
    handle.env = backend._runtime_env(handle.flavor_obj, 1)
    handle.env.update({"FTC_TRACE_ID": "t-1", "FTC_ATTEMPT": "2"})
    if card is not None:
        handle.env["CUDA_VISIBLE_DEVICES"] = card
    return handle


def test_pool_is_keyed_without_the_card_and_the_request_carries_the_grant(tmp_path):
    store = LocalObjectStore(tmp_path / "objects")
    backend = LocalProcessBackend(tmp_path / "sb", store, _catalog("cuda"), warm_workers=1)
    env = backend._runtime_env(_catalog("cuda").flavors[0], 1)
    assert backend._env_key({**env, "CUDA_VISIBLE_DEVICES": "0"}) == \
        backend._env_key({**env, "CUDA_VISIBLE_DEVICES": "1"})
    handle = _handle(tmp_path, backend, "cuda", card="1")
    fake = _FakeProc()
    backend._claim_warm = lambda env: fake

    async def main():
        rc = await asyncio.wait_for(backend._run_once(handle, 0), 30)
        if handle.sync_task is not None:
            await asyncio.wait_for(handle.sync_task, 10)
        return rc

    assert run(main(), 60) == 0
    request = json.loads(fake.stdin.data.decode())
    assert request["env"] == {"FTC_TRACE_ID": "t-1", "FTC_ATTEMPT": "2",
                              "CUDA_VISIBLE_DEVICES": "1"}
    assert request["argv"] == [] and request["spec"] == str(handle.spec_path)
    assert handle.events[-2]["message"] == "attempt 0: warm worker pid=424242"


def test_spawned_pool_env_carries_no_card_or_trace_identity(tmp_path, monkeypatch):
    store = LocalObjectStore(tmp_path / "objects")
    backend = LocalProcessBackend(tmp_path / "sb", store, _catalog("cuda"), warm_workers=1)
    seen = {}

    async def fake_exec(*args, env=None, **kw):
        seen.update(env)
        return _FakeProc()

    monkeypatch.setattr(asyncio, "create_subprocess_exec", fake_exec)
    handle = _handle(tmp_path, backend, "cuda", card="0")
    run(backend._spawn_warm(handle.env), 30)
    assert "FTC_WARM_READY_FILE" in seen
    assert not {"CUDA_VISIBLE_DEVICES", "FTC_TRACE_ID", "FTC_ATTEMPT"} & set(seen)


def test_a_lost_pool_member_cold_spawns_the_job(tmp_path):
    """A broken pipe at the handoff is a lost pool member, not a failed
    job: the attempt cold-spawns the CLI and succeeds."""
    store = LocalObjectStore(tmp_path / "objects")
    backend = LocalProcessBackend(tmp_path / "sb", store, _catalog("cpu"), warm_workers=1)
    handle = _handle(tmp_path, backend, "cpu", card=None)
    art = tmp_path / "art"
    handle.spec_path.write_text(json.dumps({**SPEC, "artifacts_dir": str(art)}))
    backend._claim_warm = lambda env: _FakeProc(broken=True)

    async def main():
        rc = await asyncio.wait_for(backend._run_once(handle, 0), AWAIT_S)
        if handle.sync_task is not None:
            await asyncio.wait_for(handle.sync_task, 10)
        return rc

    assert run(main(), AWAIT_S + 30) == 0
    reasons = [(e["reason"], e["message"]) for e in handle.events]
    assert ("WarmWorkerLost", "pool member died") in reasons
    started = [m for r, m in reasons if r == "Started"]
    assert len(started) == 1 and "train.cli" in started[0] and "--device cpu" in started[0]
    assert len(_losses(art)) == 3

