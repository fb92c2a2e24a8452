"""Chaos tests of the port: deterministic fault injection
(``resilience/faults.py``) against the port's real local backend, monitor
and retry supervisor, with ``tiny-test`` jobs that train on the CPU — the
four tests of ``tests/test_chaos.py`` — and the kill → resume trajectory in
process against the JAX trainer.

* a job SIGTERMed at step 25 (the spot-reclaim shape) is classified
  ``preemption``, requeued with backoff, resumes from its committed
  checkpoint and ends SUCCEEDED with step-continuous metrics;
* a deterministic user error is not retried (``failure_class: user``);
* ``slow``, as in the reference: a SIGKILL (no save) resumes from the last
  committed checkpoint and leaves no staging behind; the resumed job's loss
  and accuracy rows equal an uninterrupted twin's exactly;
* ``FaultyObjectStore`` over the port's ``LocalObjectStore`` fails the same
  writes as the reference's wrapper for the same seed, and passes reads
  and the written bytes through;
* in process (tier-1): ``FTC_FAULT_KILL_AT_STEP`` with SIGTERM turns into
  save-and-exit 143, a new trainer's ``fit`` resumes, and the rows equal an
  uninterrupted port run bit for bit and the JAX trainer's losses within
  ``tests/test_torch_train.py``'s rtol 2e-5.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_chaos.py -m slow
"""

from __future__ import annotations

import asyncio
import csv
import re
import signal
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import run_async as run

from test_torch_train import SEQ, _noisy, _packed_batches

from finetune_controller_tpu.models.llama import PRESETS as JAX_PRESETS
from finetune_controller_tpu.models.lora import LoRAConfig as JaxLoRAConfig
from finetune_controller_tpu.resilience.faults import FaultyObjectStore as JaxFaultyObjectStore
from finetune_controller_tpu.train.trainer import TrainConfig as JaxTrainConfig
from finetune_controller_tpu.train.trainer import Trainer as JaxTrainer
from finetune_controller_tpu_torch.controller import registry
from finetune_controller_tpu_torch.controller.backends.local import LocalProcessBackend
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
from finetune_controller_tpu_torch.models.convert import from_flax
from finetune_controller_tpu_torch.models.llama import PRESETS
from finetune_controller_tpu_torch.models.lora import LoRAConfig
from finetune_controller_tpu_torch.resilience import FaultyObjectStore, StepFault
from finetune_controller_tpu_torch.resilience.faults import (
    ENV_KILL_AT_STEP,
    ENV_ONCE_FILE,
    ENV_SIGNAL,
)
from finetune_controller_tpu_torch.resilience.policy import RetryPolicy
from finetune_controller_tpu_torch.resilience.supervisor import RetrySupervisor
from finetune_controller_tpu_torch.train.trainer import TrainConfig, Trainer


def one_chip_catalog(quota: int = 2) -> DeviceCatalog:
    """One 1-chip flavor whose jobs train on the host CPU."""
    return DeviceCatalog(
        flavors=[DeviceFlavor(name="chip-1", generation="cpu", hosts=1,
                              chips_per_host=1, runtime="cpu", queue="q")],
        quotas=[FlavorQuota(flavor="chip-1", nominal_chips=quota)],
        default_flavor="chip-1",
    )


def _arguments(total_steps=60, cadence=10):
    return LoRASFTArguments(
        total_steps=total_steps, warmup_steps=1, batch_size=2, seq_len=16,
        lora_rank=2, log_every=cadence, checkpoint_every=cadence,
    )


def _plane(tmp_path, *, fault: StepFault | None = None, subdir="plane"):
    """The port's control plane with the backend's own restart budget zeroed,
    so recovery must flow through the supervisor, and a fast seeded
    backoff."""
    registry.reset()
    registry.load_builtin_models()  # the supervisor rebuilds specs from here
    root = tmp_path / subdir
    state = StateStore(root / "state")
    store = LocalObjectStore(root / "objects")
    catalog = one_chip_catalog()
    backend = LocalProcessBackend(
        root / "sandboxes", store, catalog,
        sync_interval_s=0.2, backoff_limit=0,
        extra_env=fault.to_env() if fault else None,
    )
    supervisor = RetrySupervisor(
        state, backend, catalog,
        policy=RetryPolicy(max_attempts=3, base_delay_s=0.2, max_delay_s=0.5, seed=0),
    )
    monitor = JobMonitor(state, store, backend, interval_s=0.1, supervisor=supervisor)
    return state, store, catalog, backend, supervisor, monitor


async def _submit(state, store, backend, catalog, arguments, job_id):
    spec = TinyTestLoRA(training_arguments=arguments)
    await task_builder(
        JobInput(job_id=job_id, user_id="u", model_name="tiny-test-lora",
                 device="chip-1", arguments=arguments.model_dump()),
        spec, DatasetInput(),
        state=state, store=store, backend=backend, catalog=catalog,
        datasets_bucket="datasets", artifacts_bucket="artifacts",
    )


async def _drive_to_final(state, monitor, job_id, timeout_s=300):
    deadline = time.monotonic() + timeout_s
    while True:
        await monitor.tick()
        rec = await state.get_job(job_id)
        if rec.status.is_final:
            return rec
        assert time.monotonic() < deadline, (rec.status, rec.metadata)
        await asyncio.sleep(0.1)


def _metric_steps(sandbox_artifacts, column="step"):
    with open(sandbox_artifacts / "metrics.csv", newline="") as f:
        rows = list(csv.DictReader(f))
    return [int(float(r[column])) for r in rows], rows


def test_chaos_kill_mid_training_requeues_with_backoff_and_resumes(tmp_path):
    """SIGTERM at step 25 → FAILED (restart budget 0) → the supervisor
    classifies ``preemption``, backs off, resubmits → the respawned attempt
    resumes from the committed checkpoint and ends SUCCEEDED."""

    async def main():
        total, cadence = 60, 10
        fault = StepFault(kill_at_step=25, signum=signal.SIGTERM,
                          once_file=str(tmp_path / "fault_fired"))
        state, store, catalog, backend, sup, monitor = _plane(tmp_path, fault=fault)
        await state.connect()
        await _submit(state, store, backend, catalog, _arguments(total, cadence), "chaos-1")
        handle = backend._handles["chaos-1"]
        rec = await _drive_to_final(state, monitor, "chaos-1")

        assert rec.status is DatabaseStatus.SUCCEEDED, rec.metadata
        history = rec.metadata["attempt_history"]
        assert len(history) == 1, history
        assert history[0]["failure_class"] == "preemption"
        assert history[0]["exit_code"] == 143
        assert history[0]["delay_s"] >= 0.2  # the backoff actually applied
        assert sup.retries_scheduled == 1 and sup.resubmits == 1
        assert (tmp_path / "fault_fired").exists()

        log_text = (handle.sandbox / "logs.txt").read_text()
        # the SIGTERM save at step 25 is the committed step it resumes from
        assert "resumed from checkpoint step 25" in log_text
        steps, _ = _metric_steps(handle.artifacts_dir)
        assert steps == list(range(cadence, total + 1, cadence))
        assert await store.exists(rec.artifacts_uri + "/done.txt")
        assert await store.exists(rec.artifacts_uri + "/heartbeat.json")
        await backend.close()
        await state.close()

    run(main())


def test_chaos_user_error_is_terminal_with_failure_class(tmp_path):
    """A deterministic user error (batch_size not divisible by
    grad_accum_steps: the trainer's constructor raises) is not retried."""

    async def main():
        args = LoRASFTArguments(total_steps=5, warmup_steps=1, batch_size=3, seq_len=16,
                                lora_rank=2, grad_accum_steps=2)
        state, store, catalog, backend, sup, monitor = _plane(tmp_path)
        await state.connect()
        await _submit(state, store, backend, catalog, args, "chaos-user-1")
        rec = await _drive_to_final(state, monitor, "chaos-user-1", timeout_s=180)
        assert rec.status is DatabaseStatus.FAILED
        assert rec.metadata["failure_class"] == "user"
        history = rec.metadata["attempt_history"]
        assert len(history) == 1
        assert history[0]["exit_code"] == 1
        assert history[0]["delay_s"] is None  # terminal: no backoff scheduled
        assert sup.resubmits == 0 and sup.terminal_failures == 1
        await monitor.tick()
        rec = await state.get_job("chaos-user-1")
        assert rec.status is DatabaseStatus.FAILED
        assert len(rec.metadata["attempt_history"]) == 1
        await backend.close()
        await state.close()

    run(main())


@pytest.mark.slow
def test_chaos_sigkill_resumes_from_last_committed_checkpoint(tmp_path):
    """SIGKILL (exit -9, no chance to save): classified ``infra``; the
    respawn resumes from the last checkpoint committed before the kill and
    sweeps any staging the kill stranded."""

    async def main():
        total, cadence = 60, 10
        fault = StepFault(kill_at_step=25, signum=signal.SIGKILL,
                          once_file=str(tmp_path / "fault_fired"))
        state, store, catalog, backend, sup, monitor = _plane(tmp_path, fault=fault)
        await state.connect()
        await _submit(state, store, backend, catalog, _arguments(total, cadence),
                      "chaos-kill-1")
        handle = backend._handles["chaos-kill-1"]
        rec = await _drive_to_final(state, monitor, "chaos-kill-1")

        assert rec.status is DatabaseStatus.SUCCEEDED, rec.metadata
        history = rec.metadata["attempt_history"]
        assert len(history) == 1
        assert history[0]["failure_class"] == "infra"
        assert history[0]["exit_code"] == -9
        log_text = (handle.sandbox / "logs.txt").read_text()
        # killed at 25: the newest committed checkpoint is 20, or 10 when
        # the SIGKILL also caught step 20's async save before its commit
        m = re.search(r"resumed from checkpoint step (\d+)", log_text)
        assert m, "respawned attempt did not resume"
        assert int(m.group(1)) in (10, 20), m.group(0)
        steps, _ = _metric_steps(handle.artifacts_dir)
        assert steps == list(range(cadence, total + 1, cadence))
        strays = [p.name for p in (handle.artifacts_dir / "checkpoints").iterdir()
                  if ".tmp" in p.name]
        assert strays == [], strays
        await backend.close()
        await state.close()

    run(main())


@pytest.mark.slow
def test_chaos_resumed_loss_trajectory_matches_uninterrupted_run(tmp_path):
    """After a mid-training kill and a supervised requeue, the resumed run's
    rows (loss and accuracy, every logged step) equal an uninterrupted twin
    run's with the same seed."""

    async def main():
        total, cadence = 60, 10
        args = _arguments(total, cadence)
        fault = StepFault(kill_at_step=25, signum=signal.SIGTERM,
                          once_file=str(tmp_path / "fault_fired"))
        state_a, store_a, cat_a, backend_a, _, monitor_a = _plane(
            tmp_path, fault=fault, subdir="plane_a")
        await state_a.connect()
        await _submit(state_a, store_a, backend_a, cat_a, args, "traj-a")
        handle_a = backend_a._handles["traj-a"]
        rec_a = await _drive_to_final(state_a, monitor_a, "traj-a")
        assert rec_a.status is DatabaseStatus.SUCCEEDED, rec_a.metadata
        assert len(rec_a.metadata["attempt_history"]) == 1

        state_b, store_b, cat_b, backend_b, _, monitor_b = _plane(tmp_path, subdir="plane_b")
        await state_b.connect()
        await _submit(state_b, store_b, backend_b, cat_b, args, "traj-b")
        handle_b = backend_b._handles["traj-b"]
        rec_b = await _drive_to_final(state_b, monitor_b, "traj-b")
        assert rec_b.status is DatabaseStatus.SUCCEEDED, rec_b.metadata
        assert rec_b.metadata.get("attempt_history") in (None, [])

        steps_a, rows_a = _metric_steps(handle_a.artifacts_dir)
        steps_b, rows_b = _metric_steps(handle_b.artifacts_dir)
        assert steps_a == steps_b == list(range(cadence, total + 1, cadence))
        for row_a, row_b in zip(rows_a, rows_b):
            for col in ("loss", "accuracy"):
                assert float(row_a[col]) == float(row_b[col]), (
                    f"step {row_a['step']}: {col} diverged after resume")
        for backend in (backend_a, backend_b):
            await backend.close()
        for state in (state_a, state_b):
            await state.close()

    run(main())


# ---------------------------------------------------------------------------
# in process: the kill → resume trajectory against the JAX trainer
# ---------------------------------------------------------------------------


def test_in_process_sigterm_resume_is_bit_equal_and_matches_jax(tmp_path, monkeypatch):
    train_kw = dict(mode="lora", learning_rate=0.01, warmup_steps=1, total_steps=6,
                    batch_size=4, seq_len=SEQ, prefetch=0, log_every=1, checkpoint_every=4,
                    heartbeat_interval_s=0)
    jcfg = JAX_PRESETS["tiny-test"].replace(dtype=jnp.float32, lora=JaxLoRAConfig(rank=4))
    jtrainer = JaxTrainer(jcfg, JaxTrainConfig(**train_kw))
    state = jtrainer.init_state()
    frozen = _noisy(jax.device_get(state.frozen), 5)
    trainable = _noisy(jax.device_get(state.trainable), 6)
    state = state.replace(frozen=frozen, trainable=trainable,
                          opt_state=jtrainer.tx.init(trainable))
    batches = _packed_batches(7, 4, 6)
    want = []
    for batch in batches:
        state, metrics = jtrainer.step(state, dict(batch))
        want.append(float(metrics["loss"]))

    cfg = PRESETS["tiny-test"].replace(dtype=torch.float32, lora=LoRAConfig(rank=4))

    def port_trainer():
        trainer = Trainer(cfg, TrainConfig(**train_kw), device="cpu")
        trainer.model.load_state_dict(from_flax({**frozen, "lora": trainable}, cfg))
        return trainer

    port_trainer().fit(batches, str(tmp_path / "full"))
    monkeypatch.setenv(ENV_KILL_AT_STEP, "3")
    monkeypatch.setenv(ENV_SIGNAL, str(int(signal.SIGTERM)))
    monkeypatch.setenv(ENV_ONCE_FILE, str(tmp_path / "fired"))
    with pytest.raises(SystemExit) as info:
        port_trainer().fit(batches, str(tmp_path / "cut"))
    assert info.value.code == 143 and (tmp_path / "fired").exists()
    assert sorted(p.name for p in (tmp_path / "cut" / "checkpoints").iterdir()) == ["step_3"]
    resumed = port_trainer()
    resumed.fit(batches, str(tmp_path / "cut"))  # the once-file keeps it from firing
    got = _metric_steps(tmp_path / "cut")[1]
    full = _metric_steps(tmp_path / "full")[1]
    assert [r["step"] for r in got] == [str(i) for i in range(1, 7)]
    for col in ("loss", "accuracy", "grad_norm"):
        assert [r[col] for r in got] == [r[col] for r in full], col
    np.testing.assert_allclose([float(r["loss"]) for r in got], want, rtol=2e-5)


def test_faulty_object_store_fails_the_reference_schedule(tmp_path):
    async def writes(store, root):
        failed = []
        for i in range(40):
            try:
                await store.put_bytes(f"{root}/obj{i}", b"x" * i)
            except OSError as exc:  # each package's FaultInjectionError
                assert type(exc).__name__ == "FaultInjectionError"
                failed.append(i)
        return failed

    async def main():
        port = FaultyObjectStore(LocalObjectStore(tmp_path / "port"), write_error_rate=0.3,
                                 seed=7)
        ref = JaxFaultyObjectStore(LocalObjectStore(tmp_path / "ref"), write_error_rate=0.3,
                                   seed=7)
        failed = await writes(port, "obj://b/p")
        assert failed == await writes(ref, "obj://b/p") and 0 < len(failed) < 40
        assert port.injected_errors == len(failed) and port.write_calls == 40
        kept = next(i for i in range(40) if i not in failed)
        assert await port.get_bytes(f"obj://b/p/obj{kept}") == b"x" * kept
        assert not await port.exists(f"obj://b/p/obj{failed[0]}")

    run(main())
