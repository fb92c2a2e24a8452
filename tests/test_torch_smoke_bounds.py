"""Checks of ``chip_smoke.py`` run on the CPU.  P0 holds the DPO loss of
the kernel path within ``DPO_LOSS_F32_REL_TOL`` of the plain path in f32;
R derives the step its SIGKILLed job must resume from out of the commit
of step 2's asynchronous save, counts each attempt's flash launches from
the trainer's events and prices the asynchronous saves.

``dpo_objective_check`` runs here on ``tiny-test`` (bf16 compute and the
preset's plain attention, so the "kernel" and "plain" paths compute the
same loss, ~1.7e-3 off the f32 one): it passes as it is, and a kernel-path
loss 1 % further off makes it fail naming the bound, while the sequence
logprobs and the gradients (1 % off too) stay inside their own bounds.
The bound is new: before it, P0 only printed the loss.
"""

from __future__ import annotations

import logging
import os
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from finetune_controller_tpu_torch.models import llama  # noqa: E402
from finetune_controller_tpu_torch.prefs import losses  # noqa: E402
from finetune_controller_tpu_torch.train.checkpoint import CheckpointManager  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture
def tiny_p0(tmp_path, monkeypatch):
    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    monkeypatch.setattr(chip_smoke, "FLASH_KERNELS", ())
    monkeypatch.setitem(llama.PRESETS, "llama3-8b", llama.PRESETS["tiny-test"])
    rows = tmp_path / "prefs.jsonl"
    chip_smoke.write_preference_rows(rows, 0, 8, 256)
    return rows


@pytest.mark.parametrize("off", [0.0, 0.01])
def test_p0_bounds_the_loss_against_the_f32_plain_path(tiny_p0, monkeypatch, off):
    real = losses.dpo_loss

    def shifted(*args, **kw):
        loss, metrics = real(*args, **kw)
        if os.environ.get("FTC_FLASH_ATTN") == "kernel":
            loss = loss * (1.0 + off)
        return loss, metrics

    monkeypatch.setattr(losses, "dpo_loss", shifted)
    if off == 0.0:
        record = chip_smoke.dpo_objective_check(tiny_p0, 0)
        assert record["loss_rel_kernel_vs_f32"] <= chip_smoke.DPO_LOSS_F32_REL_TOL
        return
    with pytest.raises(chip_smoke.SmokeFailure, match="loss rel to the f32 plain path"):
        chip_smoke.dpo_objective_check(tiny_p0, 0)


@pytest.mark.parametrize("committed,resumed,swept,want", [
    pytest.param(True, [2], False, 2, id="committed-resumes-from-2"),
    pytest.param(False, [], True, 0, id="in-flight-swept-starts-from-0"),
    pytest.param(True, [], False, None, id="committed-but-started-from-0"),
    pytest.param(False, [2], True, None, id="in-flight-but-resumed"),
    pytest.param(False, [], False, None, id="in-flight-not-swept"),
])
def test_r_derives_the_resume_step_from_step_2s_commit(tmp_path, caplog, committed, resumed,
                                                        swept, want):
    logs = ["step 2 loss 12.0827 acc 0.000", "step 3 loss 11.9164 acc 0.000"]
    if swept:
        # the message the second attempt's checkpoint manager logs
        (tmp_path / "step_2.tmp").mkdir()
        with caplog.at_level(logging.WARNING):
            CheckpointManager(tmp_path)
        logs += [r.getMessage() for r in caplog.records]
        assert not (tmp_path / "step_2.tmp").exists()
    logs += [f"resumed from checkpoint step {step}" for step in resumed]
    kill_ts = 1000.0
    step2_mtime = kill_ts - 1.5 if committed else kill_ts + 20.0
    if want is None:
        with pytest.raises(chip_smoke.SmokeFailure, match="must resume from step"):
            chip_smoke.resume_outcome(logs, step2_mtime, kill_ts)
    else:
        assert chip_smoke.resume_outcome(logs, step2_mtime, kill_ts)[0] == want


def test_r_reads_each_attempts_launches_and_prices_the_async_saves():
    counts = {"flash_forward": 128, "flash_backward_dq": 64, "flash_backward_dkv": 64}
    twice = {k: 2 * v for k, v in counts.items()}
    events = [
        {"event": "train-started", "attrs": {"step": 0}},
        {"event": "checkpoint-committed", "attrs": {"step": 2, "kernel_launches": counts}},
        {"event": "train-started", "attrs": {"step": 2, "resumed_from": 2}},
        {"event": "checkpoint-committed", "attrs": {"step": 4, "kernel_launches": counts}},
        {"event": "checkpoint-committed", "attrs": {"step": 6, "blocking": True,
                                                    "kernel_launches": twice}},
        {"event": "train-finished", "attrs": {"step": 6, "kernel_launches": twice}},
    ]
    assert chip_smoke.attempt_launches(events) == [counts, twice]

    compute = {1: 9000.0, 2: 1000.0, 3: 8000.0, 4: 1100.0, 5: 1700.0, 6: 1000.0}
    records = [{"step": float(k), "phase_compute_ms": v} for k, v in compute.items()]
    spans = {2: {"ms": 450.0, "snapshot_ms": 440.0, "blocking": None, "attempt": 1},
             4: {"ms": 480.0, "snapshot_ms": 470.0, "blocking": None, "attempt": 2},
             6: {"ms": 1280.0, "snapshot_ms": 40.0, "blocking": True, "attempt": 2}}
    cost = chip_smoke.save_cost(records, spans, resumed_from=2)
    # step 3 warms up, step 5 overlaps step 4's writer, steps 4 and 6 run alone
    assert cost["writer_free_steps"] == [4, 6]
    assert cost["writer_free_compute_ms"] == 1050.0
    assert cost["async"] == {4: {"span_ms": 480.0, "snapshot_ms": 470.0,
                                 "next_step_extra_ms": 650.0, "total_ms": 1130.0}}
    assert cost["blocking"] == {6: {"span_ms": 1280.0, "snapshot_ms": 40.0}}
