"""The port's runtime guards (``analysis/recompile_guard.py``,
``analysis/transfer_guard.py``) against the JAX package's, and wired into
the port's trainer and serve engine.

* ``RecompileGuard``: the same call sequence through both guards gives the
  same leaf signatures, the same structure equalities, the same counts
  after every call and the same call on which ``raise`` trips (exact: the
  guard is host bookkeeping).
* ``TransferGuard``: the window semantics of ``tests/test_transfer_guard.py``
  mirrored on the port (the port's host fetch ``device_get`` stands in for
  ``jax.device_get``; a numpy array reaching a guarded call stands in for
  XLA's host-to-device refusal).  On the CPU no CUDA sync exists, so the
  sync-debug mode is shown on the card (``chip_smoke.py`` phase J).
* The tiny trainer and engine run clean under ``raise`` and abort on the
  injected fault (``FTC_FAULT_TRANSFER=1``); the engine's signature budget
  and counts equal the JAX engine's on the same requests.

Nothing here sleeps or opens a socket.
"""

from __future__ import annotations

import logging
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from finetune_controller_tpu.analysis import recompile_guard as ref_rg
from finetune_controller_tpu_torch.analysis import recompile_guard as rg
from finetune_controller_tpu_torch.analysis.transfer_guard import (
    TransferGuard,
    TransferGuardError,
    device_get,
)
from finetune_controller_tpu_torch.data.synthetic import synthetic_batches
from finetune_controller_tpu_torch.models.llama import PRESETS, LlamaForCausalLM, init_random_
from finetune_controller_tpu_torch.models.lora import LoRAConfig
from finetune_controller_tpu_torch.serve.engine import BatchEngine, EngineConfig, GenRequest
from finetune_controller_tpu_torch.train.trainer import Trainer, TrainConfig

# ---------------------------------------------------------------------------
# RecompileGuard against the reference
# ---------------------------------------------------------------------------


def _calls():
    """A call sequence with repeats, new shapes, new dtypes, a Python scalar
    whose value changes (no new signature) and whose type changes (one), a
    static string, a None and a changed dict structure."""
    a4 = np.zeros((4,), np.float32)
    return [
        ((a4, 1), {}),
        ((a4 + 1, 2), {}),                                  # same signature
        ((np.zeros((8,), np.float32), 1), {}),              # new shape
        ((a4.astype(np.int32), 1), {}),                     # new dtype
        ((a4, 1.5), {}),                                    # scalar type
        ((a4, 1), {"mode": "greedy"}),                      # static value
        ((a4, 1), {"mode": "greedy"}),                      # repeat
        (({"tokens": a4, "mask": None}, 1), {}),            # dict + None
        (({"tokens": a4, "mask": a4}, 1), {}),              # structure
        (([a4, a4], 1), {}),                                # list node
        (((a4, a4), 1), {}),                                # tuple node
    ]


def _run_guard(mod, budget, on_excess, to_leaf):
    guard = mod.RecompileGuard(budget, on_excess=on_excess)
    counts, sigs, raised_at = [], [], None
    for i, (args, kwargs) in enumerate(_calls()):
        args = jax.tree_util.tree_map(to_leaf, args)
        sig = mod.signature_of(*args, **kwargs)
        sigs.append(sig)
        try:
            guard.check("step" if i % 2 else "eval", sig)
        except mod.RecompileBudgetExceeded:
            raised_at = i
            break
        counts.append(guard.counts())
    return sigs, counts, raised_at


@pytest.mark.parametrize("budget", [1, 3, 6, 100])
def test_recompile_guard_counts_and_trip_equal_the_reference(budget):
    ref = _run_guard(ref_rg, budget, "raise", lambda x: jnp.asarray(x) if
                     isinstance(x, np.ndarray) else x)
    port = _run_guard(rg, budget, "raise", lambda x: torch.from_numpy(x) if
                      isinstance(x, np.ndarray) else x)
    (ref_sigs, ref_counts, ref_at), (sigs, counts, at) = ref, port
    assert (counts, at) == (ref_counts, ref_at)
    # leaf signatures are the reference's exactly; structures compare alike
    assert [s[1] for s in sigs] == [s[1] for s in ref_sigs]
    n = len(sigs)
    assert [[sigs[i][0] == sigs[j][0] for j in range(n)] for i in range(n)] == \
        [[ref_sigs[i][0] == ref_sigs[j][0] for j in range(n)] for i in range(n)]
    if budget < 100:
        assert at is not None


def test_recompile_guard_warns_once_and_validates(caplog):
    guard = rg.RecompileGuard(1, on_excess="warn", name="g")
    wrapped = guard.wrap(lambda x: x, "step")
    with caplog.at_level(logging.WARNING):
        for n in (2, 3, 4):
            wrapped(np.zeros(n))
    assert guard.compilations == 3 and guard.counts() == {"step": 3}
    assert sum("exceed the budget of 1" in r.message for r in caplog.records) == 1
    for bad in (dict(budget=0), dict(budget=1, on_excess="explode")):
        with pytest.raises(ValueError) as port_err:
            rg.RecompileGuard(**bad)
        with pytest.raises(ValueError) as ref_err:
            ref_rg.RecompileGuard(**bad)
        assert str(port_err.value) == str(ref_err.value)


# ---------------------------------------------------------------------------
# TransferGuard window semantics (mirrors tests/test_transfer_guard.py)
# ---------------------------------------------------------------------------


def add_one(x):
    return x + 1


def test_clean_dispatch_passes_and_counts_zero():
    guard = TransferGuard("raise", skip_first=False)
    x = torch.arange(4.0)
    for _ in range(3):
        y = guard.run("step", add_one, x)
    assert float(y[0]) == 1.0
    assert guard.trips == 0


def test_implicit_host_to_device_transfer_aborts():
    guard = TransferGuard("raise", skip_first=False)
    with pytest.raises(TransferGuardError, match="numpy array"):
        guard.run("step", add_one, np.arange(4.0))  # np leaf at the call boundary
    assert guard.trips == 1


def test_device_get_trap_fires_inside_window_only():
    guard = TransferGuard("raise", skip_first=False)
    x = torch.arange(4.0)
    device_get(x)  # outside any window: fine
    with pytest.raises(TransferGuardError, match="device_get"):
        with guard.window("step"):
            device_get(x)
    assert guard.trips == 1
    np.testing.assert_array_equal(device_get({"x": [x]})["x"][0], np.arange(4.0))


def test_trap_is_thread_local():
    guard = TransferGuard("raise", skip_first=False)
    x = torch.arange(4.0)
    errors = []

    def other_thread():
        try:
            device_get(x)
        except BaseException as exc:  # pragma: no cover - the failure case
            errors.append(exc)

    with guard.window("step"):
        t = threading.Thread(target=other_thread)
        t.start()
        t.join(timeout=30)
    assert not t.is_alive() and errors == []
    assert guard.trips == 0


def test_first_call_per_label_is_exempt():
    guard = TransferGuard("raise")  # skip_first defaults on
    with guard.window("step"):
        device_get(torch.arange(4.0))  # exempt: first-use work
    guard.run("other", add_one, np.arange(4.0))  # first call of its label
    with pytest.raises(TransferGuardError):
        with guard.window("step"):
            device_get(torch.arange(4.0))


def test_warn_mode_observes_without_aborting(caplog):
    guard = TransferGuard("warn", skip_first=False)
    x = torch.arange(4.0)
    with caplog.at_level(logging.WARNING):
        with guard.window("step"):
            device_get(x)
            device_get(x)
        guard.run("step", add_one, np.arange(4.0))
    assert guard.trips == 3  # counted...
    # ...with one warning per label, and the dispatch completed
    assert sum("guarded hot window" in r.message for r in caplog.records) == 1


def test_nested_window_restores_outer():
    outer = TransferGuard("raise", skip_first=False)
    inner = TransferGuard("raise", skip_first=False)
    x = torch.arange(4.0)
    with outer.window("o"):
        with inner.window("i"):
            pass
        with pytest.raises(TransferGuardError):
            device_get(x)  # the OUTER guard is active again
    assert outer.trips == 1 and inner.trips == 0


def test_from_env_parsing(monkeypatch):
    monkeypatch.delenv("FTC_TRANSFER_GUARD", raising=False)
    assert TransferGuard.from_env() is None
    monkeypatch.setenv("FTC_TRANSFER_GUARD", "off")
    assert TransferGuard.from_env() is None
    monkeypatch.setenv("FTC_TRANSFER_GUARD", "warn")
    assert TransferGuard.from_env().action == "warn"
    monkeypatch.setenv("FTC_TRANSFER_GUARD", "1")
    assert TransferGuard.from_env().action == "raise"
    with pytest.raises(ValueError):
        TransferGuard("explode")


def test_wrap_runs_in_a_window_and_injects(monkeypatch):
    monkeypatch.setenv("FTC_FAULT_TRANSFER", "1")
    guard = TransferGuard("raise")
    wrapped = guard.wrap(add_one, "step")
    assert wrapped.__wrapped__ is add_one
    assert float(wrapped(torch.zeros(2))[0]) == 1.0  # exempt first call
    with pytest.raises(TransferGuardError, match="device_get inside guarded window 'step'"):
        wrapped(torch.zeros(2))


# ---------------------------------------------------------------------------
# trainer integration
# ---------------------------------------------------------------------------


def _tiny_trainer(**cfg_kw):
    model_cfg = PRESETS["tiny-test"].replace(dtype=torch.float32, lora=LoRAConfig(rank=4))
    train_cfg = TrainConfig(mode="lora", total_steps=4, batch_size=4, seq_len=16,
                            log_every=2, checkpoint_every=1000, prefetch=0, **cfg_kw)
    return Trainer(model_cfg, train_cfg, device="cpu"), model_cfg


def test_trainer_step_clean_under_raise(tmp_path):
    trainer, model_cfg = _tiny_trainer(transfer_guard="raise", recompile_budget=2,
                                       recompile_action="raise")
    batches = synthetic_batches(4, 16, model_cfg.vocab_size, task="increment")
    trainer.fit(batches, str(tmp_path))
    assert trainer._transfer_guard.trips == 0
    assert trainer._recompile_guard.counts() == {"step:loss_mask,tokens": 1}


def test_trainer_injected_fault_aborts_the_run(tmp_path, monkeypatch):
    monkeypatch.setenv("FTC_FAULT_TRANSFER", "1")
    trainer, model_cfg = _tiny_trainer(transfer_guard="raise")
    batches = synthetic_batches(4, 16, model_cfg.vocab_size, task="increment")
    with pytest.raises(TransferGuardError, match="device_get"):
        trainer.fit(batches, str(tmp_path))
    assert trainer._transfer_guard.trips == 1


@pytest.mark.parametrize("field,env,want", [
    ("", None, None), ("", "warn", "warn"), ("raise", "warn", "raise"),
    ("off", "raise", None), ("disallow", None, None),  # unknown: off, as in the reference
])
def test_trainer_guard_modes(field, env, want, monkeypatch):
    if env is None:
        monkeypatch.delenv("FTC_TRANSFER_GUARD", raising=False)
    else:
        monkeypatch.setenv("FTC_TRANSFER_GUARD", env)
    trainer, _ = _tiny_trainer(transfer_guard=field)
    got = trainer._transfer_guard
    assert (got.action if got is not None else None) == want


@pytest.mark.parametrize("action", ["warn", "raise"])
def test_trainer_recompile_action_is_read(action, caplog):
    trainer, model_cfg = _tiny_trainer(recompile_budget=1, recompile_action=action)
    assert trainer._recompile_guard.on_excess == action
    for seq in (16, 16, 8):
        batch = next(synthetic_batches(4, seq, model_cfg.vocab_size, task="increment"))
        if seq == 8 and action == "raise":
            with pytest.raises(rg.RecompileBudgetExceeded, match="budget of 1"):
                trainer.step(batch)
        else:
            with caplog.at_level(logging.WARNING):
                trainer.step(batch)
    assert trainer._recompile_guard.compilations == 2
    if action == "warn":
        assert any("exceed the budget of 1" in r.message for r in caplog.records)


def test_trainer_eval_counts_under_its_own_label(tmp_path):
    trainer, model_cfg = _tiny_trainer(recompile_budget=3, recompile_action="raise",
                                       eval_steps=2)
    batches = synthetic_batches(4, 16, model_cfg.vocab_size, task="increment")
    trainer.step(next(batches))
    trainer.evaluate(batches)
    assert trainer._recompile_guard.counts() == {
        "step:loss_mask,tokens": 1, "eval:eval,loss_mask,tokens": 1}


# ---------------------------------------------------------------------------
# serve-engine integration
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def serve_model():
    cfg = PRESETS["tiny-test"].replace(dtype=torch.float32, lora=LoRAConfig(rank=0))
    model = LlamaForCausalLM(cfg, device="cpu")
    init_random_(model, 0)
    return model


def _engine(model, monkeypatch, *, fault: bool, **cfg):
    monkeypatch.setenv("FTC_TRANSFER_GUARD", "raise")
    if fault:
        monkeypatch.setenv("FTC_FAULT_TRANSFER", "1")
    return BatchEngine(model, EngineConfig(**{"slots": 2, "prompt_buckets": (8,),
                                              "max_new_tokens": 8, **cfg}))


@pytest.mark.parametrize("page_tokens", [4, 0])
def test_engine_decode_clean_under_raise(serve_model, monkeypatch, page_tokens):
    engine = _engine(serve_model, monkeypatch, fault=False, page_tokens=page_tokens)
    results = engine.run([
        GenRequest(request_id="a", tokens=[1, 2, 3], max_new_tokens=6),
        GenRequest(request_id="b", tokens=[4, 5], max_new_tokens=6, temperature=0.7, seed=1),
    ])
    assert {len(r.generated) for r in results.values()} == {6}
    assert engine._transfer_guard is not None
    assert engine._transfer_guard.trips == 0


def test_engine_injected_fault_aborts_decode(serve_model, monkeypatch):
    engine = _engine(serve_model, monkeypatch, fault=True)
    with pytest.raises(TransferGuardError, match="decode"):
        engine.run([GenRequest(request_id="c", tokens=[1, 2, 3], max_new_tokens=6)])
    assert engine._transfer_guard.trips == 1


def test_engine_budget_raises_past_it(serve_model, monkeypatch):
    monkeypatch.delenv("FTC_TRANSFER_GUARD", raising=False)
    engine = BatchEngine(serve_model, EngineConfig(slots=2, prompt_buckets=(8, 16),
                                                   max_new_tokens=4, recompile_budget=2))
    engine.run([GenRequest("a", [1, 2, 3], 2)])  # fill_paged@8 + decode_step
    with pytest.raises(rg.RecompileBudgetExceeded, match="serve-engine"):
        engine.run([GenRequest("b", [1] * 12, 2)])  # fill_paged@16: the third


@pytest.mark.parametrize("top_k", [0, 50])
@pytest.mark.parametrize("seed", range(4))
def test_sync_free_sampler_draws_multinomials_tokens(seed, top_k):
    """The decode step samples without a host read: its draw is
    ``torch.multinomial``'s own one-sample path, the same tokens from the
    same generator state (exact), and the generator advances alike."""
    from finetune_controller_tpu_torch.models.generate import _sample

    logits = torch.randn(3, 1000, generator=torch.Generator().manual_seed(100 + seed))
    mine, theirs = (torch.Generator().manual_seed(seed) for _ in range(2))
    for _ in range(3):
        got = _sample(logits, temperature=0.7, top_k=top_k, generator=mine)
        scaled = logits / 0.7
        if top_k:
            kth = torch.sort(scaled, dim=-1).values[:, -top_k][:, None]
            scaled = scaled.masked_fill(scaled < kth, float("-inf"))
        want = torch.multinomial(torch.softmax(scaled, dim=-1), 1, generator=theirs)[:, 0]
        assert torch.equal(got, want)


@pytest.fixture(scope="module")
def jax_model():
    from finetune_controller_tpu.models import PRESETS as JAX_PRESETS
    from finetune_controller_tpu.models.llama import LlamaForCausalLM as JaxLlama

    cfg = JAX_PRESETS["tiny-test"].replace(dtype=jnp.float32)
    model = JaxLlama(cfg)
    return model, model.init({"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 4), jnp.int32))


@pytest.mark.parametrize("cfg", [
    dict(page_tokens=4),
    dict(page_tokens=0),
    dict(page_tokens=0, prefix_cache_bytes=1 << 20),
    dict(page_tokens=4, prefix_cache_bytes=1 << 20),
], ids=["paged", "unpaged", "unpaged-prefix", "paged-prefix"])
def test_engine_budget_and_counts_equal_the_reference(serve_model, jax_model, monkeypatch, cfg):
    """The same requests (a repeated prompt, so the prefix cache hits)
    through the JAX engine and the port's: the same budget and the same
    per-label signature counts."""
    from finetune_controller_tpu.serve.engine import BatchEngine as JaxEngine
    from finetune_controller_tpu.serve.engine import EngineConfig as JaxEngineConfig
    from finetune_controller_tpu.serve.engine import GenRequest as JaxRequest

    monkeypatch.delenv("FTC_TRANSFER_GUARD", raising=False)
    shape = dict(slots=2, prompt_buckets=(8, 16), max_new_tokens=4, **cfg)
    prompts = [[1, 2, 3, 4, 5, 6, 7, 8, 9], [1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11], [5, 6]]
    port = BatchEngine(serve_model, EngineConfig(**shape))
    port.run([GenRequest(f"p{i}", p, 3) for i, p in enumerate(prompts)])
    ref = JaxEngine(*jax_model, JaxEngineConfig(**shape))
    ref.run([JaxRequest(f"p{i}", p, 3) for i, p in enumerate(prompts)])
    assert port.guard.budget == ref.guard.budget
    assert port.guard.counts() == ref.guard.counts()
    assert port.compilations == ref.compilations
