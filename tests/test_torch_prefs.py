"""The port's preference plane (``prefs/``, ``data/preference.py``,
``utils/flax_msgpack.py``) against the JAX package, on the same numpy inputs.

* the four loss functions (``masked_sequence_logprobs``, ``reward_scores``,
  ``bradley_terry_loss``, ``dpo_loss``) and their metrics: rel 1e-6 (the
  port takes ``gather - logsumexp`` where the reference takes
  ``log_softmax`` then gathers, and pools the logits with a batched product:
  f32 reassociation only);
* ``synthetic_preference_batches``, ``preference_jsonl_batches`` (text and
  pre-tokenized rows) and ``RolloutBuffer.sample_batch``: bit-equal;
* the DPO trainer on ``tiny-test`` in f32 from one noisy numpy tree: the
  first step's loss and metrics within rel 1e-5 of the JAX ``DPOTrainer``'s,
  with ``grad_accum_steps`` 1 and 2 (``grad_norm`` rel 1e-3: the noisy
  weights amplify f32 reassociation in the backward); its LoRA gradients
  within rel 1e-4 of ``jax.grad``'s (of each leaf's largest element); the
  accumulated
  gradient of 2 microbatches equals the 1-microbatch one (rel 1e-5);
  ``evaluate`` within rel 1e-5;
* the reference forward: the adapterless base's logprobs, bit for bit, with
  no gradient reaching it; an int4 base still takes the int4 product;
* the reward trainer: step-0 scores equal the mean completion logprob; loss,
  metrics (rel 1e-5, ``grad_norm`` 1e-3) and head gradients (rel 1e-4)
  against the JAX
  ``RewardModelTrainer``; ``reward_head.msgpack`` byte for byte the JAX
  trainer's file;
* the construction refusals, word for word, and ``rollout_workers > 0``
  (the disaggregated rollout plane) constructing in remote mode;
* the msgpack coder: byte equality with ``flax.serialization`` on the head
  and on a nested tree, and a round trip of flax's bytes.

The JAX trainers are built once per module.
"""

from __future__ import annotations

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from finetune_controller_tpu.data import preference as jax_pref
from finetune_controller_tpu.models.llama import PRESETS as JAX_PRESETS
from finetune_controller_tpu.models.lora import LoRAConfig as JaxLoRAConfig
from finetune_controller_tpu.models.multimodal import MM_PRESETS as JAX_MM_PRESETS
from finetune_controller_tpu.prefs import losses as jax_losses
from finetune_controller_tpu.prefs.dpo_trainer import DPOTrainer as JaxDPOTrainer
from finetune_controller_tpu.prefs.reward_trainer import RewardModelTrainer as JaxRewardTrainer
from finetune_controller_tpu.prefs.rollout_buffer import (
    PreferencePair as JaxPair,
    RolloutBuffer as JaxBuffer,
)
from finetune_controller_tpu.train.trainer import TrainConfig as JaxTrainConfig
from finetune_controller_tpu_torch.data import preference as pref
from finetune_controller_tpu_torch.models.convert import from_flax, merged_config, to_flax
from finetune_controller_tpu_torch.models.llama import PRESETS, LlamaForCausalLM
from finetune_controller_tpu_torch.models.lora import LoRAConfig
from finetune_controller_tpu_torch.models.multimodal import MM_PRESETS
from finetune_controller_tpu_torch.prefs import losses
from finetune_controller_tpu_torch.prefs.dpo_trainer import DPOTrainer
from finetune_controller_tpu_torch.prefs.reward_trainer import (
    REWARD_HEAD_FILENAME,
    RewardModelTrainer,
    read_reward_head,
)
from finetune_controller_tpu_torch.prefs.rollout_buffer import PreferencePair, RolloutBuffer
from finetune_controller_tpu_torch.train.trainer import TrainConfig
from finetune_controller_tpu_torch.utils import flax_msgpack

torch.set_num_threads(1)

SEQ = 16
B = 4


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-30))


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def loss_inputs():
    rng = np.random.default_rng(11)
    logits = (3.0 * rng.standard_normal((6, 9, 37))).astype(np.float32)
    tokens = rng.integers(0, 37, (6, 9)).astype(np.int32)
    mask = (rng.random((6, 9)) > 0.4).astype(np.float32)
    head = {"a": np.asarray(0.7, np.float32),
            "w": (0.3 * rng.standard_normal(37)).astype(np.float32),
            "b": np.asarray(-0.2, np.float32)}
    return logits, tokens, mask, head


@pytest.mark.parametrize("masked", [False, True])
def test_masked_sequence_logprobs_matches_reference(loss_inputs, masked):
    logits, tokens, mask, _ = loss_inputs
    want = jax_losses.masked_sequence_logprobs(
        jnp.asarray(logits), jnp.asarray(tokens), jnp.asarray(mask) if masked else None)
    got = losses.masked_sequence_logprobs(
        torch.from_numpy(logits), torch.from_numpy(tokens),
        torch.from_numpy(mask) if masked else None)
    assert got.dtype == torch.float32 and got.shape == (6,)
    assert _rel(got, want) < 1e-6


def test_reward_scores_matches_reference(loss_inputs):
    logits, tokens, mask, head = loss_inputs
    want = jax_losses.reward_scores(jnp.asarray(logits), jnp.asarray(tokens), jnp.asarray(mask),
                                    {k: jnp.asarray(v) for k, v in head.items()})
    got = losses.reward_scores(torch.from_numpy(logits), torch.from_numpy(tokens),
                               torch.from_numpy(mask),
                               {k: torch.from_numpy(v) for k, v in head.items()})
    assert _rel(got, want) < 1e-6


@pytest.mark.parametrize("which", ["bradley_terry_loss", "dpo_loss"])
def test_pair_objectives_match_reference(which):
    rng = np.random.default_rng(12)
    args = [(2.0 * rng.standard_normal(8)).astype(np.float32) for _ in range(4)]
    if which == "bradley_terry_loss":
        want_loss, want = jax_losses.bradley_terry_loss(*map(jnp.asarray, args[:2]))
        got_loss, got = losses.bradley_terry_loss(*map(torch.from_numpy, args[:2]))
    else:
        want_loss, want = jax_losses.dpo_loss(*map(jnp.asarray, args), 0.3)
        got_loss, got = losses.dpo_loss(*map(torch.from_numpy, args), 0.3)
    assert set(got) == set(want)
    assert _rel(got_loss.item(), float(want_loss)) < 1e-6
    for key in want:
        np.testing.assert_allclose(got[key].item(), float(want[key]), rtol=1e-6, atol=1e-7,
                                   err_msg=key)


def test_dpo_loss_treats_the_reference_as_constant():
    pc, pr, rc, rr = (torch.randn(4, requires_grad=True) for _ in range(4))
    loss, _ = losses.dpo_loss(pc, pr, rc, rr, 0.5)
    loss.backward()
    assert pc.grad.abs().sum() > 0 and pr.grad.abs().sum() > 0
    assert rc.grad is None and rr.grad is None


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------


def _assert_batches_equal(got, want):
    assert set(got) == set(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_synthetic_preference_batches_bit_equal():
    got = pref.synthetic_preference_batches(5, 24, 256, seed=7)
    want = jax_pref.synthetic_preference_batches(5, 24, 256, seed=7)
    for _ in range(3):
        _assert_batches_equal(next(got), next(want))


@pytest.mark.parametrize("rows", ["text", "tokens"])
def test_preference_jsonl_batches_bit_equal(tmp_path, rows):
    rng = np.random.default_rng(13)
    path = tmp_path / "prefs.jsonl"
    with open(path, "w") as f:
        for i in range(11):
            if rows == "text":
                row = {"prompt": f"question {i}: " + "x" * int(rng.integers(1, 9)),
                       "chosen": " good" * int(rng.integers(1, 6)),
                       "rejected": " bad" * int(rng.integers(1, 6))}
            else:
                row = {k: rng.integers(0, 256, int(rng.integers(1, 14))).tolist()
                       for k in ("prompt_tokens", "chosen_tokens", "rejected_tokens")}
            f.write(json.dumps(row) + "\n")
    got = pref.preference_jsonl_batches(str(path), 4, 12, seed=3)
    want = jax_pref.preference_jsonl_batches(str(path), 4, 12, seed=3)
    for _ in range(5):
        _assert_batches_equal(next(got), next(want))


def test_rollout_buffer_sample_batch_bit_equal():
    rng = np.random.default_rng(14)
    got, want = RolloutBuffer(6, seed=2, version_granularity=2), JaxBuffer(6, seed=2,
                                                                          version_granularity=2)
    for i in range(9):
        fields = dict(prompt=tuple(rng.integers(0, 50, 4).tolist()),
                      chosen=tuple(rng.integers(0, 50, 3).tolist()),
                      rejected=tuple(rng.integers(0, 50, 5).tolist()), version=2 * (i // 3))
        got.push(PreferencePair(**fields))
        want.push(JaxPair(**fields))
    assert got.evict_below(2, watermark=4) == want.evict_below(2, watermark=4)
    assert got.stats() == want.stats()
    for size in (3, 8):
        _assert_batches_equal(got.sample_batch(size, 10), want.sample_batch(size, 10))


# ---------------------------------------------------------------------------
# the trainers against the JAX trainers
# ---------------------------------------------------------------------------


def _noisy(tree, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda x: np.asarray(0.1 + 0.3 * rng.standard_normal(x.shape), np.float32), tree)


def _train_kw(**kw):
    return dict(dict(mode="lora", learning_rate=0.01, warmup_steps=1, total_steps=4,
                     batch_size=B, seq_len=SEQ, prefetch=0, eval_steps=2, dpo_beta=0.3,
                     heartbeat_interval_s=0), **kw)


def _jax_cfg():
    return JAX_PRESETS["tiny-test"].replace(dtype=jnp.float32, lora=JaxLoRAConfig(rank=4))


def _cfg():
    return PRESETS["tiny-test"].replace(dtype=torch.float32, lora=LoRAConfig(rank=4))


def _pair_batches(seed, n, batch=B):
    it = jax_pref.synthetic_preference_batches(batch, SEQ, 256, seed=seed)
    return [next(it) for _ in range(n)]


@pytest.fixture(scope="module")
def dpo_pair():
    """(JAX trainer, its state, frozen and lora numpy trees) for DPO."""
    jtrainer = JaxDPOTrainer(_jax_cfg(), JaxTrainConfig(task="dpo", **_train_kw()))
    state = jtrainer.init_state()
    frozen = _noisy(jax.device_get(state.frozen), 5)
    lora = _noisy(jax.device_get(state.trainable), 6)
    state = state.replace(frozen=frozen, trainable=lora, opt_state=jtrainer.tx.init(lora))
    return jtrainer, state, frozen, lora


def _port_dpo(frozen, lora, **kw):
    trainer = DPOTrainer(_cfg(), TrainConfig(task="dpo", **_train_kw(**kw)), device="cpu")
    trainer.model.load_state_dict(from_flax({**frozen, "lora": lora}, _cfg()))
    return trainer


def _captured_grads(trainer):
    """Wrap the optimizer so the next step's (averaged) gradients are kept."""
    grads = {}
    step = trainer.optimizer.step

    def capture(g):
        grads.update({k: v.clone() for k, v in g.items()})
        return step(g)

    trainer.optimizer.step = capture
    return grads


def _lora_tree(trainer, tensors):
    """Port tensors named like the trainer's trainable -> the flax lora tree."""
    state = {k: v.detach() for k, v in trainer.model.state_dict().items()}
    state.update(tensors)
    return to_flax(state, trainer.model_cfg)["lora"]


@pytest.mark.parametrize("accum", [1, 2])
def test_dpo_step_matches_reference(dpo_pair, accum):
    jtrainer, state, frozen, lora = dpo_pair
    batch = _pair_batches(21, 1)[0]
    if accum > 1:
        jtrainer = JaxDPOTrainer(_jax_cfg(), JaxTrainConfig(task="dpo",
                                                            **_train_kw(grad_accum_steps=accum)))
    _, want = jtrainer.step(state, dict(batch))
    trainer = _port_dpo(frozen, lora, grad_accum_steps=accum)
    got = trainer.step(dict(batch))
    keys = ("loss", "reward_margin", "dpo_accuracy", "accuracy", "reward_chosen",
            "reward_rejected", "policy_chosen_logprob", "policy_rejected_logprob",
            "learning_rate")
    for key in keys:
        np.testing.assert_allclose(got[key].item(), float(want[key]), rtol=1e-5, atol=1e-7,
                                   err_msg=key)
    # the norm of gradients that agree to 1e-4 of each leaf's max
    np.testing.assert_allclose(got["grad_norm"].item(), float(want["grad_norm"]), rtol=1e-3)


def test_dpo_gradients_match_jax_grad_and_accumulate(dpo_pair):
    jtrainer, state, frozen, lora = dpo_pair
    batch = _pair_batches(22, 1)[0]
    (_, _), want = jax.value_and_grad(jtrainer._loss_fn, has_aux=True)(
        lora, frozen, {k: jnp.asarray(v) for k, v in batch.items()}, None)
    grads = {}
    for accum in (1, 2):
        trainer = _port_dpo(frozen, lora, grad_accum_steps=accum)
        grads[accum] = _captured_grads(trainer)
        trainer.step(dict(batch))
    got = _lora_tree(trainer, grads[1])
    flat_want = dict(jax.tree_util.tree_leaves_with_path(want))
    flat_got = jax.tree_util.tree_leaves_with_path(got)
    assert len(flat_got) == len(flat_want) > 0
    for path, leaf in flat_got:
        assert _rel(leaf, flat_want[path]) < 1e-4, jax.tree_util.keystr(path)
    for name, g in grads[1].items():
        assert _rel(grads[2][name], g) < 1e-5, name


def test_dpo_evaluate_matches_reference(dpo_pair):
    jtrainer, state, frozen, lora = dpo_pair
    batches = _pair_batches(23, 2)
    want = jtrainer.evaluate(state, iter([dict(b) for b in batches]))
    got = _port_dpo(frozen, lora).evaluate(iter([dict(b) for b in batches]))
    for key in ("eval_loss", "eval_accuracy", "eval_reward_margin", "eval_dpo_accuracy",
                "eval_reward_chosen", "eval_policy_chosen_logprob"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-5, atol=1e-7, err_msg=key)


def test_reference_forward_is_the_adapterless_base(dpo_pair):
    """The adapter-off forward equals a rank-0 model on the same base, bit
    for bit, records no graph, and lets no gradient reach the adapters."""
    _, _, frozen, lora = dpo_pair
    trainer = _port_dpo(frozen, lora)
    batch = trainer._to_device(_pair_batches(24, 1)[0])
    rc, rr = trainer.reference_logprobs(batch)
    assert not rc.requires_grad and not rr.requires_grad
    base = LlamaForCausalLM(merged_config(_cfg()), device="cpu")
    base.load_state_dict({k: v for k, v in trainer.model.state_dict().items()
                          if not k.endswith((".lora_a", ".lora_b"))})
    tokens = torch.cat([batch["chosen_tokens"], batch["rejected_tokens"]])
    masks = torch.cat([batch["chosen_mask"], batch["rejected_mask"]])
    with torch.no_grad():
        want = losses.masked_sequence_logprobs(base(tokens), tokens, masks)
    assert torch.equal(torch.cat([rc, rr]), want)
    pc, _ = trainer._pair_logprobs(batch)
    assert not torch.equal(pc, rc)  # the adapters are back on
    with trainer.model.adapters_disabled():
        lp, _ = trainer._pair_logprobs(batch)  # gradients on, adapters off
    assert not lp.requires_grad  # nothing of it reaches a trained leaf


def test_adapters_disabled_keeps_the_int4_product():
    cfg = PRESETS["tiny-test"].replace(dtype=torch.float32, quantize_base=True,
                                       lora=LoRAConfig(rank=4))
    model = LlamaForCausalLM(cfg, device="cpu")
    from finetune_controller_tpu_torch.models.llama import init_random_

    init_random_(model, 3)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(".lora_b"):
                p.normal_(0.0, 0.5)
    tokens = torch.tensor([[1, 2, 3, 4, 5, 6]])
    with torch.no_grad():
        with model.adapters_disabled():
            off = model(tokens)
        on = model(tokens)
        for name, p in model.named_parameters():
            if name.endswith(".lora_b"):
                p.zero_()
        zero = model(tokens)
    assert torch.equal(off, zero) and not torch.equal(on, zero)


@pytest.fixture(scope="module")
def reward_pair():
    jtrainer = JaxRewardTrainer(_jax_cfg(), JaxTrainConfig(task="reward", **_train_kw()))
    state = jtrainer.init_state()
    frozen = _noisy(jax.device_get(state.frozen), 7)
    lora = _noisy(jax.device_get(state.trainable)["lora"], 8)
    rng = np.random.default_rng(9)
    head = {"a": np.asarray(0.8, np.float32),
            "w": (0.05 * rng.standard_normal(256)).astype(np.float32),
            "b": np.asarray(0.1, np.float32)}
    trainable = {"lora": lora, "head": head}
    state = state.replace(frozen=frozen, trainable=trainable,
                          opt_state=jtrainer.tx.init(trainable))
    return jtrainer, state, frozen, lora, head


def _port_reward(frozen, lora, head=None, **kw):
    trainer = RewardModelTrainer(_cfg(), TrainConfig(task="reward", **_train_kw(**kw)),
                                 device="cpu")
    trainer.model.load_state_dict(from_flax({**frozen, "lora": lora}, _cfg()))
    if head is not None:
        with torch.no_grad():
            for k, v in head.items():
                trainer.trainable[f"head.{k}"].copy_(torch.from_numpy(v))
    return trainer


def test_reward_step0_score_is_the_mean_completion_logprob(reward_pair):
    _, _, frozen, lora, _ = reward_pair
    trainer = _port_reward(frozen, lora)
    assert {k: tuple(v.shape) for k, v in trainer.head.items()} == {
        "a": (), "w": (256,), "b": ()}
    batch = trainer._to_device(_pair_batches(25, 1)[0])
    with torch.no_grad():
        scores = trainer.scores(batch)
        tokens = torch.cat([batch["chosen_tokens"], batch["rejected_tokens"]])
        masks = torch.cat([batch["chosen_mask"], batch["rejected_mask"]])
        total = losses.masked_sequence_logprobs(trainer.model(tokens), tokens, masks)
    assert _rel(scores, total / masks[:, 1:].sum(-1)) < 1e-6


def test_reward_step_and_head_gradients_match_reference(reward_pair):
    jtrainer, state, frozen, lora, head = reward_pair
    batch = _pair_batches(26, 1)[0]
    (_, _), want_grads = jax.value_and_grad(jtrainer._loss_fn, has_aux=True)(
        state.trainable, frozen, {k: jnp.asarray(v) for k, v in batch.items()}, None)
    _, want = jtrainer.step(state, dict(batch))
    trainer = _port_reward(frozen, lora, head)
    grads = _captured_grads(trainer)
    got = trainer.step(dict(batch))
    for key in ("loss", "reward_margin", "bt_accuracy", "accuracy", "score_chosen",
                "score_rejected"):
        np.testing.assert_allclose(got[key].item(), float(want[key]), rtol=1e-5, atol=1e-7,
                                   err_msg=key)
    np.testing.assert_allclose(got["grad_norm"].item(), float(want["grad_norm"]), rtol=1e-3)
    for k in ("a", "w"):
        assert _rel(grads[f"head.{k}"], want_grads["head"][k]) < 1e-4, k
    # b cancels in every margin: both gradients are f32 noise around 0
    assert abs(grads["head.b"].item()) < 1e-6 and abs(float(want_grads["head"]["b"])) < 1e-6


def test_reward_head_file_is_the_reference_bytes(reward_pair, tmp_path):
    jtrainer, state, frozen, lora, head = reward_pair
    (tmp_path / "jax").mkdir()
    jtrainer.export_artifacts(state, str(tmp_path / "jax"))
    trainer = _port_reward(frozen, lora, head)
    (tmp_path / "port").mkdir()
    trainer.export_artifacts(str(tmp_path / "port"))
    want = (tmp_path / "jax" / REWARD_HEAD_FILENAME).read_bytes()
    assert (tmp_path / "port" / REWARD_HEAD_FILENAME).read_bytes() == want
    back = read_reward_head(str(tmp_path / "port"))
    for k, v in head.items():
        assert torch.equal(back[k], torch.from_numpy(v))


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------


def _message(fn):
    with pytest.raises((ValueError, NotImplementedError)) as info:
        fn()
    return type(info.value), str(info.value)


@pytest.mark.parametrize("trainer,case", [
    ("dpo", "full"), ("dpo", "moe"), ("dpo", "multimodal"), ("dpo", "beta"),
    ("reward", "full"), ("reward", "moe"), ("reward", "multimodal")])
def test_construction_refusals_match_reference(trainer, case):
    port_cls, jax_cls = ((DPOTrainer, JaxDPOTrainer) if trainer == "dpo"
                         else (RewardModelTrainer, JaxRewardTrainer))
    kw = dict(task=trainer if trainer == "dpo" else "reward")
    kw.update({"full": {"mode": "full"}, "beta": {"dpo_beta": 0.0}}.get(case, {}))
    port_cfg = {"moe": PRESETS["tiny-moe-test"], "multimodal": MM_PRESETS["tiny-mm-test"]
                }.get(case, PRESETS["tiny-test"]).replace(lora=LoRAConfig(rank=4))
    jax_cfg = {"moe": JAX_PRESETS["tiny-moe-test"], "multimodal": JAX_MM_PRESETS["tiny-mm-test"]
               }.get(case, JAX_PRESETS["tiny-test"]).replace(lora=JaxLoRAConfig(rank=4))
    got = _message(lambda: port_cls(port_cfg, TrainConfig(**kw), device="cpu"))
    want = _message(lambda: jax_cls(jax_cfg, JaxTrainConfig(**kw)))
    assert got == want


def test_disaggregated_rollout_plane_is_refused():
    """The rollout plane is ported (``tests/test_torch_rollout_plane.py``):
    an rlhf learner with remote workers constructs, in remote mode (prefetch
    and asynchronous commits kept), as the JAX learner does."""
    cfg = TrainConfig(task="rlhf", rollout_workers=2, prefetch=2)
    trainer = DPOTrainer(_cfg(), cfg, device="cpu")
    assert (cfg.prefetch, trainer._blocking_checkpoints) == (2, False)
    jcfg = JaxTrainConfig(task="rlhf", rollout_workers=2, prefetch=2)
    jtrainer = JaxDPOTrainer(JAX_PRESETS["tiny-test"].replace(lora=JaxLoRAConfig(rank=4)), jcfg)
    assert (jcfg.prefetch, jtrainer._blocking_checkpoints) == (2, False)


# ---------------------------------------------------------------------------
# flax's msgpack format
# ---------------------------------------------------------------------------


def test_msgpack_head_bytes_equal_flax(reward_pair):
    head = reward_pair[4]
    assert flax_msgpack.serialize(head) == serialization.msgpack_serialize(head)
    assert flax_msgpack.serialize({k: torch.from_numpy(v) for k, v in head.items()}) == \
        serialization.msgpack_serialize(head)


def _nested_tree():
    rng = np.random.default_rng(15)
    return {
        "params": {"blocks": {"kernel": rng.standard_normal((3, 70, 40)).astype(np.float32),
                              "scale": np.ones((3, 40), np.float16)},
                   "ids": np.arange(300, dtype=np.int64)},
        "step": 70000, "neg": [-1, -33, -200, -70000, -2**40, 2**40, 200, 40000],
        "lr": 1.5e-4, "name": "x" * 40, "flags": [True, False, None],
        "opt": {str(i): np.float32(i) for i in range(17)},
        "empty": np.zeros((0, 3), np.uint8),
    }


def test_msgpack_nested_tree_bytes_equal_flax():
    tree = _nested_tree()
    assert flax_msgpack.serialize(tree) == serialization.msgpack_serialize(tree)


def test_msgpack_restores_flax_bytes():
    tree = _nested_tree()
    data = serialization.msgpack_serialize(tree)
    got, want = flax_msgpack.restore(data), serialization.msgpack_restore(data)
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
    for x, y in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        assert type(x) is type(y)
        np.testing.assert_array_equal(x, y)
        if isinstance(y, (np.ndarray, np.generic)):
            assert x.dtype == y.dtype
    bf16 = {"k": np.asarray(jnp.arange(6, dtype=jnp.bfloat16).reshape(2, 3))}
    back = flax_msgpack.restore(serialization.msgpack_serialize(bf16))["k"]
    assert back.dtype == torch.bfloat16
    assert torch.equal(back, torch.arange(6, dtype=torch.bfloat16).reshape(2, 3))
