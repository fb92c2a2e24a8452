"""The port's LLaVA family (``models/multimodal.py`` and its data, HF I/O,
trainer, generation and controller paths) against the JAX package's.

Tiny presets only, f32 (the tower's compute dtype too), inputs made with
numpy from a seed, the same weights carried over by ``convert.from_flax``:

* the vision tower on ``tiny-mm-test`` (gelu, patch bias, final norm) and
  ``tiny-mm-clip-test`` (class token, pre-norm, quick-gelu,
  ``feature_layer=-2``): outputs within rel 1e-5 of the largest |output|;
* the whole model's logits with pixels, with and without ``segment_ids``,
  and text-only: within rel 1e-4 of the largest |logit|;
* the trainer's first step on the ``brightness`` task: loss within rel
  1e-5, the LoRA and projector gradients within rel 1e-4 of the largest
  |gradient| of each leaf; the trained set is the LoRA leaves and the
  projector, and no tower leaf gets a gradient;
* ``data/images.py`` and ``data/mm_loader.py``: the reference's batches bit
  for bit over a PNG path, NPY files, a data URI and bare base64; the LRU
  and both "no loss-counted tokens" refusals, word for word;
* HF I/O on a tiny checkpoint written by ``transformers``'
  ``LlavaForConditionalGeneration`` from a local config: the import equals
  the JAX import + ``from_flax`` bit for bit (``load_pretrained_`` too),
  the adapter and ``projector.safetensors`` equal the JAX exporter's;
* greedy ``cached_generate`` with pixels gives the uncached ``generate``'s
  tokens and the JAX ``cached_generate``'s; ``generate_cli --image`` runs
  on a tiny job's artifacts, and both of its refusals hold;
* ``tiny-mm-test-lora`` runs through the port's API to SUCCEEDED, and its
  ``/generate`` answers with the reference loader's refusal.
"""

from __future__ import annotations

import base64
import functools
import io
import json
import os
import sys

os.environ.setdefault("USE_TF", "0")  # transformers: skip the TensorFlow import

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from finetune_controller_tpu.data import mm_loader as jax_mm_loader  # noqa: E402
from finetune_controller_tpu.models import multimodal as jax_mm  # noqa: E402
from finetune_controller_tpu.models.lora import LoRAConfig as JaxLoRAConfig  # noqa: E402
from finetune_controller_tpu_torch.data import mm_loader  # noqa: E402
from finetune_controller_tpu_torch.data.synthetic import synthetic_batches  # noqa: E402
from finetune_controller_tpu_torch.models import multimodal as mm  # noqa: E402
from finetune_controller_tpu_torch.models.convert import from_flax, to_flax  # noqa: E402
from finetune_controller_tpu_torch.models.lora import LoRAConfig  # noqa: E402

torch.set_num_threads(1)

PRESETS = ("tiny-mm-test", "tiny-mm-clip-test")
SIZE = 16  # the tiny towers' image size


def _f32(cfg, dtypes, rank: int = 0, lora=None):
    """``cfg`` computing in f32 in the tower and the decoder."""
    cfg = cfg.replace(vision=cfg.vision.replace(dtype=dtypes.float32),
                      text=cfg.text.replace(dtype=dtypes.float32))
    return cfg.replace(lora=lora(rank=rank, alpha=8.0)) if rank else cfg


def _configs(preset: str, rank: int = 0):
    return (_f32(jax_mm.MM_PRESETS[preset], jnp, rank, JaxLoRAConfig),
            _f32(mm.MM_PRESETS[preset], torch, rank, LoRAConfig))


def _noisy(tree, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda x: np.asarray(0.1 + 0.3 * rng.standard_normal(np.shape(x)), np.float32), tree)


@functools.lru_cache(maxsize=None)
def _pair(preset: str, rank: int = 0, seed: int = 1):
    """(JAX model, its variables, port model) on the same noisy weights.
    The variables tree is the port's state through ``to_flax`` (which
    ``test_variables_round_trip_through_the_flax_tree`` holds to the flax
    tree), so no flax init runs."""
    jcfg, cfg = _configs(preset, rank)
    model = mm.LlavaForCausalLM(cfg, device="cpu")
    variables = _noisy(to_flax(model.state_dict(), cfg), seed)
    model.load_state_dict(from_flax(variables, cfg))
    return jax_mm.LlavaForCausalLM(jcfg), variables, model.eval()


def _inputs(seed: int, batch: int = 2, seq: int = 8):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (batch, seq)).astype(np.int32),
            rng.standard_normal((batch, SIZE, SIZE, 3)).astype(np.float32))


def _rel(got, want) -> float:
    want = np.asarray(want)
    return float(np.abs(np.asarray(got) - want).max() / np.abs(want).max())


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


def test_variables_round_trip_through_the_flax_tree():
    """``to_flax`` of the port's LLaVA state has flax's tree (structure,
    shapes) and ``from_flax`` inverts it exactly."""
    jcfg, cfg = _configs("tiny-mm-clip-test", rank=4)
    shapes = jax.eval_shape(lambda: jax_mm.LlavaForCausalLM(jcfg).init_variables(
        jax.random.PRNGKey(0)))
    _, variables, model = _pair("tiny-mm-clip-test", rank=4)
    assert (jax.tree.map(np.shape, variables)
            == jax.tree.map(lambda x: tuple(x.shape), dict(shapes)))
    back = from_flax(variables, cfg)
    assert all(torch.equal(back[k], v) for k, v in model.state_dict().items())


@pytest.mark.parametrize("preset", PRESETS)
def test_vision_tower_matches_reference(preset):
    jmodel, variables, model = _pair(preset)
    _, pixels = _inputs(2)
    jcfg = jmodel.cfg
    want = jax.jit(jax_mm.ViTEncoder(jcfg.vision).apply)(
        {"params": variables["params"]["vision_tower"]}, pixels)
    with torch.no_grad():
        got = model.vision_tower(torch.from_numpy(pixels))
    assert got.shape == (2, jcfg.vision.n_patches, jcfg.vision.d_model)
    assert _rel(got, want) <= 1e-5
    # feature_layer=-2 builds and runs n_layers - 1 blocks and no final norm
    n_run = jcfg.vision.n_layers - (1 if jcfg.vision.feature_layer == -2 else 0)
    assert len(model.vision_tower.blocks) == n_run
    assert hasattr(model.vision_tower, "final_norm") == (jcfg.vision.feature_layer == 0)


@pytest.mark.parametrize("case", ["pixels", "pixels+segments", "text only"])
def test_logits_match_reference(case):
    jmodel, variables, model = _pair("tiny-mm-clip-test", rank=4)
    tokens, pixels = _inputs(3)
    segments = np.array([[1, 1, 1, 2, 2, 2, 3, 3], [1, 1, 1, 1, 1, 2, 2, 0]], np.int32)
    kw, tkw = {}, {}
    if case != "text only":
        kw["pixels"], tkw["pixels"] = pixels, torch.from_numpy(pixels)
    if case == "pixels+segments":
        kw["segment_ids"], tkw["segment_ids"] = segments, torch.from_numpy(segments)
    want = jax.jit(jmodel.apply)(variables, tokens, **kw)
    with torch.no_grad():
        got = model(torch.from_numpy(tokens).long(), **tkw)
    assert got.shape == (2, 8, 256) and got.dtype == torch.float32
    assert _rel(got, want) <= 1e-4


def test_trainer_first_step_matches_reference():
    """The JAX trainer's loss function (its own split of the variables into
    the frozen base and the trained LoRA + projector) and the port trainer
    on the same weights and ``brightness`` batch: the loss, the gradients of
    the trained leaves and the first step's loss; the tower stays frozen."""
    from finetune_controller_tpu.train.trainer import TrainConfig as JaxTrainConfig
    from finetune_controller_tpu.train.trainer import Trainer as JaxTrainer
    from finetune_controller_tpu_torch.train.losses import next_token_loss
    from finetune_controller_tpu_torch.train.trainer import TrainConfig, Trainer

    jcfg, cfg = _configs("tiny-mm-clip-test", rank=4)
    train_kw = dict(mode="lora", learning_rate=0.01, warmup_steps=1, total_steps=2,
                    batch_size=4, seq_len=16, prefetch=0)
    _, variables, _ = _pair("tiny-mm-clip-test", rank=4)
    jtrainer = JaxTrainer(jcfg, JaxTrainConfig(**train_kw))
    frozen, trainable = jtrainer._split(dict(variables))
    assert set(trainable) == {"lora", "projector"}
    trainer = Trainer(cfg, TrainConfig(**train_kw), device="cpu")
    trainer.model.load_state_dict(from_flax(variables, cfg))
    batch = next(synthetic_batches(4, 16, 256, task="brightness", seed=3, image_size=SIZE))

    assert set(trainer.trainable) == {
        k for k in trainer.model.state_dict()
        if k.endswith((".lora_a", ".lora_b")) or k.startswith("projector_fc")}
    assert all(not p.requires_grad for k, p in trainer.model.named_parameters()
               if k.startswith("vision_tower."))

    (_, jaux), jgrads = jax.jit(jax.value_and_grad(jtrainer._loss_fn, has_aux=True))(
        trainable, frozen, dict(batch), jax.random.PRNGKey(0))
    host = trainer._host_batch(batch)
    loss, _ = next_token_loss(trainer._logits(host), host["tokens"], host["loss_mask"])
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jaux["loss"]), rtol=1e-5)
    got = to_flax({k: p.grad for k, p in trainer.trainable.items()}, cfg)
    flat_got = dict(jax.tree_util.tree_leaves_with_path(
        {"lora": got["lora"], "projector": {k: got["params"][k] for k in
                                            ("projector_fc1", "projector_fc2")}}))
    flat_want = dict(jax.tree_util.tree_leaves_with_path(jax.device_get(jgrads)))
    assert set(flat_got) == set(flat_want) and len(flat_got) > 0
    for path, leaf in flat_want.items():
        assert _rel(flat_got[path], leaf) <= 1e-4, jax.tree_util.keystr(path)
    assert all(p.grad is None for k, p in trainer.model.named_parameters()
               if k.startswith("vision_tower."))
    for p in trainer.trainable.values():
        p.grad = None
    metrics = trainer.step(dict(batch))
    np.testing.assert_allclose(metrics["loss"].item(), float(jaux["loss"]), rtol=1e-5)
    np.testing.assert_allclose(metrics["accuracy"].item(), float(jaux["accuracy"]), rtol=1e-5)


# ---------------------------------------------------------------------------
# the data path
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def images(tmp_path_factory):
    """A dataset of image-bearing rows over every reference form: a relative
    PNG path, an NPY file (float and uint8), a PNG data URI and bare base64
    of NPY bytes."""
    from PIL import Image

    tmp = tmp_path_factory.mktemp("images")
    rng = np.random.default_rng(1)
    img = rng.uniform(0, 255, (10, 12, 3)).astype(np.uint8)
    Image.fromarray(img).save(tmp / "a.png")
    np.save(tmp / "b.npy", img.astype(np.float32) / 255.0)
    np.save(tmp / "c.npy", rng.uniform(0, 255, (SIZE, SIZE, 3)).astype(np.uint8))
    png = io.BytesIO()
    Image.fromarray(img[:, ::-1]).save(png, format="PNG")
    npy = io.BytesIO()
    np.save(npy, rng.uniform(0, 1, (20, 9, 3)).astype(np.float32))
    rows = [
        {"image": "a.png", "prompt": "p: ", "completion": "done"},
        {"image": str(tmp / "b.npy"), "text": "plain lm row"},
        {"image": "c.npy", "prompt_tokens": [5, 6], "completion_tokens": [7, 8, 9]},
        {"image": "data:image/png;base64," + base64.b64encode(png.getvalue()).decode(),
         "messages": [{"role": "user", "content": "hi"},
                      {"role": "assistant", "content": "yo"}]},
        {"image": base64.b64encode(npy.getvalue()).decode(), "text": "bare base64"},
    ]
    path = tmp / "mm.jsonl"
    path.write_text("\n".join(json.dumps(r) for r in rows) + "\n")
    return tmp, path


def test_mm_batches_equal_the_reference_bit_for_bit(images):
    _, path = images
    for normalize in ("clip", "none"):
        got = mm_loader.mm_jsonl_batches(str(path), batch_size=3, seq_len=48, image_size=8,
                                         seed=4, normalize=normalize)
        want = jax_mm_loader.mm_jsonl_batches(str(path), batch_size=3, seq_len=48,
                                              image_size=8, seed=4, normalize=normalize)
        for _ in range(4):
            g, w = next(got), next(want)
            assert set(g) == set(w) == {"tokens", "loss_mask", "pixels"}
            for key in w:
                assert g[key].dtype == w[key].dtype and np.array_equal(g[key], w[key]), key


def test_mm_loader_refusals_and_lru_match_the_reference(images):
    tmp, _ = images
    cases = {
        "no image": {"text": "no image"},
        "empty completion": {"image": "c.npy", "prompt": "p: ", "completion": ""},
        "past seq_len": {"image": "c.npy", "prompt": "x" * 32, "completion": "y"},
    }
    for name, row in cases.items():
        path = tmp / f"{name.replace(' ', '_')}.jsonl"
        path.write_text(json.dumps(row) + "\n")
        errors = []
        for module in (mm_loader, jax_mm_loader):
            with pytest.raises(ValueError) as info:
                next(module.mm_jsonl_batches(str(path), batch_size=1, seq_len=16,
                                             image_size=8))
            errors.append(str(info.value))
        assert errors[0] == errors[1], name
    for module in (mm_loader, jax_mm_loader):
        cache = module.PixelCache(3)
        px = {k: np.full((2, 2, 3), k, np.float32) for k in range(5)}
        for k in (0, 1, 2):
            cache.put(k, px[k])
        assert cache.get(0) is px[0]  # 1 is now the least recently used
        cache.put(3, px[3])
        assert 1 not in cache and {0, 2, 3} <= {k for k in range(5) if k in cache}
        cache.put(2, px[2])
        cache.put(4, px[4])
        assert 0 not in cache and 2 in cache and len(cache) == 3
        off = module.PixelCache(0)
        off.put(1, px[1])
        assert len(off) == 0 and off.get(1) is None


# ---------------------------------------------------------------------------
# HF I/O
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def hf_llava(tmp_path_factory):
    """A tiny HF LLaVA checkpoint (``tiny-mm-clip-test``'s shapes) written by
    ``transformers`` from a local config, as the reference's test builds it."""
    from transformers import CLIPVisionConfig
    from transformers import LlamaConfig as HFLlamaConfig
    from transformers import LlavaConfig as HFLlavaConfig
    from transformers import LlavaForConditionalGeneration

    torch.manual_seed(0)
    hf_cfg = HFLlavaConfig(
        vision_config=CLIPVisionConfig(
            hidden_size=32, intermediate_size=64, num_hidden_layers=3,
            num_attention_heads=2, image_size=16, patch_size=8, hidden_act="quick_gelu"),
        text_config=HFLlamaConfig(
            vocab_size=256, hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, intermediate_size=128, max_position_embeddings=128,
            tie_word_embeddings=False),
        image_token_index=255, projector_hidden_act="gelu",
        vision_feature_layer=-2, vision_feature_select_strategy="default")
    ckpt = tmp_path_factory.mktemp("llava") / "hf"
    LlavaForConditionalGeneration(hf_cfg).save_pretrained(str(ckpt), safe_serialization=True)
    return ckpt


def test_llava_import_equals_jax_import_bit_for_bit(hf_llava):
    from finetune_controller_tpu.models.hf_import import load_llava_params as jax_load
    from finetune_controller_tpu_torch.models.hf_import import (
        load_llava_params,
        load_pretrained_,
    )

    jcfg, cfg = _configs("tiny-mm-clip-test")
    want = from_flax({"params": jax_load(hf_llava, jcfg)}, cfg)
    got = load_llava_params(hf_llava, cfg)
    assert set(got) == set(want)
    for key, value in want.items():
        assert got[key].dtype == value.dtype and torch.equal(got[key], value), key
    model = mm.LlavaForCausalLM(cfg, device="cpu")
    load_pretrained_(model, hf_llava)
    state = model.state_dict()
    for key, value in want.items():
        assert torch.equal(state[key], value), key


@pytest.mark.parametrize("case", ["missing vision tensor", "unmapped vision tensor",
                                  "missing projector tensor", "unmapped projector tensor"])
def test_llava_import_errors_match_the_reference_word_for_word(hf_llava, tmp_path, case):
    from safetensors.torch import load_file, save_file

    from finetune_controller_tpu.models.hf_import import load_llava_params as jax_load
    from finetune_controller_tpu_torch.models.hf_import import load_llava_params

    (shard,) = hf_llava.glob("*.safetensors")
    tensors = load_file(shard)
    vision = "vision_tower.vision_model."
    name = next(k for k in tensors if "multi_modal_projector" in k or vision in k)
    prefix = name[:name.index("multi_modal_projector" if "multi_modal_projector" in name
                              else vision)]  # "model." with transformers >= 4.52
    edit = {"missing vision tensor": ("drop", f"{prefix}{vision}encoder.layers.1.mlp.fc1.bias"),
            "unmapped vision tensor": ("add", f"{prefix}{vision}encoder.extra.weight"),
            "missing projector tensor": ("drop", f"{prefix}multi_modal_projector.linear_2.bias"),
            "unmapped projector tensor": ("add", f"{prefix}multi_modal_projector.linear_3.bias")}
    how, key = edit[case]
    if how == "drop":
        del tensors[key]
    else:
        tensors[key] = torch.zeros(4)
    save_file(tensors, tmp_path / "model.safetensors")
    jcfg, cfg = _configs("tiny-mm-clip-test")
    with pytest.raises(ValueError) as port_error:
        load_llava_params(tmp_path, cfg)
    with pytest.raises(ValueError) as jax_error:
        jax_load(tmp_path, jcfg)
    assert str(port_error.value) == str(jax_error.value)


def test_adapter_and_projector_exports_equal_jax(tmp_path):
    from safetensors.numpy import load_file

    from finetune_controller_tpu.models import hf_export as jax_export
    from finetune_controller_tpu_torch.models.hf_export import (
        export_lora_adapter,
        export_mm_projector,
    )

    jcfg, cfg = _configs("tiny-mm-clip-test", rank=4)
    _, variables, model = _pair("tiny-mm-clip-test", rank=4, seed=7)
    state = model.state_dict()
    prefix = "base_model.model.language_model.model.layers"
    export_lora_adapter(cfg.text, state, tmp_path / "port", hf_prefix=prefix)
    export_mm_projector(state, tmp_path / "port")
    jax_export.export_lora_adapter(jcfg.text, variables["lora"], tmp_path / "jax",
                                   hf_prefix=prefix)
    jax_export.export_mm_projector(
        {k: variables["params"][k] for k in ("projector_fc1", "projector_fc2")},
        tmp_path / "jax")
    for name in ("adapter_model.safetensors", "projector.safetensors"):
        got, want = load_file(tmp_path / "port" / name), load_file(tmp_path / "jax" / name)
        assert set(got) == set(want), name
        for key in want:
            assert got[key].dtype == want[key].dtype and np.array_equal(got[key], want[key])
    assert all(k.startswith(prefix + ".") for k in load_file(
        tmp_path / "port" / "adapter_model.safetensors"))
    assert (json.loads((tmp_path / "port" / "adapter_config.json").read_text())
            == json.loads((tmp_path / "jax" / "adapter_config.json").read_text()))


def test_exported_llava_adapter_loads_into_peft(hf_llava, tmp_path):
    """The trainer's LLaVA adapter (keys under the pre-4.52 layout
    ``base_model.model.language_model.model.layers``) loads with ``peft``
    into a ``LlavaForConditionalGeneration`` of ``transformers`` 4.57: every
    exported key lands on its module (``transformers`` maps the old layout),
    and the loaded model's text logits equal the port's within the HF
    parity tolerance of ``tests/test_torch_hf_io.py`` (llama: atol 2e-4,
    rtol 1e-3), while the adapter moves them well past it."""
    from peft import PeftModel
    from safetensors.torch import load_file
    from transformers import LlavaForConditionalGeneration

    from finetune_controller_tpu_torch.train.trainer import TrainConfig, Trainer

    _, cfg = _configs("tiny-mm-clip-test", rank=4)
    trainer = Trainer(cfg, TrainConfig(total_steps=1), device="cpu")
    trainer.load_pretrained(str(hf_llava))
    gen = torch.Generator().manual_seed(3)
    with torch.no_grad():
        for name, p in trainer.model.named_parameters():
            if name.endswith(("lora_a", "lora_b")):
                p.copy_(0.3 * torch.randn(p.shape, generator=gen))
    trainer.export_artifacts(str(tmp_path))
    exported = load_file(tmp_path / "adapter" / "adapter_model.safetensors")
    assert len(exported) == 2 * 7 * cfg.text.n_layers
    hf = LlavaForConditionalGeneration.from_pretrained(str(hf_llava)).eval()
    peft_model = PeftModel.from_pretrained(hf, str(tmp_path / "adapter")).eval()
    loaded = {n: t for n, t in peft_model.state_dict().items()
              if "language_model" in n and "lora_" in n}
    matched = 0
    for key, value in exported.items():
        rest = key.split("language_model.model.", 1)[1].replace(".weight", ".default.weight")
        hits = [n for n in loaded if n.endswith("language_model." + rest)]
        matched += len(hits) == 1 and torch.equal(loaded[hits[0]], value)
    assert matched == len(exported) == len(loaded)
    tokens = torch.tensor(np.random.default_rng(0).integers(0, 200, (2, 12)))
    with torch.no_grad():
        got = trainer.model.eval()(tokens).float().numpy()
        want = peft_model(input_ids=tokens).logits.float().numpy()
        with peft_model.disable_adapter():
            base = peft_model(input_ids=tokens).logits.float().numpy()
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-3)
    assert np.abs(base - want).max() > 100 * 2e-4


# ---------------------------------------------------------------------------
# generation
# ---------------------------------------------------------------------------


def test_cached_generation_matches_the_oracle_and_the_reference():
    from finetune_controller_tpu.models.generate import cached_generate as jax_cached
    from finetune_controller_tpu_torch.models.generate import cached_generate, generate

    jmodel, variables, model = _pair("tiny-mm-clip-test", rank=4, seed=9)
    tokens, pixels = _inputs(5, batch=2, seq=5)
    want = np.asarray(jax_cached(jmodel, variables, tokens, max_new_tokens=6, pixels=pixels))
    prompt, px = torch.from_numpy(tokens).long(), torch.from_numpy(pixels)
    cached = cached_generate(model, prompt, max_new_tokens=6, pixels=px)
    oracle = generate(model, prompt, max_new_tokens=6, pixels=px)
    assert torch.equal(cached, oracle)
    assert np.array_equal(cached.numpy(), want)
    for fn in (cached_generate, generate):
        with pytest.raises(ValueError, match="multimodal"):
            fn(model, prompt, max_new_tokens=2)


def test_generate_cli_with_an_image_and_its_refusals(tmp_path, capsys):
    from finetune_controller_tpu_torch.models import generate_cli
    from finetune_controller_tpu_torch.train import cli

    art = tmp_path / "art"
    cli.run_job({"model": {"preset": "tiny-mm-clip-test", "lora": {"rank": 2},
                           "overrides": {"dtype": "float32"}},
                 "training": {"total_steps": 2, "batch_size": 2, "seq_len": 16,
                              "log_every": 1, "checkpoint_every": 2, "prefetch": 0},
                 "artifacts_dir": str(art)}, "cpu")
    assert (art / "adapter" / "projector.safetensors").exists()
    np.save(tmp_path / "im.npy", np.random.default_rng(2).uniform(0, 1, (20, 24, 3)))
    outs = []
    for extra in ([], ["--oracle"]):
        assert generate_cli.main(["--artifacts", str(art), "--prompt-tokens", "0,9,17",
                                  "--image", str(tmp_path / "im.npy"),
                                  "--max-new-tokens", "4", "--device", "cpu"] + extra) == 0
        outs.append(json.loads(capsys.readouterr().out.strip().splitlines()[-1]))
    assert len(outs[0]["new_tokens"]) == 4 and outs[0] == outs[1]
    with pytest.raises(SystemExit, match="pass --image"):
        generate_cli.main(["--artifacts", str(art), "--prompt-tokens", "1",
                           "--device", "cpu"])
    text = tmp_path / "text"
    text.mkdir()
    (text / "resolved_config.json").write_text(json.dumps({"model": {"preset": "tiny-test"}}))
    with pytest.raises(SystemExit, match="--image given but the job's model is text-only"):
        generate_cli.main(["--artifacts", str(text), "--prompt-tokens", "1", "--image",
                           str(tmp_path / "im.npy"), "--device", "cpu"])


# ---------------------------------------------------------------------------
# the controller
# ---------------------------------------------------------------------------


def test_multimodal_job_through_the_api_and_generate_refused(tmp_path):
    from finetune_controller_tpu.serve import loader as jax_loader
    from test_torch_api import _runtime, _serve, _wait, http

    rt = _runtime("finetune_controller_tpu_torch", tmp_path, python=sys.executable,
                  device="cpu")
    served = _serve("finetune_controller_tpu_torch", rt)
    try:
        status, resp = http(served.base, "POST", "/jobs", {
            "model_name": "tiny-mm-test-lora", "device": "cpu-test",
            "arguments": {"total_steps": 3, "warmup_steps": 1, "batch_size": 2,
                          "seq_len": 16, "lora_rank": 2, "log_every": 1}})
        assert status == 200, resp
        job_id = resp["job_id"]
        job = _wait(served.base, job_id,
                    lambda j: j["status"] in ("succeeded", "failed", "cancelled"))
        assert job["status"] == "succeeded", http(served.base, "GET", f"/jobs/{job_id}/logs")
        records = http(served.base, "GET", f"/jobs/{job_id}/metrics")[1]["records"]
        assert [r["step"] for r in records] == [3, 2, 1]
        assert all(np.isfinite(r["loss"]) for r in records)
        assert http(served.base, "POST", f"/jobs/{job_id}/promote")[0] == 202
        _wait(served.base, job_id, lambda j: j["promotion_status"] == "completed")
        status, body = http(served.base, "POST", f"/jobs/{job_id}/generate",
                            {"tokens": [1, 2, 3], "max_new_tokens": 2})
    finally:
        served.close()
    spec = next((rt.settings.state_path / "sandboxes" / job_id).rglob("resolved_config.json"))
    with pytest.raises(jax_loader.ServeLoadError) as info:
        jax_loader.load_serving_model(spec.parent)
    assert status == info.value.status
    assert body == {"detail": str(info.value)}
