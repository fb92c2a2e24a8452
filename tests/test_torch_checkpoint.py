"""The port's checkpoint contract (``train/checkpoint.py``,
``train/elastic.py``) against the reference's.

* the constructor sweeps the stale staging of both packages (the
  reference's three ``_TMP_RE`` patterns and the port's earlier
  ``.step_N.tmp-<pid>``);
* ``restore(like=)`` and ``Trainer.load_state`` raise
  ``CheckpointShapeError`` with the reference's message for a missing, an
  extra and a ``(1, n)``-for-``(m, n)`` leaf (a LoRA rank changed to 1
  between runs), before anything is copied;
* saves are asynchronous: ``wait()`` re-raises a background write error
  and a read waits for the save in flight;
* every committed step holds a ``manifest.json`` with the reference's keys
  whose leaves match the trainer's state; a manifest-less step restores;
* a step in orbax's OCDBT layout, written by the JAX package's own
  ``CheckpointManager`` after 2 steps of the JAX trainer, restores in the
  port with every leaf bit-equal to the JAX package's own ``restore`` of
  it, and the port's resume gives the JAX package's own resumed losses
  (the msgpack test's tolerance); a tree of a bf16 leaf, scalars and an
  all-zero array reads bit-equal; a flipped byte in a B-tree node is
  refused naming the CRC-32C; the OCDBT reader holds every key of a deep
  tensorstore-written tree (interior nodes, hundreds of versions) and reads
  zarr arrays of several chunks, the missing ones filled, as tensorstore
  reads them; the
  committed fixture ``tests/fixtures/jax_orbax_tiny`` still restores to
  what the JAX package's ``restore`` gives and resumes to its recorded
  losses;
* a ``state.msgpack`` the JAX package's ``_save_msgpack`` writes after 2
  steps of the JAX trainer (``tiny-test`` LoRA, f32, scanned layers, with
  its manifest) resumes in the port: the restored Adam moments equal the
  JAX state's bit for bit, and the next 2 losses and the moments after them
  match the JAX trainer's steps 3-4 within ``tests/test_torch_train.py``'s
  tolerances (loss rtol 2e-5; moments, like the trained leaves there,
  atol 1e-3 of their scale: ``mu`` atol 1e-3·max|mu|, ``nu`` atol
  1e-3·max|nu|).
"""

from __future__ import annotations

import asyncio
import csv
import json
import os
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_train import SEQ, _noisy, _packed_batches

from finetune_controller_tpu.models.llama import PRESETS as JAX_PRESETS
from finetune_controller_tpu.models.lora import LoRAConfig as JaxLoRAConfig
from finetune_controller_tpu.train.checkpoint import CheckpointManager as JaxCheckpointManager
from finetune_controller_tpu.train.elastic import build_manifest as jax_build_manifest
from finetune_controller_tpu.train.trainer import TrainConfig as JaxTrainConfig
from finetune_controller_tpu.train.trainer import Trainer as JaxTrainer
from finetune_controller_tpu_torch.controller.objectstore import LocalObjectStore, build_uri
from finetune_controller_tpu_torch.controller.specs import BaseFineTuneJob
from finetune_controller_tpu_torch.controller.syncer import STAGING_RE, sync_dir_to_store
from finetune_controller_tpu_torch.models.convert import from_flax
from finetune_controller_tpu_torch.models.llama import PRESETS
from finetune_controller_tpu_torch.models.lora import LoRAConfig
from finetune_controller_tpu_torch.train import checkpoint as ckpt_mod
from finetune_controller_tpu_torch.train.checkpoint import (
    CheckpointManager,
    CheckpointShapeError,
)
from finetune_controller_tpu_torch.train.elastic import leaf_entries
from finetune_controller_tpu_torch.train.trainer import TrainConfig, Trainer

torch.set_num_threads(1)

TRAIN_KW = dict(mode="lora", learning_rate=0.01, warmup_steps=1, batch_size=4, seq_len=SEQ,
                prefetch=0, log_every=1, heartbeat_interval_s=0)


def _trainer(rank: int = 4, **kw) -> Trainer:
    cfg = PRESETS["tiny-test"].replace(dtype=torch.float32, lora=LoRAConfig(rank=rank))
    return Trainer(cfg, TrainConfig(**{**TRAIN_KW, "total_steps": 4, **kw}), device="cpu")


def test_init_sweeps_stale_staging_of_both_packages(tmp_path):
    root = tmp_path / "checkpoints"
    for name in ("step_3.tmp", "step_5.orbax-checkpoint-tmp-1712345678", ".step_6.tmp-4242",
                 "step_2"):
        (root / name).mkdir(parents=True)
        (root / name / "state.pt").write_bytes(b"partial")
    (root / "step_4.manifest.tmp").write_text("{")
    (root / "notes.txt").write_text("not staging")
    CheckpointManager(root)
    assert sorted(p.name for p in root.iterdir()) == ["notes.txt", "step_2"]


def test_artifact_sync_ships_no_checkpoint_staging(tmp_path):
    """A sync tick during a save must not copy the staging: the copy would
    stay in the object store as a partial checkpoint after the rename (or
    the sweep, when the save was killed)."""
    art = tmp_path / "artifacts"
    names = ("step_3.tmp", "step_5.orbax-checkpoint-tmp-1712345678", ".step_6.tmp-4242",
             "step_2")
    for name in names:
        (art / "checkpoints" / name).mkdir(parents=True)
        (art / "checkpoints" / name / "state.pt").write_bytes(b"partial")
    (art / "checkpoints" / "step_4.manifest.tmp").write_text("{")
    (art / "metrics.csv").write_text("step,loss\n1,2.0\n")
    store = LocalObjectStore(tmp_path / "store")
    n = asyncio.run(sync_dir_to_store(store, art, build_uri("bucket", "job"),
                                      patterns=list(BaseFineTuneJob.store_asset_patterns)))
    shipped = sorted(p.relative_to(tmp_path / "store" / "bucket" / "job").as_posix()
                     for p in (tmp_path / "store").rglob("*") if p.is_file())
    assert n == 2 and shipped == ["checkpoints/step_2/state.pt", "metrics.csv"]
    # the syncer skips the staging names the checkpoint sweep removes, and
    # any other write still in flight (``<name>.tmp``, renamed when whole)
    for name in names + ("step_4.manifest.tmp", "step_12", "step_x.tmp", "notes.txt",
                         "metrics.csv.tmp"):
        assert bool(STAGING_RE.match(name)) == bool(
            ckpt_mod._TMP_RE.match(name) or name.endswith(".tmp")), name


def _state(trainer: Trainer) -> dict:
    return trainer.state_dict()


@pytest.mark.parametrize("case", ["missing", "extra", "rank1"])
def test_shape_mismatch_raises_before_any_copy(case, tmp_path):
    """A ``(1, n)`` lora_b into an ``(m, n)`` parameter: ``copy_`` broadcasts
    it silently; the check refuses it, naming the leaf and both shapes."""
    live = _trainer(rank=4)
    before = {k: v.detach().clone() for k, v in live.trainable.items()}
    state = _state(_trainer(rank=1) if case == "rank1" else _trainer(rank=4))
    name = "layers.0.attn.q_proj.lora_b"
    if case == "missing":
        del state["trainable"][name]
        want = (f"'trainable/{name}': checkpoint has <missing>, restore template has "
                "shape (4, 64)")
    elif case == "extra":
        state["trainable"]["layers.9.attn.q_proj.lora_b"] = torch.zeros(4, 64)
        want = ("'trainable/layers.9.attn.q_proj.lora_b': checkpoint has shape (4, 64), "
                "restore template has <missing>")
    else:
        # the first leaf in path order: the optimizer's moment of it
        want = ("'opt_state/mu/layers.0.attn.k_proj.lora_a': checkpoint has shape (64, 1), "
                "restore template has shape (64, 4)")
    with pytest.raises(CheckpointShapeError) as info:
        live.load_state(state)
    assert want in str(info.value) and "wrong model config or training mode" in str(info.value)
    for k, v in live.trainable.items():
        assert torch.equal(v, before[k]), k
    # the same through the manager, against the manifest and then the state
    mgr = CheckpointManager(tmp_path / "ck")
    mgr.save(2, state, blocking=True,
             manifest=live._build_manifest(2, state) if case == "rank1" else None)
    with pytest.raises(CheckpointShapeError, match=want.split(":")[0]):
        mgr.restore(2, like=live._state_tree())


def test_fit_with_a_changed_rank_refuses_the_checkpoint(tmp_path):
    batches = _packed_batches(7, 4, 4)
    _trainer(rank=4, total_steps=2, checkpoint_every=2).fit(batches, str(tmp_path))
    with pytest.raises(CheckpointShapeError, match="lora_a"):
        _trainer(rank=1, total_steps=4, checkpoint_every=2).fit(batches, str(tmp_path))


def test_wait_reraises_a_background_write_error(tmp_path, monkeypatch):
    def failing_save(obj, f):
        raise OSError("No space left on device")

    mgr = CheckpointManager(tmp_path)
    monkeypatch.setattr(ckpt_mod.torch, "save", failing_save)
    mgr.save(2, {"step": 2})  # returns: the write runs on the writer thread
    with pytest.raises(RuntimeError, match="background checkpoint save failed: No space"):
        mgr.wait()
    assert mgr.steps() == [] and not (tmp_path / "step_2").exists()


def test_reads_wait_for_the_save_in_flight(tmp_path, monkeypatch):
    release = threading.Event()
    real_write = CheckpointManager._write

    def slow_write(self, final, state, manifest):
        release.wait(10)
        real_write(self, final, state, manifest)

    monkeypatch.setattr(CheckpointManager, "_write", slow_write)
    mgr = CheckpointManager(tmp_path)
    t0 = time.perf_counter()
    mgr.save(2, {"step": 2, "trainable": {}, "opt_state": {}})
    assert time.perf_counter() - t0 < 1.0 and not (tmp_path / "step_2").exists()
    threading.Timer(0.3, release.set).start()
    assert mgr.latest_step() == 2  # waited for the commit
    assert mgr.restore(2)["step"] == 2


def _rows(path) -> list[dict]:
    with open(path) as f:
        return list(csv.DictReader(f))


def test_every_committed_step_has_a_manifest_and_legacy_steps_restore(tmp_path):
    trainer = _trainer(total_steps=4, checkpoint_every=2)
    trainer.fit(_packed_batches(7, 4, 4), str(tmp_path))
    root = tmp_path / "checkpoints"
    assert sorted(p.name for p in root.iterdir()) == ["step_2", "step_4"]
    ref_keys = set(jax_build_manifest(
        step=0, mesh_axes={"dp": 1}, rule_fingerprint="x", global_batch_size=4,
        grad_accum_steps=1, seq_len=SEQ, seed=0, host_tree={}))
    want_leaves = leaf_entries(trainer._state_tree())
    for step in (2, 4):
        manifest = json.loads((root / f"step_{step}" / "manifest.json").read_text())
        assert set(manifest) == ref_keys and manifest["step"] == step
        assert manifest["mesh_axes"] == {"dp": 1, "fsdp": 1, "ep": 1, "pp": 1, "sp": 1, "tp": 1}
        assert {k: v["shape"] for k, v in manifest["leaves"].items()} == \
            {k: v["shape"] for k, v in want_leaves.items()}
    os.remove(root / "step_4" / "manifest.json")
    state = CheckpointManager(root).restore(4, like=trainer._state_tree())
    for name, p in trainer.trainable.items():
        assert torch.equal(state["trainable"][name], p.detach())


def test_a_jax_msgpack_checkpoint_resumes_in_the_port(tmp_path):
    train_kw = {**TRAIN_KW, "total_steps": 4, "checkpoint_every": 100}
    jcfg = JAX_PRESETS["tiny-test"].replace(dtype=jnp.float32, lora=JaxLoRAConfig(rank=4))
    jtrainer = JaxTrainer(jcfg, JaxTrainConfig(**train_kw))
    state = jtrainer.init_state()
    frozen = _noisy(jax.device_get(state.frozen), 5)
    trainable = _noisy(jax.device_get(state.trainable), 6)
    state = state.replace(frozen=frozen, trainable=trainable,
                          opt_state=jtrainer.tx.init(trainable))
    batches = _packed_batches(7, 4, 4)
    want_loss = []
    for i, batch in enumerate(batches):
        state, metrics = jtrainer.step(state, dict(batch))
        want_loss.append(float(metrics["loss"]))
        if i == 1:
            host = jtrainer.state_to_host(state)
            path = tmp_path / "checkpoints" / "step_2"
            path.parent.mkdir()
            JaxCheckpointManager._save_msgpack(str(path), host,
                                               jtrainer._build_manifest(2, host))
            adam2 = host["opt_state"][1][0]
    assert sorted(os.listdir(path)) == ["manifest.json", "state.msgpack"]
    adam4 = jax.device_get(state.opt_state[1][0])

    cfg = PRESETS["tiny-test"].replace(dtype=torch.float32, lora=LoRAConfig(rank=4))
    trainer = Trainer(cfg, TrainConfig(**train_kw), device="cpu")
    trainer.model.load_state_dict(from_flax({**frozen, "lora": trainable}, cfg))
    restored = CheckpointManager(tmp_path / "checkpoints").restore(
        2, like=trainer._state_tree())
    assert restored["step"] == 2 and restored["opt_state"]["count"] == 2
    for which, tree in (("mu", adam2.mu), ("nu", adam2.nu)):
        got = {k: v.numpy() for k, v in restored["opt_state"][which].items()}
        assert got["layers.1.mlp.down_proj.lora_b"].shape == (4, 64)
        np.testing.assert_array_equal(got["layers.1.mlp.down_proj.lora_b"],
                                      np.asarray(tree["blocks"]["block"]["mlp"]["down_proj"]
                                                 ["lora_b"])[1])

    trainer.fit(batches, str(tmp_path))
    rows = _rows(tmp_path / "metrics.csv")
    assert [r["step"] for r in rows] == ["3", "4"]
    np.testing.assert_allclose([float(r["loss"]) for r in rows], want_loss[2:], rtol=2e-5)
    from finetune_controller_tpu_torch.models.convert import flat_paths, trainable_from_flax

    for which in ("mu", "nu"):
        want = trainable_from_flax(flat_paths(getattr(adam4, which)))
        got = trainer.optimizer.state_dict()[which]
        assert want.keys() == got.keys()
        scale = max(float(np.abs(np.asarray(v)).max()) for v in want.values())
        for k, v in want.items():
            np.testing.assert_allclose(got[k].numpy(), np.asarray(v), rtol=0,
                                       atol=1e-3 * scale, err_msg=f"{which} {k}")


def _leaves(tree, prefix="") -> dict:
    """Flat {path: numpy array or None} of a restored tree: sequences as
    string-indexed dicts, bf16 tensors as their bits."""
    if isinstance(tree, (list, tuple)):
        tree = {str(i): v for i, v in enumerate(tree)}
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}/{k}"))
        return out
    if isinstance(tree, torch.Tensor):
        return {prefix: ("bfloat16", tree.view(torch.int16).numpy())}
    if tree is None:
        return {prefix: None}
    arr = np.asarray(tree)
    if arr.dtype.name == "bfloat16":
        return {prefix: ("bfloat16", arr.view(np.int16))}
    return {prefix: (arr.dtype.name, arr)}


def _assert_bit_equal(got, want) -> None:
    got, want = _leaves(got), _leaves(want)
    assert got.keys() == want.keys()
    for path, value in want.items():
        if value is None:
            assert got[path] is None, path
            continue
        assert got[path][0] == value[0], path
        np.testing.assert_array_equal(got[path][1], value[1], err_msg=path)
        assert got[path][1].shape == value[1].shape, path


def _jax_orbax_run(tmp_path):
    """The JAX trainer 2 steps, saved by the JAX ``CheckpointManager``
    (orbax); then the JAX package's own resume through its ``restore`` for
    steps 3-4.  Returns (frozen, trainable at init, batches, losses 3-4)."""
    train_kw = {**TRAIN_KW, "total_steps": 4, "checkpoint_every": 100}
    jcfg = JAX_PRESETS["tiny-test"].replace(dtype=jnp.float32, lora=JaxLoRAConfig(rank=4))
    jtrainer = JaxTrainer(jcfg, JaxTrainConfig(**train_kw))
    init = jtrainer.init_state()
    frozen = _noisy(jax.device_get(init.frozen), 5)
    trainable = _noisy(jax.device_get(init.trainable), 6)
    fresh = init.replace(frozen=frozen, trainable=trainable,
                         opt_state=jtrainer.tx.init(trainable))
    state = fresh
    batches = _packed_batches(7, 4, 4)
    for batch in batches[:2]:
        state, _ = jtrainer.step(state, dict(batch))
    host = jtrainer.state_to_host(state)
    JaxCheckpointManager(str(tmp_path / "checkpoints")).save(
        2, host, blocking=True, manifest=jtrainer._build_manifest(2, host))
    restored = JaxCheckpointManager(str(tmp_path / "checkpoints")).restore(
        2, like=jtrainer.state_to_host(fresh))
    state = fresh.replace(step=jnp.asarray(restored["step"], jnp.int32),
                          trainable=restored["trainable"], opt_state=restored["opt_state"])
    losses = []
    for batch in batches[2:]:
        state, metrics = jtrainer.step(state, dict(batch))
        losses.append(float(metrics["loss"]))
    return frozen, trainable, batches, losses


def test_a_jax_orbax_checkpoint_resumes_in_the_port(tmp_path):
    """Every leaf bit-equal to the JAX package's own ``restore``; the port's
    resumed losses equal the JAX package's own resume within the msgpack
    test's tolerance (rtol 2e-5)."""
    from finetune_controller_tpu_torch.train.ocdbt import read_orbax_tree

    frozen, trainable, batches, want_loss = _jax_orbax_run(tmp_path)
    step_dir = tmp_path / "checkpoints" / "step_2"
    assert (step_dir / "manifest.ocdbt").exists() and not (step_dir / "state.msgpack").exists()
    _assert_bit_equal(read_orbax_tree(step_dir),
                      JaxCheckpointManager(str(tmp_path / "checkpoints")).restore(2))

    cfg = PRESETS["tiny-test"].replace(dtype=torch.float32, lora=LoRAConfig(rank=4))
    trainer = Trainer(cfg, TrainConfig(**{**TRAIN_KW, "total_steps": 4,
                                          "checkpoint_every": 100}), device="cpu")
    trainer.model.load_state_dict(from_flax({**frozen, "lora": trainable}, cfg))
    ckpt = CheckpointManager(tmp_path / "checkpoints")
    assert ckpt.layout(2) == "orbax"
    restored = ckpt.restore(2, like=trainer._state_tree())
    assert restored["step"] == 2 and restored["opt_state"]["count"] == 2
    trainer.fit(batches, str(tmp_path))
    rows = _rows(tmp_path / "metrics.csv")
    assert [r["step"] for r in rows] == ["3", "4"]
    np.testing.assert_allclose([float(r["loss"]) for r in rows], want_loss, rtol=2e-5)


def test_an_orbax_tree_of_bf16_scalar_and_zero_leaves_reads_bit_equal(tmp_path):
    from finetune_controller_tpu_torch.train.ocdbt import read_orbax_tree

    rng = np.random.default_rng(3)
    tree = {"step": np.int32(9), "scale": np.float32(2.5),
            "w": jnp.asarray(rng.standard_normal((33, 17)), jnp.bfloat16),
            "z": np.zeros((4, 5), np.float32), "n": {"i": np.arange(7, dtype=np.int32),
                                                     "u": np.arange(3, dtype=np.uint32)},
            "h": rng.standard_normal((6,)).astype(np.float16)}
    JaxCheckpointManager(str(tmp_path)).save(9, tree, blocking=True)
    got = read_orbax_tree(tmp_path / "step_9")
    _assert_bit_equal(got, JaxCheckpointManager(str(tmp_path)).restore(9))
    assert got["w"].dtype == torch.bfloat16 and not got["z"].any() and got["scale"] == 2.5


def test_a_flipped_byte_in_a_btree_node_is_refused_naming_the_crc(tmp_path):
    from finetune_controller_tpu_torch.train.ocdbt import OcdbtError, read_framed, read_orbax_tree

    JaxCheckpointManager(str(tmp_path)).save(
        1, {"w": np.arange(12, dtype=np.float32).reshape(3, 4)}, blocking=True)
    step = tmp_path / "step_1"
    nodes = [p for p in (step / "d").iterdir()]
    assert len(nodes) == 1 and read_framed(nodes[0].read_bytes(), 0x0CDB20DE, "node")
    data = bytearray(nodes[0].read_bytes())
    data[len(data) // 2] ^= 0x40
    nodes[0].write_bytes(bytes(data))
    with pytest.raises(OcdbtError, match="CRC-32C mismatch"):
        read_orbax_tree(step)


def test_the_ocdbt_reader_holds_every_key_of_a_deep_tensorstore_tree(tmp_path):
    """Small nodes and inline limits force interior nodes (keys stored
    under their subtree's common prefix), indirect values in several
    ``d/`` files and a version tree of hundreds of generations."""
    ts = pytest.importorskip("tensorstore")
    from finetune_controller_tpu_torch.train.ocdbt import KvStore

    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{tmp_path}/",
                          "config": {"max_decoded_node_bytes": 300, "max_inline_value_bytes": 16,
                                     "compression": {"id": "zstd"}}}).result()
    rng = np.random.default_rng(1)
    want = {}
    for i in range(240):
        key = f"layer_{i % 37}/param_{i}/chunk.{i * 7 % 13}"
        want[key] = rng.bytes(int(rng.integers(0, 60)))
        kv.write(key, want[key]).result()
    store = KvStore(tmp_path)
    assert store.manifest["height"] >= 2 and store.manifest["generation"] > 240
    assert store.keys() == sorted(want)
    for key, value in want.items():
        assert store.get(key) == value, key


@pytest.mark.parametrize("dtype", ["<f4", "bfloat16"])
def test_zarr_arrays_of_several_chunks_read_as_tensorstore_reads_them(tmp_path, dtype):
    """C-order chunks stitched at ragged edges, and the chunks never written
    filled with ``fill_value``, against tensorstore's own read."""
    ts = pytest.importorskip("tensorstore")
    from finetune_controller_tpu_torch.train.ocdbt import KvStore, read_array

    spec = {"driver": "zarr", "kvstore": {"driver": "ocdbt", "base": f"file://{tmp_path}/"},
            "path": "arr", "metadata": {"chunks": [4, 3], "compressor": {"id": "zstd",
                                                                      "level": 1},
                                        "dtype": dtype, "shape": [10, 7], "fill_value": 1.5}}
    arr = ts.open({**spec, "create": True}).result()
    values = np.random.default_rng(2).standard_normal((10, 7)).astype(np.float32)
    arr[:8, :5].write(values[:8, :5].astype(arr.dtype.numpy_dtype)).result()
    want = np.asarray(ts.open(spec).result().read().result()).astype(np.float32)
    store = KvStore(tmp_path)
    assert "arr/2.0" not in store.keys() and "arr/0.0" in store.keys()
    got = read_array(store, "arr")
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_array_equal(got, want)
    assert got[9, 6] == 1.5


FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "jax_orbax_tiny")


def test_the_committed_fixture_restores_to_the_jax_restore_and_resumes(tmp_path):
    """``tests/fixtures/jax_orbax_tiny`` (``make_jax_orbax_tiny.py``): both
    saves read bit-equal to the JAX package's ``restore``, and the port
    resumes step 2 to the JAX package's recorded losses (rtol 2e-5), as
    ``chip_smoke.py`` phase O does on the card."""
    import shutil

    from finetune_controller_tpu_torch.train.ocdbt import read_orbax_tree

    shutil.copytree(FIXTURE, tmp_path / "fx")
    fx = tmp_path / "fx"
    for root, step in (("checkpoints", 2), ("large", 0)):
        _assert_bit_equal(read_orbax_tree(fx / root / f"step_{step}"),
                          JaxCheckpointManager(str(fx / root)).restore(step))
    expected = json.loads((fx / "expected.json").read_text())
    cfg = PRESETS[expected["preset"]].replace(dtype=torch.float32,
                                              lora=LoRAConfig(rank=expected["lora_rank"]))
    trainer = Trainer(cfg, TrainConfig(**expected["train"]), device="cpu")
    base = np.load(fx / "base.npz")
    trainer.model.load_state_dict({k: torch.from_numpy(base[k]) for k in base.files})
    packed = np.load(fx / "batches.npz")
    batches = [{k.split("/", 1)[1]: packed[k] for k in packed.files if k.startswith(f"{i}/")}
               for i in range(expected["train"]["total_steps"])]
    art = tmp_path / "art"
    shutil.copytree(fx / "checkpoints", art / "checkpoints")
    trainer.fit(batches, str(art))
    rows = _rows(art / "metrics.csv")
    assert [int(r["step"]) for r in rows] == expected["resumed_steps"]
    np.testing.assert_allclose([float(r["loss"]) for r in rows], expected["losses"], rtol=2e-5)


@pytest.mark.cuda
def test_card_snapshot_reuses_pinned_buffers_and_waits_for_the_writer(tmp_path):
    """On a card a save's snapshot is copied into pinned buffers kept across
    saves, after the save in flight (whose writer reads them) commits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the snapshot buffers are pinned host memory")
    cfg = PRESETS["tiny-test"].replace(dtype=torch.float32, lora=LoRAConfig(rank=4))
    trainer = Trainer(cfg, TrainConfig(**{**TRAIN_KW, "total_steps": 4}), device="cuda")
    ckpt = CheckpointManager(tmp_path)
    first = trainer._checkpoint_state(ckpt)
    assert all(v.is_pinned() for v in first["trainable"].values())
    ptrs = {k: v.data_ptr() for k, v in first["trainable"].items()}
    ckpt.save(1, first)
    with torch.no_grad():
        for p in trainer.trainable.values():
            p.add_(1.0)
    second = trainer._checkpoint_state(ckpt)  # waits for step 1's writer
    assert ckpt._pending is None
    assert {k: v.data_ptr() for k, v in second["trainable"].items()} == ptrs
    live = trainer.state_dict()
    for k, v in second["trainable"].items():
        assert torch.equal(v, live["trainable"][k]), k
    saved = ckpt.restore(1)["trainable"]
    for k, v in saved.items():
        assert torch.equal(v + 1.0, live["trainable"][k]), k
