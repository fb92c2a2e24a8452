"""The PyTorch port stands alone: no JAX, no reference package.

Importing every module of ``finetune_controller_tpu_torch`` (and the
``chip_smoke.py`` script) in a fresh interpreter leaves ``jax``, ``flax``,
``aiohttp`` and ``finetune_controller_tpu`` out of ``sys.modules`` (and the
preference slice ``msgpack`` too) — checked in a
subprocess because this test process has JAX loaded already.  An AST scan
pins the same for every source file.  The reader of the JAX package's orbax
checkpoints restores one with no zstd package, tensorstore or orbax.  Entry points default to the CUDA card
and raise where there is none, unless the caller asks for the CPU.
"""

from __future__ import annotations

import ast
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "finetune_controller_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "finetune_controller_tpu", "aiohttp")
SOURCES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in FORBIDDEN


def test_import_leaves_jax_and_reference_out():
    code = (
        "import importlib, pkgutil, sys\n"
        "import finetune_controller_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in %r)\n"
        "print(len(names), bad)\n"
        "sys.exit(1 if bad or len(names) < 25 else 0)\n" % (FORBIDDEN,)
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_scan_covers_the_int4_and_moe_modules():
    """The int4 base and the experts are the port's own copies."""
    for name in ("models/quant.py", "models/moe.py"):
        assert PORT / name in SOURCES, name


def test_scan_covers_the_multimodal_modules():
    """The LLaVA model and its image data path are the port's own copies."""
    for name in ("models/multimodal.py", "data/images.py", "data/mm_loader.py"):
        assert PORT / name in SOURCES, name


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_source_imports_jax_or_reference(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [alias.name for alias in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        bad = [n for n in names if _forbidden(n)]
        assert not bad, f"{path.relative_to(ROOT)}:{node.lineno} imports {bad}"


def _resolved_imports(path: Path) -> list[tuple[int, str]]:
    """(line, absolute module) of every import in ``path``, relative ones
    resolved against the file's package."""
    package = list(path.relative_to(ROOT).with_suffix("").parts[:-1])
    found = []
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            found += [(node.lineno, alias.name) for alias in node.names]
        elif isinstance(node, ast.ImportFrom):
            base = package[:len(package) - node.level + 1] if node.level else []
            module = ".".join(base + ([node.module] if node.module else []))
            found += [(node.lineno, f"{module}.{alias.name}" if not node.module else module)
                      for alias in node.names]
    return found


TRAINING_SLICE = sorted(
    [PORT / "train" / f for f in ("cli.py", "trainer.py", "losses.py", "optimizer.py",
                                  "metrics.py", "checkpoint.py")]
    + [PORT / "data" / f for f in ("loader.py", "synthetic.py", "prefetch.py")]
    + [PORT / "ops" / "kernels" / "flash_attention.py"])


@pytest.mark.parametrize("path", TRAINING_SLICE, ids=lambda p: str(p.relative_to(ROOT)))
def test_training_slice_imports_resolve_inside_the_port(path):
    """Every import of the training slice, relative ones resolved (so
    ``from ...finetune_controller_tpu import x`` is caught too), stays out
    of JAX and the JAX package; ``train/cli.py`` is the CLI a job runs."""
    assert path.exists()
    for line, module in _resolved_imports(path):
        assert not _forbidden(module), f"{path.relative_to(ROOT)}:{line} imports {module}"


SERVING_SLICE = sorted(
    [PORT / "serve" / f for f in ("adapters.py", "engine.py", "fleet.py", "router.py",
                                  "loader.py", "batcher.py", "kv_pages.py", "prefix_cache.py",
                                  "__init__.py")]
    + [PORT / "resilience" / f for f in ("__init__.py", "policy.py", "faults.py")]
    + [PORT / "models" / f for f in ("lora.py", "llama.py", "convert.py", "generate.py")])


@pytest.mark.parametrize("path", SERVING_SLICE, ids=lambda p: str(p.relative_to(ROOT)))
def test_serving_slice_imports_resolve_inside_the_port(path):
    """The serving slice's modules (tenants, host tier, fleet, router,
    loader and the resilience copies), relative imports resolved, stay out
    of JAX, the JAX package and the packages the card machine lacks."""
    assert path.exists()
    for line, module in _resolved_imports(path):
        top = module.split(".")[0]
        assert not _forbidden(module) and top not in ("msgpack", "aiohttp"), \
            f"{path.relative_to(ROOT)}:{line} imports {module}"


HF_SLICE = sorted(
    [PORT / "models" / f for f in ("safetensors_io.py", "hf_import.py", "hf_export.py",
                                   "generate_cli.py")]
    + [PORT / "obs" / f for f in ("__init__.py", "events.py", "trace.py", "phase.py")]
    + [PORT / "resilience" / "heartbeat.py", PORT / "data" / "corpus.py",
       PORT / "fidelity.py"])
#: what the card machine lacks, or the port must not lean on: the HF slice
#: reads and writes safetensors itself
HF_FORBIDDEN = ("safetensors", "transformers", "peft", "msgpack", "aiohttp")


@pytest.mark.parametrize("path", HF_SLICE, ids=lambda p: str(p.relative_to(ROOT)))
def test_hf_slice_imports_resolve_inside_the_port(path):
    """The HF I/O, observability and fidelity modules, relative imports
    resolved, stay out of JAX, the JAX package, ``safetensors``,
    ``transformers``, ``peft``, ``msgpack`` and ``aiohttp``."""
    assert path.exists()
    for line, module in _resolved_imports(path):
        top = module.split(".")[0]
        assert not _forbidden(module) and top not in HF_FORBIDDEN, \
            f"{path.relative_to(ROOT)}:{line} imports {module}"


def test_hf_slice_loads_without_the_hf_packages():
    """Importing the HF slice in a fresh interpreter loads none of the
    packages it must do without."""
    code = (
        "import importlib, sys\n"
        "for name in %r:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in %r)\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    ) % ([".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
          for p in HF_SLICE], HF_FORBIDDEN + FORBIDDEN)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


CONTROL_SLICE = sorted(
    [p for p in (PORT / "controller").rglob("*.py")]
    + [PORT / "sched" / f for f in ("__init__.py", "queues.py", "preemption.py",
                                    "backfill.py", "fairshare.py")]
    + [PORT / "resilience" / "supervisor.py", PORT / "obs" / "prom.py",
       PORT / "serve" / "service.py"])
#: the control plane runs on the card machine: no aiohttp (its HTTP server is
#: ``controller/web.py``) and no msgpack
CONTROL_FORBIDDEN = ("aiohttp", "msgpack")


@pytest.mark.parametrize("path", CONTROL_SLICE, ids=lambda p: str(p.relative_to(ROOT)))
def test_control_slice_imports_resolve_inside_the_port(path):
    """The control plane's modules (controller, sched, supervisor, prom,
    the serve routes), relative imports resolved, stay out of JAX, the JAX
    package, ``aiohttp`` and ``msgpack``."""
    assert path.exists()
    for line, module in _resolved_imports(path):
        top = module.split(".")[0]
        assert not _forbidden(module) and top not in CONTROL_FORBIDDEN, \
            f"{path.relative_to(ROOT)}:{line} imports {module}"


def test_control_plane_loads_without_aiohttp():
    """Importing the port's server and every control-plane module in a fresh
    interpreter loads none of JAX, the JAX package, ``aiohttp`` or
    ``msgpack``."""
    code = (
        "import importlib, sys\n"
        "for name in %r:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in %r)\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    ) % (["finetune_controller_tpu_torch.controller.server"]
         + [".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
            for p in CONTROL_SLICE], CONTROL_FORBIDDEN + FORBIDDEN)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


PREFS_SLICE = sorted(
    [PORT / "prefs" / f for f in ("__init__.py", "losses.py", "rollout_buffer.py",
                                  "dpo_trainer.py", "reward_trainer.py", "actor.py",
                                  "learner.py")]
    + [PORT / "data" / "preference.py", PORT / "utils" / "__init__.py",
       PORT / "utils" / "flax_msgpack.py"])
#: the reward head's file is written without flax's or msgpack's packages
PREFS_FORBIDDEN = ("msgpack", "aiohttp")


def test_scan_covers_the_preference_modules():
    """The preference plane and its data and msgpack coder are the port's
    own copies, seen by the AST scan above."""
    for path in PREFS_SLICE:
        assert path in SOURCES, path


@pytest.mark.parametrize("path", PREFS_SLICE, ids=lambda p: str(p.relative_to(ROOT)))
def test_preference_slice_imports_resolve_inside_the_port(path):
    """The preference modules, relative imports resolved, stay out of JAX,
    flax, the JAX package (even its JAX-free ``data/preference.py`` and
    ``prefs/rollout_buffer.py``), ``msgpack`` and ``aiohttp``."""
    assert path.exists()
    for line, module in _resolved_imports(path):
        top = module.split(".")[0]
        assert not _forbidden(module) and top not in PREFS_FORBIDDEN, \
            f"{path.relative_to(ROOT)}:{line} imports {module}"


def test_preference_slice_loads_without_jax_flax_or_msgpack():
    """Importing the preference modules in a fresh interpreter loads none of
    JAX, flax, the JAX package, ``msgpack`` or ``aiohttp``."""
    code = (
        "import importlib, sys\n"
        "for name in %r:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in %r)\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    ) % ([".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
          for p in PREFS_SLICE], PREFS_FORBIDDEN + FORBIDDEN)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


RESILIENCE_SLICE = [PORT / name for name in (
    "resilience/faults.py", "resilience/__init__.py", "train/checkpoint.py",
    "train/elastic.py", "controller/ctl.py", "fidelity.py")]


@pytest.mark.parametrize("path", RESILIENCE_SLICE, ids=lambda p: str(p.relative_to(ROOT)))
def test_resilience_slice_imports_resolve_inside_the_port(path):
    """The chaos hook, the checkpoint contract (the JAX package's msgpack
    layout read with the port's own coder), the manifest, ``ftc-ctl`` and
    the fidelity proof's controller path stay out of JAX, flax, the JAX
    package, ``msgpack`` and ``aiohttp``."""
    assert path in SOURCES
    for line, module in _resolved_imports(path):
        top = module.split(".")[0]
        assert not _forbidden(module) and top not in PREFS_FORBIDDEN, \
            f"{path.relative_to(ROOT)}:{line} imports {module}"


def test_resilience_slice_loads_without_jax_flax_or_msgpack():
    """Importing the resilience modules and ``ftc-ctl`` in a fresh
    interpreter loads none of JAX, flax, the JAX package, ``msgpack`` or
    ``aiohttp``; ``ftc-ctl --help`` runs as a module."""
    code = (
        "import importlib, sys\n"
        "for name in %r:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in %r)\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    ) % ([".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
          for p in RESILIENCE_SLICE], PREFS_FORBIDDEN + FORBIDDEN)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    proc = subprocess.run([sys.executable, "-m", "finetune_controller_tpu_torch.controller.ctl",
                           "--help"], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and "dev-token" in proc.stdout, proc.stderr


def test_serving_entry_points_default_to_cuda(tmp_path):
    """The loader and a fleet's engines run on the card unless the caller
    passes the CPU: without a card the default raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    from finetune_controller_tpu_torch.serve.loader import load_serving_model

    (tmp_path / "checkpoints" / "step_1").mkdir(parents=True)
    (tmp_path / "resolved_config.json").write_text(
        '{"model": {"preset": "tiny-test", "lora": {"rank": 2}}, "training": {}}')
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_serving_model(tmp_path)


def test_entry_points_default_to_cuda():
    """Without ``device=`` the entry points ask for the card and raise where
    there is none; ``device="cpu"`` is honoured when given."""
    from finetune_controller_tpu_torch.device import resolve_device
    from finetune_controller_tpu_torch.models.llama import PRESETS, LlamaForCausalLM
    from finetune_controller_tpu_torch.models.lora import LoRAConfig

    assert resolve_device("cpu") == torch.device("cpu")
    assert LlamaForCausalLM(PRESETS["tiny-test"], device="cpu").device.type == "cpu"
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LlamaForCausalLM(PRESETS["tiny-test"])
    from finetune_controller_tpu_torch.train.trainer import TrainConfig, Trainer

    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(PRESETS["tiny-test"].replace(lora=LoRAConfig(rank=2)), TrainConfig())


def test_chip_smoke_refuses_without_a_card():
    """The script exits non-zero and prints no result line without CUDA."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


TRANSPORT_SLICE = sorted(
    [PORT / "transport" / f for f in ("__init__.py", "wire.py", "builders.py", "worker.py",
                                      "client.py", "process.py")]
    + [PORT / "train" / "warm_worker.py", PORT / "serve" / "adapters.py",
       PORT / "serve" / "fleet.py", PORT / "serve" / "service.py",
       PORT / "controller" / "backends" / "local.py"])
#: the transport speaks msgpack through the port's own coder
TRANSPORT_FORBIDDEN = ("msgpack", "aiohttp")


@pytest.mark.parametrize("path", TRANSPORT_SLICE, ids=lambda p: str(p.relative_to(ROOT)))
def test_transport_slice_imports_resolve_inside_the_port(path):
    """The worker-process transport, the warm trainer and the modules that
    drive them, relative imports resolved, stay out of JAX, flax, the JAX
    package (even its JAX-free ``transport/``), ``msgpack`` and
    ``aiohttp``."""
    assert path in SOURCES
    for line, module in _resolved_imports(path):
        top = module.split(".")[0]
        assert not _forbidden(module) and top not in TRANSPORT_FORBIDDEN, \
            f"{path.relative_to(ROOT)}:{line} imports {module}"


def test_transport_slice_loads_without_jax_flax_or_msgpack():
    """Importing the transport and warm-worker modules in a fresh
    interpreter loads none of JAX, flax, the JAX package, ``msgpack`` or
    ``aiohttp``; the worker's ``--help`` runs as a module."""
    code = (
        "import importlib, sys\n"
        "for name in %r:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in %r)\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    ) % ([".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
          for p in TRANSPORT_SLICE], TRANSPORT_FORBIDDEN + FORBIDDEN)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    proc = subprocess.run([sys.executable, "-m",
                           "finetune_controller_tpu_torch.transport.worker", "--help"],
                          cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and "--spec" in proc.stdout, proc.stderr


def test_worker_builders_default_to_cuda():
    """A worker's model builders run on the card unless the spec names the
    CPU: without a card the default raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    from finetune_controller_tpu_torch.transport.builders import tiny_test

    assert tiny_test(device="cpu").device.type == "cpu"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tiny_test()


#: the disaggregated rollout plane and the modules its lazy imports reach
ROLLOUT_SLICE = [PORT / "prefs" / "rollout_plane.py"]


def test_scan_covers_the_rollout_plane():
    for path in ROLLOUT_SLICE:
        assert path in SOURCES, path


@pytest.mark.parametrize("path", ROLLOUT_SLICE, ids=lambda p: str(p.relative_to(ROOT)))
def test_rollout_plane_imports_resolve_inside_the_port(path):
    """The rollout plane, relative and lazy imports resolved, stays out of
    JAX, flax, the JAX package (even its JAX-free ``prefs/rollout_plane.py``
    and ``resilience/policy.py``), ``msgpack`` and ``aiohttp``."""
    for line, module in _resolved_imports(path):
        top = module.split(".")[0]
        assert not _forbidden(module) and top not in TRANSPORT_FORBIDDEN, \
            f"{path.relative_to(ROOT)}:{line} imports {module}"


def test_rollout_plane_loads_without_jax_flax_or_msgpack():
    """Importing the rollout plane and every module its functions import
    (the worker, the client, the process transport, the builders, the
    checkpoint reader, the span recorder) in a fresh interpreter loads none
    of JAX, flax, the JAX package, ``msgpack`` or ``aiohttp``."""
    names = ["finetune_controller_tpu_torch.prefs.rollout_plane",
             "finetune_controller_tpu_torch.transport.worker",
             "finetune_controller_tpu_torch.transport.client",
             "finetune_controller_tpu_torch.transport.process",
             "finetune_controller_tpu_torch.transport.builders",
             "finetune_controller_tpu_torch.train.checkpoint",
             "finetune_controller_tpu_torch.train.cli",
             "finetune_controller_tpu_torch.obs.trace"]
    code = (
        "import importlib, sys\n"
        "for name in %r:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in %r)\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    ) % (names, TRANSPORT_FORBIDDEN + FORBIDDEN)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


#: the control plane's storage and streaming: the WebSocket, the stdlib HTTP
#: client, the stream logger, the S3 and GCS stores, the shared state
#: service and its daemon, the pod-side storage CLI and the monitor daemon
STORAGE_SLICE = [PORT / "controller" / f for f in (
    "web.py", "httpclient.py", "stream_logger.py", "objectstore.py", "s3.py", "gcs.py",
    "statestore_service.py", "statestore_main.py", "storage_cli.py", "monitor_main.py",
    "runtime.py", "server.py")]


def test_scan_covers_the_storage_and_streaming_modules():
    for path in STORAGE_SLICE:
        assert path in SOURCES and path in CONTROL_SLICE, path


@pytest.mark.parametrize("path", STORAGE_SLICE, ids=lambda p: str(p.relative_to(ROOT)))
def test_storage_slice_imports_resolve_inside_the_port(path):
    """The storage and streaming modules, relative and lazy imports
    resolved, stay out of JAX, flax, the JAX package (even its JAX-free
    ``controller/s3.py``, ``gcs.py`` and ``statestore_service.py``),
    ``aiohttp`` and ``msgpack``."""
    for line, module in _resolved_imports(path):
        top = module.split(".")[0]
        assert not _forbidden(module) and top not in CONTROL_FORBIDDEN, \
            f"{path.relative_to(ROOT)}:{line} imports {module}"


def test_storage_slice_loads_without_jax_flax_aiohttp_or_msgpack():
    """Importing the storage and streaming modules in a fresh interpreter,
    and building an S3 store, a GCS store and a remote state store's client
    from settings, loads none of JAX, flax, the JAX package, ``aiohttp`` or
    ``msgpack``."""
    names = [".".join(p.relative_to(ROOT).with_suffix("").parts) for p in STORAGE_SLICE]
    code = (
        "import importlib, sys\n"
        "for name in %r:\n"
        "    importlib.import_module(name)\n"
        "from finetune_controller_tpu_torch.controller.config import Settings\n"
        "from finetune_controller_tpu_torch.controller.objectstore import build_object_store\n"
        "from finetune_controller_tpu_torch.controller.statestore_service import RemoteStateStore\n"
        "for b in ('s3', 'gcs'):\n"
        "    build_object_store(Settings(object_store_backend=b))\n"
        "RemoteStateStore('http://127.0.0.1:1')\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in %r)\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    ) % (names, CONTROL_FORBIDDEN + FORBIDDEN)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_storage_entry_points_start_without_the_reference():
    """``statestore_main`` and ``storage_cli`` answer ``--help`` as modules
    of the port alone (``monitor_main`` is started in
    ``tests/test_torch_monitor_main.py``)."""
    for mod in ("statestore_main", "storage_cli"):
        proc = subprocess.run([sys.executable, "-m",
                               f"finetune_controller_tpu_torch.controller.{mod}", "--help"],
                              cwd=ROOT, capture_output=True, text=True, timeout=120)
        assert proc.returncode == 0 and "usage" in proc.stdout, proc.stdout + proc.stderr


#: reading the JAX package's orbax checkpoints: the OCDBT and zarr reader,
#: the plain zstd decoder and the checkpoint manager that calls them (the
#: card machine has no zstd package, tensorstore or orbax)
CHECKPOINT_SLICE = [PORT / "train" / "ocdbt.py", PORT / "utils" / "zstd.py",
                    PORT / "train" / "checkpoint.py", PORT / "ops" / "kernels" / "build.py"]
CHECKPOINT_FORBIDDEN = ("zstandard", "zstd", "tensorstore", "orbax", "msgpack")


@pytest.mark.parametrize("path", CHECKPOINT_SLICE, ids=lambda p: str(p.relative_to(ROOT)))
def test_checkpoint_reader_imports_resolve_inside_the_port(path):
    """The orbax reader's modules, relative and lazy imports resolved, stay
    out of JAX, flax, the JAX package, zstd packages, tensorstore, orbax and
    ``msgpack``."""
    assert path in SOURCES
    for line, module in _resolved_imports(path):
        top = module.split(".")[0]
        assert not _forbidden(module) and top not in CHECKPOINT_FORBIDDEN, \
            f"{path.relative_to(ROOT)}:{line} imports {module}"


def test_an_orbax_step_restores_without_jax_zstd_packages_or_tensorstore():
    """A fresh interpreter restores the committed orbax fixture through the
    port (the native decoder built with the host compiler) and loads none of
    JAX, flax, the JAX package, zstd packages, tensorstore, orbax or
    ``msgpack``."""
    if not any(shutil.which(c) for c in ("g++", "c++")):
        pytest.skip("no host C++ compiler to build the native zstd decoder")
    fixture = ROOT / "tests" / "fixtures" / "jax_orbax_tiny" / "checkpoints"
    code = (
        "import sys\n"
        "from finetune_controller_tpu_torch.train.checkpoint import CheckpointManager\n"
        "state = CheckpointManager(%r, sweep=False).restore(2)\n"
        "assert state['step'] == 2 and state['trainable'], state.keys()\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in %r)\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    ) % (str(fixture), CHECKPOINT_FORBIDDEN + FORBIDDEN)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
