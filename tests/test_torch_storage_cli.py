"""The port's pod-side storage CLI (``controller/storage_cli.py``) against
the reference's, on the local store and on S3.

``get`` of one object and ``sync SRC URI`` (one shot, and ``--interval
--until-done-file`` as the pod's sidecar runs it, with files and the done
file appearing while it runs) leave the same keys and the same bytes in
the reference's store and the port's: a local root each, then the
reference's signature-checking fake S3 (``tests/test_s3.py``) each, the
store chosen by the same ``FTC_*`` settings.  A missing object makes
``get`` raise ``FileNotFoundError`` in both packages.  The port's sync
also leaves a checkpoint's uncommitted staging out, where the reference's
ships it (the divergence ROADMAP Queue C item 5 records).  Tolerance:
exact, on keys and bytes.
"""

from __future__ import annotations

import asyncio
import os
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest
from aiohttp.test_utils import TestServer

from finetune_controller_tpu.controller import config as ref_config
from finetune_controller_tpu.controller import storage_cli as ref_cli
from finetune_controller_tpu_torch.controller import config as port_config
from finetune_controller_tpu_torch.controller import storage_cli as port_cli
from test_s3 import ACCESS, REGION, SECRET, make_fake_s3

ROOT = Path(__file__).resolve().parents[1]
PACKAGES = {"ref": ("finetune_controller_tpu", ref_cli, ref_config),
            "port": ("finetune_controller_tpu_torch", port_cli, port_config)}
FILES = {"metrics.csv": b"step,loss\n1,2.0\n", "checkpoints/step_2/state.pt": os.urandom(70000),
         "adapter/adapter_config.json": b'{"r": 4}', "logs.txt": b"line\n" * 100}


class _FakeS3:
    """The reference's fake S3 on its own event-loop thread."""

    def __init__(self):
        self.app, self.blobs, self.seen = make_fake_s3(page_size=1000)
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever, daemon=True)
        self.thread.start()
        self.server = TestServer(self.app)
        asyncio.run_coroutine_threadsafe(self.server.start_server(), self.loop).result(30)
        self.endpoint = str(self.server.make_url("")).rstrip("/")

    def close(self):
        asyncio.run_coroutine_threadsafe(self.server.close(), self.loop).result(30)
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(10)
        self.loop.close()


def _tree(root: Path) -> dict[str, bytes]:
    return {p.relative_to(root).as_posix(): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


def _env(backend: str, where: str) -> dict[str, str]:
    if backend == "local":
        return {"FTC_OBJECT_STORE_BACKEND": "local", "FTC_OBJECT_STORE_ROOT": where}
    return {"FTC_OBJECT_STORE_BACKEND": "s3", "FTC_S3_ENDPOINT": where,
            "FTC_S3_REGION": REGION, "AWS_ACCESS_KEY_ID": ACCESS,
            "AWS_SECRET_ACCESS_KEY": SECRET}


def _in_process(pkg: str, env: dict, argv: list[str], monkeypatch) -> int:
    _, cli, config = PACKAGES[pkg]
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    config.set_settings(None)
    try:
        return cli.main(argv)
    finally:
        config.set_settings(None)


def _put(pkg: str, env: dict, uri: str, data: bytes, monkeypatch) -> None:
    _, _, config = PACKAGES[pkg]
    objectstore = __import__(f"{PACKAGES[pkg][0]}.controller.objectstore",
                             fromlist=["build_object_store"])
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    config.set_settings(None)

    async def go():
        store = objectstore.build_object_store(config.get_settings())
        try:
            await store.put_bytes(uri, data)
        finally:
            await store.close()

    asyncio.run(go())
    config.set_settings(None)


def _sidecar(pkg: str, env: dict, src: Path, uri: str) -> int:
    """``sync --interval 0.1 --until-done-file`` as a subprocess; files and
    then ``done.txt`` appear while it runs."""
    proc = subprocess.Popen(
        [sys.executable, "-m", f"{PACKAGES[pkg][0]}.controller.storage_cli", "sync", str(src),
         uri, "--interval", "0.1", "--until-done-file", str(src / "done.txt")],
        env={**os.environ, **env, "PYTHONPATH": str(ROOT), "JAX_PLATFORMS": "cpu"},
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
    try:
        time.sleep(0.5)
        assert proc.poll() is None, proc.stderr.read()
        (src / "late.bin").write_bytes(b"late" * 1000)
        (src / "metrics.csv").write_bytes(b"step,loss\n1,2.0\n2,1.0\n")
        time.sleep(0.5)
        (src / "done.txt").write_text("done")
        return proc.wait(timeout=30)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def _run_both(tmp_path, backend: str, monkeypatch) -> dict:
    fakes, out = {}, {}
    try:
        for pkg in PACKAGES:
            work = tmp_path / pkg
            src = work / "artifacts"
            for rel, data in FILES.items():
                (src / rel).parent.mkdir(parents=True, exist_ok=True)
                (src / rel).write_bytes(data)
            if backend == "local":
                where = str(work / "objects")
            else:
                fakes[pkg] = _FakeS3()
                where = fakes[pkg].endpoint
            env = _env(backend, where)
            _put(pkg, env, "obj://datasets/u/d/train.jsonl", b'{"text": "hi"}\n' * 50,
                 monkeypatch)
            rc_get = _in_process(pkg, env, ["get", "obj://datasets/u/d/train.jsonl",
                                            str(work / "fetched" / "train.jsonl")], monkeypatch)
            rc_once = _in_process(pkg, env, ["sync", str(src), "obj://artifacts/u/j1"],
                                  monkeypatch)
            rc_sidecar = _sidecar(pkg, env, src, "obj://artifacts/u/j2")
            keys = (_tree(work / "objects") if backend == "local"
                    else {f"{b}/{k}": v for (b, k), v in fakes[pkg].blobs.items()})
            out[pkg] = {"rcs": (rc_get, rc_once, rc_sidecar),
                        "fetched": (work / "fetched" / "train.jsonl").read_bytes(),
                        "keys": keys}
    finally:
        for fake in fakes.values():
            fake.close()
    return out


@pytest.mark.parametrize("backend", ["local", "s3"])
def test_get_and_sync_leave_the_reference_keys_and_bytes(tmp_path, backend, monkeypatch):
    out = _run_both(tmp_path, backend, monkeypatch)
    assert out["port"] == out["ref"]
    ref = out["ref"]
    assert ref["rcs"] == (0, 0, 0)
    assert ref["fetched"] == b'{"text": "hi"}\n' * 50
    sidecar = {k.split("j2/", 1)[1]: v for k, v in ref["keys"].items() if "/j2/" in k}
    assert sidecar == {**FILES, "metrics.csv": b"step,loss\n1,2.0\n2,1.0\n",
                       "late.bin": b"late" * 1000, "done.txt": b"done"}


def test_missing_object_fails_get(tmp_path, monkeypatch):
    env = _env("local", str(tmp_path / "objects"))
    for pkg in PACKAGES:
        with pytest.raises(FileNotFoundError):
            _in_process(pkg, env, ["get", "obj://datasets/none", str(tmp_path / pkg)],
                        monkeypatch)


def test_port_sync_leaves_checkpoint_staging_out(tmp_path, monkeypatch):
    src = tmp_path / "artifacts"
    (src / "checkpoints" / "step_4.tmp").mkdir(parents=True)
    (src / "checkpoints" / "step_4.tmp" / "state.pt").write_bytes(b"partial")
    (src / "metrics.csv").write_bytes(b"step\n1\n")
    (src / "profile").mkdir()
    (src / "profile" / "steps_2-4.pt.trace.json.tmp").write_bytes(b'{"traceEv')
    trees = {}
    for pkg in PACKAGES:
        env = _env("local", str(tmp_path / f"objects_{pkg}"))
        assert _in_process(pkg, env, ["sync", str(src), "obj://artifacts/j"], monkeypatch) == 0
        trees[pkg] = sorted(_tree(tmp_path / f"objects_{pkg}"))
    assert trees["port"] == ["artifacts/j/metrics.csv"]
    assert trees["ref"] == ["artifacts/j/checkpoints/step_4.tmp/state.pt",
                            "artifacts/j/metrics.csv",
                            "artifacts/j/profile/steps_2-4.pt.trace.json.tmp"]


def test_sidecar_leaves_in_flight_atomic_writes_out(tmp_path):
    """A write still in flight (the profiler's trace, ``metrics.csv`` and
    ``heartbeat.json`` go to ``<name>.tmp`` and are renamed) is not
    shipped: on S3 a shipped ``.tmp`` would stay beside the file it became
    (the local store's listing hides ``.tmp`` names, S3's does not).  The
    sidecar's S3 prefix ends equal to the directory."""
    fake = _FakeS3()
    try:
        src = tmp_path / "artifacts"
        (src / "profile").mkdir(parents=True)
        (src / "profile" / "steps_2-4.pt.trace.json.tmp").write_bytes(b'{"traceEv')
        (src / "metrics.csv.tmp").write_bytes(b"step,loss\n1,")
        env = _env("s3", fake.endpoint)
        proc = subprocess.Popen(
            [sys.executable, "-m", "finetune_controller_tpu_torch.controller.storage_cli",
             "sync", str(src), "obj://artifacts/j", "--interval", "0.1",
             "--until-done-file", str(src / "done.txt")],
            env={**os.environ, **env, "PYTHONPATH": str(ROOT)},
            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
        time.sleep(0.8)
        os.replace(src / "profile" / "steps_2-4.pt.trace.json.tmp",
                   src / "profile" / "steps_2-4.pt.trace.json")
        os.replace(src / "metrics.csv.tmp", src / "metrics.csv")
        (src / "done.txt").write_text("done")
        assert proc.wait(timeout=30) == 0
        assert {k: v for (b, k), v in fake.blobs.items()} == {
            f"j/{rel}": data for rel, data in _tree(src).items()}
    finally:
        fake.close()


@pytest.mark.parametrize("pkg", ["port", "ref"])
def test_sigterm_mid_interval_runs_the_final_sync(tmp_path, pkg):
    """The kubelet SIGTERMs a native sidecar when the trainer container
    exits; the sidecar is then most likely asleep between two passes.  The
    port's ``sync --until-done-file`` makes its final pass on SIGTERM and
    exits 0, so the trainer's last files and ``done.txt`` reach the store;
    the reference's dies on the signal and loses them (the divergence
    ROADMAP Queue C records).  Tolerance: exact, on keys and bytes."""
    src = tmp_path / "artifacts"
    src.mkdir()
    (src / "metrics.csv").write_bytes(b"step,loss\n1,2.0\n")
    objects = tmp_path / "objects"
    proc = subprocess.Popen(
        [sys.executable, "-m", f"{PACKAGES[pkg][0]}.controller.storage_cli", "sync",
         str(src), "obj://artifacts/j", "--interval", "60", "--until-done-file",
         str(src / "done.txt")],
        env={**os.environ, **_env("local", str(objects)), "PYTHONPATH": str(ROOT),
             "JAX_PLATFORMS": "cpu"},
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
    try:
        first = objects / "artifacts" / "j" / "metrics.csv"
        deadline = time.time() + 60
        while not first.exists():  # the first pass is done; the sidecar sleeps
            assert proc.poll() is None and time.time() < deadline, proc.stderr.read()
            time.sleep(0.05)
        time.sleep(0.3)
        last = {"metrics.csv": b"step,loss\n1,2.0\n2,1.0\n",
                "adapter/adapter_model.safetensors": os.urandom(5000), "done.txt": b""}
        for rel, data in last.items():
            (src / rel).parent.mkdir(parents=True, exist_ok=True)
            (src / rel).write_bytes(data)
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=30)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    stored = {k.split("j/", 1)[1]: v for k, v in _tree(objects).items()}
    if pkg == "port":
        assert rc == 0
        assert stored == last
    else:
        assert rc == -signal.SIGTERM
        assert stored == {"metrics.csv": b"step,loss\n1,2.0\n"}
