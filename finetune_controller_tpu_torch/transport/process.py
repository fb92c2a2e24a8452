"""``ProcessTransport``: worker-process lifecycle on the local host
(counterpart of the reference's ``transport/process.py``).

One sandbox per replica under the transport root (the local backend's work
dir when the fleet is wired through a backend): the worker spec, the bound
socket's ``transport.json``, the heartbeat, and the process log live there —
the same sandbox shape the training backend gives trainer attempts, so
operators debug a serve worker exactly like a failed job attempt.

Spawn handshake::

    write spec.json → Popen(python -m …transport.worker --spec …)
        → poll for transport.json (bound port + pid)
        → connect + hello → RemoteReplica

bounded by ``serve_worker_spawn_timeout_s``; a worker that dies or stalls
during the handshake is killed and the log tail rides the raised error.

The spawn env is the parent's env (so ``CUDA_VISIBLE_DEVICES``, the
kernel build's ``CUDA_HOME``/``PATH`` and the chaos hand's
``FTC_FAULT_SERVE_*`` all cross the process boundary) plus per-worker
overrides.  Ports:
``serve_worker_port_base`` > 0 assigns ``base + n`` per spawn; 0 (default)
binds ephemeral ports and reads the bound port back from ``transport.json``
— collision-free on shared CI hosts.

A worker that dies during the handshake (it cannot load a kernel library,
or reach the card) fails the spawn with its log's tail; nothing falls back
to an in-process replica.
"""

from __future__ import annotations

import asyncio
import dataclasses
import itertools
import json
import logging
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Any

from . import TransportError, incr
from .client import RemoteReplica, _Connection
from .worker import TRANSPORT_FILENAME

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class ProcessTransport:
    """Spawns/kills serve worker sandboxes for one fleet."""

    job_id: str
    root: Path
    #: payload builder the workers reconstruct the model with
    #: (``transport/builders.py``): ``{"builder": name, "kwargs": {...}}``
    payload: dict[str, Any]
    port_base: int = 0
    spawn_timeout_s: float = 120.0
    heartbeat_interval_s: float = 2.0
    probe_timeout_s: float = 10.0
    extra_env: dict[str, str] = dataclasses.field(default_factory=dict)
    mode: str = "process"

    def __post_init__(self) -> None:
        self.root = Path(self.root)
        self._ports = itertools.count(self.port_base) \
            if self.port_base > 0 else None

    def set_payload(self, builder: str, kwargs: dict[str, Any]) -> None:
        """Swap the payload NEW spawns build (the rollover path: stage the
        new checkpoint, point the transport at it, then ``fleet.rollover``
        spins the next generation on it)."""
        self.payload = {"builder": builder, "kwargs": dict(kwargs)}

    def _spawn_env(self) -> dict[str, str]:
        # the parent's env: CUDA_VISIBLE_DEVICES (the card), CUDA_HOME and
        # PATH (the kernel build), FTC_TRANSPORT_CODEC and the chaos hand's
        # FTC_FAULT_SERVE_* cross the process boundary.  The kernels'
        # libraries live in build/torch_kernels/ beside the package
        # (ops/kernels/build.py), which the PYTHONPATH below also locates:
        # a worker loads what the parent built, and a build it must do
        # itself is atomic, so two workers that race do no harm
        env = dict(os.environ)
        # the worker runs `-m finetune_controller_tpu_torch.transport.worker`
        # from its sandbox cwd: make sure the package resolves even when this
        # process imported it off sys.path (source checkout, test run)
        import finetune_controller_tpu_torch as _pkg

        pkg_root = str(Path(_pkg.__file__).resolve().parent.parent)
        existing = env.get("PYTHONPATH", "")
        if pkg_root not in existing.split(os.pathsep):
            env["PYTHONPATH"] = (
                pkg_root + (os.pathsep + existing if existing else "")
            )
        env.update(self.extra_env)
        return env

    async def spawn(
        self,
        replica_id: str,
        generation: int,
        *,
        engine_config,
        batcher_kwargs: dict[str, Any],
        adapters=None,
        warm_start: bool = True,
        rollout: dict[str, Any] | None = None,
        reward: dict[str, Any] | None = None,
    ) -> RemoteReplica:
        """Spawn one worker sandbox and hand back its connected client; a
        ``rollout`` or ``reward`` section makes it a rollout or reward
        worker (``prefs/rollout_plane.py``)."""
        sandbox = self.root / f"{replica_id}-g{generation}"
        spec = {
            "job_id": self.job_id,
            "replica_id": replica_id,
            "sandbox": str(sandbox),
            "builder": self.payload["builder"],
            "builder_kwargs": self.payload.get("kwargs") or {},
            "engine": {
                **dataclasses.asdict(engine_config),
                "prompt_buckets": list(engine_config.prompt_buckets),
            },
            # callables (ttft observers) cannot cross the process boundary;
            # worker-side TTFT shows up through probe stats instead
            "batcher": {k: v for k, v in (batcher_kwargs or {}).items()
                        if not callable(v) and v is not None},
            "adapters": (
                {"capacity": adapters.capacity, "max_rank": adapters.max_rank}
                if adapters is not None else None
            ),
            "host": "127.0.0.1",
            "port": next(self._ports) if self._ports is not None else 0,
            "heartbeat_interval_s": self.heartbeat_interval_s,
            "warm_start": warm_start,
            "rollout": rollout,
            "reward": reward,
        }
        spec_path = sandbox / "worker_spec.json"
        log_path = sandbox / "worker.log"

        def stage() -> subprocess.Popen:
            sandbox.mkdir(parents=True, exist_ok=True)
            # a previous incarnation of this replica id (server restart,
            # same job) leaves its transport.json/heartbeat.json behind —
            # the handshake would read the STALE port and dial a dead
            # listener; scrub before the new worker exists
            for stale in ("transport.json", "heartbeat.json"):
                try:
                    os.unlink(sandbox / stale)
                except OSError:
                    pass
            with open(spec_path, "w") as f:
                json.dump(spec, f, indent=2)
            log_f = open(log_path, "ab")
            try:
                return subprocess.Popen(
                    [sys.executable, "-m",
                     "finetune_controller_tpu_torch.transport.worker",
                     "--spec", str(spec_path)],
                    stdout=log_f, stderr=subprocess.STDOUT,
                    stdin=subprocess.DEVNULL, cwd=str(sandbox),
                    env=self._spawn_env(), start_new_session=True,
                )
            finally:
                log_f.close()

        proc = await asyncio.to_thread(stage)
        incr("workers_spawned_total")
        try:
            replica = await self._handshake(
                replica_id, proc, sandbox, log_path
            )
        except BaseException:
            await asyncio.to_thread(self._kill, proc)
            raise
        logger.info(
            "serve worker %s spawned (job=%s gen=%d pid=%d port=%d)",
            replica_id, self.job_id, generation, replica.pid,
            replica.port,
        )
        return replica

    @staticmethod
    def _kill(proc: subprocess.Popen) -> None:
        try:
            proc.kill()
            proc.wait(timeout=5.0)
        except (ProcessLookupError, subprocess.TimeoutExpired, OSError):
            logger.debug("spawn-failure kill raced", exc_info=True)

    def _log_tail(self, log_path: Path, n: int = 30) -> str:
        try:
            lines = log_path.read_text(errors="replace").splitlines()
        except OSError:
            return ""
        return "\n".join(lines[-n:])

    async def _handshake(
        self, replica_id: str, proc: subprocess.Popen, sandbox: Path,
        log_path: Path,
    ) -> RemoteReplica:
        deadline = time.monotonic() + self.spawn_timeout_s
        doc: dict[str, Any] | None = None
        transport_file = sandbox / TRANSPORT_FILENAME
        while time.monotonic() < deadline:
            code = proc.poll()
            if code is not None:
                tail = await asyncio.to_thread(self._log_tail, log_path)
                raise TransportError(
                    f"serve worker {replica_id} exited with code {code} "
                    f"during spawn; log tail:\n{tail}"
                )
            doc = await asyncio.to_thread(self._read_transport_file,
                                          transport_file)
            # belt over the stage-time scrub: only THIS spawn's pid counts
            # — a stale file from a previous incarnation names a dead port
            if doc is not None and int(doc.get("pid") or -1) == proc.pid:
                break
            doc = None
            await asyncio.sleep(0.1)
        if doc is None:
            tail = await asyncio.to_thread(self._log_tail, log_path)
            raise TransportError(
                f"serve worker {replica_id} did not come up within "
                f"{self.spawn_timeout_s:.0f}s "
                f"(serve_worker_spawn_timeout_s); log tail:\n{tail}"
            )
        conn = await _Connection.open(
            doc.get("host", "127.0.0.1"), int(doc["port"]),
            timeout_s=max(5.0, deadline - time.monotonic()),
        )
        hello = await conn.call("hello", {}, timeout_s=30.0)
        replica = RemoteReplica(
            replica_id, conn, hello,
            proc=proc, sandbox=str(sandbox),
            heartbeat_interval_s=self.heartbeat_interval_s,
            probe_timeout_s=self.probe_timeout_s,
        )
        replica.port = int(doc["port"])
        return replica

    @staticmethod
    def _read_transport_file(path: Path) -> dict[str, Any] | None:
        try:
            with open(path) as f:
                doc = json.load(f)
        except (OSError, ValueError):
            return None
        return doc if isinstance(doc, dict) and "port" in doc else None
