"""Local process backend — the in-repo fake cluster.

Runs each job as a ``python -m finetune_controller_tpu_torch.train.cli`` subprocess
in a sandbox directory, reproducing the full pod lifecycle the reference gets
from Kubernetes (SURVEY.md §3.1 post-admission flow):

- **init container** (``aws s3 cp`` dataset download,
  ``PyTorchJobDeployer.py:70-91``) → async dataset staging from the object
  store into the sandbox before launch;
- **suspend-until-admitted** (Kueue, ``PyTorchJobDeployer.py:179-185``) → the
  in-repo :class:`~.scheduler.GangScheduler`;
- **artifact sidecar** (``aws s3 sync`` loop every 60 s, exit on ``done.txt``,
  ``PyTorchJobDeployer.py:121-168``) → an asyncio sync task copying
  ``store_asset_patterns`` matches to the object store;
- **restartPolicy OnFailure + backoffLimit 2** (``PyTorchJobDeployer.py:183,189``)
  → bounded restart loop with a ``Restarting`` state;
- **pod logs** (``stream_logger.py:204-284``) → a log file per job, tailed by
  :meth:`read_logs`;
- **pod events** (``kube_helpers.py:26-95``) → per-job event list.

It also carries what the reference lacks: deterministic fault injection for
elastic-recovery tests (SURVEY.md §5.3 gap).

The port's copy launches the port's trainer: a ``cuda`` flavor's job sees
only its granted card (``CUDA_VISIBLE_DEVICES``), a ``cpu`` flavor's job
gets ``--device cpu``.  With ``warm_workers > 0`` a job starts in a
pre-warmed trainer process (``train/warm_worker.py``) when one is free.
Such a process is spawned before any job exists, so it cannot inherit the
job's card: it keeps CUDA uninitialised until its request line has applied
the job's env (``CUDA_VISIBLE_DEVICES`` included), and the pool is keyed by
the runtime env without the card — one pool serves every card.
"""

from __future__ import annotations

import asyncio
import contextlib
import hashlib
import json
import logging
import os
import shlex
import sys
import time
from pathlib import Path
from typing import Any, AsyncIterator

from ...sched import FairShareScheduler
from ..devices import DeviceCatalog, DeviceFlavor, default_mesh_for
from ..objectstore import ObjectStore
from ..schemas import BackendJobReport, BackendJobState, JobInput
from ..specs import BaseFineTuneJob
from ..syncer import sync_dir_to_store
from .base import BackendError, TrainingBackend
from .scheduler import GangScheduler

logger = logging.getLogger(__name__)

#: per-job env a warm worker receives with its request line, never from the
#: pool's spawn env: the trace identity and the granted card
_REQUEST_ENV_KEYS = ("FTC_TRACE_ID", "FTC_ATTEMPT", "CUDA_VISIBLE_DEVICES")


class _JobHandle:
    """Mutable per-job state (the backend's 'pod')."""

    def __init__(self, job_id: str, sandbox: Path, artifacts_uri: str, patterns: list[str]):
        self.job_id = job_id
        self.sandbox = sandbox
        self.artifacts_dir = sandbox / "artifacts"
        self.logs_path = sandbox / "logs.txt"
        self.spec_path = sandbox / "job.json"
        self.artifacts_uri = artifacts_uri
        self.patterns = patterns
        self.state = BackendJobState.PENDING
        self.message = ""
        self.proc: asyncio.subprocess.Process | None = None
        self.run_task: asyncio.Task | None = None
        self.sync_task: asyncio.Task | None = None
        self.restarts = 0
        #: tenant queue + priority (sched/), echoed into reports/metadata
        self.queue = "default"
        self.priority: object = "normal"
        #: scheduler evicted this job: the run loop must NOT burn local
        #: restarts — it reports FAILED (exit 143) so the resilience
        #: supervisor requeues it with resume (docs/scheduling.md)
        self.preempted = False
        self.preempted_by = ""
        #: scheduler resize (docs/elasticity.md): the supervisor resubmits
        #: the job at this slice count instead of its current topology
        self.resize_to: int | None = None
        self.resize_kind = ""  # "shrink" | "grow" ("" = plain eviction)
        #: topology bookkeeping for elastic admission / resize re-renders
        self.requested_slices = 1
        self.granted_slices = 1
        #: the card granted on admission (cuda flavors), index into the
        #: host's visible cards
        self.card: int | None = None
        #: trace propagation (docs/observability.md): threaded into the
        #: trainer env as FTC_TRACE_ID / FTC_ATTEMPT on every (re)render
        self.trace_id = ""
        self.attempt = 1
        self.spec_obj: BaseFineTuneJob | None = None
        self.flavor_obj: DeviceFlavor | None = None
        self.dataset_path: str | None = None
        self.exit_code: int | None = None  # last attempt's exit code
        self.restored_checkpoints = 0  # files staged back from the store
        self.start_time: float | None = None
        self.completion_time: float | None = None
        self.events: list[dict[str, Any]] = []
        self.env: dict[str, str] = {}
        self.fault_kill_at_step: int | None = None
        self.cancelled = False
        #: path -> (mtime, size) at last successful upload (sync change detection)
        self.synced: dict[str, tuple[float, int]] = {}

    def event(self, reason: str, message: str = "") -> None:
        self.events.append({"ts": time.time(), "reason": reason, "message": message})

    def set_state(self, state: BackendJobState, message: str = "") -> None:
        if state is not self.state:
            self.event("StateChange", f"{self.state.value} -> {state.value}")
        self.state = state
        if message:
            self.message = message


class LocalProcessBackend(TrainingBackend):
    """Fake cluster: gang-scheduled subprocesses + artifact sync sidecars."""

    #: SIGTERM → SIGKILL escalation grace in :meth:`delete_job`
    term_grace_s: float = 5.0

    def __init__(
        self,
        root_dir: Path | str,
        object_store: ObjectStore,
        catalog: DeviceCatalog,
        *,
        sync_interval_s: float = 60.0,
        backoff_limit: int = 2,
        python: str | None = None,
        extra_env: dict[str, str] | None = None,
        warm_workers: int = 0,
        sched_policy: str = "fairshare",
        sched_queues: dict[str, float] | None = None,
        sched_resize: bool = True,
        sched_grow_delay_s: float = 60.0,
    ):
        self.root = Path(root_dir).expanduser()
        self.root.mkdir(parents=True, exist_ok=True)
        self.store = object_store
        self.catalog = catalog
        #: admission control (docs/scheduling.md): the multi-tenant
        #: fair-share scheduler by default; "fifo" is the legacy best-effort
        #: gang scheduler (no tenants, no preemption) kept as an escape hatch
        if sched_policy == "fifo":
            self.scheduler = GangScheduler(catalog)
        elif sched_policy == "fairshare":
            self.scheduler = FairShareScheduler(
                catalog, sched_queues,
                resize=sched_resize, grow_delay_s=sched_grow_delay_s,
            )
        else:
            raise ValueError(f"unknown sched_policy {sched_policy!r}")
        self.sync_interval_s = sync_interval_s
        self.backoff_limit = backoff_limit
        self.python = python or sys.executable
        self.extra_env = dict(extra_env or {})
        self._handles: dict[str, _JobHandle] = {}
        #: tombstone reports for jobs the backend lost before launch (the
        #: admitted-without-a-handle race): surfaced as FAILED so the retry
        #: supervisor classifies + resubmits instead of the DB job sitting
        #: QUEUED forever
        self._lost: dict[str, BackendJobReport] = {}
        self._closing = False
        #: pre-warmed trainer processes (``train/warm_worker.py``) kept per
        #: runtime env key; 0 = every attempt cold-spawns
        self.warm_workers = max(0, int(warm_workers))
        self._warm: dict[tuple, list[asyncio.subprocess.Process]] = {}
        #: cards in use, per flavor: card index -> job id (cuda flavors)
        self._cards: dict[str, dict[int, str]] = {}

    # ------------------------------------------------------------------ submit

    async def submit(
        self,
        job: JobInput,
        spec: BaseFineTuneJob,
        flavor: DeviceFlavor,
        *,
        dataset_uri: str | None,
        artifacts_uri: str,
    ) -> None:
        if job.job_id in self._handles:
            raise BackendError(f"job {job.job_id!r} already exists")
        sandbox = self.root / job.job_id
        handle = _JobHandle(job.job_id, sandbox, artifacts_uri, list(spec.store_asset_patterns))
        self._handles[job.job_id] = handle
        try:
            handle.artifacts_dir.mkdir(parents=True, exist_ok=True)

            # resume staging (resilience/supervisor.py resubmit contract):
            # if a previous attempt committed checkpoints to the object store
            # and this sandbox has none, pull them back down so the trainer's
            # resume path continues the run instead of restarting it
            await self._stage_resume_state(handle)

            # init-container equivalent: stage the dataset into the sandbox
            # (reference: aws s3 cp init container, PyTorchJobDeployer.py:70-91)
            dataset_path: str | None = None
            if dataset_uri:
                local = sandbox / "dataset" / Path(dataset_uri).name
                await self.store.get_file(dataset_uri, local)  # streamed, not buffered
                dataset_path = str(local)
                handle.event("DatasetStaged", dataset_uri)

            mesh = default_mesh_for(flavor, job.num_slices, policy=spec.mesh_policy)
            trainer_spec = spec.build_trainer_spec(
                job.job_id,
                str(handle.artifacts_dir),
                dataset_path=dataset_path,
                mesh=mesh,
            )
            await asyncio.to_thread(
                handle.spec_path.write_text, json.dumps(trainer_spec, indent=2)
            )

            handle.trace_id = job.trace_id
            handle.attempt = max(1, job.attempt)
            handle.env = self._runtime_env(flavor, job.num_slices)
            handle.env.update(self._obs_env(handle))

            handle.queue = job.queue
            handle.priority = job.priority
            # elastic-admission context (docs/elasticity.md): the scheduler
            # may grant FEWER slices than asked — the spec/env must then be
            # re-rendered at the granted topology before spawn
            handle.spec_obj = spec
            handle.flavor_obj = flavor
            handle.dataset_path = dataset_path
            handle.requested_slices = job.requested_num_slices or job.num_slices
            handle.granted_slices = job.num_slices
            self.scheduler.submit(
                job.job_id, flavor.name, job.num_slices,
                queue=job.queue, priority=job.priority,
                requested_slices=handle.requested_slices,
                # an atomic gang (RLHF actor+learner) must never run
                # partially: floor every shrink at the full gang size
                min_slices=(
                    job.num_slices if getattr(spec, "atomic_gang", False)
                    else 1
                ),
            )
            self._lost.pop(job.job_id, None)  # resubmit clears any tombstone
            handle.set_state(BackendJobState.SUSPENDED)
            handle.event(
                "Queued",
                f"flavor={flavor.name} slices={job.num_slices} "
                f"queue={job.queue} priority={job.priority}",
            )
        except BackendError:
            raise
        except Exception as exc:
            self.scheduler.release(job.job_id)
            self._handles.pop(job.job_id, None)
            raise BackendError(f"submit failed: {exc}") from exc
        # ftc: ignore[blocking-io-in-async-transitive] -- elastic re-render writes one small local spec on the rare granted<requested admission; the sync scheduler_tick hook shares this path so it cannot await
        self._admit_pending()

    async def _stage_resume_state(self, handle: _JobHandle) -> None:
        """Pull committed checkpoints (and the metrics history) back from the
        object store into a fresh sandbox — the controller half of elastic
        recovery (SURVEY.md §5.4): a resubmitted job must resume from the
        latest committed step even when its original sandbox is gone.

        Deliberately skips ``heartbeat.json`` (a stale heartbeat restored
        into a new attempt could trip the liveness lease) and ``done.txt``
        (only a SUCCEEDED attempt writes it).  No-op when the sandbox already
        has checkpoints (local restart — the fast path) or when the store has
        none (first attempt).
        """
        ckpt_dir = handle.artifacts_dir / "checkpoints"
        if ckpt_dir.is_dir() and any(ckpt_dir.iterdir()):
            return  # the sandbox survived; the trainer resumes from it as-is
        try:
            objs = await self.store.list_prefix(handle.artifacts_uri)
        except Exception:
            logger.exception(
                "resume staging: listing %s failed; job %s starts cold",
                handle.artifacts_uri, handle.job_id,
            )
            return
        prefix = handle.artifacts_uri.rstrip("/") + "/"
        n = 0
        for obj in objs:
            uri = obj["uri"]
            if not uri.startswith(prefix):
                continue
            rel = uri[len(prefix):]
            if not (
                rel.startswith("checkpoints/")
                or rel == "metrics.csv"
                # observability continuity (docs/observability.md): the
                # trainer APPENDS to events.jsonl / trace/trainer.jsonl, and
                # the monitor's ingest watermark is the line index — a fresh
                # sandbox must carry the prior attempts' lines or the synced
                # file would shrink under the watermark
                or rel == "events.jsonl"
                or rel.startswith("trace/")
            ):
                continue
            dest = handle.artifacts_dir / rel
            try:
                await self.store.get_file(uri, dest)
            except Exception:
                logger.exception("resume staging: fetch of %s failed", uri)
                continue
            # seed the sync sidecar's change detection so the files we just
            # pulled down are not immediately re-uploaded unchanged
            st = dest.stat()
            handle.synced[rel] = (st.st_mtime, st.st_size)
            n += 1
        if n:
            handle.restored_checkpoints = n
            handle.event("CheckpointsRestored",
                         f"{n} files <- {handle.artifacts_uri}")

    def _runtime_env(self, flavor: DeviceFlavor, num_slices: int) -> dict[str, str]:
        """Runtime env for a job on a flavor: the package importable from the
        sandbox.  The card (``CUDA_VISIBLE_DEVICES``) is set on admission,
        when it is granted (:meth:`_grant_card`)."""
        env = dict(os.environ)
        env.update(self.extra_env)
        # the subprocess runs with the sandbox as cwd — make our package
        # importable regardless of install state
        pkg_root = str(Path(__file__).resolve().parents[3])
        env["PYTHONPATH"] = (
            pkg_root + os.pathsep + env["PYTHONPATH"]
            if env.get("PYTHONPATH") else pkg_root
        )
        return env

    def _grant_card(self, handle: _JobHandle) -> None:
        """Give an admitted ``cuda`` job the lowest free card of its flavor
        and show the trainer that card alone.  The scheduler's quota bounds
        the cards in use, so a free one exists."""
        flavor = handle.flavor_obj
        if flavor is None or flavor.runtime != "cuda":
            return
        used = self._cards.setdefault(flavor.name, {})
        card = next(i for i in range(len(used) + 1) if i not in used)
        used[card] = handle.job_id
        handle.card = card
        visible = [c for c in os.environ.get("CUDA_VISIBLE_DEVICES", "").split(",") if c]
        handle.env["CUDA_VISIBLE_DEVICES"] = visible[card] if card < len(visible) else str(card)

    def _free_card(self, handle: _JobHandle) -> None:
        if handle.card is None or handle.flavor_obj is None:
            return
        used = self._cards.get(handle.flavor_obj.name, {})
        if used.get(handle.card) == handle.job_id:
            del used[handle.card]
        handle.card = None

    # ------------------------------------------------------- warm worker pool

    def _env_key(self, env: dict[str, str]) -> tuple:
        """Workers are interchangeable within one runtime env: the
        ``PYTHONPATH`` and a digest of the controller's ``extra_env``
        overlay (a worker prewarmed before ``extra_env`` changed inherited
        the old values and cannot be re-pointed).  The card is NOT in the
        key: the request line sets it before the worker touches CUDA."""
        extra = hashlib.sha256(
            "\x00".join(f"{k}={v}" for k, v in sorted(self.extra_env.items())).encode()
        ).hexdigest()
        return (env.get("PYTHONPATH", ""), extra)

    async def _spawn_warm(self, env: dict[str, str]) -> None:
        if self._closing or self.warm_workers <= 0:
            return
        key = self._env_key(env)
        pool = self._warm.setdefault(key, [])
        pool[:] = [p for p in pool if p.returncode is None]
        if len(pool) >= self.warm_workers:
            return
        # pre-claim output goes to a pool log, not any job's log; after the
        # claim the worker re-points itself at the job's
        pool_log = await asyncio.to_thread(open, self.root / "warm_workers.log", "ab")
        # the pool is replenished with a finished job's env: its card and
        # trace identity must not ride into the next job (each claim brings
        # its own in the request line)
        env = {k: v for k, v in env.items() if k not in _REQUEST_ENV_KEYS}
        ready_path = self.root / f".warm_ready_{time.time_ns()}"
        env["FTC_WARM_READY_FILE"] = str(ready_path)
        try:
            proc = await asyncio.create_subprocess_exec(
                self.python, "-m", "finetune_controller_tpu_torch.train.warm_worker",
                stdin=asyncio.subprocess.PIPE,
                stdout=pool_log, stderr=asyncio.subprocess.STDOUT,
                env=env, cwd=str(self.root),
            )
        finally:
            pool_log.close()
        proc.ftc_ready_path = ready_path  # type: ignore[attr-defined]
        pool.append(proc)

    def _claim_warm(self, env: dict[str, str]) -> asyncio.subprocess.Process | None:
        pool = self._warm.get(self._env_key(env), [])
        alive = [p for p in pool if p.returncode is None]
        pool[:] = alive
        # prefer a worker that has finished its imports (ready file)
        alive.sort(key=lambda p: Path(getattr(p, "ftc_ready_path", "/nonexistent")).exists())
        if not alive:
            return None
        proc = alive[-1]
        pool.remove(proc)
        ready = getattr(proc, "ftc_ready_path", None)
        if ready is not None:
            Path(ready).unlink(missing_ok=True)
        return proc

    async def prewarm(self, wait_s: float = 0.0) -> None:
        """Spawn the warm pool (the runtime calls this at startup, so the
        first submission already warm-starts).  ``wait_s > 0`` blocks until
        the workers report ready or the deadline passes."""
        if self.warm_workers <= 0:
            return
        flavor = self.catalog.get(self.catalog.default_flavor)
        if flavor is None:
            logger.warning("warm_workers=%d but the device catalog has no default "
                           "flavor; skipping prewarm", self.warm_workers)
            return
        env = self._runtime_env(flavor, 1)
        for _ in range(self.warm_workers):
            await self._spawn_warm(env)
        deadline = time.time() + wait_s
        pool = self._warm.get(self._env_key(env), [])
        while time.time() < deadline:
            alive = [p for p in pool if p.returncode is None]
            if not alive:
                # every spawned worker died (broken env, import failure): an
                # empty pool must not report ready
                logger.warning("warm-worker pool is empty: all spawned workers exited "
                               "(see %s)", self.root / "warm_workers.log")
                return
            if all(Path(getattr(p, "ftc_ready_path", "/nonexistent")).exists()
                   for p in alive):
                return
            await asyncio.sleep(0.2)

    @staticmethod
    def _obs_env(handle: _JobHandle) -> dict[str, str]:
        """Trace-propagation env (docs/observability.md): the trainer stamps
        every span/event/log line with the job's trace id and this dispatch's
        attempt number."""
        if not handle.trace_id:
            return {}
        return {
            "FTC_TRACE_ID": handle.trace_id,
            "FTC_ATTEMPT": str(handle.attempt),
        }

    def _admit_pending(self) -> None:
        if self._closing:
            return
        for w in self.scheduler.try_admit():
            if getattr(w, "owner", "train") != "train":
                # a serve-tenant replica workload: admission grants it chips,
                # but its lifecycle (spawn/drain) belongs to the serve plane
                # (sched/serve_tenant.py polls is_admitted) — there is no
                # trainer process to start and no handle to miss
                continue
            handle = self._handles.get(w.job_id)
            if handle is None:
                # the workload outlived its handle (a submit-path crash
                # dropped the handle after the scheduler registration): a
                # silent release here left the DB job QUEUED forever.  Leave
                # a FAILED tombstone report instead — the monitor hands it
                # to the retry supervisor, which classifies the message as
                # an infra failure and resubmits.
                self.scheduler.release(w.job_id)
                logger.error(
                    "job %s admitted without a live handle; reporting it "
                    "as failed so the supervisor can retry", w.job_id,
                )
                self._lost[w.job_id] = BackendJobReport(
                    job_id=w.job_id,
                    state=BackendJobState.FAILED,
                    completion_time=time.time(),
                    message=(
                        "backend error: workload admitted without a live "
                        "handle (submit-path crash); the job never started"
                    ),
                    metadata={"exit_code": None, "restarts": 0},
                )
                continue
            granted = getattr(w, "num_slices", handle.granted_slices)
            if granted != handle.granted_slices:
                # elastic admission: the scheduler granted a smaller
                # topology than the spec was rendered for — re-render the
                # mesh/env at the granted size (topology-portable
                # checkpoints make the resumed state land on it cleanly)
                try:
                    self._rerender_topology(handle, granted)
                except Exception as exc:
                    logger.exception(
                        "re-rendering %s at %d slices failed", w.job_id, granted
                    )
                    handle.set_state(
                        BackendJobState.FAILED, f"elastic re-render failed: {exc}"
                    )
                    self.scheduler.release(w.job_id)
                    continue
            self._grant_card(handle)
            handle.set_state(BackendJobState.CREATED)
            handle.event(
                "Admitted",
                f"queue={w.queue} priority={handle.priority} "
                f"slices={granted}/{handle.requested_slices}",
            )
            handle.run_task = asyncio.get_running_loop().create_task(self._run(handle))
        self._execute_preemptions()

    def _rerender_topology(self, handle: _JobHandle, num_slices: int) -> None:
        """Rewrite the trainer spec + runtime env for a new slice count
        (elastic admission granted less than asked).  The global batch stays
        in the spec untouched — ``train/elastic.py`` recomputes the
        microstructure at resume/start time."""
        spec, flavor = handle.spec_obj, handle.flavor_obj
        if spec is None or flavor is None:
            raise RuntimeError("no render context on the handle")
        mesh = default_mesh_for(flavor, num_slices, policy=spec.mesh_policy)
        trainer_spec = spec.build_trainer_spec(
            handle.job_id,
            str(handle.artifacts_dir),
            dataset_path=handle.dataset_path,
            mesh=mesh,
        )
        handle.spec_path.write_text(json.dumps(trainer_spec, indent=2))
        handle.env = self._runtime_env(flavor, num_slices)
        handle.env.update(self._obs_env(handle))
        handle.granted_slices = num_slices
        handle.event(
            "ElasticAdmission",
            f"granted {num_slices}/{handle.requested_slices} slices",
        )

    def _execute_preemptions(self) -> None:
        """Deliver the scheduler's eviction/resize decisions: SIGTERM each
        victim so the trainer checkpoints and exits 143; the run loop then
        reports FAILED without burning local restarts, and the resilience
        supervisor requeues the victim with resume — at ``to_slices`` when
        the decision is a resize (docs/elasticity.md).  The victim's chips
        stay reserved (for the preemptor, and for the victim's own shrunk
        resubmit) inside the scheduler until they actually free."""
        take = getattr(self.scheduler, "take_preemptions", None)
        if take is None:
            return
        # train-owned decisions only: a serve replica's preemption routes to
        # the serve tenant (sched/serve_tenant.py), which DRAINS the replica
        # instead of SIGTERMing a process that does not exist
        for decision in take(owner="train"):
            victim_id = decision.job_id
            preemptor_id = decision.preemptor_id or ""
            handle = self._handles.get(victim_id)
            if handle is None:
                # no backend half to resize: drop the workload AND any
                # reservation the decision just created — nothing will
                # resubmit to consume it
                getattr(self.scheduler, "forget", self.scheduler.release)(
                    victim_id
                )
                continue
            handle.preempted = True
            handle.preempted_by = preemptor_id
            if decision.kind == "evict":
                handle.event("Preempted", f"evicted for {preemptor_id}")
                logger.info("preempting job %s for %s", victim_id, preemptor_id)
            else:
                handle.resize_to = decision.to_slices
                handle.resize_kind = decision.kind
                handle.event(
                    "Resizing",
                    f"{decision.kind} {decision.from_slices}->"
                    f"{decision.to_slices} slices"
                    + (f" for {preemptor_id}" if preemptor_id else ""),
                )
                logger.info(
                    "resizing job %s: %s %d->%d slices%s",
                    victim_id, decision.kind, decision.from_slices,
                    decision.to_slices,
                    f" for {preemptor_id}" if preemptor_id else "",
                )
            if handle.proc is not None:
                with contextlib.suppress(ProcessLookupError):
                    handle.proc.terminate()
            # a proc-less victim (admitted, subprocess not yet spawned) is
            # caught by the post-spawn check in _run_once

    def scheduler_tick(self) -> None:
        """Monitor-tick admission hook: re-evaluate admission/preemption even
        without a submit/release edge (e.g. shares drifted, or a reservation
        became satisfiable) — the Kueue reconcile loop equivalent."""
        self._admit_pending()

    # --------------------------------------------------------------- run loop

    async def _run(self, handle: _JobHandle) -> None:
        """Pod main loop: launch, restart on failure up to backoffLimit."""
        try:
            attempt = 0
            outcome = BackendJobState.FAILED
            message = ""
            while True:
                rc = await self._run_once(handle, attempt)
                handle.exit_code = rc
                if handle.cancelled:
                    return
                if rc == 0:
                    # a preemption that lands as the process exits 0 is moot:
                    # the job trained to completion and must be SUCCEEDED,
                    # not spuriously failed-and-requeued
                    handle.preempted = False
                    handle.resize_to = None
                    handle.resize_kind = ""
                    outcome = BackendJobState.SUCCEEDED
                    break
                if handle.preempted:
                    # scheduler eviction/resize: do NOT restart locally — the
                    # chips are reserved (for the preemptor and, on a resize,
                    # for this job's own resubmit).  Report FAILED with the
                    # SIGTERM exit code so the supervisor classifies it as a
                    # preemption and requeues it with resume — at the resize
                    # topology when one is set.
                    outcome = BackendJobState.FAILED
                    if handle.resize_to is not None:
                        message = (
                            f"resized by scheduler ({handle.resize_kind} to "
                            f"{handle.resize_to} slices"
                            + (f" for {handle.preempted_by}"
                               if handle.preempted_by else "")
                            + f"; exit code {rc})"
                        )
                    else:
                        message = (
                            f"preempted by scheduler for {handle.preempted_by} "
                            f"(exit code {rc})"
                        )
                    break
                attempt += 1
                handle.restarts = attempt
                if attempt > self.backoff_limit:
                    outcome = BackendJobState.FAILED
                    message = f"exit code {rc} after {attempt} attempts"
                    break
                handle.set_state(BackendJobState.RESTARTING, f"exit code {rc}; retrying")
                handle.event("Restarting", f"attempt {attempt}/{self.backoff_limit}")
            handle.completion_time = time.time()
            # the terminal state must only become visible AFTER the final
            # artifact sync: the monitor deletes succeeded jobs from the
            # substrate as soon as it sees SUCCEEDED, which would cancel an
            # in-flight upload and lose the artifacts
            await self._final_sync(handle)
            handle.set_state(outcome, message)
            handle.event(outcome.value, message)
        except asyncio.CancelledError:
            raise
        except Exception as exc:  # backend bug — surface as job failure
            logger.exception("job %s runner crashed", handle.job_id)
            handle.completion_time = handle.completion_time or time.time()
            handle.set_state(BackendJobState.FAILED, f"backend error: {exc}")
        finally:
            self._free_card(handle)
            self.scheduler.release(handle.job_id)
            # ftc: ignore[blocking-io-in-async-transitive] -- same rare small-spec re-render write as the submit path; shared with the sync scheduler_tick hook
            self._admit_pending()
            # replenish the warm pool AFTER the job: a replacement importing
            # at claim time would contend with the job's first step
            with contextlib.suppress(Exception):
                await self._spawn_warm(handle.env)

    async def _run_once(self, handle: _JobHandle, attempt: int) -> int:
        device_args = []
        if handle.flavor_obj is not None and handle.flavor_obj.runtime == "cpu":
            device_args = ["--device", "cpu"]
        proc = self._claim_warm(handle.env)
        if proc is not None:
            # warm start: the worker already paid the interpreter, torch and
            # the training stack; hand it the spec with the job's card and
            # trace identity, and let it re-point its output at the job log
            request = json.dumps({
                "spec": str(handle.spec_path),
                "log": str(handle.logs_path),
                "cwd": str(handle.sandbox),
                "env": {k: handle.env[k] for k in _REQUEST_ENV_KEYS if k in handle.env},
                "argv": device_args,
            })
            try:
                proc.stdin.write(request.encode() + b"\n")
                await proc.stdin.drain()
                proc.stdin.close()
                handle.event("Started", f"attempt {attempt}: warm worker pid={proc.pid}")
            except (BrokenPipeError, ConnectionResetError, OSError) as exc:
                # the pool member died between the liveness check and the
                # handoff: a lost pool member must not fail the job
                logger.warning("warm worker pid=%s unusable (%s); cold-spawning instead",
                               proc.pid, exc)
                handle.event("WarmWorkerLost", str(exc))
                proc = None
        if proc is None:
            cmd = [
                self.python, "-m", "finetune_controller_tpu_torch.train.cli",
                "--spec", str(handle.spec_path), *device_args,
            ]
            handle.event("Started", f"attempt {attempt}: {shlex.join(cmd)}")
            log_f = await asyncio.to_thread(open, handle.logs_path, "ab")
            try:
                # the child inherits the fd; the parent's copy closes either way
                proc = await asyncio.create_subprocess_exec(
                    *cmd,
                    stdout=log_f,
                    stderr=asyncio.subprocess.STDOUT,
                    env=handle.env,
                    cwd=str(handle.sandbox),
                )
            finally:
                log_f.close()
        handle.proc = proc
        if handle.preempted:
            # preemption landed between admission and spawn: the victim's
            # process must still die now, not run to completion on chips the
            # scheduler already promised away
            with contextlib.suppress(ProcessLookupError):
                proc.terminate()
        if handle.start_time is None:
            handle.start_time = time.time()
        handle.set_state(BackendJobState.RUNNING)
        if handle.sync_task is None or handle.sync_task.done():
            handle.sync_task = asyncio.get_running_loop().create_task(
                self._sync_loop(handle)
            )
        try:
            rc = await proc.wait()
        finally:
            handle.proc = None
        return rc

    # ------------------------------------------------------- artifact sidecar

    async def _sync_dir(self, handle: _JobHandle) -> int:
        """Upload changed matching files only (shared ``syncer`` core — the
        behavior ``aws s3 sync`` gave the reference for free)."""
        return await sync_dir_to_store(
            self.store, handle.artifacts_dir, handle.artifacts_uri,
            patterns=handle.patterns, synced=handle.synced,
        )

    async def _sync_loop(self, handle: _JobHandle) -> None:
        """Sidecar: sync every interval until done.txt appears
        (``PyTorchJobDeployer.py:134-138``); the final sync runs in
        :meth:`_final_sync`."""
        try:
            while not (handle.artifacts_dir / "done.txt").exists():
                await asyncio.sleep(self.sync_interval_s)
                if handle.state in BackendJobState.stopped_states():
                    return
                with contextlib.suppress(Exception):
                    await self._sync_dir(handle)
        except asyncio.CancelledError:
            pass

    async def _final_sync(self, handle: _JobHandle) -> None:
        if handle.sync_task is not None:
            handle.sync_task.cancel()
            with contextlib.suppress(asyncio.CancelledError):
                await handle.sync_task
            handle.sync_task = None
        try:
            n = await self._sync_dir(handle)
            if handle.logs_path.exists():
                # archive the training log with the artifacts so logs survive
                # substrate cleanup (the reference loses pod logs once the
                # succeeded job is deleted — core/monitor.py:182-186)
                await self.store.put_file(
                    f"{handle.artifacts_uri}/logs.txt", handle.logs_path
                )
            handle.event("ArtifactsSynced", f"{n} files -> {handle.artifacts_uri}")
        except Exception as exc:
            # losing the final sync silently would let the monitor delete the
            # sandbox believing artifacts are safe — record it loudly instead
            logger.exception("job %s final artifact sync failed", handle.job_id)
            handle.event("ArtifactSyncFailed", str(exc))
            handle.message = (handle.message + f"; artifact sync failed: {exc}").lstrip("; ")

    # ----------------------------------------------------------- introspection

    def _report(self, handle: _JobHandle) -> BackendJobReport:
        # exit_code rides the report metadata so the monitor persists it and
        # the retry supervisor can classify the failure (resilience/policy.py)
        metadata: dict[str, Any] = {
            "restarts": handle.restarts,
            "exit_code": handle.exit_code,
            "queue": handle.queue,
            "priority": handle.priority,
        }
        if handle.restored_checkpoints:
            metadata["restored_checkpoints"] = handle.restored_checkpoints
        # the topology this attempt actually runs at: the supervisor's
        # elastic-restore accounting compares successive attempts against
        # it, and an elastic ADMISSION (granted < asked on the very first
        # attempt) would otherwise be invisible to it
        metadata["last_ran_num_slices"] = handle.granted_slices
        if handle.granted_slices != handle.requested_slices:
            # running elastically below its requested topology
            metadata["current_num_slices"] = handle.granted_slices
            metadata["requested_num_slices"] = handle.requested_slices
        if handle.preempted:
            # persisted by the monitor's metadata merge -> the preemption
            # event survives in the job document (crash-safe, like
            # retry_next_at)
            metadata["preempted"] = True
            if handle.preempted_by:
                metadata["preempted_by"] = handle.preempted_by
        if handle.resize_to is not None:
            # the supervisor resubmits at this topology (crash-safe: the
            # monitor merges it into the job document before the RETRYING
            # transition)
            metadata["resize_to_num_slices"] = handle.resize_to
            metadata["resize_kind"] = handle.resize_kind
        return BackendJobReport(
            job_id=handle.job_id,
            state=handle.state,
            start_time=handle.start_time,
            completion_time=handle.completion_time,
            message=handle.message,
            metadata=metadata,
        )

    async def list_jobs(self) -> list[BackendJobReport]:
        return [self._report(h) for h in self._handles.values()] + list(
            self._lost.values()
        )

    async def get_job(self, job_id: str) -> BackendJobReport | None:
        h = self._handles.get(job_id)
        if h is not None:
            return self._report(h)
        return self._lost.get(job_id)

    async def queue_snapshot(self) -> list[str]:
        return self.scheduler.pending()

    async def job_events(self, job_id: str) -> list[dict[str, Any]]:
        h = self._handles.get(job_id)
        return list(h.events) if h else []

    # ---------------------------------------------------------------- control

    async def delete_job(self, job_id: str, *,
                         forget_reservations: bool = False) -> bool:
        """Kill + forget (cluster-delete equivalent; DB record survives).

        Escalates SIGTERM → SIGKILL: a trainer hung hard enough to trip the
        liveness lease may ignore SIGTERM, and the supervisor resubmits into
        the SAME sandbox — two writers on one artifacts dir would corrupt
        the checkpoints the resumed attempt depends on, so the old process
        must be dead before this returns.

        ``forget_reservations`` (terminal deletions only) also drops the
        job's scheduler resize reservation — see the base-class contract."""
        release = self.scheduler.release
        if forget_reservations:
            release = getattr(self.scheduler, "forget", release)
        if self._lost.pop(job_id, None) is not None:
            # tombstone of a job that never started: nothing to kill
            release(job_id)
            return True
        handle = self._handles.pop(job_id, None)
        if handle is None:
            return False
        handle.cancelled = True
        proc = handle.proc
        if proc is not None:
            with contextlib.suppress(ProcessLookupError):
                proc.terminate()
        for task in (handle.run_task, handle.sync_task):
            if task is not None and not task.done():
                task.cancel()
                with contextlib.suppress(asyncio.CancelledError, Exception):
                    await task
        if proc is not None and proc.returncode is None:
            try:
                await asyncio.wait_for(proc.wait(), timeout=self.term_grace_s)
            except asyncio.TimeoutError:
                logger.warning(
                    "job %s ignored SIGTERM for %.1fs; escalating to SIGKILL",
                    job_id, self.term_grace_s,
                )
                with contextlib.suppress(ProcessLookupError):
                    proc.kill()
                with contextlib.suppress(Exception):
                    await proc.wait()
        self._free_card(handle)
        release(job_id)
        # ftc: ignore[blocking-io-in-async-transitive] -- same rare small-spec re-render write as the submit path; shared with the sync scheduler_tick hook
        self._admit_pending()
        return True

    def serve_worker_root(self, job_id: str) -> Path:
        """Serve-worker sandboxes live NEXT to the trainer sandboxes
        (docs/serving.md §Cross-process transport): a worker process gets
        the same debugging surface a failed trainer attempt does — spec,
        log, heartbeat and socket file under one per-replica dir — and the
        spawn/kill lifecycle rides this backend's substrate."""
        root = self.root / "serve_workers" / job_id
        root.mkdir(parents=True, exist_ok=True)
        return root

    async def inject_fault(self, job_id: str, *, signum: int = 15) -> bool:
        """Fault injection (SURVEY.md §5.3 gap): kill the running process;
        the restart loop then exercises the elastic/backoff path."""
        handle = self._handles.get(job_id)
        if handle is None or handle.proc is None:
            return False
        handle.event("FaultInjected", f"signal {signum}")
        with contextlib.suppress(ProcessLookupError):
            handle.proc.send_signal(signum)
        return True

    async def deliver_file(self, job_id: str, rel_path: str,
                           data: bytes) -> bool:
        """Artifact channel, reverse direction (docs/observability.md): drop
        a control file into the job's artifacts dir — atomically, so the
        trainer polling for it never reads a torn payload."""
        handle = self._handles.get(job_id)
        if handle is None:
            return False
        dest = (handle.artifacts_dir / rel_path).resolve()
        if handle.artifacts_dir.resolve() not in dest.parents:
            raise BackendError(f"refusing delivery outside the sandbox: {rel_path!r}")

        def write() -> None:
            dest.parent.mkdir(parents=True, exist_ok=True)
            tmp = dest.with_name(dest.name + ".tmp")
            tmp.write_bytes(data)
            os.replace(tmp, dest)

        await asyncio.to_thread(write)
        handle.event("FileDelivered", rel_path)
        return True

    # ------------------------------------------------------------------- logs

    async def read_logs(
        self,
        job_id: str,
        *,
        follow: bool = False,
        last_lines: int | None = None,
    ) -> AsyncIterator[str]:
        handle = self._handles.get(job_id)
        if handle is None:
            raise BackendError(f"unknown job {job_id!r}")

        path = handle.logs_path

        async def aiter() -> AsyncIterator[str]:
            # wait for the log file to exist (pod may still be pending);
            # historical reads return empty immediately rather than blocking
            # on a job that has not started
            while not path.exists():
                h = self._handles.get(job_id)
                if not follow:
                    return
                if h is None or h.state in BackendJobState.stopped_states():
                    return
                await asyncio.sleep(0.1)
            f = await asyncio.to_thread(open, path, "r", errors="replace")
            try:
                if last_lines is not None:
                    lines = await asyncio.to_thread(f.readlines)
                    for line in lines[-last_lines:]:
                        yield line.rstrip("\n")
                    if not follow:
                        return
                else:
                    while True:
                        line = await asyncio.to_thread(f.readline)
                        if not line:
                            break
                        yield line.rstrip("\n")
                if not follow:
                    return
                # live tail with pod-liveness probe on empty reads
                # (reference: stream_logger.py:286-341)
                while True:
                    line = await asyncio.to_thread(f.readline)
                    if line:
                        yield line.rstrip("\n")
                        continue
                    h = self._handles.get(job_id)
                    if h is None or (
                        h.state in BackendJobState.stopped_states() and h.proc is None
                    ):
                        # drain anything written between readline and the check
                        tail = await asyncio.to_thread(f.read)
                        for extra in tail.splitlines():
                            yield extra
                        return
                    await asyncio.sleep(0.2)
            finally:
                await asyncio.to_thread(f.close)

        return aiter()

    async def close(self) -> None:
        self._closing = True
        self._lost.clear()
        for job_id in list(self._handles):
            await self.delete_job(job_id, forget_reservations=True)
        for pool in self._warm.values():
            for proc in pool:
                if proc.returncode is None:
                    # closing stdin without a request is the graceful exit
                    with contextlib.suppress(Exception):
                        proc.stdin.close()
                    try:
                        await asyncio.wait_for(proc.wait(), timeout=self.term_grace_s)
                    except asyncio.TimeoutError:
                        with contextlib.suppress(ProcessLookupError):
                            proc.kill()
                        await proc.wait()
                ready = getattr(proc, "ftc_ready_path", None)
                if ready is not None:
                    Path(ready).unlink(missing_ok=True)
        self._warm.clear()
