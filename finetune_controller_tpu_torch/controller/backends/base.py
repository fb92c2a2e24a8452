"""The backend seam: what the control plane needs from an execution substrate.

The reference's equivalent surface is scattered across
``PyTorchJobDeployer.create_pytorch_job/get_job_status/delete_job``
(``app/jobs/kubeflow/PyTorchJobDeployer.py:20,264,274``), the monitor's
``kubeflow_api.list_jobs`` (``app/core/monitor.py:131``), and the log
streamer's pod-log reads (``app/utils/stream_logger.py:204-284``). Collapsing
it into one interface makes every consumer (task builder, monitor, WS log
streamer, admin debug routes) backend-neutral and fake-able in tests.
"""

from __future__ import annotations

import abc
from typing import Any, AsyncIterator

from ..devices import DeviceFlavor
from ..schemas import BackendJobReport, JobInput
from ..specs import BaseFineTuneJob


class BackendError(Exception):
    """Raised when the backend cannot perform an operation."""


class TrainingBackend(abc.ABC):
    """Execution substrate for fine-tune jobs."""

    @abc.abstractmethod
    async def submit(
        self,
        job: JobInput,
        spec: BaseFineTuneJob,
        flavor: DeviceFlavor,
        *,
        dataset_uri: str | None,
        artifacts_uri: str,
    ) -> None:
        """Accept a job for (gang-scheduled) execution.

        Replaces ``PyTorchJobDeployer.create_pytorch_job``
        (``PyTorchJobDeployer.py:20-262``): the deployer renders whatever the
        substrate runs (subprocess spec / JobSet manifest) and enqueues it
        suspended until the scheduler admits it.

        Resubmit contract (``resilience/supervisor.py``): a job may be
        submitted again under the SAME ``job_id``/``artifacts_uri`` after its
        backend half was deleted.  A backend that can should stage committed
        checkpoints from ``{artifacts_uri}/checkpoints`` back into the fresh
        substrate so the trainer's resume path continues the run rather than
        restarting it (the local backend does; see
        ``LocalProcessBackend._stage_resume_state``)."""

    @abc.abstractmethod
    async def list_jobs(self) -> list[BackendJobReport]:
        """Snapshot every job the backend knows (monitor input — replaces
        ``kubeflow_api.list_jobs``, ``app/core/monitor.py:131``)."""

    @abc.abstractmethod
    async def get_job(self, job_id: str) -> BackendJobReport | None:
        """One job's report, or None if the backend no longer tracks it."""

    @abc.abstractmethod
    async def delete_job(self, job_id: str, *,
                         forget_reservations: bool = False) -> bool:
        """Stop (if needed) and forget a job — used both for post-success
        cluster cleanup (``app/core/monitor.py:182-186``) and user cancel
        (``app/main.py:839-903``). Artifacts already live in the object
        store, so deletion loses nothing.

        ``forget_reservations=True`` (terminal deletions: success cleanup,
        user cancel) additionally drops any scheduler resize reservation the
        job holds — it is not coming back at a new size.  The default keeps
        reservations alive: the retry supervisor's teardown of a mid-resize
        victim must NOT release the chips fenced for its own resubmit
        (docs/elasticity.md)."""

    @abc.abstractmethod
    async def read_logs(
        self,
        job_id: str,
        *,
        follow: bool = False,
        last_lines: int | None = None,
    ) -> AsyncIterator[str]:
        """Yield log lines (historical, then live when ``follow``) — the
        pod-log seam the WS streamer consumes
        (``stream_logger.py:204-284``)."""

    @abc.abstractmethod
    async def queue_snapshot(self) -> list[str]:
        """Ordered pending job ids (Kueue queue order —
        ``kueue_helpers.py:19-46``)."""

    async def job_events(self, job_id: str) -> list[dict[str, Any]]:
        """Debug event log for one job (reference: pod events digest,
        ``kube_helpers.py:26-95``). Optional; default empty."""
        return []

    async def inject_fault(self, job_id: str, *, signum: int = 15) -> bool:
        """Chaos seam (``resilience/faults.py``): deliver a signal to a
        running job's process, exercising the preemption/recovery paths.
        Optional; backends without process access report False (not
        injected)."""
        return False

    async def deliver_file(self, job_id: str, rel_path: str,
                           data: bytes) -> bool:
        """Deliver a small control file into a RUNNING job's artifacts dir —
        the artifact channel in reverse (docs/observability.md: the
        on-demand ``torch.profiler`` window rides this as
        ``profile_request.json``).  Optional; backends without sandbox
        access report False (not delivered)."""
        return False

    def serve_worker_root(self, job_id: str) -> Any | None:
        """Root directory for cross-process serve-worker sandboxes of one
        served job (docs/serving.md §Cross-process transport).  The local
        backend hosts worker sandboxes next to its trainer sandboxes so the
        spawn/kill lifecycle and debugging surface ride the same substrate;
        backends without local process access return None and the serve
        manager falls back to its own state dir (or, on k8s, to rendering
        one worker POD per replica — ``k8s.render_serve_worker_pod``)."""
        return None

    async def close(self) -> None:
        """Release resources (subprocesses, watch tasks)."""
        return None
