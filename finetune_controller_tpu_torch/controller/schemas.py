"""Control-plane schemas: DB documents, API DTOs, and the training-state machine.

Capability parity with the reference's three schema files
(``app/schemas/db_schemas.py``, ``app/schemas/jobs_schemas.py``,
``app/schemas/kubeflow_schemas.py`` — SURVEY.md §2 component 8), with the
Kubeflow-specific state machine generalised to *any* training backend
(local subprocess).
"""

from __future__ import annotations

import enum
import time
from typing import Any

from pydantic import BaseModel, Field


# ---------------------------------------------------------------------------
# Status enums
# ---------------------------------------------------------------------------


class DatabaseStatus(str, enum.Enum):
    """Job lifecycle as stored/served (reference: ``db_schemas.py:46-66``)."""

    QUEUED = "queued"
    CREATED = "created"
    RUNNING = "running"
    RESTARTING = "restarting"
    #: failed, classified retryable, waiting out its backoff before the
    #: supervisor resubmits it (``resilience/supervisor.py``); deliberately
    #: NON-final — the job is still the control plane's responsibility
    RETRYING = "retrying"
    SUCCEEDED = "succeeded"
    FAILED = "failed"
    CANCELLED = "cancelled"
    UNKNOWN = "unknown"

    @classmethod
    def final_states(cls) -> set["DatabaseStatus"]:
        return {cls.SUCCEEDED, cls.FAILED, cls.CANCELLED}

    @property
    def is_final(self) -> bool:
        return self in self.final_states()


class PromotionStatus(str, enum.Enum):
    """Artifact promotion state machine (reference: ``db_schemas.py:69-74``)."""

    NOT_PROMOTED = "not_promoted"
    IN_PROGRESS = "in_progress"
    COMPLETED = "completed"
    FAILED = "failed"
    DELETING = "deleting"


class BackendJobState(str, enum.Enum):
    """States a training backend reports for a job.

    Generalisation of the reference's Kubeflow condition types
    (``kubeflow_schemas.py:10-35``): Created/Running/Restarting/Succeeded/
    Failed/Suspended map 1:1; ``PENDING`` covers "accepted but no state yet".
    """

    PENDING = "Pending"
    SUSPENDED = "Suspended"  # admitted to queue, not yet running (Kueue suspend)
    CREATED = "Created"
    RUNNING = "Running"
    RESTARTING = "Restarting"
    SUCCEEDED = "Succeeded"
    FAILED = "Failed"
    UNKNOWN = "Unknown"

    @classmethod
    def running_states(cls) -> set["BackendJobState"]:
        # reference: kubeflow_schemas.py:42-50
        return {cls.PENDING, cls.SUSPENDED, cls.CREATED, cls.RUNNING, cls.RESTARTING}

    @classmethod
    def stopped_states(cls) -> set["BackendJobState"]:
        # reference: kubeflow_schemas.py:52-59
        return {cls.SUCCEEDED, cls.FAILED, cls.UNKNOWN}


#: Backend state → DB status (reference: ``TrainingJobStatus.map_status``,
#: ``kubeflow_schemas.py:61-85``).
_STATE_TO_DB: dict[BackendJobState, DatabaseStatus] = {
    BackendJobState.PENDING: DatabaseStatus.QUEUED,
    BackendJobState.SUSPENDED: DatabaseStatus.QUEUED,
    BackendJobState.CREATED: DatabaseStatus.CREATED,
    BackendJobState.RUNNING: DatabaseStatus.RUNNING,
    BackendJobState.RESTARTING: DatabaseStatus.RESTARTING,
    BackendJobState.SUCCEEDED: DatabaseStatus.SUCCEEDED,
    BackendJobState.FAILED: DatabaseStatus.FAILED,
    BackendJobState.UNKNOWN: DatabaseStatus.UNKNOWN,
}


def map_backend_state(state: BackendJobState | str) -> DatabaseStatus:
    try:
        state = BackendJobState(state)
    except ValueError:
        return DatabaseStatus.UNKNOWN
    return _STATE_TO_DB[state]


# ---------------------------------------------------------------------------
# Backend report (what the monitor consumes each reconcile tick)
# ---------------------------------------------------------------------------


class BackendJobReport(BaseModel):
    """Snapshot of one job as seen by a training backend.

    Replaces the reference's raw ``KubeflowOrgV1PyTorchJob`` objects iterated by
    the monitor (``app/core/monitor.py:134-197``) with a typed, backend-neutral
    report.
    """

    job_id: str
    state: BackendJobState = BackendJobState.UNKNOWN
    start_time: float | None = None  # epoch seconds
    completion_time: float | None = None
    message: str = ""
    metadata: dict[str, Any] = Field(default_factory=dict)


# ---------------------------------------------------------------------------
# DB documents
# ---------------------------------------------------------------------------


class JobRecord(BaseModel):
    """The job document (reference: ``JobStatus``, ``db_schemas.py:85-129``)."""

    job_id: str
    user_id: str
    model_name: str
    status: DatabaseStatus = DatabaseStatus.QUEUED
    device: str = ""  # flavor name from the device catalog (e.g. "h100")
    num_slices: int = 1
    arguments: dict[str, Any] = Field(default_factory=dict)
    dataset_id: str | None = None
    dataset_uri: str | None = None
    artifacts_uri: str | None = None
    promotion_status: PromotionStatus = PromotionStatus.NOT_PROMOTED
    promotion_uri: str | None = None
    queue_position: int | None = None
    submitted_at: float = Field(default_factory=time.time)
    start_time: float | None = None
    end_time: float | None = None
    training_duration: float | None = None
    metadata: dict[str, Any] = Field(default_factory=dict)
    #: the lifecycle event timeline (docs/observability.md): appended by
    #: every plane via ``StateStore.append_job_event`` (exactly-once via
    #: idempotency keys), served by ``GET /jobs/{id}/timeline`` and the
    #: trace assembly (``obs/trace.py``)
    events: list[dict[str, Any]] = Field(default_factory=list)


class DatasetRecord(BaseModel):
    """Dataset document (reference: ``DatasetModel``, ``db_schemas.py:28-44``)."""

    dataset_id: str
    user_id: str
    name: str
    uri: str
    size_bytes: int | None = None
    content_type: str | None = None
    created_at: float = Field(default_factory=time.time)
    job_refs: list[str] = Field(default_factory=list)
    metadata: dict[str, Any] = Field(default_factory=dict)


class MetricsDocument(BaseModel):
    """Training metrics for one job (reference: ``MetricsDocument``,
    ``db_schemas.py:132-150``)."""

    job_id: str
    records: list[dict[str, Any]] = Field(default_factory=list)
    source_uri: str | None = None
    updated_at: float = Field(default_factory=time.time)


# ---------------------------------------------------------------------------
# API DTOs
# ---------------------------------------------------------------------------


class JobInput(BaseModel):
    """Validated submission payload (reference: ``JobInput``,
    ``jobs_schemas.py:18-36``; device validation happens in the API layer
    against the live device catalog)."""

    job_id: str
    user_id: str
    model_name: str
    device: str
    num_slices: int = 1
    arguments: dict[str, Any] = Field(default_factory=dict)
    #: tenant queue + priority class for the fair-share scheduler
    #: (``sched/``, docs/scheduling.md); validated
    #: against sched.queues.parse_priority in the API layer
    queue: str = "default"
    priority: str | int = "normal"
    #: the topology the job ORIGINALLY asked for, when ``num_slices`` is a
    #: resized (shrunk) resubmission — the scheduler's grow pass restores
    #: the job toward this when chips free (docs/elasticity.md).  None on a
    #: fresh submission (= num_slices).
    requested_num_slices: int | None = None
    #: observability (docs/observability.md): the job's trace id — minted at
    #: first submit by ``task_builder``, carried by the job metadata, and
    #: re-supplied on supervisor resubmissions so every attempt shares one
    #: trace; backends thread it into the trainer env as ``FTC_TRACE_ID``
    trace_id: str = ""
    #: 1-based attempt number of THIS dispatch (``FTC_ATTEMPT`` in the
    #: trainer env; log streams and trainer events are attributed by it)
    attempt: int = 1


class PaginatedTableResponse(BaseModel):
    """Paginated job table (reference: ``PaginatedTableResponse``,
    ``jobs_schemas.py:81-132``)."""

    total: int
    page: int
    page_size: int
    items: list[dict[str, Any]]
