"""Job submission orchestration — one validated request → a queued job.

Capability parity with the reference's ``task_builder``
(``app/jobs/task_builder.py:19-81`` — SURVEY.md §2 component 5, §3.1): resolve
the dataset (existing id / URL stream / uploaded file), compute the artifact
URI, hand the job to the execution backend, and write the DB record the
monitor will reconcile against.

Reference warts fixed here (SURVEY.md §7 step 3): the backend call is fully
async (the reference does a blocking kube call inside an async route,
``PyTorchJobDeployer.py:256``), and a backend submit failure rolls the
dataset job-ref back instead of leaving a half-registered job.
"""

from __future__ import annotations

import dataclasses
import logging

from ..obs.events import SUBMITTED, make_event
from ..obs.trace import new_trace_id
from .backends.base import TrainingBackend
from .datasets import stream_dataset_url, upload_dataset_bytes
from .devices import DeviceCatalog
from .objectstore import ObjectStore, artifacts_prefix
from .schemas import DatabaseStatus, JobInput, JobRecord
from .specs import BaseFineTuneJob
from .statestore import StateStore

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class DatasetInput:
    """One of three dataset sources (reference: ``main.py:425-435``)."""

    dataset_id: str | None = None
    url: str | None = None
    file_name: str | None = None
    file_data: bytes | None = None
    content_type: str | None = None

    @property
    def kind(self) -> str:
        if self.dataset_id:
            return "id"
        if self.url:
            return "url"
        if self.file_data is not None:
            return "file"
        return "none"


class TaskBuildError(Exception):
    def __init__(self, message: str, status: int = 400):
        super().__init__(message)
        self.status = status


async def task_builder(
    job: JobInput,
    spec: BaseFineTuneJob,
    dataset_input: DatasetInput,
    *,
    state: StateStore,
    store: ObjectStore,
    backend: TrainingBackend,
    catalog: DeviceCatalog,
    datasets_bucket: str,
    artifacts_bucket: str,
    http_session: object | None = None,
) -> JobRecord:
    """Reference flow ``task_builder.py:19-81``, backend-neutral."""
    # -- dataset resolution (reference: task_builder.py:28-53) ---------------
    dataset_uri: str | None = None
    dataset_id: str | None = None
    kind = dataset_input.kind
    if kind == "none" and spec.dataset.required:
        raise TaskBuildError("this model requires a dataset (id, url, or file)")
    if kind == "id":
        record = await state.get_dataset(dataset_input.dataset_id)
        if record is None or record.user_id != job.user_id:
            raise TaskBuildError(f"dataset {dataset_input.dataset_id!r} not found", 404)
        dataset_uri, dataset_id = record.uri, record.dataset_id
    elif kind == "url":
        record = await stream_dataset_url(
            store, state,
            user_id=job.user_id, url=dataset_input.url,
            bucket=datasets_bucket, session=http_session,
        )
        dataset_uri, dataset_id = record.uri, record.dataset_id
    elif kind == "file":
        record = await upload_dataset_bytes(
            store, state,
            user_id=job.user_id,
            filename=dataset_input.file_name or "dataset.jsonl",
            data=dataset_input.file_data,
            bucket=datasets_bucket,
            content_type=dataset_input.content_type,
        )
        dataset_uri, dataset_id = record.uri, record.dataset_id
    if dataset_id is not None:
        await state.add_dataset_job_ref(dataset_id, job.job_id)

    # -- artifact URI (reference: task_builder.py:55) ------------------------
    artifacts_uri = artifacts_prefix(artifacts_bucket, job.user_id, job.job_id)

    # -- DB record first, then deploy ----------------------------------------
    # The reference deploys before writing the record (task_builder.py:60-79),
    # leaving a window where a record-write failure orphans a running cluster
    # job nothing tracks. Record-first closes it: a submit failure rolls the
    # record back; the monitor's lost-job sweep covers the reverse crash.
    flavor = catalog.get_worker(job.device)
    # trace propagation (docs/observability.md): mint the trace id HERE, the
    # job's birth — it rides the job metadata, the backend env, every
    # supervisor resubmission, and the serve load, naming the job's whole life
    job.trace_id = job.trace_id or new_trace_id()
    record = JobRecord(
        job_id=job.job_id,
        user_id=job.user_id,
        model_name=job.model_name,
        status=DatabaseStatus.QUEUED,
        device=flavor.name,
        num_slices=job.num_slices,
        arguments=job.arguments,
        dataset_id=dataset_id,
        dataset_uri=dataset_uri,
        artifacts_uri=artifacts_uri,
        # queue/priority live in metadata (crash-safe, like retry_next_at):
        # the retry supervisor rebuilds the JobInput from the record, so a
        # resubmitted job must re-enter the SAME tenant queue at the SAME
        # priority (docs/scheduling.md).  The task type rides along so the
        # job table (ftc-ctl jobs) and the ftc_dpo_* gauges can tell a DPO
        # job from an SFT one without a registry lookup per row.
        metadata={
            "queue": job.queue,
            "priority": job.priority,
            "task": spec.task.value,
            "trace_id": job.trace_id,
        },
        # the timeline's first event — every later span/phase hangs off it
        events=[make_event(
            SUBMITTED, key="submitted:1",
            queue=job.queue, priority=str(job.priority),
            model=job.model_name, device=flavor.name,
            num_slices=job.num_slices, trace_id=job.trace_id,
        )],
    )
    try:
        await state.create_job(record)
        await backend.submit(
            job, spec, flavor,
            dataset_uri=dataset_uri, artifacts_uri=artifacts_uri,
        )
    except Exception as exc:
        await state.purge_job(job.job_id)
        if dataset_id is not None:
            # roll back the job-ref so a failed submit doesn't pin the dataset
            ds = await state.get_dataset(dataset_id)
            if ds is not None and job.job_id in ds.job_refs:
                ds.job_refs.remove(job.job_id)
                await state.insert_dataset(ds)
        raise TaskBuildError(f"job submission failed: {exc}", 500) from exc
    logger.info("job %s submitted (device=%s dataset=%s)", job.job_id, flavor.name, kind)
    return record
