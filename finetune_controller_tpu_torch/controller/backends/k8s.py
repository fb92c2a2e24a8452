"""Kubernetes backend: JobSet manifests, Kueue GPU quota, a stdlib kube API client.

The port's copy of the JAX package's k8s backend, for ``nvidia.com/gpu``
nodes.  What differs from the reference (``controller/backends/k8s.py``):

- **The card.** Pods request ``flavor.k8s_resource_name()``
  (``nvidia.com/gpu``) in requests and limits, select nodes by the
  flavor's own labels (a GPU is requested by count: no topology selector),
  and the Kueue ClusterQueue's quotas are over ``nvidia.com/gpu``.
- **The port's commands.** The trainer runs ``python -m
  finetune_controller_tpu_torch.train.cli`` (``specs.run_cmd``, with
  ``--device cpu`` for a cpu flavor), the init container and the sidecar
  the port's ``controller.storage_cli``, a serve worker pod the port's
  ``transport.worker``.
- **No TPU contract.** The MEGASCALE env (libtpu's DCN transport) and the
  GKE-nodepool exclusive-topology annotation (which keeps a multi-host TPU
  slice on one nodepool) are not rendered.  ``FTC_COORDINATOR_ADDRESS``,
  ``FTC_NUM_PROCESSES``, ``FTC_SLICE_INDEX`` and ``JOB_COMPLETION_INDEX``
  stay, for a torch rendezvous.  The port trains on one card: a job of more
  than one pod (hosts x slices > 1) is refused at submit (ROADMAP Queue A
  item 7).
- **No aiohttp.** :class:`HttpKubeClient` is built on
  ``controller/httpclient.py`` and keeps the reference client's contract:
  429 (with ``Retry-After``) and 5xx retried with backoff, a 401 re-reads
  the rotated service-account token, a 409 on create adopts the existing
  object, any other error status raises, pod logs (``follow``,
  ``tailLines``) read as lines.  A followed log of a container still
  waiting to start (the API server's 400 while the pod's init containers
  run) is asked for again until it starts, where the reference's client
  raises and the WebSocket stream ends (ROADMAP Queue C).  Its API server
  is the in-cluster
  ``https://$KUBERNETES_SERVICE_HOST:$KUBERNETES_SERVICE_PORT`` (resolved
  at the first request, so a runtime builds without a cluster), or the
  ``base_url`` given (``Settings.kube_api_url``, e.g. a ``kubectl proxy``).
- **The pods' object store.** :func:`object_store_env` renders the
  server's own store settings and credentials for the pods, which the
  runtime passes to the backend (the reference's runtime passes none, so
  its pods' ``storage_cli`` fall back to the default local store: ROADMAP
  Queue C).

What follows is the reference's description of the backend it copies.

- **JobSet instead of PyTorchJob.** Workers are symmetric peers, so the
  reference's Master + (N−1) Workers split (``PyTorchJobDeployer.py:186-249``)
  becomes one indexed Job per slice with ``hosts`` completions; rank 0 is
  elected, not special-cased.
- **Same Kueue integration**: jobs are created suspended with a queue label
  (``PyTorchJobDeployer.py:66-68,179-185``); :func:`render_kueue_crds` emits
  ResourceFlavors/ClusterQueues replacing ``crds/kueue/*.yaml``.
- **Same sidecar/init pattern**: a dataset-fetch init container and an
  artifact-sync sidecar that exits on ``done.txt``
  (``PyTorchJobDeployer.py:70-168``), but running our storage CLI instead of
  ``amazon/aws-cli`` images.

No kubernetes SDK is required: :class:`HttpKubeClient` talks to the API
server directly, and :class:`InMemoryKubeClient` is the hermetic test double.
"""

from __future__ import annotations

import asyncio
import json
import logging
import os
import re
import time
from pathlib import Path
from typing import Any, AsyncIterator

from ..devices import DeviceCatalog, DeviceFlavor, default_mesh_for
from ..schemas import BackendJobReport, BackendJobState, JobInput
from ..specs import BaseFineTuneJob
from .base import BackendError, TrainingBackend

logger = logging.getLogger(__name__)

JOBSET_GROUP = "jobset.x-k8s.io"
JOBSET_VERSION = "v1alpha2"
JOBSET_PLURAL = "jobsets"
KUEUE_QUEUE_LABEL = "kueue.x-k8s.io/queue-name"  # reference: PyTorchJobDeployer.py:66-68
APP_LABEL = "finetune-controller-tpu"
COORDINATOR_PORT = 8476
#: the port's modules the pods run
PACKAGE = "finetune_controller_tpu_torch"


def _sanitize_label(value: str) -> str:
    return re.sub(r"[^a-zA-Z0-9_.-]", "-", value)[:63]


def _parse_k8s_time(value: Any) -> float | None:
    """Accept epoch floats (fakes) or RFC3339 strings (real API server)."""
    if isinstance(value, (int, float)):
        return float(value)
    if isinstance(value, str) and value:
        from datetime import datetime

        try:
            return datetime.fromisoformat(value.replace("Z", "+00:00")).timestamp()
        except ValueError:
            return None
    return None


def object_store_env(settings: Any) -> dict[str, str]:
    """The object store the server uses, as the pods' env: the
    ``FTC_OBJECT_STORE_*``, ``FTC_S3_*`` and ``FTC_GCS_*`` settings and the
    ``AWS_*`` credentials this process holds, so the pods' ``storage_cli``
    reads and writes the store the control plane reads.  (The values ride
    the JobSet as plain env; a deployment that keeps its credentials in a
    Secret gives the pods an ``envFrom`` of it instead, and the server
    none.)"""
    env: dict[str, str] = {}
    for name in sorted(type(settings).model_fields):
        if name.startswith(("object_store_", "s3_", "gcs_")):
            value = getattr(settings, name)
            if name == "object_store_root":
                value = str(settings.object_store_path)
            env[f"FTC_{name.upper()}"] = str(value)
    for key in ("AWS_ACCESS_KEY_ID", "AWS_SECRET_ACCESS_KEY", "AWS_SESSION_TOKEN"):
        if os.environ.get(key):
            env[key] = os.environ[key]
    return env


# ---------------------------------------------------------------------------
# Manifest rendering (pure functions — the testable core)
# ---------------------------------------------------------------------------


def render_trainer_spec(
    job: JobInput,
    spec: BaseFineTuneJob,
    flavor: DeviceFlavor,
    *,
    dataset_uri: str | None,
    artifacts_dir: str = "/data/artifacts",
) -> dict[str, Any]:
    dataset_path = None
    if dataset_uri:
        dataset_path = f"/data/dataset/{dataset_uri.rsplit('/', 1)[-1]}"
    return spec.build_trainer_spec(
        job.job_id,
        artifacts_dir,
        dataset_path=dataset_path,
        mesh=default_mesh_for(flavor, job.num_slices, policy=spec.mesh_policy),
    )


def render_jobset(
    job: JobInput,
    spec: BaseFineTuneJob,
    flavor: DeviceFlavor,
    *,
    namespace: str,
    image: str,
    dataset_uri: str | None,
    artifacts_uri: str,
    sync_interval_s: float = 60.0,
    max_restarts: int = 2,
    object_store_env: dict[str, str] | None = None,
) -> dict[str, Any]:
    """Render the JobSet CR (replaces ``create_pytorch_job``'s manifest dict,
    ``PyTorchJobDeployer.py:170-252``)."""
    hosts = flavor.hosts
    total_processes = hosts * max(1, job.num_slices)
    # JobSet creates a headless service named after the jobset; pod 0 of the
    # first slice-job is the rendezvous coordinator (rank-0 election — no
    # Master/Worker asymmetry)
    coordinator = (
        f"{job.job_id}-slice-0-0.{job.job_id}:{COORDINATOR_PORT}"
    )
    store_env = [
        {"name": k, "value": v} for k, v in (object_store_env or {}).items()
    ]

    # process id = slice_index * hosts + host_index, both from downward API
    bootstrap = (
        f"export FTC_PROCESS_ID=$((FTC_SLICE_INDEX * {hosts} + JOB_COMPLETION_INDEX)) && "
    )
    trainer_cmd = bootstrap + spec.run_cmd(
        "/etc/ftc/job.json", device="cpu" if flavor.runtime == "cpu" else None
    )

    # the JobSet replicated-job index IS the slice index
    slice_index_ref = {
        "fieldRef": {
            "fieldPath": "metadata.annotations['jobset.sigs.k8s.io/job-index']"
        }
    }

    # trace propagation (docs/observability.md): every pod of every attempt
    # stamps its spans/events/logs with the job's trace id
    obs_env: list[dict[str, Any]] = []
    if job.trace_id:
        obs_env = [
            {"name": "FTC_TRACE_ID", "value": job.trace_id},
            {"name": "FTC_ATTEMPT", "value": str(max(1, job.attempt))},
        ]

    trainer_container = {
        "name": "trainer",
        "image": image,
        "command": ["/bin/sh", "-c", trainer_cmd],
        "env": [
            {"name": "FTC_COORDINATOR_ADDRESS", "value": coordinator},
            {"name": "FTC_NUM_PROCESSES", "value": str(total_processes)},
            *obs_env,
            {"name": "FTC_SLICE_INDEX", "valueFrom": slice_index_ref},
            {
                "name": "JOB_COMPLETION_INDEX",
                "valueFrom": {
                    "fieldRef": {
                        "fieldPath": (
                            "metadata.annotations"
                            "['batch.kubernetes.io/job-completion-index']"
                        )
                    }
                },
            },
            *store_env,
        ],
        "ports": [{"containerPort": COORDINATOR_PORT}],
        "resources": {
            "requests": {
                "cpu": flavor.cpu,
                "memory": flavor.memory,
                flavor.k8s_resource_name(): str(flavor.chips_per_host),
            },
            "limits": {
                flavor.k8s_resource_name(): str(flavor.chips_per_host),
            },
        },
        "volumeMounts": [
            {"name": "data", "mountPath": "/data"},
            {"name": "job-spec", "mountPath": "/etc/ftc"},
        ],
    }

    # artifact-sync sidecar (reference: aws s3 sync loop + done.txt exit,
    # PyTorchJobDeployer.py:121-168) — ours runs the storage CLI with the
    # spec's store_asset_patterns. Rendered as a NATIVE sidecar (init
    # container with restartPolicy Always, K8s >=1.28): the kubelet SIGTERMs
    # it when the trainer container terminates, and the port's storage CLI
    # makes its final pass on that signal, so a crashed trainer that never
    # touches done.txt cannot wedge the pod in Running forever.
    sync_cmd = [
        "python", "-m", f"{PACKAGE}.controller.storage_cli",
        "sync", "/data/artifacts", artifacts_uri,
        "--interval", str(sync_interval_s),
        "--until-done-file", "/data/artifacts/done.txt",
    ]
    for pattern in spec.store_asset_patterns:
        sync_cmd += ["--pattern", pattern]
    sync_container = {
        "name": "artifact-sync",
        "image": image,
        "restartPolicy": "Always",  # marks it a native sidecar
        "command": sync_cmd,
        "env": store_env,
        "volumeMounts": [{"name": "data", "mountPath": "/data"}],
    }

    # ordering: dataset fetch completes first, then the sync sidecar starts
    # and keeps running alongside the trainer
    init_containers = []
    if dataset_uri:
        # dataset-fetch init container (reference: aws s3 cp init container,
        # PyTorchJobDeployer.py:70-91)
        init_containers.append(
            {
                "name": "dataset-fetch",
                "image": image,
                "command": [
                    "python", "-m",
                    f"{PACKAGE}.controller.storage_cli",
                    "get", dataset_uri,
                    f"/data/dataset/{dataset_uri.rsplit('/', 1)[-1]}",
                ],
                "env": store_env,
                "volumeMounts": [{"name": "data", "mountPath": "/data"}],
            }
        )

    init_containers.append(sync_container)

    pod_spec: dict[str, Any] = {
        "restartPolicy": "Never",  # restarts are JobSet-level (gang semantics)
        "initContainers": init_containers,
        "containers": [trainer_container],
        "volumes": [
            {"name": "data", "emptyDir": {}},
            {"name": "job-spec", "configMap": {"name": f"{job.job_id}-spec"}},
        ],
    }
    selectors = flavor.accelerator_selectors()
    if selectors:
        pod_spec["nodeSelector"] = selectors

    return {
        "apiVersion": f"{JOBSET_GROUP}/{JOBSET_VERSION}",
        "kind": "JobSet",
        "metadata": {
            "name": job.job_id,
            "namespace": namespace,
            "labels": {
                "app": APP_LABEL,
                KUEUE_QUEUE_LABEL: flavor.queue,
                "ftc/user": _sanitize_label(job.user_id),
                "ftc/model": _sanitize_label(job.model_name),
                # total chips, as the reference records
                # (PyTorchJobDeployer.py:57-63)
                "ftc/chips": str(flavor.total_chips * max(1, job.num_slices)),
            },
        },
        "spec": {
            "suspend": True,  # Kueue admits (PyTorchJobDeployer.py:179-185)
            "failurePolicy": {"maxRestarts": max_restarts},
            "replicatedJobs": [
                {
                    "name": "slice",
                    "replicas": max(1, job.num_slices),
                    "template": {
                        "spec": {
                            "parallelism": hosts,
                            "completions": hosts,
                            "completionMode": "Indexed",
                            "backoffLimit": 0,
                            "template": {
                                "metadata": {"labels": {"app": APP_LABEL}},
                                "spec": pod_spec,
                            },
                        }
                    },
                }
            ],
        },
    }


def render_spec_configmap(
    job: JobInput, trainer_spec: dict[str, Any], namespace: str
) -> dict[str, Any]:
    return {
        "apiVersion": "v1",
        "kind": "ConfigMap",
        "metadata": {"name": f"{job.job_id}-spec", "namespace": namespace},
        "data": {"job.json": json.dumps(trainer_spec, indent=2)},
    }


def render_serve_worker_pod(
    job_id: str,
    replica_id: str,
    *,
    namespace: str,
    image: str,
    worker_spec: dict[str, Any],
    flavor: DeviceFlavor | None = None,
    port: int = 7077,
    extra_env: dict[str, str] | None = None,
) -> dict[str, Any]:
    """One POD per serve replica (docs/serving.md §Cross-process transport):
    the k8s rendering of the worker sandbox the local backend spawns as a
    subprocess.  The worker spec rides an inline env var (it is a small JSON
    document — the payload itself is staged from the object store by the
    builder inside the pod), the heartbeat/sandbox dir is an ``emptyDir``,
    and the RPC port is fixed per pod because every pod has its own IP —
    ``serve_worker_port_base`` only matters when replicas share a host.
    ``FTC_FAULT_SERVE_*`` rides ``extra_env`` so the chaos hand crosses the
    pod boundary exactly as it crosses the local process boundary."""
    spec_doc = dict(worker_spec)
    spec_doc.setdefault("sandbox", "/var/run/ftc-serve")
    spec_doc.setdefault("host", "0.0.0.0")
    spec_doc["port"] = port
    env = [
        {"name": "FTC_SERVE_WORKER_SPEC", "value": json.dumps(spec_doc)},
        *({"name": k, "value": v} for k, v in (extra_env or {}).items()),
    ]
    resources: dict[str, Any] = {}
    if flavor is not None and flavor.runtime != "cpu":
        resources = {
            "limits": {flavor.k8s_resource_name(): flavor.chips_per_host}
        }
    pod = {
        "apiVersion": "v1",
        "kind": "Pod",
        "metadata": {
            "name": f"{job_id}-serve-{replica_id}",
            "namespace": namespace,
            "labels": {
                "app": "ftc-serve-worker",
                "ftc/job": _sanitize_label(job_id),
                "ftc/replica": _sanitize_label(replica_id),
            },
        },
        "spec": {
            "restartPolicy": "Never",  # the FLEET respawns with backoff
            "containers": [{
                "name": "serve-worker",
                "image": image,
                "command": [
                    "/bin/sh", "-c",
                    "mkdir -p /var/run/ftc-serve && "
                    "printf '%s' \"$FTC_SERVE_WORKER_SPEC\" "
                    "> /var/run/ftc-serve/worker_spec.json && "
                    f"python -m {PACKAGE}.transport.worker "
                    "--spec /var/run/ftc-serve/worker_spec.json",
                ],
                "env": env,
                "ports": [{"containerPort": port, "name": "ftc-rpc"}],
                "volumeMounts": [{
                    "name": "serve-sandbox",
                    "mountPath": "/var/run/ftc-serve",
                }],
                **({"resources": resources} if resources else {}),
            }],
            "volumes": [{"name": "serve-sandbox", "emptyDir": {}}],
        },
    }
    if flavor is not None:
        selectors = flavor.accelerator_selectors()
        if selectors:
            pod["spec"]["nodeSelector"] = selectors
    return pod


def render_kueue_crds(
    catalog: DeviceCatalog, *, namespace: str = "default",
    cluster_queue: str = "ftc-cluster-queue",
) -> list[dict[str, Any]]:
    """ResourceFlavors + ClusterQueue + LocalQueues from the device catalog
    (replaces ``crds/kueue/*.yaml`` + ``examples/Kueue/crds``), the GPU
    flavors' quotas over ``nvidia.com/gpu``."""
    out: list[dict[str, Any]] = []
    # Kueue requires each resource name to appear in exactly ONE resourceGroup
    # per ClusterQueue, so flavors are grouped by the resource they cover
    # (all GPU flavors share "nvidia.com/gpu")
    by_resource: dict[str, list] = {}
    for f in catalog.flavors:
        flavor_obj: dict[str, Any] = {
            "apiVersion": "kueue.x-k8s.io/v1beta1",
            "kind": "ResourceFlavor",
            "metadata": {"name": f.name},
        }
        if f.accelerator_selectors():
            flavor_obj["spec"] = {"nodeLabels": f.accelerator_selectors()}
        out.append(flavor_obj)
        by_resource.setdefault(f.k8s_resource_name(), []).append(
            {
                "name": f.name,
                "resources": [
                    {
                        "name": f.k8s_resource_name(),
                        "nominalQuota": catalog.quota_for(f.name),
                    }
                ],
            }
        )
    resource_groups = [
        {"coveredResources": [resource], "flavors": flavors}
        for resource, flavors in by_resource.items()
    ]
    out.append(
        {
            "apiVersion": "kueue.x-k8s.io/v1beta1",
            "kind": "ClusterQueue",
            "metadata": {"name": cluster_queue},
            "spec": {
                "namespaceSelector": {},
                "resourceGroups": resource_groups,
            },
        }
    )
    for queue in sorted({f.queue for f in catalog.flavors}):
        out.append(
            {
                "apiVersion": "kueue.x-k8s.io/v1beta1",
                "kind": "LocalQueue",
                "metadata": {"name": queue, "namespace": namespace},
                "spec": {"clusterQueue": cluster_queue},
            }
        )
    return out


# ---------------------------------------------------------------------------
# Kube API clients
# ---------------------------------------------------------------------------


class KubeClient:
    """Minimal async surface over the Kubernetes API (the seam the reference
    covers with the kubernetes/kubeflow SDKs — SURVEY.md §2 component 10)."""

    async def create(self, api_path: str, body: dict[str, Any]) -> dict[str, Any]:
        raise NotImplementedError

    async def get(self, api_path: str, name: str) -> dict[str, Any] | None:
        raise NotImplementedError

    async def list(self, api_path: str, label_selector: str = "") -> list[dict[str, Any]]:
        raise NotImplementedError

    async def delete(self, api_path: str, name: str) -> bool:
        raise NotImplementedError

    async def pod_log_lines(
        self, namespace: str, pod: str, *, container: str, follow: bool,
        tail_lines: int | None,
    ) -> AsyncIterator[str]:
        raise NotImplementedError

    async def close(self) -> None:
        return None


class InMemoryKubeClient(KubeClient):
    """Hermetic fake API server for tests.

    Two modes: test code may mutate ``objects`` directly to script status
    transitions, or use the built-in **Kueue/pod simulation** —
    :meth:`kueue_tick` admits suspended JobSets FIFO within a chip quota
    (unsuspend + pod creation + active status, what the real Kueue and JobSet
    operators do), and :meth:`finish_jobset` drives terminal conditions — so
    backend tests exercise the real SUSPENDED → RUNNING → terminal mapping
    and the rank-0 pod-resolution path instead of hand-written fixtures.

    On create, JobSet manifests are schema-checked the way the operators
    would reject them: coordinator DNS convention, downward-API annotation
    paths, and Indexed completion mode.
    """

    def __init__(self, *, quota_chips: int | None = None):
        self.objects: dict[tuple[str, str], dict[str, Any]] = {}
        self.pod_logs: dict[str, list[str]] = {}
        self.quota_chips = quota_chips

    # -- JobSet manifest validation (what a real API server/operator rejects) --

    @staticmethod
    def _validate_jobset(body: dict[str, Any]) -> None:
        name = body["metadata"]["name"]
        spec = body["spec"]
        if "suspend" not in spec:
            raise BackendError(f"JobSet {name}: missing spec.suspend (Kueue contract)")
        rjs = spec.get("replicatedJobs") or []
        if not rjs:
            raise BackendError(f"JobSet {name}: no replicatedJobs")
        rj = rjs[0]
        job_spec = rj["template"]["spec"]
        if job_spec.get("completionMode") != "Indexed":
            raise BackendError(
                f"JobSet {name}: completionMode must be Indexed for the "
                "downward-API completion index to exist"
            )
        pod_spec = job_spec["template"]["spec"]
        containers = {c["name"]: c for c in pod_spec.get("containers", [])}
        trainer = containers.get("trainer")
        if trainer is None:
            raise BackendError(f"JobSet {name}: no trainer container")
        env = {e["name"]: e for e in trainer.get("env", [])}
        coord = env.get("FTC_COORDINATOR_ADDRESS", {}).get("value", "")
        # the headless service JobSet creates is named after the jobset; pod 0
        # of replicated job 0 must be the coordinator
        want_prefix = f"{name}-{rj['name']}-0-0.{name}:"
        if not coord.startswith(want_prefix):
            raise BackendError(
                f"JobSet {name}: coordinator {coord!r} does not match the "
                f"JobSet DNS convention {want_prefix}<port>"
            )
        for var, field in (
            ("FTC_SLICE_INDEX", "jobset.sigs.k8s.io/job-index"),
            ("JOB_COMPLETION_INDEX", "batch.kubernetes.io/job-completion-index"),
        ):
            got = (
                env.get(var, {})
                .get("valueFrom", {})
                .get("fieldRef", {})
                .get("fieldPath", "")
            )
            if f"['{field}']" not in got:
                raise BackendError(
                    f"JobSet {name}: env {var} must come from the downward-API "
                    f"annotation {field!r}, got {got!r}"
                )

    # -- Kueue + JobSet operator simulation ------------------------------------

    def _jobsets(self) -> list[dict[str, Any]]:
        return [
            obj for (path, _), obj in self.objects.items()
            if path.endswith(f"/{JOBSET_PLURAL}")
        ]

    @staticmethod
    def _is_terminal(obj: dict[str, Any]) -> bool:
        return any(
            c.get("status") == "True" and c.get("type") in ("Completed", "Failed")
            for c in obj.get("status", {}).get("conditions", [])
        )

    @staticmethod
    def _chips(obj: dict[str, Any]) -> int:
        return int(obj["metadata"].get("labels", {}).get("ftc/chips", 0) or 0)

    def _pods_path(self, namespace: str) -> str:
        return f"/api/v1/namespaces/{namespace}/pods"

    def kueue_tick(self) -> None:
        """One reconcile pass of the fake Kueue + JobSet operators: admit
        suspended JobSets FIFO within the chip quota, then materialise pods
        and active status for every admitted, non-terminal JobSet."""
        jobsets = sorted(
            self._jobsets(), key=lambda o: o["metadata"].get("creationTimestamp", 0)
        )
        used = sum(
            self._chips(o) for o in jobsets
            if not o["spec"].get("suspend") and not self._is_terminal(o)
        )
        for obj in jobsets:
            if not obj["spec"].get("suspend") or self._is_terminal(obj):
                continue
            chips = self._chips(obj)
            if self.quota_chips is not None and used + chips > self.quota_chips:
                continue  # FIFO with borrowing disabled: later jobs may still fit
            obj["spec"]["suspend"] = False
            used += chips
        for obj in jobsets:
            if obj["spec"].get("suspend") or self._is_terminal(obj):
                continue
            self._materialise_pods(obj)

    def _materialise_pods(self, obj: dict[str, Any]) -> None:
        name = obj["metadata"]["name"]
        namespace = obj["metadata"].get("namespace", "default")
        status = obj.setdefault("status", {})
        rj_status = []
        for rj in obj["spec"]["replicatedJobs"]:
            hosts = rj["template"]["spec"].get("parallelism", 1)
            replicas = rj.get("replicas", 1)
            for slice_idx in range(replicas):
                for host_idx in range(hosts):
                    pod_name = f"{name}-{rj['name']}-{slice_idx}-{host_idx}"
                    key = (self._pods_path(namespace), pod_name)
                    if key in self.objects:
                        continue
                    self.objects[key] = {
                        "metadata": {
                            "name": pod_name,
                            "namespace": namespace,
                            "creationTimestamp": time.time(),
                            "labels": {
                                "jobset.sigs.k8s.io/jobset-name": name,
                                "jobset.sigs.k8s.io/job-index": str(slice_idx),
                                "batch.kubernetes.io/job-completion-index": str(host_idx),
                            },
                        },
                        "status": {"phase": "Running"},
                    }
                    self.pod_logs.setdefault(pod_name, []).append(
                        f"{pod_name}: training started"
                    )
            rj_status.append({"name": rj["name"], "active": replicas * hosts})
        status["replicatedJobsStatus"] = rj_status

    def finish_jobset(
        self, name: str, *, failed: bool = False, message: str = ""
    ) -> None:
        """Drive a JobSet to a terminal condition; succeeded pods are removed
        (the kubelet reaps them), failed pods stay for forensics."""
        for obj in self._jobsets():
            if obj["metadata"]["name"] != name:
                continue
            status = obj.setdefault("status", {})
            status["replicatedJobsStatus"] = []
            status.setdefault("conditions", []).append(
                {
                    "type": "Failed" if failed else "Completed",
                    "status": "True",
                    "message": message,
                }
            )
            if not failed:
                namespace = obj["metadata"].get("namespace", "default")
                for key in [
                    k for k in self.objects
                    if k[0] == self._pods_path(namespace)
                    and self.objects[k]["metadata"]["labels"].get(
                        "jobset.sigs.k8s.io/jobset-name"
                    ) == name
                ]:
                    del self.objects[key]
            return
        raise BackendError(f"unknown JobSet {name!r}")

    @staticmethod
    def _name(body: dict[str, Any]) -> str:
        return body["metadata"]["name"]

    async def create(self, api_path: str, body: dict[str, Any]) -> dict[str, Any]:
        key = (api_path, self._name(body))
        if key in self.objects:
            raise BackendError(f"{key} already exists")
        if body.get("kind") == "JobSet":
            self._validate_jobset(body)
        body.setdefault("metadata", {})["creationTimestamp"] = time.time()
        self.objects[key] = body
        return body

    async def get(self, api_path: str, name: str) -> dict[str, Any] | None:
        return self.objects.get((api_path, name))

    async def list(self, api_path: str, label_selector: str = "") -> list[dict[str, Any]]:
        out = []
        for (path, _), obj in self.objects.items():
            if path != api_path:
                continue
            if label_selector:
                want = dict(
                    part.split("=", 1) for part in label_selector.split(",")
                )
                labels = obj["metadata"].get("labels", {})
                if not all(labels.get(k) == v for k, v in want.items()):
                    continue
            out.append(obj)
        return out

    async def delete(self, api_path: str, name: str) -> bool:
        return self.objects.pop((api_path, name), None) is not None

    async def pod_log_lines(
        self, namespace: str, pod: str, *, container: str, follow: bool,
        tail_lines: int | None,
    ) -> AsyncIterator[str]:
        lines = self.pod_logs.get(pod, [])
        if tail_lines is not None:
            lines = lines[-tail_lines:]

        async def aiter() -> AsyncIterator[str]:
            for line in lines:
                yield line

        return aiter()


class HttpKubeClient(KubeClient):
    """Direct Kubernetes API access over ``controller/httpclient.py`` with
    in-cluster service-account auth (token + CA from the standard mount) —
    no SDK, no aiohttp (the reference's ``AiohttpKubeClient``).

    ``base_url`` names the API server (a ``kubectl proxy`` on
    ``http://127.0.0.1:8001``, say); without it the in-cluster address
    ``https://$KUBERNETES_SERVICE_HOST:$KUBERNETES_SERVICE_PORT`` is read at
    the first request, which raises :class:`BackendError` outside a
    cluster.  The token is the static one given, else the projected
    service-account token, re-read every ``TOKEN_TTL_S`` and after a 401;
    with neither, requests carry no ``Authorization``.
    """

    SA_DIR = Path("/var/run/secrets/kubernetes.io/serviceaccount")

    #: re-read the projected SA token at this cadence — bound tokens expire
    #: (~1h) and the kubelet rotates them on disk
    TOKEN_TTL_S = 300.0

    #: transient apiserver statuses worth retrying (rate limit + 5xx); 401
    #: additionally forces a token re-read (a rotated SA token mid-flight)
    RETRY_STATUSES = frozenset({429, 500, 502, 503, 504})
    MAX_TRIES = 4
    BASE_DELAY_S = 0.25
    #: a followed pod log whose container has not started yet (400, "is
    #: waiting to start") is asked for again every LOG_START_POLL_S, for
    #: LOG_START_WAIT_S at most: the job reads RUNNING while its pod's init
    #: containers still run
    LOG_START_WAIT_S = 600.0
    LOG_START_POLL_S = 1.0

    def __init__(self, base_url: str | None = None, token: str | None = None):
        self.base_url = base_url.rstrip("/") if base_url else None
        self._static_token = token
        self._token = token
        self._token_read_at = 0.0
        self._session = None

    def _base(self) -> str:
        if self.base_url is None:
            host = os.environ.get("KUBERNETES_SERVICE_HOST")
            port = os.environ.get("KUBERNETES_SERVICE_PORT", "443")
            if not host:
                raise BackendError(
                    "not running in-cluster and no kube API URL given "
                    "(FTC_KUBE_API_URL)"
                )
            self.base_url = f"https://{host}:{port}"
        return self.base_url

    async def _headers(self) -> dict[str, str]:
        now = time.monotonic()
        if self._static_token is None and (
            self._token is None or now - self._token_read_at > self.TOKEN_TTL_S
        ):
            token_file = self.SA_DIR / "token"

            def read_token() -> str | None:
                # projected SA token, rotated on disk by the kubelet: a small
                # file, but never read on the event loop
                if token_file.exists():
                    return token_file.read_text().strip()
                return None

            token = await asyncio.to_thread(read_token)
            if token is not None:
                self._token = token
                self._token_read_at = now
        return {"Authorization": f"Bearer {self._token}"} if self._token else {}

    def _get_session(self):
        import ssl

        from .. import httpclient

        if self._session is None:
            ca = self.SA_DIR / "ca.crt"
            ctx = ssl.create_default_context(cafile=str(ca) if ca.exists() else None)
            self._session = httpclient.ClientSession(
                ssl_context=ctx, timeout=httpclient.ClientTimeout(total=60.0)
            )
        return self._session

    async def _request(
        self,
        method: str,
        url: str,
        *,
        params: dict[str, Any] | None = None,
        json_body: dict[str, Any] | None = None,
    ) -> tuple[int, Any]:
        """One apiserver call with bounded retry/backoff.

        Retries 429 (honoring ``Retry-After``), 5xx, and transport errors
        with exponential backoff; a 401 re-reads the projected SA token once
        per attempt (kubelet rotates it on disk).  Terminal statuses (2xx,
        404, 409, 403...) return ``(status, parsed-body)`` for the caller to
        interpret."""
        from .. import httpclient

        s = self._get_session()
        delay = self.BASE_DELAY_S
        last_err: Exception | None = None
        for attempt in range(self.MAX_TRIES):
            try:
                async with s.request(
                    method, url, params=params, json=json_body,
                    headers=await self._headers(),
                ) as resp:
                    retriable = resp.status in self.RETRY_STATUSES or (
                        resp.status == 401 and self._static_token is None
                    )
                    if not retriable or attempt == self.MAX_TRIES - 1:
                        ctype = resp.headers.get("Content-Type", "")
                        body = (
                            await resp.json() if "json" in ctype
                            else await resp.text()
                        )
                        return resp.status, body
                    await resp.read()  # the connection goes back to the pool
                    if resp.status == 401:
                        self._token_read_at = 0.0  # force token re-read
                    retry_after = resp.headers.get("Retry-After")
                    if retry_after:
                        try:
                            delay = max(delay, float(retry_after))
                        except ValueError:
                            pass
                    last_err = BackendError(
                        f"{method} {url} -> {resp.status} (attempt {attempt + 1})"
                    )
            except (httpclient.ClientError, TimeoutError) as e:
                if attempt == self.MAX_TRIES - 1:
                    raise BackendError(f"{method} {url} failed: {e}") from e
                last_err = e
            await asyncio.sleep(delay)
            delay *= 2
        raise BackendError(f"{method} {url} failed after retries: {last_err}")

    async def create(self, api_path: str, body: dict[str, Any]) -> dict[str, Any]:
        url = f"{self._base()}{api_path}"
        status, payload = await self._request("POST", url, json_body=body)
        if status == 409:
            # AlreadyExists — idempotent create: a resubmit after a crashed
            # ack must not fail the job; adopt the live object instead
            name = body.get("metadata", {}).get("name", "")
            existing = await self.get(api_path, name) if name else None
            if existing is not None:
                return existing
        if status >= 300:
            raise BackendError(f"create failed ({status}): {payload}")
        return payload

    async def get(self, api_path: str, name: str) -> dict[str, Any] | None:
        status, payload = await self._request(
            "GET", f"{self._base()}{api_path}/{name}"
        )
        if status == 404:
            return None
        if status >= 300:
            raise BackendError(f"get failed ({status}): {payload}")
        return payload

    async def list(self, api_path: str, label_selector: str = "") -> list[dict[str, Any]]:
        params = {"labelSelector": label_selector} if label_selector else None
        status, payload = await self._request(
            "GET", f"{self._base()}{api_path}", params=params
        )
        if status >= 300:
            raise BackendError(f"list failed ({status}): {payload}")
        return payload.get("items", [])

    async def delete(self, api_path: str, name: str) -> bool:
        status, _ = await self._request(
            "DELETE", f"{self._base()}{api_path}/{name}"
        )
        return status < 300

    async def pod_log_lines(
        self, namespace: str, pod: str, *, container: str, follow: bool,
        tail_lines: int | None,
    ) -> AsyncIterator[str]:
        from .. import httpclient

        s = self._get_session()
        params: dict[str, Any] = {"container": container}
        if follow:
            params["follow"] = "true"
        if tail_lines is not None:
            params["tailLines"] = str(tail_lines)
        url = f"{self._base()}/api/v1/namespaces/{namespace}/pods/{pod}/log"
        headers = await self._headers()

        async def aiter() -> AsyncIterator[str]:
            deadline = time.monotonic() + self.LOG_START_WAIT_S
            while True:
                # a followed log lasts as long as the container: no total
                # timeout
                async with s.get(url, params=params, headers=headers,
                                 timeout=httpclient.ClientTimeout()) as resp:
                    if resp.status == 400 and follow and time.monotonic() < deadline:
                        body = await resp.text()
                        if "is waiting to start" in body:
                            # the pod's init containers (dataset fetch) are
                            # still running: the API server answers 400
                            # until the container starts
                            await asyncio.sleep(self.LOG_START_POLL_S)
                            continue
                        raise BackendError(f"pod logs failed (400): {body}")
                    if resp.status >= 300:
                        raise BackendError(f"pod logs failed ({resp.status})")
                    async for raw in resp.content:
                        yield raw.decode(errors="replace").rstrip("\n")
                    return

        return aiter()

    async def close(self) -> None:
        if self._session is not None:
            await self._session.close()
            self._session = None


# ---------------------------------------------------------------------------
# The backend
# ---------------------------------------------------------------------------


def map_jobset_state(obj: dict[str, Any]) -> tuple[BackendJobState, str]:
    """JobSet status → backend state (replaces the Kubeflow condition mapping,
    ``app/schemas/kubeflow_schemas.py:61-85``)."""
    spec = obj.get("spec", {})
    status = obj.get("status", {})
    conditions = status.get("conditions", [])
    for cond in conditions:
        if cond.get("status") != "True":
            continue
        if cond.get("type") == "Completed":
            return BackendJobState.SUCCEEDED, cond.get("message", "")
        if cond.get("type") == "Failed":
            return BackendJobState.FAILED, cond.get("message", "")
    restarts = int(status.get("restarts", 0) or 0)
    if restarts > 0:
        return BackendJobState.RESTARTING, f"restarts={restarts}"
    if spec.get("suspend"):
        return BackendJobState.SUSPENDED, "awaiting quota"
    if any(rj.get("active") for rj in status.get("replicatedJobsStatus", [])):
        return BackendJobState.RUNNING, ""
    return BackendJobState.CREATED, ""


class K8sJobSetBackend(TrainingBackend):
    """Cluster execution via JobSet CRs, Kueue-scheduled."""

    def __init__(
        self,
        catalog: DeviceCatalog,
        settings: Any,
        *,
        client: KubeClient | None = None,
        image: str = "finetune-controller-tpu-torch:latest",
        object_store_env: dict[str, str] | None = None,
    ):
        self.catalog = catalog
        self.settings = settings
        self.namespace = settings.namespace
        self.client = client or HttpKubeClient(
            getattr(settings, "kube_api_url", "") or None
        )
        self.image = image
        self.object_store_env = object_store_env or {}

    # API paths
    @property
    def _jobsets_path(self) -> str:
        return (
            f"/apis/{JOBSET_GROUP}/{JOBSET_VERSION}"
            f"/namespaces/{self.namespace}/{JOBSET_PLURAL}"
        )

    @property
    def _configmaps_path(self) -> str:
        return f"/api/v1/namespaces/{self.namespace}/configmaps"

    async def submit(
        self,
        job: JobInput,
        spec: BaseFineTuneJob,
        flavor: DeviceFlavor,
        *,
        dataset_uri: str | None,
        artifacts_uri: str,
    ) -> None:
        from ...sched.queues import DEFAULT_QUEUE, PRIORITY_CLASSES, parse_priority

        pods = flavor.hosts * max(1, job.num_slices)
        if pods > 1:
            raise NotImplementedError(
                f"device {flavor.name!r} x {max(1, job.num_slices)} slice(s) = "
                f"{pods} pods: the port trains on one card in one pod; "
                "multi-host jobs are not ported yet (ROADMAP Queue A item 7)"
            )
        try:
            non_default_priority = (
                parse_priority(job.priority) != PRIORITY_CLASSES["normal"]
            )
        except ValueError:
            non_default_priority = True  # unparseable: certainly not default
        if job.queue != DEFAULT_QUEUE or non_default_priority:
            # tenant queue/priority are the in-repo fair-share scheduler's
            # vocabulary (docs/scheduling.md); on k8s, admission belongs to
            # Kueue (LocalQueue label from the flavor + WorkloadPriorityClass
            # CRs).  Say so loudly rather than silently dropping the intent.
            logger.warning(
                "job %s: queue=%r priority=%r are ignored on the k8s "
                "backend — admission is Kueue's (flavor LocalQueue %r); "
                "configure Kueue WorkloadPriorityClass for priorities",
                job.job_id, job.queue, job.priority, flavor.queue,
            )
        trainer_spec = render_trainer_spec(
            job, spec, flavor, dataset_uri=dataset_uri
        )
        cm = render_spec_configmap(job, trainer_spec, self.namespace)
        jobset = render_jobset(
            job, spec, flavor,
            namespace=self.namespace,
            image=self.image,
            dataset_uri=dataset_uri,
            artifacts_uri=artifacts_uri,
            sync_interval_s=self.settings.artifact_sync_interval_s,
            object_store_env=self.object_store_env,
        )
        await self.client.create(self._configmaps_path, cm)
        try:
            await self.client.create(self._jobsets_path, jobset)
        except Exception:
            await self.client.delete(self._configmaps_path, cm["metadata"]["name"])
            raise

    def _report(self, obj: dict[str, Any]) -> BackendJobReport:
        state, message = map_jobset_state(obj)
        status = obj.get("status", {})
        start = _parse_k8s_time(status.get("startTime"))
        completion = _parse_k8s_time(status.get("completionTime"))
        if completion is None and state in BackendJobState.stopped_states():
            # JobSet's own status carries no completionTime; the terminal
            # condition's transition time is the ground truth
            for cond in status.get("conditions", []):
                if cond.get("type") in ("Completed", "Failed") and cond.get(
                    "status"
                ) == "True":
                    completion = _parse_k8s_time(cond.get("lastTransitionTime"))
        return BackendJobReport(
            job_id=obj["metadata"]["name"],
            state=state,
            start_time=start,
            completion_time=completion,
            message=message,
            metadata={"restarts": int(status.get("restarts", 0) or 0)},
        )

    async def list_jobs(self) -> list[BackendJobReport]:
        objs = await self.client.list(self._jobsets_path, f"app={APP_LABEL}")
        return [self._report(o) for o in objs]

    async def get_job(self, job_id: str) -> BackendJobReport | None:
        obj = await self.client.get(self._jobsets_path, job_id)
        return self._report(obj) if obj else None

    async def delete_job(self, job_id: str, *,
                         forget_reservations: bool = False) -> bool:
        # forget_reservations is part of the backend contract (base.py) but
        # moot here: Kueue owns admission, this backend holds no in-process
        # scheduler reservations
        await self.client.delete(self._configmaps_path, f"{job_id}-spec")
        return await self.client.delete(self._jobsets_path, job_id)

    async def queue_snapshot(self) -> list[str]:
        """Suspended jobsets in creation order — the reference's Kubeflow
        fallback queue (``kueue_helpers.py:84-122``; the Kueue Workload API
        would be the richer source, same as the reference's primary path)."""
        objs = await self.client.list(self._jobsets_path, f"app={APP_LABEL}")
        suspended = [
            o for o in objs
            if map_jobset_state(o)[0] is BackendJobState.SUSPENDED
        ]
        suspended.sort(key=lambda o: o["metadata"].get("creationTimestamp", 0))
        return [o["metadata"]["name"] for o in suspended]

    async def _rank0_pod_name(self, job_id: str) -> str:
        """Resolve the rank-0 pod by labels — indexed-Job pods carry a random
        name suffix, so the deterministic ``{job}-0`` string is only the pod
        *hostname*, never its name. Peer-aware replacement for the
        reference's master-pod lookup (``stream_logger.py:142-144``)."""
        selector = (
            f"jobset.sigs.k8s.io/jobset-name={job_id},"
            "batch.kubernetes.io/job-completion-index=0,"
            "jobset.sigs.k8s.io/job-index=0"
        )
        pods = await self.client.list(
            f"/api/v1/namespaces/{self.namespace}/pods", selector
        )
        if not pods:
            raise BackendError(f"no rank-0 pod found for {job_id!r}")
        # newest pod wins (restarts leave terminated predecessors around)
        pods.sort(
            key=lambda p: str(p["metadata"].get("creationTimestamp", "")),
            reverse=True,
        )
        return pods[0]["metadata"]["name"]

    async def read_logs(
        self,
        job_id: str,
        *,
        follow: bool = False,
        last_lines: int | None = None,
    ) -> AsyncIterator[str]:
        pod = await self._rank0_pod_name(job_id)
        return await self.client.pod_log_lines(
            self.namespace, pod,
            container="trainer", follow=follow, tail_lines=last_lines,
        )

    async def close(self) -> None:
        await self.client.close()
