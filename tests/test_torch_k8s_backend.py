"""The port's k8s backend (``controller/backends/k8s.py``) against the JAX
package's, on the same inputs, and the port's backend end to end against
``chip_smoke.KubeEndpoint`` on the CPU.

* ``render_jobset``, the spec ConfigMap and the Kueue CRDs of one-card
  flavors are equal to the reference's after a normalisation, and only
  this one: the accelerator's resource key (``nvidia.com/gpu`` for
  ``google.com/tpu``), the node selectors (the flavor's own labels for the
  GKE TPU ones), the module paths (``finetune_controller_tpu_torch.`` for
  ``finetune_controller_tpu.``), the TPU-only rendering (MEGASCALE env, the
  GKE-nodepool exclusive-topology annotation) and a cpu flavor's trainer
  ``--device cpu``;
* ``map_jobset_state`` gives the same state and message on a table of
  status objects; both ``InMemoryKubeClient``\\ s refuse the same malformed
  JobSets with the same words;
* one scripted lifecycle (hand-written transitions, then the simulated
  Kueue) gives the same state sequence, queue snapshots, rank-0 log and
  deletions through both backends, and the monitor reconciles the same
  record sequence over both;
* a multi-host job is refused, naming ROADMAP item 7;
* ``render_serve_worker_pod`` pins what ``tests/test_transport.py`` pins;
* the port's server, ``FTC_BACKEND=k8s``, submits a ``tiny-test`` job on
  the CPU flavor to ``KubeEndpoint``, whose kubelet runs its pod; the
  standalone ``monitor_main`` alone moves it to SUCCEEDED.

Tolerance: exact (manifests, states, messages, records).
"""

from __future__ import annotations

import asyncio
import copy
import json
import sys
import time
from pathlib import Path

import pytest

from finetune_controller_tpu.controller import devices as ref_devices
from finetune_controller_tpu.controller import examples as ref_examples
from finetune_controller_tpu.controller.backends import k8s as ref_k8s
from finetune_controller_tpu.controller.backends.base import BackendError as RefBackendError
from finetune_controller_tpu.controller import config as ref_config
from finetune_controller_tpu.controller import monitor as ref_monitor
from finetune_controller_tpu.controller import objectstore as ref_objectstore
from finetune_controller_tpu.controller import schemas as ref_schemas
from finetune_controller_tpu.controller import statestore as ref_statestore
from finetune_controller_tpu.controller import task_builder as ref_task_builder
from finetune_controller_tpu_torch.controller import config as port_config
from finetune_controller_tpu_torch.controller import devices as port_devices
from finetune_controller_tpu_torch.controller import examples as port_examples
from finetune_controller_tpu_torch.controller import monitor as port_monitor
from finetune_controller_tpu_torch.controller import objectstore as port_objectstore
from finetune_controller_tpu_torch.controller import schemas as port_schemas
from finetune_controller_tpu_torch.controller import statestore as port_statestore
from finetune_controller_tpu_torch.controller import task_builder as port_task_builder
from finetune_controller_tpu_torch.controller.backends import k8s as port_k8s
from finetune_controller_tpu_torch.controller.backends.base import BackendError

ROOT = Path(__file__).resolve().parents[1]
PORT_CATALOG = port_devices.default_catalog()
#: the port's flavors as the reference renders them: the same fields, the
#: accelerator a TPU
GPU_SELECTORS = {"nvidia.com/gpu.product": "NVIDIA-H100-80GB-HBM3"}
PKG = {
    "ref": dict(k8s=ref_k8s, devices=ref_devices, examples=ref_examples,
                schemas=ref_schemas, config=ref_config, monitor=ref_monitor,
                objectstore=ref_objectstore, statestore=ref_statestore,
                task_builder=ref_task_builder, error=RefBackendError),
    "port": dict(k8s=port_k8s, devices=port_devices, examples=port_examples,
                 schemas=port_schemas, config=port_config, monitor=port_monitor,
                 objectstore=port_objectstore, statestore=port_statestore,
                 task_builder=port_task_builder, error=BackendError),
}


def run(coro, timeout: float = 60):
    return asyncio.run(asyncio.wait_for(coro, timeout))


def flavor(pkg: str, name: str, **overrides):
    """The port catalog's flavor ``name`` in ``pkg``'s model (``runtime``
    tpu for the reference's copy of a cuda flavor)."""
    fields = {**PORT_CATALOG.get(name).model_dump(), **overrides}
    if pkg == "ref":
        fields["runtime"] = {"cuda": "tpu"}.get(fields["runtime"], fields["runtime"])
        fields["generation"] = {"h100": "v5e"}.get(fields["generation"], fields["generation"])
        return ref_devices.DeviceFlavor(**fields)
    return port_devices.DeviceFlavor(**fields)


def catalog(pkg: str):
    return PKG[pkg]["devices"].DeviceCatalog(
        flavors=[flavor(pkg, f.name) for f in PORT_CATALOG.flavors],
        quotas=[q.model_dump() for q in PORT_CATALOG.quotas],
        default_flavor=PORT_CATALOG.default_flavor)


def tiny_spec(pkg: str, steps: int = 3):
    ex = PKG[pkg]["examples"]
    return ex.TinyTestLoRA(training_arguments=ex.LoRASFTArguments(
        total_steps=steps, warmup_steps=1, batch_size=2, seq_len=16, lora_rank=2))


def job(pkg: str, job_id: str = "llama3-8b-lora-abc12345", device: str = "h100", **kw):
    return PKG[pkg]["schemas"].JobInput(
        job_id=job_id, user_id="alice", model_name="llama3-8b-lora", device=device,
        arguments={}, **kw)


def normalise(obj, pkg: str, runtime: str):
    """The listed normalisation (module docstring), applied to ``pkg``'s
    rendering."""
    text = json.dumps(obj)
    if pkg == "ref":
        text = text.replace("finetune_controller_tpu.", "finetune_controller_tpu_torch.")
        text = text.replace('"google.com/tpu"', '"nvidia.com/gpu"')
    elif runtime == "cpu":
        text = text.replace(" --device cpu", "")
    out = json.loads(text)

    def walk(node):
        if isinstance(node, dict):
            node.pop("nodeSelector", None)
            node.pop("nodeLabels", None)
            node.get("annotations", {}).pop("alpha.jobset.sigs.k8s.io/exclusive-topology", None)
            if node.get("annotations") == {}:
                node.pop("annotations")
            if isinstance(node.get("env"), list):
                node["env"] = [e for e in node["env"]
                               if not e["name"].startswith("MEGASCALE_")]
            for v in node.values():
                walk(v)
            if node.get("spec") == {}:  # a ResourceFlavor with no node labels
                node.pop("spec")
        elif isinstance(node, list):
            for v in node:
                walk(v)

    walk(out)
    return out


@pytest.mark.parametrize("dataset", [None, "obj://datasets/alice/d1/train.jsonl"])
@pytest.mark.parametrize("name,selectors", [("h100", {}), ("h100", GPU_SELECTORS),
                                            ("cpu-test", {})])
def test_jobset_and_configmap_match_the_reference(name, selectors, dataset):
    renders = {}
    for pkg in PKG:
        k8s = PKG[pkg]["k8s"]
        fl = flavor(pkg, name, node_selectors=selectors)
        j = job(pkg, device=name, trace_id="0123456789abcdef", attempt=2)
        js = k8s.render_jobset(
            j, tiny_spec(pkg), fl, namespace="ftc", image="ftc:test", dataset_uri=dataset,
            artifacts_uri="obj://artifacts/finetune_jobs/alice/j/artifacts",
            sync_interval_s=5.0, object_store_env={"FTC_OBJECT_STORE_BACKEND": "s3"})
        spec = k8s.render_trainer_spec(j, tiny_spec(pkg), fl, dataset_uri=dataset)
        renders[pkg] = (js, k8s.render_spec_configmap(j, spec, "ftc"), fl)
    port_js, port_cm, port_fl = renders["port"]
    pod = port_js["spec"]["replicatedJobs"][0]["template"]["spec"]["template"]["spec"]
    trainer = pod["containers"][0]
    want = "cpu" if name == "cpu-test" else "nvidia.com/gpu"
    assert trainer["resources"]["limits"] == {want: "1"}
    assert trainer["resources"]["requests"][want] == "1"
    assert pod.get("nodeSelector", {}) == selectors
    assert "--device cpu" in trainer["command"][-1] if name == "cpu-test" else (
        "--device" not in trainer["command"][-1])
    assert "exclusive-topology" not in json.dumps(port_js)
    for obj in (port_js, port_cm):
        assert "finetune_controller_tpu." not in json.dumps(obj)
    runtime = port_fl.runtime
    assert normalise(port_js, "port", runtime) == normalise(renders["ref"][0], "ref", runtime)
    assert port_cm == renders["ref"][1]


def test_kueue_crds_match_the_reference():
    port = port_k8s.render_kueue_crds(catalog("port"), namespace="ftc")
    ref = ref_k8s.render_kueue_crds(catalog("ref"), namespace="ftc")
    assert normalise(port, "port", "cuda") == normalise(ref, "ref", "cuda")
    cq = next(c for c in port if c["kind"] == "ClusterQueue")
    groups = {tuple(g["coveredResources"]): g["flavors"] for g in cq["spec"]["resourceGroups"]}
    assert sorted(groups) == [("cpu",), ("nvidia.com/gpu",)]
    assert groups[("nvidia.com/gpu",)] == [
        {"name": "h100", "resources": [{"name": "nvidia.com/gpu", "nominalQuota": 1}]}]


STATUS_TABLE = [
    {"spec": {"suspend": True}},
    {"spec": {}},
    {"spec": {}, "status": {"replicatedJobsStatus": [{"active": 1}]}},
    {"spec": {}, "status": {"replicatedJobsStatus": [{"active": 0}]}},
    {"spec": {"suspend": True}, "status": {"replicatedJobsStatus": [{"active": 1}]}},
    {"spec": {}, "status": {"restarts": 2}},
    {"spec": {}, "status": {"restarts": "1", "replicatedJobsStatus": [{"active": 1}]}},
    {"spec": {}, "status": {"conditions": [{"type": "Completed", "status": "True"}]}},
    {"spec": {}, "status": {"conditions": [{"type": "Completed", "status": "False"}],
                            "replicatedJobsStatus": [{"active": 1}]}},
    {"spec": {}, "status": {"conditions": [{"type": "Failed", "status": "True",
                                            "message": "boom"}], "restarts": 2}},
    {"spec": {"suspend": True}, "status": {"conditions": [
        {"type": "Suspended", "status": "True"},
        {"type": "Completed", "status": "True", "message": "done"}]}},
]


@pytest.mark.parametrize("obj", STATUS_TABLE, ids=lambda o: json.dumps(o)[:60])
def test_map_jobset_state_agrees(obj):
    port = port_k8s.map_jobset_state(copy.deepcopy(obj))
    ref = ref_k8s.map_jobset_state(copy.deepcopy(obj))
    assert (port[0].value, port[1]) == (ref[0].value, ref[1])


def _break(js: dict, how: str) -> None:
    rj = js["spec"]["replicatedJobs"][0]
    pod = rj["template"]["spec"]["template"]["spec"]
    env = {e["name"]: e for e in pod["containers"][0]["env"]}
    if how == "coordinator":
        env["FTC_COORDINATOR_ADDRESS"]["value"] = "wrong-host:1234"
    elif how == "slice_index":
        env["FTC_SLICE_INDEX"]["valueFrom"]["fieldRef"]["fieldPath"] = \
            "metadata.annotations['wrong/key']"
    elif how == "completion_index":
        env["JOB_COMPLETION_INDEX"]["valueFrom"]["fieldRef"]["fieldPath"] = "metadata.name"
    elif how == "not_indexed":
        rj["template"]["spec"]["completionMode"] = "NonIndexed"
    elif how == "no_suspend":
        del js["spec"]["suspend"]
    elif how == "no_replicated_jobs":
        js["spec"]["replicatedJobs"] = []
    elif how == "no_trainer":
        pod["containers"][0]["name"] = "main"


@pytest.mark.parametrize("how", ["coordinator", "slice_index", "completion_index",
                                 "not_indexed", "no_suspend", "no_replicated_jobs",
                                 "no_trainer"])
def test_both_fakes_refuse_the_same_malformed_jobsets(how):
    words = {}
    for pkg in PKG:
        k8s = PKG[pkg]["k8s"]
        js = k8s.render_jobset(job(pkg, job_id="bad-1"), tiny_spec(pkg), flavor(pkg, "h100"),
                               namespace="ftc", image="x", dataset_uri=None,
                               artifacts_uri="obj://artifacts/x")
        _break(js, how)
        with pytest.raises(PKG[pkg]["error"]) as ei:
            run(k8s.InMemoryKubeClient().create("/apis/x/jobsets", js))
        words[pkg] = str(ei.value)
    assert words["port"] == words["ref"]


async def _lifecycle(pkg: str) -> list:
    """tests/test_k8s_backend.py's scripted and simulated lifecycles, as
    one trace of what the backend answers."""
    p = PKG[pkg]
    k8s, trace = p["k8s"], []
    client = k8s.InMemoryKubeClient()
    backend = k8s.K8sJobSetBackend(catalog(pkg), p["config"].Settings(namespace="ftc"),
                                   client=client)

    async def report(job_id):
        r = await backend.get_job(job_id)
        return None if r is None else (r.state.value, r.start_time, r.completion_time,
                                       r.message, r.metadata)

    j = job(pkg)
    await backend.submit(j, tiny_spec(pkg), flavor(pkg, "h100"), dataset_uri=None,
                         artifacts_uri="obj://artifacts/x")
    trace += [[r.state.value for r in await backend.list_jobs()],
              await backend.queue_snapshot(), sorted(k[1] for k in client.objects)]
    obj = client.objects[(backend._jobsets_path, j.job_id)]
    obj["spec"]["suspend"] = False
    obj["status"] = {"replicatedJobsStatus": [{"active": 1}], "startTime": 100.0}
    trace += [await report(j.job_id), await backend.queue_snapshot()]
    obj["status"] = {"conditions": [{"type": "Completed", "status": "True",
                                     "lastTransitionTime": "2026-07-29T11:00:00Z"}],
                     "startTime": "2026-07-29T10:00:00Z"}
    trace.append(await report(j.job_id))
    pod_name = f"{j.job_id}-slice-0-0-x7k2p"
    client.objects[("/api/v1/namespaces/ftc/pods", pod_name)] = {"metadata": {
        "name": pod_name, "creationTimestamp": "2026-07-29T10:00:00Z",
        "labels": {"jobset.sigs.k8s.io/jobset-name": j.job_id,
                   "batch.kubernetes.io/job-completion-index": "0",
                   "jobset.sigs.k8s.io/job-index": "0"}}}
    client.pod_logs[pod_name] = ["step 1", "step 2"]
    trace.append([line async for line in await backend.read_logs(j.job_id, last_lines=1)])
    trace += [await backend.delete_job(j.job_id), await backend.list_jobs(),
              sorted(k[1] for k in client.objects)]

    # the simulated Kueue: one h100 at a time
    client = k8s.InMemoryKubeClient(quota_chips=1)
    backend = k8s.K8sJobSetBackend(catalog(pkg), p["config"].Settings(namespace="ftc"),
                                   client=client)
    for job_id in ("sim-1", "sim-2"):
        await backend.submit(job(pkg, job_id=job_id), tiny_spec(pkg), flavor(pkg, "h100"),
                             dataset_uri=None, artifacts_uri="obj://artifacts/x")
    trace.append(await backend.queue_snapshot())
    client.kueue_tick()
    trace += [(await report("sim-1"))[0], (await report("sim-2"))[0],
              await backend.queue_snapshot(),
              [line async for line in await backend.read_logs("sim-1")]]
    client.finish_jobset("sim-1")
    trace.append((await report("sim-1"))[0])
    client.kueue_tick()
    trace.append((await report("sim-2"))[0])
    client.finish_jobset("sim-2", failed=True, message="boom")
    trace += [await report("sim-2"),
              [o["metadata"]["name"] for o in await client.list(
                  "/api/v1/namespaces/ftc/pods", "jobset.sigs.k8s.io/jobset-name=sim-2")]]
    with pytest.raises(p["error"], match="no rank-0 pod"):
        await backend.read_logs("sim-1")
    await backend.close()
    return trace


def test_lifecycle_matches_the_reference():
    port, ref = run(_lifecycle("port")), run(_lifecycle("ref"))
    assert port == ref
    assert port[0] == ["Suspended"] and port[1] == ["llama3-8b-lora-abc12345"]
    assert port[3][0] == "Running" and port[5][0] == "Succeeded"
    assert port[5][2] - port[5][1] == 3600.0
    assert port[6] == ["step 2"] and port[7] is True


async def _reconcile(pkg: str, tmp: Path) -> list:
    p = PKG[pkg]
    client = p["k8s"].InMemoryKubeClient()
    backend = p["k8s"].K8sJobSetBackend(catalog(pkg), p["config"].Settings(namespace="ftc"),
                                        client=client)
    state = p["statestore"].StateStore(tmp / pkg / "state")
    store = p["objectstore"].LocalObjectStore(tmp / pkg / "objects")
    await state.connect()
    monitor = p["monitor"].JobMonitor(state, store, backend, interval_s=0.1)
    j = job(pkg, device="h100")
    await p["task_builder"].task_builder(
        j, tiny_spec(pkg), p["task_builder"].DatasetInput(), state=state, store=store,
        backend=backend, catalog=catalog(pkg), datasets_bucket="datasets",
        artifacts_bucket="artifacts")
    trace = []

    async def tick():
        await monitor.tick()
        rec = await state.get_job(j.job_id)
        trace.append((rec.status.value, rec.queue_position, rec.training_duration,
                      sorted(k[1] for k in client.objects)))

    await tick()
    obj = client.objects[(backend._jobsets_path, j.job_id)]
    obj["spec"]["suspend"] = False
    obj["status"] = {"replicatedJobsStatus": [{"active": 1}], "startTime": 5.0}
    await tick()
    obj["status"] = {"conditions": [{"type": "Completed", "status": "True"}],
                     "startTime": 5.0, "completionTime": 65.0}
    await tick()
    await state.close()
    await store.close()
    return trace


def test_monitor_reconciles_over_both_backends(tmp_path):
    port, ref = run(_reconcile("port", tmp_path)), run(_reconcile("ref", tmp_path))
    assert port == ref
    assert [t[:3] for t in port] == [("queued", 1, None), ("running", None, None),
                                     ("succeeded", None, 60.0)]
    assert port[-1][3] == []  # the monitor deleted the JobSet and the ConfigMap


@pytest.mark.parametrize("name,hosts,slices", [("cpu-test", 1, 2), ("h100", 1, 2),
                                               ("h100", 2, 1)])
def test_multi_host_is_refused_naming_item_7(name, hosts, slices):
    client = port_k8s.InMemoryKubeClient()
    backend = port_k8s.K8sJobSetBackend(PORT_CATALOG, port_config.Settings(), client=client)
    with pytest.raises(NotImplementedError, match="ROADMAP Queue A item 7"):
        run(backend.submit(job("port", device=name, num_slices=slices), tiny_spec("port"),
                           flavor("port", name, hosts=hosts), dataset_uri=None,
                           artifacts_uri="obj://artifacts/x"))
    assert client.objects == {}


def test_serve_worker_pod_matches_the_transport_test():
    pods = {}
    for pkg in PKG:
        pods[pkg] = PKG[pkg]["k8s"].render_serve_worker_pod(
            "job-1", "r0", namespace="ftc", image="img:tag",
            worker_spec={"job_id": "job-1", "replica_id": "r0", "builder": "deploy_dir",
                         "builder_kwargs": {"dir": "/stage"}},
            flavor=flavor(pkg, "h100"), extra_env={"FTC_FAULT_SERVE_REPLICA": "r0"})
    pod = pods["port"]
    assert pod["kind"] == "Pod"
    assert pod["metadata"]["name"] == "job-1-serve-r0"
    assert pod["spec"]["restartPolicy"] == "Never"
    container = pod["spec"]["containers"][0]
    env = {e["name"]: e.get("value") for e in container["env"]}
    spec_doc = json.loads(env["FTC_SERVE_WORKER_SPEC"])
    assert spec_doc["replica_id"] == "r0"
    assert spec_doc["port"] == container["ports"][0]["containerPort"]
    assert env["FTC_FAULT_SERVE_REPLICA"] == "r0"
    assert "finetune_controller_tpu_torch.transport.worker" in container["command"][-1]
    assert container["resources"] == {"limits": {"nvidia.com/gpu": 1}}
    assert normalise(pod, "port", "cuda") == normalise(pods["ref"], "ref", "cuda")


def test_runtime_passes_the_store_env_and_the_api_url(tmp_path, monkeypatch):
    from finetune_controller_tpu_torch.controller.runtime import build_runtime

    monkeypatch.setenv("AWS_ACCESS_KEY_ID", "AKID")
    monkeypatch.setenv("AWS_SECRET_ACCESS_KEY", "secret")
    monkeypatch.delenv("AWS_SESSION_TOKEN", raising=False)
    rt = build_runtime(port_config.Settings(
        backend="k8s", kube_api_url="http://127.0.0.1:8001/", object_store_backend="s3",
        s3_endpoint="http://s3.local", s3_bucket_prefix="team-", state_dir=str(tmp_path)))
    assert isinstance(rt.backend, port_k8s.K8sJobSetBackend)
    assert rt.backend.client.base_url == "http://127.0.0.1:8001"
    env = rt.backend.object_store_env
    assert {k: env[k] for k in ("FTC_OBJECT_STORE_BACKEND", "FTC_S3_ENDPOINT",
                                "FTC_S3_BUCKET_PREFIX", "AWS_ACCESS_KEY_ID",
                                "AWS_SECRET_ACCESS_KEY")} == {
        "FTC_OBJECT_STORE_BACKEND": "s3", "FTC_S3_ENDPOINT": "http://s3.local",
        "FTC_S3_BUCKET_PREFIX": "team-", "AWS_ACCESS_KEY_ID": "AKID",
        "AWS_SECRET_ACCESS_KEY": "secret"}
    assert "AWS_SESSION_TOKEN" not in env
    # in-cluster: the address is read at the first request
    monkeypatch.delenv("KUBERNETES_SERVICE_HOST", raising=False)
    with pytest.raises(BackendError, match="FTC_KUBE_API_URL"):
        run(port_k8s.HttpKubeClient().list("/api/v1/namespaces/x/pods"))
    monkeypatch.setenv("KUBERNETES_SERVICE_HOST", "10.0.0.1")
    client = port_k8s.HttpKubeClient()
    assert client._base() == "https://10.0.0.1:443"


# ---------------------------------------------------------------------------
# The port's server, the k8s backend and a standalone monitor on the CPU
# ---------------------------------------------------------------------------


def test_kube_endpoint_runs_a_tiny_job_reconciled_by_the_daemon(tmp_path, monkeypatch):
    """``chip_smoke.KubeEndpoint`` drives a ``tiny-test-lora`` job on
    ``cpu-test`` end to end: the port's server (in process, no monitor of
    its own) renders a ConfigMap and a JobSet, the endpoint's Kueue admits
    it, its kubelet fetches the dataset, runs the trainer with ``--device
    cpu`` beside the artifact-sync sidecar and SIGTERMs the sidecar when
    the trainer exits; ``monitor_main``, a process of its own sharing the
    sqlite state, alone moves the job to SUCCEEDED and deletes the JobSet.
    A followed pod log over the endpoint gives the trainer's log."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs

    monkeypatch.setattr(cs, "DEVICE", "cpu")
    t0 = time.time()
    kube = cs.KubeEndpoint(tmp_path / "kube", gpus=1)
    env = {"FTC_BACKEND": "k8s", "FTC_KUBE_API_URL": kube.endpoint, "FTC_NAMESPACE": "ftc",
           "FTC_MONITOR_IN_PROCESS": "false", "FTC_ENVIRONMENT": "local",
           "FTC_ARTIFACT_SYNC_INTERVAL_S": "30", "FTC_JOB_MONITOR_INTERVAL_S": "0.2",
           "FTC_RETRY_MAX_ATTEMPTS": "0"}
    ctrl = tmp_path / "ctrl"
    daemon = cs._start_monitor_daemon(tmp_path, {
        **env, "FTC_STATE_DIR": str(ctrl / "state"),
        "FTC_OBJECT_STORE_ROOT": str(ctrl / "objects")})
    try:
        with cs.control_plane(ctrl, env) as ctx:
            api, scrape, rt, settings, on_loop, _ = ctx
            rows = b"".join(json.dumps({"text": f"row {i} " * 4}).encode() + b"\n"
                            for i in range(16))
            dataset = api.ok("POST", "/datasets", files={"file": ("train.jsonl", rows)},
                             want=(201,))
            job_id = api.ok("POST", "/jobs", fields={
                "model_name": "tiny-test-lora", "device": "cpu-test",
                "dataset_id": dataset["dataset_id"],
                "arguments": json.dumps({"total_steps": 3, "batch_size": 2, "seq_len": 16,
                                         "lora_rank": 2, "warmup_steps": 1,
                                         "log_every": 1})})["job_id"]
            seen = {}
            while time.time() - t0 < 50:
                rec = api.ok("GET", f"/jobs/{job_id}")
                seen.setdefault(rec["status"], time.time())
                if rec["status"] in ("succeeded", "failed"):
                    break
                time.sleep(0.1)
            pod = kube.pods[f"{job_id}-slice-0-0"]
            assert rec["status"] == "succeeded", (rec, pod.log_path("trainer").read_text())
            assert "running" in seen and rt.monitor.ticks == 0
            times = kube.timeline[job_id]
            assert rec["training_duration"] == pytest.approx(
                times["completed"] - times["admitted"], abs=1e-3)
            # native sidecar order: fetch, then sidecar, then trainer; the
            # sidecar (a 30 s interval) SIGTERMed after the trainer exited,
            # its final pass shipping done.txt; the pod done before Completed
            assert times["dataset-fetch_exit"] <= times["artifact-sync_start"] <= \
                times["trainer_start"] <= times["trainer_exit"] <= \
                times["artifact-sync_sigterm"] <= times["artifact-sync_exit"] <= \
                times["completed"]
            assert pod.exit_codes == {"dataset-fetch": 0, "artifact-sync": 0, "trainer": 0}
            assert (pod.volumes["data"] / "dataset" / "train.jsonl").read_bytes() == rows
            uri = rec["artifacts_uri"]
            assert on_loop(rt.store.exists(f"{uri}/done.txt"), 30)
            assert on_loop(rt.store.get_bytes(f"{uri}/metrics.csv"), 30) == (
                pod.volumes["data"] / "artifacts" / "metrics.csv").read_bytes()
            assert len(api.ok("GET", f"/jobs/{job_id}/metrics")["records"]) == 3
            deadline = time.time() + 10
            while kube.has("jobsets", job_id) and time.time() < deadline:
                time.sleep(0.1)
            assert not kube.has("jobsets", job_id)
            assert not kube.has("configmaps", f"{job_id}-spec")
            trainer_cmd = json.dumps(pod.spec["containers"][0]["command"])
            assert "--device cpu" in trainer_cmd and "/etc/ftc/job.json" in trainer_cmd
            assert "step 3 loss" in pod.log_path("trainer").read_text()
        cs._stop(daemon[0], "the monitor daemon")
    finally:
        kube.close()
        if daemon[0].poll() is None:
            daemon[0].kill()
            daemon[0].wait()
    assert time.time() - t0 < 60


def test_kube_endpoint_log_follow_waits_for_the_container(tmp_path):
    """A followed pod log asked for while the pod's init container runs is
    answered 400 until the trainer starts; the port's client asks again and
    reads the trainer's lines to its exit, ``tailLines`` the last ones."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs

    kube = cs.KubeEndpoint(tmp_path / "kube", gpus=1)
    try:
        kube.kube.quota_chips = 1
        js = port_k8s.render_jobset(
            job("port", job_id="logs-1", device="cpu-test"), tiny_spec("port"),
            flavor("port", "cpu-test"), namespace="ftc", image="x", dataset_uri=None,
            artifacts_uri="obj://artifacts/x")
        pod = js["spec"]["replicatedJobs"][0]["template"]["spec"]["template"]["spec"]
        pod["initContainers"] = [{"name": "slow-init", "command": ["/bin/sh", "-c",
                                                                   "sleep 1.5"]}]
        pod["containers"][0]["command"] = [
            "/bin/sh", "-c", "for i in 1 2 3 4; do echo step $i; sleep 0.3; done; "
            "echo $JOB_COMPLETION_INDEX $FTC_SLICE_INDEX; test -f /etc/ftc/job.json"]
        client = port_k8s.HttpKubeClient(kube.endpoint)
        client.LOG_START_POLL_S = 0.1

        async def main():
            await client.create("/api/v1/namespaces/ftc/configmaps", {
                "kind": "ConfigMap", "metadata": {"name": "logs-1-spec"},
                "data": {"job.json": "{}"}})
            await client.create("/apis/jobset.x-k8s.io/v1alpha2/namespaces/ftc/jobsets", js)
            while not await client.list("/api/v1/namespaces/ftc/pods"):
                await asyncio.sleep(0.05)
            lines, tail = [], []
            async for line in await client.pod_log_lines(
                    "ftc", "logs-1-slice-0-0", container="trainer", follow=True,
                    tail_lines=None):
                lines.append(line)
                if line == "step 2":  # the pod runs: its log's last line so far
                    tail = [t async for t in await client.pod_log_lines(
                        "ftc", "logs-1-slice-0-0", container="trainer", follow=False,
                        tail_lines=1)]
                    with pytest.raises(BackendError, match="400"):
                        async for _ in await client.pod_log_lines(
                                "ftc", "logs-1-slice-0-0", container="none", follow=False,
                                tail_lines=None):
                            pass
            await client.close()
            return lines, tail

        lines, tail = run(main(), 30)
        assert lines == ["step 1", "step 2", "step 3", "step 4", "0 0"]
        assert len(tail) == 1 and tail[0] in ("step 2", "step 3")
        assert kube.requests["GET /api/v1/namespaces/ftc/pods/logs-1-slice-0-0"] >= 3
        assert kube.pods["logs-1-slice-0-0"].exit_codes == {"slow-init": 0, "trainer": 0}
    finally:
        kube.close()
