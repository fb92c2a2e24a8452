"""The port's control-plane core against the reference's, on the same inputs.

The port keeps its own copies of the reference's controller modules
(``finetune_controller_tpu_torch/controller``, ``sched``, ``resilience/
supervisor.py``); these tests drive both copies with one input and hold the
results equal:

* every builtin job spec renders the same trainer spec (``build_trainer_spec``)
  and the same submission-form schema; only the default device differs
  (the port names the ``h100`` card where the reference names a TPU slice);
* the same sequence of state-store operations returns the same values and
  leaves the same rows in both sqlite databases;
* a seeded sequence of submits, finishes and preemptions gives the same
  admissions and preemption decisions from both ``FairShareScheduler``s;
* a metrics CSV reads to the same JSON, empty cells included (the port reads
  it with the ``csv`` module, the reference with pandas).

Every comparison is exact (tolerance 0): these are host-side copies and
must agree bit for bit.  The port's own refusals (one-device meshes, a
multi-host job on the k8s backend) and the S3, GCS, remote-state and k8s
factories are pinned at the end.
"""

from __future__ import annotations

import asyncio
import json
import re
import sqlite3
import typing

import numpy as np
import pytest

from finetune_controller_tpu.controller import devices as ref_devices
from finetune_controller_tpu.controller import examples as ref_examples
from finetune_controller_tpu.controller import objectstore as ref_objectstore
from finetune_controller_tpu.controller import schemas as ref_schemas
from finetune_controller_tpu.controller import statestore as ref_statestore
from finetune_controller_tpu.obs import events as ref_events
from finetune_controller_tpu.sched import fairshare as ref_fairshare
from finetune_controller_tpu_torch.controller import config as port_config
from finetune_controller_tpu_torch.controller import devices as port_devices
from finetune_controller_tpu_torch.controller import examples as port_examples
from finetune_controller_tpu_torch.controller import objectstore as port_objectstore
from finetune_controller_tpu_torch.controller import schemas as port_schemas
from finetune_controller_tpu_torch.controller import statestore as port_statestore
from finetune_controller_tpu_torch.obs import events as port_events
from finetune_controller_tpu_torch.resilience.policy import FailureClass, classify_failure
from finetune_controller_tpu_torch.sched import fairshare as port_fairshare

REF_SPECS = {cls.model_name: cls for cls in ref_examples.BUILTIN_JOB_SPECS}
PORT_SPECS = {cls.model_name: cls for cls in port_examples.BUILTIN_JOB_SPECS}
#: the reference's TPU flavors; the port names the card in their place
TPU_FLAVORS = {"v5e-4", "v5e-8", "v5e-16", "v5p-64"}


def run(coro):
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(coro)
    finally:
        loop.close()


# ---------------------------------------------------------------------------
# Job specs
# ---------------------------------------------------------------------------


def test_the_same_builtin_specs_are_registered():
    assert list(PORT_SPECS) == list(REF_SPECS)


@pytest.mark.parametrize("name", sorted(REF_SPECS))
def test_builtin_spec_renders_the_reference_trainer_spec(name):
    ref_cls, port_cls = REF_SPECS[name], PORT_SPECS[name]
    ref_args = typing.get_type_hints(ref_cls)["training_arguments"]
    port_args = typing.get_type_hints(port_cls)["training_arguments"]
    assert port_cls.arguments_schema() == ref_cls.arguments_schema()
    raw = {"total_steps": 7, "batch_size": 2, "seq_len": 32, "lora_rank": 4,
           "profile_steps": 2, "grad_accum_steps": 2, "seed": 3}
    ref_spec = ref_cls(training_arguments=ref_args(**raw)).build_trainer_spec(
        "job-1", "/art", dataset_path="/data/train.jsonl",
        mesh={"dp": 1, "fsdp": 1, "ep": 1, "pp": 1, "sp": 1, "tp": 1})
    port_spec = port_cls(training_arguments=port_args(**raw)).build_trainer_spec(
        "job-1", "/art", dataset_path="/data/train.jsonl",
        mesh={"dp": 1, "fsdp": 1, "ep": 1, "pp": 1, "sp": 1, "tp": 1})
    assert port_spec == ref_spec
    defaults_ref = ref_cls(training_arguments=ref_args()).build_trainer_spec("j", "/a")
    defaults_port = port_cls(training_arguments=port_args()).build_trainer_spec("j", "/a")
    assert defaults_port == defaults_ref
    for attr in ("task", "framework", "model_preset", "default_num_slices",
                 "store_asset_patterns", "promotion_path", "mesh_policy",
                 "pretrained_weights_dir", "atomic_gang", "model_overrides"):
        ref_v, port_v = getattr(ref_cls, attr), getattr(port_cls, attr)
        if hasattr(ref_v, "value"):
            ref_v, port_v = ref_v.value, port_v.value
        assert port_v == ref_v, attr
    assert port_cls.dataset.model_dump() == ref_cls.dataset.model_dump()
    # the device names: the card where the reference names a TPU slice
    want = "h100" if ref_cls.default_device in TPU_FLAVORS else "cpu-test"
    assert port_cls.default_device == want
    ref_job = ref_cls(training_arguments=ref_args())
    port_job = port_cls(training_arguments=port_args())
    assert port_job.run_cmd() == ref_job.run_cmd().replace(
        "finetune_controller_tpu.train.cli", "finetune_controller_tpu_torch.train.cli")


# ---------------------------------------------------------------------------
# The state store
# ---------------------------------------------------------------------------


async def _statestore_ops(mod_store, mod_schemas, mod_events, root):
    """One fixed sequence of state-store operations; returns every result."""
    S, P = mod_schemas.DatabaseStatus, mod_schemas.PromotionStatus
    st = mod_store.StateStore(root, backend="sqlite")
    await st.connect()
    out = []
    for i, user in enumerate(("alice", "alice", "bob")):
        await st.create_job(mod_schemas.JobRecord(
            job_id=f"job-{i}", user_id=user, model_name="tiny-test-lora", device="cpu-test",
            arguments={"total_steps": 3 + i}, artifacts_uri=f"obj://a/{i}",
            submitted_at=1000.0 + i, metadata={"queue": "default", "priority": "normal"},
            events=[mod_events.make_event("submitted", key="submitted:1", ts=1000.0 + i)]))
    out.append(await st.update_job_status("job-0", S.RUNNING, start_time=1010.0,
                                          metadata={"exit_code": None, "restarts": 0}))
    out.append(await st.transition_job_status("job-1", S.RUNNING, S.FAILED))
    out.append(await st.transition_job_status("job-1", S.QUEUED, S.CANCELLED, end_time=1020.0))
    out.append(await st.append_job_event("job-0", mod_events.make_event(
        "running", key="running:1", ts=1011.0, attempt=1)))
    out.append(await st.append_job_event("job-0", mod_events.make_event(
        "running", key="running:1", ts=1012.0, attempt=1)))  # a duplicate key
    out.append(await st.merge_job_metadata("job-0", {"trace_id": "t" * 32, "queue": "prod"}))
    out.append(await st.update_job_status("job-0", S.SUCCEEDED, end_time=1030.0,
                                          training_duration=20.0))
    out.append(await st.begin_promotion("job-0", P.IN_PROGRESS, "obj://deploy/x",
                                        expect_from=[P.NOT_PROMOTED, P.FAILED]))
    out.append(await st.begin_promotion("job-0", P.IN_PROGRESS, "obj://deploy/y",
                                        expect_from=[P.NOT_PROMOTED, P.FAILED]))
    out.append(await st.update_job_promotion("job-0", P.COMPLETED, "obj://deploy/x"))
    await st.upsert_metrics(mod_schemas.MetricsDocument(
        job_id="job-0", records=[{"step": 1, "loss": 2.5}, {"step": 2, "loss": None}],
        source_uri="obj://a/0/metrics.csv", updated_at=1031.0))
    await st.insert_dataset(mod_schemas.DatasetRecord(
        dataset_id="ds-1", user_id="alice", name="train.jsonl", uri="obj://d/1",
        size_bytes=12, created_at=999.0))
    out.append(await st.add_dataset_job_ref("ds-1", "job-0"))
    out.append(await st.add_dataset_job_ref("ds-1", "job-0"))
    out.append((await st.get_user_jobs("alice", page=1, page_size=10)).model_dump(mode="json"))
    out.append([j.job_id for j in await st.get_active_jobs()])
    out.append(await st.delete_job("job-2"))
    out.append(await st.purge_job("job-1"))
    out.append([await st.rate_limit_acquire("rl/submit/alice", 2, 60.0) for _ in range(3)])
    await st.close()
    rows = {}
    with sqlite3.connect(root / "state.db") as conn:
        for (table,) in conn.execute("SELECT name FROM sqlite_master WHERE type='table'"):
            if table.startswith("rate"):
                continue  # sliding-window stamps are wall-clock times
            # archived_at is the deletion's wall-clock time
            rows[table] = sorted(
                tuple(re.sub(r'"archived_at": [0-9.e+]+', '"archived_at": "<time>"', c)
                      if isinstance(c, str) else c for c in row)
                for row in conn.execute(f'SELECT * FROM "{table}"').fetchall())
    return out, rows


def test_statestore_sequence_leaves_the_reference_rows(tmp_path):
    ref = run(_statestore_ops(ref_statestore, ref_schemas, ref_events, tmp_path / "ref"))
    port = run(_statestore_ops(port_statestore, port_schemas, port_events, tmp_path / "port"))
    assert port[0] == ref[0]
    assert port[1] == ref[1]
    assert sum(len(r) for r in port[1].values()) >= 4


# ---------------------------------------------------------------------------
# The fair-share scheduler
# ---------------------------------------------------------------------------


def _catalog(mod):
    return mod.DeviceCatalog(
        flavors=[mod.DeviceFlavor(name="one", generation="cpu", hosts=1, chips_per_host=1,
                                  runtime="cpu", queue="q"),
                 mod.DeviceFlavor(name="two", generation="cpu", hosts=1, chips_per_host=2,
                                  runtime="cpu", queue="q")],
        quotas=[mod.FlavorQuota(flavor="one", nominal_chips=3),
                mod.FlavorQuota(flavor="two", nominal_chips=4)],
        default_flavor="one")


def _drive_scheduler(mod_sched, mod_devices, seed: int):
    now = [0.0]
    sched = mod_sched.FairShareScheduler(
        _catalog(mod_devices), {"prod": 3.0, "batch": 1.0}, clock=lambda: now[0],
        grow_delay_s=5.0)
    rng = np.random.default_rng(seed)
    live: list[str] = []
    trace = []
    for i in range(60):
        now[0] += float(rng.uniform(0.5, 3.0))
        op = rng.integers(0, 10)
        if op < 5 or not live:
            job = f"j{i}"
            flavor = "one" if rng.random() < 0.5 else "two"
            slices = int(rng.integers(1, 3))
            queue = ("prod", "batch", "default")[int(rng.integers(0, 3))]
            priority = ("low", "normal", "high")[int(rng.integers(0, 3))]
            sched.submit(job, flavor, slices, queue=queue, priority=priority,
                         requested_slices=slices)
            live.append(job)
            trace.append(("submit", job, flavor, slices, queue, priority))
        elif op < 8:
            job = live.pop(int(rng.integers(0, len(live))))
            sched.release(job)
            trace.append(("release", job))
        admitted = [(w.job_id, w.num_slices) for w in sched.try_admit()]
        decisions = [(d.job_id, d.kind, d.preemptor_id, d.from_slices, d.to_slices)
                     for d in sched.take_preemptions()]
        for job_id, *_ in decisions:
            if job_id in live and rng.random() < 0.7:
                # the victim checkpoints and exits: its chips free
                sched.release(job_id)
                live.remove(job_id)
        trace.append(("admit", admitted, "preempt", decisions, "pending", sched.pending()))
    trace.append(("usage", sched.usage()))
    return trace


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fairshare_admissions_match_the_reference(seed):
    ref = _drive_scheduler(ref_fairshare, ref_devices, seed)
    port = _drive_scheduler(port_fairshare, port_devices, seed)
    assert port == ref
    assert any(step[0] == "admit" and step[1] for step in ref)


# ---------------------------------------------------------------------------
# The metrics CSV
# ---------------------------------------------------------------------------

METRICS_CSVS = {
    "dense": b"step,timestamp,loss,accuracy,grad_norm\n1,1.5,5.8,0.0,1.25\n2,2.5,5.1,0.25,0.75\n",
    "ragged_eval": (b"step,loss,eval_loss,eval_accuracy\n1,5.8,,\n2,5.1,4.9,0.5\n"
                    b"3,4.7,,\n"),
    "short_rows": b"step,loss,eval_loss\n1,2.0\n2,1.5,1.4\n",
    "ints_with_gaps": b"step,epoch,loss\n1,,2.0\n2,1,1.5\n3,2,1.25\n",
    "mixed_types": (b"step,flag,name,mixed,note\n1,True,a,1,\n2,False,b,x,ok\n"
                    b"3,True,,2.5,NaN\n"),
    "signs_and_exponents": b"step,lr,v\n1,2e-3,-1\n2,+1.5E+2,3\n3,nan,inf\n",
}


@pytest.mark.parametrize("name", sorted(METRICS_CSVS))
def test_metrics_csv_reads_to_the_reference_json(tmp_path, name):
    raw = METRICS_CSVS[name]

    async def read(mod, root):
        store = mod.LocalObjectStore(root)
        await store.put_bytes("obj://art/job/artifacts/metrics.csv", raw)
        return await store.get_metrics_records("obj://art/job/artifacts")

    ref_records, ref_uri = run(read(ref_objectstore, tmp_path / "ref"))
    port_records, port_uri = run(read(port_objectstore, tmp_path / "port"))
    assert port_uri == ref_uri
    assert json.dumps(port_records) == json.dumps(ref_records)


# ---------------------------------------------------------------------------
# The port's refusals and its device setting
# ---------------------------------------------------------------------------


def test_one_device_mesh_and_wider_grants_refused():
    cat = port_devices.default_catalog()
    assert cat.names() == ["cpu-test", "h100"]
    h100 = cat.get("h100")
    assert (h100.runtime, h100.total_chips, cat.quota_for("h100")) == ("cuda", 1, 1)
    assert h100.k8s_resource_name() == "nvidia.com/gpu"
    one = {"dp": 1, "fsdp": 1, "ep": 1, "pp": 1, "sp": 1, "tp": 1}
    assert port_devices.default_mesh_for(h100) == one
    assert port_devices.default_mesh_for(h100, 1, {"ep": 1, "fsdp": -1}) == one
    # a policy one card cannot satisfy is refused as the reference refuses
    # it: the Mixtral example's {"ep": 8} (its MoE trains with no mesh)
    policy = PORT_SPECS["mixtral-8x7b-moe-lora"].mesh_policy
    with pytest.raises(ValueError, match=re.escape(
            "device 'h100' (1 chips) cannot satisfy the model's mesh policy "
            "{'ep': 8, 'fsdp': -1}: cannot infer fsdp: 1 devices not divisible by "
            "product of fixed axes 8")):
        port_devices.default_mesh_for(h100, 1, policy)
    with pytest.raises(NotImplementedError, match="Queue A item 7"):
        port_devices.default_mesh_for(cat.get("cpu-test"), 2)
    with pytest.raises(ValueError, match="not in"):
        port_devices.default_mesh_for(h100, 1, {"zz": 2})


def test_device_setting_reads_ftc_device(monkeypatch):
    assert port_config.Settings().device == "cuda"
    monkeypatch.setenv("FTC_DEVICE", "cpu")
    assert port_config._from_env().device == "cpu"


def test_unported_substrates_raise(tmp_path):
    from finetune_controller_tpu_torch.controller.backends.local import LocalProcessBackend
    from finetune_controller_tpu_torch.controller.runtime import build_runtime

    from finetune_controller_tpu_torch.controller.gcs import GCSObjectStore
    from finetune_controller_tpu_torch.controller.s3 import S3ObjectStore
    from finetune_controller_tpu_torch.controller.statestore_service import RemoteStateStore

    # GCS, S3, the shared state service and the k8s backend are ported
    # (ROADMAP items 3c, 3d, 3e): the factories build them
    for backend, kind in (("gcs", GCSObjectStore), ("s3", S3ObjectStore)):
        settings = port_config.Settings(object_store_backend=backend)
        assert isinstance(port_objectstore.build_object_store(settings), kind)
    base = dict(state_dir=str(tmp_path / "s"), object_store_root=str(tmp_path / "o"))
    with pytest.raises(ValueError, match="state_service_url"):
        build_runtime(port_config.Settings(state_backend="remote", **base))
    remote = build_runtime(port_config.Settings(
        state_backend="remote", state_service_url="http://127.0.0.1:1", **base))
    assert isinstance(remote.state, RemoteStateStore)
    from finetune_controller_tpu_torch.controller.backends.k8s import K8sJobSetBackend

    k8s = build_runtime(port_config.Settings(backend="k8s", **base)).backend
    assert isinstance(k8s, K8sJobSetBackend)
    # one card in one pod: a multi-host job is refused (item 7), before
    # anything reaches the API server
    spec = port_examples.TinyTestLoRA(training_arguments=port_examples.LoRASFTArguments(
        total_steps=2, batch_size=2, seq_len=16, lora_rank=2))
    wide = port_schemas.JobInput(job_id="wide-1", user_id="u", model_name="tiny-test-lora",
                                 device="cpu-test", num_slices=2, arguments={})
    with pytest.raises(NotImplementedError, match="item 7"):
        asyncio.run(k8s.submit(wide, spec, port_devices.default_catalog().get("cpu-test"),
                               dataset_uri=None, artifacts_uri="obj://artifacts/wide-1"))
    store = port_objectstore.LocalObjectStore(tmp_path / "o")
    # the warm trainer pool is ported: a backend with warm_workers=1
    # prewarms one trainer process, which exits 0 when the pool closes
    backend = LocalProcessBackend(tmp_path / "sb", store, port_devices.default_catalog(),
                                  warm_workers=1)

    async def pool():
        await asyncio.wait_for(backend.prewarm(wait_s=90), 120)
        (procs,) = backend._warm.values()
        assert len(procs) == 1 and procs[0].returncode is None
        assert getattr(procs[0], "ftc_ready_path").exists()
        await asyncio.wait_for(backend.close(), 60)
        return procs[0].returncode

    assert asyncio.run(pool()) == 0


@pytest.mark.parametrize("exit_code", [1, 2])
def test_trainer_refusal_exit_is_terminal(exit_code):
    """A port trainer that refuses a spec (``NotImplementedError``, exit 1)
    is a user failure: the retry supervisor does not retry it."""
    from finetune_controller_tpu_torch.resilience.policy import RETRYABLE, RetryPolicy

    cls = classify_failure(exit_code, f"exit code {exit_code} after 3 attempts")
    assert cls is FailureClass.USER
    assert cls not in RETRYABLE
    assert not RetryPolicy().should_retry(cls, attempt=1)


def test_build_app_gives_a_fallback_serve_manager_the_runtimes_backend(tmp_path):
    """A runtime assembled outside ``build_runtime`` gets its
    ``ServeManager`` in ``build_app``, with the runtime's backend (where
    ``serve_transport=process`` puts its worker sandboxes), as the
    reference's ``build_app`` passes it (``controller/server.py:1403-1406``)."""
    import sys

    from finetune_controller_tpu_torch.controller import monitor, runtime, server
    from finetune_controller_tpu_torch.controller.backends.local import LocalProcessBackend

    settings = port_config.Settings(state_dir=str(tmp_path / "state"),
                                    object_store_root=str(tmp_path / "objects"))
    state = port_statestore.StateStore(settings.state_path)
    store = port_objectstore.LocalObjectStore(settings.object_store_path)
    catalog = port_devices.default_catalog()
    backend = LocalProcessBackend(settings.state_path / "sandboxes", store, catalog,
                                  python=sys.executable)
    rt = runtime.Runtime(
        settings=settings, state=state, store=store, catalog=catalog, backend=backend,
        monitor=monitor.JobMonitor(state, store, backend, interval_s=0.1),
        presigner=port_objectstore.Presigner(settings.presign_secret))
    assert rt.serve is None
    server.build_app(rt)
    assert rt.serve is not None and rt.serve.backend is backend
