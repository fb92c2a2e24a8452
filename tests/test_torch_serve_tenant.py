"""Serve replicas as scheduler tenants: the port's ``sched/serve_tenant.py``
and the ``serve_autoscale`` path of ``serve/service.py`` against the JAX
package.

* ``ServeScalePolicy.decide`` gives the reference's targets over seeded
  observation sequences (exact: integer host logic).
* The autoscale scenarios of ``tests/test_serve_fleet.py`` (grow under queue
  pressure, shrink by drain, training reclaiming the chips in one tick; a
  training job preempting a serve replica while requests are in flight) run
  through the JAX tenant, scheduler and fleet and through the port's, on
  the same trace and the same tiny weights: every tick's preemptions,
  spawns, drains, target, healthy replicas, admitted workloads and counters
  are equal, and the drained replicas' in-flight requests finish with equal
  greedy tokens.
* ``RolloutTenant``'s accounting and preemption intake equal the
  reference's.
* ``serve_autoscale`` loads a promoted job with a tenant through the port's
  ``ServeManager`` (no 501), on a one-chip quota: a grow stays queued, a
  training job reclaims the replica by drain, the router answers 503 while
  no replica is up, and the tenant re-admits the floor after the job.

Waits poll a condition; nothing sleeps for a fixed time or opens a socket.
"""

from __future__ import annotations

import asyncio
import json
import random
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from conftest import run_async

from finetune_controller_tpu.controller import devices as ref_devices
from finetune_controller_tpu.models.llama import LlamaForCausalLM as JaxLlama
from finetune_controller_tpu.models.llama import PRESETS as JAX_PRESETS
from finetune_controller_tpu.models.lora import LoRAConfig as JaxLoRAConfig
from finetune_controller_tpu.resilience.policy import RetryPolicy as RefRetryPolicy
from finetune_controller_tpu.sched import FairShareScheduler as RefFairShare
from finetune_controller_tpu.sched import serve_tenant as ref_tenant
from finetune_controller_tpu.serve.engine import EngineConfig as RefEngineConfig
from finetune_controller_tpu.serve.engine import GenRequest as RefRequest
from finetune_controller_tpu.serve.fleet import ReplicaFleet as RefFleet
from finetune_controller_tpu.serve.router import ReplicaRouter as RefRouter
from finetune_controller_tpu_torch.controller import devices
from finetune_controller_tpu_torch.models.convert import from_flax
from finetune_controller_tpu_torch.models.llama import PRESETS, LlamaForCausalLM
from finetune_controller_tpu_torch.models.lora import LoRAConfig
from finetune_controller_tpu_torch.resilience.policy import RetryPolicy
from finetune_controller_tpu_torch.sched import (
    ROLLOUT_QUEUE,
    FairShareScheduler,
    RolloutTenant,
    ServeScalePolicy,
    ServeTenant,
)
from finetune_controller_tpu_torch.serve.engine import BatchEngine, EngineConfig, GenRequest
from finetune_controller_tpu_torch.serve.fleet import ReplicaFleet
from finetune_controller_tpu_torch.serve.router import FleetUnavailable, ReplicaRouter

JCFG = JAX_PRESETS["tiny-test"].replace(dtype=jnp.float32, lora=JaxLoRAConfig(rank=0))
PCFG = PRESETS["tiny-test"].replace(dtype=torch.float32, lora=LoRAConfig(rank=0))
ENGINE_CFG = dict(slots=2, prompt_buckets=(8,), max_new_tokens=48, page_tokens=4)


@pytest.fixture(scope="module")
def tiny():
    """(reference (model, variables), port model) of the same noisy weights."""
    jmodel = JaxLlama(JCFG)
    shapes = jax.eval_shape(jmodel.init, {"params": jax.random.PRNGKey(0)},
                            jnp.zeros((1, 4), jnp.int32))
    rng = np.random.default_rng(7)
    variables = jax.tree.map(
        lambda s: np.asarray(0.05 + 0.3 * rng.standard_normal(s.shape), np.float32), shapes)
    model = LlamaForCausalLM(PCFG, device="cpu")
    model.load_state_dict(from_flax(variables, PCFG))
    return (jmodel, variables), model


# the two stacks behind one surface: (tenant module, scheduler, fleet, router,
# request, devices module)
REF = types.SimpleNamespace(tenant=ref_tenant, sched=RefFairShare, router=RefRouter,
                            request=RefRequest, devices=ref_devices)
PORT = types.SimpleNamespace(tenant=types.SimpleNamespace(
    ServeTenant=ServeTenant, ServeScalePolicy=ServeScalePolicy), sched=FairShareScheduler,
    router=ReplicaRouter, request=GenRequest, devices=devices)


def _catalog(dev, quota):
    return dev.DeviceCatalog(
        flavors=[dev.DeviceFlavor(name="chip", generation="cpu", hosts=1, chips_per_host=1,
                                  runtime="cpu", queue="q")],
        quotas=[dev.FlavorQuota(flavor="chip", nominal_chips=quota)],
        default_flavor="chip",
    )


def _fleet(stack, tiny, replicas):
    common = dict(replicas=replicas, stall_timeout_s=30.0, drain_timeout_s=60.0,
                  warm_start=False)
    if stack is REF:
        (jmodel, variables), _ = tiny
        return RefFleet("job-under-test", jmodel, variables, RefEngineConfig(**ENGINE_CFG),
                        restart_policy=RefRetryPolicy(max_attempts=3, base_delay_s=0.05,
                                                      max_delay_s=0.1, seed=0), **common)
    return ReplicaFleet("job-under-test", tiny[1], EngineConfig(**ENGINE_CFG),
                        restart_policy=RetryPolicy(max_attempts=3, base_delay_s=0.05,
                                                   max_delay_s=0.1, seed=0), **common)


def _snap(summary, tenant, fleet, sched):
    return {
        "preempted": summary["preempted"], "spawned": summary["spawned"],
        "drained": summary["drained"], "target": summary["target"],
        "healthy": fleet.stats()["replicas_healthy"],
        "workloads": {wid: wl.replica_id for wid, wl in tenant._workloads.items()},
        "admitted": sorted(w for w in tenant._workloads if sched.is_admitted(w)),
        "drains": fleet.drains_total, "ups": tenant.scale_ups_total,
        "downs": tenant.scale_downs_total, "preempted_total": tenant.preempted_total,
    }


# ---------------------------------------------------------------------------
# the policy
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(6))
def test_scale_policy_decisions_equal_the_reference(seed):
    rng = random.Random(seed)
    kw = dict(min_replicas=rng.randint(1, 2), max_replicas=rng.randint(2, 6),
              scale_up_queue_depth=rng.randint(1, 6), sustain_ticks=rng.randint(1, 3),
              idle_ticks=rng.randint(1, 4))
    ref, port = ref_tenant.ServeScalePolicy(**kw), ServeScalePolicy(**kw)
    healthy = kw["min_replicas"]
    for _ in range(200):
        obs = dict(healthy=healthy, queue_depth=rng.choice([0, 0, 1, 3, 8, 20]),
                   slots_busy=rng.choice([0, 0, 1, 4]))
        want = ref.decide(**obs)
        assert port.decide(**obs) == want
        healthy = want if rng.random() < 0.7 else healthy
    for bad in (dict(min_replicas=0), dict(min_replicas=3, max_replicas=2)):
        with pytest.raises(ValueError) as got:
            ServeScalePolicy(**bad)
        with pytest.raises(ValueError) as want:
            ref_tenant.ServeScalePolicy(**bad)
        assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# the autoscale scenarios through both stacks
# ---------------------------------------------------------------------------


def _grow_shrink_reclaim(stack, tiny):
    async def main():
        sched = stack.sched(_catalog(stack.devices, 4), {"serve": 1.0, "train": 1.0})
        fleet = _fleet(stack, tiny, replicas=1)
        await fleet.start()
        depth = {"value": 12}
        tenant = stack.tenant.ServeTenant(
            sched, fleet, flavor="chip", queue="serve",
            policy=stack.tenant.ServeScalePolicy(min_replicas=1, max_replicas=3,
                                                 scale_up_queue_depth=2, sustain_ticks=1,
                                                 idle_ticks=1),
            drive_admission=True, queue_depth_fn=lambda: depth["value"],
        )
        trace = []
        try:
            await tenant.attach_initial()
            for phase_depth in (12, 0):  # sustained pressure, then idle
                depth["value"] = phase_depth
                for _ in range(5):
                    trace.append(_snap(await tenant.tick(), tenant, fleet, sched))
            # the chips the drains freed admit a training tenant in ONE pass
            sched.submit("train-big", "chip", 3, queue="train", priority="normal")
            trace.append(sorted(w.job_id for w in sched.try_admit()))
        finally:
            await fleet.close()
        return trace

    return run_async(main())


def test_grow_shrink_and_reclaim_equal_the_reference(tiny):
    port = _grow_shrink_reclaim(PORT, tiny)
    assert port == _grow_shrink_reclaim(REF, tiny)
    # and the scenario holds what the reference's test states
    assert max(t["healthy"] for t in port[:-1]) == 3 and port[-2]["healthy"] == 1
    assert port[-2]["drains"] >= 2 and port[-2]["downs"] >= 2 and port[-1] == ["train-big"]


def _preempt_inflight(stack, tiny):
    async def main():
        sched = stack.sched(_catalog(stack.devices, 2), {"serve": 1.0, "train": 1.0})
        fleet = _fleet(stack, tiny, replicas=2)
        await fleet.start()
        tenant = stack.tenant.ServeTenant(
            sched, fleet, flavor="chip", queue="serve", priority="low",
            policy=stack.tenant.ServeScalePolicy(min_replicas=1, max_replicas=2,
                                                 scale_up_queue_depth=10**6),
            drive_admission=True,
        )
        try:
            await tenant.attach_initial()
            sched.try_admit()  # both serve workloads admitted: the cluster is full
            router = stack.router(fleet)
            tasks = [asyncio.ensure_future(router.submit(stack.request(
                request_id=f"long{i}", tokens=[5, 9, 2, 7], max_new_tokens=40)))
                for i in range(2)]
            deadline = time.monotonic() + 120.0
            while fleet.stats()["slots_busy"] < 2 and time.monotonic() < deadline:
                await asyncio.sleep(0.001)  # poll: both lanes in flight
            inflight = fleet.stats()["slots_busy"]
            # a normal-priority training job wants a chip: a preemption is planned
            sched.submit("train-1", "chip", 1, queue="train", priority="normal")
            sched.try_admit()
            snap = _snap(await tenant.tick(), tenant, fleet, sched)
            results = [await t for t in tasks]
            sched.try_admit()
            return {"snap": snap, "inflight_at_preemption": inflight,
                    "results": [(r.finish_reason, [int(x) for x in r.generated])
                                for r in results],
                    "train_admitted": sched.is_admitted("train-1")}
        finally:
            await fleet.close()

    return run_async(main())


def test_preempted_replica_drains_inflight_like_the_reference(tiny):
    port = _preempt_inflight(PORT, tiny)
    ref = _preempt_inflight(REF, tiny)
    # the requests were in flight when the preemption came, on both stacks
    assert port["inflight_at_preemption"] == ref["inflight_at_preemption"] == 2
    assert port == ref
    assert port["snap"]["preempted"] and port["snap"]["healthy"] == 1
    assert port["snap"]["preempted_total"] == 1 and port["train_admitted"]
    assert all(reason == "length" for reason, _ in port["results"])


def test_rollout_tenant_accounting_equals_the_reference():
    def run(dev, sched_cls, tenant_cls):
        sched = sched_cls(_catalog(dev, 2), {ROLLOUT_QUEUE: 1.0, "train": 1.0})
        tenant = tenant_cls(sched, "job1", flavor="chip")
        tenant.submit("rollout-0")
        tenant.submit("rollout-1")
        sched.try_admit()
        out = [tenant.is_admitted("rollout-0"), tenant.tick(), tenant.stats()]
        # a normal-priority training job reclaims a low-priority rollout chip
        sched.submit("train-1", "chip", 1, queue="train", priority="normal")
        sched.try_admit()
        out += [tenant.tick(), tenant.preempted_total]
        sched.try_admit()
        out.append(sched.is_admitted("train-1"))
        tenant.close()
        out.append(tenant.stats())
        return out

    port = run(devices, FairShareScheduler, RolloutTenant)
    assert port == run(ref_devices, RefFairShare, ref_tenant.RolloutTenant)
    assert port[0] and len(port[3]["preempted"]) == 1 and port[4] == 1 and port[5]
    assert port[-1]["workloads"] == {}


# ---------------------------------------------------------------------------
# serve_autoscale through the ServeManager
# ---------------------------------------------------------------------------


def test_serve_autoscale_loads_with_a_tenant_and_yields_to_training(tmp_path):
    from finetune_controller_tpu_torch.controller import config as port_config
    from finetune_controller_tpu_torch.controller.objectstore import LocalObjectStore, build_uri
    from finetune_controller_tpu_torch.controller.schemas import PromotionStatus
    from finetune_controller_tpu_torch.serve.loader import load_serving_model
    from finetune_controller_tpu_torch.serve.service import ServeManager
    from finetune_controller_tpu_torch.train import cli

    art = tmp_path / "job"
    art.mkdir()
    spec = {"job_id": "as", "artifacts_dir": str(art),
            "model": {"preset": "tiny-test", "lora": {"rank": 4, "alpha": 8.0},
                      "overrides": {"dtype": "float32"}},
            "training": {"total_steps": 2, "batch_size": 4, "seq_len": 16, "log_every": 1,
                         "checkpoint_every": 2, "warmup_steps": 1, "learning_rate": 0.05},
            "dataset": {"synthetic": {"task": "increment"}}}
    (art / "job.json").write_text(json.dumps(spec))
    assert cli.main(["--spec", str(art / "job.json"), "--device", "cpu"]) == 0
    # the loop ticks by hand here: the background cadence never fires
    settings = port_config.Settings(
        state_dir=str(tmp_path / "state"), object_store_root=str(tmp_path / "objects"),
        device="cpu", serve_autoscale=True, serve_min_replicas=1, serve_max_replicas=2,
        serve_scale_up_queue_depth=2, serve_scale_sustain_ticks=1,
        serve_health_interval_s=3600.0, serve_prompt_buckets=[8], serve_max_new_tokens=8,
        serve_kv_page_tokens=4)
    store = LocalObjectStore(tmp_path / "objects")
    # the one-card catalog's shape: one chip of quota
    sched = FairShareScheduler(_catalog(devices, 1), {"serve": 1.0, "train": 1.0})

    class State:
        async def get_job(self, job_id):
            return types.SimpleNamespace(promotion_status=PromotionStatus.COMPLETED,
                                         promotion_uri=build_uri("deploy", "as"))

        async def append_job_event(self, job_id, event):
            return None

    prompt = [5, 9, 2, 7]

    async def main():
        state = State()
        uri = (await state.get_job("as")).promotion_uri
        for path in [art / "resolved_config.json", *sorted((art / "checkpoints").rglob("*"))]:
            if path.is_file():
                await store.put_file(f"{uri}/{path.relative_to(art)}", path)
        manager = ServeManager(state, store, settings, scheduler=sched)
        out = {}
        try:
            await manager.load("as")  # no 501
            session = manager.sessions["as"]
            tenant = session.tenant
            assert tenant is not None and session.tenant_task is not None
            sched.try_admit()
            (w0,) = tenant._workloads
            assert sched.is_admitted(w0)
            out["first"] = (await manager.generate("as", GenRequest("a", prompt, 8)))[0]
            # queue pressure: a grow is submitted and stays QUEUED on one chip
            tenant._queue_depth_fn = lambda: 10
            await tenant.tick()
            sched.try_admit()
            grow = [w for w in tenant._workloads if w != w0]
            assert len(grow) == 1 and not sched.is_admitted(grow[0])
            assert session.fleet.stats()["replicas_healthy"] == 1
            tenant._queue_depth_fn = None
            stats = manager.stats()["as"]["autoscale"]
            assert stats["scale_ups_total"] == 1 and stats["flavor"] == "chip"
            assert stats["workloads"] == {w0: "r0", grow[0]: None}
            # a training job reclaims the card: the tenant drains, never kills
            sched.submit("train-1", "chip", 1, queue="train", priority="normal")
            sched.try_admit()
            summary = await tenant.tick()
            assert summary["preempted"] == [w0]
            assert session.fleet.stats()["replicas_healthy"] == 0
            assert session.fleet.drains_total == 1
            sched.try_admit()
            assert sched.is_admitted("train-1")
            # the router while no replica is up: 503 with a retry hint
            with pytest.raises(FleetUnavailable) as e:
                await manager.generate("as", GenRequest("b", prompt, 8))
            out["unavailable"] = e.value.retry_after_s
            # the job ends: the floor comes back on the next ticks
            sched.release("train-1")
            for _ in range(3):
                sched.try_admit()
                await tenant.tick()
            assert session.fleet.stats()["replicas_healthy"] == 1
            out["again"] = (await manager.generate("as", GenRequest("c", prompt, 8)))[0]
            out["autoscale"] = manager.stats()["as"]["autoscale"]
        finally:
            await manager.close()
        assert session.tenant is None and session.tenant_task.cancelled()
        return out

    out = run_async(main())
    assert out["unavailable"] == 2.0
    assert out["autoscale"]["preempted_total"] == 1
    model, _ = load_serving_model(art, merge_lora=True, device="cpu")
    engine = BatchEngine(model, EngineConfig(slots=settings.serve_slots, prompt_buckets=(8,),
                                             max_new_tokens=8, page_tokens=4))
    want = engine.run([GenRequest("o", prompt, 8)])["o"].generated
    assert out["first"].generated == out["again"].generated == want
