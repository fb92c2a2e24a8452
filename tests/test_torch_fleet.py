"""The port's replica fleet, router and serve fault injection against the
JAX package.

``tiny-test`` in f32 from the same seeded numpy weights in both packages;
every greedy output is held to an unkilled run (one request alone on one
engine), which equals the reference's ``cached_generate`` on those
weights.  Mirrors the serve-chaos anchors of the reference's fleet tests: a replica killed mid-run loses and repeats no request, a
stalled replica is caught and restarted, drain finishes in-flight lanes,
duplicate request ids decode once, per-request errors do not fail over —
and, for the port, replicas share one model's weights and tenant adapters
stay installed across replicas, busy unloads and rollovers.
"""

from __future__ import annotations

import asyncio

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from finetune_controller_tpu.models.generate import cached_generate as jax_cached_generate
from finetune_controller_tpu.models.llama import (
    PRESETS as JAX_PRESETS,
    LlamaForCausalLM as JaxLlama,
)
from finetune_controller_tpu.models.lora import LoRAConfig as JaxLoRAConfig
from finetune_controller_tpu.resilience.policy import classify_failure as jax_classify_failure
from finetune_controller_tpu_torch.models.convert import adapter_from_flax, from_flax
from finetune_controller_tpu_torch.models.llama import PRESETS, LlamaForCausalLM
from finetune_controller_tpu_torch.models.lora import LoRAConfig
from finetune_controller_tpu_torch.resilience.faults import (
    ReplicaKilled,
    ServeFault,
    ServeFaultInjector,
)
from finetune_controller_tpu_torch.resilience.policy import (
    FailureClass,
    RetryPolicy,
    classify_failure,
)
from finetune_controller_tpu_torch.serve.adapters import AdapterRegistry
from finetune_controller_tpu_torch.serve.engine import BatchEngine, EngineConfig, GenRequest
from finetune_controller_tpu_torch.serve.fleet import AdapterBusy, ReplicaFleet
from finetune_controller_tpu_torch.serve.router import ReplicaRouter

torch.set_num_threads(1)

JCFG = JAX_PRESETS["tiny-test"].replace(dtype=jnp.float32, lora=JaxLoRAConfig(rank=0))
PCFG = PRESETS["tiny-test"].replace(dtype=torch.float32, lora=LoRAConfig(rank=0))
ENGINE_CFG = dict(slots=2, prompt_buckets=(8, 16), max_new_tokens=24, page_tokens=4)
PROMPTS = [[5, 9, 2, 7], [1, 3, 3, 8, 2, 2], [7, 7, 7], [2, 13], [11, 4, 9, 1], [3, 3, 1],
           [6, 2, 8, 8, 1], [9, 9]]


@pytest.fixture(scope="module")
def tiny():
    """(reference variables, port model) of the same noisy weights."""
    shapes = jax.eval_shape(JaxLlama(JCFG).init, {"params": jax.random.PRNGKey(0)},
                            jnp.zeros((1, 4), jnp.int32))
    rng = np.random.default_rng(7)
    variables = jax.tree.map(
        lambda s: np.asarray(0.05 + 0.3 * rng.standard_normal(s.shape), np.float32), shapes)
    model = LlamaForCausalLM(PCFG, device="cpu")
    model.load_state_dict(from_flax(variables, PCFG))
    return variables, model


@pytest.fixture(scope="module")
def baseline(tiny):
    """Greedy tokens of an unkilled run: one request alone on one engine,
    cached per (prompt, n).  ``test_unkilled_run_matches_reference`` holds
    it to the reference."""
    _, model = tiny
    engine = BatchEngine(model, EngineConfig(**ENGINE_CFG))
    memo: dict = {}

    def get(prompt, n):
        key = (tuple(prompt), n)
        if key not in memo:
            memo[key] = engine.run([GenRequest("b", list(prompt), n)])["b"].generated
        return memo[key]

    return get


def _fleet(model, **kw):
    defaults = dict(
        replicas=2, stall_timeout_s=1.0, drain_timeout_s=10.0, warm_start=False,
        restart_policy=RetryPolicy(max_attempts=3, base_delay_s=0.05, max_delay_s=0.1, seed=0),
    )
    defaults.update(kw)
    engine_kw = defaults.pop("engine", {})
    return ReplicaFleet("job-under-test", model, EngineConfig(**{**ENGINE_CFG, **engine_kw}),
                        **defaults)


def _reqs(max_new=8):
    return [GenRequest(request_id=f"r{i}", tokens=p, max_new_tokens=max_new)
            for i, p in enumerate(PROMPTS)]


def test_unkilled_run_matches_reference(tiny, baseline):
    """The unkilled baseline equals the reference's ``cached_generate`` on
    the same weights (two prompts in one batch, 24 tokens; greedy, so the
    shorter runs are its prefixes)."""
    variables, _ = tiny
    prompts = [PROMPTS[0], PROMPTS[4]]
    out = np.asarray(jax_cached_generate(JaxLlama(JCFG), variables,
                                         jnp.asarray(prompts, jnp.int32), max_new_tokens=24))
    for prompt, row in zip(prompts, out):
        assert baseline(prompt, 24) == row[len(prompt):].tolist()
        assert baseline(prompt, 8) == row[len(prompt):len(prompt) + 8].tolist()


def test_failure_classes_and_backoff_match_reference():
    """The copied policy classifies as the reference does, and the seeded
    backoff stays inside its bounds."""
    cases = [(143, ""), (-9, ""), (1, ""), (None, "lease expired"), (None, "boom"), (200, "")]
    for code, msg in cases:
        assert classify_failure(code, msg).value == jax_classify_failure(code, msg).value
    policy = RetryPolicy(max_attempts=3, base_delay_s=1.0, max_delay_s=4.0, seed=3)
    delays = [policy.next_delay(None)]
    for _ in range(5):
        delays.append(policy.next_delay(delays[-1]))
    assert all(1.0 <= d <= 4.0 for d in delays)
    assert policy.should_retry(FailureClass.INFRA, 2) and not policy.should_retry(
        FailureClass.INFRA, 3)
    assert not policy.should_retry(FailureClass.USER, 1)


def test_serve_fault_env_roundtrip_and_once_file(tmp_path):
    once = str(tmp_path / "once")
    fault = ServeFault(replica_id="r1", at_step=7, mode="stall", once_file=once)
    assert ServeFault.from_env(fault.to_env()) == fault
    assert ServeFault.from_env({"FTC_FAULT_SERVE_REPLICA": "r0"}) is None
    first = ServeFaultInjector(fault)
    assert first._spend_once()
    assert not ServeFaultInjector(fault)._spend_once()  # spent by the first


def test_replicas_share_one_model(tiny, tmp_path):
    """Two replicas hold one model's weights (the same tensors), each with
    its own KV pool.  With a transport the replicas are worker processes
    instead: a process-mode fleet of the seeded tiny model answers with an
    in-process engine's tokens, and a fleet with neither a model nor a
    transport is refused."""
    from finetune_controller_tpu_torch.transport.builders import tiny_test
    from finetune_controller_tpu_torch.transport.process import ProcessTransport

    _, model = tiny

    async def main():
        fleet = _fleet(model)
        await fleet.start()
        r0, r1 = (fleet.replicas[r].engine for r in ("r0", "r1"))
        assert r0.model is r1.model is model
        assert r0.kv.k.data_ptr() != r1.kv.k.data_ptr()
        assert fleet.stats()["transport"] == "inproc"
        await fleet.close()

    asyncio.run(main())
    payload = {"device": "cpu", "dtype": "float32", "seed": 3}
    transport = ProcessTransport(job_id="j", root=tmp_path / "workers",
                                 payload={"builder": "tiny_test", "kwargs": payload},
                                 spawn_timeout_s=120.0, heartbeat_interval_s=0.5)

    async def remote():
        fleet = ReplicaFleet("j", None, EngineConfig(**ENGINE_CFG), replicas=1,
                             transport=transport)
        try:
            await asyncio.wait_for(fleet.start(), 120)
            assert fleet.stats()["transport"] == "process"
            router = ReplicaRouter(fleet, default_timeout_s=60)
            return await asyncio.wait_for(router.submit(GenRequest("p", [5, 9, 2, 7], 8)), 60)
        finally:
            await asyncio.wait_for(fleet.close(), 60)

    got = asyncio.run(remote())
    engine = BatchEngine(tiny_test(**payload), EngineConfig(**ENGINE_CFG))
    assert got.generated == engine.run([GenRequest("p", [5, 9, 2, 7], 8)])["p"].generated
    with pytest.raises(ValueError, match="needs a model"):
        ReplicaFleet("j", None, EngineConfig(**ENGINE_CFG))


def test_replica_kill_every_request_exactly_once(tiny, baseline):
    """A seeded mid-run kill of one of two replicas: every request
    completes exactly once, with an unkilled run's greedy tokens, none
    lost, none duplicated."""
    _, model = tiny

    async def main():
        fault = ServeFaultInjector(ServeFault(replica_id="r1", at_step=3, mode="kill"))
        fleet = _fleet(model, fault=fault)
        await fleet.start()
        router = ReplicaRouter(fleet, default_timeout_s=60, failover_retries=2)
        reqs = _reqs()
        results = await asyncio.gather(*(router.submit(r) for r in reqs))
        by_id = {}
        for res in results:
            assert res.request_id not in by_id, "request completed twice"
            by_id[res.request_id] = res
        assert len(by_id) == len(reqs)
        for req in reqs:
            got = by_id[req.request_id]
            assert got.generated == baseline(req.tokens, req.max_new_tokens), req.request_id
            assert got.finish_reason == "length" and got.replica_id
        assert fault.fired and router.failovers_total >= 1
        stats = fleet.stats()
        assert stats["step_errors_total"] >= 1
        assert stats["requests_completed_total"] == len(reqs)
        # the health check fails the faulted replica and respawns it
        acts = await fleet.health_tick()
        assert "r1" in acts["failed"]
        for _ in range(100):
            if (await fleet.health_tick())["restarted"]:
                break
            await asyncio.sleep(0.02)
        assert fleet.replica_restarts_total == 1 and len(fleet.healthy_replicas()) == 2
        await fleet.close()

    asyncio.run(main())


def test_stuck_decode_detected_and_restarted(tiny, baseline):
    """A wedged replica is caught by the health check, its requests fail
    over and complete with the reference's tokens, and it restarts."""
    _, model = tiny

    async def main():
        fault = ServeFaultInjector(ServeFault(replica_id="r1", at_step=2, mode="stall"))
        fleet = _fleet(model, fault=fault, stall_timeout_s=1.0)
        await fleet.start()
        router = ReplicaRouter(fleet, default_timeout_s=60, failover_retries=2)
        reqs = _reqs(max_new=6)
        tasks = [asyncio.ensure_future(router.submit(r)) for r in reqs]
        failed: list[str] = []
        for _ in range(200):
            failed.extend((await fleet.health_tick())["failed"])
            if all(t.done() for t in tasks):
                break
            await asyncio.sleep(0.05)
        results = await asyncio.gather(*tasks)
        assert "r1" in failed, "the stalled replica was never caught"
        for req, res in zip(reqs, results):
            assert res.generated == baseline(req.tokens, req.max_new_tokens)
        for _ in range(200):
            await fleet.health_tick()
            if len(fleet.healthy_replicas()) == 2:
                break
            await asyncio.sleep(0.02)
        stats = fleet.stats()
        assert stats["replicas_healthy"] == 2 and stats["replicas_failed_total"] >= 1
        await fleet.close()

    asyncio.run(main())


def test_router_retry_after_failure_is_classified(tiny):
    """A per-request error (bad params) surfaces at once without failover;
    the injected kill is a retryable class."""
    _, model = tiny
    assert classify_failure(None, str(ReplicaKilled("x"))) in (
        FailureClass.UNKNOWN, FailureClass.INFRA)

    async def main():
        fleet = _fleet(model, replicas=1)
        await fleet.start()
        router = ReplicaRouter(fleet, failover_retries=2)
        with pytest.raises(ValueError, match="engine cap"):
            await router.submit(GenRequest(request_id="bad", tokens=[1, 2], max_new_tokens=999))
        assert router.failovers_total == 0
        await fleet.close()

    asyncio.run(main())


def test_drain_finishes_inflight_and_blocks_new_admissions(tiny, baseline):
    _, model = tiny

    async def main():
        fleet = _fleet(model)
        await fleet.start()
        router = ReplicaRouter(fleet)
        victim = fleet.replicas["r0"]
        task = asyncio.ensure_future(victim.batcher.submit(GenRequest(
            request_id="inflight", tokens=[5, 9, 2, 7], max_new_tokens=24)))
        for _ in range(200):
            if victim.batcher._inflight:
                break
            await asyncio.sleep(0.01)
        assert victim.batcher._inflight
        assert await fleet.drain_replica("r0", reason="test")
        res = await task
        assert res.finish_reason == "length"
        assert res.generated == baseline([5, 9, 2, 7], 24)
        assert "r0" not in fleet.replicas
        res2 = await router.submit(GenRequest(request_id="after-drain", tokens=[7, 7, 7],
                                              max_new_tokens=4))
        assert res2.replica_id == "r1"
        stats = fleet.stats()
        assert stats["drains_total"] == 1 and stats["tokens_generated_total"] >= 28
        await fleet.close()

    asyncio.run(main())


def test_router_duplicate_request_id_never_double_decodes(tiny):
    _, model = tiny

    async def main():
        fleet = _fleet(model, replicas=1)
        await fleet.start()
        router = ReplicaRouter(fleet)
        req = GenRequest(request_id="dup", tokens=[5, 9, 2, 7], max_new_tokens=6)
        a, b = await asyncio.gather(router.submit(req), router.submit(req))
        assert a.generated == b.generated
        assert router.duplicates_suppressed_total == 1
        assert fleet.stats()["tokens_generated_total"] == 6
        c = await router.submit(req)
        assert c.generated == a.generated
        assert fleet.stats()["tokens_generated_total"] == 6
        assert router.duplicates_suppressed_total == 2
        await fleet.close()

    asyncio.run(main())


def test_fleet_adapters_across_replicas_busy_unload_and_rollover(tiny):
    """A tenant registered on the fleet decodes the same tokens on either
    replica and as a dedicated engine; an unload while its request is in
    flight is refused; a rollover generation keeps it installed."""
    variables, model = tiny
    shapes = jax.eval_shape(JaxLlama(JCFG.replace(lora=JaxLoRAConfig(rank=4))).init,
                            {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 4), jnp.int32))
    rng = np.random.default_rng(3)
    tree = adapter_from_flax(jax.tree.map(
        lambda s: np.asarray(0.3 * rng.standard_normal(s.shape), np.float32),
        shapes["lora"]), PCFG)
    prompt = [3, 1, 4, 1]
    dedicated = BatchEngine(model, EngineConfig(**ENGINE_CFG, tenant_slots=2, tenant_rank=8))
    dedicated.adapters.register("t", tree, 16.0, 4)
    dedicated.install_adapter("t")
    want = dedicated.run([GenRequest("d", prompt, 6, adapter_id="t")])["d"].generated

    async def main():
        fleet = _fleet(model, adapters=AdapterRegistry(capacity=2, max_rank=8))
        await fleet.start()
        await fleet.register_adapter("t", tree, 16.0, 4)
        router = ReplicaRouter(fleet)
        outs = [await fleet.replicas[rid].batcher.submit(
            GenRequest(f"on-{rid}", prompt, 6, adapter_id="t")) for rid in ("r0", "r1")]
        assert [o.generated for o in outs] == [want, want]
        task = asyncio.ensure_future(router.submit(
            GenRequest("busy", prompt, 24, adapter_id="t")))
        for _ in range(200):
            if any(r.batcher._inflight for r in fleet.replicas.values()):
                break
            await asyncio.sleep(0.005)
        with pytest.raises(AdapterBusy):
            await fleet.unregister_adapter("t")
        await task
        await fleet.rollover(model)
        assert fleet.generation == 1 and set(fleet.replicas) == {"r2", "r3"}
        after = await router.submit(GenRequest("r-after", prompt, 6, adapter_id="t"))
        assert after.generated == want
        assert fleet.stats()["tokens_by_tenant"]["t"] == 6 + 6 + 24 + 6
        await fleet.unregister_adapter("t")
        assert fleet.adapters.get("t") is None
        await fleet.close()

    asyncio.run(main())
