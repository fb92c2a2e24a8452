"""The port's serving engine against the JAX ``BatchEngine``.

Both engines serve ``tiny-test`` in f32 from the same weights (seeded numpy
noise through ``from_flax``) with 4-token pages, 3 slots, buckets (8, 16)
and the prefix cache on.  One scripted sequence drives both — staggered
admissions, a prefix hit whose reuse length (10) is not a page multiple (a
copy-on-write page), an eviction mid-flight, more requests than slots — and
the greedy tokens must be EQUAL.  The same requests through the port's
asyncio ``Batcher`` give the same results.  Sampled streams cannot match
JAX's threefry, so the port's own determinism is pinned instead.  The
unpaged mode (a dense cache per lane) and ``cached_generate`` give the
reference's greedy tokens too.
"""

from __future__ import annotations

import asyncio

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from finetune_controller_tpu.models.llama import (
    PRESETS as JAX_PRESETS,
    LlamaForCausalLM as JaxLlama,
)
from finetune_controller_tpu.serve.engine import (
    BatchEngine as JaxEngine,
    EngineConfig as JaxEngineConfig,
    GenRequest as JaxRequest,
)
from finetune_controller_tpu_torch.models.convert import from_flax
from finetune_controller_tpu_torch.models.llama import PRESETS, LlamaForCausalLM
from finetune_controller_tpu_torch.serve.batcher import Batcher
from finetune_controller_tpu_torch.serve.engine import (
    BatchEngine,
    EngineConfig,
    GenRequest,
    warm_engine,
)

torch.set_num_threads(1)

ENGINE = dict(slots=3, prompt_buckets=(8, 16), max_new_tokens=12, page_tokens=4,
              prefix_cache_bytes=1 << 20)
SHARED = [3, 1, 4, 1, 5, 9, 2, 6, 5, 3]  # 10 tokens: 2.5 pages of 4


def _requests():
    """(id, prompt, max_new_tokens) in admission order."""
    rng = np.random.default_rng(0)
    return [
        ("a", [7, 1, 8, 2, 8], 9),
        ("b", [2, 7, 1, 8, 2, 8, 1, 8, 2], 7),       # second bucket
        ("c", SHARED + [7, 8], 6),
        ("d", SHARED + [9], 8),                      # prefix hit on c, CoW
        ("e", rng.integers(0, 256, 16).tolist(), 12),  # a full 16-token bucket
        ("f", [11, 12], 1),                          # finishes on admission
        ("g", SHARED + [4, 4, 4], 5),
    ]


@pytest.fixture(scope="module")
def weights():
    jcfg = JAX_PRESETS["tiny-test"].replace(dtype=jnp.float32)
    variables = JaxLlama(jcfg).init({"params": jax.random.PRNGKey(0)},
                                    jnp.zeros((1, 4), jnp.int32))
    rng = np.random.default_rng(11)
    leaves, treedef = jax.tree_util.tree_flatten(variables)
    noisy = [np.asarray(0.05 + 0.3 * rng.standard_normal(x.shape), np.float32) for x in leaves]
    return jcfg, jax.tree_util.tree_unflatten(treedef, noisy)


@pytest.fixture(scope="module")
def port_model(weights):
    _, variables = weights
    model = LlamaForCausalLM(PRESETS["tiny-test"].replace(dtype=torch.float32), device="cpu")
    model.load_state_dict(from_flax(variables, model.cfg))
    return model


def _script(engine, make):
    """Drive ``engine`` through the scripted sequence; returns
    {request id: generated tokens} (the evicted request's partial output
    included) and the prefix-hit / copy-on-write counts."""
    reqs = {rid: make(rid, p, n) for rid, p, n in _requests()}
    out: dict[str, list[int]] = {}

    def collect(results):
        for r in results:
            out[r.request_id] = list(r.generated)

    assert engine.admit(reqs["a"]) is None
    assert engine.admit(reqs["b"]) is None
    for _ in range(2):
        collect(engine.step())
    assert engine.admit(reqs["c"]) is None
    collect(engine.step())
    evicted = engine.evict("b")
    assert evicted.finish_reason == "evicted"
    collect([evicted])
    assert engine.admit(reqs["d"]) is None
    collect(engine.step())
    collect(engine.run([reqs["e"], reqs["f"], reqs["g"]]).values())
    cow = engine.kv_page_stats()["cow_copies_total"]
    return out, engine.prefix_hits_total, cow


@pytest.fixture(scope="module")
def jax_result(weights):
    jcfg, variables = weights
    engine = JaxEngine(JaxLlama(jcfg), variables, JaxEngineConfig(**ENGINE))
    return _script(engine, lambda rid, p, n: JaxRequest(request_id=rid, tokens=p,
                                                       max_new_tokens=n))


def _port_engine(model, **kw):
    return BatchEngine(model, EngineConfig(**{**ENGINE, **kw}))


def test_greedy_tokens_equal_reference(port_model, jax_result):
    got = _script(_port_engine(port_model),
                  lambda rid, p, n: GenRequest(request_id=rid, tokens=p, max_new_tokens=n))
    want = jax_result
    assert got[0] == want[0]
    assert got[1:] == want[1:]
    out, hits, cow = got
    assert set(out) == {rid for rid, _, _ in _requests()}
    assert len(out["b"]) < 7 and len(out["f"]) == 1
    assert hits >= 2 and cow >= 1


def test_greedy_tokens_equal_uncached_oracle(port_model, jax_result):
    """The reference engine's own anchor, inside the port: paged greedy
    decode equals the uncached full-forward ``generate`` oracle."""
    from finetune_controller_tpu_torch.models.generate import generate

    for rid, prompt, n in _requests():
        if rid == "b":  # evicted mid-flight in the script
            continue
        want = generate(port_model, torch.tensor([prompt]), max_new_tokens=n)
        assert jax_result[0][rid] == want[0, len(prompt):].tolist(), rid


def test_batcher_serves_the_same_tokens(port_model, jax_result):
    """The same requests (no eviction) through the asyncio admission layer:
    more requests than slots, so admission queues."""
    reqs = [(rid, p, n) for rid, p, n in _requests() if rid != "b"]
    engine = _port_engine(port_model)
    direct = engine.run([GenRequest(request_id=rid, tokens=p, max_new_tokens=n)
                         for rid, p, n in reqs])

    async def go():
        batcher = Batcher(_port_engine(port_model), default_timeout_s=0)
        try:
            return await asyncio.gather(*(
                batcher.submit(GenRequest(request_id=rid, tokens=p, max_new_tokens=n))
                for rid, p, n in reqs
            )), batcher.stats()
        finally:
            await batcher.close()

    results, stats = asyncio.run(go())
    assert {r.request_id: r.generated for r in results} == \
        {rid: r.generated for rid, r in direct.items()}
    assert stats["step_errors_total"] == 0
    assert stats["requests_completed_total"] == len(reqs)
    # greedy output does not depend on batch-mates: the scripted run of the
    # reference (with its eviction) produced the same tokens
    for rid, _, _ in reqs:
        assert direct[rid].generated == jax_result[0][rid]


def test_sampled_streams_are_deterministic(port_model):
    """Same seed, same tokens — alone or beside other requests."""
    def sampled(rid, seed):
        return GenRequest(request_id=rid, tokens=[3 + seed, 1, 4, 1], seed=seed,
                          temperature=0.8, top_k=7, max_new_tokens=8)

    first = _port_engine(port_model).run(
        [sampled("s0", 40), sampled("s1", 41), GenRequest("g", [5, 5, 5], 6)])
    again = _port_engine(port_model).run(
        [sampled("s0", 40), sampled("s1", 41), GenRequest("g", [5, 5, 5], 6)])
    alone = _port_engine(port_model).run([sampled("s0", 40)])
    assert first["s0"].generated == again["s0"].generated == alone["s0"].generated
    assert first["s1"].generated == again["s1"].generated
    assert first["s0"].generated != first["s1"].generated


def test_warm_engine_zeroes_counters(port_model):
    engine = _port_engine(port_model)
    warm_engine(engine)
    assert engine.steps_total == engine.tokens_generated_total == 0
    assert engine.free_slots == ENGINE["slots"]
    assert engine.kv_page_stats()["pages_reserved"] == 0


@pytest.fixture(scope="module")
def jax_unpaged(weights):
    """The reference engine's unpaged mode (dense per-lane cache, prefix
    snapshots) on the scripted requests, without the eviction."""
    jcfg, variables = weights
    engine = JaxEngine(JaxLlama(jcfg), variables, JaxEngineConfig(**{**ENGINE, "page_tokens": 0}))
    reqs = [JaxRequest(request_id=rid, tokens=p, max_new_tokens=n) for rid, p, n in _requests()]
    out = {rid: r.generated for rid, r in engine.run(reqs).items()}
    return out, engine.prefix_hits_total


def test_unpaged_mode_waits_for_a_later_slice(port_model, jax_unpaged):
    """The unpaged mode has arrived (``page_tokens=0``): a dense cache per
    lane with prefix snapshots gives the reference unpaged engine's greedy
    tokens and prefix hits, and the paged engine's tokens."""
    engine = _port_engine(port_model, page_tokens=0)
    assert not engine.paged and engine.kv_page_stats() == {}
    got = engine.run([GenRequest(request_id=rid, tokens=p, max_new_tokens=n)
                      for rid, p, n in _requests()])
    want, hits = jax_unpaged
    assert {rid: r.generated for rid, r in got.items()} == want
    assert engine.prefix_hits_total == hits >= 2
    paged = _port_engine(port_model).run([GenRequest(request_id=rid, tokens=p, max_new_tokens=n)
                                          for rid, p, n in _requests()])
    assert {rid: r.generated for rid, r in paged.items()} == want


def test_cached_generate_matches_reference(weights, port_model):
    """``cached_generate`` (fill, then one cached position per token) gives
    the reference's greedy tokens on a batch of two prompts, and the
    uncached oracle's."""
    from finetune_controller_tpu.models.generate import cached_generate as jax_cached_generate
    from finetune_controller_tpu_torch.models.generate import cached_generate, generate

    jcfg, variables = weights
    prompts = np.array([[3, 1, 4, 1, 5, 9, 2], [7, 1, 8, 2, 8, 1, 8]], np.int32)
    want = np.asarray(jax_cached_generate(JaxLlama(jcfg), variables, jnp.asarray(prompts),
                                          max_new_tokens=9, eos_id=255))
    got = cached_generate(port_model, torch.from_numpy(prompts), max_new_tokens=9, eos_id=255)
    assert got.tolist() == want.tolist()
    assert got.tolist() == generate(port_model, torch.from_numpy(prompts), max_new_tokens=9,
                                    eos_id=255).tolist()


def test_unknown_adapter_is_refused(port_model):
    """A request naming an adapter is refused with the reference's
    messages: by an engine without a registry (naming the knob) and by a
    tenant-mode engine that has not loaded it (naming what is loaded); the
    lane stays free."""
    from finetune_controller_tpu_torch.serve.engine import UnknownAdapter

    engine = _port_engine(port_model)
    with pytest.raises(UnknownAdapter, match="serve_max_adapters"):
        engine.admit(GenRequest("t", [1, 2], 2, adapter_id="tenant-a"))
    assert engine.free_slots == ENGINE["slots"]
    tenants = _port_engine(port_model, tenant_slots=3, tenant_rank=4)
    with pytest.raises(UnknownAdapter, match="'tenant-a' is not loaded .*loaded: none"):
        tenants.admit(GenRequest("t", [1, 2], 2, adapter_id="tenant-a"))
    assert tenants.free_slots == ENGINE["slots"]


def test_qlora_engine_tokens_equal_reference():
    """A QLoRA ``tiny-test`` (int4 base, rank-4 adapters unmerged, f32
    compute) served paged and unpaged gives the JAX paged engine's greedy
    tokens on the same variables; the int4 base dequantizes inside each
    projection, so batching changes no row."""
    from finetune_controller_tpu.models.lora import LoRAConfig as JaxLoRAConfig
    from finetune_controller_tpu_torch.models.lora import LoRAConfig

    jcfg = JAX_PRESETS["tiny-test"].replace(dtype=jnp.float32, quantize_base=True,
                                            lora=JaxLoRAConfig(rank=4, alpha=8.0))
    variables = jax.device_get(JaxLlama(jcfg).init({"params": jax.random.PRNGKey(3)},
                                                   jnp.zeros((1, 4), jnp.int32)))
    rng = np.random.default_rng(12)
    variables = jax.tree_util.tree_map(
        lambda x: (np.asarray(0.05 + 0.3 * rng.standard_normal(x.shape), np.float32)
                   if np.asarray(x).dtype == np.float32 else np.asarray(x)), variables)
    reqs = [(rid, p, n) for rid, p, n in _requests() if rid != "b"]
    jax_engine = JaxEngine(JaxLlama(jcfg), variables, JaxEngineConfig(**ENGINE))
    want = {rid: r.generated for rid, r in jax_engine.run(
        [JaxRequest(request_id=rid, tokens=p, max_new_tokens=n) for rid, p, n in reqs]).items()}
    cfg = PRESETS["tiny-test"].replace(dtype=torch.float32, quantize_base=True,
                                       lora=LoRAConfig(rank=4, alpha=8.0))
    model = LlamaForCausalLM(cfg, device="cpu")
    model.load_state_dict(from_flax(variables, cfg))
    model.requires_grad_(False).eval()
    for page_tokens in (ENGINE["page_tokens"], 0):
        got = _port_engine(model, page_tokens=page_tokens).run(
            [GenRequest(request_id=rid, tokens=p, max_new_tokens=n) for rid, p, n in reqs])
        assert {rid: r.generated for rid, r in got.items()} == want, page_tokens
