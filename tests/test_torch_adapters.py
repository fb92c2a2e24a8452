"""Multi-tenant LoRA serving and the host KV tier of the port against the
JAX package.

``tiny-test`` in f32; the base weights and every adapter are numpy noise
from a seed, carried into the port by ``models/convert.py``.  The same
inputs go through the reference and the port:

* the tenant branch of ``LoRADense`` with mixed ranks padded into one stack
  (tolerance 1e-5);
* the engine in tenant mode, three tenants of ranks 2, 4 and 8 and the base
  in one batch: greedy tokens EQUAL, first-token logits within 1e-4;
* unmerged tenant logits against the merged model (2e-4, the reference's
  tolerance for the two evaluation orders);
* prefix-cache namespaces: never spliced across adapters, dropped on
  unload, a reused slot computes its new tenant's output;
* the host KV tier under a tiny device budget: demotions and restores
  happen, the counts equal the reference engine's, and greedy tokens equal
  a run without the tier.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from finetune_controller_tpu.models.llama import (
    PRESETS as JAX_PRESETS,
    LlamaForCausalLM as JaxLlama,
)
from finetune_controller_tpu.models.lora import (
    LoRAConfig as JaxLoRAConfig,
    LoRADense as JaxLoRADense,
)
from finetune_controller_tpu.serve.adapters import install_into as jax_install_into
from finetune_controller_tpu.serve.engine import (
    BatchEngine as JaxEngine,
    EngineConfig as JaxEngineConfig,
    GenRequest as JaxRequest,
)
from finetune_controller_tpu.serve.loader import merge_lora_variables as jax_merge
from finetune_controller_tpu_torch.models.convert import adapter_from_flax, from_flax, merge_lora
from finetune_controller_tpu_torch.models.llama import PRESETS, LlamaForCausalLM
from finetune_controller_tpu_torch.models.lora import LoRAConfig, LoRADense, TenantStacks
from finetune_controller_tpu_torch.serve.adapters import (
    AdapterError,
    AdapterRegistry,
    UnknownAdapter,
    install_into,
)
from finetune_controller_tpu_torch.serve.engine import BatchEngine, EngineConfig, GenRequest

torch.set_num_threads(1)

JCFG = JAX_PRESETS["tiny-test"].replace(dtype=jnp.float32, lora=JaxLoRAConfig(rank=0))
PCFG = PRESETS["tiny-test"].replace(dtype=torch.float32, lora=LoRAConfig(rank=0))
ENGINE = dict(slots=3, prompt_buckets=(8, 16), max_new_tokens=10, page_tokens=4,
              prefix_cache_bytes=1 << 20, tenant_slots=4, tenant_rank=8)
#: the host tier under a tiny device pool (24 pages) and a 2-page device
#: prefix budget (a page of tiny-test f32 is 1 KiB): the tenant engines of
#: both packages run with it, so one reference engine serves every parity
#: check of this file
TIER = dict(pool_pages=24, prefix_cache_bytes=2 * 1024, host_pool_bytes=1 << 16)
TENANTS = {"t2": (61, 2), "t4": (62, 4), "t8": (63, 8)}   # id: (seed, rank)
ALPHA = 16.0
SHARED = [3, 1, 4, 1, 5, 9, 2, 6, 5, 3]


def _noise(tree, seed, scale):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda s: np.asarray(scale * rng.standard_normal(s.shape), np.float32),
                        tree)


@pytest.fixture(scope="module")
def weights():
    """(reference variables, port model) of the same noisy base."""
    shapes = jax.eval_shape(JaxLlama(JCFG).init, {"params": jax.random.PRNGKey(0)},
                            jnp.zeros((1, 4), jnp.int32))
    rng = np.random.default_rng(11)
    variables = jax.tree.map(
        lambda s: np.asarray(0.05 + 0.3 * rng.standard_normal(s.shape), np.float32), shapes)
    model = LlamaForCausalLM(PCFG, device="cpu")
    model.load_state_dict(from_flax(variables, PCFG))
    return variables, model


def _lora_tree(seed, rank):
    """A reference ``lora`` tree of ``rank`` with non-zero A and B."""
    cfg = JCFG.replace(lora=JaxLoRAConfig(rank=rank))
    shapes = jax.eval_shape(JaxLlama(cfg).init, {"params": jax.random.PRNGKey(0)},
                            jnp.zeros((1, 4), jnp.int32))["lora"]
    return _noise(shapes, seed, 0.3)


@pytest.fixture(scope="module")
def trees():
    return {aid: (_lora_tree(seed, rank), rank) for aid, (seed, rank) in TENANTS.items()}


def _jax_engine(variables, trees, **kw):
    eng = JaxEngine(JaxLlama(JCFG), variables, JaxEngineConfig(**{**ENGINE, **kw}))
    for aid, (tree, rank) in trees.items():
        eng.adapters.register(aid, tree, ALPHA, rank)
        eng.install_adapter(aid)
    return eng


def _port_engine(model, trees, **kw):
    eng = BatchEngine(model, EngineConfig(**{**ENGINE, **kw}))
    for aid, (tree, rank) in trees.items():
        eng.adapters.register(aid, adapter_from_flax(tree, PCFG), ALPHA, rank)
        eng.install_adapter(aid)
    return eng


def _mixed_requests():
    """(id, prompt, max_new, adapter) — every tenant and the base share a
    prompt, so one batch mixes four adapters on the same tokens."""
    reqs = []
    for i, aid in enumerate(["", "t2", "t4", "t8"]):
        reqs.append((f"s-{aid or 'base'}", SHARED + [7, 8], 6 + i, aid))
        reqs.append((f"u-{aid or 'base'}", [11 + i, 5, 2, 9, 4], 8, aid))
    reqs.append(("hit-t4", SHARED + [9], 5, "t4"))   # prefix hit in t4's namespace
    return reqs


def _run(engine, make):
    return {rid: r.generated for rid, r in
            engine.run([make(rid, p, n, a) for rid, p, n, a in _mixed_requests()]).items()}


#: three 12-token prefixes touched twice, against the 2-page device budget
TIER_PREFIXES = [list(range(1, 13)), list(range(40, 52)), list(range(70, 82))]


def _tier_script(engine, make):
    out = {}
    for rnd, tail in enumerate((30, 33)):
        for j, shared in enumerate(TIER_PREFIXES):
            rid = f"t{rnd}_{j}"
            out[rid] = engine.run([make(rid, shared + [tail], 4)])[rid].generated
    return out


def _counts(engine):
    return {"hits": engine.prefix_hits_total, "demotions": engine._host_pool.demotions_total,
            "restores": engine._host_pool.restores_total,
            "tokens_by_tenant": dict(engine.tokens_by_tenant)}


@pytest.fixture(scope="module")
def jax_tiered(weights, trees):
    """The reference tenant engine with the host tier: the mixed batch,
    then the tier script; tokens and counters after each."""
    variables, _ = weights
    eng = _jax_engine(variables, trees, **TIER)
    mixed = _run(eng, lambda rid, p, n, a: JaxRequest(request_id=rid, tokens=p,
                                                      max_new_tokens=n, adapter_id=a))
    after_mixed = _counts(eng)
    tier = _tier_script(eng, lambda rid, p, n: JaxRequest(request_id=rid, tokens=p,
                                                          max_new_tokens=n))
    return mixed, after_mixed, tier, _counts(eng), eng


# ---------------------------------------------------------------------------
# The tenant branch of LoRADense
# ---------------------------------------------------------------------------


def test_tenant_lora_dense_matches_reference_mixed_ranks():
    """Three tenants of ranks 2, 4 and 8 in a rank-8 stack of 4 slots, the
    rows of one batch on slots 2, 0, 3, 1; tolerance 1e-5."""
    rng = np.random.default_rng(5)
    fan_in, fan_out, n, r_max = 16, 24, 4, 8
    x = rng.standard_normal((4, 5, fan_in)).astype(np.float32)
    ids = np.array([2, 0, 3, 1], np.int32)
    kernel = rng.standard_normal((fan_in, fan_out)).astype(np.float32)
    adapters = {slot: {"lora_a": 0.3 * rng.standard_normal((fan_in, r)).astype(np.float32),
                       "lora_b": 0.3 * rng.standard_normal((r, fan_out)).astype(np.float32)}
                for slot, r in ((1, 2), (2, 4), (3, 8))}

    dense = JaxLoRADense(fan_out, dtype=jnp.float32, tenant_slots=n, tenant_rank=r_max)
    variables = dense.init(jax.random.PRNGKey(0), jnp.asarray(x), adapter_ids=jnp.asarray(ids))
    tenants = variables["tenants"]
    for slot, tree in adapters.items():
        tenants = jax_install_into(tenants, slot, tree, ALPHA, tree["lora_a"].shape[1])
    want = dense.apply({"params": {"kernel": kernel}, "tenants": tenants}, jnp.asarray(x),
                       adapter_ids=jnp.asarray(ids))

    port = LoRADense(fan_in, fan_out, dtype=torch.float32, device="cpu")
    port.kernel.data = torch.from_numpy(kernel)
    stacks = TenantStacks({"q_proj": (fan_in, fan_out)}, 1, n, r_max, torch.float32)
    for slot, tree in adapters.items():
        install_into(stacks, slot, {f"layers.0.attn.q_proj.{k}": torch.from_numpy(v)
                                    for k, v in tree.items()}, ALPHA, tree["lora_a"].shape[1])
    got = port(torch.from_numpy(x), stacks.select(torch.from_numpy(ids))[0]["q_proj"])
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    # slot 0 is the base: its row gets no delta at all
    np.testing.assert_array_equal(got[1].detach().numpy(), x[1] @ kernel)


# ---------------------------------------------------------------------------
# The engine in tenant mode
# ---------------------------------------------------------------------------


def test_tenant_engine_greedy_tokens_equal_reference(weights, trees, jax_tiered):
    """Three tenants of mixed ranks and the base decode in one batch (3
    slots, 9 requests, prefix cache and host tier on): the port's greedy
    tokens equal the reference engine's, and so do the prefix hits, the
    tier's page moves and the per-tenant token counts."""
    _, model = weights
    eng = _port_engine(model, trees, **TIER)
    got = _run(eng, lambda rid, p, n, a: GenRequest(request_id=rid, tokens=p, max_new_tokens=n,
                                                    adapter_id=a))
    want, want_counts = jax_tiered[:2]
    assert got == want
    assert _counts(eng) == want_counts and want_counts["hits"] >= 1
    # the tenants genuinely compute different things on the same prompt
    assert len({tuple(got[f"s-{a}"][:6]) for a in ("base", "t2", "t4", "t8")}) >= 3


def test_tenant_first_token_logits_match_reference(weights, trees, jax_tiered):
    """First-token logits of the shared prompt under each adapter, through
    each engine's installed stacks, agree within 1e-4; ``from_flax``
    carries the reference engine's stacks into the port's exactly."""
    variables, model = weights
    jeng = jax_tiered[-1]
    eng = _port_engine(model, trees)
    tokens = np.array([SHARED + [7, 8]] * 4, np.int32)
    ids = np.array([0, 1, 2, 3], np.int32)
    tcfg = JCFG.replace(lora_tenant_slots=ENGINE["tenant_slots"],
                        lora_tenant_rank=ENGINE["tenant_rank"])
    want = JaxLlama(tcfg).apply({"params": variables["params"], "tenants": jeng._tenants},
                                jnp.asarray(tokens), adapter_ids=jnp.asarray(ids))[:, -1]
    # the port's registry hands out the same slots in the same order
    assert [eng.adapters.resolve(a) for a in ("t2", "t4", "t8")] == \
        [jeng.adapters.resolve(a) for a in ("t2", "t4", "t8")]
    with torch.no_grad():
        got = model(torch.from_numpy(tokens).long(), adapter_ids=torch.from_numpy(ids),
                    tenants=eng._tenants)[:, -1]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)
    # the reference's tenants collection carried over by from_flax gives
    # the port's own installed stacks, leaf for leaf
    pcfg = PCFG.replace(lora_tenant_slots=ENGINE["tenant_slots"],
                        lora_tenant_rank=ENGINE["tenant_rank"])
    carried = LlamaForCausalLM(pcfg, device="cpu")
    carried.load_state_dict(from_flax({"params": variables["params"],
                                       "tenants": jax.tree.map(np.asarray, jeng._tenants)}, pcfg))
    for key, value in eng._tenants.state_dict().items():
        assert torch.equal(carried.tenants.state_dict()[key], value), key


def test_unmerged_tenant_logits_match_merged_model(weights, trees):
    """The per-row stack math computes the function of merging ``W +
    (alpha/r) A B`` into the kernels, to the reference's tolerance (2e-4):
    the port's tenant path against the port's merge and against the
    reference's merged model."""
    variables, model = weights
    tree, rank = trees["t4"]
    tokens = np.array([[3, 1, 4, 1, 5, 9]], np.int32)
    eng = _port_engine(model, {"t4": (tree, rank)})
    with torch.no_grad():
        tenant = model(torch.from_numpy(tokens).long(), adapter_ids=torch.ones(1, dtype=torch.int32),
                       tenants=eng._tenants)
    lcfg = PCFG.replace(lora=LoRAConfig(rank=rank, alpha=ALPHA))
    state = {**from_flax(variables, PCFG), **adapter_from_flax(tree, lcfg)}
    mcfg, mstate = merge_lora(lcfg, state)
    merged = LlamaForCausalLM(mcfg, device="cpu")
    merged.load_state_dict(mstate)
    with torch.no_grad():
        port_merged = merged(torch.from_numpy(tokens).long())
    np.testing.assert_allclose(tenant.numpy(), port_merged.numpy(), rtol=2e-4, atol=2e-4)
    jcfg = JCFG.replace(lora=JaxLoRAConfig(rank=rank, alpha=ALPHA))
    jmcfg, jmvars = jax_merge(jcfg, {"params": variables["params"],
                                     "lora": jax.tree.map(jnp.asarray, tree)})
    ref_merged = JaxLlama(jmcfg).apply(jmvars, jnp.asarray(tokens))
    np.testing.assert_allclose(port_merged.numpy(), np.asarray(ref_merged), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# Prefix-cache namespaces
# ---------------------------------------------------------------------------


def _dedicated(model, aid, tree, rank, req):
    eng = _port_engine(model, {aid: (tree, rank)}, slots=2, tenant_slots=2)
    return eng.run([req])[req.request_id].generated


def test_prefix_cache_never_splices_across_adapters(weights, trees):
    """Tenant B sending the prompt tenant A just cached misses and decodes
    its own tokens; a same-tenant repeat hits."""
    _, model = weights
    eng = _port_engine(model, trees, slots=2)

    def req(rid, aid, tail):
        return GenRequest(request_id=rid, tokens=SHARED + [tail], max_new_tokens=8,
                          adapter_id=aid)

    out_a = eng.run([req("a1", "t2", 30)])["a1"].generated
    misses0, hits0 = eng.prefix_misses_total, eng.prefix_hits_total
    out_b = eng.run([req("b1", "t4", 30)])["b1"].generated
    assert eng.prefix_misses_total == misses0 + 1
    assert eng.prefix_hits_total == hits0
    out_a2 = eng.run([req("a2", "t2", 31)])["a2"].generated
    assert eng.prefix_hits_total == hits0 + 1
    tree_a, rank_a = trees["t2"]
    tree_b, rank_b = trees["t4"]
    assert out_a == _dedicated(model, "t2", tree_a, rank_a, req("d", "t2", 30))
    assert out_b == _dedicated(model, "t4", tree_b, rank_b, req("d", "t4", 30))
    assert out_a2 == _dedicated(model, "t2", tree_a, rank_a, req("d", "t2", 31))
    assert out_a != out_b


def test_unload_drops_namespace_and_slot_reuse_is_clean(weights, trees):
    """After unregister a new tenant reusing the slot id misses the old
    tenant's cached KV and computes its own weights."""
    _, model = weights
    (old, old_rank), (new, new_rank) = trees["t4"], trees["t8"]
    eng = _port_engine(model, {"old": (old, old_rank)}, slots=2, tenant_slots=2)
    prompt = SHARED + [1]
    eng.run([GenRequest(request_id="o", tokens=prompt, max_new_tokens=4, adapter_id="old")])
    entry = eng.adapters.get("old")
    eng.adapters.unregister("old")
    eng.remove_adapter("old", entry.slot)
    reused = eng.adapters.register("new", adapter_from_flax(new, PCFG), ALPHA, new_rank)
    assert reused.slot == entry.slot
    eng.install_adapter("new")
    misses0 = eng.prefix_misses_total
    got = eng.run([GenRequest(request_id="n", tokens=prompt, max_new_tokens=6,
                              adapter_id="new")])
    assert eng.prefix_misses_total == misses0 + 1
    want = _dedicated(model, "new", new, new_rank,
                      GenRequest(request_id="d", tokens=prompt, max_new_tokens=6,
                                 adapter_id="new"))
    assert got["n"].generated == want


def test_registry_slots_capacity_reuse_and_rank_refusals():
    reg = AdapterRegistry(capacity=3, max_rank=8)  # 2 tenant slots
    a = reg.register("a", {}, 16.0, 4)
    b = reg.register("b", {}, 16.0, 4)
    assert {a.slot, b.slot} == {1, 2}
    with pytest.raises(AdapterError, match="full"):
        reg.register("c", {}, 16.0, 4)
    assert reg.resolve("") == 0 and reg.resolve("a") == a.slot
    with pytest.raises(UnknownAdapter):
        reg.resolve("ghost")
    a2 = reg.register("a", {"new": True}, 16.0, 6)   # in-place refresh
    assert a2.slot == a.slot and a2.rank == 6
    reg.unregister("b")
    assert reg.register("c", {}, 16.0, 2).slot == b.slot
    for bad in (9, 0):
        with pytest.raises(AdapterError, match="rank"):
            reg.register("bad", {}, 16.0, bad)


def test_install_refuses_a_misfit_adapter_and_leaves_the_stacks(weights, trees):
    """A leaf of the wrong shape is refused with the reference's message
    before any slot is written."""
    _, model = weights
    eng = _port_engine(model, {})
    before = {k: v.clone() for k, v in eng._tenants.state_dict().items()}
    bad = adapter_from_flax(trees["t8"][0], PCFG)
    bad["layers.1.mlp.down_proj.lora_a"] = torch.zeros(7, 8)
    eng.adapters.register("bad", bad, ALPHA, 8)
    with pytest.raises(AdapterError, match="does not fit stack slot"):
        eng.install_adapter("bad")
    assert all(torch.equal(v, before[k]) for k, v in eng._tenants.state_dict().items())


# ---------------------------------------------------------------------------
# The host KV tier
# ---------------------------------------------------------------------------

def test_host_tier_demotes_restores_and_matches_reference(weights, trees, jax_tiered):
    """After the mixed batch, three prefixes touched twice against the
    2-page device budget: entries demote to host pages and restore on
    touch.  The greedy tokens and the demotion, restore and hit counts
    equal the reference engine's, and the tokens equal an engine's without
    the tier or the prefix cache."""
    _, model = weights
    eng = _port_engine(model, trees, **TIER)
    _run(eng, lambda rid, p, n, a: GenRequest(request_id=rid, tokens=p, max_new_tokens=n,
                                              adapter_id=a))
    before = _counts(eng)
    got = _tier_script(eng, lambda rid, p, n: GenRequest(request_id=rid, tokens=p,
                                                         max_new_tokens=n))
    _, _, want, want_counts, _ = jax_tiered
    assert got == want and _counts(eng) == want_counts
    assert want_counts["demotions"] > before["demotions"]
    assert want_counts["restores"] > before["restores"]
    assert want_counts["hits"] >= before["hits"] + 3
    assert eng.kv_page_stats()["tier_host_pages_used"] == eng._host_pool.used_count
    plain = BatchEngine(model, EngineConfig(**{**ENGINE, "prefix_cache_bytes": 0}))
    assert got == _tier_script(plain, lambda rid, p, n: GenRequest(request_id=rid, tokens=p,
                                                                   max_new_tokens=n))
