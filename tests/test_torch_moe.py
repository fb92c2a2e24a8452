"""The port's Mixture of Experts (``models/moe.py``) against the reference's.

``MoEMLP`` at the ``tiny-moe-test`` shapes (d 64, d_ff 128, 4 experts,
top 2), f32, on the same numpy weights and inputs.  The reference's routing
is read from its own run: ``jax.lax.top_k``'s outputs, and the expert
input rows of its first expert einsum, mapped back to token ids (the
token rows are distinct, the empty slot reads the zero row).  Checked:

* ``top_idx`` and ``token_of_slot`` EQUAL, and the slot of every routed
  pair (derived from the reference's ``token_of_slot``) equal to the
  port's, dropped pairs at the sentinel ``e*C`` on both sides;
* the output within atol 1e-5, the load-balancing term within rel 1e-6,
  ``grad_x`` within atol 1e-5;
* cases: a normal router, a zero router (every probability ties: the
  stable sort must pick experts 0 and 1 as ``lax.top_k`` does, and
  overflow drops pairs), a capacity factor low enough to drop pairs, and
  int4 experts.

The whole ``tiny-moe-test`` model (scanned layout, with and without int4)
with pad tokens: logits within 1e-4, the summed load-balancing term within
rel 1e-6 of ``moe_aux_loss``, LoRA gradients within rel 1e-4; greedy
generation gives the reference ``generate``'s tokens, and the cached path
the same; an MoE job trains through ``cli.run_job(..., "cpu")`` with a
``moe_aux`` column, and the loader refuses to serve it with the
reference's message.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from finetune_controller_tpu.models import moe as jax_moe
from finetune_controller_tpu.models import quant as jax_quant
from finetune_controller_tpu.models.llama import (
    PRESETS as JAX_PRESETS,
    LlamaForCausalLM as JaxLlama,
)
from finetune_controller_tpu.models.lora import LoRAConfig as JaxLoRAConfig
from finetune_controller_tpu_torch.models.convert import from_flax, to_flax
from finetune_controller_tpu_torch.models.llama import PRESETS, LlamaForCausalLM, remat_mode
from finetune_controller_tpu_torch.models.lora import LoRAConfig
from finetune_controller_tpu_torch.models.moe import MoEMLP

torch.set_num_threads(1)

D, F, E, K = 64, 128, 4, 2


def _jax_moe(capacity_factor: float, quantize: bool):
    return jax_moe.MoEMLP(d_model=D, d_ff=F, n_experts=E, top_k=K,
                          capacity_factor=capacity_factor, dtype=jnp.float32,
                          quantize_base=quantize)


def _params(case: str, quantize: bool, seed: int = 4) -> dict:
    """numpy params of one MoE layer: seeded f32 kernels (quantized by the
    reference's ``quantize_int4`` for int4 experts)."""
    rng = np.random.default_rng(seed)
    router = np.zeros((D, E), np.float32) if case == "zero_router" else \
        (rng.standard_normal((D, E)) * 0.5).astype(np.float32)
    params = {"router_kernel": router}
    for name, shape in (("experts_gate", (E, D, F)), ("experts_up", (E, D, F)),
                        ("experts_down", (E, F, D))):
        w = (rng.standard_normal(shape) / np.sqrt(shape[1])).astype(np.float32)
        if quantize:
            packed, scales = jax.vmap(jax_quant.quantize_int4)(jnp.asarray(w))
            params[f"{name}_packed"] = np.asarray(packed)
            params[f"{name}_scales"] = np.asarray(scales)
        else:
            params[name] = w
    return params


class _Recorder:
    """Records the reference's ``lax.top_k`` outputs and the inputs of its
    first expert einsum (``ecd,edf->ecf``) while it runs eagerly."""

    def __init__(self, monkeypatch):
        self.top_idx, self.expert_in = [], []
        top_k, einsum = jax.lax.top_k, jnp.einsum

        def rec_top_k(x, k):
            out = top_k(x, k)
            self.top_idx.append(np.asarray(out[1]))
            return out

        def rec_einsum(spec, *ops, **kw):
            if spec == "ecd,edf->ecf" and len(self.expert_in) < len(self.top_idx):
                self.expert_in.append(np.asarray(ops[0]))
            return einsum(spec, *ops, **kw)

        monkeypatch.setattr(jax.lax, "top_k", rec_top_k)
        monkeypatch.setattr(jnp, "einsum", rec_einsum)


def _reference_routing(xt: np.ndarray, expert_in: np.ndarray, top_idx: np.ndarray):
    """``token_of_slot`` and each pair's slot from the reference's expert
    input rows (rows of ``xt``, or the zero row for an empty slot)."""
    t = xt.shape[0]
    e, c, _ = expert_in.shape
    rows = expert_in.reshape(e * c, -1)
    padded = np.concatenate([xt, np.zeros((1, xt.shape[1]), xt.dtype)])
    token_of_slot = np.array([int(np.flatnonzero((padded == r).all(1))[0]) for r in rows])
    slot = np.full(top_idx.shape, e * c)
    for tok in range(t):
        for j, ex in enumerate(top_idx[tok]):
            hit = np.flatnonzero(token_of_slot[ex * c:(ex + 1) * c] == tok)
            if hit.size:
                slot[tok, j] = ex * c + hit[0]
    return token_of_slot, slot


CASES = {"normal": (1.25, False), "zero_router": (1.25, False),
         "drops": (0.25, False), "int4": (1.25, True)}


@pytest.mark.parametrize("case", list(CASES))
def test_routing_output_aux_and_grad_x_match_reference(case, monkeypatch):
    capacity_factor, quantize = CASES[case]
    params = _params(case, quantize)
    x = np.random.default_rng(8).standard_normal((2, 24, D)).astype(np.float32)
    cot = np.random.default_rng(9).standard_normal((2, 24, D)).astype(np.float32)
    module = _jax_moe(capacity_factor, quantize)

    def apply(xj):
        out, state = module.apply({"params": params}, xj, mutable=("moe_aux",))
        return out, jax_moe.moe_aux_loss(state)

    rec = _Recorder(monkeypatch)
    want_out, want_aux = apply(jnp.asarray(x))
    monkeypatch.undo()
    want_gx = jax.jit(jax.grad(lambda xj: jnp.sum(apply(xj)[0] * cot)))(jnp.asarray(x))
    xt = x.reshape(-1, D)
    want_tos, want_slot = _reference_routing(xt, rec.expert_in[0], rec.top_idx[0])

    port = MoEMLP(D, F, E, top_k=K, capacity_factor=capacity_factor, dtype=torch.float32,
                  quantize_base=quantize, device="cpu")
    port.load_state_dict({k: torch.from_numpy(np.array(v)) if v.dtype.name != "bfloat16"
                          else torch.from_numpy(v.view(np.int16).copy()).view(torch.bfloat16)
                          for k, v in params.items()})
    r = port.route(torch.from_numpy(xt))
    assert np.array_equal(r.top_idx.numpy(), rec.top_idx[0])
    assert np.array_equal(r.token_of_slot.numpy(), want_tos)
    assert np.array_equal(r.slot.numpy(), want_slot)
    dropped = int((r.slot == E * r.capacity).sum())
    if case in ("zero_router", "drops"):
        assert dropped > 0
    if case == "zero_router":
        assert (r.top_idx.numpy() == [0, 1]).all()
    xg = torch.from_numpy(x).requires_grad_(True)
    out, aux = port(xg)
    (out * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out), atol=1e-5, rtol=0)
    np.testing.assert_allclose(aux.item(), float(want_aux), rtol=1e-6)
    np.testing.assert_allclose(xg.grad.numpy(), np.asarray(want_gx), atol=1e-5, rtol=0)


def _moe_variables(quantize: bool, seed: int):
    jcfg = JAX_PRESETS["tiny-moe-test"].replace(dtype=jnp.float32, quantize_base=quantize,
                                                lora=JaxLoRAConfig(rank=4, alpha=8.0))
    variables = jax.device_get(JaxLlama(jcfg).init({"params": jax.random.PRNGKey(2)},
                                                   jnp.zeros((1, 4), jnp.int32)))
    variables.pop("moe_aux")
    rng = np.random.default_rng(seed)
    noisy = jax.tree_util.tree_map(
        lambda x: (np.asarray(0.05 + 0.2 * rng.standard_normal(x.shape), np.float32)
                   if np.asarray(x).dtype == np.float32 else np.asarray(x)), variables)
    return jcfg, noisy


def _port_model(quantize: bool, variables) -> LlamaForCausalLM:
    cfg = PRESETS["tiny-moe-test"].replace(dtype=torch.float32, quantize_base=quantize,
                                           lora=LoRAConfig(rank=4, alpha=8.0))
    model = LlamaForCausalLM(cfg, device="cpu")
    model.load_state_dict(from_flax(variables, cfg))
    return model


#: two rows, the second padded with token 0 (pad tokens route and count
#: toward capacity like any other)
TOKENS = np.array([[5, 17, 200, 3, 9, 41, 7, 7, 120, 64],
                   [11, 250, 6, 33, 0, 0, 0, 0, 0, 0]], np.int32)


@pytest.mark.parametrize("quantize", [False, True], ids=["float", "int4"])
def test_moe_model_logits_aux_and_lora_grads_match_reference(quantize):
    jcfg, variables = _moe_variables(quantize, 3)
    jmodel = JaxLlama(jcfg)

    def loss(lora):
        logits, state = jmodel.apply({**variables, "lora": lora}, jnp.asarray(TOKENS),
                                     mutable=("moe_aux",))
        aux = jax_moe.moe_aux_loss(state)
        return jnp.sum(logits * jnp.linspace(-1.0, 1.0, logits.shape[-1])) + aux, (logits, aux)

    (_, (want_logits, want_aux)), want_grads = jax.jit(
        jax.value_and_grad(loss, has_aux=True))(variables["lora"])
    model = _port_model(quantize, variables)
    logits, aux = model(torch.from_numpy(TOKENS).long(), return_moe_aux=True)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(want_logits),
                               atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(aux.item(), float(want_aux), rtol=1e-6)
    ((logits * torch.linspace(-1.0, 1.0, logits.shape[-1])).sum() + aux).backward()
    grads = {n: p.grad for n, p in model.named_parameters() if n.endswith((".lora_a", ".lora_b"))}
    got = jax.tree_util.tree_leaves_with_path(to_flax(grads, model.cfg)["lora"])
    want = dict(jax.tree_util.tree_leaves_with_path(want_grads))
    # LoRA never reaches the experts: the attention projections only
    assert len(got) == len(want) == 4 * 2
    for path, g in got:
        w = np.asarray(want[path])
        np.testing.assert_allclose(g, w, atol=1e-4 * np.abs(w).max(), rtol=0,
                                   err_msg=jax.tree_util.keystr(path))


def test_moe_remat_recomputes_the_whole_block():
    """The reference's ``mlp`` policy saves names an MoE block never sows,
    so ``mlp`` means ``full`` for MoE; the rematerialised backward gives
    the same gradients as no remat."""
    cfg = PRESETS["mixtral-proxy"]
    assert cfg.remat_policy == "mlp" and remat_mode(cfg) == "full"
    assert remat_mode(PRESETS["mistral-7b"]) == "mlp"
    _, variables = _moe_variables(False, 5)
    grads = []
    for remat in (True, False):
        model = _port_model(False, variables)
        model.cfg = model.cfg.replace(remat=remat)
        logits, aux = model(torch.from_numpy(TOKENS).long(), return_moe_aux=True)
        (logits.square().mean() + aux).backward()
        grads.append({n: p.grad.clone() for n, p in model.named_parameters()
                      if p.grad is not None})
    assert grads[0].keys() == grads[1].keys() and grads[0]
    for name in grads[0]:
        assert torch.equal(grads[0][name], grads[1][name]), name


def test_greedy_generation_matches_reference():
    """Greedy tokens of the uncached oracle equal the reference
    ``generate``'s (capacity at each call's ``t``), and the cached path
    (capacity at ``B`` per decode step) gives the same tokens here."""
    from finetune_controller_tpu.models.generate import generate as jax_generate
    from finetune_controller_tpu_torch.models.generate import cached_generate, greedy_generate

    jcfg, variables = _moe_variables(True, 6)
    prompts = TOKENS[:, :6]
    want = np.asarray(jax_generate(JaxLlama(jcfg), variables, jnp.asarray(prompts),
                                   max_new_tokens=4))
    model = _port_model(True, variables).eval()
    got = greedy_generate(model, torch.from_numpy(prompts), max_new_tokens=4)
    assert got.tolist() == want.tolist()
    assert cached_generate(model, torch.from_numpy(prompts), max_new_tokens=4).tolist() == \
        got.tolist()


def test_moe_job_trains_and_serving_refuses_it(tmp_path, capsys):
    """``tiny-moe-test`` with int4 experts through the CLI: finite losses,
    a positive ``moe_aux`` column, the attention-only adapter; the loader
    refuses to serve it with the reference's words, and ``generate_cli``
    rebuilds it as the reference's does (through the trainer), its cached
    and oracle paths giving the same greedy tokens."""
    import csv

    from finetune_controller_tpu_torch.serve.loader import ServeLoadError, load_serving_model
    from finetune_controller_tpu_torch.train import cli

    art = tmp_path / "art"
    cli.run_job({"model": {"preset": "tiny-moe-test", "lora": {"rank": 4},
                           "overrides": {"quantize_base": True}},
                 "training": {"total_steps": 2, "batch_size": 4, "seq_len": 16,
                              "log_every": 1, "checkpoint_every": 2, "warmup_steps": 1,
                              "grad_accum_steps": 2},
                 "dataset": {"synthetic": {"task": "increment"}},
                 "artifacts_dir": str(art)}, "cpu")
    with open(art / "metrics.csv") as f:
        rows = list(csv.DictReader(f))
    assert [int(r["step"]) for r in rows] == [1, 2]
    for r in rows:
        assert np.isfinite(float(r["loss"])) and 0.0 < float(r["moe_aux"]) < 1.0
    import json

    adapter = json.loads((art / "adapter" / "adapter_config.json").read_text())
    assert adapter["target_modules"] == ["k_proj", "o_proj", "q_proj", "v_proj"]
    with pytest.raises(ServeLoadError, match=r"serving MoE checkpoints is not supported "
                                             r"\(batching invariance does not hold under "
                                             r"capacity routing\)"):
        load_serving_model(art, device="cpu")
    from finetune_controller_tpu_torch.models import generate_cli

    outs = []
    for extra in ([], ["--oracle"]):
        capsys.readouterr()
        assert generate_cli.main(["--artifacts", str(art), "--prompt-tokens", "3,1,4,1,5",
                                  "--max-new-tokens", "4", "--device", "cpu"] + extra) == 0
        outs.append(json.loads(capsys.readouterr().out.strip().splitlines()[-1]))
    assert outs[0] == outs[1] and outs[0]["checkpoint_step"] == 2
    assert len(outs[0]["new_tokens"]) == 4

