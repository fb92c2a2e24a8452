"""The port's remat policies (``models/llama.py``) against ``none`` and the
JAX package's policies of the same name.

A one-layer ``tiny-test`` with LoRA rank 4, f32, packed segments and the
flash path (``attention_impl="pallas"``: the port's plain version on the
CPU, the JAX package's Pallas kernel in interpret mode):

* under every policy the port's loss and LoRA gradients equal its own
  ``none`` bit for bit (rematerialisation re-runs the same operations);
* they match the JAX package's gradient under the same policy: loss rtol
  1e-5, each gradient leaf atol 1e-4 of its largest element (f32 sums in
  another order: ~1.3e-5 measured);
* the forwards of the port's ``FlashAttention`` Function per layer and step
  are 1 under ``none``, ``flash`` and ``mlp_flash`` (the Function runs
  outside every checkpointed segment and its saved output and lse serve the
  backward) and 2 under the others; the JAX package's gradient (its
  jaxpr, the forward ``pallas_call`` counted by its two outputs, out and
  lse) holds 2 under every policy but ``none``: under ``flash`` and
  ``mlp_flash`` its recompute still rebuilds the attention output, which
  no name of those policies keeps, for the output projection's backward.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_model import _noisy_variables

from finetune_controller_tpu.models.llama import LlamaForCausalLM as JaxLlama
from finetune_controller_tpu.models.llama import PRESETS as JAX_PRESETS
from finetune_controller_tpu.models.lora import LoRAConfig as JaxLoRAConfig
from finetune_controller_tpu_torch.models.convert import from_flax, to_flax
from finetune_controller_tpu_torch.models.llama import (
    PRESETS,
    REMAT_POLICIES,
    LlamaForCausalLM,
)
from finetune_controller_tpu_torch.models.lora import LoRAConfig
from finetune_controller_tpu_torch.ops.kernels.flash_attention import FlashAttention

torch.set_num_threads(1)

#: flash forwards per layer and step
PORT_FORWARDS = {p: 1 if p in ("none", "flash", "mlp_flash") else 2 for p in REMAT_POLICIES}
JAX_FORWARDS = {p: 1 if p == "none" else 2 for p in REMAT_POLICIES}

SEQ = 16


@pytest.fixture(scope="module")
def inputs():
    jcfg = JAX_PRESETS["tiny-test"].replace(
        n_layers=1, dtype=jnp.float32, attention_impl="pallas", scan_layers=False,
        lora=JaxLoRAConfig(rank=4))
    variables = _noisy_variables(jcfg, seed=21)
    rng = np.random.default_rng(22)
    tokens = rng.integers(0, 256, (2, SEQ)).astype(np.int32)
    seg = np.repeat(np.array([[1, 2], [1, 1]]), SEQ // 2, axis=1).astype(np.int32)
    return jcfg, variables, tokens, seg


def _port(policy: str, variables, tokens, seg):
    cfg = PRESETS["tiny-test"].replace(
        n_layers=1, dtype=torch.float32, attention_impl="pallas", remat_policy=policy,
        scan_layers=False, lora=LoRAConfig(rank=4))
    model = LlamaForCausalLM(cfg, device="cpu")
    model.load_state_dict(from_flax(variables, cfg))
    FlashAttention.forwards = 0
    logits = model(torch.from_numpy(tokens).long(), segment_ids=torch.from_numpy(seg))
    loss = torch.log_softmax(logits, -1)[..., 0].mean()
    loss.backward()
    grads = {n: p.grad for n, p in model.named_parameters() if p.grad is not None}
    return cfg, loss.item(), grads, FlashAttention.forwards


@pytest.fixture(scope="module")
def port_none(inputs):
    _, variables, tokens, seg = inputs
    return _port("none", variables, tokens, seg)


def _jax_forwards(jaxpr) -> int:
    """Forward flash ``pallas_call``s (outputs: out and lse) in a jaxpr and
    its sub-jaxprs."""
    n = 0
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "pallas_call":
            avals = eqn.params["out_avals"]
            n += len(avals) == 2 and avals[1].shape[-1] == 1
        for value in eqn.params.values():
            for sub in value if isinstance(value, (list, tuple)) else (value,):
                inner = getattr(sub, "jaxpr", sub)
                if hasattr(inner, "eqns"):
                    n += _jax_forwards(inner)
    return n


@pytest.mark.parametrize("policy", REMAT_POLICIES)
def test_policy_matches_none_and_the_reference(policy, inputs, port_none):
    jcfg, variables, tokens, seg = inputs
    cfg, loss, grads, forwards = _port(policy, variables, tokens, seg)
    _, loss0, grads0, _ = port_none
    assert forwards == PORT_FORWARDS[policy] * cfg.n_layers
    assert loss == loss0 and grads.keys() == grads0.keys()
    for key in grads0:
        torch.testing.assert_close(grads[key], grads0[key], atol=0, rtol=0)

    model = JaxLlama(jcfg.replace(remat=True, remat_policy=policy))

    def jloss(lora):
        logits = model.apply({"params": variables["params"], "lora": lora},
                             jnp.asarray(tokens), segment_ids=jnp.asarray(seg))
        return jax.nn.log_softmax(logits, -1)[..., 0].mean()

    traced = jax.jit(jax.value_and_grad(jloss)).trace(variables["lora"])
    assert _jax_forwards(traced.jaxpr.jaxpr) == JAX_FORWARDS[policy] * jcfg.n_layers
    want_loss, want_grads = traced.lower().compile()(variables["lora"])
    np.testing.assert_allclose(loss, float(want_loss), rtol=1e-5)
    got = to_flax({k: v for k, v in grads.items()}, cfg)["lora"]
    flat_got = dict(jax.tree_util.tree_leaves_with_path(got))
    flat_want = dict(jax.tree_util.tree_leaves_with_path(jax.device_get(want_grads)))
    assert flat_got.keys() == flat_want.keys() and flat_got
    for path, want in flat_want.items():
        want = np.asarray(want)
        np.testing.assert_allclose(flat_got[path], want, rtol=0,
                                   atol=1e-4 * float(np.abs(want).max()),
                                   err_msg=jax.tree_util.keystr(path))
