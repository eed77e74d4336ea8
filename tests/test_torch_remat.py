"""qwen3_forward(remat=True, remat_policy="dots") against the JAX package's
"dots" policy (dots_with_no_batch_dims_saveable) and against the port's
"full" policy on the CPU: the hidden states and the gradients, and that
"dots" keeps the layers' weight products for the backward instead of
recomputing them."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from bitdance_tpu.models import qwen3 as jq
from bitdance_tpu_torch.io.from_jax import qwen3_from_jax
from bitdance_tpu_torch.models import qwen3 as tq

torch.set_num_threads(2)
LLM = dict(vocab_size=300, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
           num_attention_heads=4, num_key_value_heads=2, head_dim=16)


def _case():
    """Two packed documents (tests/test_torch_mllm.py's layout: the second
    in windows of 4), embeds and an output cotangent."""
    blk, doc = [], []
    nb = 0
    for i, (n, window) in enumerate(((30, 1), (42, 4))):
        blk += [nb + j // window for j in range(n)]
        nb += -(-n // window)
        doc += [i] * n
    pos = np.concatenate([np.arange(30), np.arange(42)])[None]
    rng = np.random.default_rng(1)
    x = rng.normal(size=(1, 72, 64)).astype(np.float32)
    cot = rng.normal(size=(1, 72, 64)).astype(np.float32)
    ids = [np.asarray(a, np.int32).reshape(1, -1) for a in (pos, blk, doc)]
    return ids, x, cot


def _model():
    params = jq.init_qwen3_params(jax.random.PRNGKey(0), jq.Qwen3Config(**LLM))
    return params, qwen3_from_jax(tq.Qwen3Config(**LLM), params).requires_grad_(True)


def _port(model, ids, x, cot, policy):
    model.zero_grad(set_to_none=True)
    tx = torch.tensor(x, requires_grad=True)
    out = tq.qwen3_forward(model, tx, *(torch.from_numpy(a).long() for a in ids),
                           remat=True, remat_policy=policy)
    (out * torch.from_numpy(cot)).sum().backward()
    return out.detach(), tx.grad, {n: p.grad.clone() for n, p in model.named_parameters()
                                   if p.grad is not None}


def test_dots_matches_jax_dots():
    """fp32; hidden states 1e-5 and gradients 1e-4, the bounds of
    tests/test_torch_mllm.py's remat test."""
    params, model = _model()
    ids, x, cot = _case()
    cfg = jq.Qwen3Config(**LLM)

    def jloss(p, x):
        out = jq.qwen3_forward(p, cfg, x, *ids, remat=True, remat_policy="dots")
        return jnp.sum(out * cot), out

    (_, want), (jg, jgx) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        params, jnp.asarray(x))
    out, gx, grads = _port(model, ids, x, cot, "dots")
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(gx.numpy(), np.asarray(jgx), rtol=1e-4, atol=1e-5)
    for i in range(2):
        for name, key in (("self_attn.q_proj", "q_proj"), ("self_attn.v_proj", "v_proj"),
                          ("mlp.down_proj", "down_proj"), ("mlp.gate_proj", "gate_proj")):
            np.testing.assert_allclose(
                grads[f"model.layers.{i}.{name}.weight"].numpy(),
                np.asarray(jg["layers"][key])[i].T, rtol=1e-4, atol=1e-5, err_msg=name)
        np.testing.assert_allclose(
            grads[f"model.layers.{i}.input_layernorm.weight"].numpy(),
            np.asarray(jg["layers"]["input_layernorm"])[i], rtol=1e-4, atol=1e-5)


def test_dots_is_bit_equal_to_full_on_cpu():
    _, model = _model()
    ids, x, cot = _case()
    full = _port(model, ids, x, cot, "full")
    dots = _port(model, ids, x, cot, "dots")
    assert torch.equal(full[0], dots[0]) and torch.equal(full[1], dots[1])
    assert full[2].keys() == dots[2].keys()
    for n in full[2]:
        assert torch.equal(full[2][n], dots[2][n]), n


class _CountMM(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.mm = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.mm += func in tq.DOTS_SAVED_OPS
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("policy,recomputed", [("full", 6), ("dots", 0)])
def test_dots_keeps_the_weight_products(policy, recomputed):
    """The backward of a layer takes 2 products per weight product (its
    input and weight gradients); "full" also recomputes the layer's weight
    products up to gate / up (non-reentrant checkpointing stops before
    down_proj, whose output no gradient needs), "dots" none."""
    _, model = _model()
    ids, x, cot = _case()
    tx = torch.tensor(x, requires_grad=True)
    out = tq.qwen3_forward(model, tx, *(torch.from_numpy(a).long() for a in ids),
                           remat=True, remat_policy=policy)
    with _CountMM() as count:
        (out * torch.from_numpy(cot)).sum().backward()
    layers = LLM["num_hidden_layers"]
    assert count.mm == layers * (2 * 7 + recomputed)
    with pytest.raises(ValueError, match="remat_policy"):
        tq.qwen3_forward(model, tx, *(torch.from_numpy(a).long() for a in ids),
                         remat=True, remat_policy="offload")
