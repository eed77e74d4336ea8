"""Quantized Qwen3 serving in the port vs the JAX package: the int8 (W8A8)
and packed-int4 (W4A8, int8 embedding) models carried from JAX trees by
io/from_jax.py, with the fused int8 KV cache, against JAX
qwen3_forward_cached over one causal prefill and two bidirectional blocks;
and quantize_qwen3_ of the carried bf16/f32 weights against the JAX
quantizers, byte for byte.

Bound: relative Frobenius error 2e-2 per block output. Both sides round the
same integers, but an upstream difference of one float rounding (summation
order, the fused-KV kernel's plain version folding the scales into the
scores where the JAX CPU path dequantizes to the activation dtype first) can
move one activation across an int8 step."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bitdance_tpu.models import qwen3 as jq
from bitdance_tpu.ops.decode_attention import dequantize_fused_kv as j_dequantize
from bitdance_tpu_torch.io.from_jax import (
    load_into,
    qwen3_from_jax,
    qwen3_quant_modes,
    qwen3_state_from_jax,
)
from bitdance_tpu_torch.models import qwen3 as tq
from bitdance_tpu_torch.ops.decode_attention import dequantize_fused_kv as t_dequantize

torch.set_num_threads(2)
REL_FROB = 2e-2

KW = dict(vocab_size=64, hidden_size=64, intermediate_size=128,
          num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
          head_dim=16, rope_theta=10000.0)


def _params(seed=0):
    jcfg = jq.Qwen3Config(**KW)
    params = jq.init_qwen3_params(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    params.pop("lm_head", None)
    rng = np.random.default_rng(seed)
    for k in ("q_norm", "k_norm", "input_layernorm", "post_attention_layernorm"):
        params["layers"][k] = jnp.asarray(
            1.0 + 0.2 * rng.normal(size=params["layers"][k].shape), jnp.float32)
    return jcfg, params


def _quantized(params, mode):
    if mode == "int8":
        return jq.quantize_qwen3_params(params)
    return jq.quantize_qwen3_params_int4(params)


def _rel(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_quantized_cached_forward_with_int8_cache(mode):
    jcfg, params = _params()
    jp = _quantized(params, mode)
    tm = qwen3_from_jax(tq.Qwen3Config(**KW), jp)
    kinds = {"int8": (tq.QLinear, torch.nn.Embedding), "int4": (tq.Q4Linear, tq.QEmbedding)}
    assert type(tm.model.layers[1].mlp.down_proj) is kinds[mode][0]
    assert isinstance(tm.model.embed_tokens, kinds[mode][1])
    P, p, steps_p = 6, 4, 4
    pads = np.array([0, 3, 1], np.int32)
    b = len(pads)
    max_len = P + 2 + p + steps_p
    rng = np.random.default_rng(1)
    # the int4 model's embeddings come from its int8 table as bf16
    dt = (jnp.float32, torch.float32) if mode == "int8" else (jnp.bfloat16, torch.bfloat16)
    emb = rng.normal(size=(b, max_len, 64)).astype(np.float32)
    emb = np.asarray(jnp.asarray(emb, dt[0]).astype(jnp.float32))
    pos = np.maximum(np.arange(max_len)[None] - pads[:, None], 0).astype(np.int32)
    jcache = jq.init_kv_cache(jcfg, b, max_len, int8=True)
    tcache = tq.init_kv_cache(tm.cfg, b, max_len, int8=True)
    assert tcache["kv"].dtype == torch.int8 and tuple(tcache["sc"].shape) == (2, b, 2, 2, max_len)
    segments = [(0, P + 2, True), (P + 2, P + 2 + p, False), (P + 2 + p, max_len, False)]
    with torch.no_grad():
        for s0, s1, causal in segments:
            jh, jcache = jq.qwen3_forward_cached(
                jp, jcfg, jnp.asarray(emb[:, s0:s1], dt[0]), jnp.asarray(pos[:, s0:s1]),
                jcache, jnp.int32(s0), jnp.asarray(pads), causal_block=causal)
            th, tcache = tq.qwen3_forward_cached(
                tm, torch.from_numpy(emb[:, s0:s1].copy()).to(dt[1]),
                torch.from_numpy(pos[:, s0:s1]), tcache, s0, torch.from_numpy(pads),
                causal_block=causal)
            assert th.dtype == dt[1]
            jh = np.asarray(jh.astype(jnp.float32))
            th = th.float().numpy()
            if causal:
                real = pos[:, s0:s1] > 0
                real[:, 0] |= pads == 0
                jh, th = jh[real], th[real]
            assert _rel(th, jh) < REL_FROB, (s0, causal, _rel(th, jh))
    live = np.arange(max_len)[None] >= pads[:, None]
    jk, jv = (np.asarray(t) for t in j_dequantize(jcache["kv"][0], jcache["sc"][0]))
    tk, tv = t_dequantize(tcache["kv"][0], tcache["sc"][0])
    for got, want in ((tk.numpy(), jk), (tv.numpy(), jv)):
        got = got.transpose(0, 2, 1, 3)[live]
        want = want.transpose(0, 2, 1, 3)[live]
        assert _rel(got, want) < REL_FROB


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_quantize_qwen3_gives_the_jax_bytes(mode):
    """quantize_qwen3_ of the carried f32 weights == JAX quantize_qwen3_params
    (_int4) carried as quantized leaves: the same buffers, byte for byte."""
    _, params = _params(2)
    tm = load_into(tq.Qwen3Model(tq.Qwen3Config(**KW)), qwen3_state_from_jax(params))
    tq.quantize_qwen3_(tm, mode)
    jp = _quantized(params, mode)
    assert qwen3_quant_modes(jp) == (mode, mode == "int4")
    want = qwen3_state_from_jax(jp)
    got = {k: v.numpy() for k, v in tm.state_dict().items()}
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["model.layers.0.mlp.gate_proj.q"].shape == (
        (128, 64) if mode == "int8" else (128, 32))


def test_int8_embedding_gather_matches_jax():
    _, params = _params(3)
    jp = jq.quantize_qwen3_params_int4(params)
    tm = qwen3_from_jax(tq.Qwen3Config(**KW), jp)
    ids = np.array([[1, 5, 63], [0, 0, 7]], np.int64)
    got = tq.embed_tokens(tm, torch.from_numpy(ids))
    want = jq.embed_tokens(jp, jnp.asarray(ids, jnp.int32))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))
