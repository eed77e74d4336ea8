"""Fused-KV decode attention (ops/decode_attention.py) against the JAX
package: the packing and int8 quantization of new rows byte for byte, and
the kernel's plain version against the Pallas kernel in interpret mode for
bf16 and int8 buffers, per-row windows with kv_start > 0."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bitdance_tpu.ops import decode_attention as jda
from bitdance_tpu_torch.ops import decode_attention as tda

torch.set_num_threads(2)


def _qkv(b, s, lmax, hq, hkv, d, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, s, hq, d)).astype(np.float32)
    k = rng.standard_normal((b, lmax, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, lmax, hkv, d)).astype(np.float32)
    return q, k, v


def test_pack_and_quantize_kv_rows_match_jax():
    _, k, v = _qkv(2, 1, 24, 4, 2, 16, 0)
    k[0, 3] = 0.0                                  # an all-zero row: the 1e-8 floor
    np.testing.assert_array_equal(
        tda.pack_kv_rows(torch.from_numpy(k), torch.from_numpy(v)).numpy(),
        np.asarray(jda.pack_kv_rows(jnp.asarray(k), jnp.asarray(v))))
    jkv, jsc = jda.quantize_kv_rows(jnp.asarray(k), jnp.asarray(v))
    tkv, tsc = tda.quantize_kv_rows(torch.from_numpy(k), torch.from_numpy(v))
    assert tkv.dtype == torch.int8 and tuple(tkv.shape) == (2, 2, 24, 32)
    assert tuple(tsc.shape) == (2, 2, 2, 24)
    np.testing.assert_array_equal(tkv.numpy(), np.asarray(jkv))
    np.testing.assert_array_equal(tsc.numpy(), np.asarray(jsc))
    jk, jv = jda.dequantize_fused_kv(jkv, jsc)
    tk, tv = tda.dequantize_fused_kv(tkv, tsc)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("quant", [False, True])
def test_fusedkv_reference_matches_pallas_interpret(quant):
    q, k, v = _qkv(2, 4, 384, 4, 2, 64, 1)
    kv_len = np.asarray([200, 384], np.int32)
    kv_start = np.asarray([30, 130], np.int32)
    if quant:
        jkv, jsc = jda.quantize_kv_rows(jnp.asarray(k), jnp.asarray(v))
        tkv, tsc = tda.quantize_kv_rows(torch.from_numpy(k), torch.from_numpy(v))
    else:
        jkv, jsc = jda.pack_kv_rows(jnp.asarray(k), jnp.asarray(v)), None
        tkv, tsc = tda.pack_kv_rows(torch.from_numpy(k), torch.from_numpy(v)), None
    want = np.asarray(jda.decode_attention_fusedkv(
        jnp.asarray(q), jkv, jnp.asarray(kv_len), jnp.asarray(kv_start),
        kv_scales=jsc, interpret=True))
    args = (torch.from_numpy(q), tkv.contiguous(), torch.from_numpy(kv_len),
            torch.from_numpy(kv_start), None if tsc is None else tsc.contiguous())
    got = tda.decode_attention_fusedkv_reference(*args).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(tda.decode_attention_fusedkv(*args).numpy(), got)


def test_empty_window_gives_zero_and_windowed_dispatches():
    q, k, v = _qkv(2, 3, 40, 4, 2, 16, 2)
    kv, sc = tda.quantize_kv_rows(torch.from_numpy(k), torch.from_numpy(v))
    kv_len = torch.tensor([40, 10], dtype=torch.int32)
    kv_start = torch.tensor([5, 10], dtype=torch.int32)
    got = tda.windowed_decode_attention_fusedkv(torch.from_numpy(q), kv, kv_len,
                                                kv_start, sc)
    assert (got[1] == 0).all() and got[0].abs().sum() > 0
    np.testing.assert_array_equal(
        got.numpy(), tda.decode_attention_fusedkv_reference(
            torch.from_numpy(q), kv, kv_len, kv_start, sc).numpy())
    # the XLA fallback path of the JAX package (dequantize, then dense
    # attention) agrees on the non-empty row
    want = np.asarray(jda.windowed_decode_attention_fusedkv(
        jnp.asarray(q), jnp.asarray(kv.numpy()), jnp.asarray(kv_len.numpy()),
        jnp.asarray(kv_start.numpy()), jnp.asarray(sc.numpy()),
        implementation="xla"))
    np.testing.assert_allclose(got.numpy()[0], want[0], rtol=1e-5, atol=1e-5)


def test_bf16_buffer_matches_the_separate_cache_kernel_plain_version():
    """A bf16 fused buffer attends exactly as the head-major k/v caches of
    the bf16 decode kernel's plain version."""
    q, k, v = _qkv(2, 4, 64, 4, 2, 128, 3)
    qt = torch.from_numpy(q).bfloat16()
    kt, vt = torch.from_numpy(k).bfloat16(), torch.from_numpy(v).bfloat16()
    kv_len = torch.tensor([64, 33], dtype=torch.int32)
    kv_start = torch.tensor([0, 7], dtype=torch.int32)
    fused = tda.decode_attention_fusedkv(qt, tda.pack_kv_rows(kt, vt).contiguous(),
                                         kv_len, kv_start)
    split = tda.decode_attention(qt, kt.transpose(1, 2).contiguous(),
                                 vt.transpose(1, 2).contiguous(), kv_len, kv_start)
    np.testing.assert_array_equal(fused.float().numpy(), split.float().numpy())
