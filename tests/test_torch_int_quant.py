"""Quantization primitives of the port (ops/int8.py, ops/int4.py and the
head's quantize_cols / quantize_cols_int4) against the JAX package: the same
int8 bytes (after the [in, out] -> [out, in] transpose) and scales, the same
row quantization, and the W4A8 product against the Pallas kernel in
interpret mode and the XLA unpack path."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bitdance_tpu.ops import fused_head as jfh
from bitdance_tpu.ops import int4 as ji4
from bitdance_tpu.ops import int8 as ji8
from bitdance_tpu_torch.ops import fused_head as tfh
from bitdance_tpu_torch.ops import int4 as ti4
from bitdance_tpu_torch.ops import int8 as ti8

torch.set_num_threads(2)


def _w(shape, seed, scale=0.05):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


@pytest.mark.parametrize("kind", ["linear", "linear_int4", "cols", "cols_int4"])
@pytest.mark.parametrize("dtype", [np.float32, "bf16"])
def test_weight_quantizers_match_jax_bytes(kind, dtype):
    """[in, out] JAX weight vs its [out, in] transpose in the port: identical
    int8 bytes, scales within rtol 1e-7 (in fact equal)."""
    w = _w((96, 40), 0)
    jw = jnp.asarray(w) if dtype is np.float32 else jnp.asarray(w, jnp.bfloat16)
    tw = torch.from_numpy(np.array(jw.astype(jnp.float32))).t().contiguous()
    if dtype != np.float32:
        tw = tw.bfloat16()
    if kind == "linear":
        jq, js = ji8.quantize_linear(jw)
        tq, ts = ti8.quantize_linear(tw).q, ti8.quantize_linear(tw).s
    elif kind == "linear_int4":
        jq, js = ji4.quantize_linear_int4(jw)
        tq, ts = ti4.quantize_linear_int4(tw).q, ti4.quantize_linear_int4(tw).s
    elif kind == "cols":
        jq, js = jfh.quantize_cols(jw)
        tq, ts = tfh.quantize_cols(tw)
    else:
        jq, js = jfh.quantize_cols_int4(jw)
        tq, ts = tfh.quantize_cols_int4(tw)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq).T)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js)[0], rtol=1e-7, atol=0)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32


def test_unpack_int4_sign_extends_all_nibbles():
    nib = np.arange(16, dtype=np.int32)
    packed = (nib[:, None] | (nib[None, :] << 4)).astype(np.uint8).view(np.int8)
    lo, hi = ti4.unpack_int4(torch.from_numpy(packed.copy()))
    signed = np.where(nib >= 8, nib - 16, nib)
    np.testing.assert_array_equal(lo.numpy(), np.broadcast_to(signed[:, None], (16, 16)))
    np.testing.assert_array_equal(hi.numpy(), np.broadcast_to(signed[None, :], (16, 16)))
    jlo, jhi = ji4.unpack_int4(jnp.asarray(packed))
    np.testing.assert_array_equal(lo.numpy(), np.asarray(jlo))
    np.testing.assert_array_equal(hi.numpy(), np.asarray(jhi))
    assert lo.dtype == hi.dtype == torch.int8


def test_pack_int4_round_trips():
    q = np.random.default_rng(1).integers(-8, 8, size=(12, 64)).astype(np.int8)
    lo, hi = ti4.unpack_int4(ti4.pack_int4(torch.from_numpy(q)))
    np.testing.assert_array_equal(torch.cat([lo, hi], dim=-1).numpy(), q)


def test_quantize_rows_matches_jax_including_halfway_values():
    x = np.random.default_rng(2).standard_normal((8, 64)).astype(np.float32)
    # rows whose values sit exactly halfway between two int8 steps: amax 127
    # gives scale 1, so x = k + 0.5 must round to the even neighbour
    x[0] = np.concatenate([[127.0], np.arange(-31, 32) + 0.5]).astype(np.float32)
    x[1, :] = 0.0                                  # all-zero row: the 1e-12 floor
    x[2] = np.round(x[2] * 8) / 8 * 31.75          # more halfway points
    jq, js = ji4._quantize_rows(jnp.asarray(x))
    tq, ts = ti8.quantize_rows(torch.from_numpy(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js)[:, 0])
    assert ts[0].item() == 1.0
    assert tq[0, 1].item() == -30 and tq[0, -1].item() == 32     # half to even


def test_true_div_is_an_ieee_division():
    x = torch.from_numpy(np.random.default_rng(3).random(4096).astype(np.float32))
    want = (x.double() / 127.0).float()
    assert torch.equal(ti8.true_div(x, 127.0), want)


def test_int4_matmul_reference_matches_pallas_and_xla():
    """The plain W4A8 product == JAX _w4a8_matmul_tpu (interpret) and
    int4_matmul(force_xla=True) within rtol 1e-6 on the same f32 inputs."""
    x = np.random.default_rng(4).standard_normal((32, 256)).astype(np.float32)
    w = _w((256, 384), 5, 0.02)
    jw = ji4.quantize_linear_int4(jnp.asarray(w))
    xq, sx = ji4._quantize_rows(jnp.asarray(x))
    pallas = np.asarray(ji4._w4a8_matmul_tpu(xq, sx, jw.q, jw.s, interpret=True))
    xla = np.asarray(ji4.int4_matmul(jnp.asarray(x), jw, force_xla=True))
    tw = ti4.quantize_linear_int4(torch.from_numpy(w.T.copy()))
    tq, ts = ti8.quantize_rows(torch.from_numpy(x))
    got = ti4.int4_matmul_reference(tq, ts, tw.q, tw.s).numpy()
    np.testing.assert_allclose(got, pallas, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got, xla, rtol=1e-6, atol=1e-6)
    wrapper = ti4.int4_matmul(torch.from_numpy(x), tw).numpy()
    np.testing.assert_array_equal(wrapper, got)


@pytest.mark.parametrize("shape", [(16, 64), (2, 3, 64)])
def test_int8_matmul_matches_jax(shape):
    x = np.random.default_rng(6).standard_normal(shape).astype(np.float32)
    w = _w((64, 48), 7)
    want = np.asarray(ji8.int8_matmul(jnp.asarray(x), ji8.quantize_linear(jnp.asarray(w))))
    got = ti8.int8_matmul(torch.from_numpy(x),
                          ti8.quantize_linear(torch.from_numpy(w.T.copy())))
    assert got.shape == shape[:-1] + (48,)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_int_dot_is_exact():
    rng = np.random.default_rng(8)
    a = rng.integers(-127, 128, size=(20, 4096)).astype(np.int8)
    b = rng.integers(-127, 128, size=(24, 4096)).astype(np.int8)
    want = (a.astype(np.int64) @ b.astype(np.int64).T).astype(np.float32)
    got = ti8.int_dot(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_array_equal(got.numpy(), want)


def test_mm_dispatches_on_the_weight_type():
    x = torch.from_numpy(np.random.default_rng(9).standard_normal((2, 3, 64))
                         .astype(np.float32)).bfloat16()
    w = torch.from_numpy(_w((32, 64), 10))
    q8, q4 = ti8.quantize_linear(w), ti4.quantize_linear_int4(w)
    assert isinstance(q8, ti8.QTensor) and isinstance(q4, ti4.Q4Tensor)
    np.testing.assert_array_equal(ti8.mm(x, q8).float().numpy(),
                                  ti8.int8_matmul(x, q8).float().numpy())
    np.testing.assert_array_equal(ti8.mm(x, q4).float().numpy(),
                                  ti4.int4_matmul(x, q4).float().numpy())
    np.testing.assert_array_equal(ti8.mm(x.float(), w).numpy(),
                                  (x.float() @ w.t()).numpy())
    for out in (ti8.mm(x, q8), ti8.mm(x, q4)):
        assert out.shape == (2, 3, 32) and out.dtype == torch.bfloat16
    # the two formats dequantize back to the weight within half a step
    for back, step in ((ti8.dequantize(q8, torch.float32), q8.s),
                       (ti4.dequantize_int4(q4, torch.float32), q4.s)):
        assert ((back - w).abs() <= 0.5 * step[:, None] + 1e-7).all()
