"""The head GEMM's integer kinds (kernel #2's W8A8 / W4A8 quant modes,
``csrc/head_gemm.cuh``) on the CPU: the quant plan at the 14B head's
products and its refusals, the split ranges over 128-byte stages, the plain
split twin ``head_gemm_s8_split_plain`` bit for bit at every split count in
both modes and every epilogue, and the twin against the JAX package's
``_mmq`` (the quant mode's stage_dot) plus the same epilogue.

The integer sums are exact on both sides, so the twin's outputs do not
depend on the split count, and its dequantized sum y = float(acc) * (sa *
ws) equals JAX's bit for bit; the epilogues then take the same fp32 and
bf16 steps (silu's exp may differ by an ulp between the packages: 1e-6
relative on "swiglu_q")."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bitdance_tpu.ops import fused_head as jfh
from bitdance_tpu_torch.ops import fused_head as tfh
from bitdance_tpu_torch.ops.int4 import quantize_linear_int4
from bitdance_tpu_torch.ops.int8 import quantize_linear, quantize_rows

torch.set_num_threads(2)

# the 14B head's products (rows, N, K) -> (bm, bn, splits) at 132 SMs, the
# same in int8 and int4 (qkv / w1 120 or 240 tiles; wo / w2 40 tiles x 2 at
# 128 rows, 80 x 1 at 256)
PLANNED_Q = {"qkv_128": ((128, 15360, 5120), (128, 128, 1)),
             "wo_128": ((128, 5120, 5120), (128, 128, 2)),
             "w1_128": ((128, 15360, 5120), (128, 128, 1)),
             "w2_128": ((128, 5120, 7680), (128, 128, 2)),
             "qkv_256": ((256, 15360, 5120), (128, 128, 1)),
             "wo_256": ((256, 5120, 5120), (128, 128, 1)),
             "w1_256": ((256, 15360, 5120), (128, 128, 1)),
             "w2_256": ((256, 5120, 7680), (128, 128, 1))}
# stages of 128 bytes: int8 K / 128, packed int4 K / 256 (a half last stage)
STAGES = {("int8", 5120): 40, ("int8", 7680): 60, ("int4", 5120): 20, ("int4", 7680): 30,
          ("int4", 384): 2, ("int8", 384): 3}


@pytest.mark.parametrize("quant", ["int8", "int4"])
@pytest.mark.parametrize("name", list(PLANNED_Q))
def test_quant_plan_at_the_14b_head(name, quant):
    shape, want = PLANNED_Q[name]
    assert tuple(tfh.head_gemm_plan(*shape, quant=quant)) == want
    key = name.split("_")[0]
    rows = shape[0]
    plans = tfh.sampler_plans(rows, 5120, 7680, True, quant=quant)
    assert plans["wqkv" if key == "qkv" else key] == tfh.HeadGemmPlan(*want)


@pytest.mark.parametrize("quant,k", list(STAGES))
def test_quant_stages(quant, k):
    assert tfh.head_gemm_stages(k, quant) == STAGES[(quant, k)]


def test_quant_plan_refusals():
    with pytest.raises(ValueError):
        tfh.head_gemm_plan(128, 5120 + 64, 5120, quant="int8")     # N % 128
    with pytest.raises(ValueError):
        tfh.head_gemm_plan(128, 5120, 5120 + 64, quant="int8")     # K % 128
    with pytest.raises(ValueError):
        tfh.head_gemm_plan(128, 5120, 5120 + 64, quant="int4")
    with pytest.raises(ValueError):
        tfh.head_gemm_plan(128, 5120, 5120, quant="int2")
    with pytest.raises(ValueError):
        tfh.head_gemm_plan(0, 5120, 5120, quant="int4")


@pytest.mark.parametrize("quant", ["int8", "int4"])
@pytest.mark.parametrize("k", [128, 384, 1280, 5120, 7680])
def test_split_ranges_cover_k_once(quant, k):
    """Every split count the plan may pick: the ranges of stored columns
    (int8: k; int4: packed bytes, each holding k and k + K/2) are whole
    128-byte stages (a packed last one may be half), in order, cover the row
    once, and the plan's splits each walk two stages or more."""
    cols = k // 2 if quant == "int4" else k
    steps = tfh.head_gemm_stages(k, quant)
    for splits in (1, 2, 4, 8):
        if splits > steps:
            continue
        r = tfh.head_gemm_split_ranges(k, splits, quant)
        assert len(r) == splits and r[0][0] == 0 and r[-1][1] == cols
        assert all(a[1] == b[0] for a, b in zip(r, r[1:]))
        assert all(c1 > c0 and c0 % 128 == 0 and (c1 % 128 == 0 or c1 == cols) for c0, c1 in r)
    for rows in (64, 128, 256):
        p = tfh.head_gemm_plan(rows, 1280, k, quant=quant)
        r = tfh.head_gemm_split_ranges(k, p.splits, quant)
        if steps >= 2:
            assert min(-(-(c1 - c0) // 128) for c0, c1 in r) >= 2 or p.splits == 1


def _operands(rows, n, k, mode, quant, seed):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((rows, k)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((n, k)) / k ** 0.5).astype(np.float32))
    qt = quantize_linear_int4(w) if quant == "int4" else quantize_linear(w)
    bias = torch.from_numpy(0.1 * rng.standard_normal(n).astype(np.float32)).bfloat16()
    kw = {}
    if mode == "gated_f32":
        kw["resid"] = torch.from_numpy(rng.standard_normal((rows, n)).astype(np.float32))
        kw["gate"] = torch.from_numpy(0.5 * rng.standard_normal((rows, n)).astype(np.float32)
                                      ).bfloat16()
    return x, qt, bias, kw


MODES = ("bias", "gated_f32", "swiglu_q")


@pytest.mark.parametrize("quant", ["int8", "int4"])
@pytest.mark.parametrize("mode", MODES)
def test_split_twin_is_bit_equal_at_every_split_count(mode, quant):
    """int32 partials summed in split order: the same bits at 1, 2 and 4
    splits (and at a half last int4 stage, K 384), and through the wrapper's
    CPU branch at its plan's splits."""
    for k in (1024, 384):
        x, qt, bias, kw = _operands(40, 256, k, mode, quant, 3)
        aq, sa = quantize_rows(x)
        outs = [tfh.head_gemm_s8_split_plain(aq, sa, qt.q, qt.s, mode, bias, splits=s,
                                             quant=quant, **kw)
                for s in (1, 2, 4) if s <= tfh.head_gemm_stages(k, quant)]
        assert len(outs) >= 2
        assert all(torch.equal(o, outs[0]) for o in outs[1:])
        want_shape = (40, 128) if mode == "swiglu_q" else (40, 256)
        assert tuple(outs[0].shape) == want_shape
        assert outs[0].dtype == (torch.bfloat16 if mode == "bias" else torch.float32)
        fresh = {q: v.clone() if q == "resid" else v for q, v in kw.items()}
        got = tfh.head_gemm_s8(aq, sa, qt.q, qt.s, mode, bias, quant=quant, **fresh)
        assert torch.equal(got, outs[0])
        if mode == "gated_f32":
            assert got is fresh["resid"]            # updated in place, as on the card


@pytest.mark.parametrize("quant", ["int8", "int4"])
@pytest.mark.parametrize("mode", MODES)
def test_split_twin_matches_jax_mmq(mode, quant):
    """The twin against the JAX kernel #2's stage_dot (``_mmq``: the same
    row quantization from fp32, the exact integer sum, acc * (sa * scale))
    plus the same epilogue in fp32."""
    n, k = 256, 512
    x, qt, bias, kw = _operands(48, n, k, mode, quant, 5)
    aq, sa = quantize_rows(x)
    got = tfh.head_gemm_s8_split_plain(aq, sa, qt.q, qt.s, mode, bias, splits=2, quant=quant,
                                       **kw).float().numpy()
    # JAX layout: [in, out] (packed [in/2, out]), scales [1, out]
    y = np.asarray(jfh._mmq(jnp.asarray(x.numpy()), jnp.asarray(qt.q.numpy().T),
                            jnp.asarray(qt.s.numpy()[None])))
    yb = jnp.asarray(y) + jnp.asarray(bias.float().numpy())[None]
    if mode == "bias":
        want = np.asarray(yb.astype(jnp.bfloat16).astype(jnp.float32))
        np.testing.assert_array_equal(got, want)
    elif mode == "gated_f32":
        want = np.asarray(jnp.asarray(kw["resid"].numpy())
                          + yb * jnp.asarray(kw["gate"].float().numpy()))
        np.testing.assert_array_equal(got, want)
    else:
        h12 = yb.astype(jnp.bfloat16).astype(jnp.float32)
        import jax

        want = np.asarray(jax.nn.silu(h12[:, :n // 2]) * h12[:, n // 2:])
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_twin_refuses_unknown_modes():
    x, qt, bias, _ = _operands(8, 128, 128, "bias", "int8", 0)
    aq, sa = quantize_rows(x)
    with pytest.raises(ValueError):
        tfh.head_gemm_s8_split_plain(aq, sa, qt.q, qt.s, "swiglu_f32", bias)
    with pytest.raises(ValueError):
        tfh.head_gemm_s8(aq, sa, qt.q, qt.s, "bias", bias, quant="int2")


# a tp-2 rank's products of the 14B head at R 128 (N cut to 256; K as the
# rank holds it): qkv and w1 whole in K, wo and w2 a half of it
RANK_K = {"wqkv": 5120, "wo": 2560, "w1": 5120, "w2": 3840}


def _int_matmul_ranges(aq, w, quant, splits):
    """int32 sums of torch integer matmuls (int64 on the CPU) over the
    planned K ranges of ``splits``, the packed int4 planes each against
    its half of the rows, summed in split order."""
    from bitdance_tpu_torch.ops.int4 import unpack_int4

    k = aq.shape[1]
    acc = torch.zeros((aq.shape[0], w.shape[0]), dtype=torch.int64)
    for c0, c1 in tfh.head_gemm_split_ranges(k, splits, quant):
        if quant == "int4":
            lo, hi = unpack_int4(w[:, c0:c1])
            acc += aq[:, c0:c1].long() @ lo.long().t()
            acc += aq[:, k // 2 + c0:k // 2 + c1].long() @ hi.long().t()
        else:
            acc += aq[:, c0:c1].long() @ w[:, c0:c1].long().t()
    return acc.to(torch.int32)


@pytest.mark.parametrize("quant", ["int8", "int4"])
@pytest.mark.parametrize("key", list(RANK_K))
def test_out_s32_twin_is_the_integer_sums(key, quant):
    """"out_s32" (the tensor-parallel head's row-parallel products): the
    split twin's int32 output at 1, 2 and 4 splits is exactly the sum of
    torch integer matmuls over the planned K ranges, the same at every
    split count, and the wrapper's CPU branch gives it at its plan without
    any scale or bias."""
    k = RANK_K[key]
    rng = np.random.default_rng(sum(map(ord, key + quant)))
    aq = torch.from_numpy(rng.integers(-127, 128, (128, k), dtype=np.int8))
    w = torch.from_numpy(rng.integers(-127, 128, (256, k // 2 if quant == "int4" else k),
                                      dtype=np.int8))
    outs = []
    for splits in (1, 2, 4):
        got = tfh.head_gemm_s8_split_plain(aq, None, w, None, "out_s32", None, splits=splits,
                                           quant=quant)
        assert got.dtype == torch.int32 and tuple(got.shape) == (128, 256)
        assert torch.equal(got, _int_matmul_ranges(aq, w, quant, splits))
        outs.append(got)
    assert all(torch.equal(o, outs[0]) for o in outs[1:])
    assert torch.equal(tfh.head_gemm_s8(aq, None, w, None, "out_s32", None, quant=quant), outs[0])
