"""The attention block #15 (``fused_attn_block``) on the head GEMM, on the
CPU: its qkv product's "bias_f32" mode (the fp32 sums plus the bias, qkv
kept in fp32 as the TPU kernel keeps it) and its plans.

- The split twin (``head_gemm_split_plain``) of "bias_f32" at 1 / 2 / 4 / 8
  splits against the same product in one pass, its fp32 partials read
  through a spy on ``_dot_acc``; the CPU branch of ``head_gemm`` equal to
  the twin at the plan's splits.
- ``fused_attn_block_reference`` on the split twin at the card's plans
  (``attn_block_plans``) against the JAX ``fused_attn_block(...,
  interpret=True)`` (the TPU kernel #15) at 32 windows of 16, C 256, with 4
  heads (head dim 64) and 2 heads (head dim 128), bf16; qkv rounded to bf16
  before the attention fails the bound.
- The plans at 256 / 512 / 1024 rows, and the refusal of a shape the head
  GEMM cannot take.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bitdance_tpu.ops import fused_block as jfb
from bitdance_tpu_torch.ops import fused_block as tfb
from bitdance_tpu_torch.ops import fused_head as tfh

torch.set_num_threads(2)
BF = torch.bfloat16


def _bf(rng, *shape, scale=1.0):
    return torch.from_numpy((scale * rng.standard_normal(shape)).astype(np.float32)).to(BF)


# B-16x's qkv product at 24 rows: [2304, 768], 12 stages of 64 k
QKV_SHAPE = (24, 2304, 768)
# split vs one pass, max |difference| / max |one pass|: fp32 sums over K 768
# in another order, a few fp32 ulps (as "out_f32")
BIAS_F32_SPLIT_BOUND = 1e-5


@pytest.mark.parametrize("splits", [1, 2, 4, 8])
def test_bias_f32_split_twin_matches_one_pass(splits, monkeypatch):
    rows, n, k = QKV_SHAPE
    rng = np.random.default_rng(0)
    a, w, bias = _bf(rng, rows, k), _bf(rng, n, k, scale=k ** -0.5), _bf(rng, n, scale=0.1)
    one = tfh.head_gemm_split_plain(a, w, "bias_f32", bias, splits=1)
    widths, dot = [], tfh._dot_acc
    monkeypatch.setattr(tfh, "_dot_acc", lambda a, w: widths.append(w.shape[1]) or dot(a, w))
    got = tfh.head_gemm_split_plain(a, w, "bias_f32", bias, splits=splits)
    # fp32 partials over the split ranges of whole 64-k stages
    assert widths == [k1 - k0 for k0, k1 in tfh.head_gemm_split_ranges(k, splits)]
    assert got.dtype == torch.float32 and got.shape == (rows, n)
    rel = ((got - one).abs().max() / one.abs().max()).item()
    assert rel < BIAS_F32_SPLIT_BOUND, rel


def test_bias_f32_epilogue_is_the_fp32_sums_plus_the_bias():
    rng = np.random.default_rng(1)
    a, w, b = _bf(rng, 16, 256), _bf(rng, 768, 256, scale=1 / 16), _bf(rng, 768, scale=0.1)
    got = tfh.head_gemm_split_plain(a, w, "bias_f32", b)
    assert torch.equal(got, a.float() @ w.float().t() + b.float())
    assert tfh.HEAD_GEMM_MODES["bias_f32"] == 4        # kBiasF32 in head_blocks.cuh


def test_head_gemm_bias_f32_on_the_cpu_is_the_planned_twin():
    rows, n, k = QKV_SHAPE
    rng = np.random.default_rng(2)
    a, w, bias = _bf(rng, rows, k), _bf(rng, n, k, scale=k ** -0.5), _bf(rng, n, scale=0.1)
    plan = tfh.head_gemm_plan(rows, n, k)
    assert plan.splits > 1
    before = tfh.head_gemm.launches
    want = tfh.head_gemm_split_plain(a, w, "bias_f32", bias, splits=plan.splits)
    assert torch.equal(tfh.head_gemm(a, w, "bias_f32", bias), want)
    assert tfh.head_gemm.launches == before


C, GROUPS, WINDOW = 256, 32, 16


def _attn_args(seed):
    """bf16 block inputs at C 256 over 32 windows of 16 rows."""
    rng = np.random.default_rng(seed)
    lead = (GROUPS, WINDOW)
    x = _bf(rng, *lead, C)
    scale, shift = _bf(rng, *lead, C, scale=0.1), _bf(rng, *lead, C, scale=0.1)
    gate = _bf(rng, *lead, C, scale=0.5)
    ln_w = (1 + 0.1 * _bf(rng, C).float()).to(BF)
    return (x, scale, shift, gate, ln_w, _bf(rng, C, scale=0.1),
            _bf(rng, 3 * C, C, scale=C ** -0.5), _bf(rng, 3 * C, scale=0.1),
            _bf(rng, C, C, scale=C ** -0.5), _bf(rng, C, scale=0.1))


def _jax_attn(args, n_head):
    """The JAX kernel #15 in interpret mode on bf16 operands (its weights in
    the JAX layout [in, out])."""
    x, scale, shift, gate, ln_w, ln_b, wqkv, bqkv, wo, bo = args
    j = lambda t: jnp.asarray(t.float().numpy(), jnp.bfloat16)   # noqa: E731
    out = jfb.fused_attn_block(j(x), j(scale), j(shift), j(gate), j(ln_w), j(ln_b),
                               j(wqkv.t()), j(bqkv), j(wo.t()), j(bo), n_head=n_head,
                               interpret=True)
    return torch.from_numpy(np.array(out.astype(jnp.float32)))


def _gaps(got, want):
    d = (got.float() - want).abs()
    return (d.max() / want.abs().max()).item(), (d.mean() / want.abs().mean()).item()


# the port's attention block against the JAX kernel #15 in bf16, max
# |difference| / max |JAX out| and mean |difference| / mean |JAX out|: both
# take LN statistics, qkv, the softmax, P V and y in fp32 and round h, the
# attention output and the block output to bf16; the fp32 orders differ, so
# a few outputs move by a bf16 ulp where they sit at a rounding boundary
# (measured at most 3.2e-3 / 9.0e-6 over both head dims, three seeds and 1-4
# splits). qkv rounded to bf16 before the attention (the round route's
# precision) reads 3.2e-3-3.5e-3 / 5.0e-4-5.3e-4: the mean bound sits between;
# the max bound (two bf16 ulps of the largest output) holds the rest.
ATTN_JAX_REL = 8e-3
ATTN_JAX_MEAN = 5e-5


@pytest.mark.parametrize("n_head", [4, 2], ids=["hd64", "hd128"])
def test_attn_block_reference_on_the_plans_matches_jax(n_head):
    """fused_attn_block_reference on the split twin at the card's plans (512
    rows at C 256: qkv and wo at 2 splits) and in one pass (the wrapper's
    CPU branch) against the JAX kernel #15."""
    args = _attn_args(seed=n_head)
    rows = GROUPS * WINDOW
    p_qkv, p_wo = tfb.attn_block_plans(rows, C)
    splits = {"qkv": p_qkv.splits, "wo": p_wo.splits}
    assert splits == {"qkv": 2, "wo": 2}
    want = _jax_attn(args, n_head)
    got = tfb.fused_attn_block_reference(*args, n_head, splits=splits)
    assert got.dtype == BF and got.shape == (GROUPS, WINDOW, C)
    top, mean = _gaps(got, want)
    assert top < ATTN_JAX_REL and mean < ATTN_JAX_MEAN, (top, mean)
    before = tfb.fused_attn_block.launches
    one = tfb.fused_attn_block(*args, n_head)
    assert tfb.fused_attn_block.launches == before
    assert torch.equal(one, tfb.fused_attn_block_reference(*args, n_head))
    top, mean = _gaps(one, want)
    assert top < ATTN_JAX_REL and mean < ATTN_JAX_MEAN, (top, mean)


@pytest.mark.parametrize("n_head", [4, 2], ids=["hd64", "hd128"])
def test_bf16_qkv_fails_the_jax_attn_bound(n_head, monkeypatch):
    """The mean bound catches the fault it is for: qkv rounded to bf16
    (q and k as bf16 operands) before the attention."""
    args = _attn_args(seed=n_head)
    mm = tfb._mm

    def rounded(a, w, s=1):
        out = mm(a, w, s)
        return out.to(BF).float() if w.shape[0] == 3 * C else out

    monkeypatch.setattr(tfb, "_mm", rounded)
    got = tfb.fused_attn_block_reference(*args, n_head)
    assert _gaps(got, _jax_attn(args, n_head))[1] > ATTN_JAX_MEAN


# rows -> the plans of #15's qkv and wo at B-16x (C 768): (bm, bn, splits)
ATTN_PLANS = {256: ((128, 128, 2), (128, 128, 4)),
              512: ((128, 128, 1), (128, 128, 4)),
              1024: ((128, 128, 1), (128, 128, 2))}


@pytest.mark.parametrize("rows", list(ATTN_PLANS))
def test_attn_block_plans(rows):
    plans = tfb.attn_block_plans(rows, 768)
    assert tuple(map(tuple, plans)) == ATTN_PLANS[rows]
    assert plans == (tfh.head_gemm_plan(rows, 3 * 768, 768), tfh.head_gemm_plan(rows, 768, 768))


@pytest.mark.parametrize("c", [192, 320, 448])
def test_attn_block_plans_refuse_shapes_the_head_gemm_cannot_take(c):
    """C % 128 not 0: the card's wrapper raises (no other GEMM to fall back
    on)."""
    with pytest.raises(ValueError, match="head GEMM"):
        tfb.attn_block_plans(512, c)


def test_every_head_width_takes_the_attn_block_plans():
    """The released head widths (C 256 / 768 / 1024 / 1280 / 5120) at the
    row counts the per-call route runs."""
    for c in (256, 768, 1024, 1280, 5120):
        for rows in (256, 512, 1024):
            qkv, wo = tfb.attn_block_plans(rows, c)
            assert (qkv.bn, wo.bn) == (tfh.HEAD_GEMM_BN, tfh.HEAD_GEMM_BN)
