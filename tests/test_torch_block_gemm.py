"""The head GEMM's modes for the per-call head blocks on the CPU: the MLP
block #14 (``fused_mlp_block``: "swiglu_h32", h1 and h2 kept in fp32, and
"gated_bf16", bf16(x + y * gate) into a new output) and the whole net #5
(``fused_diffnet_forward``: "out_f32", the fp32 sums of its t-MLP and
modulation products).

- The split twin (``head_gemm_split_plain``) of each mode at 1 / 2 / 4 / 8
  splits against the same product in one pass, and the CPU branch of
  ``head_gemm`` equal to the twin at the plan's splits.
- The MLP block composed of the LN + modulate and the two products on the
  split twin, and ``fused_mlp_block_reference`` at the card's plans, against
  the JAX ``fused_mlp_block(..., interpret=True)`` (the TPU kernel #14) at C
  256 with a stride-0 gate, bf16.
- The plans of #14 and #5 at the ImageNet heads' row counts (8 / 64 / 512),
  and the refusal of a shape the head GEMM cannot take.
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


def _product(rows, n, k, mode, seed=0):
    rng = np.random.default_rng(seed)
    a, w = _bf(rng, rows, k), _bf(rng, n, k, scale=k ** -0.5)
    bias = None if mode == "out_f32" else _bf(rng, n, scale=0.1)
    kw = {}
    if mode == "gated_bf16":
        kw["x"] = _bf(rng, rows, n)
        kw["gate"] = _bf(rng, 1, n, scale=0.5).expand(rows, n)      # row stride 0
    return a, w, bias, kw


# split vs one pass, max |difference| / max |one pass|: the fp32 sums differ
# in order only. "out_f32" keeps them: a few fp32 ulps of sums over K 1280
# (bound 1e-5); the bf16 outputs move where they sit at a bf16 rounding
# boundary, one bf16 ulp, at most 2^-7 of the largest output.
BLOCK_SPLIT_BOUND = {"swiglu_h32": 8e-3, "gated_bf16": 8e-3, "out_f32": 1e-5}
BLOCK_SPLIT_CASES = {"swiglu_h32": (8, 768, 1280), "gated_bf16": (24, 256, 1920),
                     "out_f32": (8, 1280, 1280)}


@pytest.mark.parametrize("splits", [1, 2, 4, 8])
@pytest.mark.parametrize("mode", list(BLOCK_SPLIT_CASES))
def test_block_modes_split_twin_matches_one_pass(mode, splits, monkeypatch):
    rows, n, k = BLOCK_SPLIT_CASES[mode]
    a, w, bias, kw = _product(rows, n, k, mode)
    one = tfh.head_gemm_split_plain(a, w, mode, bias, splits=1, **kw).float()
    widths, dot = [], tfh._dot_acc
    monkeypatch.setattr(tfh, "_dot_acc", lambda a, w: widths.append(w.shape[1]) or dot(a, w))
    got = tfh.head_gemm_split_plain(a, w, mode, bias, splits=splits, **kw)
    # fp32 partials over the split ranges of whole 64-k stages
    assert widths == [k1 - k0 for k0, k1 in tfh.head_gemm_split_ranges(k, splits)]
    assert torch.equal(got, tfh.head_gemm_split_plain(a, w, mode, bias, splits=splits, **kw))
    cols = n // 2 if mode == "swiglu_h32" else n
    assert got.shape == one.shape == (rows, cols)
    assert got.dtype == (torch.float32 if mode == "out_f32" else BF)
    rel = ((got.float() - one).abs().max() / one.abs().max()).item()
    assert rel < BLOCK_SPLIT_BOUND[mode], rel


def test_block_modes_epilogues():
    """Each mode's epilogue on the fp32 sums y = a @ w.T (+ bias): the
    SwiGLU of fp32 halves rounded once, the gated bf16 residual, the sums
    alone."""
    rng = np.random.default_rng(1)
    a, w, b = _bf(rng, 16, 256), _bf(rng, 512, 256, scale=1 / 16), _bf(rng, 512, scale=0.1)
    y = a.float() @ w.float().t() + b.float()
    got = tfh.head_gemm_split_plain(a, w, "swiglu_h32", b)
    want = (torch.nn.functional.silu(y[:, :256]) * y[:, 256:]).to(BF)
    assert torch.equal(got, want)
    x, gate = _bf(rng, 16, 512), _bf(rng, 16, 512, scale=0.5)
    got = tfh.head_gemm_split_plain(a, w, "gated_bf16", b, gate=gate, x=x)
    assert torch.equal(got, (x.float() + y * gate.float()).to(BF))
    got = tfh.head_gemm_split_plain(a, w, "out_f32", None)
    assert torch.equal(got, a.float() @ w.float().t())


@pytest.mark.parametrize("mode", list(BLOCK_SPLIT_CASES))
def test_head_gemm_on_the_cpu_is_the_planned_twin(mode):
    rows, n, k = BLOCK_SPLIT_CASES[mode]
    a, w, bias, kw = _product(rows, n, k, mode, seed=2)
    plan = tfh.head_gemm_plan(rows, n, k)
    assert plan.splits > 1
    before = tfh.head_gemm.launches
    want = tfh.head_gemm_split_plain(a, w, mode, bias, splits=plan.splits, **kw)
    assert torch.equal(tfh.head_gemm(a, w, mode, bias, **kw), want)
    assert tfh.head_gemm.launches == before


C, H = 256, 384


def _jax_block(x, scale, shift, gate, ln_w, ln_b, w1, b1, w2, b2):
    """The JAX kernel #14 in interpret mode on bf16 operands (its weights in
    the JAX layout [in, out])."""
    j = lambda t: jnp.asarray(t.float().numpy(), jnp.bfloat16)   # noqa: E731
    out = jfb.fused_mlp_block(j(x), j(scale), j(shift), j(gate), j(ln_w), j(ln_b),
                              j(w1.t()), j(b1), j(w2.t()), j(b2), interpret=True)
    return torch.from_numpy(np.array(out.astype(jnp.float32)))


def _block_args(rows, seed):
    """bf16 block inputs at C 256, H 384; the gate one row at stride 0."""
    rng = np.random.default_rng(seed)
    x = _bf(rng, rows, C)
    scale, shift = _bf(rng, rows, C, scale=0.1), _bf(rng, rows, C, scale=0.1)
    gate = _bf(rng, 1, C, scale=0.5).expand(rows, C)
    ln_w = (1 + 0.1 * _bf(rng, C).float()).to(BF)
    return (x, scale, shift, gate, ln_w, _bf(rng, C, scale=0.1),
            _bf(rng, 2 * H, C, scale=C ** -0.5), _bf(rng, 2 * H, scale=0.1),
            _bf(rng, C, H, scale=H ** -0.5), _bf(rng, C, scale=0.1))


# the port's MLP block against the JAX kernel #14 in bf16, max |difference| /
# max |JAX out| and mean |difference| / mean |JAX out|: both take LN
# statistics, h12, silu(h1) * h2 and y in fp32 and round h, glu and the
# output to bf16; the fp32 orders differ, so a few outputs move by a bf16 ulp
# where they sit at a rounding boundary: measured at most 1.5e-3 / 2.3e-6
# over 8-512 rows and 1-4 splits. A product rounded to bf16 before its bias
# reads 3.4e-3-5.8e-3 / 8.4e-4-9.3e-4, h1 and h2 rounded to bf16 before the
# SwiGLU (kernel #2's epilogue) 3.4e-3-5.8e-3 / 6.8e-4-8.6e-4: the mean
# bound sits between; the max bound (two bf16 ulps of the largest output)
# holds the rest.
BLOCK_JAX_REL = 8e-3
BLOCK_JAX_MEAN = 5e-5


def _gaps(got, want):
    d = (got.float() - want).abs()
    return (d.max() / want.abs().max()).item(), (d.mean() / want.abs().mean()).item()


@pytest.mark.parametrize("splits", [1, 2, 4])
def test_split_twin_modes_make_the_jax_mlp_block(splits):
    """LN + modulate, then w1 on "swiglu_h32" (K 256: 4 stages of 64 k)
    and w2 on "gated_bf16" (K 384: 6 stages) of the split twin, against the
    JAX kernel #14; the same as fused_mlp_block_reference at those splits."""
    args = _block_args(40, seed=3)
    x, scale, shift, gate, ln_w, ln_b, w1, b1, w2, b2 = args
    h = tfb._ln_modulate(x, scale, shift, ln_w, ln_b, 1e-6).to(BF)
    glu = tfh.head_gemm_split_plain(h, w1, "swiglu_h32", b1, splits=splits)
    got = tfh.head_gemm_split_plain(glu, w2, "gated_bf16", b2, gate=gate, x=x, splits=splits)
    assert torch.equal(got, tfb.fused_mlp_block_reference(
        *args, splits={"w1": splits, "w2": splits}))
    top, mean = _gaps(got, _jax_block(*args))
    assert top < BLOCK_JAX_REL and mean < BLOCK_JAX_MEAN, (top, mean)


@pytest.mark.parametrize("rows", [8, 77, 512])
def test_mlp_block_reference_on_the_plans_matches_jax(rows):
    """fused_mlp_block_reference on the split twin at the card's plans (C
    256: w1 and w2 at 2 splits), the wrapper's CPU branch (one pass), and
    the JAX kernel #14."""
    args = _block_args(rows, seed=rows)
    p1, p2 = tfb.mlp_block_plans(rows, C, H)
    splits = {"w1": p1.splits, "w2": p2.splits}
    assert splits == {"w1": 2, "w2": 2}
    got = tfb.fused_mlp_block_reference(*args, splits=splits)
    want = _jax_block(*args)
    assert got.dtype == BF and got.shape == (rows, C)
    top, mean = _gaps(got, want)
    assert top < BLOCK_JAX_REL and mean < BLOCK_JAX_MEAN, (top, mean)
    before = tfb.fused_mlp_block.launches
    one = tfb.fused_mlp_block(*args)
    assert tfb.fused_mlp_block.launches == before
    assert torch.equal(one, tfb.fused_mlp_block_reference(*args))
    assert _gaps(one, want)[0] < BLOCK_JAX_REL


def test_bf16_rounded_products_fail_the_jax_block_bound(monkeypatch):
    """The mean bound catches the faults it is for: each product rounded to
    bf16 before its bias, and h1 and h2 rounded to bf16 before the SwiGLU."""
    args = _block_args(77, seed=77)
    want = _jax_block(*args)
    mm = tfb._mm
    with monkeypatch.context() as m:
        m.setattr(tfb, "_mm", lambda a, w, s=1: mm(a, w, s).to(BF).float())
        assert _gaps(tfb.fused_mlp_block_reference(*args), want)[1] > BLOCK_JAX_MEAN
    x, scale, shift, gate, ln_w, ln_b, w1, b1, w2, b2 = args
    h12 = (mm(tfb._ln_modulate(x, scale, shift, ln_w, ln_b, 1e-6), w1) + b1.float()).to(BF)
    glu = torch.nn.functional.silu(h12[:, :H].float()) * h12[:, H:].float()
    out = (x.float() + (mm(glu, w2) + b2.float()) * gate.float()).to(BF)
    assert _gaps(out, want)[1] > BLOCK_JAX_MEAN


# (rows, C, H) -> the plans of #14's w1 and w2: H-1x unguided (8 rows) and
# guided (64), B-16x (32 windows of 16)
MLP_PLANS = {"h1x_8": ((8, 1280, 1920), ((64, 128, 4), (64, 128, 8))),
             "h1x_64": ((64, 1280, 1920), ((64, 128, 4), (64, 128, 8))),
             "b16x_512": ((512, 768, 1152), ((128, 128, 1), (128, 128, 4)))}
# #5's plans of its t-MLP, adaLN-group and final-modulation products
NET_PLANS = {"h1x_8": ((8, 1280, 1920, False), {"t_w0": (64, 128, 2), "t_w2": (64, 128, 8),
                                                "mods": (64, 128, 4), "final": (64, 128, 4)}),
             "h1x_64": ((64, 1280, 1920, False), {"t_w0": (64, 128, 2),
                                                  "t_w2": (64, 128, 8),
                                                  "mods": (64, 128, 4),
                                                  "final": (64, 128, 4)}),
             "b16x_512": ((512, 768, 1152, True), {"t_w0": (128, 128, 2),
                                                   "t_w2": (128, 128, 4),
                                                   "mods": (128, 128, 1),
                                                   "final": (128, 128, 2)})}


@pytest.mark.parametrize("name", list(MLP_PLANS))
def test_block_and_net_plans(name):
    shape, want = MLP_PLANS[name]
    assert tuple(map(tuple, tfb.mlp_block_plans(*shape))) == want
    nshape, nwant = NET_PLANS[name]
    plans = tfh.net_plans(*nshape)
    attention = nshape[3]
    assert set(plans) == set(tfh.NET_PRODUCTS) - (set() if attention else {"wqkv", "wo"})
    assert {k: tuple(plans[k]) for k in nwant} == nwant
    # the block products on the whole sampler's rule; #14's w1 / w2 alike
    rows, c, h = shape
    assert plans["w1"] == tfh.head_gemm_plan(rows, 2 * h, c)
    assert (plans["w1"], plans["w2"]) == tfb.mlp_block_plans(rows, c, h)


@pytest.mark.parametrize("c,h", [(192, 288), (256, 352), (320, 480)])
def test_plans_refuse_shapes_the_head_gemm_cannot_take(c, h):
    """C % 128 or H % 64 not 0: the card's wrappers raise (no other GEMM to
    fall back on)."""
    with pytest.raises(ValueError, match="head GEMM"):
        tfb.mlp_block_plans(8, c, h)
    with pytest.raises(ValueError, match="head GEMM"):
        tfh.net_plans(8, c, h, attention=False)


def test_every_head_width_takes_the_head_gemm():
    """The ImageNet heads (C 256 / 768 / 1024 / 1280) and the T2I head (C
    5120), H = 1.5 C, at the row counts their routes run."""
    for c in (256, 768, 1024, 1280, 5120):
        for rows in (8, 64, 512):
            tfb.mlp_block_plans(rows, c, c * 3 // 2)
            tfh.net_plans(rows, c, c * 3 // 2, attention=c != 1280)
