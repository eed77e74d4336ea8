"""The head GEMM of the whole sampler's bf16 routes (kernel #2, the 14B
head, and kernels #3/#4, ``csrc/head_gemm.cuh``) on the CPU: its plan, its
plain split twin, the plain sampler run through that twin against the JAX
kernels #3 and #2 in interpret mode, and the whole-sampler bound of
chip_smoke.py, which counts the block stack once per net call less what the
L2 holds.

- ``head_gemm_plan`` at the H-1x (64 rows), B-16x (1024 rows) and 14B
  (128 and 256 rows) products and over a grid of shapes and SM counts: the splits cover K once, in
  ranges of whole 64-k stages; the count is a power of two up to 8 (one
  cluster); every split walks two stages or more; the tiles times the
  splits fill one wave of the SMs and no more, and twice the splits would
  break one of those rules.
- ``head_gemm_split_plain`` (fp32 partials over the planned K ranges,
  summed in split order, then the route's epilogue) against the same
  product in one pass, for each mode; equal bits over repeated runs; kernel
  #2's epilogues against the JAX kernel #2's math.
- The plain sampler with every product split as the card's plan splits it
  (C 256: every product 2 ways) against ``fused_em_sample(...,
  interpret=True)``, both families, bf16, 4 steps; every gaussian draw is
  the shape-keyed table of tests/test_reference_parity.py.
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bitdance_tpu.models.diff_head import DiffNet as JDiffNet
from bitdance_tpu.ops import fused_head as jfh
from bitdance_tpu_torch.io.from_jax import flax_state_from_jax, load_into
from bitdance_tpu_torch.models import diff_head as tdh
from bitdance_tpu_torch.ops import fused_head as tfh

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _shaped_noise(shape):
    """tests/test_reference_parity.py's shape-keyed table: the same shape
    gives the same values on both sides."""
    seed = 5
    for d in shape:
        seed = (seed * 131 + int(d) + 7) % (2**31 - 1)
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


# the sampler's products: (rows, N, K) -> the plan at 132 SMs
PLANNED = {"h1x_w1": ((64, 3840, 1280), (64, 128, 4)),
           "h1x_w2": ((64, 1280, 1920), (64, 128, 8)),
           "b16x_qkv": ((1024, 2304, 768), (128, 128, 1)),
           "b16x_wo": ((1024, 768, 768), (128, 128, 2)),
           "b16x_w1": ((1024, 2304, 768), (128, 128, 1)),
           "b16x_w2": ((1024, 768, 1152), (128, 128, 2)),
           "t2i_qkv_128": ((128, 15360, 5120), (128, 128, 1)),
           "t2i_wo_128": ((128, 5120, 5120), (128, 128, 2)),
           "t2i_w1_128": ((128, 15360, 5120), (128, 128, 1)),
           "t2i_w2_128": ((128, 5120, 7680), (128, 128, 2)),
           "t2i_qkv_256": ((256, 15360, 5120), (128, 128, 1)),
           "t2i_wo_256": ((256, 5120, 5120), (128, 128, 1)),
           "t2i_w1_256": ((256, 15360, 5120), (128, 128, 1)),
           "t2i_w2_256": ((256, 5120, 7680), (128, 128, 1))}


@pytest.mark.parametrize("name", list(PLANNED))
def test_plan_at_the_sampler_shapes(name):
    shape, want = PLANNED[name]
    assert tuple(tfh.head_gemm_plan(*shape)) == want


def test_round_route_plan_names_every_product():
    h1x = tfh.sampler_plans(64, 1280, 1920, attention=False)
    b16x = tfh.sampler_plans(1024, 768, 1152, attention=True)
    assert set(h1x) == {"w1", "w2"} and set(b16x) == {"wqkv", "wo", "w1", "w2"}
    assert h1x["w2"] == tfh.head_gemm_plan(64, 1280, 1920)
    assert b16x["wo"] == tfh.head_gemm_plan(1024, 768, 768)


def _plan_holds(rows, n, k, sms):
    p = tfh.head_gemm_plan(rows, n, k, sms)
    bk = tfh.HEAD_GEMM_BK
    steps = k // bk
    tiles = -(-rows // p.bm) * (n // p.bn)
    ranges = tfh.head_gemm_split_ranges(k, p.splits)
    assert len(ranges) == p.splits and ranges[0][0] == 0 and ranges[-1][1] == k
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    assert all(k1 > k0 and k0 % bk == 0 and k1 % bk == 0 for k0, k1 in ranges)
    if steps >= 2:
        assert min(k1 - k0 for k0, k1 in ranges) >= 2 * bk
    assert p.splits & (p.splits - 1) == 0 and p.splits <= tfh.HEAD_GEMM_MAX_SPLITS
    if tiles <= sms:
        assert tiles * p.splits <= sms
        s = 2 * p.splits         # twice the splits breaks the wave, the stages or the cluster
        assert tiles * s > sms or steps // s < 2 or s > tfh.HEAD_GEMM_MAX_SPLITS
    else:
        assert p.splits == 1
    assert p.bm == (64 if rows <= 64 else 128)


@pytest.mark.parametrize("sms", [132, 114, 16])
@pytest.mark.parametrize("rows", [1, 24, 64, 65, 200, 1024])
def test_plan_rules(rows, sms):
    for n in (128, 768, 1280, 3840):
        for k in (64, 128, 384, 768, 1920):
            _plan_holds(rows, n, k, sms)


def test_plan_refuses_shapes_the_kernel_cannot_take():
    with pytest.raises(ValueError):
        tfh.head_gemm_plan(64, 1280 + 64, 1920)       # N % 128
    with pytest.raises(ValueError):
        tfh.head_gemm_plan(64, 1280, 1920 + 32)       # K % 64


def _product(rows, n, k, mode, seed=0):
    rng = np.random.default_rng(seed)
    bf = torch.bfloat16
    a = torch.from_numpy(rng.standard_normal((rows, k)).astype(np.float32)).to(bf)
    w = torch.from_numpy((rng.standard_normal((n, k)) / k ** 0.5).astype(np.float32)).to(bf)
    bias = torch.from_numpy(0.1 * rng.standard_normal(n).astype(np.float32)).to(bf)
    kw = {}
    if mode == "gated":
        kw["resid"] = torch.from_numpy(rng.standard_normal((rows, n)).astype(np.float32)
                                       ).to(bf).float()
        kw["gate"] = torch.from_numpy(0.5 * rng.standard_normal((rows, n)).astype(np.float32)
                                      ).to(bf)
    return a, w, bias, kw


# split vs one pass, max |difference| / max |one pass|: the fp32 sums differ
# in order only, so an output moves where it sits at a bf16 rounding
# boundary: one bf16 ulp, at most 2^-7 of the largest output (the swiglu's
# product of two rounded halves up to twice that). Measured 8.7e-4 / 3.2e-4
# / 1.5e-4 on these inputs.
SPLIT_BOUND = {"bias": 8e-3, "gated": 8e-3, "swiglu": 1.6e-2}
SPLIT_CASES = {"bias": (64, 768, 1152, 8), "gated": (64, 1280, 1920, 8),
               "swiglu": (24, 768, 1280, 4)}


@pytest.mark.parametrize("mode", list(SPLIT_CASES))
def test_split_twin_matches_one_pass(mode):
    rows, n, k, splits = SPLIT_CASES[mode]
    a, w, bias, kw = _product(rows, n, k, mode)
    one = tfh.head_gemm_split_plain(a, w, mode, bias, splits=1, **kw).float()
    got = tfh.head_gemm_split_plain(a, w, mode, bias, splits=splits, **kw)
    again = tfh.head_gemm_split_plain(a, w, mode, bias, splits=splits, **kw)
    assert torch.equal(got, again)
    assert got.shape == one.shape == (rows, n // 2 if mode == "swiglu" else n)
    rel = ((got.float() - one).abs().max() / one.abs().max()).item()
    assert rel < SPLIT_BOUND[mode], rel
    # the split sums are not the one-pass sums: the twin does split
    y_one = tfh._dot_acc_split(a, w, 1)
    y_split = tfh._dot_acc_split(a, w, splits)
    assert not torch.equal(y_one, y_split)
    assert ((y_one - y_split).abs().max() / y_one.abs().max()).item() < 1e-5


def test_head_gemm_on_the_cpu_is_the_planned_twin():
    a, w, bias, kw = _product(64, 1280, 1920, "gated", seed=1)
    before = tfh.head_gemm.launches
    want = tfh.head_gemm_split_plain(a, w, "gated", bias, splits=8, **kw)
    resid = kw["resid"]
    got = tfh.head_gemm(a, w, "gated", bias, **kw)      # the residual in place
    assert got is resid and torch.equal(got, want) and tfh.head_gemm.launches == before
    with pytest.raises(ValueError, match="mode"):
        tfh.head_gemm(a, w, "relu", bias)


@pytest.fixture(scope="module", params=["mlp", "trans"])
def split_sampler(request):
    """The JAX kernel #3 (interpret mode) and the port's plain sampler on the
    same bf16 weights (C 256, H 384, 4 blocks, 32 rows), x0 and noise from
    the shape-keyed table."""
    attention = request.param == "trans"
    c, ch, cond_dim, blocks, ada = 256, 8, 64, 4, 2
    net = JDiffNet(in_channels=ch, model_channels=c, z_channels=cond_dim,
                   num_res_blocks=blocks, num_ada_ln_blocks=ada, attention=attention,
                   use_swiglu=True, bounded_output=False, attn_head_dim=64)
    lead = (2, 8) if attention else (16,)
    params = net.init(jax.random.PRNGKey(5), jnp.zeros(lead + (ch,)),
                      jnp.zeros(lead[:1]), jnp.zeros(lead + (cond_dim,)))["params"]
    rng = np.random.default_rng(6)
    params = jax.tree_util.tree_map(
        lambda l: jnp.asarray(0.05 * rng.standard_normal(l.shape), jnp.float32), params)
    tnet = load_into(tdh.DiffNet(ch, c, cond_dim, blocks, ada, attention=attention,
                                 bounded_output=False, attn_head_dim=64),
                     flax_state_from_jax(params))
    rows, groups = 32, (4 if attention else 1)
    cond = _shaped_noise((rows, cond_dim))
    x0 = _shaped_noise((rows // 2, ch))
    noise = _shaped_noise((4, rows // 2, ch))
    t_all = np.linspace(0.0, 0.95, 5).astype(np.float32)
    dt_all = np.concatenate([t_all[1:] - t_all[:-1], [0.0]]).astype(np.float32)
    kw = dict(num_blocks=blocks, num_ada=ada, n_head=4, groups=groups,
              attention=attention, bounded=False)
    jst = jfh.stack_diffnet_params(params, blocks, attention, dtype=jnp.bfloat16)
    cemb = jnp.asarray(cond) @ params["cond_embed"]["kernel"] + params["cond_embed"]["bias"]
    mods = jfh.em_precompute(jst, cemb, jnp.asarray(t_all), out_dtype=jnp.bfloat16)
    want = np.asarray(jfh.fused_em_sample(
        jst, jnp.asarray(x0), jnp.asarray(noise), mods, jnp.asarray(t_all),
        jnp.asarray(dt_all), jnp.float32(3.0), interpret=True, resident=False,
        streamed=False, **kw))
    tst = tfh.stack_diffnet_params(tnet, blocks, dtype=torch.bfloat16)
    tmods = torch.tensor(np.asarray(mods.astype(jnp.float32))).bfloat16()
    plans = tfh.sampler_plans(rows, c, c * 3 // 2, attention)

    def port(splits):
        return tfh.fused_em_sample_reference(
            tst, torch.from_numpy(x0), torch.from_numpy(noise), tmods, t_all, dt_all, 3.0,
            splits=splits, **kw).numpy()

    return dict(attention=attention, want=want, port=port, plans=plans, stack=tst)


def _mean_gap(got, want):
    return float(np.abs(got - want).mean() / np.abs(want).max())


def test_split_sampler_matches_jax_kernel_3(split_sampler):
    """Mean |port - JAX| relative to max |JAX x|, bf16, 4 steps at cfg 3.
    The one-pass port measured 2.3e-4 (mlp) and 3.7e-3 (trans: XLA on the
    CPU keeps the attention's scaled q and some sums in fp32 where the
    kernel's bf16 ops round), the split port 1.9e-4 and 3.7e-3: the split
    sums move a few bf16 roundings, no more than the one-pass port's own
    distance. Bounds a few times those."""
    s = split_sampler
    assert tfh.rounds_residual(s["stack"], 4, s["attention"])
    splits = {k: p.splits for k, p in s["plans"].items()}
    assert splits["w1"] == 2 and splits["w2"] == 2
    assert splits.get("wqkv", 2) == 2 and splits.get("wo", 2) == 2
    split = s["port"](splits)
    assert np.array_equal(split, s["port"](splits))
    assert np.isfinite(split).all() and split.shape == s["want"].shape
    gap = _mean_gap(split, s["want"])
    assert gap < (1e-2 if s["attention"] else 1e-3), gap


def _stack(c, h, blocks, attention):
    z = lambda *s: torch.zeros(s, dtype=torch.bfloat16)   # noqa: E731
    st = {"w1": z(blocks, 2 * h, c), "b1": z(blocks, 2 * h), "w2": z(blocks, c, h),
          "b2": z(blocks, c), "n2": z(blocks, 2, c), "in_w": z(c, 16),
          "in_b": torch.zeros(c), "f_out_w": z(16, c), "f_out_b": torch.zeros(16)}
    if attention:
        st.update(wqkv=z(blocks, 3 * c, c), bqkv=z(blocks, 3 * c), wo=z(blocks, c, c),
                  bo=z(blocks, c), n1=z(blocks, 2, c))
    return st


@pytest.mark.parametrize("attention", [False, True], ids=["mlp", "trans"])
def test_sampler_bound_streams_the_stack_per_net_call(attention):
    """chip_smoke.sampler_bound: the inputs once (the first net call reads
    the stack cold), then max(0, stack - L2) bytes of the block stack in
    every later net call; the operations as before."""
    cs = _chip_smoke()
    c, h, blocks, half, calls = 128, 192, 4, 16, 11
    st = _stack(c, h, blocks, attention)
    x0, noise = torch.zeros(half, 16), torch.zeros(calls - 1, half, 16)
    mods = torch.zeros(calls, 2 * half, 8 * c, dtype=torch.bfloat16)
    keys = ["w1", "b1", "w2", "b2", "n2"] + (["wqkv", "bqkv", "wo", "bo", "n1"]
                                             if attention else [])
    stack = cs.nbytes(*[st[k] for k in keys])
    once = stack + cs.nbytes(st["in_w"], st["in_b"], st["f_out_w"], st["f_out_b"], mods,
                             x0, noise, x0)
    kw = dict(attention=attention, groups=2, window=16)
    for l2, streamed in ((0, stack), (stack // 3, stack - stack // 3), (stack, 0),
                         (10 * stack, 0)):
        got = cs.sampler_bound(st, x0, noise, mods, l2_bytes=l2, **kw)
        byte_ms = (once + (calls - 1) * streamed) / cs.H100_HBM_BYTES_PER_S * 1e3
        assert set(got) == {"bound_ms", "bound_by"}
        assert got["bound_ms"] >= byte_ms * (1 - 1e-12)
        if got["bound_by"] == "bytes":
            assert got["bound_ms"] == pytest.approx(byte_ms, rel=1e-12)
    # H-1x at 101 net calls: the 177 MB stack less a 50 MB L2, ~3.8 ms
    h1x = {k: v for k, v in _stack(1280, 1920, 12, False).items()}
    mods = torch.zeros(101, 64, 5 * 1280, dtype=torch.bfloat16)
    got = cs.sampler_bound(h1x, torch.zeros(32, 16), torch.zeros(100, 32, 16), mods,
                           attention=False, l2_bytes=50 * 2**20)
    assert got["bound_by"] == "bytes" and 3.7 < got["bound_ms"] < 3.9


def _jax_epilogue(a, w, bias, mode, kw):
    """Kernel #2's products and epilogues as the JAX kernel computes them
    (bitdance_tpu/ops/fused_head.py: _dot with fp32 accumulation, the bias
    in fp32; h + y * gate; h12 stored in bf16, silu(h1) * h2 in fp32, then
    the stage's bf16)."""
    j = lambda t: jnp.asarray(t.float().numpy())          # noqa: E731
    y = jfh._dot(j(a).astype(jnp.bfloat16), j(w).T.astype(jnp.bfloat16)) + j(bias)
    if mode == "gated_f32":
        return np.asarray(j(kw["resid"]) + y * j(kw["gate"]))
    hidden = w.shape[0] // 2
    h12 = y.astype(jnp.bfloat16).astype(jnp.float32)
    return np.asarray((jax.nn.silu(h12[:, :hidden]) * h12[:, hidden:]).astype(jnp.bfloat16)
                      .astype(jnp.float32))


# kernel #2's epilogues, twin vs the JAX math on the same bf16 operands: the
# fp32 sums differ in order only (gated_f32: a few fp32 ulps of the largest
# output); the swiglu_f32 output is bf16, where such a difference flips an
# output at a rounding boundary by one bf16 ulp (2^-7 of the largest output
# at most). Measured 1.9e-7 and 1.1e-4 on these inputs (8 splits).
F32_EPILOGUE_BOUND = {"gated_f32": 1e-6, "swiglu_f32": 8e-3}
F32_CASES = {"gated_f32": (32, 1280, 1920), "swiglu_f32": (32, 1536, 1280)}


@pytest.mark.parametrize("mode", list(F32_CASES))
def test_f32_epilogue_twins_match_jax_kernel_2(mode):
    rows, n, k = F32_CASES[mode]
    a, w, bias, kw = _product(rows, n, k, "gated" if mode == "gated_f32" else mode, seed=4)
    plan = tfh.head_gemm_plan(rows, n, k)
    got = tfh.head_gemm_split_plain(a, w, mode, bias, splits=plan.splits, **kw)
    want = _jax_epilogue(a, w, bias, mode, kw)
    assert got.shape == want.shape == (rows, n // 2 if mode == "swiglu_f32" else n)
    assert got.dtype == (torch.float32 if mode == "gated_f32" else torch.bfloat16)
    rel = float(np.abs(got.float().numpy() - want).max() / np.abs(want).max())
    assert rel < F32_EPILOGUE_BOUND[mode], rel


@pytest.mark.parametrize("mode", ["gated_f32", "swiglu_f32"])
def test_head_gemm_on_the_cpu_is_the_planned_twin_for_kernel_2(mode):
    a, w, bias, kw = _product(128, 1280, 1920, "gated" if mode == "gated_f32" else mode,
                              seed=2)
    plan = tfh.head_gemm_plan(128, 1280, 1920)
    assert plan.splits > 1
    before = tfh.head_gemm.launches
    want = tfh.head_gemm_split_plain(a, w, mode, bias, splits=plan.splits, **kw)
    got = tfh.head_gemm(a, w, mode, bias, **kw)
    assert torch.equal(got, want) and tfh.head_gemm.launches == before
    if mode == "gated_f32":
        assert got is kw["resid"]                          # the residual in place


@pytest.fixture(scope="module")
def split_sampler_2():
    """The JAX kernel #2 (the streamed sampler, interpret mode) and the
    port's plain sampler with kernel #2's precision (round_residual=False)
    on the same bf16 TransEncoder (C 256, H 384, 4 blocks, 32 rows), x0 and
    noise from the shape-keyed table."""
    c, ch, cond_dim, blocks, ada = 256, 8, 64, 4, 2
    net = JDiffNet(in_channels=ch, model_channels=c, z_channels=cond_dim,
                   num_res_blocks=blocks, num_ada_ln_blocks=ada, attention=True,
                   use_swiglu=True, bounded_output=True, attn_head_dim=64)
    params = net.init(jax.random.PRNGKey(7), jnp.zeros((2, 8, ch)), jnp.zeros((2,)),
                      jnp.zeros((2, 8, cond_dim)))["params"]
    rng = np.random.default_rng(8)
    params = jax.tree_util.tree_map(
        lambda l: jnp.asarray(0.05 * rng.standard_normal(l.shape), jnp.float32), params)
    tnet = load_into(tdh.DiffNet(ch, c, cond_dim, blocks, ada, attn_head_dim=64),
                     flax_state_from_jax(params))
    rows = 32
    cond = _shaped_noise((rows, cond_dim))
    x0 = _shaped_noise((rows // 2, ch))
    noise = _shaped_noise((4, rows // 2, ch))
    t_all = np.linspace(0.0, 0.95, 5).astype(np.float32)
    dt_all = np.concatenate([t_all[1:] - t_all[:-1], [0.0]]).astype(np.float32)
    kw = dict(num_blocks=blocks, num_ada=ada, n_head=4, groups=4, attention=True, bounded=True)
    jst = jfh.stack_diffnet_params(params, blocks, True, dtype=jnp.bfloat16)
    cemb = jnp.asarray(cond) @ params["cond_embed"]["kernel"] + params["cond_embed"]["bias"]
    mods = jfh.em_precompute(jst, cemb, jnp.asarray(t_all), out_dtype=jnp.bfloat16)
    want = np.asarray(jfh.fused_em_sample(
        jst, jnp.asarray(x0), jnp.asarray(noise), mods, jnp.asarray(t_all),
        jnp.asarray(dt_all), jnp.float32(3.0), interpret=True, resident=False,
        streamed="dma", **kw))
    tst = tfh.stack_diffnet_params(tnet, blocks, dtype=torch.bfloat16)
    tmods = torch.tensor(np.asarray(mods.astype(jnp.float32))).bfloat16()
    plans = tfh.sampler_plans(rows, c, c * 3 // 2, True)

    def port(splits):
        return tfh.fused_em_sample_reference(
            tst, torch.from_numpy(x0), torch.from_numpy(noise), tmods, t_all, dt_all, 3.0,
            round_residual=False, splits=splits, **kw).numpy()

    return dict(want=want, port=port, plans=plans)


def test_split_sampler_matches_jax_kernel_2(split_sampler_2, monkeypatch):
    """Kernel #2's plain sampler with every product split as the card's plan
    splits it (2 ways at C 256) against the same sampler un-split and against
    the JAX kernel #2, bf16, 4 steps at cfg 3, max and mean |difference|
    relative to max |x|. Measured: split vs un-split 7.1e-3 / 1.5e-3, split
    vs JAX 1.0e-2 / 2.1e-3, un-split vs JAX 8.1e-3 / 1.6e-3: the split sums
    move a few bf16 roundings of the stage activations, about as far as the
    port's own distance to JAX. Bounds about 2x those.

    That the twin splits is read from its fp32 partials, not from the
    sample's bits: a CPU BLAS that blocks K at 128 (MKL on an AMD EPYC host)
    sums a one-pass product at K 256 in the split's order, and split and
    un-split samples then have equal bits."""
    s = split_sampler_2
    splits = {k: p.splits for k, p in s["plans"].items()}
    assert splits == {"wqkv": 2, "wo": 2, "w1": 2, "w2": 2}
    split, one = s["port"](splits), s["port"](None)
    assert np.array_equal(split, s["port"](splits))
    assert np.isfinite(split).all() and split.shape == s["want"].shape
    rel = lambda a, b: float(np.abs(a - b).max() / np.abs(b).max())   # noqa: E731
    for got, want, top, mean in ((split, one, 1.5e-2, 4e-3), (split, s["want"], 2e-2, 5e-3),
                                 (one, s["want"], 2e-2, 5e-3)):
        assert rel(got, want) < top and _mean_gap(got, want) < mean, \
            (rel(got, want), _mean_gap(got, want))
    # every fp32 partial the sampler sums: a net call is the input projection
    # (K 8), per block qkv, wo and w1 (K 256) and w2 (K 384), the output
    # projection (K 256); 5 net calls
    widths, dot = [], tfh._dot_acc
    monkeypatch.setattr(tfh, "_dot_acc", lambda a, w: widths.append(w.shape[1]) or dot(a, w))

    def partials(n):
        blk = [k // n for k in (256, 256, 256, 384) for _ in range(n)]
        return 5 * ([8] + 4 * blk + [256])

    assert np.array_equal(s["port"](splits), split) and widths == partials(2)
    widths.clear()
    assert np.array_equal(s["port"](None), one) and widths == partials(1)
