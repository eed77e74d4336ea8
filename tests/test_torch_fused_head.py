"""Port sampler (stack + em_precompute + plain fused_em_sample, the CPU
branch of the kernel wrapper) vs the JAX fused_em_sample in its three TPU
variants (interpret mode), its final_chunk contract, and em_sample_stacked.
Weights cross over through bitdance_tpu_torch.io.from_jax. On bf16 stacks
(kernel #2's route, round_residual=False): each product with its bias in
fp32 as the JAX kernel's _dot (preferred_element_type f32), and the plain
sampler against the streamed kernel #2 in interpret mode."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bitdance_tpu.models.diff_head import DiffNet as JDiffNet
from bitdance_tpu.ops import fused_head as jfh
from bitdance_tpu_torch.io.from_jax import flax_state_from_jax, load_into
from bitdance_tpu_torch.models.diff_head import DiffHead as TDiffHead
from bitdance_tpu_torch.models.diff_head import DiffNet as TDiffNet
from bitdance_tpu_torch.models.sampling import euler_maruyama
from bitdance_tpu_torch.ops import fused_head as tfh

torch.set_num_threads(2)
TOL = dict(rtol=2e-4, atol=2e-4)
C, CH, COND, BLOCKS, ADA, STEPS, CFG = 256, 8, 64, 4, 2, 4, 2.0


def _nets(seed=0):
    net = JDiffNet(in_channels=CH, model_channels=C, z_channels=COND,
                   num_res_blocks=BLOCKS, num_ada_ln_blocks=ADA,
                   attention=True, use_swiglu=True, attn_head_dim=128)
    params = net.init(jax.random.PRNGKey(seed), jnp.zeros((2, 8, CH)),
                      jnp.zeros((2,)), jnp.zeros((2, 8, COND)))["params"]
    leaves, treedef = jax.tree_util.tree_flatten(params)
    rng = np.random.default_rng(seed + 1)   # zero adaLN would be vacuous
    params = jax.tree_util.tree_unflatten(
        treedef, [jnp.asarray(0.05 * rng.normal(size=l.shape), jnp.float32)
                  for l in leaves])
    tnet = TDiffNet(CH, C, COND, BLOCKS, ADA)
    load_into(tnet, flax_state_from_jax(params))
    return net, params, tnet


@pytest.fixture(scope="module")
def setup():
    net, params, tnet = _nets()
    rng = np.random.default_rng(9)
    cond = rng.normal(size=(4, 8, COND)).astype(np.float32)   # 4 groups of 8
    x0 = rng.normal(size=(16, CH)).astype(np.float32)
    noise = rng.normal(size=(STEPS, 16, CH)).astype(np.float32)
    t_all = np.linspace(0.0, 0.95, STEPS + 1).astype(np.float32)
    dt_all = np.concatenate([t_all[1:] - t_all[:-1], [0.0]]).astype(np.float32)
    c_flat = cond.reshape(-1, COND)
    j_stacked = jfh.stack_diffnet_params(params, BLOCKS, True, dtype=jnp.float32)
    j_cemb = jnp.asarray(c_flat) @ params["cond_embed"]["kernel"] \
        + params["cond_embed"]["bias"]
    j_mods = jfh.em_precompute(j_stacked, j_cemb, jnp.asarray(t_all),
                               out_dtype=jnp.float32)
    t_stacked = tfh.stack_diffnet_params(tnet, BLOCKS, dtype=torch.float32)
    t_cemb = torch.from_numpy(c_flat) @ t_stacked["cond_w"].t() + t_stacked["cond_b"]
    t_mods = tfh.em_precompute(t_stacked, t_cemb, torch.from_numpy(t_all),
                               out_dtype=torch.float32)
    return dict(net=net, params=params, cond=cond, x0=x0, noise=noise,
                t_all=t_all, dt_all=dt_all, j_stacked=j_stacked, j_mods=j_mods,
                j_cemb=j_cemb, t_stacked=t_stacked, t_mods=t_mods, t_cemb=t_cemb)


KW = dict(num_blocks=BLOCKS, num_ada=ADA, n_head=C // 128, groups=4)
# the T2I head's family; test_torch_imagenet_sample.py holds the MlpEncoder
# and the unbounded TransEncoder
KW = dict(KW, attention=True, bounded=True)
JKW = KW


def _port(s, x0, noise, mods, t_all, dt_all, **kw):
    return tfh.fused_em_sample(
        s["t_stacked"], torch.from_numpy(np.asarray(x0)),
        torch.from_numpy(np.asarray(noise)), mods, torch.from_numpy(t_all),
        torch.from_numpy(dt_all), CFG, **KW, **kw).numpy()


def test_stack_and_precompute_match(setup):
    s = setup
    for k, jv in s["j_stacked"].items():
        if k in ("ada_w", "ada_b", "f_ada_w", "f_ada_b"):
            continue
        tv = s["t_stacked"][k].numpy()
        jv = np.asarray(jv)
        if k in ("b1", "b2", "bqkv", "bo"):
            jv = jv[:, 0]
        elif jv.ndim == 3 and k not in ("n1", "n2"):
            jv = jv.transpose(0, 2, 1)               # [L, in, out] -> [L, out, in]
        elif k in ("in_w", "t_w0", "t_w2", "f_out_w", "cond_w", "modcat_w"):
            jv = jv.T
        np.testing.assert_array_equal(tv, jv, err_msg=k)
    np.testing.assert_allclose(s["t_cemb"].numpy(), np.asarray(s["j_cemb"]), **TOL)
    np.testing.assert_allclose(s["t_mods"].numpy(), np.asarray(s["j_mods"]), **TOL)


@pytest.mark.parametrize("variant", ["resident", "per_block", "dma"])
def test_plain_sampler_matches_jax_kernel(setup, variant):
    s = setup
    want = np.asarray(jfh.fused_em_sample(
        s["j_stacked"], jnp.asarray(s["x0"]), jnp.asarray(s["noise"]),
        s["j_mods"], jnp.asarray(s["t_all"]), jnp.asarray(s["dt_all"]),
        jnp.float32(CFG), interpret=True, resident=variant == "resident",
        streamed="dma" if variant == "dma" else False, **JKW))
    before = tfh.fused_em_sample.launches
    got = _port(s, s["x0"], s["noise"], s["t_mods"], s["t_all"], s["dt_all"])
    assert tfh.fused_em_sample.launches == before      # CPU: plain version
    np.testing.assert_allclose(got, want, **TOL)


def test_final_chunk_chaining(setup):
    """final_chunk=False runs num_steps EM updates and no final step; chained
    chunks equal one whole call (and the JAX whole call)."""
    s = setup
    whole = _port(s, s["x0"], s["noise"], s["t_mods"], s["t_all"], s["dt_all"])
    x = s["x0"]
    s0 = 0
    for c in (2, 1, 1):
        last = s0 + c >= STEPS
        n_rows = c + 1 if last else c
        sl = slice(s0, s0 + n_rows)
        mods = tfh.em_precompute(s["t_stacked"], s["t_cemb"],
                                 torch.from_numpy(s["t_all"][sl]),
                                 out_dtype=torch.float32)
        x = _port(s, x, s["noise"][s0:s0 + c], mods, s["t_all"][sl],
                  s["dt_all"][sl], final_chunk=last)
        s0 += c
    np.testing.assert_allclose(x, whole, **TOL)
    # a partial chunk returns the post-EM state of the JAX kernel as well
    jpart = np.asarray(jfh.fused_em_sample(
        s["j_stacked"], jnp.asarray(s["x0"]), jnp.asarray(s["noise"][:2]),
        s["j_mods"][:2], jnp.asarray(s["t_all"][:2]),
        jnp.asarray(s["dt_all"][:2]), jnp.float32(CFG), interpret=True,
        resident=True, final_chunk=False, **JKW))
    tpart = _port(s, s["x0"], s["noise"][:2], s["t_mods"][:2],
                  s["t_all"][:2], s["dt_all"][:2], final_chunk=False)
    np.testing.assert_allclose(tpart, jpart, **TOL)


def test_em_sample_stacked_matches_jax(setup):
    s = setup
    want = np.asarray(jfh.em_sample_stacked(
        s["j_stacked"], jnp.asarray(s["x0"]), jnp.asarray(s["noise"]), None,
        jnp.asarray(s["t_all"]), jnp.asarray(s["dt_all"]), jnp.float32(CFG),
        c_emb=s["j_cemb"], **JKW))
    got = tfh.em_sample_stacked(
        s["t_stacked"], torch.from_numpy(s["x0"]), torch.from_numpy(s["noise"]),
        None, torch.from_numpy(s["t_all"]), torch.from_numpy(s["dt_all"]), CFG,
        c_emb=s["t_cemb"], **KW).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_euler_maruyama_second_oracle(setup):
    """The port's plain euler_maruyama driving the flax net (the per-call
    forward) equals the stacked sampler on the same x0 and noise."""
    s = setup

    def net_fn(x, t, c):
        out = s["net"].apply({"params": s["params"]}, jnp.asarray(x.numpy()),
                             jnp.asarray(t.numpy()), jnp.asarray(c.numpy()))
        return torch.from_numpy(np.asarray(out))

    cond = torch.from_numpy(s["cond"])
    x0 = torch.from_numpy(s["x0"]).reshape(2, 8, CH)
    noise = torch.from_numpy(s["noise"]).reshape(STEPS, 2, 8, CH)
    want = euler_maruyama(net_fn, cond, None, CH, cfg=CFG, cfg_mult=2,
                          num_sampling_steps=STEPS, x_init=x0, noise=noise)
    got = _port(s, s["x0"], s["noise"], s["t_mods"], s["t_all"], s["dt_all"])
    np.testing.assert_allclose(got, want.reshape(16, CH).numpy(), **TOL)


def test_stack_for_sampler_keeps_one_copy():
    """After stacking, the head's block and adaLN weights are views into the
    stacked tensors (one copy on the device) and keep their values."""
    torch.manual_seed(0)
    head = TDiffHead(CH, COND, C, BLOCKS, ADA, parallel_num=8)
    before = {k: v.clone() for k, v in head.state_dict().items()}
    st = head._stack_for_sampler()
    after = head.state_dict()
    for k, v in before.items():
        torch.testing.assert_close(after[k], v, rtol=0, atol=0, msg=k)

    def base(t):
        return t.untyped_storage().data_ptr()

    net = head.net
    for i, blk in enumerate(net.res_blocks):
        for t, key in ((blk.attn.wqkv.weight, "wqkv"), (blk.attn.wo.bias, "bo"),
                       (blk.w1.weight, "w1"), (blk.w2.weight, "w2"),
                       (blk.norm1.weight, "n1"), (blk.norm2.bias, "n2")):
            assert base(t) == base(st[key]), (i, key)
    for lin in [*net.ada_ln_blocks, net.final_layer.ada_ln_modulation]:
        assert base(lin.weight) == base(st["modcat_w"])


# kernel #2's precision on bf16 operands: each product sums the exact
# products of the bf16 operands in fp32 and adds the bias to that sum, as the
# JAX kernel's _dot does; the two sums differ in order only (a few fp32 ulps).
# A product rounded to bf16 before the bias is off by up to 2^-9 of it.
PRODUCT_REL = 1e-5


def _bf16(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("which", ["block_product", "out_projection"])
def test_non_round_products_keep_fp32_sums(which):
    """The block products (the head GEMM twin's gated_f32 mode with gate 1
    and a zero residual returns y = a @ w.T + bias as _net_forward's
    products compute it) and the output projection of _net_forward's
    non-round route (no block; an exact h, so the modulated z has the same
    bits on both sides) against the JAX _dot plus the bias."""
    rng = np.random.default_rng(3)
    bf = torch.bfloat16
    if which == "block_product":
        a, w = _bf16(rng, 32, 512), _bf16(rng, 256, 512, scale=512 ** -0.5)
        bias = _bf16(rng, 256, scale=0.1)
        ta, tw, tb = (torch.from_numpy(v).to(bf) for v in (a, w, bias))
        got = tfh.head_gemm_split_plain(ta, tw, "gated_f32", tb, gate=torch.ones(32, 256, dtype=bf),
                                        resid=torch.zeros(32, 256)).numpy()
        want = np.asarray(jfh._dot(jnp.asarray(ta.float().numpy(), jnp.bfloat16),
                                   jnp.asarray(tw.float().numpy().T, jnp.bfloat16))
                          + jnp.asarray(tb.float().numpy()))
    else:
        c, ch, half = 256, 8, 16
        st = tfh.stack_diffnet_params(TDiffNet(ch, c, COND, 1, 1), 1, dtype=bf)
        # x and in_w small multiples of 1/8: h is exact in fp32 and in bf16
        st["in_w"] = torch.from_numpy(rng.integers(-4, 5, (c, ch)) / 8.0).to(bf)
        st["in_b"] = torch.zeros(c)
        st["f_out_w"] = torch.from_numpy(_bf16(rng, ch, c, scale=c ** -0.5)).to(bf)
        st["f_out_b"] = torch.from_numpy(_bf16(rng, ch, scale=0.1))
        x = torch.from_numpy(rng.integers(-4, 5, (half, ch)) / 8.0).float()
        mods = torch.from_numpy(_bf16(rng, 2 * half, 8 * c, scale=0.3)).to(bf)
        got = tfh._net_forward(st, x, mods, num_blocks=0, switch_freq=1, n_head=2, groups=1,
                               bounded=False).numpy()
        h = torch.cat([x, x]) @ st["in_w"].float().t()
        fm = mods[:, -2 * c:].float()
        z = tfh._ln(h) * (1.0 + fm[:, :c]) + fm[:, c:]
        want = np.asarray(jfh._dot(jnp.asarray(z.numpy()),
                                   jnp.asarray(st["f_out_w"].float().numpy().T, jnp.bfloat16))
                          + jnp.asarray(st["f_out_b"].numpy()))
    assert got.dtype == np.float32 and got.shape == want.shape
    assert _rel(got, want) < PRODUCT_REL, _rel(got, want)


# ROADMAP C8: em_precompute's products keep their fp32 sums before the fp32
# bias, as the JAX em_precompute's _dot does. On a bf16 stack with fp32 mods
# out on both sides they differ by fp32 summation order (3.1e-6 of max
# |mods| measured); products rounded to bf16 before the bias miss by ~2^-9
# (3.8e-3).
PRECOMPUTE_BF16_REL = 1e-5


def test_bf16_mods_precompute_keeps_fp32_sums(setup):
    s = setup
    jst = jfh.stack_diffnet_params(s["params"], BLOCKS, True, dtype=jnp.bfloat16)
    want = np.asarray(jfh.em_precompute(jst, s["j_cemb"], jnp.asarray(s["t_all"]),
                                        out_dtype=jnp.float32))
    _, _, tnet = _nets()
    tst = tfh.stack_diffnet_params(tnet, BLOCKS, dtype=torch.bfloat16)
    got = tfh.em_precompute(tst, torch.from_numpy(np.array(s["j_cemb"])),
                            torch.from_numpy(s["t_all"]), out_dtype=torch.float32).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    assert _rel(got, want) < PRECOMPUTE_BF16_REL, _rel(got, want)


# the plain sampler on a bf16 stack with kernel #2's precision against the
# streamed kernel #2 (interpret mode) on the same bf16 mods, max and mean
# |difference| / max |x|. Over 4 steps the gap is rounding chaos: the port
# against itself with float64-exact product sums moves 5.8e-3 (8e-5 after one
# step); against JAX it read 5.4e-3 on one host and 8.3e-3 on an AMD EPYC
# host, where products rounded to bf16 before their bias (the fault this test
# is for) read 7.6e-3: there the 4-step gap cannot tell them apart. After
# one step (two net calls) the mean gap can: 4.9e-5 to 5.1e-5 over float64
# sums, 1 / 2 / 4 splits and 1 / 2 / 4 threads, 1.16e-4 to 1.18e-4 with the
# fault, on that host. Bounds: one step, mean 8e-5 and max 5e-4 (2.3e-4
# measured); 4 steps, max 1.5e-2 and mean 4e-3, a check on drift.
SAMPLER_BF16_REL = {1: (5e-4, 8e-5), STEPS: (1.5e-2, 4e-3)}


def test_plain_bf16_sampler_matches_jax_kernel_2(setup):
    s = setup
    jst = jfh.stack_diffnet_params(s["params"], BLOCKS, True, dtype=jnp.bfloat16)
    jmods = jfh.em_precompute(jst, s["j_cemb"], jnp.asarray(s["t_all"]),
                              out_dtype=jnp.bfloat16)
    _, _, tnet = _nets()
    tst = tfh.stack_diffnet_params(tnet, BLOCKS, dtype=torch.bfloat16)
    tmods = torch.tensor(np.asarray(jmods.astype(jnp.float32))).bfloat16()
    assert tfh.rounds_residual(tst, BLOCKS, True)    # the router's pick; #2 forced below
    for steps, (top, mean) in SAMPLER_BF16_REL.items():
        t_all, dt_all = s["t_all"][:steps + 1], s["dt_all"][:steps + 1]
        noise = s["noise"][:steps]
        want = np.asarray(jfh.fused_em_sample(
            jst, jnp.asarray(s["x0"]), jnp.asarray(noise), jmods, jnp.asarray(t_all),
            jnp.asarray(dt_all), jnp.float32(CFG), interpret=True, resident=False,
            streamed="dma", **JKW))
        got = tfh.fused_em_sample_reference(
            tst, torch.from_numpy(s["x0"]), torch.from_numpy(noise), tmods, t_all,
            dt_all, CFG, round_residual=False, **KW).numpy()
        assert np.isfinite(got).all() and got.shape == want.shape
        gap = float(np.abs(got - want).mean() / np.abs(want).max())
        assert _rel(got, want) < top and gap < mean, (steps, _rel(got, want), gap)
