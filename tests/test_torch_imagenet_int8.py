"""Quantized ImageNet sampling of the port against the JAX package on the CPU
(ROADMAP A8): the W8A8 backbone (``quantize_ar_params``), the int8 KV cache
(``_init_cache(int8=True)``, ``_quant_rows``, ``_forward_cached``), the
W8A8 / W4A8 head on the whole sampler's round route (R3), and ``sample``
with all of them to an exact ±1 grid.

R3: the JAX router sends a quantized ImageNet head to the resident kernel
#4 (B-16x in int8 and int4, H-1x in int4: under 48 MB) or to #3 (H-1x in
int8, 88.9 MB), never to #2; both run ``_block_body``, which rounds the
residual and every elementwise stage to the weights' dtype and quantizes
each product's rounded input (``_mmq``). The port's router used to keep
kernel #2's fp32 residual for every quantized stack.

The JAX kernels run in interpret mode under ``jax.jit``, where XLA may keep
fused bf16 chains in fp32 (``xla_allow_excess_precision``, on by default):
the resident and per-block kernels then differ from each other by as much
as the fp32 residual does. They are compiled here with it off, and then
both equal each other exactly; the port's plain ``_block_body`` equals the
JAX ``_block_body`` run op by op bit for bit.

Noise for ``sample``: the shape-keyed tables of
tests/test_reference_parity.py:341-366 on both sides, with its sign-margin
guard (every sign input clears 1e-3) before any exact comparison.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bitdance_tpu.models import imagenet_ar as jia
from bitdance_tpu.models.diff_head import DiffHead as JDiffHead
from bitdance_tpu.models.diff_head import DiffNet as JDiffNet
from bitdance_tpu.ops import fused_head as jfh
from bitdance_tpu.ops.int8 import QTensor as JQTensor
from bitdance_tpu_torch.io.from_jax import (
    flax_state_from_jax,
    imagenet_ar_state_from_jax,
    imagenet_sampler_from_jax,
    load_into,
)
from bitdance_tpu_torch.models import diff_head as tdh
from bitdance_tpu_torch.models import imagenet_ar as tia
from bitdance_tpu_torch.models.qwen3 import QLinear
from bitdance_tpu_torch.ops import fused_head as tfh
from bitdance_tpu_torch.ops.int4 import unpack_int4
from bitdance_tpu_torch.ops.int8 import dequantize, quantize_rows

torch.set_num_threads(2)
CFG = 3.0
# R3, mean |port - JAX| / max |JAX| after one sampler step (two net calls)
# of a quantized bf16 stack: the round route measured 2e-7 to 2.3e-4 (a few
# int8 steps flip where XLA's fused fp32 sums differ from torch's), the
# fp32 residual 4.0e-3 to 5.8e-3; the bound is 4x the first
ROUND_STEP_GAP = 1e-3
FP32_STEP_GAP = 3e-3
# over 4 steps the int8 flips compound (0.4e-3 to 4.4e-3 measured): a drift
# bound only
ROUND_DRIFT_GAP = 1.5e-2
# one cached forward, port vs JAX, both quantized (fp32 activations; the
# int8 products' inputs can land on the other side of a rounding step where
# the two sides' fp32 sums differ): relative to max |x|
FORWARD_REL = 1e-4
# JAX's own bound of a quantized forward against the full-precision one
# (tests/test_int8.py:109-130)
QUANT_FORWARD_REL = 0.05
NOISE_SEED = 49
SIGN_MARGIN = 1e-3


def _randomized(tree, seed, scale=0.1):
    leaves, treedef = jax.tree_util.tree_flatten(tree)
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_unflatten(treedef, [
        jnp.asarray(scale * rng.standard_normal(l.shape), jnp.float32) for l in leaves])


def _no_excess(fn, *args):
    """fn(*args) under jax.jit with xla_allow_excess_precision off, so each
    bf16 op rounds as it does op by op."""
    return np.asarray(jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})(*args))


# ---------------------------------------------------------------------------
# the whole sampler on a quantized bf16 stack (R3)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=[("mlp", True), ("mlp", "int4"),
                                        ("trans", True), ("trans", "int4")],
                ids=["mlp_int8", "mlp_int4", "trans_int8", "trans_int4"])
def quant_stacks(request):
    """A flax DiffNet (C 128, 4 blocks, 2 adaLN groups, head dim 64) with
    every leaf drawn, its quantized bf16 stacks on both sides, and the
    sampler's inputs at 32 rows."""
    family, quant = request.param
    attention = family == "trans"
    net = JDiffNet(in_channels=8, model_channels=128, z_channels=64, num_res_blocks=4,
                   num_ada_ln_blocks=2, attention=attention, use_swiglu=True,
                   bounded_output=False, attn_head_dim=64)
    lead = (2, 8) if attention else (16,)
    params = net.init(jax.random.PRNGKey(5), jnp.zeros(lead + (8,)), jnp.zeros(lead[:1]),
                      jnp.zeros(lead + (64,)))["params"]
    rng = np.random.default_rng(6)
    params = jax.tree_util.tree_map(
        lambda l: jnp.asarray(0.05 * rng.standard_normal(l.shape), jnp.float32), params)
    tnet = load_into(tdh.DiffNet(8, 128, 64, 4, 2, attention=attention, bounded_output=False,
                                 attn_head_dim=64), flax_state_from_jax(params))
    jst = jfh.stack_diffnet_params(params, 4, attention, dtype=jnp.bfloat16, quant=quant)
    tst = tfh.stack_diffnet_params(tnet, 4, dtype=torch.bfloat16, quant=quant)
    rng = np.random.default_rng(9)
    cond = rng.standard_normal((32, 64)).astype(np.float32)
    cemb = jnp.asarray(cond) @ params["cond_embed"]["kernel"] + params["cond_embed"]["bias"]
    kw = dict(num_blocks=4, num_ada=2, n_head=2, groups=4 if attention else 1,
              attention=attention, bounded=False)

    def inputs(steps):
        x0 = rng.standard_normal((16, 8)).astype(np.float32)
        noise = rng.standard_normal((steps, 16, 8)).astype(np.float32)
        t_all = np.linspace(0.0, 0.95, steps + 1).astype(np.float32)
        dt_all = np.concatenate([t_all[1:] - t_all[:-1], [0.0]]).astype(np.float32)
        mods = jfh.em_precompute(jst, cemb, jnp.asarray(t_all), out_dtype=jnp.bfloat16)
        return x0, noise, mods, t_all, dt_all

    return dict(attention=attention, quant=quant, jst=jst, tst=tst, kw=kw, inputs=inputs,
                params=params, tnet=tnet)


def _gap(got, want):
    return float(np.abs(got - want).mean() / np.abs(want).max())


def _both_samplers(s, steps, resident):
    x0, noise, mods, t_all, dt_all = s["inputs"](steps)
    want = _no_excess(
        lambda x0, noise, mods, t, dt: jfh.fused_em_sample(
            s["jst"], x0, noise, mods, t, dt, jnp.float32(CFG), interpret=True,
            resident=resident, streamed=False, **s["kw"]),
        jnp.asarray(x0), jnp.asarray(noise), mods, jnp.asarray(t_all), jnp.asarray(dt_all))
    tmods = torch.tensor(np.asarray(mods.astype(jnp.float32))).bfloat16()
    args = (s["tst"], torch.from_numpy(x0), torch.from_numpy(noise), tmods,
            torch.from_numpy(t_all), torch.from_numpy(dt_all), CFG)
    before = tfh.fused_em_sample.launches
    got = tfh.fused_em_sample(*args, quant=s["quant"], **s["kw"]).numpy()
    assert tfh.fused_em_sample.launches == before            # CPU: the plain version
    fp32 = tfh.fused_em_sample_reference(*args, quant=s["quant"], round_residual=False,
                                         **s["kw"]).numpy()
    return got, fp32, want


@pytest.mark.parametrize("resident", [True, False], ids=["resident", "per_block"])
def test_quantized_stack_takes_the_round_route(quant_stacks, resident):
    """R3: a quantized ImageNet-sized stack rounds (the JAX router's bytes),
    and the port's sampler (its plain version on the CPU) gives JAX kernel
    #4 (resident) and #3 (per block) in their quant mode within
    ROUND_STEP_GAP after one step, where kernel #2's fp32 residual lies
    beyond FP32_STEP_GAP; over 4 steps within a drift bound."""
    s = quant_stacks
    assert tfh.rounds_residual(s["tst"], 4, s["attention"])
    got, fp32, want = _both_samplers(s, 1, resident)
    assert _gap(got, want) < ROUND_STEP_GAP, _gap(got, want)
    assert _gap(fp32, want) > FP32_STEP_GAP, _gap(fp32, want)
    got, _, want = _both_samplers(s, 4, resident)
    assert np.isfinite(got).all() and _gap(got, want) < ROUND_DRIFT_GAP, _gap(got, want)


def test_quantized_block_equals_jax_block_op_by_op(quant_stacks):
    """One block of _block_body on the quantized bf16 stack (h, mods drawn):
    the port's plain block and the JAX function run op by op, bit for bit."""
    s = quant_stacks
    jst, attention, l = s["jst"], s["attention"], 1
    rng = np.random.default_rng(1)
    h = rng.standard_normal((32, 128)).astype(np.float32)
    mods = jnp.asarray(0.3 * rng.standard_normal((32, (6 if attention else 3) * 128)),
                       jnp.bfloat16)
    attn_w = ((jst["n1"][l], jst["wqkv"][l], jst["bqkv"][l, 0], jst["wo"][l], jst["bo"][l, 0],
               jst["wqkv_s"][l], jst["wo_s"][l]) if attention else None)
    want = np.asarray(jfh._block_body(
        jnp.asarray(h), mods, attn_w, jst["n2"][l], jst["w1"][l], jst["b1"][l, 0],
        jst["w2"][l], jst["b2"][l, 0], n_head=2, groups=s["kw"]["groups"], eps=1e-6,
        w1_s=jst["w1_s"][l], w2_s=jst["w2_s"][l], elem=jnp.bfloat16).astype(jnp.float32))
    got = tfh._block_body(torch.from_numpy(h),
                          torch.tensor(np.asarray(mods.astype(jnp.float32))).bfloat16(),
                          s["tst"], l, attention=attention, n_head=2,
                          groups=s["kw"]["groups"], quant=tfh.quant_mode(s["quant"]))
    np.testing.assert_array_equal(got.float().numpy(), want)


def _deq_bound(a, w, sa, sw):
    """|a w^T - deq(a) deq(w)^T| per output, a [R, K] and w [N, K] the
    dequantized operands' sources, sa [R] and sw [N] the quantization steps:
    sum_k |a| sw / 2 + |w| sa / 2 + sa sw / 4, with 1e-5 relative room for
    the fp32 sums."""
    a, w = a.abs().double(), w.abs().double()
    sa, sw = sa.double()[:, None], sw.double()[None, :]
    k = a.shape[1]
    b = a @ torch.ones(k, 1, dtype=torch.float64) * sw / 2 \
        + sa / 2 * (w @ torch.ones(k, 1, dtype=torch.float64)).t() + k * sa * sw / 4
    return b + 1e-5 * (a @ w.t())


def test_quantized_products_against_dequantized_math(quant_stacks):
    """C1: each quantized block product of the stack (the plain integer
    route, every split count of the head GEMM) against eager fp32 math on
    the float weights, within the quantization's error bound, and equal to
    the product of the dequantized operands to fp32 rounding."""
    s = quant_stacks
    mode = tfh.quant_mode(s["quant"])
    rng = np.random.default_rng(3)
    blk = s["tnet"].res_blocks[2]
    mats = {"w1": blk.w1.weight, "w2": blk.w2.weight}
    if s["attention"]:
        mats.update(wqkv=blk.attn.wqkv.weight, wo=blk.attn.wo.weight)
    for key, wf in mats.items():
        a = torch.from_numpy(rng.standard_normal((24, wf.shape[1])).astype(np.float32))
        aq, sa = quantize_rows(a)
        wq, ws = s["tst"][key][2], s["tst"][key + "_s"][2]
        w_int = torch.cat(unpack_int4(wq), dim=1) if mode == "int4" else wq
        deq = (aq.float() * sa[:, None]) @ (w_int.float() * ws[:, None]).t()
        for splits in (1, 2, 4):
            got = tfh._int_product(aq, sa, wq, ws, splits, mode)
            np.testing.assert_allclose(got.numpy(), deq.numpy(), rtol=1e-5, atol=1e-5)
        err = (got.double() - a.double() @ wf.double().t()).abs()
        assert (err <= _deq_bound(a, wf.detach(), sa, ws)).all(), key


# ---------------------------------------------------------------------------
# the backbone: W8A8 products and the int8 KV cache
# ---------------------------------------------------------------------------

def _backbone_pair(parallel_num=1, resolution=64):
    jcfg = jia.config_s(parallel_num=parallel_num, resolution=resolution)
    tcfg = tia.config_s(parallel_num=parallel_num, resolution=resolution)
    params = _randomized(jia.init_ar_params(jax.random.PRNGKey(0), jcfg), 1, 0.05)
    qparams = jia.quantize_ar_params(params)
    model = load_into(tia.ImageNetAR(tcfg), imagenet_ar_state_from_jax(params))
    return jcfg, tcfg, params, qparams, model


def test_quantize_ar_params_matches_jax():
    """quantize_ar_params swaps the four layer products of every layer for
    int8 QLinear modules holding JAX's quantized weights bit for bit (the
    bridge carries a quantized JAX tree the same way); norms, embeddings,
    proj_in, pos_for_diff stay float."""
    jcfg, tcfg, params, qparams, model = _backbone_pair(parallel_num=4)
    tia.quantize_ar_params(model)
    bridged = tia.quantized_ar_structure_(tia.ImageNetAR(tcfg))
    load_into(bridged, imagenet_ar_state_from_jax(qparams))
    names = {"wqkv": ("attention", "wqkv"), "wo": ("attention", "wo"),
             "ffn_w1": ("feed_forward", "w1"), "ffn_w2": ("feed_forward", "w2")}
    for m in (model, bridged):
        for key, (part, name) in names.items():
            leaf = qparams["layers"][key]
            assert isinstance(leaf, JQTensor)
            for i, layer in enumerate(m.layers):
                lin = getattr(getattr(layer, part), name)
                assert isinstance(lin, QLinear)
                np.testing.assert_array_equal(lin.q.numpy(), np.asarray(leaf.q[i]).T)
                np.testing.assert_array_equal(lin.s.numpy(), np.asarray(leaf.s[i, 0]))
        assert m.proj_in.w1.weight.dtype == torch.float32
        assert m.query_token.dtype == torch.float32


def test_quantized_sampler_shares_the_source_weights():
    """io/random_init.py::quantize_imagenet_sampler: W8A8 layer products
    quantized from the sampler's own weights and a quantized head stack,
    the source sampler left as it was, its float parts shared."""
    from bitdance_tpu_torch.io.random_init import quantize_imagenet_sampler

    _, tcfg, params, _, _ = _backbone_pair(parallel_num=4)
    head = jia.make_head(jia.config_s(parallel_num=4, resolution=64))
    hp = _randomized(head.init(jax.random.PRNGKey(1), jnp.zeros((2, 4, 16)),
                               jnp.zeros((2, 4, 256)), jax.random.PRNGKey(2)), 2)
    b = imagenet_sampler_from_jax(tcfg, params, hp, None)
    q = quantize_imagenet_sampler(b, backbone=True, head_quant="int4")
    for ql, bl in zip(q.model.layers, b.model.layers):
        assert isinstance(ql.attention.wqkv, QLinear) and isinstance(ql.feed_forward.w2, QLinear)
        assert isinstance(bl.attention.wqkv, torch.nn.Linear)
        want = QLinear(tcfg.dim, 3 * tcfg.dim)
        want.fill_(bl.attention.wqkv.weight.detach())
        assert torch.equal(ql.attention.wqkv.q, want.q) and torch.equal(ql.attention.wqkv.s, want.s)
        assert ql.attention_norm.weight is bl.attention_norm.weight
    assert q.model.cls_embedding.weight is b.model.cls_embedding.weight
    assert q.head.sample_weight_quant == "int4" and not b.head.sample_weight_quant
    assert q.head_stacked["w1"].shape[-1] == b.head_stacked["w1"].shape[-1] // 2
    assert b.head_stacked["w1"].dtype == torch.float32 and "w1_s" not in b.head_stacked


def test_quant_rows_and_int8_cache_match_jax():
    rng = np.random.default_rng(4)
    x = (rng.standard_normal((2, 5, 4, 64)) * rng.uniform(0.0, 3.0, (2, 5, 4, 1))
         ).astype(np.float32)
    x[0, 1, 2] = 0.0                                    # the 1e-8 scale floor
    jq, js = jia._quant_rows(jnp.asarray(x))
    tq, ts = tia._quant_rows(torch.from_numpy(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert float(ts[0, 1, 2]) == np.float32(1e-8) / np.float32(127.0)
    cfg = tia.config_s(parallel_num=4, resolution=64)
    jc = jia._init_cache(jia.config_s(parallel_num=4, resolution=64), 3, int8=True)
    tc = tia._init_cache(cfg, 3, int8=True)
    assert set(tc) == set(jc) == {"k", "v", "ks", "vs"}
    for k in jc:
        assert tuple(tc[k].shape) == jc[k].shape
        assert str(tc[k].dtype).split(".")[-1] == str(jc[k].dtype)
        assert not tc[k].any()


@pytest.mark.parametrize("int8_cache", [False, True], ids=["f32_cache", "int8_cache"])
def test_quantized_cached_forward_matches_jax(int8_cache):
    """A causal prefill then one decode window through _forward_cached with
    quantize_ar_params weights, against JAX's: the hidden states within
    FORWARD_REL of max |x|, the int8 cache equal but for rare one-step
    flips, its scales to 1e-5; and within JAX's own QUANT_FORWARD_REL of
    the port's full-precision forward."""
    jcfg, tcfg, params, qparams, model = _backbone_pair()
    fp32_model = load_into(tia.ImageNetAR(tcfg), imagenet_ar_state_from_jax(params))
    tia.quantize_ar_params(model)
    rng = np.random.default_rng(5)
    b = 3
    pre = (0.3 * rng.standard_normal((b, 6, tcfg.dim))).astype(np.float32)
    step = (0.3 * rng.standard_normal((b, 1, tcfg.dim))).astype(np.float32)
    freqs = np.asarray(jia.freqs_cis_table(jcfg))[:7]
    jcache = jia._init_cache(jcfg, b, int8=int8_cache)
    _, jcache = jia._forward_cached(qparams, jcfg, jnp.asarray(pre), jnp.asarray(freqs[:6]),
                                    jcache, jnp.int32(0), True)
    jx, jcache = jia._forward_cached(qparams, jcfg, jnp.asarray(step),
                                     jnp.asarray(freqs[6:7]), jcache, jnp.int32(6), False)
    tfreqs = torch.from_numpy(freqs.copy())
    outs = {}
    for name, m in (("quant", model), ("fp32", fp32_model)):
        cache = tia._init_cache(tcfg, b, int8=int8_cache and name == "quant")
        with torch.no_grad():
            tia._forward_cached(m, tcfg, torch.from_numpy(pre), tfreqs[:6], cache, 0, True)
            x, cache = tia._forward_cached(m, tcfg, torch.from_numpy(step), tfreqs[6:7],
                                           cache, 6, False)
        outs[name] = (x.numpy(), cache)
    tx, tcache = outs["quant"]
    jx = np.asarray(jx)
    assert np.abs(tx - jx).max() / np.abs(jx).max() < FORWARD_REL
    if int8_cache:
        for k in ("k", "v"):
            d = tcache[k].numpy().astype(np.int32) - np.asarray(jcache[k]).astype(np.int32)
            assert np.abs(d).max() <= 1 and (d != 0).mean() < 1e-3, k
        for k in ("ks", "vs"):
            np.testing.assert_allclose(tcache[k].numpy(), np.asarray(jcache[k]), rtol=1e-5,
                                       atol=0)
    ref = outs["fp32"][0]
    assert np.linalg.norm(tx - ref) / np.linalg.norm(ref) < QUANT_FORWARD_REL


def test_int8_cache_reads_back_within_a_step():
    """C1 for the cache: what _forward_cached reads back (k * ks) is within
    half a quantization step of the rotated k it stored, per (position,
    head)."""
    cfg = tia.config_s(parallel_num=1, resolution=64)
    rng = np.random.default_rng(6)
    k = torch.from_numpy(rng.standard_normal((2, 7, cfg.n_head, cfg.head_dim))
                         .astype(np.float32))
    q, s = tia._quant_rows(k)
    back = q.float() * s[..., None]
    assert ((back - k).abs() <= s[..., None] / 2 * (1 + 1e-6)).all()


def test_w8a8_linear_against_dequantized_math():
    """C1 for the backbone: a QLinear product equals the product with the
    dequantized weight and per-row dequantized activations to fp32 rounding,
    and the float product within the quantization's bound."""
    rng = np.random.default_rng(7)
    lin = torch.nn.Linear(256, 384, bias=False).requires_grad_(False)
    lin.weight.data = torch.from_numpy((0.05 * rng.standard_normal((384, 256)))
                                       .astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((9, 256)).astype(np.float32))
    ql = QLinear(256, 384)
    ql.fill_(lin.weight)
    got = tia._linear(x, ql)
    xq, sx = quantize_rows(x)
    deq = (xq.float() * sx[:, None]) @ dequantize(ql.weight_q, torch.float32).t()
    np.testing.assert_allclose(got.numpy(), deq.numpy(), rtol=1e-5, atol=1e-5)
    err = (got.double() - x.double() @ lin.weight.double().t()).abs()
    assert (err <= _deq_bound(x, lin.weight.detach(), sx, ql.s)).all()


# ---------------------------------------------------------------------------
# sample(kv_int8=True): exact ±1 grids
# ---------------------------------------------------------------------------

def _tiny_kw(parallel_num):
    return dict(dim=64, n_layer=2, n_head=4, diff_layers=2, diff_dim=128,
                diff_adanln_layers=1, latent_dim=8, down_size=16, patch_size=1,
                resolution=64, cls_token_num=4, num_classes=10,
                parallel_num=parallel_num)


def _shaped_noise(shape):
    seed = NOISE_SEED
    for d in shape:
        seed = (seed * 131 + int(d) + 7) % (2**31 - 1)
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _sample_both(monkeypatch, parallel_num, cfg_scale, head_quant):
    """JAX sample(kv_int8=True) and the port's on the same random tree, the
    backbone quantize_ar_params'd, the head quantized by head_quant:
    JAX's guided head routed to the whole sampler in interpret mode (its CPU
    dispatch would take euler_maruyama on the flax net, which ignores the
    quant), x0 and noise from the fused path's shape-keyed tables; unguided,
    both per call with x-shaped tables. Returns (port, JAX, sign margins)."""
    kw = _tiny_kw(parallel_num)
    jcfg, tcfg = jia.ImageNetARConfig(**kw), tia.ImageNetARConfig(**kw)
    ar = _randomized(jia.init_ar_params(jax.random.PRNGKey(0), jcfg), 1, 0.3)
    head = jia.make_head(jcfg, sample_weight_quant=head_quant)
    lead = (2, parallel_num) if parallel_num > 1 else (2,)
    hp = _randomized(head.init(jax.random.PRNGKey(1), jnp.zeros(lead + (8,)),
                               jnp.zeros(lead + (64,)), jax.random.PRNGKey(2)), 2, 0.3)
    jar = jia.quantize_ar_params(ar)
    b = imagenet_sampler_from_jax(tcfg, jar, hp, None, sample_weight_quant=head_quant)
    assert b.head.sample_weight_quant == head_quant
    if head_quant:
        assert b.head_stacked["w1"].dtype == torch.int8
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape=(), dtype=jnp.float32:
                        jnp.asarray(_shaped_noise(tuple(shape)), dtype))
    guided = cfg_scale > 1.0
    stacked = None
    if guided:
        monkeypatch.setattr(JDiffHead, "_can_fuse_sample",
                            lambda self, cond, cfg_mult: cfg_mult == 2)
        monkeypatch.setattr(jfh, "fused_em_sample",
                            functools.partial(jfh.fused_em_sample, interpret=True))
        stacked = head.apply(hp, method=JDiffHead._stack_for_sampler)
    cls = np.asarray([0, 3], np.int32)
    steps = 4
    want = np.asarray(jia.sample(jar, head, hp, jcfg, jnp.asarray(cls),
                                 jax.random.PRNGKey(5), num_sampling_steps=steps,
                                 cfg_scale=cfg_scale, kv_int8=True,
                                 head_stacked=stacked))
    x_shape = (2, 8) if parallel_num == 1 else (2, parallel_num, 8)

    def table_noise(generator, half, ch, num_steps, device):
        if guided:
            return (torch.from_numpy(_shaped_noise((half, ch))),
                    torch.from_numpy(_shaped_noise((num_steps, half, ch))))
        t = torch.from_numpy(_shaped_noise(x_shape)).reshape(half, ch)
        return t.clone(), t[None].repeat(num_steps, 1, 1)

    margins = []
    real_sign = tia._sign

    def spy_sign(x):
        margins.append(float(x.abs().min()))
        return real_sign(x)

    monkeypatch.setattr(tdh, "draw_sampler_noise", table_noise)
    monkeypatch.setattr(tia, "_sign", spy_sign)
    got = tia.sample(b.model, b.head, b.cfg, torch.from_numpy(cls).long(), torch.Generator(),
                     num_sampling_steps=steps, cfg_scale=cfg_scale,
                     head_sampler=tdh.make_fused_sampler(b.head, b.head_stacked),
                     kv_int8=True).numpy()
    assert len(margins) == 16 // parallel_num
    return got, want, min(margins)


@pytest.mark.parametrize("cfg_scale", [1.0, 3.0], ids=["unguided", "guided"])
@pytest.mark.parametrize("parallel_num", [1, 4])
def test_sample_kv_int8_quantized_backbone_exact(monkeypatch, parallel_num, cfg_scale):
    got, want, margin = _sample_both(monkeypatch, parallel_num, cfg_scale, False)
    assert margin > SIGN_MARGIN, f"borderline sign margin {margin}: pick another NOISE_SEED"
    assert got.shape == want.shape == (2, 16, 8)
    np.testing.assert_array_equal(got, want, err_msg="±1 token grids diverge")


@pytest.mark.parametrize("head_quant", [True, "int4"], ids=["int8_head", "int4_head"])
@pytest.mark.parametrize("cfg_scale", [1.0, 3.0], ids=["unguided", "guided"])
@pytest.mark.parametrize("parallel_num", [1, 4])
def test_sample_quantized_head_exact(monkeypatch, parallel_num, cfg_scale, head_quant):
    """The same with the head's sampler stack quantized (W8A8 / W4A8, the
    round route on both sides: JAX's kernel #4 in interpret mode)."""
    got, want, margin = _sample_both(monkeypatch, parallel_num, cfg_scale, head_quant)
    assert margin > SIGN_MARGIN, f"borderline sign margin {margin}: pick another NOISE_SEED"
    np.testing.assert_array_equal(got, want, err_msg="±1 token grids diverge")


def test_int8_cache_grid_stays_close_to_the_float_cache():
    """As tests/test_decode_attention.py:161-189 asks of JAX: sampling with
    the int8 KV cache agrees with the float cache on more than 0.9 of the
    tokens (the same weights, generator and draws)."""
    jcfg = jia.ImageNetARConfig(dim=128, n_layer=2, n_head=2, diff_layers=1, diff_dim=128,
                                diff_adanln_layers=1, latent_dim=8, resolution=32,
                                cls_token_num=4, parallel_num=4)
    tcfg = tia.ImageNetARConfig(**{f: getattr(jcfg, f) for f in (
        "dim", "n_layer", "n_head", "diff_layers", "diff_dim", "diff_adanln_layers",
        "latent_dim", "resolution", "cls_token_num", "parallel_num")})
    params = jia.init_ar_params(jax.random.PRNGKey(0), jcfg)
    head = jia.make_head(jcfg)
    hp = head.init(jax.random.PRNGKey(1), jnp.zeros((2, 4, jcfg.token_dim)),
                   jnp.zeros((2, 4, jcfg.dim)), jax.random.PRNGKey(2))
    hp = _randomized(hp, 3, 0.1)
    b = imagenet_sampler_from_jax(tcfg, params, hp, None)
    cls = torch.tensor([1, 2])
    grids = [tia.sample(b.model, b.head, b.cfg, cls, torch.Generator().manual_seed(3),
                        num_sampling_steps=4, cfg_scale=1.5, kv_int8=kv)
             for kv in (False, True)]
    assert grids[0].shape == grids[1].shape == (2, tcfg.num_tokens, tcfg.token_dim)
    agree = (grids[0] == grids[1]).float().mean().item()
    assert agree > 0.9, agree
