"""ImageNet class-conditional sampling of the port against the JAX package on
the CPU: the head-block kernels' plain versions against the Pallas kernels
in interpret mode (fused_mlp_block with row padding, fused_attn_block), the
per-call DiffNet forward of both head families (bounded and unbounded, plain
modules and kernel wrappers) against DiffNet.apply, the MlpEncoder and
unbounded TransEncoder variants of the whole sampler against the Pallas
sampler and em_sample_stacked, the JAX weight loaders by round trip, and
``sample`` for parallel_num 1 and 4, unguided and guided, to an exact ±1
grid.

Noise for ``sample``: every gaussian draw on both sides comes from a
shape-keyed table (tests/test_reference_parity.py's pattern). On the CPU the
JAX sample runs the head per call through euler_maruyama, whose x0 and
per-step noise have the shape of x ([n, ch] or [n, p, ch]), so both are the
same table; the port draws through diff_head.draw_sampler_noise (guided:
the whole sampler's plain version; unguided: per call), which gets that
table as [n * p, ch] for x0 and for every step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bitdance_tpu.io.torch_import import (
    convert_ae_state,
    convert_diffhead_state,
    convert_imagenet_ar_state,
)
from bitdance_tpu.models import imagenet_ar as jia
from bitdance_tpu.models.diff_head import DiffNet as JDiffNet
from bitdance_tpu.models.tokenizer import VQModel as JVQ
from bitdance_tpu.ops import fused_block as jfb
from bitdance_tpu.ops import fused_head as jfh
from bitdance_tpu_torch.io.from_jax import (
    flax_state_from_jax,
    imagenet_sampler_from_jax,
    load_into,
)
from bitdance_tpu_torch.models import diff_head as tdh
from bitdance_tpu_torch.models import imagenet_ar as tia
from bitdance_tpu_torch.ops import fused_block as tfb
from bitdance_tpu_torch.ops import fused_head as tfh

torch.set_num_threads(2)
# fp32 on both sides; only the order of the sums differs
TOL = dict(rtol=1e-5, atol=1e-5)
# whole samplers over 4 chained net calls, fp32
SAMPLER_TOL = dict(rtol=2e-4, atol=2e-4)
NOISE_SEED = 49
TINY_DD = dict(z_channels=8, in_channels=3, out_ch=3, ch=32, ch_mult=[1, 2],
               num_res_blocks=1)


def _np_args(seed, shapes, scales):
    """Seeded fp32 arrays: scale * N(0, 1), or 1 + 0.1 N(0, 1) for "one"."""
    rng = np.random.default_rng(seed)
    out = []
    for shape, s in zip(shapes, scales):
        base, s = (1.0, 0.1) if s == "one" else (0.0, s)
        out.append((base + s * rng.standard_normal(shape)).astype(np.float32))
    return out


def _block_args(seed, rows, c, hidden):
    """x, scale, shift, gate, ln_w, ln_b, w1 [C, 2H], b1, w2 [H, C], b2 in
    the JAX layout, numpy fp32."""
    return _np_args(seed, [(rows, c)] * 4 + [(c,), (c,), (c, 2 * hidden),
                                             (2 * hidden,), (hidden, c), (c,)],
                    [1.0, 0.1, 0.1, 0.1, "one", 0.1, 0.05, 0.05, 0.05, 0.05])


@pytest.mark.parametrize("rows,block_rows", [(5, 512), (13, 8), (100, 64)])
def test_fused_mlp_block_plain_matches_pallas(rows, block_rows):
    """Row counts that pad to 8 and to the row block."""
    c, hidden = 128, 192
    a = _block_args(rows, rows, c, hidden)
    want = np.asarray(jfb.fused_mlp_block(*map(jnp.asarray, a),
                                          block_rows=block_rows, interpret=True))
    t = [torch.from_numpy(v) for v in a]
    t[6], t[8] = t[6].t().contiguous(), t[8].t().contiguous()   # Linear layout
    before = tfb.fused_mlp_block.launches
    got = tfb.fused_mlp_block(*t).numpy()
    assert tfb.fused_mlp_block.launches == before          # CPU: plain version
    assert got.shape == (rows, c)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("g,w,c,n_head", [(3, 16, 128, 2), (2, 8, 256, 4)])
def test_fused_attn_block_plain_matches_pallas(g, w, c, n_head):
    """Head dim 64, the ImageNet Nx heads' (windows of 16 and 8 tokens)."""
    a = _np_args(g * w, [(g, w, c)] * 4 + [(c,), (c,), (c, 3 * c), (3 * c,),
                                           (c, c), (c,)],
                 [1.0, 0.1, 0.1, 0.1, "one", 0.1, 0.05, 0.05, 0.05, 0.05])
    want = np.asarray(jfb.fused_attn_block(*map(jnp.asarray, a), n_head=n_head,
                                           interpret=True))
    t = [torch.from_numpy(v) for v in a]
    t[6], t[8] = t[6].t().contiguous(), t[8].t().contiguous()
    before = tfb.fused_attn_block.launches
    got = tfb.fused_attn_block(*t, n_head=n_head).numpy()
    assert tfb.fused_attn_block.launches == before
    np.testing.assert_allclose(got, want, **TOL)


def test_mods_are_read_through_a_row_stride():
    """The kernels read each mod as [rows, C] with unit column stride and one
    row stride: a chunk of the adaLN output stays a view, a broadcast row
    keeps stride 0, and only a layout no stride can describe is copied."""
    ada = torch.randn(2, 16, 6 * 128)
    scale = ada.chunk(6, dim=-1)[3]
    m = tfb._mod_rows("scale", scale, (2, 16, 128), 32)
    assert m.data_ptr() == scale.data_ptr() and m.stride() == (6 * 128, 1)
    row = torch.randn(1, 128).expand(32, 128)
    assert tfb._mod_rows("gate", row, (32, 128), 32).stride() == (0, 1)
    per_group = torch.randn(2, 1, 128).expand(2, 16, 128)
    m = tfb._mod_rows("shift", per_group, (2, 16, 128), 32)
    assert m.stride(1) == 1 and torch.equal(m, per_group.reshape(32, 128))
    with pytest.raises(ValueError, match="shape"):
        tfb._mod_rows("gate", row, (16, 128), 16)


def _randomized(tree, seed, scale=0.1):
    """Every leaf drawn (zero adaLN and final layer would be vacuous)."""
    leaves, treedef = jax.tree_util.tree_flatten(tree)
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_unflatten(treedef, [
        jnp.asarray(scale * rng.standard_normal(l.shape), jnp.float32)
        for l in leaves])


def _net_pair(attention, bounded, seed=0, c=128, ch=8, cond=64, blocks=4, ada=2):
    net = JDiffNet(in_channels=ch, model_channels=c, z_channels=cond,
                   num_res_blocks=blocks, num_ada_ln_blocks=ada,
                   attention=attention, use_swiglu=True, bounded_output=bounded,
                   attn_head_dim=64)
    shape = (2, 8) if attention else (2,)
    params = net.init(jax.random.PRNGKey(seed), jnp.zeros(shape + (ch,)),
                      jnp.zeros((2,)), jnp.zeros(shape + (cond,)))["params"]
    params = _randomized(params, seed + 1)
    tnet = load_into(tdh.DiffNet(ch, c, cond, blocks, ada, attention=attention,
                                 bounded_output=bounded, attn_head_dim=64),
                     flax_state_from_jax(params))
    return net, params, tnet


@pytest.mark.parametrize("train", [False, True], ids=["kernels", "plain"])
@pytest.mark.parametrize("bounded", [False, True], ids=["unbounded", "bounded"])
@pytest.mark.parametrize("attention", [False, True], ids=["mlp", "trans"])
def test_diffnet_forward_matches_jax(attention, bounded, train):
    net, params, tnet = _net_pair(attention, bounded)
    rng = np.random.default_rng(3)
    lead = (3, 16) if attention else (24,)
    x = rng.standard_normal(lead + (8,)).astype(np.float32)
    t = rng.uniform(size=lead[:1]).astype(np.float32)
    c = rng.standard_normal(lead + (64,)).astype(np.float32)
    want = np.asarray(net.apply({"params": params}, jnp.asarray(x),
                                jnp.asarray(t), jnp.asarray(c)))
    counts = (tfb.fused_mlp_block.launches, tfb.fused_attn_block.launches)
    with torch.no_grad():
        got = tnet(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(c),
                   train=train).numpy()
    assert counts == (tfb.fused_mlp_block.launches, tfb.fused_attn_block.launches)
    if bounded:
        assert np.abs(got).max() <= 1.0
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


@pytest.fixture(scope="module", params=["mlp", "trans_unbounded"])
def sampler_setup(request):
    attention = request.param != "mlp"
    net, params, tnet = _net_pair(attention, False, seed=5)
    rng = np.random.default_rng(9)
    rows = 32                                   # 16 cond + 16 uncond rows
    groups = 4 if attention else 1
    cond = rng.standard_normal((rows, 64)).astype(np.float32)
    x0 = rng.standard_normal((rows // 2, 8)).astype(np.float32)
    noise = rng.standard_normal((4, rows // 2, 8)).astype(np.float32)
    t_all = np.linspace(0.0, 0.95, 5).astype(np.float32)
    dt_all = np.concatenate([t_all[1:] - t_all[:-1], [0.0]]).astype(np.float32)
    j_stacked = jfh.stack_diffnet_params(params, 4, attention, dtype=jnp.float32)
    j_cemb = jnp.asarray(cond) @ params["cond_embed"]["kernel"] \
        + params["cond_embed"]["bias"]
    j_mods = jfh.em_precompute(j_stacked, j_cemb, jnp.asarray(t_all),
                               out_dtype=jnp.float32)
    t_stacked = tfh.stack_diffnet_params(tnet, 4, dtype=torch.float32)
    t_cemb = torch.from_numpy(cond) @ t_stacked["cond_w"].t() + t_stacked["cond_b"]
    t_mods = tfh.em_precompute(t_stacked, t_cemb, torch.from_numpy(t_all),
                               out_dtype=torch.float32)
    kw = dict(num_blocks=4, num_ada=2, n_head=2, groups=groups,
              attention=attention, bounded=False)
    return dict(attention=attention, x0=x0, noise=noise, t_all=t_all,
                dt_all=dt_all, j_stacked=j_stacked, j_cemb=j_cemb, j_mods=j_mods,
                t_stacked=t_stacked, t_cemb=t_cemb, t_mods=t_mods, kw=kw,
                params=params, tnet=tnet)


def test_stack_matches_jax_for_both_families(sampler_setup):
    s = sampler_setup
    want_keys = {"n2", "w1", "b1", "w2", "b2"} | (
        {"n1", "wqkv", "bqkv", "wo", "bo"} if s["attention"] else set())
    assert want_keys <= set(s["t_stacked"])
    if not s["attention"]:
        assert not {"n1", "wqkv", "bqkv", "wo", "bo"} & set(s["t_stacked"])
    for k in want_keys:
        jv = np.asarray(s["j_stacked"][k])
        if k in ("b1", "b2", "bqkv", "bo"):
            jv = jv[:, 0]
        elif k not in ("n1", "n2"):
            jv = jv.transpose(0, 2, 1)
        np.testing.assert_array_equal(s["t_stacked"][k].numpy(), jv, err_msg=k)
    np.testing.assert_allclose(s["t_mods"].numpy(), np.asarray(s["j_mods"]), **TOL)
    # the quantized stacks (int8, packed int4), bf16 elsewhere: every key
    # bit for bit (matrices transposed, a packed byte keeping its pair)
    for quant in (True, "int4"):
        jq = jfh.stack_diffnet_params(s["params"], 4, s["attention"], dtype=jnp.bfloat16,
                                      quant=quant)
        tq = tfh.stack_diffnet_params(s["tnet"], 4, dtype=torch.bfloat16, quant=quant)
        mats = ("w1", "w2") + (("wqkv", "wo") if s["attention"] else ())
        assert {k for k in tq if k.endswith("_s")} == {m + "_s" for m in mats + ("modcat_w",)}
        for k in want_keys | {m + "_s" for m in mats} | {"modcat_w", "modcat_w_s"}:
            jv, tv = np.asarray(jq[k]), tq[k]
            if k.endswith("_s") or k in ("b1", "b2", "bqkv", "bo"):
                jv = jv.reshape(tv.shape)
            elif k == "modcat_w":
                jv = jv.T
            elif k not in ("n1", "n2"):
                jv = jv.transpose(0, 2, 1)
            assert tv.dtype == (torch.int8 if k in mats + ("modcat_w",) else
                                torch.float32 if k.endswith("_s") else torch.bfloat16), k
            np.testing.assert_array_equal(tv.float().numpy(), jv.astype(np.float32),
                                          err_msg=f"{quant} {k}")


def _port_sample(s, **kw):
    return tfh.fused_em_sample(
        s["t_stacked"], torch.from_numpy(s["x0"]), torch.from_numpy(s["noise"]),
        s["t_mods"], torch.from_numpy(s["t_all"]), torch.from_numpy(s["dt_all"]),
        3.0, **s["kw"], **kw).numpy()


@pytest.mark.parametrize("resident", [True, False], ids=["resident", "per_block"])
def test_plain_sampler_matches_jax_kernel(sampler_setup, resident):
    """The MlpEncoder (3 mods, no attention) and the unbounded TransEncoder
    through the Pallas kernels #3 (per block) and #4 (resident)."""
    s = sampler_setup
    want = np.asarray(jfh.fused_em_sample(
        s["j_stacked"], jnp.asarray(s["x0"]), jnp.asarray(s["noise"]),
        s["j_mods"], jnp.asarray(s["t_all"]), jnp.asarray(s["dt_all"]),
        jnp.float32(3.0), interpret=True, resident=resident, streamed=False,
        **s["kw"]))
    before = tfh.fused_em_sample.launches
    got = _port_sample(s)
    assert tfh.fused_em_sample.launches == before
    np.testing.assert_allclose(got, want, **SAMPLER_TOL)


def test_em_sample_stacked_matches_jax(sampler_setup):
    s = sampler_setup
    want = np.asarray(jfh.em_sample_stacked(
        s["j_stacked"], jnp.asarray(s["x0"]), jnp.asarray(s["noise"]), None,
        jnp.asarray(s["t_all"]), jnp.asarray(s["dt_all"]), jnp.float32(3.0),
        c_emb=s["j_cemb"], **s["kw"]))
    got = tfh.em_sample_stacked(
        s["t_stacked"], torch.from_numpy(s["x0"]), torch.from_numpy(s["noise"]),
        None, torch.from_numpy(s["t_all"]), torch.from_numpy(s["dt_all"]), 3.0,
        c_emb=s["t_cemb"], **s["kw"]).numpy()
    np.testing.assert_allclose(got, want, **SAMPLER_TOL)
    np.testing.assert_allclose(_port_sample(s), want, **SAMPLER_TOL)


def _tiny_kw(parallel_num):
    return dict(dim=64, n_layer=2, n_head=4, diff_layers=2, diff_dim=64,
                diff_adanln_layers=1, latent_dim=8, down_size=16, patch_size=1,
                resolution=64, cls_token_num=4, num_classes=10,
                parallel_num=parallel_num)


@pytest.mark.parametrize("parallel_num", [1, 16])
def test_sampler_loader_round_trips(parallel_num):
    """A JAX sampling tree (backbone with query tokens for Nx; MlpEncoder,
    or TransEncoder at head dim 64; VQ decoder) -> the port's sampler
    bundle -> the JAX package's converters give it back exactly."""
    kw = dict(_tiny_kw(parallel_num), diff_dim=128)
    jcfg, tcfg = jia.ImageNetARConfig(**kw), tia.ImageNetARConfig(**kw)
    ar = _randomized(jia.init_ar_params(jax.random.PRNGKey(0), jcfg), 1)
    head = jia.make_head(jcfg)
    lead = (2, parallel_num) if parallel_num > 1 else (2,)
    hp = _randomized(head.init(jax.random.PRNGKey(1), jnp.zeros(lead + (8,)),
                               jnp.zeros(lead + (64,)), jax.random.PRNGKey(2)), 2)
    aep = _randomized(JVQ(ddconfig=TINY_DD).init(
        jax.random.PRNGKey(3), jnp.zeros((1, 4, 4, 8)), method=JVQ.decode), 3)
    b = imagenet_sampler_from_jax(tcfg, ar, hp, aep, ddconfig=TINY_DD)
    assert b.head.attention == (parallel_num > 1) and not b.head.bounded
    if parallel_num > 1:
        assert b.head.net.res_blocks[0].attn.n_head == 2 and "query_token" in ar
    np_state = lambda m: {k: v.detach().numpy() for k, v in m.state_dict().items()}  # noqa: E731
    back = convert_imagenet_ar_state(np_state(b.model), kw["n_layer"])
    jax.tree_util.tree_map(np.testing.assert_array_equal, back, ar)
    back = convert_diffhead_state(np_state(b.head))
    jax.tree_util.tree_map(np.testing.assert_array_equal, back, hp)
    back = convert_ae_state(np_state(b.ae))
    jax.tree_util.tree_map(np.testing.assert_array_equal, back, aep)
    w1 = b.head.net.res_blocks[1].w1.weight
    assert w1.untyped_storage().data_ptr() == b.head_stacked["w1"].untyped_storage().data_ptr()


def _shaped_noise(shape):
    seed = NOISE_SEED
    for d in shape:
        seed = (seed * 131 + int(d) + 7) % (2**31 - 1)
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _sample_pair(parallel_num):
    kw = _tiny_kw(parallel_num)
    jcfg, tcfg = jia.ImageNetARConfig(**kw), tia.ImageNetARConfig(**kw)
    ar = _randomized(jia.init_ar_params(jax.random.PRNGKey(0), jcfg), 1, 0.3)
    head = jia.make_head(jcfg)
    lead = (2, parallel_num) if parallel_num > 1 else (2,)
    hp = _randomized(head.init(jax.random.PRNGKey(1), jnp.zeros(lead + (8,)),
                               jnp.zeros(lead + (64,)), jax.random.PRNGKey(2)), 2, 0.3)
    b = imagenet_sampler_from_jax(tcfg, ar, hp, None)
    return jcfg, ar, head, hp, b


@pytest.mark.parametrize("cfg_scale", [1.0, 3.0], ids=["unguided", "guided"])
@pytest.mark.parametrize("parallel_num", [1, 4])
def test_sample_exact_tokens(monkeypatch, parallel_num, cfg_scale):
    jcfg, ar, head, hp, b = _sample_pair(parallel_num)
    cls = np.asarray([0, 3], np.int32)
    steps = 4
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape=(), dtype=jnp.float32:
                        jnp.asarray(_shaped_noise(tuple(shape)), dtype))
    want = np.asarray(jia.sample(ar, head, hp, jcfg, jnp.asarray(cls),
                                 jax.random.PRNGKey(5), num_sampling_steps=steps,
                                 cfg_scale=cfg_scale))
    x_shape = (2, 8) if parallel_num == 1 else (2, parallel_num, 8)

    def table_noise(generator, half, ch, num_steps, device):
        t = torch.from_numpy(_shaped_noise(x_shape)).reshape(half, ch)
        return t.clone(), t[None].repeat(num_steps, 1, 1)

    margins = []
    real_sign = tia._sign

    def spy_sign(x):
        margins.append(float(x.abs().min()))
        return real_sign(x)

    monkeypatch.setattr(tdh, "draw_sampler_noise", table_noise)
    monkeypatch.setattr(tia, "_sign", spy_sign)
    counts = (tfh.fused_em_sample.launches, tfb.fused_mlp_block.launches,
              tfb.fused_attn_block.launches)
    timing = {}
    got = tia.sample(b.model, b.head, b.cfg, torch.from_numpy(cls).long(),
                     torch.Generator(), num_sampling_steps=steps,
                     cfg_scale=cfg_scale,
                     head_sampler=tdh.make_fused_sampler(b.head, b.head_stacked),
                     timing=timing).numpy()
    assert counts == (tfh.fused_em_sample.launches, tfb.fused_mlp_block.launches,
                      tfb.fused_attn_block.launches)           # CPU: plain versions
    assert set(timing) == {"prefill", "decode", "sampler", "clock"}
    n_ar = 16 // parallel_num
    assert len(margins) == n_ar and min(margins) > 1e-3, (
        f"borderline sign margin {min(margins)}: pick another NOISE_SEED")
    assert got.shape == want.shape == (2, 16, 8)
    np.testing.assert_array_equal(got, want, err_msg="±1 token grids diverge")


def test_per_call_and_whole_sampler_agree_when_guided():
    """Under cfg_mult 2 the per-call path (the block kernels' plain versions)
    and the whole sampler's plain version give the same latents from the
    same draws, for both families."""
    for parallel_num in (1, 4):
        *_, b = _sample_pair(parallel_num)
        lead = (4, parallel_num) if parallel_num > 1 else (4,)
        cond = torch.randn(lead + (64,), generator=torch.Generator().manual_seed(0))
        outs = [fn(cond, torch.Generator().manual_seed(1), 2.5, 3, 2)
                for fn in (b.head.sample_per_call,
                           tdh.make_fused_sampler(b.head, b.head_stacked))]
        np.testing.assert_allclose(outs[0].numpy(), outs[1].numpy(), **SAMPLER_TOL)


def test_euler_matches_jax():
    from bitdance_tpu.models.sampling import euler as jeuler
    from bitdance_tpu_torch.models.sampling import euler

    rng = np.random.default_rng(2)
    w = rng.standard_normal((8, 8)).astype(np.float32) * 0.3
    cond = rng.standard_normal((6, 8)).astype(np.float32)
    x0 = rng.standard_normal((3, 8)).astype(np.float32)
    jfn = lambda x, t, c: jnp.tanh(x @ w + c) * t[:, None]  # noqa: E731
    want = jeuler(jfn, jnp.asarray(cond), jax.random.PRNGKey(0), 8, cfg=2.0,
                  cfg_mult=2, num_sampling_steps=5, x_init=jnp.asarray(x0))
    tw = torch.from_numpy(w)
    tfn = lambda x, t, c: torch.tanh(x @ tw + c) * t[:, None]  # noqa: E731
    got = euler(tfn, torch.from_numpy(cond), None, 8, cfg=2.0, cfg_mult=2,
                num_sampling_steps=5, x_init=torch.from_numpy(x0))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
