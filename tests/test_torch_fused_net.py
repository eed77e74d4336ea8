"""Kernel #5 (the one-call DiffNet forward) and the residual rounding it
shares with the ImageNet heads' whole sampler (ROADMAP C3).

The plain version :func:`fused_diffnet_forward_reference` against the JAX
``fused_diffnet_forward(interpret=True)`` (the TPU kernel #5 in interpret
mode) on the same weights, carried from the flax tree by
``io/from_jax.py``: both head families in fp32 (the tests of
tests/test_fused_head.py:40-86), the adaLN switch, the [R, ch] squeeze with
``bounded`` on and off, one bf16 case; and against the port's own per-call
``DiffNet.forward`` in fp32. On the CPU the wrapper takes the plain version.

C3: in bf16 the JAX package runs the ImageNet heads' sampler on kernel #3,
whose blocks carry the residual in bf16; the port's plain sampler with the
rounding flag (chosen by the same weight-bytes rule) is closer to it than
with an fp32 residual.
"""

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
# fp32 on both sides; the order of the sums differs (the JAX tests' bound)
F32_TOL = dict(rtol=2e-4, atol=2e-4)


def _nets(attention, c=256, ch=8, cond=64, blocks=4, ada=2, bounded=None,
          seed=0, head_dim=128):
    """A flax DiffNet with every leaf drawn (0.05 N(0, 1)) and the port's
    DiffNet carrying the same weights."""
    net = JDiffNet(in_channels=ch, model_channels=c, z_channels=cond,
                   num_res_blocks=blocks, num_ada_ln_blocks=ada,
                   attention=attention, use_swiglu=True, bounded_output=bounded,
                   attn_head_dim=head_dim)
    lead = (2, 8) if attention else (16,)
    params = net.init(jax.random.PRNGKey(seed), jnp.zeros(lead + (ch,)),
                      jnp.zeros(lead[:1]), jnp.zeros(lead + (cond,)))["params"]
    rng = np.random.default_rng(seed + 1)
    params = jax.tree_util.tree_map(
        lambda l: jnp.asarray(0.05 * rng.standard_normal(l.shape), jnp.float32),
        params)
    tnet = load_into(tdh.DiffNet(ch, c, cond, blocks, ada, attention=attention,
                                 bounded_output=bounded, attn_head_dim=head_dim),
                     flax_state_from_jax(params))
    return net, params, tnet


def _inputs(attention, seed=3, g=2, w=8, rows=16, ch=8, cond=64):
    rng = np.random.default_rng(seed)
    lead = (g, w) if attention else (rows,)
    x = rng.standard_normal(lead + (ch,)).astype(np.float32)
    t_rows = rng.uniform(0.1, 0.9, size=lead[:1]).astype(np.float32)
    t = np.broadcast_to(t_rows[:, None], lead).copy() if attention else t_rows
    cc = rng.standard_normal(lead + (cond,)).astype(np.float32)
    return x, t_rows, t, cc


def _both(params, tnet, x, t, cc, *, attention, bounded, blocks=4, ada=2,
          dtype=torch.float32, jdtype=jnp.float32):
    n_head = tnet.res_blocks[0].attn.n_head if attention else 0
    jst = jfh.stack_diffnet_params(params, blocks, attention, dtype=jdtype)
    j_cemb = jnp.asarray(cc) @ params["cond_embed"]["kernel"] \
        + params["cond_embed"]["bias"]
    want = np.asarray(jfh.fused_diffnet_forward(
        jst, jnp.asarray(x), jnp.asarray(t), j_cemb, num_blocks=blocks,
        num_ada=ada, n_head=n_head, attention=attention, bounded=bounded,
        interpret=True))
    tst = tfh.stack_diffnet_params(tnet, blocks, dtype=dtype)
    t_cemb = torch.from_numpy(cc).float() @ tst["cond_w"].float().t() + tst["cond_b"]
    before = tfh.fused_diffnet_forward.launches
    got = tfh.fused_diffnet_forward(
        tst, torch.from_numpy(x), torch.from_numpy(t), t_cemb, num_blocks=blocks,
        num_ada=ada, n_head=n_head, attention=attention, bounded=bounded)
    assert tfh.fused_diffnet_forward.launches == before       # CPU: plain
    assert got.shape == x.shape and got.dtype == torch.float32
    return got.numpy(), want


@pytest.mark.parametrize("attention", [True, False], ids=["trans", "mlp"])
def test_plain_matches_jax_kernel(attention):
    _, params, tnet = _nets(attention)
    x, _, t, cc = _inputs(attention)
    got, want = _both(params, tnet, x, t, cc, attention=attention,
                      bounded=attention)
    np.testing.assert_allclose(got, want, **F32_TOL)


def test_adaln_switching():
    """4 blocks / 2 groups: blocks 2-3 must read group 1 (ada_ln_1 x -3)."""
    _, params, _ = _nets(True)
    params["ada_ln_1"] = jax.tree_util.tree_map(lambda a: a * -3.0,
                                                params["ada_ln_1"])
    tnet = load_into(tdh.DiffNet(8, 256, 64, 4, 2, attention=True,
                                 attn_head_dim=128), flax_state_from_jax(params))
    x, _, t, cc = _inputs(True, seed=5)
    got, want = _both(params, tnet, x, t, cc, attention=True, bounded=True)
    np.testing.assert_allclose(got, want, **F32_TOL)
    # the two groups swapped give another function
    tst = tfh.stack_diffnet_params(tnet, 4, dtype=torch.float32)
    (g0, _), (g1, _) = tfh.adaln_views(tst, 2, True)[0]
    swapped = dict(tst, modcat_w=torch.cat([g1, g0, tst["modcat_w"][2 * 6 * 256:]]))
    other = tfh.fused_diffnet_forward_reference(
        swapped, torch.from_numpy(x), torch.from_numpy(t),
        torch.from_numpy(cc) @ tst["cond_w"].t() + tst["cond_b"],
        num_blocks=4, num_ada=2, n_head=2, attention=True)
    assert np.abs(other.numpy() - want).max() > 100 * F32_TOL["atol"]


@pytest.mark.parametrize("bounded", [False, True], ids=["unbounded", "bounded"])
def test_rows_squeeze_and_bounded(bounded):
    """The MlpEncoder's [R, ch] rows (one group, squeezed on the way out)."""
    _, params, tnet = _nets(False, bounded=bounded, seed=7)
    x, _, t, cc = _inputs(False, seed=8, rows=24)
    got, want = _both(params, tnet, x, t, cc, attention=False, bounded=bounded)
    assert got.shape == (24, 8)
    if bounded:
        assert np.abs(got).max() <= 1.0
    else:
        assert np.abs(got).max() > 1.0
    np.testing.assert_allclose(got, want, **F32_TOL)


@pytest.mark.parametrize("attention", [True, False], ids=["trans", "mlp"])
def test_plain_matches_jax_kernel_bf16(attention):
    """bf16 stacks on both sides (the card's working type). Every stage is
    rounded to bf16 on both sides, but XLA on the CPU keeps some
    intermediates in fp32 where torch rounds each op, so the two differ by
    a few bf16 ulps: measured 7.1e-3 (trans) / 3.8e-3 (mlp) of max |out|;
    bound 2e-2 of max |out|."""
    _, params, tnet = _nets(attention, seed=11)
    x, _, t, cc = _inputs(attention, seed=12)
    got, want = _both(params, tnet, x, t, cc, attention=attention,
                      bounded=attention, dtype=torch.bfloat16,
                      jdtype=jnp.bfloat16)
    rel = np.abs(got - want).max() / np.abs(want).max()
    assert rel < 2e-2, rel


@pytest.mark.parametrize("attention", [True, False], ids=["trans", "mlp"])
def test_plain_on_the_split_twin_matches_jax_kernel_bf16(attention, monkeypatch):
    """The plain version with every product summed over the K splits of the
    card's plans (net_plans: at C 256 and 16 rows each product 2 ways, the
    head GEMM's split twin), as the card's kernel is held against it,
    against the JAX kernel #5 in bf16 (interpret mode) under the one-pass
    bound of test_plain_matches_jax_kernel_bf16 (2e-2 of max |out|), and
    within a few bf16 roundings of the one-pass plain version."""
    _, params, tnet = _nets(attention, seed=11)
    x, _, t, cc = _inputs(attention, seed=12)
    n_head = tnet.res_blocks[0].attn.n_head if attention else 0
    kw = dict(num_blocks=4, num_ada=2, n_head=n_head, attention=attention, bounded=attention)
    jst = jfh.stack_diffnet_params(params, 4, attention, dtype=jnp.bfloat16)
    j_cemb = jnp.asarray(cc) @ params["cond_embed"]["kernel"] + params["cond_embed"]["bias"]
    want = np.asarray(jfh.fused_diffnet_forward(jst, jnp.asarray(x), jnp.asarray(t), j_cemb,
                                                interpret=True, **kw))
    tst = tfh.stack_diffnet_params(tnet, 4, dtype=torch.bfloat16)
    t_cemb = torch.from_numpy(cc) @ tst["cond_w"].float().t() + tst["cond_b"]
    plans = tfh.net_plans(16, 256, 384, attention)
    splits = {k: p.splits for k, p in plans.items()}
    assert set(splits.values()) == {2}
    widths, dot = [], tfh._dot_acc
    monkeypatch.setattr(tfh, "_dot_acc", lambda a, w: widths.append(w.shape[1]) or dot(a, w))
    args = (tst, torch.from_numpy(x), torch.from_numpy(t), t_cemb)
    got = tfh.fused_diffnet_forward_reference(*args, splits=splits, **kw).numpy()
    # t_w0 (K 256), t_w2 (K 256), the input projection (K 8), the final
    # modulation (K 256), per adaLN group its product (K 256) and its two
    # blocks' qkv, wo, w1 (K 256) and w2 (K 384), the output projection (K
    # 256): every product of the head GEMM in two partials
    blk = ([128] * 4 if attention else []) + [128, 128, 192, 192]
    assert widths == [128] * 4 + [8] + [128] * 2 + 2 * ([128] * 2 + 2 * blk) + [256]
    one = tfh.fused_diffnet_forward_reference(*args, **kw).numpy()
    assert np.isfinite(got).all() and got.shape == x.shape
    rel = lambda a, b: np.abs(a - b).max() / np.abs(b).max()    # noqa: E731
    assert rel(got, want) < 2e-2, rel(got, want)
    assert rel(got, one) < 2e-2, rel(got, one)


@pytest.mark.parametrize("attention", [True, False], ids=["trans", "mlp"])
def test_plain_matches_port_diffnet_forward(attention):
    _, _, tnet = _nets(attention, seed=13)
    x, t_rows, t, cc = _inputs(attention, seed=14)
    with torch.no_grad():
        want = tnet(torch.from_numpy(x), torch.from_numpy(t_rows),
                    torch.from_numpy(cc)).numpy()
        tst = tfh.stack_diffnet_params(tnet, 4, dtype=torch.float32)
        got = tfh.fused_diffnet_forward_reference(
            tst, torch.from_numpy(x), torch.from_numpy(t),
            torch.from_numpy(cc) @ tst["cond_w"].t() + tst["cond_b"],
            num_blocks=4, num_ada=2, n_head=2 if attention else 0,
            attention=attention, bounded=tnet.bounded).numpy()
    np.testing.assert_allclose(got, want, **F32_TOL)


@pytest.mark.parametrize("attention", [True, False], ids=["trans", "mlp"])
def test_plain_twins_of_the_card_check(attention):
    """The twins chip_smoke.py holds kernel #5 away from: group_of given as
    the default rule reproduces the plain version bit for bit, one block
    late it does not; fp32_qkv_h12 moves a bf16 net and leaves an fp32 one
    (where qkv and h12 are already fp32) as it is."""
    _, _, tnet = _nets(attention, seed=11)
    x, _, t, cc = (torch.from_numpy(a) for a in _inputs(attention, seed=12))
    kw = dict(num_blocks=4, num_ada=2, n_head=2 if attention else 0,
              attention=attention, bounded=attention)
    for dtype in (torch.bfloat16, torch.float32):
        st = tfh.stack_diffnet_params(tnet, 4, dtype=dtype)
        cemb = cc @ st["cond_w"].float().t() + st["cond_b"]
        ref = lambda **tw: tfh.fused_diffnet_forward_reference(  # noqa: E731
            st, x, t, cemb, **kw, **tw)
        want = ref()
        assert torch.equal(ref(group_of=lambda l: l // 2), want)
        assert not torch.allclose(ref(group_of=lambda l: max(l - 1, 0) // 2), want)
        twin = ref(fp32_qkv_h12=True)
        assert torch.equal(twin, want) == (dtype == torch.float32)


def test_adaln_views_share_modcat_storage():
    _, _, tnet = _nets(True)
    tst = tfh.stack_diffnet_params(tnet, 4, dtype=torch.bfloat16)
    groups, (f_w, f_b) = tfh.adaln_views(tst, 2, True)
    base_w = tst["modcat_w"].untyped_storage().data_ptr()
    base_b = tst["modcat_b"].untyped_storage().data_ptr()
    c = 256
    for g, (w, b) in enumerate(groups + [(f_w, f_b)]):
        assert w.untyped_storage().data_ptr() == base_w
        assert b.untyped_storage().data_ptr() == base_b
        assert w.data_ptr() == tst["modcat_w"].data_ptr() + g * 6 * c * c * 2
    assert f_w.shape == (2 * c, c) and groups[1][0].shape == (6 * c, c)
    torch.testing.assert_close(groups[1][0], tnet.ada_ln_blocks[1].weight.bfloat16())
    torch.testing.assert_close(f_w, tnet.final_layer.ada_ln_modulation.weight.bfloat16())


def test_launch_count_formula():
    assert tfh.net_launches(12, 3, False) == 6 + 6 + 36 + 2
    assert tfh.net_launches(6, 2, True) == 6 + 4 + 42 + 2


# ---------------------------------------------------------------------------
# C3: the ImageNet heads' whole sampler rounds its residual, as kernel #3
# ---------------------------------------------------------------------------

def _meta_stack(quant=False, **head):
    with torch.device("meta"):
        h = tdh.DiffHead(**head, dtype=torch.bfloat16)
    return tfh.stack_diffnet_params(h.net, head["depth_latent"],
                                    dtype=torch.bfloat16, quant=quant)


def test_rounding_rule_follows_the_jax_router():
    """H-1x (MlpEncoder C 1280, 12 blocks, 177 MB) and B-16x (C 768, 6
    blocks, 60 MB) go to kernel #3; the 14B head (C 5120, 2.7 GB) to #2.
    Quantized (R3), the router counts the int8 / packed int4 matrices and
    their fp32 scales: H-1x in int8 (88.9 MB) goes to #3, H-1x in int4 and
    B-16x in both under 48 MB to the resident #4, which rounds too; the 14B
    head stays on #2."""
    h1x = _meta_stack(ch_target=16, ch_cond=1280, ch_latent=1280,
                      depth_latent=12, depth_adanln=3, parallel_num=1,
                      attention=False)
    b16x = _meta_stack(ch_target=16, ch_cond=768, ch_latent=768, depth_latent=6,
                       depth_adanln=2, parallel_num=16, attn_head_dim=64)
    big = _meta_stack(ch_target=32, ch_cond=5120, ch_latent=5120, depth_latent=6,
                      depth_adanln=2, parallel_num=64)
    assert tfh.block_weight_bytes(h1x, False) == 12 * 2 * (2 * 1920 * 1280 + 1280
                                                           * 1920 + 2 * 1920
                                                           + 1280 + 2 * 1280)
    assert tfh.rounds_residual(h1x, 12, False)
    assert tfh.rounds_residual(b16x, 6, True)
    assert not tfh.rounds_residual(big, 6, True)
    geo = {"h1x": (dict(ch_target=16, ch_cond=1280, ch_latent=1280, depth_latent=12,
                        depth_adanln=3, parallel_num=1, attention=False), 12, False),
           "b16x": (dict(ch_target=16, ch_cond=768, ch_latent=768, depth_latent=6,
                         depth_adanln=2, parallel_num=16, attn_head_dim=64), 6, True),
           "14b": (dict(ch_target=32, ch_cond=5120, ch_latent=5120, depth_latent=6,
                        depth_adanln=2, parallel_num=64), 6, True)}
    for quant in (True, "int4"):
        for name, (head, blocks, attention) in geo.items():
            st = _meta_stack(quant, **head)
            wb = tfh.block_weight_bytes(st, attention)
            assert st["w1_s"].dtype == torch.float32 and wb > 0
            if name == "14b":
                assert not tfh.rounds_residual(st, blocks, attention), (quant, wb)
            else:
                assert tfh.rounds_residual(st, blocks, attention), (name, quant)
                resident = not (name == "h1x" and quant is True)
                assert (wb <= 48 * 1024 * 1024) == resident, (name, quant, wb)


@pytest.fixture(scope="module", params=["mlp", "trans"])
def bf16_sampler(request):
    attention = request.param == "trans"
    _, params, tnet = _nets(attention, c=128, seed=5, head_dim=64)
    rng = np.random.default_rng(9)
    rows, groups = 32, (4 if attention else 1)
    cond = rng.standard_normal((rows, 64)).astype(np.float32)
    x0 = rng.standard_normal((rows // 2, 8)).astype(np.float32)
    noise = rng.standard_normal((4, rows // 2, 8)).astype(np.float32)
    t_all = np.linspace(0.0, 0.95, 5).astype(np.float32)
    dt_all = np.concatenate([t_all[1:] - t_all[:-1], [0.0]]).astype(np.float32)
    kw = dict(num_blocks=4, num_ada=2, n_head=2, groups=groups,
              attention=attention, bounded=False)
    jst = jfh.stack_diffnet_params(params, 4, attention, dtype=jnp.bfloat16)
    cemb = jnp.asarray(cond) @ params["cond_embed"]["kernel"] \
        + params["cond_embed"]["bias"]
    mods = jfh.em_precompute(jst, cemb, jnp.asarray(t_all), out_dtype=jnp.bfloat16)
    want = np.asarray(jfh.fused_em_sample(
        jst, jnp.asarray(x0), jnp.asarray(noise), mods, jnp.asarray(t_all),
        jnp.asarray(dt_all), jnp.float32(3.0), interpret=True, resident=False,
        streamed=False, **kw))
    tst = tfh.stack_diffnet_params(tnet, 4, dtype=torch.bfloat16)
    tmods = torch.tensor(np.asarray(mods.astype(jnp.float32))).bfloat16()

    def port(**flag):
        return tfh.fused_em_sample_reference(
            tst, torch.from_numpy(x0), torch.from_numpy(noise), tmods, t_all,
            dt_all, 3.0, **kw, **flag).numpy()

    return dict(attention=attention, want=want, port=port, stack=tst)


def _mean_gap(got, want):
    return float(np.abs(got - want).mean() / np.abs(want).max())


def test_bf16_sampler_rounds_the_residual_as_kernel_3(bf16_sampler):
    """bf16, 4 steps at cfg 3 against JAX kernel #3 (per-block weights, the
    route of both ImageNet heads). Mean gap relative to max |x|: the
    rounded residual (the rule's choice here) measured 6.5e-8 (mlp) and
    4.3e-3 (trans: XLA on the CPU keeps the attention's scaled q and some
    sums in fp32 where the kernel's bf16 ops round), the fp32 residual
    4.6e-3 and 6.0e-3 (1.40x). Bounds: 1e-5 and 4.6e-3; the fp32 residual
    at least 100x and 1.3x further."""
    s = bf16_sampler
    assert tfh.rounds_residual(s["stack"], 4, s["attention"])
    rounded = _mean_gap(s["port"](), s["want"])
    assert rounded == _mean_gap(s["port"](round_residual=True), s["want"])
    fp32 = _mean_gap(s["port"](round_residual=False), s["want"])
    assert rounded < (4.6e-3 if s["attention"] else 1e-5), rounded
    assert fp32 > (1.3 if s["attention"] else 100.0) * rounded, (rounded, fp32)
