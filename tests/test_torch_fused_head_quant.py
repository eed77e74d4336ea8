"""The head's W8A8 / W4A8 sampler in the port vs the JAX package: the
quantized stacks (int8 or nibble-packed block matrices with per-column
scales, int8 modcat), the W8A8 mods precompute, and the plain quant sampler
against JAX em_sample_stacked and against the TPU kernel #2 in its quant
mode (interpret mode) over 4 steps. Weights cross over through
bitdance_tpu_torch.io.from_jax.

Bounds: both sides quantize the same fp32 stage inputs to the same int8
values and sum the same integers, so one step agrees to ~2e-7 (int8) and
~2e-4 (int4, one flipped activation) on unit-scale latents: bound 1e-3. An
fp32 summation-order difference can move an activation across an int8 step,
and over 4 chained steps such flips grow: the JAX package's own XLA twin and
its kernel #2 (interpret) differ by 7.6e-3 (int8) and 4.5e-3 (int4) on the
same inputs. Bound over 4 steps: 2e-2 absolute."""

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
from bitdance_tpu_torch.models.diff_head import _quant_itemsize
from bitdance_tpu_torch.ops import fused_head as tfh

torch.set_num_threads(2)
C, CH, COND, BLOCKS, ADA, STEPS, CFG = 256, 8, 64, 4, 2, 4, 2.0
STEP_TOL = {1: 1e-3, STEPS: 2e-2}
KW = dict(num_blocks=BLOCKS, num_ada=ADA, n_head=C // 128, groups=4,
          attention=True, bounded=True)
JQUANT = {"int8": True, "int4": "int4"}


@pytest.fixture(scope="module")
def nets():
    net = JDiffNet(in_channels=CH, model_channels=C, z_channels=COND,
                   num_res_blocks=BLOCKS, num_ada_ln_blocks=ADA,
                   attention=True, use_swiglu=True, attn_head_dim=128)
    params = net.init(jax.random.PRNGKey(0), jnp.zeros((2, 8, CH)),
                      jnp.zeros((2,)), jnp.zeros((2, 8, COND)))["params"]
    leaves, treedef = jax.tree_util.tree_flatten(params)
    rng = np.random.default_rng(1)
    params = jax.tree_util.tree_unflatten(
        treedef, [jnp.asarray(0.05 * rng.normal(size=l.shape), jnp.float32)
                  for l in leaves])
    tnet = TDiffNet(CH, C, COND, BLOCKS, ADA)
    load_into(tnet, flax_state_from_jax(params))
    rng = np.random.default_rng(9)
    inputs = dict(
        cond=rng.normal(size=(32, COND)).astype(np.float32),
        x0=rng.normal(size=(16, CH)).astype(np.float32),
        noise=rng.normal(size=(STEPS, 16, CH)).astype(np.float32),
        t_all=np.linspace(0.0, 0.95, STEPS + 1).astype(np.float32))
    inputs["dt_all"] = np.concatenate([inputs["t_all"][1:] - inputs["t_all"][:-1],
                                       [0.0]]).astype(np.float32)
    return params, tnet, inputs


def _stacks(nets, mode):
    params, tnet, inp = nets
    js = jfh.stack_diffnet_params(params, BLOCKS, True, dtype=jnp.float32,
                                  quant=JQUANT[mode])
    ts = tfh.stack_diffnet_params(tnet, BLOCKS, dtype=torch.float32,
                                  quant=JQUANT[mode])
    j_cemb = jnp.asarray(inp["cond"]) @ params["cond_embed"]["kernel"] \
        + params["cond_embed"]["bias"]
    t_cemb = torch.from_numpy(inp["cond"]) @ ts["cond_w"].t() + ts["cond_b"]
    return js, ts, j_cemb, t_cemb


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_quantized_stack_matches_jax(nets, mode):
    js, ts, _, _ = _stacks(nets, mode)
    keys = {k for k in js if k not in ("ada_w", "ada_b", "f_ada_w", "f_ada_b")}
    assert keys == set(ts)
    for k in ("wqkv", "wo", "w1", "w2"):
        assert ts[k].dtype == torch.int8 and ts[k + "_s"].dtype == torch.float32
        np.testing.assert_array_equal(ts[k].numpy(),
                                      np.asarray(js[k]).transpose(0, 2, 1), err_msg=k)
        np.testing.assert_allclose(ts[k + "_s"].numpy(), np.asarray(js[k + "_s"])[:, 0],
                                   rtol=1e-7, atol=0, err_msg=k)
    div = 2 if mode == "int4" else 1
    assert tuple(ts["w1"].shape) == (BLOCKS, 2 * 384, C // div)
    assert ts["modcat_w"].dtype == torch.int8          # int8 whatever the blocks
    np.testing.assert_array_equal(ts["modcat_w"].numpy(), np.asarray(js["modcat_w"]).T)
    np.testing.assert_array_equal(ts["modcat_w_s"].numpy(), np.asarray(js["modcat_w_s"])[0])


# em_precompute's W8A8 product quantizes y = silu(te + c_emb) per row. The
# fp32 sums that lead to y are ordered differently by XLA and by torch (y
# differs by 1.7e-6 of max |y| measured), so a y within that of a rounding
# boundary of y / s rounds to the neighbouring int8 value on one side, and
# its row's mods move by a quantization step (one such value in 40,960 on an
# AMD EPYC host: 2,112 mods of its row off by up to 7.9e-4). So y is held to
# fp32 sums (Y_REL of max |y|); given the same y, the product to 1e-6 (the
# same int8 values, integer sums and scales: equal bits here, the bound
# leaves an fp32 ulp for a multiply-add that XLA may fuse); and the mods to 1e-4 over the rows whose every y / s clears a rounding
# boundary by more than the y bound can move it. A bf16-rounded product sum
# (ROADMAP C8) is off by up to 2^-9 of a mod and fails the last two.
Y_REL = 4e-6


def _jax_rows(js, j_cemb, t_all):
    """The JAX em_precompute's y, by its own steps (fused_head.py:1556-1560)."""
    from bitdance_tpu.models.diff_head import timestep_embedding

    te = jfh._dot(timestep_embedding(t_all, 256), js["t_w0"]) + js["t_b0"][None]
    te = jfh._dot(jax.nn.silu(te), js["t_w2"]) + js["t_b2"][None]
    return jax.nn.silu(te[:, None, :] + j_cemb[None]).reshape(-1, C)


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_w8a8_mods_precompute_matches_jax(nets, mode):
    js, ts, j_cemb, t_cemb = _stacks(nets, mode)
    t_all = nets[2]["t_all"]
    want = np.asarray(jfh.em_precompute(js, j_cemb, jnp.asarray(t_all), out_dtype=jnp.float32))
    want = want.reshape(-1, want.shape[-1])
    got = tfh.em_precompute(ts, t_cemb, torch.from_numpy(t_all),
                            out_dtype=torch.float32).numpy().reshape(want.shape)
    jy = _jax_rows(js, j_cemb, jnp.asarray(t_all))
    np.testing.assert_array_equal(       # _jax_rows is the JAX em_precompute's y
        np.asarray(jfh._mmq(jy, js["modcat_w"], js["modcat_w_s"]) + js["modcat_b"][None]), want)
    jy = np.array(jy)
    ty = tfh.em_precompute_rows(ts, t_cemb, torch.from_numpy(t_all)).reshape(jy.shape)
    np.testing.assert_allclose(ty.numpy(), jy, rtol=0, atol=Y_REL * np.abs(jy).max())
    np.testing.assert_allclose(tfh.modcat_product(ts, torch.from_numpy(jy)).numpy(), want,
                               rtol=1e-6, atol=1e-6)
    # y / s moves by at most 127 Y_REL from y and as much again from s
    q = jy / np.maximum(np.abs(jy).max(1, keepdims=True) / np.float32(127), np.float32(1e-12))
    clear = np.abs(np.abs(q - np.floor(q)) - 0.5).min(1) > 2 * 127 * Y_REL
    assert clear.sum() >= 0.4 * len(clear), clear.sum()
    np.testing.assert_allclose(got[clear], want[clear], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("steps", [1, STEPS])
@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_plain_quant_sampler_matches_jax(nets, mode, steps):
    """em_sample_stacked (the plain quant sampler) == JAX em_sample_stacked
    and the JAX kernel #2 quant mode (interpret), on the same mods."""
    js, ts, j_cemb, t_cemb = _stacks(nets, mode)
    inp = nets[2]
    t_all, dt_all = inp["t_all"][:steps + 1], inp["dt_all"][:steps + 1]
    j_args = (jnp.asarray(inp["x0"]), jnp.asarray(inp["noise"][:steps]))
    t_args = (torch.from_numpy(inp["x0"]), torch.from_numpy(inp["noise"][:steps]))
    j_mods = jfh.em_precompute(js, j_cemb, jnp.asarray(t_all), out_dtype=jnp.float32)
    stacked_xla = np.asarray(jfh.em_sample_stacked(
        js, *j_args, j_mods, jnp.asarray(t_all), jnp.asarray(dt_all),
        jnp.float32(CFG), **KW))
    kernel = np.asarray(jfh.fused_em_sample(
        js, *j_args, j_mods, jnp.asarray(t_all), jnp.asarray(dt_all),
        jnp.float32(CFG), interpret=True, streamed="dma", **KW))
    got = tfh.em_sample_stacked(
        ts, *t_args, torch.from_numpy(np.array(j_mods)), t_all, dt_all, CFG,
        quant=mode, **KW).numpy()
    tol = STEP_TOL[steps]
    np.testing.assert_allclose(got, stacked_xla, rtol=0, atol=tol)
    np.testing.assert_allclose(got, kernel, rtol=0, atol=tol)
    # with its own W8A8 mods, and through the wrapper's CPU branch
    own = tfh.em_sample_stacked(
        ts, *t_args, None, torch.from_numpy(t_all), torch.from_numpy(dt_all), CFG,
        c_emb=t_cemb, quant=mode, **KW)
    np.testing.assert_allclose(own.numpy(), stacked_xla, rtol=0, atol=STEP_TOL[STEPS])
    mods = tfh.em_precompute(ts, t_cemb, torch.from_numpy(t_all),
                             out_dtype=torch.float32)
    wrapped = tfh.fused_em_sample(ts, *t_args, mods, t_all, dt_all, CFG,
                                  quant=mode, **KW)
    np.testing.assert_array_equal(wrapped.numpy(), own.numpy())


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_plain_quant_sampler_on_the_split_twin_matches_jax_kernel_2(nets, mode, monkeypatch):
    """The plain quant sampler runs every block product through the integer
    head GEMM's split twin (head_gemm_s8_split_plain), here at 2 splits
    where the product has two 128-byte stages or more (the integer sums do
    not move with the split), against the JAX kernel #2 in its quant mode
    (interpret), 4 steps, under STEP_TOL."""
    js, ts, j_cemb, _ = _stacks(nets, mode)
    inp = nets[2]
    ks = {"wqkv": C, "wo": C, "w1": C, "w2": 384}
    splits = {key: min(2, tfh.head_gemm_stages(k, mode)) for key, k in ks.items()}
    twin, calls = tfh.head_gemm_s8_split_plain, []

    def counted(*args, **kw):
        calls.append(kw["splits"])
        return twin(*args, **kw)

    monkeypatch.setattr(tfh, "head_gemm_s8_split_plain", counted)
    j_mods = jfh.em_precompute(js, j_cemb, jnp.asarray(inp["t_all"]), out_dtype=jnp.float32)
    kernel = np.asarray(jfh.fused_em_sample(
        js, jnp.asarray(inp["x0"]), jnp.asarray(inp["noise"]), j_mods,
        jnp.asarray(inp["t_all"]), jnp.asarray(inp["dt_all"]), jnp.float32(CFG),
        interpret=True, streamed="dma", **KW))
    got = tfh.fused_em_sample_reference(
        ts, torch.from_numpy(inp["x0"]), torch.from_numpy(inp["noise"]),
        torch.from_numpy(np.array(j_mods)), inp["t_all"], inp["dt_all"], CFG, quant=mode,
        round_residual=False, splits=splits, **KW).numpy()
    assert len(calls) == 4 * BLOCKS * (STEPS + 1)
    assert sorted(set(calls)) == sorted(set(splits.values()))
    np.testing.assert_allclose(got, kernel, rtol=0, atol=STEP_TOL[STEPS])


def test_quant_changes_the_sample(nets):
    """The quant flag reaches the products: fp32, int8 and int4 stacks of
    the same weights give three different samples, each near the fp32 one."""
    _, tnet, inp = nets
    outs = []
    for quant in (False, True, "int4"):
        ts = tfh.stack_diffnet_params(tnet, BLOCKS, dtype=torch.float32, quant=quant)
        cemb = torch.from_numpy(inp["cond"]) @ ts["cond_w"].t() + ts["cond_b"]
        outs.append(tfh.em_sample_stacked(
            ts, torch.from_numpy(inp["x0"]), torch.from_numpy(inp["noise"]), None,
            torch.from_numpy(inp["t_all"]), torch.from_numpy(inp["dt_all"]), CFG,
            c_emb=cemb, quant=tfh.quant_mode(quant), **KW))
    assert not torch.equal(outs[0], outs[1]) and not torch.equal(outs[1], outs[2])
    for q in outs[1:]:
        assert ((q - outs[0]).norm() / outs[0].norm()).item() < 0.25


def test_head_stack_for_sampler_quant_and_itemsize():
    torch.manual_seed(0)
    head = TDiffHead(CH, COND, C, BLOCKS, ADA, parallel_num=8,
                     sample_weight_quant="int4")
    st = head._stack_for_sampler()
    assert st["wqkv"].dtype == torch.int8 and st["wqkv"].shape[-1] == C // 2
    assert "modcat_w_s" in st
    # the module keeps its own float weights (no shared storage with int8)
    assert head.net.res_blocks[0].w1.weight.dtype == torch.float32
    assert [_quant_itemsize(q) for q in (False, True, "int4")] == [2, 1, 0.5]
    with pytest.raises(ValueError):
        tfh.quant_mode("int2")
