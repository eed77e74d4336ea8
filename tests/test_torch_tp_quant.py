"""Quantized tensor-parallel serving in the port (parallel/tp.py,
T2IPipeline(mesh=..., kv_int8=True)) on the CPU over gloo, against the JAX
package: the int8 and packed-int4 head stacks head-major and sharded, the
int8 KV cache at a rank's kv heads, and the stacked sampler's
``glue_dtype`` and ``mods_chunks``.

  - reorder_stacked_head_major on int8 and int4 stacks equals JAX's key by
    key (the port's [out, in] layout transposed);
  - the head-major quantized em_sample_stacked at tp 1 (bf16 glue,
    mods_chunks 1, 2 and 4) against JAX em_sample_stacked(glue_dtype=bf16)
    on the JAX head-major stack, compiled with xla_allow_excess_precision
    off so that each bf16 op rounds op by op
    (tests/test_torch_imagenet_int8.py): one step's mean gap within
    QUANT_STEP_MEAN_GAP, which fp32 glue exceeds; mods_chunks 2 and 4 equal
    to 1 bit for bit;
  - T2IPipeline(mesh, kv_int8=True) with the int8 and then the int4 head
    under the (1, 1, 4) and (1, 2, 2) meshes: tokens equal to JAX's
    T2IPipeline(mesh=..., kv_int8=True) under the same mesh (four of the
    8 virtual CPU devices), every sign input clear of SIGN_MARGIN and
    within SIGN_INPUT_GAP of JAX's; wqkv / w1 / their scales
    column-parallel, wo / w2 row-parallel, each rank's unpacked int4 share
    the whole weight's in-feature range; the int8 cache at the rank's kv
    heads; the all-reduces by kind (int32 sums, fp32 maxima);
  - the refusals: quantized Qwen3 projections, the int8 embedding and
    lm_head, and (off the CPU) a packed share the s4 stage does not divide
    (meta tensors at the 14B head's shapes).

One world-4 gloo spawn per mesh (tests/test_torch_parallel.py's ``spawn``)
serves both heads and returns what the checks read. The weights, the
tokenizer and the tables of noise are tests/test_torch_tp.py's.
"""

import dataclasses
import functools
import os

import numpy as np
import pytest
import torch

from bitdance_tpu_torch.ops import fused_head as tfh
from bitdance_tpu_torch.ops.int4 import unpack_int4
from bitdance_tpu_torch.parallel import tp as ttp
from tests.test_torch_tp import MESHES, TINY_DD, StubTokenizer, _jax_bundle, _shaped_noise

torch.set_num_threads(2)
QUANTS = {"int8": True, "int4": "int4"}
PROMPT = "a quantized head over tp"
GEN = dict(height=8, width=8, num_sampling_steps=4, guidance_scale=2.0, num_images=1, seed=5)
NOISE_SEED = 4            # every sign input of the four runs clears 2e-2 (and SIGN_MARGIN)
SIGN_MARGIN = 1e-3
SIGN_INPUT_GAP = 2e-2     # |port - JAX| of a sign input (JAX keeps fused bf16 chains in fp32)
HEAD_TP = dict(ch_target=8, ch_cond=64, ch_latent=128, depth_latent=2, depth_adanln=2,
               parallel_num=4, attn_head_dim=32)
ROW_KEYS = ("wo", "w2")


# ---------------------------------------------------------------------------
# the ranks
# ---------------------------------------------------------------------------

def _table_noise(generator, half, ch, num_steps, device):
    """JAX's stacked sampler draws x0 [half, ch] and noise [steps, half, ch]."""
    return (torch.from_numpy(_shaped_noise((half, ch), NOISE_SEED)),
            torch.from_numpy(_shaped_noise((num_steps, half, ch), NOISE_SEED)))


def _port_bundle(states, quant):
    from bitdance_tpu_torch.io.from_jax import load_into
    from bitdance_tpu_torch.models import diff_head as tdh
    from bitdance_tpu_torch.models import qwen3 as tq
    from bitdance_tpu_torch.models.connector import MLPConnector
    from bitdance_tpu_torch.models.tokenizer import VQModel
    from bitdance_tpu_torch.pipelines import t2i as tt2i

    head = load_into(tdh.DiffHead(**HEAD_TP, sample_weight_quant=quant), states["head"])
    return tt2i.T2IModelBundle(
        llm=load_into(tq.Qwen3Model(tq.Qwen3Config(**states["llm_cfg"])), states["llm"]),
        ae=load_into(VQModel(states["dd"]), states["ae"]), head=head,
        projector=load_into(MLPConnector(8, 64), states["proj"]), parallel_num=4,
        hidden_size=64, vae_patch_size=2, pe_max_len=128)


def _share_of_whole(local: torch.Tensor, whole: torch.Tensor, rank: int, size: int,
                    packed: bool) -> bool:
    """Whether a row-parallel share's (unpacked) in-features are the whole
    weight's [rank K/size, (rank + 1) K/size)."""
    if packed:
        local, whole = (torch.cat(unpack_int4(t), dim=2) for t in (local, whole))
    k = local.shape[2]
    return k * size == whole.shape[2] and torch.equal(local, whole[..., rank * k:(rank + 1) * k])


def _serve(mesh, states, quant) -> dict:
    from bitdance_tpu_torch.models import diff_head as tdh
    from bitdance_tpu_torch.models import qwen3 as tq
    from bitdance_tpu_torch.pipelines import t2i as tt2i

    bundle = _port_bundle(states, QUANTS[quant])
    whole = ttp.reorder_stacked_head_major(bundle.stacked_head(), 4)
    inputs, caches = [], []
    real = tdh.draw_sampler_noise, tt2i.sign_quantize, tq.init_kv_cache

    def spy_sign(x):
        inputs.append(x.float().numpy().copy())
        return real[1](x)

    def spy_cache(*args, **kw):
        cache = real[2](*args, **kw)
        caches.append({k: (tuple(v.shape), v.dtype) for k, v in cache.items()})
        return cache

    tdh.draw_sampler_noise, tt2i.sign_quantize, tq.init_kv_cache = _table_noise, spy_sign, spy_cache
    try:
        pipe = tt2i.T2IPipeline(bundle, StubTokenizer(), kv_int8=True, mesh=mesh)
        _, tok = pipe.generate(PROMPT, return_tokens=True, **GEN)
    finally:
        tdh.draw_sampler_noise, tt2i.sign_quantize, tq.init_kv_cache = real
    hs = pipe.bundle.head_stacked
    g = hs["tp"].group
    keys = ("wqkv", "wqkv_s", "w1", "w1_s", "wo", "wo_s", "w2", "w2_s")
    return {"tokens": tok, "inputs": inputs, "caches": caches, "last_tp": pipe.last_tp,
            "placements": dict(hs["tp"].placements),
            "shapes": {k: tuple(hs[k].shape) for k in keys},
            "row_shares": {k: _share_of_whole(hs[k], whole[k], g.rank, g.size,
                                              quant == "int4") for k in ROW_KEYS},
            "scales_whole": all(torch.equal(hs[k], whole[k])
                                for k in ("wo_s", "w2_s", "modcat_w_s"))}


def tp_quant_task(rank, world, workdir):
    from bitdance_tpu_torch.parallel import mesh as tmesh

    ref = torch.load(os.path.join(workdir, "states.pt"), weights_only=False)
    mesh = tmesh.create_mesh(*ref["mesh"], device_type="cpu")
    return {q: _serve(mesh, ref["states"], q) for q in QUANTS}


# ---------------------------------------------------------------------------
# the JAX side and the worlds
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_runs():
    """JAX's T2IPipeline(mesh=..., kv_int8=True) on the stacked-only int8 and
    int4 heads under each mesh: tokens and sign inputs; and the weights the
    ranks load."""
    import jax
    import jax.numpy as jnp

    from bitdance_tpu.models.diff_head import DiffHead
    from bitdance_tpu.parallel.mesh import create_mesh
    from bitdance_tpu.pipelines import t2i as jt2i
    from bitdance_tpu_torch.io.from_jax import flax_state_from_jax, qwen3_state_from_jax

    b = _jax_bundle()
    out = {}
    for quant, flag in QUANTS.items():
        head = b.head.clone(attn_head_dim=32, sample_weight_quant=flag)
        bq = dataclasses.replace(b, head=head, head_params=None, head_stacked=head.apply(
            b.head_params, method=DiffHead._stack_for_sampler))
        for name, shape in MESHES.items():
            inputs = []
            real = jt2i.sign_quantize

            def spy(x, real=real, inputs=inputs):
                jax.debug.callback(lambda v: inputs.append(np.asarray(v)), x)
                return real(x)

            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(jax.random, "normal", lambda key, shape=(), dtype=jnp.float32:
                           jnp.asarray(_shaped_noise(tuple(shape), NOISE_SEED), dtype))
                mp.setattr(jt2i, "sign_quantize", spy)
                pipe = jt2i.T2IPipeline(bq, tokenizer=StubTokenizer(), kv_int8=True,
                                        force_one_program=True,
                                        mesh=create_mesh(*shape, devices=jax.devices()[:4]))
                _, tok = pipe.generate(PROMPT, return_tokens=True, **GEN)
            hs = pipe.bundle.head_stacked
            out[quant, name] = {"tokens": np.asarray(tok), "inputs": inputs,
                                "specs": {k: str(hs[k].sharding.spec)
                                          for k in ("wqkv", "w1", "w1_s", "wo", "w2")}}
    states = {"llm": {k: np.asarray(v) for k, v in qwen3_state_from_jax(b.llm_params).items()},
              "llm_cfg": dataclasses.asdict(b.llm_cfg),
              "head": flax_state_from_jax(b.head_params), "ae": flax_state_from_jax(b.ae_params),
              "proj": flax_state_from_jax(b.projector_params), "dd": dict(TINY_DD)}
    return out, states


@pytest.fixture(scope="module")
def worlds(jax_runs, tmp_path_factory):
    from tests.test_torch_parallel import spawn

    out = {}
    for name, shape in MESHES.items():
        root = tmp_path_factory.mktemp(f"tp_quant_{name}")
        torch.save({"states": jax_runs[1], "mesh": shape}, root / "states.pt")
        out[name] = spawn(tp_quant_task, 4, root)
    return out


# ---------------------------------------------------------------------------
# serving over the meshes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("quant", QUANTS)
@pytest.mark.parametrize("mesh", MESHES)
def test_quant_tp_serving_matches_jax(worlds, jax_runs, mesh, quant):
    """Tokens equal JAX's under the same mesh on every rank, every sign input
    clear of the margin and within SIGN_INPUT_GAP of JAX's; the JAX head
    sharded as the port's is."""
    want = jax_runs[0][quant, mesh]
    assert want["specs"] == {"wqkv": "PartitionSpec(None, None, 'tp')",
                             "w1": "PartitionSpec(None, None, 'tp')",
                             "w1_s": "PartitionSpec(None, None, 'tp')",
                             "wo": "PartitionSpec(None, 'tp', None)",
                             "w2": "PartitionSpec(None, 'tp', None)"}
    for r in worlds[mesh]:
        got = r[quant]
        assert len(got["inputs"]) == len(want["inputs"]) == 4
        margin = min(float(np.abs(x).min()) for x in got["inputs"])
        assert margin > SIGN_MARGIN, f"borderline sign margin {margin}: pick another NOISE_SEED"
        gap = max(float(np.abs(x - j.reshape(x.shape)).max())
                  for x, j in zip(got["inputs"], want["inputs"]))
        assert gap < SIGN_INPUT_GAP, gap
        assert got["tokens"].shape == want["tokens"].shape == (1, 16, 8)
        np.testing.assert_array_equal(got["tokens"], want["tokens"])


@pytest.mark.parametrize("quant", QUANTS)
@pytest.mark.parametrize("mesh", MESHES)
def test_quant_head_shards_and_kv_int8(worlds, mesh, quant):
    """The head really is split: wqkv, w1 and their column scales by whole
    heads, wo and w2 by in-features (int4: repacked shares equal to the
    whole weight's K range), their scales and modcat's whole; the int8 KV
    ring at the rank's kv heads; int32 sums and fp32 maxima all-reduced."""
    tp = MESHES[mesh][2]
    packed = 2 if quant == "int4" else 1
    for r in worlds[mesh]:
        got = r[quant]
        assert got["placements"] == {"wqkv": "col", "wqkv_s": "col", "bqkv": "col",
                                     "w1": "col", "w1_s": "col", "b1": "col",
                                     "wo": "row", "w2": "row"}
        assert got["shapes"] == {
            "wqkv": (2, 384 // tp, 128 // packed), "wqkv_s": (2, 384 // tp),
            "w1": (2, 384 // tp, 128 // packed), "w1_s": (2, 384 // tp),
            "wo": (2, 128, 128 // tp // packed), "wo_s": (2, 128),
            "w2": (2, 128, 192 // tp // packed), "w2_s": (2, 128)}
        assert got["row_shares"] == {"wo": True, "w2": True} and got["scales_whole"]
        # kv heads a rank: 2 whole; tp 2 keeps one, tp 4 the one its q head reads
        (cache,) = got["caches"]
        (layers, rows, hkv, length, lanes), dt = cache["kv"]
        assert (layers, rows, hkv, lanes, dt) == (2, 2, 1, 32, torch.int8)
        assert cache["sc"] == ((2, 2, 1, 2, length), torch.float32)
        kinds = got["last_tp"]["kinds"]
        assert set(kinds) == {"float32 sum", "int32 sum", "float32 max"}
        # each AR step: (steps + 1) net calls x 2 blocks x wo and w2
        assert kinds["int32 sum"][0] == kinds["float32 max"][0] == 4 * 5 * 2 * 2


# ---------------------------------------------------------------------------
# the stacks and the sampler at tp 1
# ---------------------------------------------------------------------------

C, CH, COND, BLOCKS, ADA, HD, ROWS = 256, 8, 64, 2, 2, 64, 128
KW = dict(num_blocks=BLOCKS, num_ada=ADA, n_head=C // HD, groups=ROWS // 8,
          attention=True, bounded=True)
# one step's mean |port - JAX| on latents of mean |x| 0.6: 2.6e-4 (int8) and
# 2.7e-4 (int4) on an AMD EPYC host, from fp32 attention sums in another order
# moving an int8 activation by a step; fp32 glue lands 5.7-6.1e-4 away
QUANT_STEP_MEAN_GAP = 4e-4


@pytest.fixture(scope="module")
def head_stacks():
    """A flax DiffNet (C 256, 4 heads of 64, 2 blocks, 2 adaLN groups) with
    every leaf drawn, its int8 and int4 fp32 stacks on both sides, head-major,
    and the sampler's inputs at 128 rows (16 windows of 8)."""
    import jax
    import jax.numpy as jnp

    from bitdance_tpu.models.diff_head import DiffNet as JDiffNet
    from bitdance_tpu.ops import fused_head as jfh
    from bitdance_tpu.parallel.tp import reorder_stacked_head_major as j_reorder
    from bitdance_tpu_torch.io.from_jax import flax_state_from_jax, load_into
    from bitdance_tpu_torch.models.diff_head import DiffNet as TDiffNet

    net = JDiffNet(in_channels=CH, model_channels=C, z_channels=COND, num_res_blocks=BLOCKS,
                   num_ada_ln_blocks=ADA, attention=True, use_swiglu=True, attn_head_dim=HD)
    params = jax.eval_shape(lambda: net.init(jax.random.PRNGKey(0), jnp.zeros((2, 8, CH)),
                                             jnp.zeros((2,)), jnp.zeros((2, 8, COND))))["params"]
    leaves, treedef = jax.tree_util.tree_flatten(params)
    rng = np.random.default_rng(1)
    params = jax.tree_util.tree_unflatten(treedef, [
        jnp.asarray(0.05 * rng.normal(size=l.shape), jnp.float32) for l in leaves])
    tnet = load_into(TDiffNet(CH, C, COND, BLOCKS, ADA, attn_head_dim=HD),
                     flax_state_from_jax(params))
    stacks = {}
    for quant, flag in QUANTS.items():
        js = jfh.stack_diffnet_params(params, BLOCKS, True, dtype=jnp.float32, quant=flag)
        ts = tfh.stack_diffnet_params(tnet, BLOCKS, dtype=torch.float32, quant=flag)
        stacks[quant] = (j_reorder(js, C // HD), ttp.reorder_stacked_head_major(ts, C // HD), ts)
    rng = np.random.default_rng(9)
    steps = 4
    t_all = np.linspace(0.0, 0.95, steps + 1).astype(np.float32)
    inputs = dict(cond=rng.normal(size=(ROWS, COND)).astype(np.float32),
                  x0=rng.normal(size=(ROWS // 2, CH)).astype(np.float32),
                  noise=rng.normal(size=(steps, ROWS // 2, CH)).astype(np.float32),
                  t_all=t_all,
                  dt_all=np.concatenate([t_all[1:] - t_all[:-1], [0.0]]).astype(np.float32))
    return stacks, inputs


@pytest.mark.parametrize("quant", QUANTS)
def test_reorder_quantized_stacks_matches_jax(head_stacks, quant):
    """reorder_stacked_head_major on an int8 / int4 stack equals JAX's key
    by key (the port's [out, in] against JAX's [in, out]; scales [L, N]
    against [L, 1, N]); it moves qkv, w1 and their scales and biases only."""
    js, ts, canon = head_stacks[0][quant]
    assert set(ts) == set(js) - {"ada_w", "ada_b", "f_ada_w", "f_ada_b"}
    for k, v in ts.items():
        j = np.asarray(js[k])
        if k.endswith("_w") or k in ("wqkv", "wo", "w1", "w2", "t_w0", "t_w2"):
            j = np.swapaxes(j, -1, -2)          # JAX's [in, out]
        np.testing.assert_array_equal(v.numpy(), j.reshape(v.shape), err_msg=k)
        moved = k in ("wqkv", "wqkv_s", "bqkv", "w1", "w1_s", "b1", "hm_marker")
        assert moved or torch.equal(v, canon[k]), k


def _sample(ts, inputs, steps, **kw):
    c_emb = torch.from_numpy(inputs["cond"]) @ ts["cond_w"].float().t() + ts["cond_b"]
    return tfh.em_sample_stacked(
        ts, torch.from_numpy(inputs["x0"]), torch.from_numpy(inputs["noise"][:steps]), None,
        torch.from_numpy(inputs["t_all"][:steps + 1]),
        torch.from_numpy(inputs["dt_all"][:steps + 1]), 2.0, c_emb=c_emb, **KW, **kw).numpy()


@pytest.mark.parametrize("quant", QUANTS)
def test_head_major_quant_sampler_matches_jax(head_stacks, quant):
    """The head-major quantized em_sample_stacked at tp 1 with bf16 glue
    against JAX em_sample_stacked(glue_dtype=bf16) on the JAX head-major
    stack (each bf16 op rounded, xla_allow_excess_precision off): one step's
    mean gap within QUANT_STEP_MEAN_GAP, fp32 glue outside it; 4 steps at
    mods_chunks 2 and 4 bit-equal to 1 (so as close to JAX)."""
    import jax
    import jax.numpy as jnp

    from bitdance_tpu.ops import fused_head as jfh

    js, ts, _ = head_stacks[0][quant]
    inp = head_stacks[1]
    j_cemb = jnp.asarray(inp["cond"]) @ js["cond_w"].astype(jnp.float32) + js["cond_b"]

    def jax_sample(js, x0, noise, t_all, dt_all, c_emb):
        return jfh.em_sample_stacked(js, x0, noise, None, t_all, dt_all, jnp.float32(2.0),
                                     c_emb=c_emb, glue_dtype=jnp.bfloat16, **KW)

    args = (js, jnp.asarray(inp["x0"]), jnp.asarray(inp["noise"][:1]),
            jnp.asarray(inp["t_all"][:2]), jnp.asarray(inp["dt_all"][:2]), j_cemb)
    want = np.asarray(jax.jit(jax_sample).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})(*args))
    run = functools.partial(_sample, ts, inp, quant=quant)
    one = run(1, glue_dtype=torch.bfloat16)
    gap = float(np.abs(one - want).mean())
    assert gap < QUANT_STEP_MEAN_GAP, gap
    assert float(np.abs(run(1) - want).mean()) > QUANT_STEP_MEAN_GAP   # fp32 glue
    four = run(4, glue_dtype=torch.bfloat16)
    for chunks in (2, 4):
        np.testing.assert_array_equal(run(4, glue_dtype=torch.bfloat16, mods_chunks=chunks),
                                      four)
    with pytest.raises(ValueError, match="does not divide"):
        run(4, glue_dtype=torch.bfloat16, mods_chunks=3)


def test_glue_dtype_is_the_head_major_samplers(head_stacks):
    """A canonical stack runs kernel #2's plain version, whose residual is
    fp32: bf16 glue there raises; mods_chunks works on both routes."""
    _, hm, canon = head_stacks[0]["int8"]
    inp = head_stacks[1]
    with pytest.raises(ValueError, match="glue_dtype"):
        _sample(canon, inp, 2, quant="int8", glue_dtype=torch.bfloat16)
    np.testing.assert_array_equal(_sample(canon, inp, 2, quant="int8", mods_chunks=2),
                                  _sample(canon, inp, 2, quant="int8"))


# ---------------------------------------------------------------------------
# the refusals
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("what", ["int8", "int4", "embedding", "lm_head"])
def test_quantized_qwen3_is_not_tensor_parallel(what):
    """Quantized Qwen3 projections, the int8 embedding and the int8 lm_head
    raise under a mesh, naming the JAX package's own gap; nothing falls
    back."""
    from bitdance_tpu_torch.models import qwen3 as tq

    cfg = tq.Qwen3Config(vocab_size=128, hidden_size=64, intermediate_size=128,
                         num_hidden_layers=1, num_attention_heads=4, num_key_value_heads=2,
                         head_dim=16)
    model = tq.Qwen3Model(cfg, lm_head=what == "lm_head")
    if what in ("int8", "int4"):
        tq.quantized_structure_(model, what, embed_int8=False)
    else:
        tq.quantized_structure_(model, None, embed_int8=what == "embedding")
        if what == "lm_head":
            model.lm_head = tq.QLinear(64, 128)
    with pytest.raises(NotImplementedError, match="JAX package does not serve them"):
        ttp.shard_qwen3_(model, ttp.TPGroup(0, 2))


def test_int4_share_must_fill_the_s4_stages():
    """At the 14B head's shapes (meta tensors): tp 2's packed row shares
    (wo 2,560, w2 3,840 in-features) are whole 256-k stages and shard; tp
    4's w2 share of 1,920 is not, and raises off the CPU."""
    L, C, H = 6, 5120, 7680
    meta = dict(device="meta")
    stack = {"n2": torch.empty((L, 2, C), **meta), "b1": torch.empty((L, 2 * H), **meta)}
    for k, (n, k_in) in {"wqkv": (3 * C, C), "wo": (C, C), "w1": (2 * H, C),
                         "w2": (C, H)}.items():
        stack[k] = torch.empty((L, n, k_in // 2), dtype=torch.int8, **meta)
        stack[k + "_s"] = torch.empty((L, n), **meta)
    stack["bqkv"] = torch.empty((L, 3 * C), **meta)
    two = ttp.shard_head_stacked(stack, ttp.TPGroup(1, 2), 40)
    assert tuple(two["wo"].shape) == (L, C, C // 4) and tuple(two["w2"].shape) == (L, C, H // 4)
    assert tuple(two["w1"].shape) == (L, H, C // 2) and tuple(two["w1_s"].shape) == (L, H)
    with pytest.raises(ValueError, match="1920 in-features at tp 4"):
        ttp.shard_head_stacked(stack, ttp.TPGroup(0, 4), 40)
