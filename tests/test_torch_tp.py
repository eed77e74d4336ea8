"""Tensor-parallel serving in the port (bitdance_tpu_torch/parallel/tp.py,
T2IPipeline(mesh=...)) on the CPU over gloo, against the JAX package run
single-device in the test process: the counterparts of tests/test_tp.py.

  - qwen3_forward sharded over the mesh against JAX's replicated forward at
    rtol = atol = 1e-4 (test_tp.py's tolerance), the q projection split;
  - the placement table at test_tp.py's indivisible config beside JAX's
    shardings, with the whole-head rule's differences stated;
  - T2I serving over the mesh against JAX's single-device images, > 0.99
    of the pixels equal (test_tp.py's bound);
  - head-TP serving on the 4-head tiny head token-exact against JAX's
    stacked sampler, wqkv / w1 / wo / w2 split, every sign input clear of
    1e-3 (the guard of tests/test_reference_parity.py:472);
  - reorder_stacked_head_major and the head-major plain sampler equal the
    canonical sampler bit for bit (JAX tp.py's "pure permutation").

Ranks are spawned by tests/test_torch_parallel.py's ``spawn`` (gloo from a
file store, 300 s deadline). Each mesh, (1, 1, 4) and (1, 2, 2), is one
world-4 spawn that runs every check and hands its results back through
files; the JAX weights, inputs and outputs reach the ranks through the
same workdir. Noise on both sides comes from shape-keyed tables (the
pattern of tests/test_torch_t2i.py).
"""

import os

import numpy as np
import pytest
import torch

from bitdance_tpu_torch.parallel import tp as ttp

torch.set_num_threads(2)
MESHES = {"1x1x4": (1, 1, 4), "1x2x2": (1, 2, 2)}
PROMPT = "a tp parity test prompt"
T2I_GEN = dict(height=8, width=8, num_sampling_steps=6, guidance_scale=3.0,
               num_images=2, seed=7)
HEAD_PROMPT = "a head tp test prompt"
HEAD_GEN = dict(height=8, width=8, num_sampling_steps=4, guidance_scale=2.0,
                num_images=1, seed=11)
LLM = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
           num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
           head_dim=16)
TINY_DD = dict(z_channels=8, in_channels=3, out_ch=3, ch=32, ch_mult=[1, 2],
               num_res_blocks=1)
NOISE_SEED = 27   # every sign input of the head-TP run clears SIGN_MARGIN
SIGN_MARGIN = 1e-3


def _shaped_noise(shape):
    seed = NOISE_SEED
    for d in shape:
        seed = (seed * 131 + int(d) + 7) % (2**31 - 1)
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


class StubTokenizer:
    """tests/test_t2i_pipeline.py's char-level stub, for both packages."""

    def __init__(self):
        toks = (["<|vision_start|>"] + [f"<|res_{j}|>" for j in range(1, 65)]
                + [f"<|query_{j}|>" for j in range(1, 64)])
        self.special = {t: 200 + i for i, t in enumerate(toks)}

    def encode(self, text):
        return [min(ord(c), 199) for c in text][:48]

    def convert_tokens_to_ids(self, tok):
        return self.special[tok]


# ---------------------------------------------------------------------------
# the ranks
# ---------------------------------------------------------------------------

def _em_noise(generator, half, ch, num_steps, device):
    """JAX's per-call euler_maruyama draws x0 and each step's noise at [n,
    p, ch] (p = 4), all one table."""
    t = torch.from_numpy(_shaped_noise((half // 4, 4, ch))).reshape(half, ch)
    return t.clone(), t[None].repeat(num_steps, 1, 1)


def _stacked_noise(generator, half, ch, num_steps, device):
    """JAX's stacked sampler draws x0 [half, ch] and noise [steps, half, ch]."""
    return (torch.from_numpy(_shaped_noise((half, ch))),
            torch.from_numpy(_shaped_noise((num_steps, half, ch))))


def _bundle(states, attn_head_dim=128):
    from bitdance_tpu_torch.io.from_jax import load_into
    from bitdance_tpu_torch.models import diff_head as tdh
    from bitdance_tpu_torch.models import qwen3 as tq
    from bitdance_tpu_torch.models.connector import MLPConnector
    from bitdance_tpu_torch.models.tokenizer import VQModel
    from bitdance_tpu_torch.pipelines import t2i as tt2i

    head = load_into(tdh.DiffHead(ch_target=8, ch_cond=64, ch_latent=128, depth_latent=2,
                                  depth_adanln=2, parallel_num=4,
                                  attn_head_dim=attn_head_dim), states["head"])
    return tt2i.T2IModelBundle(
        llm=load_into(tq.Qwen3Model(tq.Qwen3Config(**states["llm_cfg"])), states["llm"]),
        ae=load_into(VQModel(states["dd"]), states["ae"]), head=head,
        projector=load_into(MLPConnector(8, 64), states["proj"]), parallel_num=4,
        hidden_size=64, vae_patch_size=2, pe_max_len=128)


def _forward_case(mesh, ref) -> dict:
    from bitdance_tpu_torch.io.from_jax import load_into
    from bitdance_tpu_torch.models import qwen3 as tq
    from bitdance_tpu_torch.parallel import mesh as tmesh

    model = load_into(tq.Qwen3Model(tq.Qwen3Config(**LLM), lm_head=True), ref["fwd_llm"])
    ttp.shard_qwen3_(model, tmesh.tp_group(mesh))
    if tmesh.data_size(mesh) > 1:
        tmesh.shard_model(model, mesh)
        model.unshard()
    i = {k: torch.from_numpy(v) for k, v in ref["fwd_in"].items()}
    with torch.no_grad():
        x = tq.embed_tokens(model, i["ids"])
        out = tq.qwen3_forward(model, x, i["pos"], i["blk"], i["doc"])
        logits = tq.lm_logits(model, out)
    with tq.gathered(model.model.layers[0]) as layer:
        shapes = {n: tuple(getattr(layer.self_attn, n).weight.shape)
                  for n in ("q_proj", "k_proj", "o_proj")}
        shapes["gate_proj"] = tuple(layer.mlp.gate_proj.weight.shape)
    return {"embeds": x.numpy(), "out": out.numpy(), "logits": logits.numpy(),
            "shapes": shapes, "embed_rows": model.model.embed_tokens.weight.shape[0],
            "lm_rows": model.lm_head.weight.shape[0]}


def _serve(mesh, bundle, noise, prompt, gen) -> dict:
    from bitdance_tpu_torch.models import diff_head as tdh
    from bitdance_tpu_torch.pipelines import t2i as tt2i

    margins = []
    real_noise, real_sign = tdh.draw_sampler_noise, tt2i.sign_quantize

    def spy_sign(x):
        margins.append(float(x.abs().min()))
        return real_sign(x)

    tdh.draw_sampler_noise, tt2i.sign_quantize = noise, spy_sign
    try:
        pipe = tt2i.T2IPipeline(bundle, StubTokenizer(), mesh=mesh)
        img, tok = pipe.generate(prompt, return_tokens=True, **gen)
    finally:
        tdh.draw_sampler_noise, tt2i.sign_quantize = real_noise, real_sign
    hs = pipe.bundle.head_stacked
    return {"images": img, "tokens": tok, "margin": min(margins),
            "last_tp": pipe.last_tp, "hm_marker": "hm_marker" in hs,
            "placements": dict(hs["tp"].placements),
            "stacked": {k: tuple(hs[k].shape) for k in ("wqkv", "w1", "wo", "w2")},
            "q_proj": tuple(pipe.bundle.llm.model.layers[0].self_attn.q_proj.weight.shape)}


def tp_task(rank, world, workdir):
    from bitdance_tpu_torch.parallel import mesh as tmesh

    ref = torch.load(os.path.join(workdir, "refs.pt"), weights_only=False)
    mesh = tmesh.create_mesh(*ref["mesh"], device_type="cpu")
    tp = tmesh.tp_group(mesh)
    return {"tp": (tp.rank, tp.size), "mesh": tuple(mesh.shape),
            "forward": _forward_case(mesh, ref),
            "t2i": _serve(mesh, _bundle(ref["t2i"]), _em_noise, PROMPT, T2I_GEN),
            "head_tp": _serve(mesh, _bundle(ref["t2i"], attn_head_dim=32), _stacked_noise,
                              HEAD_PROMPT, HEAD_GEN)}


# ---------------------------------------------------------------------------
# the JAX side and the worlds
# ---------------------------------------------------------------------------

def _jax_bundle():
    """tests/test_t2i_pipeline.py's tiny bundle, built faster: the LLM and
    the VQ decoder as flax initialises them (the decoder alone, jitted), the
    head and the connector drawn N(0, 0.05) and N(0, 0.2) into their flax
    trees (the flax head's zero final layer would make every token the sign
    of rounding noise)."""
    import jax
    import jax.numpy as jnp

    from bitdance_tpu.models import qwen3 as q3
    from bitdance_tpu.models.connector import MLPConnector
    from bitdance_tpu.models.diff_head import DiffHead
    from bitdance_tpu.models.tokenizer import VQModel
    from bitdance_tpu.pipelines.t2i import T2IModelBundle

    def drawn(shapes, seed, scale):
        rng = np.random.default_rng(seed)
        return jax.tree_util.tree_map(
            lambda l: jnp.asarray(scale * rng.standard_normal(l.shape), jnp.float32), shapes)

    cfg = q3.Qwen3Config(**dict(LLM, vocab_size=512))
    ae = VQModel(ddconfig=TINY_DD)
    head = DiffHead(ch_target=8, ch_cond=64, ch_latent=128, depth_latent=2, depth_adanln=2,
                    parallel_num=4, use_swiglu=True, P_mean=-0.8, P_std=0.8)
    proj = MLPConnector(out_dim=64)
    key = jax.random.PRNGKey(2)
    return T2IModelBundle(
        llm_cfg=cfg, llm_params=q3.init_qwen3_params(jax.random.PRNGKey(0), cfg),
        ae=ae, ae_params=jax.jit(lambda k: ae.init(k, jnp.zeros((1, 4, 4, 8)),
                                                   method=VQModel.decode))(jax.random.PRNGKey(1)),
        head=head, head_params=drawn(jax.eval_shape(lambda k: head.init(
            k, jnp.zeros((2, 4, 8)), jnp.zeros((2, 4, 64)), k), key), 3, 0.05),
        projector=proj, projector_params=drawn(jax.eval_shape(lambda k: proj.init(
            k, jnp.zeros((1, 8))), key), 6, 0.2),
        parallel_num=4, hidden_size=64, vae_patch_size=2, pe_max_len=128)


@pytest.fixture(scope="module")
def jax_refs():
    """JAX's single-device outputs of the three serving checks, and the
    weights and inputs the ranks load."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    from bitdance_tpu.models import qwen3 as q3
    from bitdance_tpu.models.diff_head import DiffHead
    from bitdance_tpu.ops.attention import causal_ids
    from bitdance_tpu.pipelines.t2i import T2IPipeline
    from bitdance_tpu_torch.io.from_jax import flax_state_from_jax, qwen3_state_from_jax

    cfg = q3.Qwen3Config(**LLM)
    params = q3.init_qwen3_params(jax.random.PRNGKey(0), cfg)
    ids = jax.random.randint(jax.random.PRNGKey(1), (2, 12), 0, 128)
    x = q3.embed_tokens(params, ids)
    pos = jnp.tile(jnp.arange(12)[None], (2, 1))
    blk, doc = causal_ids(12)
    blk, doc = jnp.tile(blk[None], (2, 1)), jnp.tile(doc[None], (2, 1))
    fwd = q3.qwen3_forward(params, cfg, x, pos, blk, doc)
    logits = np.asarray(q3.lm_logits(params, cfg, fwd))
    fwd = np.asarray(fwd)
    fwd_in = {k: np.asarray(v) for k, v in
              dict(ids=ids, pos=pos, blk=blk, doc=doc).items()}
    fwd_llm = {k: np.asarray(v) for k, v in qwen3_state_from_jax(params).items()}

    b = _jax_bundle()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "normal", lambda key, shape=(), dtype=jnp.float32:
                   jnp.asarray(_shaped_noise(tuple(shape)), dtype))
        images = T2IPipeline(b, tokenizer=StubTokenizer(), force_one_program=True).generate(
            PROMPT, **T2I_GEN)
        head4 = b.head.clone(attn_head_dim=32)
        stacked = head4.apply(b.head_params, method=DiffHead._stack_for_sampler)
        b4 = dataclasses.replace(b, head=head4, head_params=None, head_stacked=stacked)
        _, head_tokens = T2IPipeline(b4, tokenizer=StubTokenizer(),
                                     force_one_program=True).generate(
            HEAD_PROMPT, return_tokens=True, **HEAD_GEN)
    llm = {k: np.asarray(v) for k, v in qwen3_state_from_jax(b.llm_params).items()}
    states = {"llm": llm, "llm_cfg": dataclasses.asdict(b.llm_cfg),
              "head": flax_state_from_jax(b.head_params), "ae": flax_state_from_jax(b.ae_params),
              "proj": flax_state_from_jax(b.projector_params), "dd": dict(TINY_DD)}
    return {"fwd": fwd, "logits": logits, "x": np.asarray(x), "fwd_in": fwd_in,
            "fwd_llm": fwd_llm, "images": np.asarray(images),
            "head_tokens": np.asarray(head_tokens), "t2i": states}


@pytest.fixture(scope="module")
def worlds(jax_refs, tmp_path_factory):
    from tests.test_torch_parallel import spawn

    out = {}
    for name, shape in MESHES.items():
        root = tmp_path_factory.mktemp(f"tp_{name}")
        torch.save({**jax_refs, "mesh": shape}, root / "refs.pt")
        out[name] = spawn(tp_task, 4, root)
    return out


# ---------------------------------------------------------------------------
# the counterparts of tests/test_tp.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh", MESHES)
def test_tp_sharded_forward_matches_replicated(worlds, jax_refs, mesh):
    """qwen3_forward of the sharded model against JAX's replicated forward,
    with the q projection (and the MLP and embedding) actually split: at tp
    4 each rank keeps 1 of the 4 q heads and the 1 kv head it reads, at tp 2
    two q heads and their one kv head. The vocabulary-parallel lookup gives
    JAX's embeddings exactly; the column-parallel lm_head's gathered logits
    JAX's lm_logits within the same tolerance."""
    tp = MESHES[mesh][2]
    for r in worlds[mesh]:
        f = r["forward"]
        np.testing.assert_array_equal(f["embeds"], jax_refs["x"])
        np.testing.assert_allclose(f["out"], jax_refs["fwd"], rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(f["logits"], jax_refs["logits"], rtol=1e-4, atol=1e-4)
        assert f["lm_rows"] == 128 // tp
        assert f["shapes"]["q_proj"] == (64 // tp, 64)
        assert f["shapes"]["k_proj"] == (16, 64)
        assert f["shapes"]["o_proj"] == (64, 64 // tp)
        assert f["shapes"]["gate_proj"] == (128 // tp, 64)
        assert f["embed_rows"] == 128 // tp
    assert [r["tp"] for r in worlds[mesh]] == [(i % tp, tp) for i in range(4)]
    assert all(r["mesh"] == MESHES[mesh] for r in worlds[mesh])


def test_tp_rules_fall_back_on_indivisible():
    """test_tp.py's indivisible config at tp 8 (vocab 126, intermediate
    130, 4 q / 2 kv heads of 16): the MLP and the embedding stay whole, as
    in JAX. Where the rules differ: JAX splits q / k / v / o by column count
    (64 and 32 columns divide by 8, cutting inside heads), the whole-head
    rule keeps attention whole (8 does not divide 4 heads)."""
    import jax

    from bitdance_tpu.models import qwen3 as q3
    from bitdance_tpu.parallel.mesh import create_mesh
    from bitdance_tpu.parallel.tp import qwen3_tp_shardings

    jcfg = q3.Qwen3Config(vocab_size=126, hidden_size=64, intermediate_size=130,
                          num_hidden_layers=1, num_attention_heads=4,
                          num_key_value_heads=2, head_dim=16)
    sh = qwen3_tp_shardings(q3.init_qwen3_params(jax.random.PRNGKey(0), jcfg),
                            create_mesh(replica=1, fsdp=1, tp=8))
    jax_split = {n: "tp" in str(sh["layers"][n].spec)
                 for n in ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj",
                           "up_proj", "down_proj")}
    jax_split["embed_tokens"] = "tp" in str(sh["embed_tokens"].spec)
    assert jax_split == {"q_proj": True, "k_proj": True, "v_proj": True, "o_proj": True,
                         "gate_proj": False, "up_proj": False, "down_proj": False,
                         "embed_tokens": False}
    got = ttp.qwen3_tp_placements(jcfg, 8)
    assert all(v is None for v in got.values()), got
    differ = {n for n, split in jax_split.items() if split != (got[n] is not None)}
    assert differ == {"q_proj", "k_proj", "v_proj", "o_proj"}
    # where the heads divide, the port splits as JAX does, kv heads kept
    # as read where they do not (tp 4: 4 q heads, 2 kv heads)
    assert ttp.qwen3_tp_placements(jcfg, 4)["k_proj"] == ttp.KV_READ
    assert ttp.qwen3_tp_placements(jcfg, 2) == {
        **dict.fromkeys(got), "q_proj": 0, "k_proj": 0, "v_proj": 0, "o_proj": 1,
        "gate_proj": 0, "up_proj": 0, "down_proj": 1, "embed_tokens": 0, "lm_head": 0}


@pytest.mark.parametrize("hq, hkv, tp, want", [
    (40, 8, 2, [[0, 1, 2, 3], [4, 5, 6, 7]]),          # the 14B at tp 2: 20 q / 4 kv
    (4, 2, 4, [[0], [0], [1], [1]]),
    (12, 3, 6, [[0], [0], [1], [1], [2], [2]]),
    (40, 8, 5, [[0, 0, 0, 0, 0, 1, 1, 1], [1, 1, 2, 2, 2, 2, 2, 3],
                [3, 4], [4, 5, 5, 5, 5, 5, 6, 6],
                [6, 6, 6, 7, 7, 7, 7, 7]]),
])
def test_kv_heads_read(hq, hkv, tp, want):
    """Each rank's kv heads: its share where tp divides them, else those
    its q heads read, once each where they read them in equal runs, else
    one for each q head."""
    got = [ttp.kv_heads_read(r, hq, hkv, tp) for r in range(tp)]
    assert got == want


@pytest.mark.parametrize("mesh", MESHES)
def test_tp_t2i_serving_matches_single_device(worlds, jax_refs, mesh):
    """T2IPipeline(mesh=) against JAX's single-device images (the head has
    one 128-wide head, so only its wo / w2 rows split), every rank the same
    images, the all-reduces counted."""
    want = jax_refs["images"]
    tp = MESHES[mesh][2]
    for r in worlds[mesh]:
        got = r["t2i"]
        assert got["images"].shape == want.shape and got["images"].dtype == want.dtype
        agree = float(np.mean(got["images"] == want))
        assert agree > 0.99, f"TP images diverge from single-device: {agree:.4f}"
        np.testing.assert_array_equal(got["images"], worlds[mesh][0]["t2i"]["images"])
        assert got["hm_marker"]
        assert got["placements"] == {"wqkv": None, "bqkv": None, "w1": None, "b1": None,
                                     "wo": "row", "w2": "row"}
        assert got["stacked"]["wo"] == (2, 128, 128 // tp)
        assert got["last_tp"]["all_reduces"] > 0
        assert got["q_proj"] == (64 // tp, 64)


@pytest.mark.parametrize("mesh", MESHES)
def test_head_tp_stacked_serving_token_exact(worlds, jax_refs, mesh):
    """Head TP on the 4-head tiny head: wqkv, w1 (column-parallel, whole
    heads) and wo, w2 (row-parallel) split; tokens equal JAX's stacked
    sampler's exactly, every sign input clear of the margin."""
    tp = MESHES[mesh][2]
    for r in worlds[mesh]:
        got = r["head_tp"]
        assert got["margin"] > SIGN_MARGIN, (
            f"borderline sign margin {got['margin']}: pick another NOISE_SEED")
        assert got["stacked"] == {"wqkv": (2, 384 // tp, 128), "w1": (2, 384 // tp, 128),
                                  "wo": (2, 128, 128 // tp), "w2": (2, 128, 192 // tp)}
        assert set(got["placements"].values()) == {"col", "row"}
        np.testing.assert_array_equal(got["tokens"], jax_refs["head_tokens"])


@pytest.mark.parametrize("attention", [True, False], ids=["trans_encoder", "mlp_encoder"])
def test_head_major_reorder_is_a_permutation(attention):
    """reorder_stacked_head_major plus the head-major sampler on one device
    equals the canonical sampler bit for bit on the fp32-residual route,
    with each product summed as the head GEMM splits it, for both head
    families (qkv and w1 reordered, or w1 alone)."""
    from bitdance_tpu_torch.models import diff_head as tdh
    from bitdance_tpu_torch.ops import fused_head as fh

    g = torch.Generator().manual_seed(0)
    head = tdh.DiffHead(ch_target=8, ch_cond=256, ch_latent=512, depth_latent=2,
                        depth_adanln=1, parallel_num=4, attn_head_dim=128,
                        attention=attention, dtype=torch.bfloat16)
    with torch.no_grad():
        for p in head.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.05)
    stacked = head._stack_for_sampler()
    hm = ttp.reorder_stacked_head_major(stacked, 4)
    assert "hm_marker" in hm and not torch.equal(hm["w1"], stacked["w1"])
    if attention:
        assert not torch.equal(hm["wqkv"], stacked["wqkv"])
    rows, steps = 8, 3
    x0 = torch.randn((rows // 2, 8), generator=g)
    noise = torch.randn((steps, rows // 2, 8), generator=g)
    c_emb = torch.randn((rows, 512), generator=g)
    t_all = torch.linspace(0.0, 0.95, steps + 1)
    dt_all = torch.cat([t_all[1:] - t_all[:-1], torch.zeros(1)])
    allmods = fh.em_precompute(stacked, c_emb, t_all)
    splits = {k: p.splits for k, p in fh.sampler_plans(rows, 512, 768, attention).items()}
    kw = dict(num_blocks=2, num_ada=1, n_head=4, groups=2 if attention else 1,
              attention=attention, bounded=True)
    want = fh.fused_em_sample_reference(stacked, x0, noise, allmods, t_all, dt_all, 2.0,
                                        round_residual=False, splits=splits, **kw)
    got = fh.em_sample_stacked(hm, x0, noise, allmods, t_all, dt_all, 2.0, **kw)
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="head-major"):
        fh.fused_em_sample_reference(hm, x0, noise, allmods, t_all, dt_all, 2.0, **kw)
