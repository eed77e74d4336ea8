"""The release directory: the port's safetensors format against the
``safetensors`` package, its release readers, loader, export and CLI
against the JAX package's, both ways.

The tiny bundle and the offline tokenizer follow
tests/test_release_roundtrip.py; every weight is drawn (zero adaLN and final
layer would make the grids vacuous). Grids are compared as in
tests/test_torch_t2i.py: every gaussian draw on both sides comes from a
shape-keyed table, and the sign inputs must clear a 1e-3 margin before an
exact ±1 comparison. fp32 throughout (the loaders' dtype argument), so the
fp32 files round-trip exactly.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bitdance_tpu.io import torch_import as jti
from bitdance_tpu.models import qwen3 as jq
from bitdance_tpu.models.connector import MLPConnector as JConnector
from bitdance_tpu.models.diff_head import DiffHead as JHead
from bitdance_tpu.models.tokenizer import VQModel as JVQ
from bitdance_tpu.ops.rotary import pos_embed_2d as j_pos_embed_2d
from bitdance_tpu.pipelines import t2i as jt2i
from bitdance_tpu.train.checkpoints import export_hf_qwen3 as j_export_llm
from bitdance_tpu.train.checkpoints import export_release_dir as j_export_dir
from bitdance_tpu_torch.io import release as trel
from bitdance_tpu_torch.io import safetensors as tst
from bitdance_tpu_torch.io.from_jax import qwen3_state_from_jax
from bitdance_tpu_torch.models import diff_head as tdh
from bitdance_tpu_torch.ops.rotary import pos_embed_2d
from bitdance_tpu_torch.pipelines import t2i as tt2i
from bitdance_tpu_torch.pipelines.loader import load_t2i_pipeline
from bitdance_tpu_torch.train.checkpoints import export_hf_qwen3, export_release_dir
from tests.test_release_roundtrip import _make_tokenizer

safetensors_numpy = pytest.importorskip("safetensors.numpy")
safetensors_torch = pytest.importorskip("safetensors.torch")
ROOT = Path(__file__).resolve().parents[1]
torch.set_num_threads(2)

DD = dict(z_channels=8, in_channels=3, out_ch=3, ch=32, ch_mult=[1, 2],
          num_res_blocks=1)
LLM = dict(vocab_size=512, hidden_size=64, intermediate_size=128,
           num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
           head_dim=16)
HEAD_JSON = {"ch_target": 8, "ch_cond": 64, "ch_latent": 128, "depth_latent": 2,
             "depth_adanln": 2, "parallel_num": 4, "use_swiglu": True,
             "P_mean": -0.8, "P_std": 0.8}
# a plain-MLP TransEncoder head: the key left out, as config.py defaults it
PLAIN_HEAD_JSON = {k: v for k, v in HEAD_JSON.items() if k != "use_swiglu"}
NOISE_SEED = 49


# ---------------------------------------------------------------------------
# the file format
# ---------------------------------------------------------------------------

_DTYPES = {"F32": torch.float32, "BF16": torch.bfloat16, "F16": torch.float16,
           "I8": torch.int8, "I32": torch.int32}


def _tensors(code, seed=0):
    g = torch.Generator().manual_seed(seed)
    dt = _DTYPES[code]
    if dt.is_floating_point:
        make = lambda *s: torch.randn(s, generator=g).to(dt)  # noqa: E731
    else:
        make = lambda *s: torch.randint(-100, 100, s, generator=g).to(dt)  # noqa: E731
    return {"layer.0.weight": make(6, 5), "layer.0.bias": make(5), "scalar": make(),
            "odd": make(3, 1, 7)}


@pytest.mark.parametrize("code", sorted(_DTYPES))
def test_reads_what_the_package_writes(tmp_path, code):
    want = _tensors(code)
    path = tmp_path / "t.safetensors"
    if code == "BF16":
        safetensors_torch.save_file(want, str(path), metadata={"format": "pt"})
    else:
        safetensors_numpy.save_file({k: v.numpy() for k, v in want.items()},
                                    str(path), metadata={"format": "np"})
    got = tst.load_file(path)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("code", sorted(_DTYPES))
def test_package_reads_what_the_port_writes(tmp_path, code):
    want = {**_tensors(code), "mixed.int8": torch.arange(3, dtype=torch.int8)}
    path = tmp_path / "t.safetensors"
    tst.save_file(want, path)
    got = safetensors_torch.load_file(str(path))
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k
    cast = tmp_path / "c.safetensors"
    tst.save_file(want, cast, dtype=torch.float32)
    back = safetensors_torch.load_file(str(cast))
    assert back["mixed.int8"].dtype == torch.int8
    if want["scalar"].is_floating_point():
        assert back["odd"].dtype == torch.float32
        assert torch.equal(back["odd"], want["odd"].float())


# ---------------------------------------------------------------------------
# readers
# ---------------------------------------------------------------------------

def test_remap_ema_state_matches_jax():
    rng = np.random.default_rng(0)
    state = {k: rng.standard_normal(3).astype(np.float32) for k in
             ("enc.a.weight", "enc.b.bias", "model_ema.encaweight",
              "model_ema.unrelated")}
    want = jti.remap_ema_state(state)
    got = trel.remap_ema_state({k: torch.from_numpy(v) for k, v in state.items()})
    assert set(got) == set(want) == {"enc.a.weight", "enc.b.bias"}
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k])


def test_head_config_from_json_matches_jax():
    from bitdance_tpu.config import head_config_from_json as jcfg
    from bitdance_tpu_torch.config import head_config_from_json as tcfg

    for j in (HEAD_JSON, {k: v for k, v in HEAD_JSON.items()
                          if k in ("ch_target", "ch_cond", "ch_latent",
                                   "depth_latent", "depth_adanln")},
              dict(HEAD_JSON, time_shift=3.0, diff_batch_mul=4)):
        assert tcfg(j) == jcfg(j)


def test_load_state_refuses_unknown_keys():
    lin = torch.nn.Linear(3, 2)
    state = {"weight": torch.ones(2, 3), "bias": torch.zeros(2)}
    trel.load_state_(lin, dict(state, **{"net.final_layer.norm_final.weight":
                                         torch.ones(3)}))
    assert torch.equal(lin.weight, torch.ones(2, 3))
    with pytest.raises(KeyError, match="no module holds"):
        trel.load_state_(lin, dict(state, extra=torch.ones(1)))
    with pytest.raises(KeyError, match="missing"):
        trel.load_state_(lin, {"weight": torch.ones(2, 3)})


# ---------------------------------------------------------------------------
# the release directory, both ways
# ---------------------------------------------------------------------------

def _randomized(tree, seed, scale=0.05):
    leaves, treedef = jax.tree_util.tree_flatten(tree)
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_unflatten(treedef, [
        jnp.asarray(scale * rng.normal(size=l.shape), jnp.float32) for l in leaves])


def _jax_bundle(head_json=HEAD_JSON):
    cfg = jq.Qwen3Config(**LLM)
    llm = jq.init_qwen3_params(jax.random.PRNGKey(0), cfg, jnp.float32)
    head = JHead(**head_json)
    hp = _randomized(head.init(jax.random.PRNGKey(1), jnp.zeros((2, 4, 8)),
                               jnp.zeros((2, 4, 64)), jax.random.PRNGKey(2)), 3)
    ae = JVQ(ddconfig=DD)
    aep = ae.init(jax.random.PRNGKey(4), jnp.zeros((1, 8, 8, 3)))
    proj = JConnector(out_dim=64)
    pp = _randomized(proj.init(jax.random.PRNGKey(5), jnp.zeros((1, 8))), 6, 0.2)
    return jt2i.T2IModelBundle(
        llm_cfg=cfg, llm_params=llm, ae=ae, ae_params=aep, head=head,
        head_params=hp, projector=proj, projector_params=pp, parallel_num=4,
        hidden_size=64, vae_patch_size=2, pe_max_len=4096)


def _configs(head_json=HEAD_JSON):
    return {"ae_config": {"ddconfig": DD, "gan_decoder": False},
            "vision_head_config": head_json}


def _jax_release(tmp_path_factory, head_json):
    out = str(tmp_path_factory.mktemp("release") / "jax")
    jb = _jax_bundle(head_json)
    j_export_dir(out, ae_params=jb.ae_params, head_params=jb.head_params,
                 projector_params=jb.projector_params, configs=_configs(head_json))
    j_export_llm(jb.llm_params, jb.llm_cfg, out)
    tok = _make_tokenizer()
    tok.save_pretrained(out)
    return dict(dir=out, jb=jb, tok=tok)


@pytest.fixture(scope="module")
def release(tmp_path_factory):
    """A JAX export of the tiny bundle (with the tokenizer), the bundle, and
    the tokenizer."""
    return _jax_release(tmp_path_factory, HEAD_JSON)


def _shaped_noise(shape):
    seed = NOISE_SEED
    for d in shape:
        seed = (seed * 131 + int(d) + 7) % (2**31 - 1)
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _request(tok):
    """Prompt rows [cond; uncond] (left-padded), pads and image start ids
    of one 8 px request (4 x 4 latents at patch 2, parallel_num 4)."""
    from bitdance_tpu_torch.data.special_tokens import chatml_prompts, image_start_ids

    cond, uncond = (tok.encode(t) for t in chatml_prompts("a tiny cat"))
    P = max(len(cond), len(uncond))
    rows = [[0] * (P - len(r)) + r for r in (cond, uncond)]
    pads = [P - len(cond), P - len(uncond)]
    return rows, pads, image_start_ids(tok, 4, 4, 4)


def _jax_grid(jb, tok, monkeypatch):
    rows, pads, start = _request(tok)
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape=(), dtype=jnp.float32:
                        jnp.asarray(_shaped_noise(tuple(shape)), dtype))
    pe = j_pos_embed_2d(jt2i.build_pos_table(jb), 4, 4, 2)
    return np.asarray(jt2i.generate_tokens(
        jb, jnp.asarray(rows, jnp.int32), jnp.asarray(pads, jnp.int32),
        jnp.asarray(start, jnp.int32), pe, jax.random.PRNGKey(0), latent_h=4,
        latent_w=4, num_images=1, guidance_scale=2.0, num_sampling_steps=4))


def _port_noise_and_margins(monkeypatch):
    """Route the port's sampler draws to the shape-keyed table and return
    the list that collects each AR step's least |sign input|."""
    def table_noise(generator, half, ch, num_steps, device):
        t = torch.from_numpy(_shaped_noise((1, 4, ch))).reshape(half, ch)
        return t.clone(), t[None].repeat(num_steps, 1, 1)

    margins = []
    real_sign = tt2i.sign_quantize

    def spy_sign(x):
        margins.append(float(x.abs().min()))
        return real_sign(x)

    monkeypatch.setattr(tdh, "draw_sampler_noise", table_noise)
    monkeypatch.setattr(tt2i, "sign_quantize", spy_sign)
    return margins


def _port_grid(tb, tok, monkeypatch):
    rows, pads, start = _request(tok)
    margins = _port_noise_and_margins(monkeypatch)
    pe = pos_embed_2d(tt2i.build_pos_table(tb), 4, 4, 2)
    got = tt2i.generate_tokens(
        tb, torch.tensor(rows), torch.tensor(pads, dtype=torch.int32),
        torch.tensor(start), pe, torch.Generator(), latent_h=4, latent_w=4,
        num_images=1, guidance_scale=2.0, num_sampling_steps=4).numpy()
    assert len(margins) == 4 and min(margins) > 1e-3, (
        f"borderline sign margin {min(margins)}: pick another NOISE_SEED")
    return got


def test_jax_export_loads_into_the_port(release, monkeypatch):
    pipe = load_t2i_pipeline(release["dir"], dtype=torch.float32, device="cpu")
    b = pipe.bundle
    assert b.parallel_num == 4 and b.vae_patch_size == 2 and b.pe_max_len == 4096
    assert b.device.type == "cpu"
    # LLM weights round-trip exactly (fp32 -> safetensors -> fp32)
    want = qwen3_state_from_jax(release["jb"].llm_params)
    got = b.llm.state_dict()
    for k, v in got.items():
        np.testing.assert_array_equal(v.numpy(), want[k], err_msg=k)
    # the head's block weights are views into the sampler stack
    w1 = b.head.net.res_blocks[1].w1.weight
    assert w1.untyped_storage().data_ptr() == \
        b.head_stacked["w1"].untyped_storage().data_ptr()
    want_grid = _jax_grid(release["jb"], release["tok"], monkeypatch)
    got_grid = _port_grid(b, release["tok"], monkeypatch)
    assert got_grid.shape == want_grid.shape == (1, 16, 8)
    np.testing.assert_array_equal(got_grid, want_grid, err_msg="±1 grids diverge")
    # the VQ decoder came through too (fp32; the order of the sums differs)
    img_j = np.asarray(jt2i.decode_image(release["jb"], jnp.asarray(want_grid), 4, 4))
    img_t = tt2i.decode_image(b, torch.from_numpy(got_grid), 4, 4).numpy()
    np.testing.assert_allclose(img_t, img_j, rtol=2e-4, atol=2e-4)


def test_port_export_loads_into_jax(release, tmp_path, monkeypatch):
    from bitdance_tpu.pipelines.loader import load_t2i_pipeline as j_load

    b = load_t2i_pipeline(release["dir"], dtype=torch.float32, device="cpu").bundle
    out = str(tmp_path / "port")
    export_release_dir(out, ae=b.ae, head=b.head, projector=b.projector,
                       configs=_configs())
    export_hf_qwen3(b.llm, out)
    release["tok"].save_pretrained(out)
    jpipe = j_load(out, dtype=jnp.float32)
    jb, ob = jpipe.bundle, release["jb"]
    for name in ("q_proj", "gate_proj", "input_layernorm"):
        np.testing.assert_array_equal(np.asarray(jb.llm_params["layers"][name]),
                                      np.asarray(ob.llm_params["layers"][name]))
    np.testing.assert_array_equal(np.asarray(jb.llm_params["embed_tokens"]),
                                  np.asarray(ob.llm_params["embed_tokens"]))
    jax.tree_util.tree_map(np.testing.assert_array_equal, jb.head_params,
                           ob.head_params)
    np.testing.assert_array_equal(_jax_grid(jb, release["tok"], monkeypatch),
                                  _jax_grid(ob, release["tok"], monkeypatch))


def test_sharded_llm_directory(release, tmp_path):
    """model.safetensors.index.json with two shards reads as the one file."""
    state, cfg = trel.load_hf_qwen3_dir(release["dir"])
    keys = sorted(state)
    shards = {"model-00001-of-00002.safetensors": keys[:len(keys) // 2],
              "model-00002-of-00002.safetensors": keys[len(keys) // 2:]}
    for name, ks in shards.items():
        tst.save_file({k: state[k] for k in ks}, tmp_path / name)
    (tmp_path / "config.json").write_text(json.dumps(cfg))
    (tmp_path / "model.safetensors.index.json").write_text(json.dumps(
        {"weight_map": {k: n for n, ks in shards.items() for k in ks}}))
    got, got_cfg = trel.load_hf_qwen3_dir(str(tmp_path))
    assert got_cfg == cfg and set(got) == set(state)
    for k in keys:
        assert torch.equal(got[k], state[k]), k


def test_cli_writes_a_png(release, tmp_path):
    from PIL import Image

    out = tmp_path / "cat.png"
    res = subprocess.run(
        [sys.executable, "-m", "bitdance_tpu_torch.cli.t2i", release["dir"],
         "--prompt", "a tiny cat", "--resolution", "8", "--steps", "2",
         "--cfg", "3.0", "--seed", "5", "--dtype", "float32", "--device", "cpu",
         "--out", str(out)],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, OMP_NUM_THREADS="2"))
    assert res.returncode == 0, res.stderr[-3000:]
    img = np.asarray(Image.open(out).convert("RGB"))
    pipe = load_t2i_pipeline(release["dir"], dtype=torch.float32, device="cpu")
    want = pipe.generate("a tiny cat", 8, 8, num_sampling_steps=2,
                         guidance_scale=3.0, seed=5)
    assert img.shape == (8, 8, 3)
    np.testing.assert_array_equal(img, want[0])


def test_loader_without_transformers_asks_for_a_tokenizer(release, monkeypatch):
    import builtins

    real_import = builtins.__import__

    def no_transformers(name, *a, **k):
        if name.startswith("transformers"):
            raise ImportError(name)
        return real_import(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_transformers)
    with pytest.raises(RuntimeError, match="pass tokenizer="):
        load_t2i_pipeline(release["dir"], dtype=torch.float32, device="cpu")
    pipe = load_t2i_pipeline(release["dir"], dtype=torch.float32, device="cpu",
                             tokenizer=release["tok"])
    assert pipe.tokenizer is release["tok"]


@pytest.fixture(scope="module")
def plain_release(tmp_path_factory):
    """The tiny export with a plain-MLP head (no ``use_swiglu`` key)."""
    return _jax_release(tmp_path_factory, PLAIN_HEAD_JSON)


def test_plain_mlp_release_serves_like_jax(plain_release, monkeypatch):
    """A release whose head JSON has no ``use_swiglu`` loads, and
    T2IPipeline.generate serves it: DiffHead.sample takes the per-call
    route (there is no sampler stack), as the JAX pipeline sends such a head
    to euler_maruyama. Grids exact (sign inputs clear 1e-3), images within
    one level (fp32 decoders, sums in another order)."""
    from bitdance_tpu.pipelines.loader import load_t2i_pipeline as j_load

    pipe = load_t2i_pipeline(plain_release["dir"], dtype=torch.float32, device="cpu")
    assert not pipe.bundle.head.stackable and pipe.bundle.head_stacked is None
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape=(), dtype=jnp.float32:
                        jnp.asarray(_shaped_noise(tuple(shape)), dtype))
    want_img, want = j_load(plain_release["dir"], dtype=jnp.float32).generate(
        "a tiny cat", 8, 8, num_sampling_steps=4, guidance_scale=2.0,
        return_tokens=True)
    margins = _port_noise_and_margins(monkeypatch)
    got_img, got = pipe.generate("a tiny cat", 8, 8, num_sampling_steps=4,
                                 guidance_scale=2.0, return_tokens=True)
    assert len(margins) == 4 and min(margins) > 1e-3, (
        f"borderline sign margin {min(margins)}: pick another NOISE_SEED")
    assert got.shape == np.asarray(want).shape == (1, 16, 8)
    np.testing.assert_array_equal(got, np.asarray(want), err_msg="±1 grids diverge")
    assert np.abs(got_img.astype(int) - np.asarray(want_img).astype(int)).max() <= 1


class _TwoWayTP:
    """A mesh stub whose "tp" axis has two ranks (parallel/mesh.py::tp_group
    reads no more of it)."""

    def size(self, dim):
        return 2 if dim == 2 else 1

    def get_local_rank(self, name):
        return 0

    def get_group(self, name):
        return None


def test_plain_mlp_head_refuses_tensor_parallel_serving(plain_release):
    """The per-call sampler has no tensor-parallel form: shard_bundle_ says
    so before it touches the bundle."""
    b = load_t2i_pipeline(plain_release["dir"], dtype=torch.float32, device="cpu").bundle
    before = b.llm.model.layers[0].self_attn.q_proj.weight.shape
    with pytest.raises(NotImplementedError, match="plain-MLP head"):
        tt2i.shard_bundle_(b, _TwoWayTP())
    assert b.llm.model.layers[0].self_attn.q_proj.weight.shape == before
