"""The port's DPG and GenEval harnesses (bitdance_tpu_torch/eval) on the CPU,
against the JAX package's (bitdance_tpu/eval, tests/test_eval_harnesses.py).

  - On tests/test_eval_harnesses.py's stub pipeline and the stub assets (and
    the vendored DPG prompts, cut by max_prompts), both harnesses write the
    same file tree, every PNG and metadata file byte for byte (the port's
    PNG writer reproduces Pillow's bytes).
  - Through the tiny real pipelines, the JAX T2IPipeline and the port's
    loaded from one JAX export (tests/test_torch_release.py's, fp32), with
    every gaussian draw on both sides from a shape-keyed table and every
    sign input clear of SIGN_MARGIN: the ±1 tokens of each harness call
    equal, the grids within one level (fp32 decoders, sums in another
    order).
  - ``shard`` and the seed equal JAX's BaseEvaluator at worlds 1-3.
  - A world-2 gloo run of the DPG harness (tests/test_torch_parallel.py's
    ``spawn``): the ranks' files together are the world-1 tree's names,
    each rank's grids drawn with its own seed.
  - ``eval.dpg.main`` / ``eval.geneval.main`` on the export write the layout,
    their grids equal to the evaluators run in-process.
"""

import json
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bitdance_tpu.eval.dpg import DPGEvaluator as JDPG
from bitdance_tpu.eval.geneval import GenevalEvaluator as JGeneval
from bitdance_tpu_torch.eval import base as tbase
from bitdance_tpu_torch.eval.dpg import DPGEvaluator
from bitdance_tpu_torch.eval.geneval import GenevalEvaluator

ASSETS = Path(__file__).resolve().parents[1] / "eval_assets"
DPG_STUB = str(ASSETS / "dpg_stub_prompts.json")
GENEVAL_STUB = str(ASSETS / "geneval_stub_metadata.jsonl")
NOISE_SEED = 71       # every sign input of the real-pipeline runs clears SIGN_MARGIN
SIGN_MARGIN = 1e-3
REAL_PROMPTS = {"cat": "a tiny cat", "square": "a red square"}
REAL_GEN = dict(guidance_scale=2.0, num_sampling_steps=4, image_size=(8, 8))
torch.set_num_threads(2)


class StubPipeline:
    """tests/test_eval_harnesses.py's stub: seeded uint8 noise images."""

    def __init__(self):
        self.calls = []

    def generate(self, prompt, height, width, num_sampling_steps, guidance_scale,
                 num_images, seed):
        self.calls.append((prompt, guidance_scale, num_sampling_steps, seed))
        rng = np.random.default_rng(seed)
        return rng.integers(0, 255, (num_images, height, width, 3), dtype=np.uint8)


def _tree(root) -> dict:
    """{relative path: bytes} of every file under ``root``."""
    root = Path(root)
    return {str(p.relative_to(root)): p.read_bytes() for p in sorted(root.rglob("*"))
            if p.is_file()}


def _png(path) -> np.ndarray:
    from PIL import Image

    return np.asarray(Image.open(path).convert("RGB"))


# ---------------------------------------------------------------------------
# the stub pipeline: byte-equal trees
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["dpg_stub", "dpg_real", "geneval_stub"])
def test_harness_writes_the_jax_tree(tmp_path, case):
    """Both packages' harnesses on the same stub pipeline and data: the same
    files, byte for byte, and the same generate calls."""
    kind, data = case.split("_")
    path = {"dpg_stub": DPG_STUB, "dpg_real": str(ASSETS / "dpg" / "prompts.json"),
            "geneval_stub": GENEVAL_STUB}[case]
    kw = dict(guidance_scale=7.5 if kind == "dpg" else 13.0, num_sampling_steps=4,
              image_size=(16, 24))
    trees, calls = [], []
    for cls in ((JDPG, DPGEvaluator) if kind == "dpg" else (JGeneval, GenevalEvaluator)):
        pipe, out = StubPipeline(), tmp_path / cls.__module__.split(".")[0]
        ev = cls("unused", pipeline=pipe)
        if data == "real":
            ev.eval(path, str(out), max_prompts=3, **kw)
        else:
            ev.eval(path, str(out), **kw)
        trees.append(_tree(out))
        calls.append(pipe.calls)
    jax_tree, port_tree = trees
    assert len(jax_tree) == {"dpg": 3, "geneval": 2 * 6}[kind]
    assert sorted(port_tree) == sorted(jax_tree)
    for name in jax_tree:
        assert port_tree[name] == jax_tree[name], name
    assert calls[1] == calls[0]
    if kind == "dpg":
        assert _png(next(iter((tmp_path / "bitdance_tpu_torch").glob("*.png")))).shape \
            == (32, 48, 3)


def test_save_grid_pads_a_short_last_row(tmp_path):
    """Three images in two columns: the fourth cell black, as JAX writes."""
    from bitdance_tpu.eval.base import save_grid as j_save_grid

    imgs = np.random.default_rng(0).integers(0, 256, (3, 5, 7, 3), dtype=np.uint8)
    j_save_grid(imgs, str(tmp_path / "j.png"))
    tbase.save_grid(imgs, str(tmp_path / "t" / "g.png"))
    assert (tmp_path / "t" / "g.png").read_bytes() == (tmp_path / "j.png").read_bytes()


# ---------------------------------------------------------------------------
# shard and seed
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("world", [1, 2, 3])
def test_shard_and_seed_match_jax(monkeypatch, world):
    import torch.distributed as dist

    from bitdance_tpu.eval.base import BaseEvaluator as JBase

    items = list(range(10))
    for rank in range(world):
        monkeypatch.setattr(jax, "process_index", lambda r=rank: r)
        monkeypatch.setattr(jax, "process_count", lambda w=world: w)
        monkeypatch.setattr(dist, "is_initialized", lambda: True)
        monkeypatch.setattr(dist, "get_rank", lambda group=None, r=rank: r)
        monkeypatch.setattr(dist, "get_world_size", lambda group=None, w=world: w)
        j, t = JBase("unused", pipeline=object()), tbase.BaseEvaluator("unused", object())
        assert (t.rank, t.world_size, t.seed) == (j.rank, j.world_size, j.seed) \
            == (rank, world, 4396 * world + rank)
        for n in (0, 1, 2, 3, 10):
            assert t.shard(items[:n]) == j.shard(items[:n])
    monkeypatch.undo()
    assert tbase.BaseEvaluator("unused", object()).seed == 4396


# ---------------------------------------------------------------------------
# world 2 over gloo
# ---------------------------------------------------------------------------

def dpg_rank(rank, world, workdir):
    pipe = StubPipeline()
    ev = DPGEvaluator("unused", pipeline=pipe, device="cpu")
    ev.eval(DPG_STUB, os.path.join(workdir, "out"), num_sampling_steps=4, image_size=(8, 8))
    return {"seed": ev.seed, "ids": [d["id"] for d in ev.datasets],
            "seeds": [c[3] for c in pipe.calls]}


def test_dpg_world2_splits_the_prompts(tmp_path):
    from tests.test_torch_parallel import spawn

    ranks = spawn(dpg_rank, 2, tmp_path)
    single = StubPipeline()
    DPGEvaluator("unused", pipeline=single, device="cpu").eval(
        DPG_STUB, str(tmp_path / "one"), num_sampling_steps=4, image_size=(8, 8))
    got = _tree(tmp_path / "out")
    assert sorted(got) == sorted(_tree(tmp_path / "one")) == \
        [f"{k}.png" for k in sorted(json.loads(Path(DPG_STUB).read_text()))]
    assert [r["ids"] for r in ranks] == [["stub_0001", "stub_0002"], ["stub_0003"]]
    for rank, r in enumerate(ranks):
        assert r["init"] == (rank, 2)
        assert r["seed"] == 4396 * 2 + rank and set(r["seeds"]) == {r["seed"]}
        for pid in r["ids"]:
            imgs = StubPipeline().generate("", 8, 8, 4, 7.5, 4, r["seed"])
            tbase.save_grid(imgs, str(tmp_path / "want" / f"{pid}.png"))
            assert got[f"{pid}.png"] == (tmp_path / "want" / f"{pid}.png").read_bytes()


# ---------------------------------------------------------------------------
# the tiny real pipelines
# ---------------------------------------------------------------------------

def _shaped_noise(shape):
    seed = NOISE_SEED
    for d in shape:
        seed = (seed * 131 + int(d) + 7) % (2**31 - 1)
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


class Recording:
    """A pipeline that keeps each call's ±1 tokens beside the images."""

    def __init__(self, pipe):
        self.pipe, self.tokens = pipe, []

    def generate(self, prompt, **kw):
        images, tokens = self.pipe.generate(prompt, return_tokens=True, **kw)
        self.tokens.append(np.asarray(tokens))
        return np.asarray(images)


def jax_export(out: str, head_json: dict) -> dict:
    """tests/test_torch_release.py's tiny JAX export (every weight drawn,
    the offline HF tokenizer), built faster: the VQ model's init jitted and
    the head's and connector's shapes alone initialised (their drawn values
    replace every leaf anyway)."""
    from bitdance_tpu.models import qwen3 as jq
    from bitdance_tpu.models.connector import MLPConnector as JConnector
    from bitdance_tpu.models.diff_head import DiffHead as JHead
    from bitdance_tpu.models.tokenizer import VQModel as JVQ
    from bitdance_tpu.pipelines import t2i as jt2i
    from bitdance_tpu.train.checkpoints import export_hf_qwen3, export_release_dir
    from tests.test_release_roundtrip import _make_tokenizer
    from tests.test_torch_release import DD, LLM, _configs, _randomized

    cfg = jq.Qwen3Config(**LLM)
    head, ae, proj = JHead(**head_json), JVQ(ddconfig=DD), JConnector(out_dim=64)
    key = jax.random.PRNGKey(1)
    jb = jt2i.T2IModelBundle(
        llm_cfg=cfg, llm_params=jq.init_qwen3_params(jax.random.PRNGKey(0), cfg, jnp.float32),
        ae=ae, ae_params=jax.jit(lambda k: ae.init(k, jnp.zeros((1, 8, 8, 3))))(
            jax.random.PRNGKey(4)),
        head=head, head_params=_randomized(jax.eval_shape(lambda k: head.init(
            k, jnp.zeros((2, 4, 8)), jnp.zeros((2, 4, 64)), k), key), 3),
        projector=proj, projector_params=_randomized(jax.eval_shape(
            lambda k: proj.init(k, jnp.zeros((1, 8))), key), 6, 0.2),
        parallel_num=4, hidden_size=64, vae_patch_size=2, pe_max_len=4096)
    export_release_dir(out, ae_params=jb.ae_params, head_params=jb.head_params,
                       projector_params=jb.projector_params, configs=_configs(head_json))
    export_hf_qwen3(jb.llm_params, cfg, out)
    tok = _make_tokenizer()
    tok.save_pretrained(out)
    return dict(dir=out, jb=jb, tok=tok)


@pytest.fixture(scope="module")
def export(tmp_path_factory):
    from tests.test_torch_release import HEAD_JSON

    return jax_export(str(tmp_path_factory.mktemp("release")), HEAD_JSON)


@pytest.fixture(scope="module")
def real_runs(export, tmp_path_factory):
    """Each harness through the JAX and the port pipeline under the
    shape-keyed draws: {harness: {side: (output dir, tokens a call)}} and
    the port's least sign input."""
    from bitdance_tpu.pipelines.loader import load_t2i_pipeline as j_load
    from bitdance_tpu_torch.models import diff_head as tdh
    from bitdance_tpu_torch.pipelines import t2i as tt2i
    from bitdance_tpu_torch.pipelines.loader import load_t2i_pipeline

    root = tmp_path_factory.mktemp("real")
    (root / "dpg.json").write_text(json.dumps(REAL_PROMPTS))
    (root / "geneval.jsonl").write_text(json.dumps(
        {"tag": "single_object", "prompt": REAL_PROMPTS["cat"]}) + "\n")
    margins = []

    def table_noise(generator, half, ch, num_steps, device):
        # JAX's per-call sampler draws x0 and each step at [n, p, ch]
        t = torch.from_numpy(_shaped_noise((half // 4, 4, ch))).reshape(half, ch)
        return t.clone(), t[None].repeat(num_steps, 1, 1)

    real_sign = tt2i.sign_quantize

    def spy_sign(x):
        margins.append(float(x.abs().min()))
        return real_sign(x)

    pipes = {"jax": Recording(j_load(export["dir"], dtype=jnp.float32)),
             "port": Recording(load_t2i_pipeline(export["dir"], dtype=torch.float32,
                                                 device="cpu"))}
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "normal", lambda key, shape=(), dtype=jnp.float32:
                   jnp.asarray(_shaped_noise(tuple(shape)), dtype))
        mp.setattr(tdh, "draw_sampler_noise", table_noise)
        mp.setattr(tt2i, "sign_quantize", spy_sign)
        for name, classes, data in (("dpg", (JDPG, DPGEvaluator), root / "dpg.json"),
                                    ("geneval", (JGeneval, GenevalEvaluator),
                                     root / "geneval.jsonl")):
            out[name] = {}
            for side, cls in zip(("jax", "port"), classes):
                rec = pipes[side]
                rec.tokens = []
                d = root / f"{name}_{side}"
                cls("unused", pipeline=rec).eval(str(data), str(d), **REAL_GEN)
                out[name][side] = (d, rec.tokens)
    return out, margins


@pytest.mark.parametrize("harness", ["dpg", "geneval"])
def test_real_pipelines_agree_through_the_harness(real_runs, harness):
    runs, margins = real_runs
    assert len(margins) == (2 + 1) * 4 and min(margins) > SIGN_MARGIN, (
        f"borderline sign margin {min(margins)}: pick another NOISE_SEED")
    (jdir, jtok), (tdir, ttok) = runs[harness]["jax"], runs[harness]["port"]
    prompts = {"dpg": 2, "geneval": 1}[harness]
    assert len(jtok) == len(ttok) == prompts
    for j, t in zip(jtok, ttok):
        assert t.shape == j.shape == (4, 16, 8)
        np.testing.assert_array_equal(t, j, err_msg="±1 grids diverge")
    jt, tt = _tree(jdir), _tree(tdir)
    assert sorted(tt) == sorted(jt)
    for name in jt:
        if name.endswith(".png"):
            a, b = _png(jdir / name).astype(int), _png(tdir / name).astype(int)
            assert a.shape == b.shape and np.abs(a - b).max() <= 1, name
        else:
            assert tt[name] == jt[name], name
    grids = [n for n in jt if n.endswith("grid.png") or harness == "dpg"]
    assert len(grids) == prompts and all(_png(jdir / n).shape == (16, 16, 3) for n in grids)


# ---------------------------------------------------------------------------
# the command lines
# ---------------------------------------------------------------------------

@pytest.fixture
def process_group():
    """Destroy the group of one that main() starts, unless one was up."""
    import torch.distributed as dist

    was = dist.is_initialized()
    yield
    if dist.is_initialized() and not was:
        dist.destroy_process_group()


@pytest.mark.parametrize("harness", ["dpg", "geneval"])
def test_main_writes_the_layout(export, tmp_path, process_group, harness):
    """``main`` on the export (bf16, the loader's default), one prompt at
    8 px and 2 steps: the layout, and grids equal to the evaluator run
    in-process on the same loaded pipeline."""
    from bitdance_tpu_torch.eval import dpg, geneval
    from bitdance_tpu_torch.pipelines.loader import load_t2i_pipeline

    mod, cls, data = {"dpg": (dpg, DPGEvaluator, DPG_STUB),
                      "geneval": (geneval, GenevalEvaluator, GENEVAL_STUB)}[harness]
    out = tmp_path / "main"
    rc = mod.main(["--model_path", export["dir"], "--data_path", data, "--save_dir", str(out),
                   "--image_size", "8", "8", "--num_sampling_steps", "2",
                   "--max_prompts", "1", "--device", "cpu"], tokenizer=export["tok"])
    assert rc == 0
    pipe = load_t2i_pipeline(export["dir"], device="cpu", tokenizer=export["tok"])
    want = tmp_path / "want"
    cls("unused", pipeline=pipe).eval(data, str(want), num_sampling_steps=2,
                                      image_size=(8, 8), max_prompts=1)
    got = _tree(out)
    if harness == "dpg":
        assert sorted(got) == ["stub_0001.png"]
    else:
        first = Path(data).read_text().splitlines(keepends=True)[0]
        assert sorted(got) == ["00000/grid.png", "00000/metadata.jsonl"] + [
            f"00000/samples/{i:04d}.png" for i in range(4)]
        assert got["00000/metadata.jsonl"] == first.encode()
    assert got == _tree(want)
