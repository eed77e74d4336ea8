"""The port's command lines and FID sampler on the CPU: every new command
defaults to the card and refuses a missing one; cli.train_imagenet at
BitDance-S over an image folder and cli.train_mllm at a tiny YAML, resumed
mid-way, end bit-equal to their straight runs; cli.sample_fid samples from
the trainer's checkpoint; eval/fid.py's sample_fid against the JAX
package's under shape-keyed noise tables (equal ±1 grids, PNG pixels
within 1, the same file names) and its npz packer against JAX's.

The trainers' tokenizer is the commands' width (ch 256, 4 blocks a level),
which the CPU would take minutes to run at 256 px; the tests narrow it by
setting cli/common.py's TOKENIZER_DDCONFIG."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from bitdance_tpu.eval import fid as jfid
from bitdance_tpu.models import imagenet_ar as jia
from bitdance_tpu.models.tokenizer import VQModel as JVQ
from bitdance_tpu_torch.cli import common, sample_fid, train_imagenet, train_mllm
from bitdance_tpu_torch.data import packing as tpack
from bitdance_tpu_torch.eval import fid as tfid
from bitdance_tpu_torch.io.from_jax import imagenet_sampler_from_jax
from bitdance_tpu_torch.io.safetensors import load_file
from bitdance_tpu_torch.models import diff_head as tdh
from bitdance_tpu_torch.models import imagenet_ar as tia

torch.set_num_threads(4)
SMALL_TOKENIZER = dict(in_channels=3, out_ch=3, ch=32, ch_mult=[1, 1, 1, 1, 1],
                       num_res_blocks=1)


def _checkpoints_equal(a, b, step):
    """Every tensor of two step directories bit for bit, and their meta and
    data status."""
    da, db = os.path.join(a, str(step)), os.path.join(b, str(step))
    ta, tb = load_file(os.path.join(da, "state.safetensors")), \
        load_file(os.path.join(db, "state.safetensors"))
    assert set(ta) == set(tb)
    diff = [k for k in ta if ta[k].dtype != tb[k].dtype or not torch.equal(ta[k], tb[k])]
    assert not diff, diff[:8]
    for name in ("meta.json", "data_status.json"):
        with open(os.path.join(da, name)) as fa, open(os.path.join(db, name)) as fb:
            assert fa.read() == fb.read(), name
    return ta


@pytest.mark.parametrize("module,argv", [
    (train_imagenet, ["--data-path", "x"]),
    (sample_fid, ["--ckpt", "x"]),
    (train_mllm, ["--config", "x", "--data-dir", "y"]),
], ids=["train_imagenet", "sample_fid", "train_mllm"])
def test_commands_default_to_the_card(module, argv, tmp_path):
    assert module.parse_args(argv).device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="no CUDA device"):
            module.main(argv)


@pytest.mark.parametrize("encoder", [True, False])
def test_trained_vae_loads_its_half(tmp_path, monkeypatch, encoder):
    """--trained-vae: a whole tokenizer's safetensors (encoder and decoder,
    as a release ae.safetensors holds them) fills the half a command uses;
    without it the half is drawn from the seed."""
    from bitdance_tpu_torch.io.safetensors import save_file
    from bitdance_tpu_torch.models.tokenizer import init_vq

    monkeypatch.setattr(common, "TOKENIZER_DDCONFIG", SMALL_TOKENIZER)
    full = init_vq(dict(SMALL_TOKENIZER, z_channels=16), "cpu", torch.float32,
                   torch.Generator().manual_seed(5), encoder=True, decoder=True)
    save_file(full.state_dict(), tmp_path / "ae.safetensors")
    got = common.imagenet_tokenizer(16, str(tmp_path / "ae.safetensors"),
                                    torch.device("cpu"), encoder=encoder)
    want = full.state_dict()
    assert got.state_dict().keys() < want.keys() and not got.training
    for k, v in got.state_dict().items():
        assert torch.equal(v, want[k]), k
    drawn = common.imagenet_tokenizer(16, "", torch.device("cpu"), encoder=encoder)
    assert drawn.state_dict().keys() == got.state_dict().keys()


def _image_folder(root, n_classes=4, per_class=4):
    from PIL import Image

    rng = np.random.default_rng(0)
    for c in range(n_classes):
        d = root / f"class_{c}"
        d.mkdir(parents=True)
        for i in range(per_class):
            Image.fromarray(rng.integers(0, 255, (40 + 5 * c, 48 + 3 * i, 3),
                                         np.uint8)).save(d / f"img_{i}.png")
    return str(root)


@pytest.fixture(scope="module")
def imagenet_runs(tmp_path_factory):
    """BitDance-S at 256 px, batch 4 over 16 images (4 steps an epoch): 6
    steps straight, and 3 then 3 more in a second results directory (the
    resume lands mid-epoch)."""
    root = tmp_path_factory.mktemp("imagenet")
    data = _image_folder(root / "imgs")
    saved = common.TOKENIZER_DDCONFIG
    common.TOKENIZER_DDCONFIG = SMALL_TOKENIZER
    base = ["--data-path", data, "--model", "BitDance-S", "--global-batch-size", "4",
            "--epochs", "3", "--warmup-steps", "1", "--log-every", "1",
            "--diff-batch-mul", "2", "--global-seed", "3", "--device", "cpu"]
    stats = {}
    try:
        train_imagenet.main(base + ["--results-dir", str(root / "a"), "--max-steps", "6"],
                            stats=stats)
        train_imagenet.main(base + ["--results-dir", str(root / "b"), "--max-steps", "3"])
        resumed = {}
        train_imagenet.main(base + ["--results-dir", str(root / "b"), "--max-steps", "6"],
                            stats=resumed)
    finally:
        common.TOKENIZER_DDCONFIG = saved
    return root, stats, resumed


def test_train_imagenet_resumed_equals_straight(imagenet_runs):
    root, stats, resumed = imagenet_runs
    a, b = str(root / "a" / "checkpoints"), str(root / "b" / "checkpoints")
    # the straight run saved at the end of epoch 0 (step 4) and at step 6
    assert sorted(os.listdir(a)) == ["4", "6"] and sorted(os.listdir(b)) == ["3", "4", "6"]
    assert len(stats["step_seconds"]) == 6 and len(resumed["step_seconds"]) == 3
    assert stats["ckpt_bytes"][0] > 0 and "restore_seconds" in resumed
    assert set(stats["phase_seconds"]) == {"encode", "train_step", "clock"}
    t = _checkpoints_equal(a, b, 6)
    _checkpoints_equal(a, b, 4)
    with open(os.path.join(b, "3", "data_status.json")) as f:
        assert f.read() == '{"epoch": 0, "batch": 3}'
    with open(os.path.join(a, "6", "data_status.json")) as f:
        assert f.read() == '{"epoch": 1, "batch": 2}'
    # the run trained: the EMA and the masters moved apart, moments are set
    assert not torch.equal(t["model/ar.norm.weight"], t["ema/ar.norm.weight"])
    assert float(t["opt/ar.layers.0.attention.wqkv.weight/step"]) == 6.0
    assert (root / "a" / "log.txt").exists()


def test_sample_fid_command_from_a_checkpoint(imagenet_runs, tmp_path):
    root, _, _ = imagenet_runs
    saved = common.TOKENIZER_DDCONFIG
    common.TOKENIZER_DDCONFIG = SMALL_TOKENIZER
    try:
        sample_fid.main(["--model", "BitDance-S", "--ckpt", str(root / "a" / "checkpoints"),
                         "--sample-dir", str(tmp_path), "--per-proc-batch-size", "2",
                         "--num-fid-samples", "3", "--sample-steps", "2",
                         "--cfg-scale", "4.6", "--device", "cpu"])
    finally:
        common.TOKENIZER_DDCONFIG = saved
    folder = tmp_path / "BitDance-S-size-256-steps-2-cfg-4.6-seed-99"
    assert sorted(os.listdir(folder)) == ["000000.png", "000001.png", "000002.png"]
    arr = np.load(str(folder) + ".npz")["arr_0"]
    assert arr.shape == (3, 256, 256, 3) and arr.dtype == np.uint8


def test_sample_fid_without_checkpoint_raises(tmp_path):
    with pytest.raises(SystemExit, match="no checkpoint"):
        sample_fid.main(["--model", "BitDance-S", "--ckpt", str(tmp_path),
                         "--device", "cpu"])


MLLM_YAML = {
    "model": {
        "vit_patch_size": 16,
        "encoder": {"params": {"ddconfig": {"z_channels": 8}}},
        "llm": {"hidden_size": 64, "intermediate_size": 128, "num_hidden_layers": 2,
                "num_attention_heads": 4, "num_key_value_heads": 2, "head_dim": 16},
        "head": {"vision_pred": {"model_dim": 128, "num_blocks": 2, "num_adaln": 2,
                                 "parallel_num": 4, "P_mean": -0.8, "P_std": 0.8,
                                 "use_swiglu": True},
                 "vision_perturb": 0.1, "pe_max_len": 64},
    },
    "data": {"max_num_tokens_per_sample": 0},
    "training": {"global_seed": 7, "auto_resume": True, "log_every": 1,
                 "save_every": 2, "validate_every": 2, "warmup_steps": 1,
                 "lr": 1e-3, "min_lr": 0.0, "beta1": 0.9, "beta2": 0.95, "eps": 1e-15,
                 "max_grad_norm": 1.0, "loss_weight_text": 0.01,
                 "loss_weight_vision": 1.0, "num_replicate": 1, "num_shard": 1},
}


def _packed_files(d, n=3):
    table = tpack.sincos_1d_table_np(32, 64)
    rng = np.random.default_rng(0)
    d.mkdir()
    for f in range(n + 1):
        samples = [tpack.T2ISample(
            text_ids=rng.integers(1, 250, int(rng.integers(5, 12))),
            image_latents=np.sign(rng.normal(size=(16, 8))).astype(np.float32),
            latent_h=4, latent_w=4, vision_start_id=251, res_h_id=252, res_w_id=253,
            query_ids=np.arange(260, 263), text_loss=True) for _ in range(2)]
        raw = tpack.pack_t2i_batch(samples, 4, 128, table, text_budget=48, vis_budget=48)
        np.savez(d / (f"{f:03d}.npz" if f < n else "../val.npz"), **raw)
    return str(d), str(d.parent / "val.npz")


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_train_mllm_resumed_equals_straight(tmp_path, grad_accum):
    """A tiny YAML: 4 steps straight against 2 and 2 more resumed from the
    step-2 checkpoint and its data file; a validation loss every 2 steps."""
    cfg = dict(MLLM_YAML, training=dict(MLLM_YAML["training"],
                                        grad_accum=grad_accum))
    path = tmp_path / "c.yaml"
    path.write_text(yaml.safe_dump(cfg))
    data, val = _packed_files(tmp_path / "data")
    base = ["--config", str(path), "--data-dir", data, "--val-batch", val,
            "--vocab-size", "300", "--device", "cpu"]
    stats = {}
    train_mllm.main(base + ["--results-dir", str(tmp_path / "a"), "--max-steps", "4"],
                    stats=stats)
    train_mllm.main(base + ["--results-dir", str(tmp_path / "b"), "--max-steps", "2"])
    train_mllm.main(base + ["--results-dir", str(tmp_path / "b"), "--max-steps", "4"])
    a, b = str(tmp_path / "a" / "checkpoints"), str(tmp_path / "b" / "checkpoints")
    assert sorted(os.listdir(a)) == ["2", "4"] == sorted(os.listdir(b))
    t = _checkpoints_equal(a, b, 4)
    _checkpoints_equal(a, b, 2)
    with open(os.path.join(a, "4", "data_status.json")) as f:
        assert f.read() == f'{{"file": {4 * grad_accum}}}'
    assert t["model/llm.model.embed_tokens.weight"].dtype == torch.bfloat16
    assert len(stats["val"]) == 2 and all(np.isfinite(v["val_loss"]) for v in stats["val"])
    assert len(stats["step_seconds"]) == 4
    assert set(stats["phase_seconds"]) == {"batch", "train_step", "clock"}


def test_train_mllm_mesh_falls_back_to_the_world(tmp_path):
    """The 14B yaml's mesh (1, 8) does not fit one process: the command
    trains on (1, world), as scripts/train_mllm.py:79-84 does, and says so."""
    cfg = dict(MLLM_YAML, training=dict(MLLM_YAML["training"], num_shard=8))
    path = tmp_path / "c.yaml"
    path.write_text(yaml.safe_dump(cfg))
    data, _ = _packed_files(tmp_path / "data")
    stats = {}
    train_mllm.main(["--config", str(path), "--data-dir", data, "--vocab-size", "300",
                     "--results-dir", str(tmp_path / "r"), "--max-steps", "1",
                     "--device", "cpu"], stats=stats)
    assert stats["mesh"] == (1, 1)
    with open(tmp_path / "r" / "log.txt") as f:
        assert "overriding it to (1, 1)" in f.read()
    assert os.listdir(tmp_path / "r" / "checkpoints") == ["1"]


# ---------------------------------------------------------------------------
# eval/fid.py against the JAX package
# ---------------------------------------------------------------------------

NOISE_SEED = 5
FID_DD = dict(z_channels=16, in_channels=3, out_ch=3, ch=32, ch_mult=[1, 1, 1, 1, 1],
              num_res_blocks=1)


def _shaped_noise(shape):
    seed = NOISE_SEED
    for d in shape:
        seed = (seed * 131 + int(d) + 7) % (2**31 - 1)
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _randomized(tree, seed, scale):
    leaves, treedef = jax.tree_util.tree_flatten(tree)
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_unflatten(treedef, [
        jnp.asarray(scale * rng.standard_normal(l.shape), jnp.float32) for l in leaves])


def test_sample_fid_matches_jax(tmp_path, monkeypatch):
    """BitDance-S widths at 64 px (16 tokens), 5 samples in batches of 4
    over 10 classes, guided: the ±1 grids of every batch equal JAX's, the
    PNGs are within 1 of JAX's and carry the same names."""
    kw = dict(resolution=64, cls_token_num=4, num_classes=10)
    jcfg, tcfg = jia.config_s(**kw), tia.config_s(**kw)
    ar = _randomized(jia.init_ar_params(jax.random.PRNGKey(0), jcfg), 1, 0.3)
    head = jia.make_head(jcfg)
    hp = _randomized(head.init(jax.random.PRNGKey(1), jnp.zeros((2, 16)),
                               jnp.zeros((2, 256)), jax.random.PRNGKey(2)), 2, 0.3)
    ae = JVQ(ddconfig=FID_DD)
    aep = _randomized(ae.init(jax.random.PRNGKey(3), jnp.zeros((1, 4, 4, 16)),
                              method=JVQ.decode), 3, 0.1)
    b = imagenet_sampler_from_jax(tcfg, ar, hp, aep, ddconfig=FID_DD)
    run = dict(num_fid_samples=5, per_proc_batch_size=4, cfg_scale=4.6,
               sample_steps=3, seed=99)

    # JAX: every normal draw from the table, jit off so the grids can be read
    monkeypatch.setattr(jax.random, "normal", lambda key, shape=(), dtype=jnp.float32:
                        jnp.asarray(_shaped_noise(tuple(shape)), dtype))
    monkeypatch.setattr(jax, "jit", lambda f, **k: f)
    want_grids = []
    real_grid = jia.tokens_to_grid
    monkeypatch.setattr(jia, "tokens_to_grid",
                        lambda c, t: want_grids.append(np.asarray(t)) or real_grid(c, t))
    jnpz = jfid.sample_fid(ar, head, hp, jcfg, ae, aep, str(tmp_path / "jax"), **run)
    monkeypatch.undo()

    def table_noise(generator, half, ch, num_steps, device):
        t = torch.from_numpy(_shaped_noise((4, 16))).reshape(half, ch)
        return t.clone(), t[None].repeat(num_steps, 1, 1)

    got_grids, margins = [], []
    real_sample, real_sign = tfid.sample, tia._sign
    monkeypatch.setattr(tdh, "draw_sampler_noise", table_noise)
    monkeypatch.setattr(tia, "_sign", lambda x: margins.append(float(x.abs().min()))
                        or real_sign(x))
    monkeypatch.setattr(tfid, "sample", lambda *a, **k:
                        got_grids.append(real_sample(*a, **k)) or got_grids[-1])
    tnpz = tfid.sample_fid(b.model, b.head, tcfg, b.ae, str(tmp_path / "port"),
                           head_stacked=b.head_stacked, **run)
    assert min(margins) > 1e-3, f"borderline sign margin {min(margins)}: pick another NOISE_SEED"
    assert len(got_grids) == len(want_grids) == 2
    for g, w in zip(got_grids, want_grids):
        np.testing.assert_array_equal(g.numpy(), w)
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jax")) \
        == [f"{i:06d}.png" for i in range(5)]
    t_arr, j_arr = np.load(tnpz)["arr_0"], np.load(jnpz)["arr_0"]
    assert t_arr.shape == j_arr.shape == (5, 64, 64, 3) and t_arr.dtype == np.uint8
    assert np.abs(t_arr.astype(int) - j_arr.astype(int)).max() <= 1
    assert len(np.unique(t_arr)) > 50               # not a flat image


def test_fid_npz_pack_matches_jax(tmp_path):
    from PIL import Image

    d = tmp_path / "samples"
    d.mkdir()
    rng = np.random.default_rng(0)
    for i in range(4):
        Image.fromarray(rng.integers(0, 255, (8, 8, 3), np.uint8)).save(d / f"{i:06d}.png")
    got = np.load(tfid.create_npz_from_sample_folder(str(d), num=4))["arr_0"]
    want = np.load(jfid.create_npz_from_sample_folder(str(d), num=4))["arr_0"]
    assert got.shape == (4, 8, 8, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    with pytest.raises(FileNotFoundError):
        tfid.create_npz_from_sample_folder(str(d), num=5)
