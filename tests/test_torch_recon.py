"""The reconstruction harness and the GAN decoder's entry points against the
JAX package on the CPU: load_image_folder, ReconReport /
compare_reconstructions, ``python -m bitdance_tpu_torch.cli.recon`` (plain
and --uni), a tiny release whose ae_config says ``gan_decoder: true``
through the port's loader, and the GAN tokenizer training step (every
gaussian draw on both sides from a shape-keyed table)."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from bitdance_tpu.eval import recon as jrecon
from bitdance_tpu.models import tokenizer as jtok
from bitdance_tpu.train import tokenizer_train as jtt
from bitdance_tpu_torch.cli import recon as cli_recon
from bitdance_tpu_torch.eval import recon as trecon
from bitdance_tpu_torch.io.from_jax import flax_state_from_jax, load_into
from bitdance_tpu_torch.io.safetensors import save_file
from bitdance_tpu_torch.models import tokenizer as ttok
from bitdance_tpu_torch.models.tokenizer_uni import init_uni_vq
from bitdance_tpu_torch.pipelines import t2i as tt2i
from bitdance_tpu_torch.pipelines.loader import load_t2i_pipeline
from bitdance_tpu_torch.train import tokenizer_train as ttt

torch.set_num_threads(2)
TINY_DD = dict(z_channels=8, in_channels=3, out_ch=3, ch=32, ch_mult=[1, 2],
               num_res_blocks=1)
UNI_DD = dict(TINY_DD, attn_blocks=1, n_heads=4)


def _png_folder(path, sizes, seed=0):
    rng = np.random.default_rng(seed)
    path.mkdir()
    for i, (h, w) in enumerate(sizes):
        Image.fromarray(rng.integers(0, 256, (h, w, 3), np.uint8)).save(
            path / f"img_{i:02d}.png")
    (path / "notes.txt").write_text("not an image")
    return str(path)


@pytest.mark.parametrize("limit", [0, 3])
def test_load_image_folder_matches_jax(tmp_path, limit):
    folder = _png_folder(tmp_path / "imgs", [(40, 52), (33, 33), (70, 31), (48, 48)])
    want = jrecon.load_image_folder(folder, 32, limit)
    got = trecon.load_image_folder(folder, 32, limit)
    assert got.shape == want.shape == (limit or 4, 32, 32, 3) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    with pytest.raises(FileNotFoundError):
        trecon.load_image_folder(str(tmp_path), 32)


def test_compare_reconstructions_matches_jax():
    rng = np.random.default_rng(2)
    imgs = rng.uniform(-1, 1, (2, 24, 20, 3))
    r1 = np.clip(imgs + 0.1 * rng.normal(size=imgs.shape), -1, 1)
    r2 = np.clip(imgs + 0.12 * rng.normal(size=imgs.shape), -1, 1)
    one, jone = trecon.compare_reconstructions(imgs, r1), jrecon.compare_reconstructions(
        imgs, r1, None)
    assert (one.psnr, one.ssim) == (jone.psnr_jax, jone.ssim_jax)
    assert one.psnr_ref is None and one.within_north_star is None
    for a, b in ((r1, r2), (r2, r1)):
        two, jtwo = (trecon.compare_reconstructions(imgs, a, b),
                     jrecon.compare_reconstructions(imgs, a, b))
        assert (two.psnr, two.ssim, two.psnr_ref, two.ssim_ref) == (
            jtwo.psnr_jax, jtwo.ssim_jax, jtwo.psnr_torch, jtwo.ssim_torch)
        assert two.psnr_delta == jtwo.psnr_delta
        assert two.within_north_star is jtwo.within_north_star is (a is r1)
        jd, d = jtwo.as_dict(), two.as_dict()
        assert [d[k] for k in ("psnr_db", "ssim", "psnr_ref_db", "ssim_ref", "psnr_delta_db",
                               "within_0p05db")] == [
            jd[k] for k in ("psnr_jax_db", "ssim_jax", "psnr_torch_db", "ssim_torch",
                            "psnr_delta_db", "within_0p05db")]


def _run_cli(argv, capsys) -> dict:
    assert cli_recon.main(argv) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_cli_recon_plain_and_uni(tmp_path, capsys):
    """The command end to end on the CPU: its PSNR / SSIM equal the
    in-process reconstruct of the same images (and, --uni, the same
    generator seed and the EMA weights)."""
    folder = _png_folder(tmp_path / "imgs", [(20, 24), (16, 16), (30, 18)], seed=4)
    cfg = tmp_path / "ae_config.json"
    cfg.write_text(json.dumps({"ddconfig": UNI_DD, "gan_decoder": False}))
    images = trecon.load_image_folder(folder, 16, 0)
    base = ["--images", folder, "--ae-config", str(cfg), "--resolution", "16",
            "--batch", "2", "--device", "cpu"]

    vq = ttok.init_vq(TINY_DD, "cpu", torch.float32, torch.Generator().manual_seed(1),
                      encoder=True, decoder=True)
    save_file(vq.state_dict(), tmp_path / "ae.safetensors")
    out = _run_cli(base + ["--ae", str(tmp_path / "ae.safetensors")], capsys)
    want = trecon.compare_reconstructions(images, trecon.reconstruct(vq, images, batch=2))
    assert out == {"n_images": 3, "resolution": 16, **want.as_dict()}
    assert out["psnr_ref_db"] is None and np.isfinite(out["psnr_db"])

    uni = init_uni_vq(UNI_DD, "cpu", torch.float32, torch.Generator().manual_seed(2))
    ema = init_uni_vq(UNI_DD, "cpu", torch.float32, torch.Generator().manual_seed(3))
    state = dict(uni.state_dict())
    state.update({"model_ema." + k.replace(".", ""): v for k, v in ema.state_dict().items()})
    save_file(state, tmp_path / "uni.safetensors")
    out = _run_cli(base + ["--ae", str(tmp_path / "uni.safetensors"), "--uni",
                           "--seed", "5"], capsys)
    recon = trecon.reconstruct(ema, images, batch=2,
                               generator=torch.Generator().manual_seed(5))
    want = trecon.compare_reconstructions(images, recon)
    assert out == {"n_images": 3, "resolution": 16, **want.as_dict()}
    other = trecon.reconstruct(ema, images, batch=2,
                               generator=torch.Generator().manual_seed(6))
    assert not np.array_equal(other, recon)


# ---------------------------------------------------------------------------
# a release with the GAN decoder
# ---------------------------------------------------------------------------

LLM = dict(vocab_size=512, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
           num_attention_heads=4, num_key_value_heads=2, head_dim=16)
HEAD_JSON = {"ch_target": 8, "ch_cond": 64, "ch_latent": 128, "depth_latent": 2,
             "depth_adanln": 2, "parallel_num": 4, "use_swiglu": True}


@pytest.fixture(scope="module")
def gan_release(tmp_path_factory):
    """A tiny release (tests/test_torch_release.py's sizes) of random port
    modules, its ae a GAN decoder, written by the port's exporter."""
    from bitdance_tpu_torch.config import head_config_from_json
    from bitdance_tpu_torch.io.random_init import init_head, init_projector
    from bitdance_tpu_torch.models.qwen3 import Qwen3Config, init_qwen3
    from bitdance_tpu_torch.train.checkpoints import export_hf_qwen3, export_release_dir
    from tests.test_release_roundtrip import _make_tokenizer

    out = str(tmp_path_factory.mktemp("gan_release"))
    g = torch.Generator().manual_seed(0)
    kw = head_config_from_json(HEAD_JSON)
    kw.pop("diff_batch_mul")
    export_release_dir(out, ae=ttok.init_vq(TINY_DD, "cpu", torch.float32, g, gan_decoder=True),
                       head=init_head(kw, "cpu", torch.float32, g),
                       projector=init_projector(8, 64, "cpu", torch.float32, g),
                       configs={"ae_config": {"ddconfig": TINY_DD, "gan_decoder": True},
                                "vision_head_config": HEAD_JSON})
    export_hf_qwen3(init_qwen3(Qwen3Config(**LLM), "cpu", torch.float32, g), out)
    tok = _make_tokenizer()
    tok.save_pretrained(out)
    return dict(dir=out, tok=tok)


def test_gan_release_loads_and_decodes_with_the_requests_seed(gan_release):
    """The port serves a ``gan_decoder: true`` release: its decoder equals
    the JAX decoder of the same file (convert_ae_state) given the same
    noise; a request's image is its seed's, the same twice, another seed's
    differs; without a generator the decode refuses."""
    from bitdance_tpu.io.torch_import import convert_ae_state, load_safetensors

    pipe = load_t2i_pipeline(gan_release["dir"], dtype=torch.float32, device="cpu",
                             tokenizer=gan_release["tok"])
    b = pipe.bundle
    assert b.ae.gan_decoder and b.ae.decoder.conv_in.weight.shape[1] == 16
    grid = torch.from_numpy(np.sign(np.random.default_rng(3).normal(
        size=(1, 16, 8))).astype(np.float32))
    # the JAX decoder given a noise rng (its pipeline passes none: C15)
    k = jax.random.PRNGKey(6)
    lat = jtok.tokens_to_latents(jnp.asarray(grid.numpy()), 4, 4, 2)
    params = convert_ae_state(load_safetensors(f"{gan_release['dir']}/ae.safetensors"))
    want = np.asarray(jtok.VQModel(ddconfig=TINY_DD, gan_decoder=True).apply(
        params, lat, method=jtok.VQModel.decode, noise_rng=k))
    noise = torch.from_numpy(np.array(jax.random.normal(k, lat.shape, jnp.float32)))
    got = b.ae.decode(ttok.tokens_to_latents(grid, 4, 4, 2), noise=noise).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    with pytest.raises(ValueError, match="noise= or generator="):
        tt2i.decode_image(b, grid, 4, 4)
    kw = dict(num_sampling_steps=2, guidance_scale=2.0)
    a, ta = pipe.generate("a tiny cat", 8, 8, seed=3, return_tokens=True, **kw)
    again, tb = pipe.generate("a tiny cat", 8, 8, seed=3, return_tokens=True, **kw)
    np.testing.assert_array_equal(a, again)
    np.testing.assert_array_equal(ta, tb)
    assert not np.array_equal(a, pipe.generate("a tiny cat", 8, 8, seed=4, **kw))
    assert ta.shape == (1, 16, 8) and set(np.unique(ta)) <= {-1.0, 1.0}


def _table(shape, seed=11):
    for d in shape:
        seed = (seed * 131 + int(d) + 7) % (2 ** 31 - 1)
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def test_gan_tokenizer_train_step_matches_jax(monkeypatch):
    """tokenizer_loss with a GAN decoder, its terms and gradients, against
    the JAX step's, the decoder noise from the same shape-keyed table on
    both sides (JAX draws it from the step's rng, the port from the step's
    generator)."""
    monkeypatch.setattr(jax.random, "normal", lambda key, shape=(), dtype=jnp.float32:
                        jnp.asarray(_table(tuple(shape)), dtype))
    drawn = []

    def randn(shape, generator=None, device=None, dtype=None):
        drawn.append((tuple(shape), generator))
        return torch.from_numpy(_table(tuple(shape)))

    monkeypatch.setattr(torch, "randn", randn)
    jm = jtok.VQModel(ddconfig=TINY_DD, gan_decoder=True)
    tcfg = jtt.TokenizerTrainConfig(lr=1e-3, warmup_steps=0, total_steps=100,
                                    num_codebooks=2)
    params = jax.jit(lambda k: jm.init(k, jnp.zeros((1, 16, 16, 3)),
                                       noise_rng=jax.random.PRNGKey(0)))(jax.random.PRNGKey(3))
    images = np.random.default_rng(4).uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32)
    (_, want), grads = jax.jit(jax.value_and_grad(
        lambda p: jtt.tokenizer_loss(p, jm, jnp.asarray(images), jax.random.PRNGKey(2), tcfg),
        has_aux=True))(params)
    tm = load_into(ttok.VQModel(TINY_DD, encoder=True, gan_decoder=True),
                   flax_state_from_jax(params))
    pcfg = ttt.TokenizerTrainConfig(**{f: getattr(tcfg, f) for f in
                                       ttt.TokenizerTrainConfig.__dataclass_fields__})
    gen = torch.Generator().manual_seed(0)
    loss, got = ttt.tokenizer_loss(tm, torch.from_numpy(images), pcfg, gen)
    assert drawn == [((2, 8, 8, 8), gen)]
    for k in want:
        # fp32, the sums in another order (test_torch_tokenizer_train.py)
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    want_g = flax_state_from_jax(grads)
    names = [n for n, _ in tm.named_parameters()]
    got_g = dict(zip(names, torch.autograd.grad(loss, list(tm.parameters()))))
    assert set(got_g) == set(want_g)
    scale = max(float(np.abs(v).max()) for v in want_g.values())
    for name, g in got_g.items():
        np.testing.assert_allclose(g.numpy(), want_g[name], rtol=0, atol=3e-4 * scale,
                                   err_msg=name)


def test_gan_tokenizer_train_steps_draw_from_the_step_generator():
    tcfg = ttt.TokenizerTrainConfig(lr=1e-3, warmup_steps=0, total_steps=100,
                                    num_codebooks=2)
    images = torch.from_numpy(np.random.default_rng(1).uniform(
        -1, 1, (2, 16, 16, 3)).astype(np.float32))
    runs = []
    for _ in range(2):
        state = ttt.init_tokenizer_train(TINY_DD, tcfg, "cpu", torch.Generator().manual_seed(0),
                                         gan_decoder=True)
        assert state.model.decoder.conv_in.weight.shape[1] == 16
        step = ttt.make_tokenizer_train_step(tcfg)
        runs.append([step(state, images, torch.Generator().manual_seed(10 + i))["loss"].item()
                     for i in range(3)])
    assert runs[0] == runs[1] and runs[0][-1] < runs[0][0]
    with pytest.raises(ValueError, match="noise= or generator="):
        ttt.make_tokenizer_train_step(tcfg)(state, images)
