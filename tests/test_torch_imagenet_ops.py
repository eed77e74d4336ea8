"""ImageNet-slice ops and modules of the port vs the JAX package: paired 2D
RoPE, bit packing and the bit-flip augmentation, GFQ (inference and
training), the tokenizer Encoder / encode_raw, and the weight bridges of the
backbone, the MlpEncoder head and the encoder. Float32; each test states its
tolerance."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bitdance_tpu.models import gfq as jgfq
from bitdance_tpu.models import imagenet_ar as jia
from bitdance_tpu.ops import quantize as jq
from bitdance_tpu.ops import rotary as jr
from bitdance_tpu_torch.models import gfq as tgfq
from bitdance_tpu_torch.models import imagenet_ar as tia
from bitdance_tpu_torch.ops import quantize as tq
from bitdance_tpu_torch.ops import rotary as tr

torch.set_num_threads(2)
TOL = dict(rtol=1e-5, atol=1e-5)


def _rand(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("resolution,patch,head_dim,cls", [
    (256, 16, 64, 64), (64, 16, 32, 7), (32, 8, 16, 0)])
def test_paired_rope_2d(resolution, patch, head_dim, cls):
    """Patch centres, the (cos, sin) table with t = pos + 1 for patches and
    t = 0 for the prefix rows, and the pairwise rotation; 1e-5."""
    jc = jr.patch_center_coords_2d(resolution, patch)
    tc = tr.patch_center_coords_2d(resolution, patch)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), **TOL)
    jt = jr.rope_table_2d(jc, head_dim, cls_token_num=cls)
    tt = tr.rope_table_2d(tc, head_dim, cls_token_num=cls)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), **TOL)
    np.testing.assert_array_equal(tt[:cls, :, 0].numpy(), 1.0)   # identity rows
    np.testing.assert_array_equal(tt[:cls, :, 1].numpy(), 0.0)
    x = _rand(np.random.default_rng(0), 2, tt.shape[0], 3, head_dim)
    np.testing.assert_allclose(
        tr.apply_rope_paired(torch.from_numpy(x), tt).numpy(),
        np.asarray(jr.apply_rope_paired(jnp.asarray(x), jt)), **TOL)


@pytest.mark.parametrize("parallel_num", [1, 4, 16])
def test_freqs_table_and_train_ids(parallel_num):
    """freqs_cis_table (ps-raster reorder in parallel mode) and the
    block/doc ids of the training mask at BitDance geometry; 1e-5 / exact."""
    jcfg = jia.config_b(parallel_num=parallel_num)
    tcfg = tia.config_b(parallel_num=parallel_num)
    np.testing.assert_allclose(tia.freqs_cis_table(tcfg).numpy(),
                               np.asarray(jia.freqs_cis_table(jcfg)), **TOL)
    for got, want in zip(tia.train_ids(tcfg), jia.train_ids(jcfg)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_bit_packing_roundtrips_and_matches_jax():
    rng = np.random.default_rng(1)
    bits = rng.integers(0, 2, (3, 5, 12)).astype(np.int32)
    idx = tq.bits_to_indices(torch.from_numpy(bits))
    np.testing.assert_array_equal(idx.numpy(),
                                  np.asarray(jq.bits_to_indices(jnp.asarray(bits))))
    np.testing.assert_array_equal(tq.indices_to_bits(idx, 12).numpy(), bits)
    np.testing.assert_array_equal(
        tq.indices_to_codes(idx, 12).numpy(),
        np.asarray(jq.indices_to_codes(jnp.asarray(idx.numpy()), 12)))
    lat = np.where(rng.normal(size=(2, 4, 4, 16)) > 0, 1.0, -1.0).astype(np.float32)
    np.testing.assert_array_equal(
        tq.latents_to_indices(torch.from_numpy(lat), 4).numpy(),
        np.asarray(jq.latents_to_indices(jnp.asarray(lat), 4)))


def test_flip_bits_uniform_prob_same_draws(monkeypatch):
    """With the same two uniform tables on both sides the flips are equal
    (exact); the port draws r1 then r2 from the passed generator."""
    rng = np.random.default_rng(2)
    x = np.where(rng.normal(size=(4, 16, 8)) > 0, 1.0, -1.0).astype(np.float32)
    r = [rng.random(x.shape).astype(np.float32) for _ in range(2)]
    jdraws, tdraws = iter(r), iter(r)
    monkeypatch.setattr(jax.random, "uniform",
                        lambda key, shape=(), dtype=jnp.float32: jnp.asarray(next(jdraws)))
    monkeypatch.setattr(torch, "rand",
                        lambda shape, generator=None, device=None: torch.from_numpy(next(tdraws)))
    want = np.asarray(jq.flip_bits_uniform_prob(jax.random.PRNGKey(0),
                                                jnp.asarray(x), 0.5))
    got = tq.flip_bits_uniform_prob(torch.from_numpy(x), 0.5).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got != x).mean() > 0.1


def test_flip_bits_rate_from_a_generator():
    """Marginal flip rate p_max / 2 (0.05 at 0.1), within 0.01 on 64k bits."""
    x = torch.ones((64, 1024))
    g = torch.Generator().manual_seed(0)
    flipped = (tq.flip_bits_uniform_prob(x, 0.1, g) < 0).float().mean().item()
    assert abs(flipped - 0.05) < 0.01


@pytest.mark.parametrize("training", [False, True])
def test_gfq_quantize_matches_jax(training):
    """Quantized values and indices exact; entropy and commit terms and the
    straight-through gradient of a weighted sum within 1e-5 (relative 1e-4
    for the entropies at temperature 0.01)."""
    rng = np.random.default_rng(3)
    z = _rand(rng, 2, 3, 3, 16)
    w = _rand(rng, 2, 3, 3, 16)
    jo = jgfq.gfq_quantize(jnp.asarray(z), 4, training=training)
    zt = torch.tensor(z, requires_grad=True)
    to = tgfq.gfq_quantize(zt, 4, training=training)
    np.testing.assert_array_equal(to.quantized.detach().numpy(), np.asarray(jo.quantized))
    np.testing.assert_array_equal(to.indices.numpy(), np.asarray(jo.indices))
    for name in ("entropy_loss", "commit_loss", "per_sample_entropy",
                 "codebook_entropy"):
        np.testing.assert_allclose(getattr(to, name).detach().numpy(),
                                   np.asarray(getattr(jo, name)), rtol=1e-4,
                                   atol=1e-5, err_msg=name)
    if training:
        def jloss(z):
            o = jgfq.gfq_quantize(z, 4, training=True)
            return jnp.sum(o.quantized * w) + o.entropy_loss + o.commit_loss

        want = np.asarray(jax.grad(jloss)(jnp.asarray(z)))
        (to.quantized * torch.from_numpy(w)).sum().add(
            to.entropy_loss + to.commit_loss).backward()
        np.testing.assert_allclose(zt.grad.numpy(), want, rtol=1e-4, atol=1e-5)


TINY_DD = dict(z_channels=8, in_channels=3, out_ch=3, ch=32, ch_mult=[1, 2],
               num_res_blocks=1)


def _encoder_pair(dd, seed=4):
    from bitdance_tpu.models.tokenizer import VQModel as JVQ
    from bitdance_tpu_torch.io.from_jax import flax_state_from_jax, load_into
    from bitdance_tpu_torch.models.tokenizer import VQModel

    jm = JVQ(ddconfig=dd)
    params = jm.init(jax.random.PRNGKey(seed), jnp.zeros((1, 16, 16, 3)),
                     method=JVQ.encode_raw)
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(   # non-zero biases, norm gains off 1
        lambda l: l + 0.05 * rng.normal(size=l.shape).astype(np.float32), params)
    tm = load_into(VQModel(dd, encoder=True, decoder=False),
                   flax_state_from_jax(params))
    return jm, params, tm


def test_encoder_encode_raw_matches_jax():
    """Encoder (conv_in, levels with strided downsample, mid blocks,
    GroupNorm32 + swish + 1x1 conv_out), NHWC in and out; 1e-4 (sums over
    3x3xC taps in another order)."""
    from bitdance_tpu.models.tokenizer import VQModel as JVQ

    jm, params, tm = _encoder_pair(TINY_DD)
    x = np.clip(_rand(np.random.default_rng(5), 2, 16, 16, 3) * 0.5, -1, 1)
    want = np.asarray(jm.apply(params, jnp.asarray(x), method=JVQ.encode_raw))
    with torch.no_grad():
        got = tm.encode_raw(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 8, 8, 8)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_encode_batch_matches_jax_training_script():
    """encode_raw -> gfq_quantize(4 codebooks, inference) -> grid_to_tokens,
    as scripts/train_imagenet.py encodes a batch; exact ±1 tokens wherever
    the encoder output is farther than 1e-3 from 0."""
    from bitdance_tpu.models.tokenizer import VQModel as JVQ
    from bitdance_tpu_torch.train.imagenet_train import encode_batch

    dd = dict(TINY_DD, z_channels=16, ch_mult=[1, 1, 2, 2, 4])
    jm, params, tm = _encoder_pair(dd, seed=6)
    jcfg = jia.ImageNetARConfig(resolution=32, latent_dim=16, cls_token_num=4)
    tcfg = tia.ImageNetARConfig(resolution=32, latent_dim=16, cls_token_num=4)
    x = np.clip(_rand(np.random.default_rng(7), 2, 32, 32, 3) * 0.5, -1, 1)
    raw = jm.apply(params, jnp.asarray(x), method=JVQ.encode_raw)
    want = np.asarray(jia.grid_to_tokens(
        jcfg, jgfq.gfq_quantize(raw, num_codebooks=4, training=False).quantized))
    got = encode_batch(tm, tcfg, torch.from_numpy(x)).numpy()
    margin = np.abs(np.asarray(jia.grid_to_tokens(jcfg, raw))) > 1e-3
    assert got.shape == want.shape == (2, 4, 16) and margin.mean() > 0.9
    np.testing.assert_array_equal(got[margin], want[margin])


@pytest.mark.parametrize("parallel_num,patch", [(1, 1), (1, 2), (4, 1)])
def test_grid_tokens_roundtrip_matches_jax(parallel_num, patch):
    kw = dict(resolution=128, down_size=16 // patch, patch_size=patch,
              latent_dim=4, parallel_num=parallel_num)
    jcfg, tcfg = jia.ImageNetARConfig(**kw), tia.ImageNetARConfig(**kw)
    lat = _rand(np.random.default_rng(8), 2, 8 * patch, 8 * patch, 4)
    tok = tia.grid_to_tokens(tcfg, torch.from_numpy(lat))
    np.testing.assert_array_equal(tok.numpy(),
                                  np.asarray(jia.grid_to_tokens(jcfg, jnp.asarray(lat))))
    np.testing.assert_array_equal(tia.tokens_to_grid(tcfg, tok).numpy(), lat)


def test_weight_bridges_round_trip():
    """JAX trees -> port modules (io/from_jax.py) -> the JAX package's own
    converters give back the same trees, exactly: the stacked backbone
    (parallel 4, with query tokens), the MlpEncoder head, the encoder."""
    from bitdance_tpu.io.torch_import import (
        convert_ae_state,
        convert_diffhead_state,
        convert_imagenet_ar_state,
    )
    from bitdance_tpu_torch.io.from_jax import (
        flax_state_from_jax,
        imagenet_ar_state_from_jax,
        load_into,
    )

    kw = dict(dim=64, n_layer=2, n_head=2, diff_layers=2, diff_dim=64,
              diff_adanln_layers=1, latent_dim=8, resolution=64,
              cls_token_num=4, num_classes=10, parallel_num=4)
    jcfg, tcfg = jia.ImageNetARConfig(**kw), tia.ImageNetARConfig(**kw)
    ar = jia.init_ar_params(jax.random.PRNGKey(0), jcfg)
    tm = load_into(tia.ImageNetAR(tcfg), imagenet_ar_state_from_jax(ar))
    back = convert_imagenet_ar_state(
        {k: v.detach() for k, v in tm.state_dict().items()}, kw["n_layer"])
    jax.tree_util.tree_map(np.testing.assert_array_equal, back, ar)

    kw1 = dict(kw, parallel_num=1)                  # the MlpEncoder head
    head = jia.make_head(jia.ImageNetARConfig(**kw1))
    hp = head.init(jax.random.PRNGKey(1), jnp.zeros((2, 8)), jnp.zeros((2, 64)),
                   jax.random.PRNGKey(2))
    th = load_into(tia.make_head(tia.ImageNetARConfig(**kw1)), flax_state_from_jax(hp))
    assert not th.net.attention and len(th.net.ada_ln_blocks[0].weight) == 3 * 64
    back = convert_diffhead_state({k: v.numpy() for k, v in th.state_dict().items()})
    jax.tree_util.tree_map(np.testing.assert_array_equal, back, hp)

    _, params, enc = _encoder_pair(TINY_DD)
    back = convert_ae_state({k: v.numpy() for k, v in enc.state_dict().items()})
    jax.tree_util.tree_map(np.testing.assert_array_equal, back, params)
