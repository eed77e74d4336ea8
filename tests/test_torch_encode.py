"""The port's tokenizer encode path vs the JAX package: the fused encode
tail (kernel #13's plain version against the Pallas kernel in interpret
mode), ``VQModel.encode``, ``latents_to_tokens``, ``reconstruct`` and the
PSNR / SSIM metrics, at a tiny ddconfig.

±1 latents are compared exactly only where the pre-sign value clears a
1e-3 margin (the sign-margin guard of tests/test_reference_parity.py:472);
the model and image seeds here leave every value clear of it, which each
test asserts.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bitdance_tpu.eval import recon as jrecon
from bitdance_tpu.models import tokenizer as jtok
from bitdance_tpu.ops import fused_encode as jfe
from bitdance_tpu_torch.eval import recon as trecon
from bitdance_tpu_torch.io.from_jax import flax_state_from_jax, load_into
from bitdance_tpu_torch.models import tokenizer as ttok
from bitdance_tpu_torch.ops import fused_encode as tfe

torch.set_num_threads(2)
MARGIN = 1e-3
TINY_DD = dict(z_channels=32, in_channels=3, out_ch=3, ch=32, ch_mult=[1, 2],
               num_res_blocks=1)


def _tail_inputs(shape, seed):
    rng = np.random.default_rng(seed)
    b, h, w, c = shape
    x = (1.5 * rng.normal(size=shape) + 0.3).astype(np.float32)
    gw = (1 + 0.2 * rng.normal(size=c)).astype(np.float32)
    gb = (0.2 * rng.normal(size=c)).astype(np.float32)
    cw = (rng.normal(size=(c, 32)) / np.sqrt(c)).astype(np.float32)
    cb = (0.1 * rng.normal(size=32)).astype(np.float32)
    return x, gw, gb, cw, cb


@pytest.mark.parametrize("shape", [(2, 4, 4, 64), (1, 8, 6, 128), (3, 2, 2, 32)])
def test_encode_tail_matches_pallas_interpret(shape):
    """Raw tail output (quantize=False) within 1e-5 of the Pallas kernel's
    (fp32; statistics summed in another order), and the ±1 output exact
    wherever the raw value clears the margin."""
    x, gw, gb, cw, cb = _tail_inputs(shape, sum(shape))
    raw_j = np.asarray(jfe.fused_encode_tail(x, gw, gb, cw, cb, quantize=False,
                                             interpret=True))
    sgn_j = np.asarray(jfe.fused_encode_tail(x, gw, gb, cw, cb, interpret=True))
    t = [torch.from_numpy(a) for a in (x, gw, gb, cw, cb)]
    raw_t = tfe.fused_encode_tail_reference(*t, quantize=False).numpy()
    np.testing.assert_allclose(raw_t, raw_j, rtol=1e-5, atol=1e-5)
    clear = np.abs(raw_j) > MARGIN
    assert clear.mean() > 0.99
    sgn_t = tfe.fused_encode_tail(*t).numpy()            # the wrapper on CPU
    assert set(np.unique(sgn_t)) <= {-1.0, 1.0}
    np.testing.assert_array_equal(sgn_t[clear], sgn_j[clear])


def test_encode_tail_bf16_follows_the_kernels_casts():
    """In bf16 the activations are rounded to the weight's type before an
    fp32-accumulated product and the output is bf16, as the TPU kernel
    does: within two bf16 ulps of the JAX kernel's raw output."""
    x, gw, gb, cw, cb = _tail_inputs((2, 4, 4, 64), 5)
    xb, cwb = jnp.asarray(x, jnp.bfloat16), jnp.asarray(cw, jnp.bfloat16)
    want = np.asarray(jfe.fused_encode_tail(xb, gw, gb, cwb, cb, quantize=False,
                                            interpret=True)).astype(np.float32)
    got = tfe.fused_encode_tail_reference(
        torch.from_numpy(x).bfloat16(), torch.from_numpy(gw), torch.from_numpy(gb),
        torch.from_numpy(cw).bfloat16(), torch.from_numpy(cb), quantize=False)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2 ** -7, atol=2 ** -7)


def test_encode_tail_refuses_other_devices():
    x = torch.zeros((1, 2, 2, 32), device="meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        tfe.fused_encode_tail(x, x[0, 0, 0], x[0, 0, 0], x[0, 0], x[0, 0, 0])


def _models(seed=0):
    jm = jtok.VQModel(ddconfig=TINY_DD)
    params = jm.init(jax.random.PRNGKey(seed), jnp.zeros((1, 16, 16, 3)))
    leaves, treedef = jax.tree_util.tree_flatten(params)
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_unflatten(treedef, [
        jnp.asarray(np.asarray(l) + 0.1 * rng.normal(size=l.shape), jnp.float32)
        for l in leaves])
    tm = ttok.VQModel(TINY_DD, encoder=True, decoder=True)
    load_into(tm, flax_state_from_jax(params))
    return jm, params, tm.eval()


def _images(n, side, seed):
    rng = np.random.default_rng(seed)
    return np.clip(rng.normal(size=(n, side, side, 3)) * 0.5, -1, 1).astype(np.float32)


def test_vq_encode_matches_jax_and_the_fused_tail():
    """VQModel.encode on the CPU (encoder + sign) vs the JAX encode, exact
    under the margin; the trunk + fused tail (the card's route, here its
    plain version) gives the same ±1 latents."""
    jm, params, tm = _models(seed=4)
    x = _images(2, 16, 1)
    raw = np.asarray(jm.apply(params, jnp.asarray(x), method=jtok.VQModel.encode_raw))
    want = np.asarray(jm.apply(params, jnp.asarray(x), method=jtok.VQModel.encode))
    clear = np.abs(raw) > MARGIN
    assert clear.all()
    with torch.no_grad():
        got = tm.encode(torch.from_numpy(x))
        h = tm.encoder.trunk(tm._nchw(torch.from_numpy(x))).permute(0, 2, 3, 1)
        w = tm.encoder.conv_out.weight
        fused = tfe.fused_encode_tail_reference(
            h, tm.encoder.norm_out.weight, tm.encoder.norm_out.bias,
            w.reshape(w.shape[0], -1).t(), tm.encoder.conv_out.bias)
    assert got.shape == want.shape == (2, 8, 8, 32)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(fused.numpy(), want)


def test_reconstruct_matches_jax():
    """reconstruct (encode -> ±1 -> decode, one image a batch) vs
    reconstruct_jax: the same latents, images within 2e-4 (fp32 convs)."""
    jm, params, tm = _models(seed=4)
    imgs = _images(2, 16, 1)
    raw = np.asarray(jm.apply(params, jnp.asarray(imgs), method=jtok.VQModel.encode_raw))
    assert (np.abs(raw) > MARGIN).all()
    want = jrecon.reconstruct_jax(TINY_DD, params, imgs, batch=1)
    lat = []
    got = trecon.reconstruct(tm, imgs, batch=1, latents_out=lat)
    assert got.shape == imgs.shape and got.dtype == np.float32
    assert [tuple(q.shape) for q in lat] == [(1, 8, 8, 32)] * 2
    np.testing.assert_array_equal(torch.cat(lat).numpy(), np.where(raw > 0, 1.0, -1.0))
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    assert abs(trecon.psnr(imgs, got) - jrecon.psnr(imgs, want)) < 1e-3


def test_psnr_ssim_and_tokens_match_jax():
    rng = np.random.default_rng(4)
    a = rng.uniform(-1, 1, (2, 3, 24, 20))
    b = np.clip(a + 0.1 * rng.normal(size=a.shape), -1, 1)
    assert trecon.psnr(a, b) == jrecon.psnr(a, b)
    assert trecon.ssim(a, b) == pytest.approx(jrecon.ssim(a, b), rel=1e-12)
    assert trecon.psnr(a, a) == float("inf")
    q = rng.normal(size=(2, 4, 6, 5)).astype(np.float32)
    for ps in (1, 2):
        np.testing.assert_array_equal(
            ttok.latents_to_tokens(torch.from_numpy(q), ps).numpy(),
            np.asarray(jtok.latents_to_tokens(jnp.asarray(q), ps)))
        np.testing.assert_array_equal(ttok.tokens_to_latents(
            ttok.latents_to_tokens(torch.from_numpy(q), ps), 4, 6, ps).numpy(), q)
