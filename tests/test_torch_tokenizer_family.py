"""The tokenizer family against the JAX package on the CPU at the JAX tests'
tiny sizes (ch 32, ch_mult [1, 2]): the GAN decoder (the JAX noise passed
to the port explicitly), the W8A8 convolution and decoder (conv_int8), the
UniWeTok tokenizer (tests/test_tokenizer_uni.py's TINY_DD), its RoPE
tables, the parameter names both ways, and BatchedEncoder."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bitdance_tpu.io import torch_import as jti
from bitdance_tpu.models import tokenizer as jtok
from bitdance_tpu.models import tokenizer_uni as juni
from bitdance_tpu.models.vt_encode import BatchedEncoder as JBatched
from bitdance_tpu_torch.io.from_jax import flax_state_from_jax, load_into
from bitdance_tpu_torch.io.release import remap_ema_state
from bitdance_tpu_torch.models import tokenizer as ttok
from bitdance_tpu_torch.models import tokenizer_uni as tuni
from bitdance_tpu_torch.models.vt_encode import BatchedEncoder, bucket_of, is_long_image

torch.set_num_threads(2)
# fp32 on both sides, sums in another order (test_torch_tokenizer.py's bound)
TOL = dict(rtol=2e-4, atol=2e-4)
TINY_DD = dict(z_channels=8, in_channels=3, out_ch=3, ch=32, ch_mult=[1, 2],
               num_res_blocks=1)
UNI_DD = dict(TINY_DD, attn_blocks=1, n_heads=4)
SIGN_MARGIN = 1e-3


def _perturbed(params, seed, scale=0.1):
    """Every leaf moved by N(0, scale), so gains, biases and AdaGN count."""
    leaves, treedef = jax.tree_util.tree_flatten(params)
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_unflatten(treedef, [
        jnp.asarray(np.asarray(l) + scale * rng.normal(size=l.shape), jnp.float32)
        for l in leaves])


def _latents(shape, seed):
    return np.sign(np.random.default_rng(seed).normal(size=shape)).astype(np.float32)


def _sharpened(params, gain=10.0):
    """The encoder's conv_out scaled by ``gain``: fewer raw values near 0,
    so the sign-margin guards below hold at more seeds."""
    enc = dict(params["params"]["encoder"])
    enc["conv_out"] = jax.tree_util.tree_map(lambda a: a * gain, enc["conv_out"])
    return {"params": dict(params["params"], encoder=enc)}


@functools.lru_cache(maxsize=None)
def _gan_pair(seed=0):
    jm = jtok.VQModel(ddconfig=TINY_DD, gan_decoder=True)
    params = _perturbed(jax.jit(lambda k, z, n: jm.init(
        k, z, method=jtok.VQModel.decode, noise_rng=n))(
            jax.random.PRNGKey(seed), jnp.zeros((1, 4, 4, 8)), jax.random.PRNGKey(1)), seed)
    tm = load_into(ttok.VQModel(TINY_DD, gan_decoder=True), flax_state_from_jax(params))
    return jm, params, tm.eval()


def test_gan_decode_matches_jax_with_its_noise():
    jm, params, tm = _gan_pair()
    z = _latents((2, 4, 6, 8), 1)
    k = jax.random.PRNGKey(7)
    want = np.asarray(jax.jit(lambda p, z, k: jm.apply(
        p, z, method=jtok.VQModel.decode, noise_rng=k))(params, jnp.asarray(z), k))
    noise = np.array(jax.random.normal(k, z.shape, jnp.float32))
    assert tm.decoder.conv_in.weight.shape[1] == 16       # latents + noise
    with torch.no_grad():
        got = tm.decode(torch.from_numpy(z), noise=torch.from_numpy(noise)).numpy()
    assert got.shape == want.shape == (2, 8, 12, 3)
    np.testing.assert_allclose(got, want, **TOL)


def test_gan_decode_noise_comes_from_an_explicit_generator():
    _, _, tm = _gan_pair()
    z = torch.from_numpy(_latents((1, 4, 4, 8), 2))
    with torch.no_grad():
        a = tm.decode(z, generator=torch.Generator().manual_seed(3))
        b = tm.decode(z, generator=torch.Generator().manual_seed(3))
        c = tm.decode(z, generator=torch.Generator().manual_seed(4))
        # the draw is standard normal in the latents' NHWC shape
        n = torch.randn((1, 4, 4, 8), generator=torch.Generator().manual_seed(3))
        d = tm.decode(z, noise=n)
        with pytest.raises(ValueError, match="noise= or generator="):
            tm.decode(z)
        with pytest.raises(ValueError, match="decoder noise"):
            tm.decode(z, noise=n[..., :4])
    assert torch.equal(a, b) and torch.equal(a, d) and not torch.allclose(a, c)


@pytest.mark.parametrize("k,bias", [(3, True), (1, False)])
def test_conv2d_quant_bit_equal_to_jax(k, bias):
    conv = jtok.Conv2D(16, (k, k), padding=k // 2, use_bias=bias, quant=True)
    x = np.random.default_rng(3).normal(size=(2, 5, 7, 12)).astype(np.float32)
    x[1] *= 4.0                                           # per-image scales differ
    params = _perturbed(conv.init(jax.random.PRNGKey(1), jnp.asarray(x)), 2)
    want = np.asarray(conv.apply(params, jnp.asarray(x)))
    tc = load_into(ttok.Conv2D(12, 16, k, bias=bias, quant=True),
                   flax_state_from_jax(params))
    with torch.no_grad():
        got = tc(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_array_equal(got, want)


def test_conv_int8_chunks_give_the_same_sums(monkeypatch):
    """The im2col chunks over output rows (a 1024 px decode needs them)
    sum exactly what one chunk sums."""
    g = torch.Generator().manual_seed(0)
    xq = torch.randint(-127, 128, (2, 9, 11, 24), generator=g).to(torch.int8)
    wq = torch.randint(-127, 128, (16, 9 * 24), generator=g).to(torch.int8)
    whole = ttok.conv_int8_acc(xq, wq, 3)
    monkeypatch.setattr(ttok, "CONV_INT8_CHUNK_BYTES", 2 * 11 * 9 * 24 * 2)
    chunked = ttok.conv_int8_acc(xq, wq, 3)
    want = torch.nn.functional.conv2d(
        xq.permute(0, 3, 1, 2).double(),
        wq.double().reshape(16, 3, 3, 24).permute(0, 3, 1, 2), padding=1)
    assert torch.equal(whole, chunked)
    assert torch.equal(whole.permute(0, 3, 1, 2).double(), want)


def test_conv_int8_decoder_matches_jax():
    """The whole W8A8 decoder: the plain parameter tree, within 1e-3
    relative L2 of JAX's conv_int8 decode (integer sums exact on both sides;
    GroupNorm and the fp32 glue in another order), and within JAX's 0.08 of
    the float decode (tests/test_tokenizer.py)."""
    jf = jtok.VQModel(ddconfig=TINY_DD)
    jq = jtok.VQModel(ddconfig=TINY_DD, conv_int8=True)
    params = _perturbed(jf.init(jax.random.PRNGKey(0), jnp.zeros((1, 4, 4, 8)),
                                method=jtok.VQModel.decode), 5)
    z = _latents((2, 4, 6, 8), 6)
    want_q, want_f = (np.asarray(m.apply(params, jnp.asarray(z), method=jtok.VQModel.decode))
                      for m in (jq, jf))
    tq = load_into(ttok.VQModel(TINY_DD, conv_int8=True), flax_state_from_jax(params))
    assert set(tq.state_dict()) == set(ttok.VQModel(TINY_DD).state_dict())
    assert sum(m.quant for m in tq.modules() if isinstance(m, ttok.Conv2D)) == 8
    with torch.no_grad():
        got = tq.eval().decode(torch.from_numpy(z)).numpy()
    rel = lambda a, b: np.linalg.norm(a - b) / np.linalg.norm(b)  # noqa: E731
    assert rel(got, want_q) < 1e-3, rel(got, want_q)
    assert rel(got, want_f) < 0.08, rel(got, want_f)


@functools.lru_cache(maxsize=None)
def _uni_pair(seed=0):
    jm = juni.UniVQModel(ddconfig=UNI_DD)
    params = _sharpened(_perturbed(jax.jit(lambda k, x, n: jm.init(k, x, noise_rng=n))(
        jax.random.PRNGKey(seed), jnp.zeros((1, 16, 16, 3)), jax.random.PRNGKey(1)), seed))
    tm = load_into(tuni.UniVQModel(UNI_DD), flax_state_from_jax(params))
    return jm, params, tm.eval()


def test_uni_encode_and_decode_match_jax(monkeypatch):
    jm, params, tm = _uni_pair()
    x = np.random.default_rng(4).uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32)
    apply = jax.jit(lambda p, x, k: (
        jm.apply(p, x, method=juni.UniVQModel.encode_raw),
        jm.apply(p, x, method=juni.UniVQModel.encode),
        jm.apply(p, jm.apply(p, x, method=juni.UniVQModel.encode),
                 method=juni.UniVQModel.decode, noise_rng=k)))
    k = jax.random.PRNGKey(9)
    want_raw, want_q, want = (np.asarray(a) for a in apply(params, jnp.asarray(x), k))
    margins = []
    real_sign = tuni.sign_quantize

    def spy_sign(h):
        margins.append(float(h.abs().min()))
        return real_sign(h)

    monkeypatch.setattr(tuni, "sign_quantize", spy_sign)
    with torch.no_grad():
        raw = tm.encode_raw(torch.from_numpy(x)).numpy()
        q = tm.encode(torch.from_numpy(x)).numpy()
    assert np.abs(raw).max() <= 1.0                       # SigLu bound
    np.testing.assert_allclose(raw, want_raw, rtol=1e-4, atol=1e-5)
    assert min(margins) > SIGN_MARGIN, f"borderline sign margin {min(margins)}"
    np.testing.assert_array_equal(q, want_q)
    noise = torch.from_numpy(np.array(jax.random.normal(k, want_q.shape, jnp.float32)))
    with torch.no_grad():
        got = tm.decode(torch.from_numpy(q), noise=noise).numpy()
    assert got.shape == want.shape == (2, 16, 16, 3)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("h,w,decoder", [(6, 6, False), (6, 6, True), (4, 7, True),
                                         (1, 3, False)])
def test_mid_freqs_match_jax(h, w, decoder):
    want = np.asarray(juni._mid_freqs(h, w, 16, 4, decoder=decoder))
    got = tuni.mid_freqs(h, w, 16, 4, decoder).numpy()
    assert got.shape == want.shape == (4 + h * w, 8, 2)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def _structure(tree):
    return {jax.tree_util.keystr(p): tuple(v.shape)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("kind", ["gan", "uni"])
def test_port_names_map_onto_the_jax_tree(kind):
    """port state_dict() -> convert_ae_state gives the JAX tree's structure
    and shapes. convert_ae_state refuses the UniWeTok ``register_token``
    leaf (its leaf converter knows weight and bias only), so those two
    leaves are checked apart."""
    if kind == "gan":
        params = jax.eval_shape(lambda: jtok.VQModel(ddconfig=TINY_DD, gan_decoder=True).init(
            jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 3)), noise_rng=jax.random.PRNGKey(1)))
        tm = ttok.VQModel(TINY_DD, encoder=True, gan_decoder=True)
    else:
        _, params, tm = _uni_pair()
    state = {k: v.numpy() for k, v in tm.state_dict().items()}
    regs = {k: state.pop(k) for k in list(state) if k.endswith("register_token")}
    assert len(regs) == (2 if kind == "uni" else 0)
    if regs:
        with pytest.raises(ValueError, match="register_token"):
            jti.convert_ae_state(regs)
    want = _structure(params["params"])
    got = _structure(jti.convert_ae_state(state)["params"])
    for k, v in regs.items():
        got["".join(f"['{p}']" for p in k.split("."))] = v.shape
    assert got == want


def test_remap_ema_state_on_a_uni_tree_matches_jax():
    _, _, tm = _uni_pair()
    state = {k: v.numpy() for k, v in tm.state_dict().items()}
    rng = np.random.default_rng(3)
    for k in list(state)[::3]:
        state["model_ema." + k.replace(".", "")] = rng.normal(
            size=state[k].shape).astype(np.float32)
    want = jti.remap_ema_state(state)
    got = remap_ema_state({k: torch.from_numpy(v) for k, v in state.items()})
    assert set(got) == set(want) == set(tm.state_dict())
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), want[k])
    load_into(tuni.UniVQModel(UNI_DD), {k: np.asarray(v) for k, v in got.items()})


def _images():
    rng = np.random.default_rng(11)
    shapes = [(8, 8), (16, 8), (8, 8), (12, 20), (24, 8), (16, 8)]
    return [rng.uniform(-1, 1, (h, w, 3)).astype(np.float32) for h, w in shapes]


@pytest.mark.parametrize("mode", ["group", "maxpad"])
def test_batched_encoder_matches_jax(mode, monkeypatch):
    """Packed ±1 tokens equal JAX's exactly, once every raw value the port
    signs clears SIGN_MARGIN. maxpad with stride 4 and buckets (8, 16):
    three buckets (8, 16 and "long" through the buckets' end), padding and
    crops."""
    jm = jtok.VQModel(ddconfig=TINY_DD)
    params = _sharpened(_perturbed(jm.init(jax.random.PRNGKey(2), jnp.zeros((1, 8, 8, 3)),
                                           method=jtok.VQModel.encode_raw), 8))
    tm = load_into(ttok.VQModel(TINY_DD, encoder=True, decoder=False),
                   flax_state_from_jax(params)).eval()
    imgs = _images()
    margins = []
    real_sign = ttok.sign_quantize
    monkeypatch.setattr(ttok, "sign_quantize",
                        lambda h: margins.append(float(h.abs().min())) or real_sign(h))
    jenc, tenc = JBatched(jm, params, ps=2), BatchedEncoder(tm, ps=2)
    if mode == "group":
        want = np.asarray(jenc.vt_forward(imgs, max_bs=2))
        got = tenc.vt_forward(imgs, max_bs=2)
        n = sum(h * w // 4 for h, w in (im.shape[:2] for im in imgs))
        single = tenc.vt_forward([imgs[3]])
        start = sum(im.shape[0] * im.shape[1] // 4 for im in imgs[:3])
        assert torch.equal(got[start:start + single.shape[0]], single)
    else:
        kw = dict(max_bs=2, stride=4, normal_buckets=(8, 16))
        want = np.asarray(jenc.vt_forward_maxpad(imgs, **kw))
        got = tenc.vt_forward_maxpad(imgs, **kw)
        n = sum(-(-h // 4) * -(-w // 4) for h, w in (im.shape[:2] for im in imgs))
    assert min(margins) > SIGN_MARGIN, f"borderline sign margin {min(margins)}"
    assert got.shape == want.shape == (n, 8)
    np.testing.assert_array_equal(got.numpy(), want)


def test_batched_encoder_takes_a_uni_model():
    """vt_forward on a UniVQModel: each image's tokens are its own encode's
    (ps-raster), batched or alone."""
    _, _, tm = _uni_pair()
    imgs = [im for im in _images() if im.shape[0] % 4 == 0 and im.shape[1] % 4 == 0][:3]
    enc = BatchedEncoder(tm, ps=2)
    got = enc.vt_forward(imgs, max_bs=2)
    with torch.no_grad():
        want = torch.cat([ttok.latents_to_tokens(tm.encode(torch.from_numpy(im[None])), 2)[0]
                          for im in imgs])
    assert torch.equal(got, want)


@pytest.mark.parametrize("hw,bucket,long", [
    ((1024, 640), "long", True), ((640, 1024), "long", True),
    ((1024, 768), 1024, False), ((1024, 683), 1024, False),
    ((1536, 1024), "long", False), ((384, 200), 384, False),
    ((500, 300), 512, False), ((700, 768), 768, False)])
def test_maxpad_buckets(hw, bucket, long):
    """The reference's buckets: "long" (major >= 1024, minor <= 768, aspect
    >= 1.5), else the first of 384 / 512 / 768 / 1024 the major side fits,
    else "long"."""
    assert bucket_of(*hw) == bucket
    assert is_long_image(*hw) == long


def test_vq_names_keep_the_diffhead_rule():
    """from_jax keeps ``block_{i}`` under a ``mid_attn`` stack only: a
    DiffHead's blocks still map to ``res_blocks.{i}``."""
    got = flax_state_from_jax({"net": {"block_0": {"norm1": {"weight": np.ones(2)}}},
                               "mid_attn": {"block_0": {"ffn_norm": {"weight": np.ones(2)}},
                                            "register_token": np.ones((4, 2))}})
    assert set(got) == {"net.res_blocks.0.norm1.weight", "mid_attn.block_0.ffn_norm.weight",
                        "mid_attn.register_token"}
