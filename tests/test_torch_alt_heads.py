"""The head and connector leftovers against the JAX package on the CPU: the
TransEncoder's plain-MLP blocks (use_swiglu=False: the training loss and
guided sampling, which takes the per-call route), SwiGLUConnector, the three
alternative vision heads and the code helpers
(tests/test_alt_heads_and_inference.py's cases). Gaussian draws on both
sides come from one shape-keyed table."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bitdance_tpu.models import alt_heads as jalt
from bitdance_tpu.models.connector import SwiGLUConnector as JSwiGLU
from bitdance_tpu.models.diff_head import DiffHead as JHead
from bitdance_tpu_torch.io.from_jax import flax_state_from_jax, load_into
from bitdance_tpu_torch.io.random_init import init_head
from bitdance_tpu_torch.models import alt_heads as talt
from bitdance_tpu_torch.models import diff_head as tdh
from bitdance_tpu_torch.models.connector import SwiGLUConnector

torch.set_num_threads(2)
HEAD = dict(ch_target=8, ch_cond=64, ch_latent=128, depth_latent=2, depth_adanln=2,
            parallel_num=4, use_swiglu=False, P_mean=-0.8, P_std=0.8)


def _table(shape, seed=23):
    for d in shape:
        seed = (seed * 131 + int(d) + 7) % (2 ** 31 - 1)
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _randomized(tree, seed, scale=0.1):
    leaves, treedef = jax.tree_util.tree_flatten(tree)
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_unflatten(treedef, [
        jnp.asarray(scale * rng.normal(size=l.shape), jnp.float32) for l in leaves])


def _heads():
    jh = JHead(**HEAD)
    params = _randomized(jax.jit(lambda k: jh.init(k, jnp.zeros((2, 4, 8)), jnp.zeros((2, 4, 64)),
                                                   jax.random.PRNGKey(1)))(
        jax.random.PRNGKey(0)), 2)
    th = load_into(tdh.DiffHead(**HEAD, per_token_loss=True), flax_state_from_jax(params))
    return jh, params, th.eval()


def test_plain_mlp_head_tree_and_loss_match_jax(monkeypatch):
    """The blocks hold mlp.0 (C -> 1.5 C) and mlp.2 (convert_diffhead_state's
    mlp.(\\d+) rule); the per-token flow-matching loss on the same t and
    noise within 1e-5."""
    jh, params, th = _heads()
    blk = th.net.res_blocks[0]
    assert not hasattr(blk, "w1") and blk.mlp[0].weight.shape == (192, 128)
    assert not th.stackable and th._stack_for_sampler() is None
    monkeypatch.setattr(jax.random, "normal", lambda key, shape=(), dtype=jnp.float32:
                        jnp.asarray(_table(tuple(shape)), dtype))
    monkeypatch.setattr(torch, "randn", lambda shape, generator=None, device=None, **kw:
                        torch.from_numpy(_table(tuple(shape))))
    rng = np.random.default_rng(3)
    x = np.sign(rng.normal(size=(3, 4, 8))).astype(np.float32)
    cond = rng.normal(size=(3, 4, 64)).astype(np.float32)
    want = np.asarray(jh.apply(params, jnp.asarray(x), jnp.asarray(cond), jax.random.PRNGKey(4)))
    got = th(torch.from_numpy(x), torch.from_numpy(cond))
    assert got.shape == want.shape == (3, 4)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("cfg", [1.0, 3.0])
def test_plain_mlp_head_sample_matches_jax(cfg, monkeypatch):
    """Guided (cfg_mult 2) and unguided sampling over 4 steps: the JAX head
    runs euler_maruyama (its stacked and fused samplers refuse a plain-MLP
    head, _sample_shape_ok), the port its per-call route (the
    fused_attn_block kernel's plain version on the CPU) from the same
    table; fp32, 1e-4."""
    jh, params, th = _heads()
    monkeypatch.setattr(jax.random, "normal", lambda key, shape=(), dtype=jnp.float32:
                        jnp.asarray(_table(tuple(shape)), dtype))

    def table_noise(generator, half, ch, num_steps, device):
        t = torch.from_numpy(_table((half // 4, 4, ch))).reshape(half, ch)
        return t.clone(), t[None].repeat(num_steps, 1, 1)

    monkeypatch.setattr(tdh, "draw_sampler_noise", table_noise)
    cfg_mult = 2 if cfg > 1 else 1
    cond = np.random.default_rng(5).normal(size=(cfg_mult, 4, 64)).astype(np.float32)
    want = np.asarray(jh.apply(params, jnp.asarray(cond), jax.random.PRNGKey(6), cfg, 4,
                               cfg_mult=cfg_mult, method=JHead.sample))
    got = th.sample(torch.from_numpy(cond), torch.Generator(), cfg, 4, cfg_mult=cfg_mult)
    assert got.shape == want.shape == (1, 4, 8)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)


def test_plain_mlp_head_random_init_draws_every_weight():
    head = init_head(dict(HEAD), "cpu", torch.float32, torch.Generator().manual_seed(0))
    for name, p in head.named_parameters():
        assert p.abs().max() > 0, name


def test_swiglu_connector_matches_jax():
    jc = JSwiGLU(out_dim=48)
    x = np.random.default_rng(7).normal(size=(3, 5, 16)).astype(np.float32)
    params = _randomized(jc.init(jax.random.PRNGKey(0), jnp.asarray(x)), 8, 0.3)
    want = np.asarray(jc.apply(params, jnp.asarray(x)))
    tc = load_into(SwiGLUConnector(16, 48), flax_state_from_jax(params))
    assert tc.w1.weight.shape == (144, 16)
    with torch.no_grad():
        got = tc(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_standard_head_matches_jax():
    head = jalt.StandardVisionHead(vocab_size_vision=16, hidden_size=32)
    h = np.random.default_rng(0).normal(size=(5, 32)).astype(np.float32)
    labels = np.asarray([0, 3, 7, 15, 8])
    params = _randomized(head.init(jax.random.PRNGKey(1), jnp.asarray(h),
                                   jnp.zeros((5,), jnp.int32)), 1, 0.3)
    th = load_into(talt.StandardVisionHead(16, 32), flax_state_from_jax(params))
    ht, lt = torch.from_numpy(h), torch.from_numpy(labels)
    with torch.no_grad():
        logits, emb = th(ht, lt)
        loss = th.loss(ht, lt)
    np.testing.assert_allclose(logits.numpy(), np.asarray(head.apply(
        params, jnp.asarray(h), method=jalt.StandardVisionHead.logits)), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(emb.numpy(), np.asarray(head.apply(
        params, jnp.asarray(labels), method=jalt.StandardVisionHead.embed)))
    np.testing.assert_allclose(loss.numpy(), np.asarray(head.apply(
        params, jnp.asarray(h), jnp.asarray(labels), method=jalt.StandardVisionHead.loss)),
        rtol=1e-5, atol=1e-6)
    assert loss.shape == (5,) and emb.shape == (5, 32)


def test_code_helpers_match_jax():
    lat = np.sign(np.random.default_rng(2).normal(size=(5, 4))).astype(np.float32)
    codes = talt.codes_from_latents(torch.from_numpy(lat), 1)
    np.testing.assert_array_equal(codes.numpy(), np.asarray(
        jalt.codes_from_latents(jnp.asarray(lat), 1)))
    back = talt.latents_from_codes(codes[..., 0], 4)
    np.testing.assert_array_equal(back.numpy(), lat)
    lat8 = np.sign(np.random.default_rng(3).normal(size=(3, 8))).astype(np.float32)
    np.testing.assert_array_equal(
        talt.codes_from_latents(torch.from_numpy(lat8), 2).numpy(),
        np.asarray(jalt.codes_from_latents(jnp.asarray(lat8), 2)))


def _mlp_state(params):
    """The JAX MLP heads' Dense_0 / Dense_1 are the port's mlp.0 / mlp.2."""
    return {k.replace("Dense_0", "mlp.0").replace("Dense_1", "mlp.2"): v
            for k, v in flax_state_from_jax(params).items()}


def test_regression_heads_match_jax():
    rng = np.random.default_rng(0)
    h = rng.normal(size=(4, 32)).astype(np.float32)
    lat = np.sign(rng.normal(size=(4, 8))).astype(np.float32)
    reg = jalt.RegressionVisionHead(latent_dim=8, model_dim=16)
    rp = _randomized(reg.init(jax.random.PRNGKey(2), jnp.asarray(h)), 3, 0.3)
    treg = load_into(talt.RegressionVisionHead(32, 8, 16), _mlp_state(rp))
    with torch.no_grad():
        np.testing.assert_allclose(treg.loss(torch.from_numpy(h), torch.from_numpy(lat)).numpy(),
                                   np.asarray(reg.apply(rp, jnp.asarray(h), jnp.asarray(lat),
                                                        method=jalt.RegressionVisionHead.loss)),
                                   rtol=1e-5, atol=1e-6)
    gauss = jalt.GaussianRegressionVisionHead(latent_dim=8, model_dim=16)
    k = jax.random.PRNGKey(5)
    gp = _randomized(gauss.init(jax.random.PRNGKey(3), jnp.asarray(h), k), 4, 0.3)
    tg = load_into(talt.GaussianRegressionVisionHead(32, 8, 16), _mlp_state(gp))
    eps = torch.from_numpy(np.array(jax.random.normal(k, (4, 8), jnp.float32)))
    with torch.no_grad():
        s = tg(torch.from_numpy(h), eps)
        loss = tg.loss(torch.from_numpy(h), torch.from_numpy(lat), eps)
        s1 = tg(torch.from_numpy(h), generator=torch.Generator().manual_seed(5))
        s2 = tg(torch.from_numpy(h), generator=torch.Generator().manual_seed(6))
        with pytest.raises(ValueError, match="eps= or generator="):
            tg(torch.from_numpy(h))
    np.testing.assert_allclose(s.numpy(), np.asarray(gauss.apply(gp, jnp.asarray(h), k)),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(loss.numpy(), np.asarray(gauss.apply(
        gp, jnp.asarray(h), jnp.asarray(lat), k, method=jalt.GaussianRegressionVisionHead.loss)),
        rtol=1e-5, atol=1e-6)
    assert s1.shape == (4, 8) and not torch.allclose(s1, s2)          # stochastic
