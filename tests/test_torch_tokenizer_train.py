"""The port's tokenizer training step against the JAX package's on the CPU:
tokenizer_loss and each of its terms on the same weights (carried by
io/from_jax.py) and images, the gradients of the loss, and a few steps that
improve the reconstruction (test_tokenizer_train_step_improves_recon)."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from bitdance_tpu.models import tokenizer as jtok
from bitdance_tpu.train import tokenizer_train as jtt
from bitdance_tpu_torch.io.from_jax import flax_state_from_jax, load_into
from bitdance_tpu_torch.models.tokenizer import VQModel
from bitdance_tpu_torch.train import tokenizer_train as ttt

torch.set_num_threads(2)
DD = dict(z_channels=8, in_channels=3, out_ch=3, ch=32, ch_mult=[1, 2],
          num_res_blocks=1)
# fp32 on both sides, the sums in another order (seen: 1e-6 of each term);
# the entropy terms see logits / 0.01, which scales the encoders' last-bit
# differences by 100
TOL = dict(rtol=1e-5, atol=1e-6)


def _pair(seed=0):
    jm = jtok.VQModel(ddconfig=DD)
    tcfg = jtt.TokenizerTrainConfig(lr=1e-3, warmup_steps=0, total_steps=100,
                                    num_codebooks=2)
    params = jm.init(jax.random.PRNGKey(seed), jnp.zeros((1, 16, 16, 3)),
                     noise_rng=jax.random.PRNGKey(0))
    tm = load_into(VQModel(DD, encoder=True, decoder=True), flax_state_from_jax(params))
    images = np.random.default_rng(seed + 1).uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32)
    return jm, params, tm, tcfg, images


def _port_cfg(tcfg):
    return ttt.TokenizerTrainConfig(**{f: getattr(tcfg, f) for f in
                                       ttt.TokenizerTrainConfig.__dataclass_fields__})


def test_tokenizer_loss_matches_jax():
    jm, params, tm, tcfg, images = _pair()
    (_, want), grads = jax.jit(jax.value_and_grad(
        lambda p: jtt.tokenizer_loss(p, jm, jnp.asarray(images),
                                     jax.random.PRNGKey(2), tcfg), has_aux=True))(params)
    loss, got = ttt.tokenizer_loss(tm, torch.from_numpy(images), _port_cfg(tcfg))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].item(), float(want[k]), err_msg=k, **TOL)
    assert got["entropy_loss"].item() != 0 and got["commit_loss"].item() > 0
    want_g = flax_state_from_jax(grads)
    got_g = dict(zip([n for n, _ in tm.named_parameters()],
                     torch.autograd.grad(loss, list(tm.parameters()))))
    assert set(got_g) == set(want_g)
    scale = max(float(np.abs(v).max()) for v in want_g.values())
    for name, g in got_g.items():
        # gradients through the sign's straight-through estimator and the
        # sharp entropy softmax: held to 3e-4 of the largest gradient (seen:
        # 6e-5)
        np.testing.assert_allclose(g.numpy(), want_g[name], rtol=0,
                                   atol=3e-4 * scale, err_msg=name)


def test_tokenizer_train_step_improves_recon():
    tcfg = ttt.TokenizerTrainConfig(lr=1e-3, warmup_steps=0, total_steps=100,
                                    num_codebooks=2)
    state = ttt.init_tokenizer_train(DD, tcfg, "cpu",
                                     generator=torch.Generator().manual_seed(0))
    assert state.ema is not None and all(p.requires_grad for p in state.tx.params)
    images = torch.from_numpy(np.random.default_rng(1).uniform(
        -1, 1, (2, 16, 16, 3)).astype(np.float32))
    _, m0 = ttt.tokenizer_loss(state.model, images, tcfg)
    step = ttt.make_tokenizer_train_step(tcfg)
    for _ in range(5):
        metrics = step(state, images)
    assert state.step == 5
    assert float(metrics["loss"]) < float(m0["loss"])
    assert float(metrics["l2"]) < float(m0["l2"])
    assert np.isfinite(float(metrics["grad_norm"]))
