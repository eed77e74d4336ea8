"""The port's ImageNet training slice vs the JAX package on the same weights
and draws: the MlpEncoder head's loss, ``forward_train`` at BitDance-S
(parallel 1 and 4), and whole ``train_step``s with optax (one and two
steps, with and without warmup, fp32 and bf16 mixed precision).

Every random draw is replaced on both sides by shape-keyed tables (the
k-th normal or uniform draw of a shape gets the same values in both
frameworks), as tests/test_reference_parity.py does for normals.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from bitdance_tpu.models import imagenet_ar as jia
from bitdance_tpu.train import imagenet_train as jit_
from bitdance_tpu.train import optim as jopt
from bitdance_tpu_torch.io.from_jax import imagenet_train_state_from_jax, load_into
from bitdance_tpu_torch.models import imagenet_ar as tia
from bitdance_tpu_torch.train import imagenet_train as tit
from bitdance_tpu_torch.train import optim as topt

torch.set_num_threads(2)


class _Draws:
    """Deterministic tables keyed by (kind, shape, k): the k-th draw of a
    kind and shape on one side equals the k-th on the other."""

    def __init__(self):
        self.counts = {"jax": {}, "torch": {}}

    def __call__(self, side, kind, shape):
        shape = tuple(int(s) for s in shape)
        key = (kind, shape)
        k = self.counts[side].get(key, 0)
        self.counts[side][key] = k + 1
        seed = 5 + 7919 * k + (104729 if kind == "uniform" else 0)
        for d in shape:
            seed = (seed * 131 + d + 7) % (2 ** 31 - 1)
        rng = np.random.default_rng(seed)
        if kind == "normal":
            return rng.standard_normal(shape).astype(np.float32)
        return rng.random(shape).astype(np.float32)


def _patch_draws(monkeypatch):
    draws = _Draws()
    monkeypatch.setattr(
        jax.random, "normal", lambda key, shape=(), dtype=jnp.float32:
        jnp.asarray(draws("jax", "normal", shape), dtype))
    monkeypatch.setattr(
        jax.random, "uniform", lambda key, shape=(), dtype=jnp.float32, minval=0.0,
        maxval=1.0: jnp.asarray(draws("jax", "uniform", shape), dtype))
    monkeypatch.setattr(
        torch, "randn", lambda shape, generator=None, device=None:
        torch.from_numpy(draws("torch", "normal", shape)).to(device))
    monkeypatch.setattr(
        torch, "rand", lambda shape, generator=None, device=None:
        torch.from_numpy(draws("torch", "uniform", shape)).to(device))
    return draws


TINY = dict(dim=64, n_layer=2, n_head=2, diff_layers=2, diff_dim=64,
            diff_adanln_layers=1, latent_dim=8, down_size=16, patch_size=1,
            resolution=64, cls_token_num=4, num_classes=10, diff_batch_mul=2,
            perturb_rate=0.1)


def _jax_params(jcfg, seed, head_dtype=jnp.float32, noise=0.05):
    """JAX init, every leaf moved by N(0, noise) so that the zero-initialised
    adaLN and final layers are non-zero (a zero final layer would leave the
    backbone without gradient). Returns (params, head module)."""
    head = jia.make_head(jcfg, dtype=head_dtype)
    shape = ((2, jcfg.parallel_num, jcfg.token_dim) if jcfg.parallel_num > 1
             else (2, jcfg.token_dim))
    cshape = shape[:-1] + (jcfg.dim,)
    params = {"ar": jia.init_ar_params(jax.random.PRNGKey(seed), jcfg),
              "head": head.init(jax.random.PRNGKey(seed + 1), jnp.zeros(shape),
                                jnp.zeros(cshape), jax.random.PRNGKey(0))}
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(
        lambda l: jnp.asarray(np.asarray(l) + noise * rng.standard_normal(l.shape),
                              jnp.float32), params)
    return params, head


def _port_model(tcfg, params):
    return load_into(tit.ImageNetTrainModel(tcfg), imagenet_train_state_from_jax(params))


def _batch(cfg_kw, b=2, seed=3):
    rng = np.random.default_rng(seed)
    n = (cfg_kw["resolution"] // cfg_kw["down_size"]) ** 2
    tokens = np.where(rng.normal(size=(b, n, cfg_kw["latent_dim"])) > 0, 1.0,
                      -1.0).astype(np.float32)
    cls = rng.integers(0, cfg_kw["num_classes"], b).astype(np.int32)
    return tokens, cls


def test_mlp_head_loss_matches_jax(monkeypatch):
    """DiffHead (MlpEncoder, 2 blocks, 1 adaLN group) flow-matching loss on
    the same t and noise; fp32, relative 1e-5."""
    _patch_draws(monkeypatch)
    jcfg = jia.ImageNetARConfig(**TINY)
    params, head = _jax_params(jcfg, 0)
    model = _port_model(tia.ImageNetARConfig(**TINY), params)
    rng = np.random.default_rng(1)
    x = np.where(rng.normal(size=(40, 8)) > 0, 1.0, -1.0).astype(np.float32)
    cond = rng.normal(size=(40, 64)).astype(np.float32)
    want = float(head.apply(params["head"], jnp.asarray(x), jnp.asarray(cond),
                            jax.random.PRNGKey(0)))
    got = model.head(torch.from_numpy(x), torch.from_numpy(cond)).item()
    np.testing.assert_allclose(got, want, rtol=1e-5)


@pytest.mark.parametrize("parallel_num", [1, 4])
def test_forward_train_matches_jax_at_bitdance_s(monkeypatch, parallel_num):
    """forward_train at config_s (256 px, 319 / 322 tokens, dim 256, 4
    layers, head dim 64) with class dropout and bit-flip perturbation on,
    fp32, relative 1e-4: the loss and the gradient norms of backbone and head
    (parallel 1, MlpEncoder head); the head's inputs and the backbone's
    gradient norm under a linear stand-in head (parallel 4: block windows,
    query tokens, ps-raster RoPE; the TransEncoder head's training forward
    is not ported). The port's kernel route (the plain flash versions on
    CPU) gives the same result as its dense route (no row is fully masked)."""
    draws = _patch_draws(monkeypatch)
    kw = dict(parallel_num=parallel_num, perturb_rate=0.1)
    jcfg, tcfg = jia.config_s(**kw), tia.config_s(**kw)
    params, head = _jax_params(jcfg, 2, noise=0.02)
    model = _port_model(tcfg, params)
    tokens, cls = _batch(dict(resolution=256, down_size=16, latent_dim=16,
                              num_classes=1000))
    seen = {}
    if parallel_num > 1:
        rows = 2 * 256 // parallel_num * jcfg.diff_batch_mul
        w = np.random.default_rng(9).normal(size=(rows, parallel_num, 256))
        w = w.astype(np.float32)

        class JaxStandIn:
            def apply(self, hp, target, x, rng):
                seen["jax"] = (target, x)
                return jnp.sum(x.astype(jnp.float32) * w)

        def port_stand_in(target, x, generator):
            seen["port"] = (target, x)
            return (x.float() * torch.from_numpy(w)).sum()

        head = JaxStandIn()
        model.head.forward = port_stand_in

    def jloss(p):
        return jia.forward_train(p["ar"], head, p["head"], jcfg, jnp.asarray(tokens),
                                 jnp.asarray(cls), jax.random.PRNGKey(0))

    jg = jax.grad(jloss)(params)
    draws.counts["jax"].clear()     # again, outside the trace, for the inputs
    want = jloss(params)
    for implementation in ("auto", "kernel"):
        draws.counts["torch"].clear()                  # the same draws again
        model.zero_grad()
        got = model(torch.from_numpy(tokens), torch.from_numpy(cls).long(),
                    implementation=implementation)
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-4)
        got.backward()
        for part in ("ar", "head") if parallel_num == 1 else ("ar",):
            tn = topt.global_norm([p.grad for n, p in model.named_parameters()
                                   if n.startswith(part + ".")]).item()
            np.testing.assert_allclose(tn, float(optax.global_norm(jg[part])),
                                       rtol=1e-4, err_msg=part)
        for got_t, want_t in zip(seen.get("port", ()), seen.get("jax", ())):
            np.testing.assert_allclose(got_t.detach().numpy(), np.asarray(want_t),
                                       rtol=1e-4, atol=1e-4)


def _per_layer_mask(params):
    """The decay rule on per-layer tensors: the JAX mask without the stacked
    RMSNorm gains ([L, D] after stacking; see test_decay_mask below)."""
    mask = jopt.decay_mask(params, jit_.NON_DECAY_KEYS)
    for k in ("attention_norm", "ffn_norm"):
        mask["ar"]["layers"][k] = False
    return mask


def _jax_tx(params, tc):
    sched = jopt.make_lr_schedule(tc.lr, tc.warmup_steps, tc.total_steps,
                                  tc.decay_start, tc.min_lr)
    return optax.chain(
        optax.clip_by_global_norm(tc.max_grad_norm),
        optax.adamw(sched, b1=tc.betas[0], b2=tc.betas[1], eps=tc.eps,
                    weight_decay=tc.weight_decay, mask=_per_layer_mask(params)))


@pytest.mark.parametrize("mixed", [False, True], ids=["fp32", "bf16"])
@pytest.mark.parametrize("warmup", [0, 3])
def test_train_steps_match_jax_optax(monkeypatch, mixed, warmup):
    """Two train_steps from the same state and draws: loss and pre-clip
    grad norm each step; parameters and EMA after one and after two steps.

    fp32: loss and grad norm relative 1e-5. A parameter moves by about lr a
    step (Adam normalises g by |g| + eps), so where |g| is near eps a
    rounding of g moves it differently: all moves within 0.05 of the summed
    lr and at most 0.1% of them beyond 1e-3 of it; the EMA within 1e-6 plus
    (1 - decay) times the move bound.
    bf16: every product and activation rounds in another order than XLA's,
    so loss and grad norm within 2e-2 relative; a move can flip sign where
    the gradient is near 0, so 99% of parameter moves within 0.1 lr.
    With warmup the first step moves nothing (lr 0 at count 0) on both sides.
    """
    _patch_draws(monkeypatch)
    jcfg, tcfg = jia.ImageNetARConfig(**TINY), tia.ImageNetARConfig(**TINY)
    tc_kw = dict(lr=1e-3, warmup_steps=warmup, max_grad_norm=1.0,
                 weight_decay=0.05, mixed_precision=mixed)
    jtc, ttc = jit_.ImageNetTrainConfig(**tc_kw), tit.ImageNetTrainConfig(**tc_kw)
    params, head = _jax_params(jcfg, 4, jnp.bfloat16 if mixed else jnp.float32)
    tx = _jax_tx(params, jtc)
    jstate = jopt.TrainState.create(params, tx)
    model = _port_model(tcfg, params)
    state = tit.make_train_state(model, ttc)
    tokens, cls = _batch(TINY)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    ema_decay = 0.9
    for step in range(2):
        jstate, jm = jit_.train_step(jstate, jnp.asarray(tokens), jnp.asarray(cls),
                                     jax.random.PRNGKey(step), cfg=jcfg, head=head,
                                     tx=tx, ema_decay=ema_decay,
                                     mixed_precision=mixed)
        tm = tit.train_step(state, torch.from_numpy(tokens),
                            torch.from_numpy(cls).long(), ema_decay=ema_decay,
                            mixed_precision=mixed)
        rtol = 2e-2 if mixed else 1e-5
        np.testing.assert_allclose(tm["loss"].item(), float(jm["loss"]), rtol=rtol)
        np.testing.assert_allclose(tm["grad_norm"].item(), float(jm["grad_norm"]),
                                   rtol=rtol)
        lr_sum = sum(state.tx.lr_schedule(i) for i in range(step + 1))
        ema_atol = 1e-6 + (1 - ema_decay) * 0.05 * lr_sum
        want = imagenet_train_state_from_jax(jstate.params)
        want_ema = imagenet_train_state_from_jax(jstate.ema_params)
        moves_t, moves_j = [], []
        for n, p in model.named_parameters():
            moves_t.append((p.detach() - before[n]).flatten())
            moves_j.append((torch.from_numpy(want[n]) - before[n]).flatten())
            if not mixed:
                np.testing.assert_allclose(state.ema[n].numpy(), want_ema[n],
                                           rtol=0, atol=ema_atol, err_msg=n)
        mt, mj = torch.cat(moves_t), torch.cat(moves_j)
        if warmup and step == 0:
            assert mt.abs().max() == 0 and mj.abs().max() == 0
            continue
        assert mj.abs().max() > 0.5 * lr_sum
        diff = (mt - mj).abs() / lr_sum
        if mixed:
            assert (diff < 0.1).float().mean() > 0.99
        else:
            assert (diff > 1e-3).float().mean() < 1e-3 and diff.max() < 0.05
    assert state.step == int(jstate.step) == 2


def test_decay_mask_reads_per_layer_tensors():
    """The port decays ndim >= 2 tensors without a non-decay key. The JAX
    package applies the same rule to layer-stacked arrays, so its 2 x n_layer
    RMSNorm gains ([L, D]) are decayed where the reference's 1-D per-layer
    gains are not (ROADMAP C4); train_steps_match_jax_optax hands optax
    the per-layer mask."""
    jcfg, tcfg = jia.ImageNetARConfig(**TINY), tia.ImageNetARConfig(**TINY)
    params, _ = _jax_params(jcfg, 5)
    jm = jopt.decay_mask(params, jit_.NON_DECAY_KEYS)
    assert jm["ar"]["layers"]["attention_norm"] and jm["ar"]["layers"]["ffn_norm"]
    model = _port_model(tcfg, params)
    tm = topt.decay_mask(dict(model.named_parameters()), tit.NON_DECAY_KEYS)
    assert not tm["ar.layers.0.attention_norm.weight"]
    assert not tm["ar.layers.1.ffn_norm.weight"]
    assert tm["ar.layers.0.attention.wqkv.weight"] and tm["ar.pos_for_diff.weight"]
    assert not tm["ar.proj_in.w1.weight"] and not tm["ar.cls_embedding.weight"]
    assert not tm["head.net.res_blocks.0.norm.weight"]


@pytest.mark.parametrize("warmup,total,decay,steps", [
    (2000, 500_000, -1, [0, 1, 1999, 2000, 10_000]),
    (0, 100, 50, [0, 49, 50, 75, 100, 120]),
    (10, 100, 40, [0, 5, 10, 39, 40, 70, 100])])
def test_lr_schedule_matches_jax(warmup, total, decay, steps):
    js = jopt.make_lr_schedule(6e-4, warmup, total, decay, 1e-5)
    ts = topt.make_lr_schedule(6e-4, warmup, total, decay, 1e-5)
    for s in steps:
        np.testing.assert_allclose(ts(s), float(js(s)), rtol=1e-6, atol=1e-12)


def test_init_train_state_follows_jax_init():
    """Zero adaLN and final layer, unit norm gains, N(0, 0.02) backbone; EMA
    starts equal to the parameters; step 0."""
    cfg = tia.ImageNetARConfig(**TINY)
    st = tit.init_train_state(cfg, tit.ImageNetTrainConfig(), device="cpu",
                              generator=torch.Generator().manual_seed(0))
    sd = dict(st.model.named_parameters())
    assert sd["head.net.ada_ln_blocks.0.weight"].abs().max() == 0
    assert sd["head.net.final_layer.linear.weight"].abs().max() == 0
    assert (sd["ar.layers.0.ffn_norm.weight"] == 1).all()
    assert abs(sd["ar.layers.0.attention.wqkv.weight"].std().item() - 0.02) < 2e-3
    assert all(torch.equal(st.ema[n], p) for n, p in sd.items())
    assert st.step == 0 and dataclasses.is_dataclass(st)


def test_load_jax_train_state_params_and_ema():
    """A JAX TrainState after one step (EMA no longer equal to the params)
    loads into the port's TrainState exactly: parameters, EMA, step."""
    from bitdance_tpu_torch.io.from_jax import load_imagenet_train_state

    jcfg, tcfg = jia.ImageNetARConfig(**TINY), tia.ImageNetARConfig(**TINY)
    params, head = _jax_params(jcfg, 6)
    tx = _jax_tx(params, jit_.ImageNetTrainConfig(warmup_steps=0))
    jstate = jopt.TrainState.create(params, tx)
    tokens, cls = _batch(TINY)
    jstate, _ = jit_.train_step(jstate, jnp.asarray(tokens), jnp.asarray(cls),
                                jax.random.PRNGKey(0), cfg=jcfg, head=head, tx=tx,
                                ema_decay=0.5, mixed_precision=False)
    state = tit.init_train_state(tcfg, tit.ImageNetTrainConfig(), device="cpu")
    load_imagenet_train_state(state, jstate)
    want = imagenet_train_state_from_jax(jstate.params)
    want_ema = imagenet_train_state_from_jax(jstate.ema_params)
    assert any((want[n] != want_ema[n]).any() for n in want)
    for n, p in state.model.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), want[n], err_msg=n)
        np.testing.assert_array_equal(state.ema[n].numpy(), want_ema[n], err_msg=n)
    assert state.step == state.tx.count == 1
