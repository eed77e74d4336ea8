"""The port's packed multimodal training slice (BitDance-14B's trainer) vs
the JAX package on the same weights, data and draws, at a tiny width: the
chunked CE, the uncached Qwen3 forward with remat, the head's per-token
loss, the packer, the batched forward's losses and gradients, whole
``train_step``s with optax, the JAX-tree and TrainState loaders, and the
yaml builders.

Every random draw is replaced on both sides by shape-keyed tables (the k-th
normal or uniform draw of a shape gets the same values in both frameworks),
as tests/test_torch_imagenet_train.py does. fp32 throughout; each test
states its tolerance.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bitdance_tpu import config as jconfig
from bitdance_tpu.data import packing as jpack
from bitdance_tpu.models import mllm as jm
from bitdance_tpu.models import qwen3 as jq
from bitdance_tpu.ops import chunked_ce as jce
from bitdance_tpu.ops import rotary as jrot
from bitdance_tpu.train import mllm_train as jtrain
from bitdance_tpu.train import optim as jopt
from bitdance_tpu_torch import config as tconfig
from bitdance_tpu_torch.data import packing as tpack
from bitdance_tpu_torch.io.from_jax import (
    load_into,
    load_mllm_train_state,
    mllm_from_jax,
    mllm_state_from_jax,
    qwen3_from_jax,
)
from bitdance_tpu_torch.models import mllm as tm
from bitdance_tpu_torch.models import qwen3 as tq
from bitdance_tpu_torch.ops import chunked_ce as tce
from bitdance_tpu_torch.train import mllm_train as ttrain

torch.set_num_threads(2)

LLM = dict(hidden_size=64, intermediate_size=128, num_hidden_layers=2,
           num_attention_heads=4, num_key_value_heads=2, head_dim=16)
HEAD = dict(z_channels=8, parallel_num=4, head_model_dim=128, head_num_blocks=2,
            head_num_adaln=2, head_use_swiglu=True, P_mean=-0.8, P_std=0.8,
            vision_perturb=0.1)


class _Draws:
    """Deterministic tables keyed by (kind, shape, k)."""

    def __init__(self):
        self.counts = {"jax": {}, "torch": {}}

    def __call__(self, side, kind, shape):
        shape = tuple(int(s) for s in shape)
        k = self.counts[side].get((kind, shape), 0)
        self.counts[side][(kind, shape)] = k + 1
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


def _cfgs(vocab=300, **kw):
    jcfg = jm.MLLMConfig(llm=jq.Qwen3Config(vocab_size=vocab, **LLM), **HEAD, **kw)
    tcfg = tm.MLLMConfig(llm=tq.Qwen3Config(vocab_size=vocab, **LLM), **HEAD, **kw)
    return jcfg, tcfg


def _jax_params(jcfg, seed=0, noise=0.05):
    """init_mllm_params with every leaf moved by N(0, noise): the zero
    adaLN / final layers become non-zero, so the backbone has gradient."""
    params = jm.init_mllm_params(jax.random.PRNGKey(seed), jcfg)
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda l: jnp.asarray(np.asarray(l) + noise * rng.standard_normal(l.shape),
                              jnp.float32), params)


def _samples(n, seed=0, z=8, p=4, side=4, text_loss=True):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        out.append(jpack.T2ISample(
            text_ids=rng.integers(1, 250, int(rng.integers(5, 12))),
            image_latents=np.sign(rng.normal(size=(side * side, z))).astype(np.float32),
            latent_h=side, latent_w=side, vision_start_id=251, res_h_id=252 + i % 3,
            res_w_id=253, query_ids=np.arange(260, 260 + p - 1), text_loss=text_loss))
    return out


def _tsample(s):
    return tpack.T2ISample(**dataclasses.asdict(s))


def _raw(n_seq=1, budget=128, seed=0):
    """[n_seq] packed sequences, stacked (numpy dict)."""
    table = jrot.sincos_1d_table_np(LLM["hidden_size"] // 2, 64)
    raws = [jpack.pack_t2i_batch(_samples(3, seed + i), 4, budget, table)
            for i in range(n_seq)]
    return jpack.stack_packed_batches(raws)


def _jbatch(raw):
    return jm.PackedBatch(**{k: jnp.asarray(v) for k, v in raw.items()})


# ---------------------------------------------------------------------------
# ops: chunked CE
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("vocab,chunk", [(20000, 8192), (300, 128), (256, 8192)])
def test_chunked_ce_and_grads_match_jax(vocab, chunk):
    """Per-row NLL and its gradients w.r.t. hidden and lm_head, padded last
    chunk included; fp32, 1e-5 relative (NLL), 1e-4 (gradients)."""
    rng = np.random.default_rng(0)
    h = rng.normal(size=(37, 48)).astype(np.float32)
    w = (0.2 * rng.normal(size=(48, vocab))).astype(np.float32)
    lab = rng.integers(0, vocab, 37).astype(np.int32)
    cot = rng.normal(size=(37,)).astype(np.float32)

    def jloss(h, w):
        return jnp.sum(jce.chunked_cross_entropy(h, w, jnp.asarray(lab), chunk) * cot)

    want = np.asarray(jce.chunked_cross_entropy(h, w, lab, chunk))
    jgh, jgw = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(h), jnp.asarray(w))
    th, tw = (torch.tensor(x, requires_grad=True) for x in (h, w))
    got = tce.chunked_cross_entropy(th, tw, torch.from_numpy(lab), chunk)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5, atol=1e-5)
    (got * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(jgh), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jgw), rtol=1e-4, atol=1e-6)
    ref = tce.cross_entropy_reference(torch.from_numpy(h), torch.from_numpy(w),
                                      torch.from_numpy(lab))
    np.testing.assert_allclose(ref.numpy(), np.asarray(jce.cross_entropy_reference(
        h, w, lab)), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.detach().numpy(), ref.numpy(), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# models: uncached Qwen3, per-token head loss
# ---------------------------------------------------------------------------

def _packed_ids(lens, window=1):
    blk, doc, nb = [], [], 0
    for i, n in enumerate(lens):
        blk += [nb + j // window for j in range(n)]
        nb += -(-n // window)
        doc += [i] * n
    return np.asarray(blk, np.int32)[None], np.asarray(doc, np.int32)[None]


@pytest.mark.parametrize("remat", [False, True])
def test_qwen3_forward_and_grads_match_jax(remat):
    """Uncached forward over two packed documents (one with windows of 4)
    and its gradients w.r.t. embeds and every weight, with and without
    per-layer remat; fp32, 1e-5 (hidden) and 1e-4 (gradients)."""
    cfg_j = jq.Qwen3Config(vocab_size=300, **LLM)
    cfg_t = tq.Qwen3Config(vocab_size=300, **LLM)
    params = jq.init_qwen3_params(jax.random.PRNGKey(0), cfg_j)
    model = qwen3_from_jax(cfg_t, params).requires_grad_(True)
    blk, doc = _packed_ids([30, 42], window=4)
    pos = np.concatenate([np.arange(30), np.arange(42)]).astype(np.int32)[None]
    rng = np.random.default_rng(1)
    x = rng.normal(size=(1, 72, 64)).astype(np.float32)
    cot = rng.normal(size=(1, 72, 64)).astype(np.float32)

    def jloss(p, x):
        out = jq.qwen3_forward(p, cfg_j, x, pos, blk, doc, remat=remat)
        return jnp.sum(out * cot), out

    (_, want), (jg, jgx) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        params, jnp.asarray(x))
    tx = torch.tensor(x, requires_grad=True)
    out = tq.qwen3_forward(model, tx, *(torch.from_numpy(a).long() for a in (pos, blk, doc)),
                           remat=remat)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    (out * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), rtol=1e-4, atol=1e-5)
    q_grad = np.asarray(jg["layers"]["q_proj"])[1].T
    np.testing.assert_allclose(model.model.layers[1].self_attn.q_proj.weight.grad.numpy(),
                               q_grad, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(model.model.layers[0].mlp.down_proj.weight.grad.numpy(),
                               np.asarray(jg["layers"]["down_proj"])[0].T, rtol=1e-4,
                               atol=1e-5)


def test_qwen3_forward_sparse_route_equals_dense_on_cpu():
    """attn_impl="kernel" with max_live_kv (the plain sparse versions on
    CPU) gives the dense result, and so does remat "dots" with gradients
    on (tests/test_torch_remat.py holds "dots" against JAX)."""
    cfg_t = tq.Qwen3Config(vocab_size=300, **LLM)
    model = qwen3_from_jax(cfg_t, jq.init_qwen3_params(
        jax.random.PRNGKey(2), jq.Qwen3Config(vocab_size=300, **LLM)))
    blk, doc = _packed_ids([70, 90, 40], window=4)
    ids = [torch.from_numpy(a).long() for a in (blk, blk, doc)]
    x = torch.from_numpy(np.random.default_rng(3).normal(size=(1, 200, 64)).astype(np.float32))
    with torch.no_grad():
        dense = tq.qwen3_forward(model, x, *ids)
        sparse = tq.qwen3_forward(model, x, *ids, attn_impl="kernel", max_live_kv=3)
    np.testing.assert_allclose(sparse.numpy(), dense.numpy(), rtol=1e-5, atol=1e-5)
    dots = tq.qwen3_forward(model, x.clone().requires_grad_(True), *ids, remat=True,
                            remat_policy="dots")
    np.testing.assert_array_equal(dots.detach().numpy(), dense.numpy())


def test_per_token_head_loss_matches_jax(monkeypatch):
    """The TransEncoder head's per-token loss [N, P] (3-D targets) on the
    same t and noise; fp32, 1e-5 relative."""
    _patch_draws(monkeypatch)
    jcfg, tcfg = _cfgs()
    params = _jax_params(jcfg)
    model = mllm_from_jax(tcfg, params, device="cpu")
    rng = np.random.default_rng(4)
    x = np.sign(rng.normal(size=(6, 4, 8))).astype(np.float32)
    cond = rng.normal(size=(6, 4, 64)).astype(np.float32)
    want = np.asarray(jm.make_head(jcfg).apply(params["head"], x, cond,
                                               jax.random.PRNGKey(0)))
    got = model.head(torch.from_numpy(x), torch.from_numpy(cond))
    assert got.shape == (6, 4)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# data: packing
# ---------------------------------------------------------------------------

def test_sincos_tables_match_jax():
    t = tpack.sincos_1d_table_np(32, 40, 2.0)
    np.testing.assert_array_equal(t, jrot.sincos_1d_table_np(32, 40, 2.0))
    np.testing.assert_array_equal(tpack.pos_embed_2d_np(t, 8, 4, 2),
                                  jrot.pos_embed_2d_np(t, 8, 4, 2))


@pytest.mark.parametrize("text_loss", [True, False])
def test_pack_t2i_batch_byte_exact(text_loss):
    table = jrot.sincos_1d_table_np(32, 64)
    js = _samples(4, 5, text_loss=text_loss)
    want = jpack.pack_t2i_batch(js, 4, 200, table, text_budget=90, vis_budget=80)
    got = tpack.pack_t2i_batch([_tsample(s) for s in js], 4, 200, table,
                               text_budget=90, vis_budget=80)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    with pytest.raises(ValueError, match="overflows"):
        tpack.pack_t2i_batch([_tsample(s) for s in js], 4, 60, table)


def test_greedy_packer_and_stack_match_jax():
    jp, tp = jpack.GreedyPacker(4, 120, 160, 100, 6), tpack.GreedyPacker(4, 120, 160, 100, 6)
    batches = []
    for s in _samples(20, 9):
        a, b = jp.add(s), tp.add(_tsample(s))
        assert (a is None) == (b is None)
        if a is not None:
            assert [id(x) for x in a] != []
            assert [sorted(x.text_ids.tolist()) for x in a] == [
                sorted(x.text_ids.tolist()) for x in b]
            batches.append(len(a))
    assert batches and len(jp.flush()) == len(tp.flush())
    raws = [jpack.pack_t2i_batch(_samples(2, i), 4, 100, jrot.sincos_1d_table_np(16, 64))
            for i in range(4)]
    for ga in (1, 2):
        want = jpack.stack_packed_batches(raws, ga)
        got = tpack.stack_packed_batches(raws, ga)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])


# ---------------------------------------------------------------------------
# models/mllm and train/mllm_train
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("vocab,diff_batch_mul", [(300, 1), (33000, 1), (300, 2)])
def test_mllm_forward_losses_and_grads_match_jax(monkeypatch, vocab, diff_batch_mul):
    """mllm_forward_train_batched on one packed sequence (perturbation,
    remat, chunked CE above 32,768 entries, the head's rows tiled by
    diff_batch_mul): both losses and the gradients of their weighted sum
    w.r.t. every parameter; fp32, 1e-5 relative (losses), 1e-4 of each
    gradient's max (gradients)."""
    _patch_draws(monkeypatch)
    jcfg, tcfg = _cfgs(vocab, diff_batch_mul=diff_batch_mul)
    params = _jax_params(jcfg)
    model = mllm_from_jax(tcfg, params, device="cpu")
    raw = _raw()

    def jloss(p):
        out = jm.mllm_forward_train_batched(p, jcfg, _jbatch(raw), jax.random.PRNGKey(0))
        return 0.01 * out["ce_loss_text"] + out["ce_loss_vision"], out

    (_, jout), jg = jax.value_and_grad(jloss, has_aux=True)(params)
    out = tm.mllm_forward_train_batched(model, tcfg, tm.PackedBatch.from_numpy(raw, "cpu"), 0)
    for k in ("ce_loss_text", "ce_loss_vision"):
        np.testing.assert_allclose(out[k].item(), float(jout[k]), rtol=1e-5)
    (0.01 * out["ce_loss_text"] + out["ce_loss_vision"]).backward()
    want = mllm_state_from_jax(jg)
    for n, p in model.named_parameters():
        scale = max(np.abs(want[n]).max(), 1e-8)
        err = np.abs(p.grad.numpy() - want[n]).max() / scale
        assert err < 1e-4, (n, err)


def _jax_tx(params, tc):
    return jtrain.make_tx(params, tc)


def _assert_params_close(model, want: dict, atol: float, what: str):
    """Every parameter against ``want`` (numpy by port name)."""
    for n, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[n], rtol=0, atol=atol,
                                   err_msg=f"{what} {n}")


# AdamW as the yaml sets it but for eps: at eps 1e-15 the first update is
# lr * sign(g), so an element whose gradient is rounding noise (a window
# attention's key bias, whose gradient is 0 in exact arithmetic) steps +-lr
# on that noise's sign in either framework; eps 1e-4 keeps such elements
# from being amplified while every other part of the update is the same
ADAM = dict(lr=1e-3, eps=1e-4, total_steps=100)


@pytest.mark.parametrize("warmup", [0, 3])
def test_train_step_matches_jax_optax(monkeypatch, warmup):
    """Two train_steps (clip 1.0, AdamW .9/.95, warmup 0 or 3, no EMA) from
    the same parameters and data: loss, grad norm and every parameter after
    each step; fp32, 1e-5 relative (metrics), 2e-6 absolute on parameters
    (lr 1e-3 steps)."""
    _patch_draws(monkeypatch)
    jcfg, tcfg = _cfgs()
    params = _jax_params(jcfg, seed=1)
    jtc = jtrain.MLLMTrainConfig(warmup_steps=warmup, **ADAM)
    ttc = ttrain.MLLMTrainConfig(warmup_steps=warmup, **ADAM)
    tx = _jax_tx(params, jtc)
    jstate = jtrain.make_state(params, tx, jtc)
    model = mllm_from_jax(tcfg, params, device="cpu").requires_grad_(True)
    state = ttrain.make_state(model, ttrain.make_tx(model, ttc), ttc)
    assert jstate.ema_params is None and state.ema is None
    raw = _raw(seed=2)
    batch = tm.PackedBatch.from_numpy(raw, "cpu")
    for step in range(2):
        jstate, jmet = jtrain.train_step(jstate, _jbatch(raw), jax.random.PRNGKey(step),
                                         cfg=jcfg, tcfg=jtc, tx=tx)
        met = ttrain.train_step(state, batch, step, cfg=tcfg, tcfg=ttc)
        for k in ("loss", "grad_norm", "ce_loss_text", "ce_loss_vision"):
            np.testing.assert_allclose(met[k].item(), float(jmet[k]), rtol=1e-5, err_msg=k)
        _assert_params_close(model, mllm_state_from_jax(jstate.params), 2e-6,
                             f"step {step + 1}")


def test_grad_accum_splits_are_invariant():
    """Two sequences as one batch of 2 or as 2 microbatches of 1 give the
    same losses and gradients: draws follow the global sequence index (the
    JAX step's seq_offset), gradients average over microbatches; the
    port's own generators, 1e-5 relative."""
    _, tcfg = _cfgs()
    params = _jax_params(_cfgs()[0], seed=3)
    raw = _raw(n_seq=2, seed=4)
    ttc1 = ttrain.MLLMTrainConfig(warmup_steps=0, **ADAM)
    ttc2 = ttrain.MLLMTrainConfig(warmup_steps=0, grad_accum=2, **ADAM)
    mets, finals = [], []
    for ttc, stacked in ((ttc1, raw), (ttc2, {k: v.reshape(2, 1, *v.shape[1:])
                                             for k, v in raw.items()})):
        model = mllm_from_jax(tcfg, params, device="cpu").requires_grad_(True)
        state = ttrain.make_state(model, ttrain.make_tx(model, ttc), ttc)
        mets.append(ttrain.train_step(state, tm.PackedBatch.from_numpy(stacked, "cpu"), 7,
                                      cfg=tcfg, tcfg=ttc))
        finals.append(model)
    for k in mets[0]:
        np.testing.assert_allclose(mets[0][k].item(), mets[1][k].item(), rtol=1e-5, err_msg=k)
    _assert_params_close(finals[0], {n: p.detach().numpy() for n, p in
                                     finals[1].named_parameters()}, 1e-6, "split")


def test_eval_step_matches_jax(monkeypatch):
    """Validation losses without perturbation, batched and one sequence;
    fp32, 1e-5 relative."""
    _patch_draws(monkeypatch)
    jcfg, tcfg = _cfgs()
    params = _jax_params(jcfg, seed=5)
    model = mllm_from_jax(tcfg, params, device="cpu")
    raw = _raw(seed=6)
    jt, tt = jtrain.MLLMTrainConfig(), ttrain.MLLMTrainConfig()
    want = jtrain.eval_step(params, _jbatch(raw), jax.random.PRNGKey(0), cfg=jcfg, tcfg=jt)
    got = ttrain.eval_step(model, tm.PackedBatch.from_numpy(raw, "cpu"), 0, cfg=tcfg, tcfg=tt)
    for k in want:
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=1e-5, err_msg=k)
    one = {k: v[0] for k, v in raw.items()}
    want1 = jtrain.eval_step(params, jm.PackedBatch(**{k: jnp.asarray(v) for k, v in one.items()}),
                             jax.random.PRNGKey(0), cfg=jcfg, tcfg=jt)
    got1 = ttrain.eval_step(model, tm.PackedBatch.from_numpy(one, "cpu"), 0, cfg=tcfg, tcfg=tt)
    for k in want1:
        np.testing.assert_allclose(got1[k].item(), float(want1[k]), rtol=1e-5, err_msg=k)


# ---------------------------------------------------------------------------
# io and config
# ---------------------------------------------------------------------------

def test_mllm_from_jax_round_trip():
    """Every JAX leaf lands in the port's module by name (lm_head
    transposed, stacked layers split) and nothing is left over."""
    jcfg, tcfg = _cfgs()
    params = _jax_params(jcfg, seed=7)
    model = mllm_from_jax(tcfg, params, device="cpu")
    sd = mllm_state_from_jax(params)
    own = model.state_dict()
    assert set(own) == set(sd)
    for k, t in own.items():
        np.testing.assert_array_equal(t.numpy(), sd[k], err_msg=k)
    np.testing.assert_array_equal(model.llm.lm_head.weight.detach().numpy(),
                                  np.asarray(params["llm"]["lm_head"]).T)
    n_jax = sum(np.asarray(x).size for x in jax.tree_util.tree_leaves(params))
    assert n_jax == sum(p.numel() for p in model.parameters())
    load_into(tm.MLLM(tcfg), sd)


def test_load_mllm_train_state_then_step_matches_jax(monkeypatch):
    """A JAX TrainState after one step (moments and count non-trivial)
    loads into the port's TrainState; the next step agrees on every
    parameter (2e-6 absolute)."""
    draws = _patch_draws(monkeypatch)
    jcfg, tcfg = _cfgs()
    params = _jax_params(jcfg, seed=8)
    jtc = jtrain.MLLMTrainConfig(warmup_steps=0, **ADAM)
    tx = _jax_tx(params, jtc)
    jstate = jtrain.make_state(params, tx, jtc)
    raw = _raw(seed=9)
    jstate, _ = jtrain.train_step(jstate, _jbatch(raw), jax.random.PRNGKey(0),
                                  cfg=jcfg, tcfg=jtc, tx=tx)
    ttc = ttrain.MLLMTrainConfig(warmup_steps=0, **ADAM)
    model = tm.MLLM(tcfg).requires_grad_(True)
    state = ttrain.make_state(model, ttrain.make_tx(model, ttc), ttc)
    load_mllm_train_state(state, jstate)
    assert state.step == state.tx.count == 1
    draws.counts["jax"] = {}        # both sides' next step reads the same draws
    jstate, _ = jtrain.train_step(jstate, _jbatch(raw), jax.random.PRNGKey(1),
                                  cfg=jcfg, tcfg=jtc, tx=tx)
    ttrain.train_step(state, tm.PackedBatch.from_numpy(raw, "cpu"), 1, cfg=tcfg, tcfg=ttc)
    _assert_params_close(model, mllm_state_from_jax(jstate.params), 2e-6, "step 2")


def test_yaml_dict_and_builders_match_jax():
    """The port's dict mirrors train/configs/bitdance_14b_64x.yaml, and its
    builders give the JAX builders' configs (live-kv bound 33 JAX tiles,
    514 of the port's 64-key tiles)."""
    yaml_cfg = jconfig.load_yaml("train/configs/bitdance_14b_64x.yaml")

    def num(v):                 # YAML 1.1 reads 1e-5 (no dot) as a string
        try:
            return float(v) if isinstance(v, str) else v
        except ValueError:
            return v

    for block in ("model", "data", "training"):
        want_block = {k: num(v) for k, v in yaml_cfg[block].items()}
        assert tconfig.BITDANCE_14B_64X[block] == want_block, block
    want = jconfig.mllm_config_from_yaml(yaml_cfg, 152064)
    got = tconfig.mllm_config_from_yaml(tconfig.BITDANCE_14B_64X, 152064)
    assert dataclasses.asdict(got.llm) == dataclasses.asdict(want.llm)
    gd, wd = dataclasses.asdict(got), dataclasses.asdict(want)
    gd.pop("llm"), wd.pop("llm")
    assert gd == wd and got.attn_max_live_kv == 33
    assert got.attn_live_tiles() == 514
    assert (dataclasses.asdict(tconfig.mllm_train_config_from_yaml(tconfig.BITDANCE_14B_64X))
            == dataclasses.asdict(jconfig.mllm_train_config_from_yaml(yaml_cfg)))
    assert dataclasses.asdict(tm.MLLMConfig.bitdance_14b().llm) == dataclasses.asdict(
        jm.MLLMConfig.bitdance_14b().llm)


def test_make_state_keeps_no_ema_without_decay():
    _, tcfg = _cfgs()
    model = tm.MLLM(tcfg)
    assert ttrain.make_state(model, ttrain.make_tx(model, ttrain.MLLMTrainConfig()),
                             ttrain.MLLMTrainConfig()).ema is None
    with_ema = ttrain.MLLMTrainConfig(ema_decay=0.99)
    st = ttrain.make_state(model, ttrain.make_tx(model, with_ema), with_ema)
    assert set(st.ema) == set(dict(model.named_parameters()))
    assert jopt.TrainState.create({"a": jnp.zeros(2)}, _jax_tx(
        {"a": jnp.zeros(2)}, jtrain.MLLMTrainConfig()), with_ema=False).ema_params is None


@pytest.mark.parametrize("entry", ["mllm_from_jax", "build_random_mllm_train_state",
                                   "init_train_state"])
def test_entry_points_default_to_the_card(entry):
    """The slice's entry points build on the card unless the caller asks
    for the CPU (no fallback when CUDA is absent)."""
    import inspect

    from bitdance_tpu_torch.io import from_jax, random_init
    from bitdance_tpu_torch.train import imagenet_train

    fn = next(getattr(mod, entry) for mod in (from_jax, random_init, imagenet_train)
              if hasattr(mod, entry))
    assert inspect.signature(fn).parameters["device"].default == "cuda"


def test_adamw_is_fused_on_the_cpu_too():
    """The optimizer takes torch's fused AdamW on every device, so the step
    tests against optax run the update the card runs."""
    _, tcfg = _cfgs()
    tx = ttrain.make_tx(tm.MLLM(tcfg), ttrain.MLLMTrainConfig())
    assert all(g["fused"] for g in tx.opt.param_groups)
