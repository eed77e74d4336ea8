"""Port attention (bitdance_tpu_torch.ops.attention) vs the JAX package.

The plain flash version and the autograd Function (which takes the plain
forward and backward versions on CPU tensors) against JAX ``flash_attention``
in Pallas interpret mode, its custom-VJP gradients, and ``masked_attention``.
All in float32; tolerance 1e-5 absolute (a few ulps of outputs of order 1)
unless a test says otherwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bitdance_tpu.ops import attention as ja
from bitdance_tpu_torch.ops import attention as ta

torch.set_num_threads(2)
TOL = dict(rtol=1e-5, atol=1e-5)


def _packed(lens, parallel=1):
    """block/doc ids of packed documents, windows of `parallel` tokens."""
    block = np.concatenate([np.arange(n) // parallel for n in lens]).astype(np.int32)
    doc = np.concatenate([np.full(n, i) for i, n in enumerate(lens)]).astype(np.int32)
    return block, doc


# name -> (b, lq, lk, hq, hkv, d, q ids, k ids)
def _case(name):
    if name == "causal":
        blk, doc = _packed([200])
        return 2, 200, 200, 2, 2, 64, (blk, doc), (blk, doc)
    if name == "block_windows":        # BitDance-B-16x style windows
        blk, doc = _packed([256], parallel=16)
        return 1, 256, 256, 2, 2, 32, (blk, doc), (blk, doc)
    if name == "packed_docs":
        blk, doc = _packed([90, 110], parallel=4)
        return 1, 200, 200, 2, 2, 32, (blk, doc), (blk, doc)
    if name == "gqa_ragged":            # GQA, lengths off the 128 tiles
        blk, doc = _packed([150])
        return 2, 150, 150, 4, 2, 32, (blk, doc), (blk, doc)
    if name == "cross_unsorted":        # Lq != Lk, unsorted ids, empty rows
        rng = np.random.default_rng(3)
        qb = rng.integers(0, 40, 100).astype(np.int32)
        qd = rng.integers(0, 3, 100).astype(np.int32)
        kb = rng.integers(0, 40, 170).astype(np.int32)
        kd = rng.integers(0, 3, 170).astype(np.int32)
        qd[:5] = 7                       # these rows see no key
        return 1, 100, 170, 2, 1, 32, (qb, qd), (kb, kd)
    raise KeyError(name)


CASES = ["causal", "block_windows", "packed_docs", "gqa_ragged", "cross_unsorted"]


def _inputs(name, seed=0):
    b, lq, lk, hq, hkv, d, (qb, qd), (kb, kd) = _case(name)
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, lq, hq, d)).astype(np.float32)
    k = rng.normal(size=(b, lk, hkv, d)).astype(np.float32)
    v = rng.normal(size=(b, lk, hkv, d)).astype(np.float32)
    w = rng.normal(size=(b, lq, hq, d)).astype(np.float32)
    ids = tuple(np.broadcast_to(x, (b, x.shape[0])).copy() for x in (qb, qd, kb, kd))
    return q, k, v, w, ids


def _jax_flash(q, k, v, ids):
    return ja.flash_attention(q, k, v, *ids, block_q=128, block_k=128,
                              interpret=True)


def _jax_lse(q, k, v, ids):
    """lse [B, Hq, Lq] of the Pallas forward, padded as flash_attention pads."""
    b, lq, hq, d = q.shape
    lk = k.shape[1]
    lq_p, lk_p = ja._round_up(lq, 128), ja._round_up(lk, 128)
    qb, qd, kb, kd = (jnp.asarray(x) for x in ids)
    tr = lambda x, n: jnp.transpose(ja._pad_axis(jnp.asarray(x), 1, n), (0, 2, 1, 3))  # noqa: E731
    _, lse = ja._flash_forward_padded(
        tr(q, lq_p), tr(k, lk_p), tr(v, lk_p), ja._pad_axis(qb, 1, lq_p, 0),
        ja._pad_axis(qd, 1, lq_p, -3), ja._pad_axis(kb, 1, lk_p, 0),
        ja._pad_axis(kd, 1, lk_p, -2), d ** -0.5, 128, 128, True)
    return np.asarray(lse)[:, :, :lq, 0]


def _t(*xs, grad=False):
    return [torch.tensor(x, requires_grad=grad) for x in xs]


@pytest.mark.parametrize("name", CASES)
def test_flash_reference_matches_jax_forward(name):
    q, k, v, _, ids = _inputs(name)
    want = np.asarray(_jax_flash(q, k, v, ids))
    o, lse = ta.flash_attention_reference(*_t(q, k, v), *_t(*ids), return_lse=True)
    np.testing.assert_allclose(o.numpy(), want, **TOL)
    want_lse = _jax_lse(q, k, v, ids)
    live = want_lse < 1e29
    np.testing.assert_allclose(lse.numpy()[live], want_lse[live], **TOL)
    np.testing.assert_array_equal(lse.numpy()[~live], np.float32(ta.MASKED_LSE))
    if name == "cross_unsorted":        # rows that see nothing: 0 and 1e30
        assert (~live).sum() == 5 * 2
        np.testing.assert_array_equal(o.numpy()[:, :5], 0.0)


@pytest.mark.parametrize("name", CASES)
def test_flash_gradients_match_jax_custom_vjp(name):
    """Reference autograd and the autograd Function (plain dq and dk/dv
    versions on CPU, delta = sum(do * o)) vs jax.grad through _flash_core."""
    q, k, v, w, ids = _inputs(name, seed=1)

    def loss(q, k, v):
        return jnp.sum(_jax_flash(q, k, v, ids) * w)

    want = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k),
                                             jnp.asarray(v))
    for fn in (ta.flash_attention_reference, ta.flash_attention):
        tq, tk, tv = _t(q, k, v, grad=True)
        (fn(tq, tk, tv, *_t(*ids)) * torch.from_numpy(w)).sum().backward()
        for got, ref, n in zip((tq.grad, tk.grad, tv.grad), want, "qkv"):
            np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4,
                                       atol=1e-4, err_msg=f"{fn.__name__} d{n}")


@pytest.mark.parametrize("implementation", ["plain", "kernel", "auto"])
def test_masked_attention_matches_jax(implementation):
    """Causal 200 tokens: the JAX dispatcher's XLA and Pallas paths agree,
    and so do the port's three (auto takes plain on a CPU tensor)."""
    q, k, v, _, ids = _inputs("causal", seed=2)
    jimpl = {"plain": "xla", "kernel": "pallas", "auto": "auto"}[implementation]
    want = np.asarray(ja.masked_attention(q, k, v, *ids, implementation=jimpl,
                                          interpret=True))
    got = ta.masked_attention(*_t(q, k, v), *_t(*ids),
                              implementation=implementation).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_masked_rows_differ_between_plain_and_flash_as_in_jax():
    """A row that sees no key: attention_xla averages v, flash gives 0 --
    two functions in JAX too; each port function matches its own twin."""
    q, k, v, _, ids = _inputs("cross_unsorted", seed=4)
    for jimpl, timpl in (("xla", "plain"), ("pallas", "kernel")):
        want = np.asarray(ja.masked_attention(q, k, v, *ids, implementation=jimpl,
                                              interpret=True))
        got = ta.masked_attention(*_t(q, k, v), *_t(*ids),
                                  implementation=timpl).numpy()
        np.testing.assert_allclose(got, want, **TOL)
    plain = ta.masked_attention(*_t(q, k, v), *_t(*ids), implementation="plain")
    assert plain[:, :5].abs().max() > 0.1


def test_mask_from_ids_matches_jax():
    _, _, _, _, (qb, qd, kb, kd) = _inputs("cross_unsorted")
    want = np.asarray(jax.vmap(ja.mask_from_ids)(qb, qd, kb, kd))
    got = ta.mask_from_ids(*_t(qb, qd, kb, kd)).numpy()
    np.testing.assert_array_equal(got, want)


def test_plain_backward_versions_match_autograd_bf16():
    """The plain dq and dk/dv versions on bf16 inputs (what the kernels are
    held to on the card) vs autograd of the fp32 reference on the same
    values: within bf16 output rounding (2e-2 of the max)."""
    q, k, v, w, ids = _inputs("gqa_ragged", seed=5)
    tq, tk, tv = (torch.tensor(x).bfloat16() for x in (q, k, v))
    tids = _t(*ids)
    rq, rk, rv = (x.float().requires_grad_() for x in (tq, tk, tv))
    o = ta.flash_attention_reference(rq, rk, rv, *tids)
    (o * torch.from_numpy(w)).sum().backward()
    o_b, lse = ta.flash_fwd(tq, tk, tv, *tids, 32 ** -0.5)
    do = torch.from_numpy(w).bfloat16()
    delta = (do.float() * o_b.float()).sum(-1).transpose(1, 2).contiguous()
    dq = ta.flash_bwd_dq(tq, tk, tv, do, lse, delta, *tids, 32 ** -0.5)
    dk, dv = ta.flash_bwd_dkv(tq, tk, tv, do, lse, delta, *tids, 32 ** -0.5)
    for got, want in ((dq, rq.grad), (dk, rk.grad), (dv, rv.grad)):
        assert got.dtype == torch.bfloat16
        err = (got.float() - want).abs().max() / want.abs().max()
        assert err.item() < 2e-2


def test_kernel_wrappers_refuse_non_cuda_non_cpu_devices():
    q = torch.zeros((1, 4, 2, 64), device="meta", dtype=torch.bfloat16)
    ids = torch.zeros((1, 4), dtype=torch.int32)
    with pytest.raises(RuntimeError, match="no kernel"):
        ta.flash_fwd(q, q, q, ids, ids, ids, ids, 0.125)
    lse = torch.zeros((1, 2, 4), device="meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        ta.flash_bwd_dq(q, q, q, q, lse, lse, ids, ids, ids, ids, 0.125)
    with pytest.raises(RuntimeError, match="no kernel"):
        ta.flash_bwd_dkv(q, q, q, q, lse, lse, ids, ids, ids, ids, 0.125)
