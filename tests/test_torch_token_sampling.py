"""The port's token sampling (bitdance_tpu_torch/ops/token_sampling.py)
against the JAX package's: top_k_filter and top_p_filter give JAX's logits
exactly (ties at the k-th value, min_tokens_to_keep, p >= 1, k <= 0), the
greedy modes give the argmax, and the Gumbel-max draw from a fixed generator
follows the softmax of the filtered logits."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bitdance_tpu.ops import token_sampling as jts
from bitdance_tpu_torch.ops import token_sampling as tts

torch.set_num_threads(2)


def _logits(kind: str) -> np.ndarray:
    rng = np.random.default_rng({"normal": 0, "ties": 1, "filtered": 2}[kind])
    if kind == "normal":
        return (3.0 * rng.standard_normal((6, 97))).astype(np.float32)
    ties = rng.integers(-4, 5, size=(6, 97)).astype(np.float32)
    if kind == "filtered":      # a row already top-k filtered (FILTER_VALUE)
        ties[:, ::3] = tts.FILTER_VALUE
    return ties


def _same(got: torch.Tensor, want) -> None:
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("kind", ["normal", "ties", "filtered"])
@pytest.mark.parametrize("k", [-1, 0, 1, 2, 7, 96, 97, 200])
def test_top_k_filter_equals_jax(kind, k):
    x = _logits(kind)
    got = tts.top_k_filter(torch.from_numpy(x), k)
    _same(got, jts.top_k_filter(jnp.asarray(x), k))
    if kind == "ties" and 0 < k < 97:
        # every logit equal to the k-th largest survives
        kth = np.sort(x, axis=-1)[:, ::-1][:, k - 1:k]
        assert ((got.numpy() > tts.FILTER_VALUE) == (x >= kth)).all()
        assert ((x == kth).sum(-1) > 1).any()


@pytest.mark.parametrize("kind", ["normal", "ties", "filtered"])
@pytest.mark.parametrize("p,min_keep", [(0.0, 1), (0.3, 1), (0.9, 1), (0.95, 4),
                                        (0.5, 10), (1.0, 1), (1.5, 1)])
def test_top_p_filter_equals_jax(kind, p, min_keep):
    x = _logits(kind)
    got = tts.top_p_filter(torch.from_numpy(x), p, min_tokens_to_keep=min_keep)
    want = np.asarray(jts.top_p_filter(jnp.asarray(x), p, min_tokens_to_keep=min_keep))
    _same(got, want)
    kept = (want > tts.FILTER_VALUE).sum(-1)
    assert (kept >= min(min_keep, 97)).all()
    if p >= 1.0:
        _same(got, x)


@pytest.mark.parametrize("temperature,top_k,top_p", [(1.0, 0, 1.0), (0.7, 5, 0.9),
                                                     (2.0, 40, 0.5), (1e-9, 3, 1.0)])
def test_greedy_modes_give_the_argmax(temperature, top_k, top_p):
    """do_sample=False is the argmax of the filtered logits, as JAX's; top_k=1
    draws the argmax whatever the generator."""
    x = _logits("normal")
    got = tts.sample_tokens(None, torch.from_numpy(x), temperature, top_k, top_p,
                            do_sample=False)
    want = jts.sample_tokens(None, jnp.asarray(x), temperature, top_k, top_p,
                             do_sample=False)
    _same(got, want)
    _same(got, np.argmax(x, axis=-1))
    g = torch.Generator().manual_seed(3)
    for _ in range(5):
        _same(tts.sample_tokens(g, torch.from_numpy(x), temperature, 1, top_p),
              np.argmax(x, axis=-1))


@pytest.mark.parametrize("temperature,top_k,top_p", [(1.0, 0, 1.0), (0.8, 6, 1.0),
                                                     (1.3, 0, 0.8), (0.9, 7, 0.9)])
def test_draws_follow_the_filtered_softmax(temperature, top_k, top_p):
    """20,000 draws from a fixed generator: each token's share within 0.02 of
    the softmax of JAX's filtered logits; filtered tokens are never drawn."""
    x = np.array([2.0, 1.5, 1.0, 0.9, 0.5, 0.0, -0.5, -1.0, -2.0, 1.2], np.float32)
    f = np.asarray(jts.top_p_filter(jts.top_k_filter(
        jnp.asarray(x / temperature), top_k), top_p) if top_p < 1.0
        else jts.top_k_filter(jnp.asarray(x / temperature), top_k))
    prob = np.exp(f - f.max())
    prob /= prob.sum()
    g = torch.Generator().manual_seed(0)
    rows = torch.from_numpy(np.tile(x, (20_000, 1)))
    got = tts.sample_tokens(g, rows, temperature, top_k, top_p).numpy()
    share = np.bincount(got, minlength=x.size) / got.size
    assert np.abs(share - prob).max() < 0.02, (share, prob)
    assert (share[prob == 0] == 0).all()
    again = tts.sample_tokens(torch.Generator().manual_seed(0), rows, temperature,
                              top_k, top_p).numpy()
    np.testing.assert_array_equal(got, again)
