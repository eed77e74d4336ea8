"""The split-KV arithmetic of the decode kernels (ops/decode_attention.py):
the plain twin of their partition and merge against the JAX Pallas kernels
in interpret mode (bf16 caches, fused bf16 and int8 buffers), the tile
ranges each split takes, and the split count the wrapper picks."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bitdance_tpu.ops import decode_attention as jda
from bitdance_tpu_torch.ops import decode_attention as tda

torch.set_num_threads(2)
TOL = dict(rtol=2e-4, atol=2e-4)
B, S, HQ, HKV, D, L = 2, 3, 4, 2, 32, 460          # 8 tiles of 64 keys
# (kv_start, kv_len) per row
WINDOWS = {
    "mid_tile": ([37, 0], [460, 201]),              # both edges inside tiles
    "tile_edges": ([128, 64], [384, 448]),          # on tile / split boundaries
    "one_key_and_empty": ([300, 0], [301, 0]),      # row 1 attends nothing
}
_JAX = {}


def _inputs(fmt):
    rng = np.random.default_rng(7)
    q = rng.standard_normal((B, S, HQ, D)).astype(np.float32)
    k = rng.standard_normal((B, L, HKV, D)).astype(np.float32)
    v = rng.standard_normal((B, L, HKV, D)).astype(np.float32)
    if fmt == "int8":
        return q, jda.quantize_kv_rows(jnp.asarray(k), jnp.asarray(v))
    kb, vb = (jnp.asarray(x).astype(jnp.bfloat16) for x in (k, v))
    if fmt == "fused_bf16":
        return q, (jda.pack_kv_rows(kb, vb), None)
    return q, (kb.transpose(0, 2, 1, 3), vb.transpose(0, 2, 1, 3))


def _jax_out(fmt, window):
    """The Pallas kernel's output, once per (format, window)."""
    if (fmt, window) not in _JAX:
        q, (a, b) = _inputs(fmt)
        start, end = (jnp.asarray(x, jnp.int32) for x in WINDOWS[window])
        if fmt == "bf16":
            out = jda.decode_attention_pallas(jnp.asarray(q), a, b, end, start,
                                              block_k=128, interpret=True)
        else:
            out = jda.decode_attention_fusedkv(jnp.asarray(q), a, end, start,
                                               kv_scales=b, interpret=True)
        _JAX[fmt, window] = np.asarray(out)
    return _JAX[fmt, window]


def _twin_args(fmt):
    """The twin's (q, k, v, k_scale, v_scale) on the same buffers."""
    q, (a, b) = _inputs(fmt)

    def to_t(x):
        return torch.from_numpy(np.array(x.astype(jnp.float32)
                                         if x.dtype == jnp.bfloat16 else x))

    if fmt == "bf16":
        return torch.from_numpy(q), to_t(a).bfloat16(), to_t(b).bfloat16(), None, None
    kv = to_t(a)
    kv = kv.bfloat16() if fmt == "fused_bf16" else kv
    ks, vs = (None, None) if b is None else (to_t(b)[:, :, 0], to_t(b)[:, :, 1])
    return torch.from_numpy(q), kv[..., :D], kv[..., D:], ks, vs


@pytest.mark.parametrize("window", list(WINDOWS))
@pytest.mark.parametrize("n_splits", [1, 2, 5, 8])      # 8 = the tile count
@pytest.mark.parametrize("fmt", ["bf16", "fused_bf16", "int8"])
def test_split_twin_matches_pallas_kernel(fmt, n_splits, window):
    q, k, v, ks, vs = _twin_args(fmt)
    start, end = (torch.tensor(x, dtype=torch.int32) for x in WINDOWS[window])
    got = tda.decode_attention_split_plain(q, k, v, end, start, n_splits, ks, vs)
    want = _jax_out(fmt, window)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    if window == "one_key_and_empty":
        np.testing.assert_array_equal(got[1].numpy(), 0.0)   # empty window -> 0


def test_split_twin_matches_dense_plain_versions():
    """With any split count, the twin equals the dense plain versions the
    CPU path runs (bf16 separate caches, int8 fused buffer)."""
    q, k, v, _, _ = _twin_args("bf16")
    start, end = (torch.tensor(x, dtype=torch.int32) for x in WINDOWS["mid_tile"])
    dense = tda.decode_attention_reference(q, k, v, end, start)
    for n in (1, 3, 8):
        np.testing.assert_allclose(
            tda.decode_attention_split_plain(q, k, v, end, start, n).numpy(),
            dense.numpy(), rtol=1e-5, atol=1e-5)
    q, kq, vq, ks, vs = _twin_args("int8")
    kv = torch.cat([kq, vq], dim=-1).contiguous()
    sc = torch.stack([ks, vs], dim=2).contiguous()
    dense = tda.decode_attention_fusedkv_reference(q, kv, end, start, sc)
    np.testing.assert_allclose(
        tda.decode_attention_split_plain(q, kq, vq, end, start, 5, ks, vs).numpy(),
        dense.numpy(), rtol=1e-5, atol=1e-5)


def test_empty_splits_hold_no_key_and_merge_to_the_live_ones():
    """More splits than live tiles: the extra splits write m = -1e30, l = 0,
    o = 0, and the merge gives the same output as one split."""
    q, k, v, _, _ = _twin_args("bf16")
    start, end = torch.tensor([130, 0], dtype=torch.int32), torch.tensor([250, 0],
                                                                         dtype=torch.int32)
    o, m, l = tda.split_partials(q, k, v, end, start, 8)
    # row 0 spans tiles 2-3 (two live tiles of 8 splits), row 1 none
    live = (m[:, 0, 0, 0] > tda.NEG_INF).tolist()
    assert sum(live) == 2
    dead = ~torch.tensor(live)
    assert (m[dead] == tda.NEG_INF).all() and (l[dead] == 0).all() and (o[dead] == 0).all()
    assert (m[:, 1] == tda.NEG_INF).all() and (l[:, 1] == 0).all()
    merged = tda.merge_partials(o, m, l)
    one = tda.merge_partials(*tda.split_partials(q, k, v, end, start, 1))
    np.testing.assert_allclose(merged.numpy(), one.numpy(), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(merged[1].numpy(), 0.0)


@pytest.mark.parametrize("start,end,max_len,n_splits", [
    (0, 4226, 4226, 4),          # the 14B model's last AR step
    (50, 194, 4226, 4),          # its second prefill pass: 4 tiles, 4 splits
    (37, 460, 460, 5),
    (128, 384, 460, 2),          # window edges on tile boundaries
    (1024, 4226, 4226, 67),      # one tile per split, 16 tiles before the window
    (300, 301, 460, 8),          # one key
    (10, 5000, 4226, 3),         # kv_len past the cache: clipped to it
])
def test_split_ranges_cover_the_window_in_whole_tiles(start, end, max_len, n_splits):
    ranges = tda.split_tile_ranges(start, end, max_len, n_splits)
    assert len(ranges) == n_splits
    end = min(end, max_len)
    live = [(a, b) for a, b in ranges if b > a]
    # contiguous, in split order, exactly the window
    assert live[0][0] == start and live[-1][1] == end
    assert all(x[1] == y[0] for x, y in zip(live, live[1:]))
    # inner boundaries on tiles; shares of whole tiles differ by at most one
    assert all(b % tda.KV_TILE == 0 for _, b in live[:-1])
    tiles = [-(-b // 64) - a // 64 for a, b in live]
    assert max(tiles) - min(tiles) <= 1
    n_live = -(-end // 64) - start // 64
    assert len(live) == min(n_splits, n_live)        # every split busy if it can be


def test_empty_window_has_no_live_split():
    assert all(b <= a for a, b in tda.split_tile_ranges(256, 256, 460, 4))
    assert all(b <= a for a, b in tda.split_tile_ranges(300, 100, 460, 2))


@pytest.mark.parametrize("b,hkv,rows,max_len,per_sm,want", [
    (2, 8, 320, 4226, 2, 3),       # 14B-64x CFG pair: 80 blocks a split, 240 of 264
    (4, 8, 320, 4226, 2, 3),       # two images: 160 blocks a split, 480 in two waves
    (4, 8, 320, 1154, 2, 3),       # the same at 512 px
    (2, 8, 320, 4226, 3, 4),       # a kernel 3 blocks an SM could hold: 320 of 396
    (1, 8, 320, 4226, 2, 6),       # one row: 40 blocks a split -> 240
    (2, 8, 80, 130, 2, 3),         # S 16 at the second prefill pass: tiles cap it
    (2, 8, 320, 64, 2, 1),         # one-tile cache
    (64, 8, 320, 4226, 2, 1),      # the grid already fills ten waves
])
def test_decode_splits(b, hkv, rows, max_len, per_sm, want):
    """The count that minimises waves x (tiles a split + a block's fixed
    cost), at least 1, never more than the cache's tiles."""
    sm = 132
    n = tda.decode_splits(b, hkv, rows, max_len, sm, per_sm)
    assert n == want
    tiles = -(-max_len // 64)
    assert 1 <= n <= tiles
    base = b * hkv * -(-rows // 64)
    slots = per_sm * sm

    def modelled(k):
        return math.ceil(base * k / slots) * (tiles / k + tda.BLOCK_COST_TILES)

    assert all(modelled(n) <= modelled(k) + 1e-9 for k in range(1, tiles + 1))
    if (b, hkv, rows, max_len, per_sm) == (2, 8, 320, 4226, 2):
        assert base * n > slots - base               # 14B: within a split of a full wave
