"""Port sparse-iteration flash attention (bitdance_tpu_torch.ops.attention)
vs the JAX package's ``flash_attention_sparse`` in Pallas interpret mode.

The port tiles at 64 (its CUDA kernels' tiles) where the JAX package tiles
at 128-512, so the two build different tile maps for the same ids; both are
exact over the live pairs, so outputs and gradients agree. The tile maps
themselves are compared at equal tile sizes. All float32; tolerance 3e-5
for outputs (the two sum a row's keys in other orders and tiles; a few
ulps of outputs of order 1), 1e-4 for gradients (sums over more terms),
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
TOL = dict(rtol=3e-5, atol=3e-5)
GTOL = dict(rtol=1e-4, atol=1e-4)


def _segments():
    """test_attention.py:147-165's packed ids: 3 samples, causal and
    parallel (window 16) segments."""
    block, doc = ja.packed_ids_from_segments(
        [120, 136, 128], [24, 96, 8, 128, 128],
        ["causal", "parallel", "causal", "parallel", "causal"], 16)
    return np.asarray(block, np.int32), np.asarray(doc, np.int32)


# name -> (b, hq, hkv, d, (block, doc), JAX max_live_kv at 128 tiles,
#          the port's max_live_kv at 64 tiles)
def _case(name):
    if name == "packed":               # test_sparse_flash_matches_dense_packed
        return 1, 2, 1, 64, _segments(), 2, ta.live_tile_bound(136)
    if name == "causal":               # test_sparse_flash_causal_single_doc
        blk = np.arange(384, dtype=np.int32)
        return 2, 2, 2, 64, (blk, np.zeros(384, np.int32)), 3, 6
    if name == "gqa5_d128":            # Qwen3-14B's group 5 and head dim 128
        lens = [70, 150, 100]
        blk = np.concatenate([np.arange(n) for n in lens]).astype(np.int32)
        doc = np.concatenate([np.full(n, i) for i, n in enumerate(lens)]).astype(np.int32)
        # JAX pads L = 320 to 384 with doc -3: its last q tile then spans
        # every doc id and needs all 3 kv tiles (ROADMAP C5)
        return 1, 10, 2, 128, (blk, doc), 3, ta.live_tile_bound(150)
    raise KeyError(name)


CASES = ["packed", "causal", "gqa5_d128"]


def _inputs(name, seed=0):
    b, hq, hkv, d, (blk, doc), jmax, tmax = _case(name)
    L = blk.shape[0]
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, L, hq, d)).astype(np.float32)
    k = rng.normal(size=(b, L, hkv, d)).astype(np.float32)
    v = rng.normal(size=(b, L, hkv, d)).astype(np.float32)
    w = rng.normal(size=(b, L, hq, d)).astype(np.float32)
    ids = tuple(np.broadcast_to(x, (b, L)).copy() for x in (blk, doc, blk, doc))
    return q, k, v, w, ids, jmax, tmax


def _jax_sparse(q, k, v, ids, jmax):
    return ja.flash_attention_sparse(q, k, v, *ids, max_live_kv=jmax, block_q=128,
                                     block_k=128, interpret=True)


def _t(*xs, grad=False):
    return [torch.tensor(x, requires_grad=grad) for x in xs]


@pytest.mark.parametrize("name", ["packed", "causal"])
@pytest.mark.parametrize("tiles", [(128, 128, 3), (64, 64, 6)])
def test_kv_tile_map_matches_jax(name, tiles):
    """Tile maps and clamped counts, exact, at equal tile sizes, on ids with
    no padding (negative doc ids are where the two tests differ, see
    test_padding_tile_stays_bounded_where_jax_drops)."""
    bq, bk, max_n = tiles
    *_, ids, _, _ = _inputs(name)
    L = ids[0].shape[1]
    n = -(-L // 128) * 128
    pad = lambda x, val: np.pad(x, ((0, 0), (0, n - L)), constant_values=val)  # noqa: E731
    padded = (pad(ids[0], 0), pad(ids[1], -3), pad(ids[2], 0), pad(ids[3], -2))
    want_map, want_cnt = ja.kv_tile_map(*(jnp.asarray(x) for x in padded), bq, bk, max_n)
    got_map, got_cnt = ta.kv_tile_map(*_t(*padded), bq, bk, max_n)
    np.testing.assert_array_equal(got_cnt.numpy(), np.asarray(want_cnt))
    np.testing.assert_array_equal(got_map.numpy(), np.asarray(want_map))
    live_j = np.asarray(ja.tile_live_matrix(*(jnp.asarray(x) for x in padded), bq, bk))
    live_t = ta.tile_live_matrix(*_t(*padded), bq, bk).numpy()
    np.testing.assert_array_equal(live_t, live_j)


def test_kv_tile_map_two_docs_as_jax_test():
    """test_attention.py:183-194: trailing entries repeat the last live tile."""
    qb = torch.arange(256, dtype=torch.int32)[None]
    qd = torch.cat([torch.zeros(128), torch.ones(128)]).int()[None]
    tm, cnt = ta.kv_tile_map(qb, qd, qb, qd, 128, 128, 2)
    assert cnt.tolist() == [[1, 1]]
    assert tm[0].tolist() == [[0, 0], [1, 1]]


@pytest.mark.parametrize("name", CASES)
def test_sparse_forward_matches_jax(name):
    q, k, v, _, ids, jmax, tmax = _inputs(name)
    want = np.asarray(_jax_sparse(q, k, v, ids, jmax))
    got = ta.flash_attention_sparse(*_t(q, k, v), *_t(*ids), max_live_kv=tmax)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    plan = ta.sparse_plan(*_t(*ids), tmax)
    o, lse = ta.flash_sparse_reference(*_t(q, k, v), *_t(*ids), plan.kv_map,
                                       plan.kv_counts, return_lse=True)
    o_d, lse_d = ta.flash_attention_reference(*_t(q, k, v), *_t(*ids), return_lse=True)
    np.testing.assert_allclose(o.numpy(), want, **TOL)
    np.testing.assert_allclose(lse.numpy(), lse_d.numpy(), **TOL)


@pytest.mark.parametrize("name", CASES)
def test_sparse_gradients_match_jax_custom_vjp(name):
    """The autograd Function (plain sparse dq over the forward's lists,
    dk/dv over the transposed lists, on CPU) and autograd of the plain
    sparse forward vs jax.grad through _flash_sparse_core."""
    q, k, v, w, ids, jmax, tmax = _inputs(name, seed=1)

    def loss(q, k, v):
        return jnp.sum(_jax_sparse(q, k, v, ids, jmax) * w)

    want = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(x) for x in (q, k, v)))
    plan = ta.sparse_plan(*_t(*ids), tmax)
    fns = {"function": lambda *a: ta.flash_attention_sparse(*a, plan=plan),
           "reference": lambda *a: ta.flash_sparse_reference(*a, plan.kv_map,
                                                             plan.kv_counts)}
    for label, fn in fns.items():
        tq, tk, tv = _t(q, k, v, grad=True)
        (fn(tq, tk, tv, *_t(*ids)) * torch.from_numpy(w)).sum().backward()
        for got, ref, n in zip((tq.grad, tk.grad, tv.grad), want, "qkv"):
            np.testing.assert_allclose(got.numpy(), np.asarray(ref), **GTOL,
                                       err_msg=f"{label} d{n}")


def test_sparse_plan_raises_on_undersized_bound():
    """The JAX function clamps and drops tiles; the port raises."""
    *_, ids, _, tmax = _inputs("packed")
    ta.sparse_plan(*_t(*ids), tmax)
    with pytest.raises(ValueError, match="live kv tiles"):
        ta.sparse_plan(*_t(*ids), 2)


def test_dropped_or_extra_tile_shows_in_plain_version():
    """The plain versions compute over exactly the listed tiles: dropping a
    q tile's own kv tile, or listing a tile twice, changes o; the listed
    set as built gives the dense result."""
    q, k, v, _, ids, _, tmax = _inputs("gqa5_d128")
    tq, tk, tv = _t(q, k, v)
    plan = ta.sparse_plan(*_t(*ids), tmax)
    dense = ta.flash_attention_reference(tq, tk, tv, *_t(*ids))
    ok = ta.flash_sparse_reference(tq, tk, tv, *_t(*ids), plan.kv_map, plan.kv_counts)
    np.testing.assert_allclose(ok.numpy(), dense.numpy(), **TOL)
    row = 1                              # drop q tile 1's own (diagonal) kv tile
    listed = plan.kv_map[0, row, :plan.kv_counts[0, row]]
    kept = listed[listed != row]
    fewer_map, fewer = plan.kv_map.clone(), plan.kv_counts.clone()
    fewer_map[0, row, :kept.numel()] = kept
    fewer[0, row] = kept.numel()
    dropped = ta.flash_sparse_reference(tq, tk, tv, *_t(*ids), fewer_map, fewer)
    assert (dropped - dense).abs().max() > 0.1
    extra_map, extra_cnt = plan.kv_map.clone(), plan.kv_counts.clone()
    extra_map[0, row, extra_cnt[0, row]] = row       # q tile 1's own tile twice
    extra_cnt[0, row] += 1
    extra = ta.flash_sparse_reference(tq, tk, tv, *_t(*ids), extra_map, extra_cnt)
    assert (extra - dense).abs().max() > 0.1


def test_padding_tile_stays_bounded_where_jax_drops():
    """A packed sequence padded with doc -1 (the packer's padding): the JAX
    tile test takes one [min, max] of doc ids, so the q tile holding the
    last document's end and the padding sees every earlier kv tile and its
    count exceeds a bound set from the longest document; JAX clamps it and
    drops the tile's own document (ROADMAP C5). The port tests padding apart
    and stays within the bound, and its result is the dense one."""
    lens = [100, 120, 110, 90]          # global causal block ids, as packed
    blk = np.concatenate([np.arange(420), np.full(92, 500)]).astype(np.int32)
    doc = np.concatenate([np.full(n, i) for i, n in enumerate(lens)]
                         + [np.full(92, -1)]).astype(np.int32)
    ids = tuple(x[None] for x in (blk, doc, blk, doc))          # L = 512
    j_live = np.asarray(ja.tile_live_matrix(*(jnp.asarray(x) for x in ids), 64, 64))
    t_live = ta.tile_live_matrix(*_t(*ids), 64, 64).numpy()
    bound = ta.live_tile_bound(120)
    assert j_live.sum(-1).max() > bound >= t_live.sum(-1).max()
    assert (t_live <= j_live).all()
    rng = np.random.default_rng(7)
    q, k, v = (rng.normal(size=(1, 512, 2, 64)).astype(np.float32) for _ in range(3))
    got = ta.flash_attention_sparse(*_t(q, k, v), *_t(*ids), max_live_kv=bound)
    dense = ta.flash_attention_reference(*_t(q, k, v), *_t(*ids))
    np.testing.assert_allclose(got.numpy(), dense.numpy(), **TOL)
    jax_sparse = np.asarray(ja.flash_attention_sparse(
        q, k, v, *ids, max_live_kv=2, block_q=128, block_k=128, interpret=True))
    assert np.abs(jax_sparse - dense.numpy()).max() > 0.1


def test_masked_attention_dispatches_sparse():
    """masked_attention(kernel, max_live_kv) == the dense kernel route."""
    q, k, v, _, ids, _, tmax = _inputs("packed", seed=3)
    sparse = ta.masked_attention(*_t(q, k, v), *_t(*ids), implementation="kernel",
                                 max_live_kv=tmax)
    dense = ta.masked_attention(*_t(q, k, v), *_t(*ids), implementation="kernel")
    np.testing.assert_allclose(sparse.numpy(), dense.numpy(), **TOL)


def test_plain_sparse_backward_versions_bf16():
    """The plain sparse dq and dk/dv versions on bf16 inputs (what the
    kernels are held to on the card) vs autograd of the fp32 dense
    reference on the same values: within bf16 output rounding (2e-2 of the
    max)."""
    q, k, v, w, ids, _, tmax = _inputs("gqa5_d128", seed=5)
    tq, tk, tv = (torch.tensor(x).bfloat16() for x in (q, k, v))
    tids = _t(*ids)
    rq, rk, rv = (x.float().requires_grad_() for x in (tq, tk, tv))
    (ta.flash_attention_reference(rq, rk, rv, *tids) * torch.from_numpy(w)).sum().backward()
    plan = ta.sparse_plan(*tids, tmax)
    scale = 128 ** -0.5
    o, lse = ta.flash_fwd_sparse(tq, tk, tv, *tids, plan, scale)
    do = torch.from_numpy(w).bfloat16()
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    dq = ta.flash_bwd_dq_sparse(tq, tk, tv, do, lse, delta, *tids, plan, scale)
    dk, dv = ta.flash_bwd_dkv_sparse(tq, tk, tv, do, lse, delta, *tids, plan, scale)
    for got, want in ((dq, rq.grad), (dk, rk.grad), (dv, rv.grad)):
        assert got.dtype == torch.bfloat16
        err = (got.float() - want).abs().max() / want.abs().max()
        assert err.item() < 2e-2


def test_live_tile_bound_covers_packed_documents():
    """The bound derived from the longest document holds for every q tile
    of random packings (windows of 64 after a causal prefix, as the packer
    lays out a T2I sample)."""
    rng = np.random.default_rng(11)
    for _ in range(5):
        blk, doc, nb = [], [], 0
        lens = rng.integers(200, 700, 8)
        for i, n in enumerate(lens):
            causal = int(rng.integers(10, 60))
            rest = (int(n) - causal) // 64 * 64
            blk += list(range(nb, nb + causal))
            nb += causal
            blk += [nb + j // 64 for j in range(rest)]
            nb += rest // 64
            doc += [i] * (causal + rest)
        ids = [torch.tensor(blk, dtype=torch.int32)[None],
               torch.tensor(doc, dtype=torch.int32)[None]]
        longest = int(np.bincount(doc).max())
        ta.sparse_plan(ids[0], ids[1], ids[0], ids[1],
                       ta.live_tile_bound(longest))


def test_sparse_wrappers_refuse_non_cuda_non_cpu_devices():
    q = torch.zeros((1, 64, 2, 64), device="meta", dtype=torch.bfloat16)
    ids = torch.zeros((1, 64), dtype=torch.int32)
    plan = ta.sparse_plan(ids, ids, ids, ids, 1)
    with pytest.raises(RuntimeError, match="no kernel"):
        ta.flash_fwd_sparse(q, q, q, ids, ids, ids, ids, plan, 0.125)
    lse = torch.zeros((1, 2, 64), device="meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        ta.flash_bwd_dq_sparse(q, q, q, q, lse, lse, ids, ids, ids, ids, plan, 0.125)
    with pytest.raises(RuntimeError, match="no kernel"):
        ta.flash_bwd_dkv_sparse(q, q, q, q, lse, lse, ids, ids, ids, ids, plan, 0.125)
