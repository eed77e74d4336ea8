"""The flash kernels' tile classes, the forward's arithmetic, and the ids
the backward kernels are handed.

``tile_classes`` is the plain twin of the kernels' rule for a (q tile, kv
tile) pair (csrc/flash_attention.cu::pair_class): dead pairs are skipped,
full pairs take no per-element id compares. Held against ``mask_from_ids``
at the kernels' 64-row tiles: a dead pair has no visible (query, key), and
a pair is full exactly when both tiles lie inside L and every (query, key)
is visible. On the ids of chip_smoke.py's four flash cases (the ImageNet
H-1x and B-16x training ids among them), a packed T2I batch from the port's
packer, and ragged or unsorted ids.

``flash_fwd_twin`` is the plain twin of the forward kernel's arithmetic (the
live tiles in the kernel's order, ids compared on partial tiles only, the
log2-domain online softmax, P rounded to bf16 before P V). Held against the
Pallas forward, dense and sparse, in interpret mode on the same cases at
small widths (D 64 and 128, GQA), within the card's bounds
(chip_smoke.py::_FLASH_BOUNDS: o 1.2e-2 of max |o|, lse 1e-6 of max |lse|).
The sparse kernel gives the dense kernel's bits only if its list holds
every tile with a visible pair: the tiles the two visit apart then hold
none, and a tile in which a row sees no key leaves the row's max, sum and
O as they were; the twin shows it over the sparse plan and over every tile.

The autograd Functions convert the ids once in the forward and hand the
same int32 tensors to both backward kernels; with ids of another dtype and
a broadcast shape the CPU path still agrees with JAX's custom VJPs (Pallas
interpret mode), float32, tolerance 1e-4 (as the flash gradient tests).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bitdance_tpu.ops import attention as ja
from bitdance_tpu_torch.data.packing import T2ISample, pack_t2i_batch, sincos_1d_table_np
from bitdance_tpu_torch.models.imagenet_ar import config_b, config_h, train_ids
from bitdance_tpu_torch.ops import attention as ta

torch.set_num_threads(2)
TILE = ta.TILE
GTOL = dict(rtol=1e-4, atol=1e-4)


def _packed(lens):
    block = torch.cat([torch.arange(n) for n in lens]).int()
    doc = torch.cat([torch.full((n,), i) for i, n in enumerate(lens)]).int()
    return block, doc


def _t2i_packed():
    """4 T2I samples (prompt + 16 x 16 latents, windows of 4) packed into
    1,500 tokens, the packer's padding at the end."""
    rng = np.random.default_rng(3)
    samples = [T2ISample(
        text_ids=rng.integers(1, 2000, 30 + 17 * i),
        image_latents=np.sign(rng.normal(size=(256, 8))).astype(np.float32),
        latent_h=16, latent_w=16, vision_start_id=2001, res_h_id=2017, res_w_id=2017,
        query_ids=np.arange(2100, 2103), text_loss=True) for i in range(4)]
    raw = pack_t2i_batch(samples, 4, 1500, sincos_1d_table_np(64, 64))
    return (torch.from_numpy(raw["block_ids"]).int(),
            torch.from_numpy(raw["doc_ids"]).int())


def _ids(name):
    """(q block, q doc, kv block, kv doc), each [B, L] int32."""
    if name in ("path", "b16x"):        # chip_smoke.py's ImageNet training cases
        cfg = config_h() if name == "path" else config_b(parallel_num=16)
        block, doc = train_ids(cfg)
    elif name == "packed":              # chip_smoke.py: two documents, 300 + 340
        block, doc = _packed((300, 340))
    elif name == "gqa_d128":            # chip_smoke.py: one causal document of 1,000
        block, doc = torch.arange(1000).int(), torch.zeros(1000).int()
    elif name == "t2i_packed":
        block, doc = _t2i_packed()
    elif name == "ragged":              # a doc boundary inside a tile, L % 64 = 10
        block, doc = _packed((140, 190))
    else:                               # unsorted, Lq != Lk, rows that see no key
        g = torch.Generator().manual_seed(3)
        qb, kb = (torch.randint(0, 40, (n,), generator=g).int() for n in (100, 170))
        qd, kd = (torch.randint(0, 3, (n,), generator=g).int() for n in (100, 170))
        qd[:5] = 7
        return tuple(t[None] for t in (qb, qd, kb, kd))
    return tuple(t[None] for t in (block, doc, block, doc))


CASES = ["path", "b16x", "packed", "gqa_d128", "t2i_packed", "ragged", "unsorted"]


def _mask_tiles(ids):
    """Per (q tile, kv tile): any (query, key) visible, every one visible,
    and both tiles inside L."""
    mask = ta.mask_from_ids(*ids)                      # [B, Lq, Lk]
    b, lq, lk = mask.shape
    nq, nk = -(-lq // TILE), -(-lk // TILE)
    padded = torch.zeros((b, nq * TILE, nk * TILE), dtype=torch.bool)
    padded[:, :lq, :lk] = mask
    tiles = padded.reshape(b, nq, TILE, nk, TILE)
    whole = (((torch.arange(nq) + 1) * TILE <= lq)[:, None]
             & ((torch.arange(nk) + 1) * TILE <= lk)[None, :])
    return tiles.any(dim=(2, 4)), tiles.all(dim=(2, 4)), whole


@pytest.mark.parametrize("name", CASES)
def test_tile_classes_agree_with_mask(name):
    ids = _ids(name)
    cls = ta.tile_classes(*ids, TILE, TILE)
    any_vis, all_vis, whole = _mask_tiles(ids)
    assert cls.shape == any_vis.shape and cls.dtype == torch.int8
    dead, full = cls == ta.TILE_DEAD, cls == ta.TILE_FULL
    assert not (dead & any_vis).any(), "a dead pair has a visible (query, key)"
    assert torch.equal(full, whole & all_vis), "full must be: inside L, all visible"
    # the classes are not vacuous: causal masks leave whole tiles fully
    # visible below the diagonal and invisible above it
    if name != "unsorted":
        assert full.any() and dead.any() and (cls == ta.TILE_PARTIAL).any()


# the card's bounds (chip_smoke.py::_FLASH_BOUNDS), relative to max |value|
FWD_BOUNDS = {"o": 1.2e-2, "lse": 1e-6}
# per case: head dim, q heads, kv heads
FWD_WIDTHS = {"path": (64, 4, 2), "b16x": (64, 4, 4), "packed": (64, 4, 2),
              "gqa_d128": (128, 5, 1), "t2i_packed": (128, 4, 2), "ragged": (64, 4, 1),
              "unsorted": (128, 4, 2)}


def _jax_forward(q, k, v, ids, sparse):
    """(o [B, Lq, Hq, D], lse [B, Hq, Lq]) of the Pallas forward in interpret
    mode (_flash_kernel, or _flash_kernel_sparse with every kv tile allowed:
    no bound drops a tile, ROADMAP C5), padded to 128-row tiles as
    flash_attention and flash_attention_sparse pad."""
    lq, lk, d = q.shape[1], k.shape[1], q.shape[3]
    lq_p, lk_p = ja._round_up(lq, 128), ja._round_up(lk, 128)
    qb, qd, kb, kd = (jnp.asarray(x.numpy()) for x in ids)
    tr = lambda x, n: jnp.transpose(ja._pad_axis(jnp.asarray(x), 1, n), (0, 2, 1, 3))  # noqa: E731
    args = (tr(q, lq_p), tr(k, lk_p), tr(v, lk_p), ja._pad_axis(qb, 1, lq_p, 0),
            ja._pad_axis(qd, 1, lq_p, -3), ja._pad_axis(kb, 1, lk_p, 0),
            ja._pad_axis(kd, 1, lk_p, -2), d ** -0.5, 128, 128)
    if sparse:
        o, lse = ja._flash_sparse_forward_padded(*args, lk_p // 128, True)
    else:
        o, lse = ja._flash_forward_padded(*args, True)
    return np.asarray(o).transpose(0, 2, 1, 3)[:, :lq], np.asarray(lse)[:, :, :lq, 0]


def _bf16_inputs(seed, b, lq, lk, hq, hkv, d):
    """q, k, v as float32 arrays of bf16 values (what the kernel reads)."""
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.normal(size=(b, n, h, d)).astype(np.float32))
                 .bfloat16().float().numpy() for n, h in ((lq, hq), (lk, hkv), (lk, hkv)))


@pytest.mark.parametrize("route", ["dense", "sparse"])
@pytest.mark.parametrize("name", CASES)
def test_forward_twin_matches_jax(name, route):
    """The forward kernel's plain twin (over every kv tile, or over the
    sparse plan's lists) vs the Pallas forward: o and lse within the card's
    bounds; a row that sees no key gets o 0 and lse 1e30 on both sides."""
    ids = _ids(name)
    d, hq, hkv = FWD_WIDTHS[name]
    lq, lk = ids[0].shape[1], ids[2].shape[1]
    q, k, v = _bf16_inputs(5, 1, lq, lk, hq, hkv, d)
    want_o, want_lse = _jax_forward(q, k, v, ids, route == "sparse")
    lists = ()
    if route == "sparse":
        plan = ta.sparse_plan(*ids, -(-lk // TILE))
        lists = (plan.kv_map, plan.kv_counts)
    o, lse = ta.flash_fwd_twin(*(torch.from_numpy(x).bfloat16() for x in (q, k, v)), *ids,
                               d ** -0.5, *lists)
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
    o, lse = o.float().numpy(), lse.numpy()
    live = want_lse < 1e29
    assert live.any()
    assert np.abs(o - want_o).max() <= FWD_BOUNDS["o"] * np.abs(want_o).max()
    assert (np.abs(lse[live] - want_lse[live]).max()
            <= FWD_BOUNDS["lse"] * np.abs(want_lse[live]).max())
    np.testing.assert_array_equal(lse[~live], np.float32(ta.MASKED_LSE))
    rows = ~live.any(axis=1)                         # [B, Lq]: no head sees a key
    np.testing.assert_array_equal(o[rows], 0.0)
    if name == "unsorted":                         # doc 7 (the first 5 rows), and others
        assert rows[:, :5].all()


@pytest.mark.parametrize("name", CASES)
def test_sparse_plan_lists_every_tile_with_a_visible_pair(name):
    """The precondition of sparse = dense bit for bit: for every q tile the
    plan's list (kv_map[:count]) holds every kv tile with a visible (query,
    key) pair. Tiles that tile_classes calls live by their id ranges may be
    left out (the packed T2I batch's padding tiles span every document):
    they hold no visible pair, so visiting them changes no bit, and the
    forward's twin gives the same bits over the plan as over every tile."""
    ids = _ids(name)
    cls = ta.tile_classes(*ids, TILE, TILE)
    any_vis, _, _ = _mask_tiles(ids)
    plan = ta.sparse_plan(*ids, cls.shape[2])
    listed = torch.zeros_like(any_vis)
    for bi in range(listed.shape[0]):
        for i in range(listed.shape[1]):
            listed[bi, i, plan.kv_map[bi, i, :plan.kv_counts[bi, i]].long()] = True
    assert not (any_vis & ~listed).any(), "a tile with a visible pair is not listed"
    if name == "t2i_packed":
        assert ((cls != ta.TILE_DEAD) & ~listed).any()
    lq, lk = ids[0].shape[1], ids[2].shape[1]
    q, k, v = (torch.from_numpy(x).bfloat16() for x in _bf16_inputs(9, 1, lq, lk, 2, 1, 64))
    dense = ta.flash_fwd_twin(q, k, v, *ids, 0.125)
    sparse = ta.flash_fwd_twin(q, k, v, *ids, 0.125, plan.kv_map, plan.kv_counts)
    assert all(map(torch.equal, dense, sparse))


def _recording(monkeypatch, names):
    """Wrap the named kernel wrappers of ops.attention so that each call's
    id arguments (the four tensors after q, k, v, and after dout, lse and
    delta in the backward) are recorded."""
    seen = {}
    for name, at in names.items():
        fn = getattr(ta, name)

        def wrapper(*args, _fn=fn, _name=name, _at=at):
            seen[_name] = args[_at:_at + 4]
            return _fn(*args)

        monkeypatch.setattr(ta, name, wrapper)
    return seen


def _inputs(seed, b=2, lq=150, hq=4, hkv=2, d=32):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, lq, hq, d)).astype(np.float32)
    k = rng.normal(size=(b, lq, hkv, d)).astype(np.float32)
    v = rng.normal(size=(b, lq, hkv, d)).astype(np.float32)
    w = rng.normal(size=(b, lq, hq, d)).astype(np.float32)
    block, doc = _packed((70, 80))
    return q, k, v, w, block.numpy(), doc.numpy()


@pytest.mark.parametrize("route", ["dense", "sparse"])
def test_forward_ids_reach_both_backward_kernels(monkeypatch, route):
    """ids given as int64 [1, L] for a batch of 2: the forward converts them
    once, and both backward wrappers get those very int32 [B, L] tensors
    (self-attention: one block and one doc tensor); gradients as JAX's."""
    q, k, v, w, block, doc = _inputs(seed=7)
    b, L = q.shape[:2]
    jids = tuple(np.broadcast_to(x, (b, L)).astype(np.int32) for x in (block, doc) * 2)
    if route == "dense":
        names = {"flash_fwd": 3, "flash_bwd_dq": 6, "flash_bwd_dkv": 6}

        def jax_fn(q, k, v):
            return ja.flash_attention(q, k, v, *jids, block_q=128, block_k=128,
                                      interpret=True)

        def torch_fn(*qkv, ids):
            return ta.flash_attention(*qkv, *ids)
    else:
        names = {"flash_fwd_sparse": 3, "flash_bwd_dq_sparse": 6, "flash_bwd_dkv_sparse": 6}

        def jax_fn(q, k, v):
            return ja.flash_attention_sparse(q, k, v, *jids, max_live_kv=2, block_q=128,
                                             block_k=128, interpret=True)

        def torch_fn(*qkv, ids):
            return ta.flash_attention_sparse(*qkv, *ids, max_live_kv=ta.live_tile_bound(80))
    want = jax.grad(lambda *a: jnp.sum(jax_fn(*a) * w), argnums=(0, 1, 2))(
        *(jnp.asarray(x) for x in (q, k, v)))
    seen = _recording(monkeypatch, names)
    blk64, doc64 = (torch.from_numpy(x).long()[None] for x in (block, doc))
    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    o = torch_fn(tq, tk, tv, ids=(blk64, doc64, blk64, doc64))
    (o * torch.from_numpy(w)).sum().backward()
    fwd, dq, dkv = (seen[n] for n in names)
    for ids in (fwd, dq, dkv):
        assert all(t.dtype == torch.int32 and t.shape == (b, L) and t.is_contiguous()
                   for t in ids)
    assert all(a is x and a is y for a, x, y in zip(fwd, dq, dkv))
    assert fwd[0] is fwd[2] and fwd[1] is fwd[3]
    for got, ref, n in zip((tq.grad, tk.grad, tv.grad), want, "qkv"):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **GTOL, err_msg=f"d{n}")
