"""The flash backward kernels' tile classes and the ids they are handed.

``tile_classes`` is the plain twin of the backward kernels' rule for a
(q tile, kv tile) pair (csrc/flash_attention.cu::pair_class): dead pairs
are skipped, full pairs take no per-element id compares. Held against
``mask_from_ids`` at the kernels' 64-row tiles: a dead pair has no visible
(query, key), and a pair is full exactly when both tiles lie inside L and
every (query, key) is visible. On the ids of chip_smoke.py's four flash
cases (the ImageNet H-1x and B-16x training ids among them), a packed T2I
batch from the port's packer, and ragged or unsorted ids.

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
