"""Attention under the (block_id, doc_id) mask model (port of
bitdance_tpu/ops/attention.py: mask_from_ids, attention_xla, flash_attention
with its custom VJP, the sparse-iteration flash_attention_sparse with its
tile maps, masked_attention).

Every token carries two int32 ids and query i sees key j iff
``doc_q[i] == doc_k[j]`` and ``block_k[j] <= block_q[i]`` (causal: block =
position; a parallel window shares one block id; packed samples differ in
doc id). The flash path is ``csrc/flash_attention.cu``: one forward kernel
that returns o and the per-row log-sum-exp, and two backward kernels (dq;
dk/dv summed over each GQA group). :func:`flash_attention_reference` is the
plain differentiable version (and the forward kernel's plain version);
``flash_bwd_dq_reference`` and ``flash_bwd_dkv_reference`` are the backward
kernels'. The three wrappers take their plain versions only for CPU
tensors; on a CUDA tensor they launch their kernel or raise. The autograd
Functions make the int32 ids once in the forward and hand the same tensors
to both backward kernels; :func:`tile_classes` is the plain twin of the
kernels' dead / partial / full classification of tile pairs, and
:func:`flash_fwd_twin` of the forward kernel's arithmetic (both for the
tests).

Sparse iteration (packed training): :func:`sparse_plan` builds, once per
batch on the device, the per-q-tile list of live 64-key tiles
(:func:`kv_tile_map`) and its transpose, the per-kv-tile list of live q
tiles, and checks both against their bounds with one host read: an
undersized bound RAISES (the JAX function clamps the counts and drops
tiles). ``flash_fwd_sparse``, ``flash_bwd_dq_sparse`` and
``flash_bwd_dkv_sparse`` are the same three kernels iterating those lists;
their plain versions (``flash_sparse_reference``, ``flash_sparse_dq_reference``,
``flash_sparse_dkv_reference``) compute over exactly the listed tiles, so a
dropped or extra tile shows.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from bitdance_tpu_torch.ops import _cuda

NEG_INF = -1e30
MASKED_LSE = 1e30   # lse of a row that sees no key: exp(s - lse) == 0
# tile size of the CUDA kernels (csrc/flash_attention.cu kBQ, kBK): q tiles
# (the dk/dv kernel's too) and kv tiles of 64 rows
TILE = 64
Q_PAD_DOC, KV_PAD_DOC = -3, -2   # doc ids of rows padded up to a tile


def mask_from_ids(q_block: torch.Tensor, q_doc: torch.Tensor,
                  kv_block: torch.Tensor, kv_doc: torch.Tensor) -> torch.Tensor:
    """Dense bool mask [..., Lq, Lk]: same doc and kv block <= q block."""
    return ((q_doc[..., :, None] == kv_doc[..., None, :])
            & (kv_block[..., None, :] <= q_block[..., :, None]))


def attention_xla(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  mask: torch.Tensor | None = None,
                  scale: float | None = None) -> torch.Tensor:
    """Attention with fp32 softmax.

    q: [B, Lq, Hq, D]; k/v: [B, Lk, Hkv, D]; mask broadcastable to
    [B, Hq, Lq, Lk] (True = attend). GQA by head repetition. A fully masked
    row averages v uniformly, exactly as the JAX function does.
    """
    b, lq, hq, d = q.shape
    hkv = k.shape[2]
    assert hq % hkv == 0
    group = hq // hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    qf = q.float() * scale
    kf = k.float()
    vf = v.float()
    if group > 1:
        kf = kf.repeat_interleave(group, dim=2)
        vf = vf.repeat_interleave(group, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf)
    if mask is not None:
        s = torch.where(mask, s, torch.full((), NEG_INF, device=s.device))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    p = torch.where(l > 0, p / l.clamp_min(1e-30), torch.zeros((), device=p.device))
    return torch.einsum("bhqk,bkhd->bqhd", p, vf).to(q.dtype)


# ---------------------------------------------------------------------------
# Flash attention: plain versions
# ---------------------------------------------------------------------------

def _repeat_kv(x: torch.Tensor, group: int) -> torch.Tensor:
    return x.repeat_interleave(group, dim=2) if group > 1 else x


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, q_block_ids: torch.Tensor,
                              q_doc_ids: torch.Tensor,
                              kv_block_ids: torch.Tensor,
                              kv_doc_ids: torch.Tensor,
                              scale: float | None = None,
                              return_lse: bool = False):
    """Plain flash attention, fp32 softmax, differentiable through autograd.

    q: [B, Lq, Hq, D]; k/v: [B, Lk, Hkv, D]; ids [B, L] int. A row that sees
    no key gives output 0 and lse 1e30 (the flash kernels' conventions; the
    dense ``attention_xla`` averages v there instead). lse: [B, Hq, Lq] fp32.
    """
    hq, d = q.shape[2], q.shape[3]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    group = hq // k.shape[2]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float() * scale,
                     _repeat_kv(k.float(), group))
    mask = mask_from_ids(q_block_ids, q_doc_ids, kv_block_ids, kv_doc_ids)[:, None]
    s = torch.where(mask, s, torch.full((), NEG_INF, device=s.device))
    m = s.amax(dim=-1, keepdim=True).detach()   # o and lse do not depend on m
    p = torch.where(mask, torch.exp(s - m), torch.zeros((), device=s.device))
    l = p.sum(dim=-1, keepdim=True)
    live = l > 0
    safe = torch.where(live, l, torch.ones((), device=l.device))
    o = torch.einsum("bhqk,bkhd->bqhd", p / safe,
                     _repeat_kv(v.float(), group)).to(q.dtype)
    if not return_lse:
        return o
    lse = torch.where(live, m + torch.log(safe),
                      torch.full((), MASKED_LSE, device=l.device))[..., 0]
    return o, lse


def _flash_ds(q, k, v, dout, lse, delta, q_block_ids, q_doc_ids, kv_block_ids,
              kv_doc_ids, scale: float):
    """Recomputed p and ds = p * (dp - delta) [B, Hq, Lq, Lk], fp32."""
    group = q.shape[2] // k.shape[2]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float() * scale,
                     _repeat_kv(k.float(), group))
    mask = mask_from_ids(q_block_ids, q_doc_ids, kv_block_ids, kv_doc_ids)[:, None]
    p = torch.where(mask, torch.exp(s - lse[..., None]),
                    torch.zeros((), device=s.device))
    dp = torch.einsum("bqhd,bkhd->bhqk", dout.float(), _repeat_kv(v.float(), group))
    return p, p * (dp - delta[..., None])


def flash_bwd_dq_reference(q, k, v, dout, lse, delta, q_block_ids, q_doc_ids,
                           kv_block_ids, kv_doc_ids, scale: float) -> torch.Tensor:
    """Plain version of the dq kernel: p recomputed from lse [B, Hq, Lq],
    ds = p * (dp - delta), dq = scale * ds K (as _flash_bwd_dq_kernel,
    attention.py:339-377)."""
    _, ds = _flash_ds(q, k, v, dout, lse, delta, q_block_ids, q_doc_ids,
                      kv_block_ids, kv_doc_ids, scale)
    kf = _repeat_kv(k.float(), q.shape[2] // k.shape[2])
    return (torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale).to(q.dtype)


def flash_bwd_dkv_reference(q, k, v, dout, lse, delta, q_block_ids, q_doc_ids,
                            kv_block_ids, kv_doc_ids, scale: float):
    """Plain version of the dk/dv kernel: dk = scale * ds^T Q, dv = p^T dO,
    each summed over its GQA group (as _flash_bwd_dkv_kernel and the group
    sum of _flash_backward_padded, attention.py:380-499)."""
    b, lk, hkv, d = k.shape
    group = q.shape[2] // hkv
    p, ds = _flash_ds(q, k, v, dout, lse, delta, q_block_ids, q_doc_ids,
                      kv_block_ids, kv_doc_ids, scale)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float()) * scale
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dout.float())
    return (dk.reshape(b, lk, hkv, group, d).sum(dim=3).to(k.dtype),
            dv.reshape(b, lk, hkv, group, d).sum(dim=3).to(v.dtype))


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def _ids(t: torch.Tensor, b: int, n: int, device) -> torch.Tensor:
    """ids of any int dtype, broadcastable to [b, n] -> contiguous int32
    [b, n] on ``device`` (no copy when they already are)."""
    if (t.dtype == torch.int32 and t.device == device and t.shape == (b, n)
            and t.is_contiguous()):
        return t
    return t.to(device=device, dtype=torch.int32).expand(b, n).contiguous()


def _ids_once(q, k, q_block_ids, q_doc_ids, kv_block_ids, kv_doc_ids):
    """The four id tensors as the kernels take them (:func:`_ids`), made
    once per attention call: the forward saves them for both backward
    kernels, and a kv id tensor that is the q one (self-attention) is
    converted once."""
    b, lq, lk, dev = q.shape[0], q.shape[1], k.shape[1], q.device
    qb, qd = _ids(q_block_ids, b, lq, dev), _ids(q_doc_ids, b, lq, dev)
    kb = qb if kv_block_ids is q_block_ids and lk == lq else _ids(kv_block_ids, b, lk, dev)
    kd = qd if kv_doc_ids is q_doc_ids and lk == lq else _ids(kv_doc_ids, b, lk, dev)
    return qb, qd, kb, kd


def _check(name: str, q, k, v, *more) -> None:
    if q.device.type != "cuda":
        raise RuntimeError(f"{name}: no kernel for {q.device}")
    b, lq, hq, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d or \
            d not in (64, 128) or hq % k.shape[2]:
        raise ValueError(f"{name}: kernel takes head dim 64 or 128 and GQA "
                         f"k/v, got q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    for t in (q, k, v, *more):
        if t.dtype != torch.bfloat16 or not t.is_contiguous() or t.device != q.device:
            raise ValueError(f"{name}: tensors must be contiguous bf16 on "
                             f"{q.device}, got {t.dtype} {tuple(t.shape)}")


def flash_fwd(q, k, v, q_block_ids, q_doc_ids, kv_block_ids, kv_doc_ids,
              scale: float):
    """(o [B, Lq, Hq, D], lse [B, Hq, Lq] fp32) of masked flash attention."""
    if q.device.type == "cpu":
        with torch.no_grad():
            return flash_attention_reference(q, k, v, q_block_ids, q_doc_ids,
                                             kv_block_ids, kv_doc_ids, scale,
                                             return_lse=True)
    _check("flash_fwd", q, k, v)
    b, lq, hq, d = q.shape
    lk, hkv = k.shape[1], k.shape[2]
    qb, qd = (_ids(t, b, lq, q.device) for t in (q_block_ids, q_doc_ids))
    kb, kd = (_ids(t, b, lk, q.device) for t in (kv_block_ids, kv_doc_ids))
    o = torch.empty_like(q)
    lse = torch.empty((b, hq, lq), dtype=torch.float32, device=q.device)
    _cuda.check(_cuda.load().bd_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
        qb.data_ptr(), qd.data_ptr(), kb.data_ptr(), kd.data_ptr(),
        b, lq, lk, hq, hkv, d, float(scale), _cuda.stream_ptr()), "flash_fwd")
    flash_fwd.launches += 1
    return o, lse


def flash_bwd_dq(q, k, v, dout, lse, delta, q_block_ids, q_doc_ids,
                 kv_block_ids, kv_doc_ids, scale: float) -> torch.Tensor:
    """dq of masked flash attention (like q)."""
    if q.device.type == "cpu":
        return flash_bwd_dq_reference(q, k, v, dout, lse, delta, q_block_ids,
                                      q_doc_ids, kv_block_ids, kv_doc_ids, scale)
    _check("flash_bwd_dq", q, k, v, dout)
    b, lq, hq, d = q.shape
    lk, hkv = k.shape[1], k.shape[2]
    qb, qd = (_ids(t, b, lq, q.device) for t in (q_block_ids, q_doc_ids))
    kb, kd = (_ids(t, b, lk, q.device) for t in (kv_block_ids, kv_doc_ids))
    dq = torch.empty_like(q)
    _cuda.check(_cuda.load().bd_flash_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
        lse.contiguous().data_ptr(), delta.contiguous().data_ptr(),
        dq.data_ptr(), qb.data_ptr(), qd.data_ptr(), kb.data_ptr(),
        kd.data_ptr(), b, lq, lk, hq, hkv, d, float(scale),
        _cuda.stream_ptr()), "flash_bwd_dq")
    flash_bwd_dq.launches += 1
    return dq


def flash_bwd_dkv(q, k, v, dout, lse, delta, q_block_ids, q_doc_ids,
                  kv_block_ids, kv_doc_ids, scale: float):
    """(dk, dv) of masked flash attention (like k), summed per GQA group."""
    if q.device.type == "cpu":
        return flash_bwd_dkv_reference(q, k, v, dout, lse, delta, q_block_ids,
                                       q_doc_ids, kv_block_ids, kv_doc_ids, scale)
    _check("flash_bwd_dkv", q, k, v, dout)
    b, lq, hq, d = q.shape
    lk, hkv = k.shape[1], k.shape[2]
    qb, qd = (_ids(t, b, lq, q.device) for t in (q_block_ids, q_doc_ids))
    kb, kd = (_ids(t, b, lk, q.device) for t in (kv_block_ids, kv_doc_ids))
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    _cuda.check(_cuda.load().bd_flash_bwd_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
        lse.contiguous().data_ptr(), delta.contiguous().data_ptr(),
        dk.data_ptr(), dv.data_ptr(), qb.data_ptr(), qd.data_ptr(),
        kb.data_ptr(), kd.data_ptr(), b, lq, lk, hq, hkv, d, float(scale),
        _cuda.stream_ptr()), "flash_bwd_dkv")
    flash_bwd_dkv.launches += 1
    return dk, dv


flash_fwd.launches = 0
flash_bwd_dq.launches = 0
flash_bwd_dkv.launches = 0


class _FlashAttention(torch.autograd.Function):
    """Forward saves lse and the int32 ids it made (:func:`_ids_once`);
    backward takes delta = sum(do * o) as a plain reduction, then the dq and
    dk/dv kernels on those ids, with no id copies (the custom VJP of
    _flash_core, attention.py:508-541)."""

    @staticmethod
    def forward(ctx, q, k, v, qb, qd, kb, kd, scale):
        ids = _ids_once(q, k, qb, qd, kb, kd)
        o, lse = flash_fwd(q, k, v, *ids, scale)
        ctx.save_for_backward(q, k, v, *ids, o, lse)
        ctx.scale = scale
        return o

    @staticmethod
    def backward(ctx, dout):
        q, k, v, qb, qd, kb, kd, o, lse = ctx.saved_tensors
        dout = dout.to(q.dtype).contiguous()
        delta = (dout.float() * o.float()).sum(dim=-1).transpose(1, 2).contiguous()
        dq = flash_bwd_dq(q, k, v, dout, lse, delta, qb, qd, kb, kd, ctx.scale)
        dk, dv = flash_bwd_dkv(q, k, v, dout, lse, delta, qb, qd, kb, kd,
                               ctx.scale)
        return dq, dk, dv, None, None, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    q_block_ids: torch.Tensor, q_doc_ids: torch.Tensor,
                    kv_block_ids: torch.Tensor, kv_doc_ids: torch.Tensor,
                    scale: float | None = None) -> torch.Tensor:
    """Differentiable masked flash attention; q [B, Lq, Hq, D], k/v
    [B, Lk, Hkv, D], ids [B, L]. Rows that see no key give 0."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    return _FlashAttention.apply(q.contiguous(), k.contiguous(), v.contiguous(),
                                 q_block_ids, q_doc_ids, kv_block_ids,
                                 kv_doc_ids, float(scale))


# ---------------------------------------------------------------------------
# Sparse-iteration flash attention: tile maps
# ---------------------------------------------------------------------------

def _pad_ids(t: torch.Tensor, n: int, value: int) -> torch.Tensor:
    t = t.to(torch.int32)
    if t.shape[-1] == n:
        return t
    pad = torch.full((*t.shape[:-1], n - t.shape[-1]), value, dtype=torch.int32,
                     device=t.device)
    return torch.cat([t, pad], dim=-1)


def _range_overlap(q_min, q_max, k_min, k_max) -> torch.Tensor:
    """[B, n_q, n_k]: the q tile's [min, max] meets the kv tile's."""
    return ~((k_min[:, None, :] > q_max[:, :, None])
             | (k_max[:, None, :] < q_min[:, :, None]))


def tile_live_matrix(q_block_ids: torch.Tensor, q_doc_ids: torch.Tensor,
                     kv_block_ids: torch.Tensor, kv_doc_ids: torch.Tensor,
                     block_q: int, block_k: int) -> torch.Tensor:
    """[B, n_q, n_k] bool: tile (i, j) is live unless provably fully masked
    (min kv block id > max q block id, or no doc id the two tiles could
    share). Lengths must be multiples of the tile sizes.

    Negative doc ids are padding (packer padding -1, tile padding -3 / -2)
    and are tested apart from the documents: two tiles are live by doc when
    their ranges of non-negative ids meet or their ranges of negative ids
    meet. Where every id is >= 0 this is the JAX function's test
    (attention.py:612-635). That test takes one [min, max] over all ids, so
    a q tile holding a document's end and the packer's padding (doc -1)
    spans every document: every earlier kv tile is live and the row exceeds
    any bound set from the longest document (ROADMAP C5)."""
    b, lq = q_block_ids.shape
    lk = kv_block_ids.shape[1]
    n_q, n_k = lq // block_q, lk // block_k
    big = torch.iinfo(torch.int32).max
    qb = q_block_ids.reshape(b, n_q, block_q)
    kb = kv_block_ids.reshape(b, n_k, block_k)
    blk_live = kb.amin(-1)[:, None, :] <= qb.amax(-1)[:, :, None]

    def ranges(d: torch.Tensor, n: int, size: int):
        d = d.reshape(b, n, size)
        pos, neg = d >= 0, d < 0
        big_t = torch.full((), big, dtype=d.dtype, device=d.device)
        return (torch.where(pos, d, big_t).amin(-1), torch.where(pos, d, -big_t).amax(-1),
                torch.where(neg, d, big_t).amin(-1), torch.where(neg, d, -big_t).amax(-1))

    qp_min, qp_max, qn_min, qn_max = ranges(q_doc_ids, n_q, block_q)
    kp_min, kp_max, kn_min, kn_max = ranges(kv_doc_ids, n_k, block_k)
    doc_live = (_range_overlap(qp_min, qp_max, kp_min, kp_max)
                | _range_overlap(qn_min, qn_max, kn_min, kn_max))
    return blk_live & doc_live


TILE_DEAD, TILE_PARTIAL, TILE_FULL = 0, 1, 2


def _tile_ranges(block_ids: torch.Tensor, doc_ids: torch.Tensor, tile: int):
    """(block min, block max, doc min, doc max) [B, ceil(L / tile)] over
    each tile's ids inside L."""
    b, n_ids = block_ids.shape
    n = -(-n_ids // tile)
    hi, lo = torch.iinfo(torch.int32).max, torch.iinfo(torch.int32).min

    def tiles(t: torch.Tensor, fill: int) -> torch.Tensor:
        pad = t.new_full((b, n * tile - n_ids), fill)
        return torch.cat([t, pad], 1).reshape(b, n, tile)

    return (tiles(block_ids, hi).amin(-1), tiles(block_ids, lo).amax(-1),
            tiles(doc_ids, hi).amin(-1), tiles(doc_ids, lo).amax(-1))


def tile_classes(q_block_ids: torch.Tensor, q_doc_ids: torch.Tensor,
                 kv_block_ids: torch.Tensor, kv_doc_ids: torch.Tensor,
                 block_q: int, block_k: int) -> torch.Tensor:
    """[B, ceil(Lq / block_q), ceil(Lk / block_k)] int8 class of each
    (q tile, kv tile) pair under the backward kernels' rule
    (csrc/flash_attention.cu::pair_class), ids int32 [B, L]: TILE_DEAD when
    no query can see a key (min kv block > max q block, or disjoint doc
    ranges), TILE_FULL when every query sees every key (both tiles inside
    L, max kv block <= min q block, one doc id on both sides), else
    TILE_PARTIAL. The kernels skip dead pairs and take full ones without
    per-element id compares. Plain twin for the tests; the card path never
    calls it."""
    lq, lk = q_block_ids.shape[1], kv_block_ids.shape[1]
    qb_min, qb_max, qd_min, qd_max = (r[:, :, None] for r in _tile_ranges(
        q_block_ids, q_doc_ids, block_q))
    kb_min, kb_max, kd_min, kd_max = (r[:, None, :] for r in _tile_ranges(
        kv_block_ids, kv_doc_ids, block_k))
    dead = (kb_min > qb_max) | (kd_min > qd_max) | (kd_max < qd_min)
    dev = q_block_ids.device
    whole = (((torch.arange(qb_min.shape[1], device=dev) + 1) * block_q <= lq)[:, None]
             & ((torch.arange(kb_min.shape[2], device=dev) + 1) * block_k <= lk)[None, :])
    full = (whole & (kb_max <= qb_min) & (qd_min == qd_max) & (kd_min == kd_max)
            & (qd_min == kd_min))
    return torch.where(dead, TILE_DEAD, torch.where(full, TILE_FULL, TILE_PARTIAL)).to(
        torch.int8)


def flash_fwd_twin(q, k, v, q_block_ids, q_doc_ids, kv_block_ids, kv_doc_ids,
                   scale: float, tile_map=None, counts=None):
    """Plain twin of the forward kernel's arithmetic
    (csrc/flash_attention.cu::flash_fwd_kernel), for the tests; the card
    path never calls it. Per 64-row q tile, its candidate 64-key tiles in the
    kernel's order (every kv tile, or tile_map[b, i, :counts[b, i]] where a
    sparse plan is given), the dead ones (:func:`tile_classes`) skipped and
    ids compared on partial ones only; an online softmax in the log2 domain
    (running max m of the raw scores, p = exp2(s scale log2(e) - m scale
    log2(e)), 0 where masked); P rounded to bf16 before P V. Returns
    (o = O / l in q's dtype, lse = (m scale log2(e) + log2(l)) ln(2) [B, Hq,
    Lq] fp32), 0 and 1e30 where a row sees no key. ids int32 [B, L]."""
    b, lq, hq, d = q.shape
    lk, hkv = k.shape[1], k.shape[2]
    group = hq // hkv
    n_q, n_k = -(-lq // TILE), -(-lk // TILE)
    classes = tile_classes(q_block_ids, q_doc_ids, kv_block_ids, kv_doc_ids, TILE,
                           TILE).tolist()
    sl2 = torch.tensor(scale * math.log2(math.e), dtype=torch.float32)
    qp = _pad_rows(q.float(), n_q * TILE)
    kp, vp = (_heads(_pad_rows(t.float(), n_k * TILE), group) for t in (k, v))
    qbp, qdp = (_pad_ids(t, n_q * TILE, 0) for t in (q_block_ids, q_doc_ids))
    kbp, kdp = (_pad_ids(t, n_k * TILE, 0) for t in (kv_block_ids, kv_doc_ids))
    key_in = torch.arange(n_k * TILE) < lk
    o = torch.zeros((b, n_q * TILE, hq, d))
    lse = torch.full((b, hq, n_q * TILE), MASKED_LSE)
    for bi in range(b):
        for i in range(n_q):
            rows = slice(i * TILE, (i + 1) * TILE)
            qt = qp[bi, rows].transpose(0, 1)                        # [Hq, 64, D]
            m = torch.full((hq, TILE), NEG_INF)
            l = torch.zeros((hq, TILE))
            acc = torch.zeros((hq, TILE, d))
            cand = (range(n_k) if tile_map is None
                    else tile_map[bi, i, :int(counts[bi, i])].tolist())
            for t in cand:
                cls = classes[bi][i][t]
                if cls == TILE_DEAD:
                    continue
                keys = slice(t * TILE, (t + 1) * TILE)
                s = qt @ kp[bi, keys].permute(1, 2, 0)              # [Hq, 64, 64]
                if cls == TILE_PARTIAL:
                    vis = (key_in[keys] & (kdp[bi, keys] == qdp[bi, rows, None])
                           & (kbp[bi, keys] <= qbp[bi, rows, None]))
                else:
                    vis = torch.ones((TILE, TILE), dtype=torch.bool)
                m_new = torch.maximum(m, torch.where(vis, s, NEG_INF).amax(-1))
                m2 = m_new * sl2
                corr = torch.exp2(m * sl2 - m2)
                p = torch.where(vis, torch.exp2(s * sl2 - m2[..., None]), 0.0)
                l = l * corr + p.sum(-1)
                acc = (acc * corr[..., None]
                       + p.bfloat16().float() @ vp[bi, keys].transpose(0, 1))
                m = m_new
            live = l > 0
            safe = torch.where(live, l, 1.0)
            o[bi, rows] = torch.where(live[..., None], acc / safe[..., None], 0.0).transpose(0, 1)
            lse[bi, :, rows] = torch.where(live, (m * sl2 + torch.log2(safe)) * math.log(2),
                                           MASKED_LSE)
    return o[:, :lq].to(q.dtype), lse[:, :, :lq]


def select_live_tiles(live: torch.Tensor, max_n: int):
    """live [B, R, C] bool -> (tile_map [B, R, max_n], counts [B, R]) int32:
    per row, the live column indices in ascending order; trailing entries
    repeat the last live index. Counts are clamped to max_n, as in the JAX
    function (attention.py:638-652); :func:`sparse_plan` checks the
    unclamped counts first and raises instead of dropping."""
    counts = live.sum(-1).to(torch.int32)
    order = torch.argsort((~live).to(torch.int8), dim=-1, stable=True)
    sel = order[..., :max_n]
    if sel.shape[-1] < max_n:
        sel = torch.cat([sel, sel[..., -1:].expand(*sel.shape[:-1],
                                                   max_n - sel.shape[-1])], -1)
    last = torch.gather(sel, -1, (counts.long() - 1).clamp(min=0)[..., None])
    pos = torch.arange(max_n, device=live.device)
    tile_map = torch.where(pos < counts[..., None], sel, last).to(torch.int32)
    return tile_map, counts.clamp(max=max_n)


def kv_tile_map(q_block_ids: torch.Tensor, q_doc_ids: torch.Tensor,
                kv_block_ids: torch.Tensor, kv_doc_ids: torch.Tensor,
                block_q: int, block_k: int, max_live_kv: int):
    """Per-(batch, q-tile) list of live kv tiles, ascending."""
    live = tile_live_matrix(q_block_ids, q_doc_ids, kv_block_ids, kv_doc_ids,
                            block_q, block_k)
    return select_live_tiles(live, max_live_kv)


def live_tile_bound(max_doc_tokens: int) -> int:
    """Live 64-key tiles a 64-row q tile can see, from the data guarantee
    that no document is longer than ``max_doc_tokens``, nor any block (a
    parallel window, or the packer's padding, which is one block). A q tile
    can hold the end of one document and the start of the next: its rows
    reach back to the start of the first one's document and forward to the
    end of the last one's block, an interval of at most 2 * max_doc + 62
    tokens, which touches at most ceil((n - 1) / 64) + 1 tiles."""
    n = 2 * max_doc_tokens + TILE - 2
    return -(-(n - 1) // TILE) + 1


class SparsePlan(NamedTuple):
    """The tile lists of one batch's ids, built once and shared by every
    layer. kv_map [B, ceil(Lq/64), max_live_kv] and kv_counts list 64-key
    tiles per 64-row q tile (forward, dq); q_map [B, ceil(Lk/64),
    max_live_q] and q_counts list the transposed lists, q tiles of
    ``block_q_dkv`` (64) rows per 64-key tile (dk/dv). int32 on the ids'
    device."""
    kv_map: torch.Tensor
    kv_counts: torch.Tensor
    q_map: torch.Tensor
    q_counts: torch.Tensor
    block_q_dkv: int


def sparse_plan(q_block_ids: torch.Tensor, q_doc_ids: torch.Tensor,
                kv_block_ids: torch.Tensor, kv_doc_ids: torch.Tensor,
                max_live_kv: int) -> SparsePlan:
    """Build both tile lists (ids [B, L]) and check them: raises ValueError
    if any q tile has more than ``max_live_kv`` live kv tiles or any kv tile
    more than max_live_q = max_live_kv + 1 live q tiles (the JAX backward's
    bound, attention.py:922, in this port's tiles). One host read."""
    b, lq = q_block_ids.shape
    lk = kv_block_ids.shape[1]
    n_q, n_k = -(-lq // TILE), -(-lk // TILE)
    max_live_kv = min(max_live_kv, n_k)
    max_live_q = min(n_q, max_live_kv + 1)
    live = tile_live_matrix(_pad_ids(q_block_ids, n_q * TILE, 0),
                            _pad_ids(q_doc_ids, n_q * TILE, Q_PAD_DOC),
                            _pad_ids(kv_block_ids, n_k * TILE, 0),
                            _pad_ids(kv_doc_ids, n_k * TILE, KV_PAD_DOC), TILE, TILE)
    most_kv, most_q = torch.stack([live.sum(-1).amax(), live.sum(-2).amax()]).tolist()
    if most_kv > max_live_kv or most_q > max_live_q:
        raise ValueError(
            f"sparse flash attention: a q tile has {most_kv} live kv tiles "
            f"(bound {max_live_kv}) and a kv tile {most_q} live q tiles (bound "
            f"{max_live_q}); size max_live_kv from the longest document "
            "(live_tile_bound)")
    kv_map, kv_counts = select_live_tiles(live, max_live_kv)
    q_map, q_counts = select_live_tiles(live.transpose(1, 2), max_live_q)
    return SparsePlan(kv_map.contiguous(), kv_counts.contiguous(),
                      q_map.contiguous(), q_counts.contiguous(), TILE)


# ---------------------------------------------------------------------------
# Sparse-iteration flash attention: plain versions (over the listed tiles)
# ---------------------------------------------------------------------------

def _pad_rows(x: torch.Tensor, n: int) -> torch.Tensor:
    if x.shape[1] == n:
        return x
    return torch.cat([x, x.new_zeros((x.shape[0], n - x.shape[1], *x.shape[2:]))], 1)


def _gather_tiles(tile_map, counts, tile: int):
    """Row indices [B, R, S*tile] of the listed tiles and their validity
    (entry j < count) [B, R, S*tile], S the largest count (entries past it
    are never valid)."""
    s = max(1, int(counts.max()))
    tile_map = tile_map[..., :s]
    ar = torch.arange(tile, device=tile_map.device)
    idx = (tile_map.long()[..., None] * tile + ar).flatten(-2)
    valid = (torch.arange(s, device=tile_map.device) < counts[..., None])
    return idx, valid.repeat_interleave(tile, dim=-1)


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [B, L, ...] at rows idx [B, R, K] -> [B, R, K, ...]."""
    bidx = torch.arange(x.shape[0], device=x.device)[:, None, None]
    return x[bidx, idx]


def _heads(x: torch.Tensor, group: int) -> torch.Tensor:
    """[..., Hkv, D] -> [..., Hq, D] (each kv head repeated for its group)."""
    return x.repeat_interleave(group, dim=-2) if group > 1 else x


def _sparse_fwd_tiles(q, k, v, qb, qd, kb, kd, tile_map, counts, scale):
    """(s-mask, p, normaliser ...) helpers of the plain forward and dq: q
    tiles [B, n_q, 64, Hq, D] against their listed keys."""
    b, lq, hq, d = q.shape
    group = hq // k.shape[2]
    n_q = tile_map.shape[1]
    lqp, lkp = n_q * TILE, -(-k.shape[1] // TILE) * TILE
    qt = _pad_rows(q, lqp).reshape(b, n_q, TILE, hq, d)
    qbt = _pad_ids(qb, lqp, 0).reshape(b, n_q, TILE)
    qdt = _pad_ids(qd, lqp, Q_PAD_DOC).reshape(b, n_q, TILE)
    idx, valid = _gather_tiles(tile_map, counts, TILE)
    kg = _heads(_take(_pad_rows(k, lkp), idx).float(), group)
    vg = _heads(_take(_pad_rows(v, lkp), idx).float(), group)
    kbg = _take(_pad_ids(kb, lkp, 0), idx)
    kdg = _take(_pad_ids(kd, lkp, KV_PAD_DOC), idx)
    mask = ((qdt[..., :, None] == kdg[..., None, :])
            & (kbg[..., None, :] <= qbt[..., :, None]) & valid[..., None, :])
    s = torch.einsum("bnqhd,bnkhd->bnhqk", qt.float() * scale, kg)
    return qt, kg, vg, mask[:, :, None], s, lqp


def flash_sparse_reference(q, k, v, q_block_ids, q_doc_ids, kv_block_ids,
                           kv_doc_ids, tile_map, counts,
                           scale: float | None = None, return_lse: bool = False):
    """Plain sparse forward: each 64-row q tile attends over exactly the
    64-key tiles tile_map[b, i, :counts[b, i]] under the id mask; fp32
    softmax, differentiable. Shapes and conventions as
    :func:`flash_attention_reference` (a row that sees no key gives 0 and
    lse 1e30)."""
    b, lq, hq, d = q.shape
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    _, _, vg, mask, s, lqp = _sparse_fwd_tiles(
        q, k, v, q_block_ids, q_doc_ids, kv_block_ids, kv_doc_ids, tile_map,
        counts, scale)
    s = torch.where(mask, s, torch.full((), NEG_INF, device=s.device))
    m = s.amax(dim=-1, keepdim=True).detach()
    p = torch.where(mask, torch.exp(s - m), torch.zeros((), device=s.device))
    l = p.sum(dim=-1, keepdim=True)
    live = l > 0
    safe = torch.where(live, l, torch.ones((), device=l.device))
    o = torch.einsum("bnhqk,bnkhd->bnqhd", p / safe, vg)
    o = o.reshape(b, lqp, hq, d)[:, :lq].to(q.dtype)
    if not return_lse:
        return o
    lse = torch.where(live, m + torch.log(safe),
                      torch.full((), MASKED_LSE, device=l.device))[..., 0]
    lse = lse.permute(0, 2, 1, 3).reshape(b, hq, lqp)[:, :, :lq]
    return o, lse


def flash_sparse_dq_reference(q, k, v, dout, lse, delta, q_block_ids,
                              q_doc_ids, kv_block_ids, kv_doc_ids, tile_map,
                              counts, scale: float) -> torch.Tensor:
    """Plain version of the sparse dq kernel over the forward's tile list:
    p = exp(s - lse), ds = p (dp - delta), dq = scale ds K."""
    b, lq, hq, d = q.shape
    _, kg, vg, mask, s, lqp = _sparse_fwd_tiles(
        q, k, v, q_block_ids, q_doc_ids, kv_block_ids, kv_doc_ids, tile_map,
        counts, scale)
    n_q = tile_map.shape[1]
    tiles = lambda t: _pad_rows(t.transpose(1, 2), lqp).reshape(  # noqa: E731
        b, n_q, TILE, hq).permute(0, 1, 3, 2)[..., None]
    p = torch.where(mask, torch.exp(s - tiles(lse)), torch.zeros((), device=s.device))
    dot = _pad_rows(dout, lqp).reshape(b, n_q, TILE, hq, d).float()
    dp = torch.einsum("bnqhd,bnkhd->bnhqk", dot, vg)
    ds = p * (dp - tiles(delta))
    dq = torch.einsum("bnhqk,bnkhd->bnqhd", ds, kg) * scale
    return dq.reshape(b, lqp, hq, d)[:, :lq].to(q.dtype)


def flash_sparse_dkv_reference(q, k, v, dout, lse, delta, q_block_ids,
                               q_doc_ids, kv_block_ids, kv_doc_ids, q_map,
                               q_counts, block_q: int, scale: float):
    """Plain version of the sparse dk/dv kernel over the transposed list:
    each 64-key tile against exactly the q tiles (of ``block_q`` rows)
    q_map[b, j, :q_counts[b, j]]; dk = scale ds^T Q, dv = p^T dO, each
    summed over its GQA group."""
    b, lk, hkv, d = k.shape
    hq = q.shape[2]
    group = hq // hkv
    n_k = q_map.shape[1]
    lkp, lqp = n_k * TILE, -(-q.shape[1] // block_q) * block_q
    idx, valid = _gather_tiles(q_map, q_counts, block_q)
    qg = _take(_pad_rows(q, lqp), idx).float()               # [B, n_k, K, Hq, D]
    dog = _take(_pad_rows(dout, lqp), idx).float()
    qbg = _take(_pad_ids(q_block_ids, lqp, 0), idx)
    qdg = _take(_pad_ids(q_doc_ids, lqp, Q_PAD_DOC), idx)
    rows = lambda t: _take(_pad_rows(t.transpose(1, 2), lqp), idx).permute(  # noqa: E731
        0, 1, 3, 2)[..., None]                                # [B, n_k, Hq, K, 1]
    kt = _heads(_pad_rows(k, lkp).reshape(b, n_k, TILE, hkv, d).float(), group)
    vt = _heads(_pad_rows(v, lkp).reshape(b, n_k, TILE, hkv, d).float(), group)
    kbt = _pad_ids(kv_block_ids, lkp, 0).reshape(b, n_k, TILE)
    kdt = _pad_ids(kv_doc_ids, lkp, KV_PAD_DOC).reshape(b, n_k, TILE)
    mask = ((qdg[..., :, None] == kdt[..., None, :])
            & (kbt[..., None, :] <= qbg[..., :, None]) & valid[..., :, None])[:, :, None]
    s = torch.einsum("bnqhd,bnkhd->bnhqk", qg * scale, kt)
    p = torch.where(mask, torch.exp(s - rows(lse)), torch.zeros((), device=s.device))
    dp = torch.einsum("bnqhd,bnkhd->bnhqk", dog, vt)
    ds = p * (dp - rows(delta))
    dk = torch.einsum("bnhqk,bnqhd->bnkhd", ds, qg) * scale
    dv = torch.einsum("bnhqk,bnqhd->bnkhd", p, dog)
    fold = lambda t: t.reshape(b, n_k, TILE, hkv, group, d).sum(4).reshape(  # noqa: E731
        b, lkp, hkv, d)[:, :lk]
    return fold(dk).to(k.dtype), fold(dv).to(v.dtype)


# ---------------------------------------------------------------------------
# Sparse-iteration flash attention: kernel wrappers
# ---------------------------------------------------------------------------

def _check_plan(name: str, plan: SparsePlan, b: int, lq: int, lk: int):
    n_q, n_k = -(-lq // TILE), -(-lk // TILE)
    ok = (plan.kv_map.shape[:2] == (b, n_q) and plan.kv_counts.shape == (b, n_q)
          and plan.q_map.shape[:2] == (b, n_k) and plan.q_counts.shape == (b, n_k)
          and plan.block_q_dkv == TILE)
    if not ok or any(t.dtype != torch.int32 or not t.is_contiguous()
                     for t in plan[:4]):
        raise ValueError(f"{name}: the tile plan does not fit q [{b}, {lq}] "
                         f"k [{b}, {lk}]")


def flash_fwd_sparse(q, k, v, q_block_ids, q_doc_ids, kv_block_ids, kv_doc_ids,
                     plan: SparsePlan, scale: float):
    """(o, lse) of masked flash attention over plan's kv tile lists."""
    if q.device.type == "cpu":
        with torch.no_grad():
            return flash_sparse_reference(q, k, v, q_block_ids, q_doc_ids,
                                          kv_block_ids, kv_doc_ids, plan.kv_map,
                                          plan.kv_counts, scale, return_lse=True)
    _check("flash_fwd_sparse", q, k, v)
    b, lq, hq, d = q.shape
    lk, hkv = k.shape[1], k.shape[2]
    _check_plan("flash_fwd_sparse", plan, b, lq, lk)
    qb, qd = (_ids(t, b, lq, q.device) for t in (q_block_ids, q_doc_ids))
    kb, kd = (_ids(t, b, lk, q.device) for t in (kv_block_ids, kv_doc_ids))
    o = torch.empty_like(q)
    lse = torch.empty((b, hq, lq), dtype=torch.float32, device=q.device)
    _cuda.check(_cuda.load().bd_flash_fwd_sparse(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
        qb.data_ptr(), qd.data_ptr(), kb.data_ptr(), kd.data_ptr(),
        plan.kv_map.data_ptr(), plan.kv_counts.data_ptr(), plan.kv_map.shape[2],
        b, lq, lk, hq, hkv, d, float(scale), _cuda.stream_ptr()), "flash_fwd_sparse")
    flash_fwd_sparse.launches += 1
    return o, lse


def flash_bwd_dq_sparse(q, k, v, dout, lse, delta, q_block_ids, q_doc_ids,
                        kv_block_ids, kv_doc_ids, plan: SparsePlan,
                        scale: float) -> torch.Tensor:
    """dq over plan's kv tile lists (like q)."""
    if q.device.type == "cpu":
        return flash_sparse_dq_reference(q, k, v, dout, lse, delta, q_block_ids,
                                         q_doc_ids, kv_block_ids, kv_doc_ids,
                                         plan.kv_map, plan.kv_counts, scale)
    _check("flash_bwd_dq_sparse", q, k, v, dout)
    b, lq, hq, d = q.shape
    lk, hkv = k.shape[1], k.shape[2]
    _check_plan("flash_bwd_dq_sparse", plan, b, lq, lk)
    qb, qd = (_ids(t, b, lq, q.device) for t in (q_block_ids, q_doc_ids))
    kb, kd = (_ids(t, b, lk, q.device) for t in (kv_block_ids, kv_doc_ids))
    dq = torch.empty_like(q)
    _cuda.check(_cuda.load().bd_flash_bwd_dq_sparse(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
        lse.contiguous().data_ptr(), delta.contiguous().data_ptr(),
        dq.data_ptr(), qb.data_ptr(), qd.data_ptr(), kb.data_ptr(), kd.data_ptr(),
        plan.kv_map.data_ptr(), plan.kv_counts.data_ptr(), plan.kv_map.shape[2],
        b, lq, lk, hq, hkv, d, float(scale), _cuda.stream_ptr()),
        "flash_bwd_dq_sparse")
    flash_bwd_dq_sparse.launches += 1
    return dq


def flash_bwd_dkv_sparse(q, k, v, dout, lse, delta, q_block_ids, q_doc_ids,
                         kv_block_ids, kv_doc_ids, plan: SparsePlan,
                         scale: float):
    """(dk, dv) over plan's transposed lists, summed per GQA group."""
    if q.device.type == "cpu":
        return flash_sparse_dkv_reference(q, k, v, dout, lse, delta, q_block_ids,
                                          q_doc_ids, kv_block_ids, kv_doc_ids,
                                          plan.q_map, plan.q_counts,
                                          plan.block_q_dkv, scale)
    _check("flash_bwd_dkv_sparse", q, k, v, dout)
    b, lq, hq, d = q.shape
    lk, hkv = k.shape[1], k.shape[2]
    _check_plan("flash_bwd_dkv_sparse", plan, b, lq, lk)
    qb, qd = (_ids(t, b, lq, q.device) for t in (q_block_ids, q_doc_ids))
    kb, kd = (_ids(t, b, lk, q.device) for t in (kv_block_ids, kv_doc_ids))
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    _cuda.check(_cuda.load().bd_flash_bwd_dkv_sparse(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
        lse.contiguous().data_ptr(), delta.contiguous().data_ptr(),
        dk.data_ptr(), dv.data_ptr(), qb.data_ptr(), qd.data_ptr(),
        kb.data_ptr(), kd.data_ptr(), plan.q_map.data_ptr(),
        plan.q_counts.data_ptr(), plan.q_map.shape[2], b, lq, lk, hq, hkv, d,
        float(scale), _cuda.stream_ptr()), "flash_bwd_dkv_sparse")
    flash_bwd_dkv_sparse.launches += 1
    return dk, dv


flash_fwd_sparse.launches = 0
flash_bwd_dq_sparse.launches = 0
flash_bwd_dkv_sparse.launches = 0


class _FlashSparse(torch.autograd.Function):
    """Sparse-iteration core (the custom VJP of _flash_sparse_core,
    attention.py:783-1041): the forward saves lse and its int32 ids; the
    backward runs dq over the forward's lists and dk/dv over the transposed
    lists, on those ids (as the JAX code does; its docstring's "reuses the
    dense kernels" is stale)."""

    @staticmethod
    def forward(ctx, q, k, v, qb, qd, kb, kd, plan, scale):
        ids = _ids_once(q, k, qb, qd, kb, kd)
        o, lse = flash_fwd_sparse(q, k, v, *ids, plan, scale)
        ctx.save_for_backward(q, k, v, *ids, o, lse)
        ctx.plan, ctx.scale = plan, scale
        return o

    @staticmethod
    def backward(ctx, dout):
        q, k, v, qb, qd, kb, kd, o, lse = ctx.saved_tensors
        dout = dout.to(q.dtype).contiguous()
        delta = (dout.float() * o.float()).sum(dim=-1).transpose(1, 2).contiguous()
        dq = flash_bwd_dq_sparse(q, k, v, dout, lse, delta, qb, qd, kb, kd,
                                 ctx.plan, ctx.scale)
        dk, dv = flash_bwd_dkv_sparse(q, k, v, dout, lse, delta, qb, qd, kb, kd,
                                      ctx.plan, ctx.scale)
        return dq, dk, dv, None, None, None, None, None, None


def flash_attention_sparse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           q_block_ids: torch.Tensor, q_doc_ids: torch.Tensor,
                           kv_block_ids: torch.Tensor, kv_doc_ids: torch.Tensor,
                           max_live_kv: int | None = None,
                           scale: float | None = None,
                           plan: SparsePlan | None = None) -> torch.Tensor:
    """Differentiable splash-style flash attention (attention.py:669-717):
    only live kv tiles are visited. ``max_live_kv`` counts this port's
    64-key tiles (:func:`live_tile_bound` derives it from the longest
    document); a ``plan`` built once by :func:`sparse_plan` may be given
    instead. An undersized bound raises."""
    d = q.shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    ids = _ids_once(q, k, q_block_ids, q_doc_ids, kv_block_ids, kv_doc_ids)
    if plan is None:
        if max_live_kv is None:
            raise ValueError("flash_attention_sparse: give max_live_kv or a plan")
        plan = sparse_plan(*ids, max_live_kv)
    return _FlashSparse.apply(q.contiguous(), k.contiguous(), v.contiguous(), *ids,
                              plan, float(scale))



def masked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     q_block_ids: torch.Tensor, q_doc_ids: torch.Tensor,
                     kv_block_ids: torch.Tensor, kv_doc_ids: torch.Tensor,
                     scale: float | None = None,
                     implementation: str = "auto",
                     max_live_kv: int | None = None,
                     plan: SparsePlan | None = None) -> torch.Tensor:
    """Attention under the (block, doc) mask model; kernel or plain.

    "auto" follows the JAX package's rule (attention.py:1081-1096): the flash
    kernels on the accelerator when Lq * Lk > 256^2, otherwise the plain
    dense-mask ``attention_xla``. "kernel" forces the flash kernels (plain
    versions on CPU tensors), "plain" the dense path. On the kernel route a
    ``max_live_kv`` (64-key tiles) or a ``plan`` switches to
    :func:`flash_attention_sparse`.
    """
    if implementation == "auto":
        big = q.shape[1] * k.shape[1] > 256 * 256
        implementation = "kernel" if (q.device.type == "cuda" and big) else "plain"
    if implementation == "kernel":
        if max_live_kv is not None or plan is not None:
            return flash_attention_sparse(q, k, v, q_block_ids, q_doc_ids,
                                          kv_block_ids, kv_doc_ids, max_live_kv,
                                          scale, plan)
        return flash_attention(q, k, v, q_block_ids, q_doc_ids, kv_block_ids,
                               kv_doc_ids, scale)
    if implementation != "plain":
        raise ValueError(f"masked_attention: unknown implementation {implementation!r}")
    mask = mask_from_ids(q_block_ids, q_doc_ids, kv_block_ids, kv_doc_ids)
    return attention_xla(q, k, v, mask[:, None], scale=scale)
