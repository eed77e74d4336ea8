"""Decode attention: a query block against a long head-major KV cache.

Port of bitdance_tpu/ops/decode_attention.py: ``decode_attention_pallas`` and
``windowed_decode_attention`` over separate bf16 k/v caches, and the fused
ring buffer [B, Hkv, L, 2D] (k in lanes [:D], v in [D:]) in bf16 or int8
with per-(head, position) f32 scales [B, Hkv, 2, L]: ``pack_kv_rows``,
``quantize_kv_rows``, ``dequantize_fused_kv``, ``decode_attention_fusedkv``
and ``windowed_decode_attention_fusedkv``. Both kernels are
``csrc/decode_attention.cu``, a split-KV design: the cache length is cut
into ``n_splits`` shares of whole 64-key tiles (:func:`decode_splits`
picks the count), each block writes fp32 partials to scratch, and a second
launch merges them in fixed order. :func:`decode_attention_reference` and
:func:`decode_attention_fusedkv_reference` are their dense plain PyTorch
versions, which CPU tensors take; :func:`decode_attention_split_plain` is a
plain twin of the kernels' partition and merge, for tests. A CUDA tensor
always takes the kernel (the JAX package's ``max_len >= 1024`` and backend
routing is a TPU choice and is not carried over).
"""

from __future__ import annotations

import ctypes
import math
from fractions import Fraction

import torch

from bitdance_tpu_torch.ops import _cuda
from bitdance_tpu_torch.ops.int8 import true_div

NEG_INF = -1e30
KV_TILE = 64          # keys per tile of the kernels; splits hold whole tiles
Q_TILE = 64           # q rows per block of the kernels (GQA folded into rows)
BLOCK_COST_TILES = 2  # a block's fixed cost in tiles' time (decode_splits)


def decode_splits(b: int, hkv: int, rows: int, max_len: int, sm_count: int,
                  blocks_per_sm: int) -> int:
    """How many splits of the cache length the kernels take.

    The grid has ``base = b * hkv * ceil(rows / 64)`` blocks per split (rows
    = the q heads of one kv head times S), run in waves of ``slots =
    blocks_per_sm * sm_count`` resident blocks. With n splits a block walks
    tiles / n of the cache's 64-key tiles after a fixed cost of about
    BLOCK_COST_TILES tiles (its q tile, the ring's fill, the partials'
    write), so a call takes about ceil(base * n / slots) * (tiles / n +
    BLOCK_COST_TILES): the count is the n in [1, tiles] that minimises it,
    the fewest splits on a tie. A second wave can pay: on the H100 (264
    slots) B 4 at 4226 keys took 0.091 ms at 1 split (160 blocks, one wave)
    and 0.074 ms at 3 (480 blocks, two), where B 2 is fastest at 3 (240
    blocks, one wave; 4 splits, 320 blocks, take 1.26x as long).
    """
    base = b * hkv * -(-rows // Q_TILE)
    tiles = -(-max_len // KV_TILE)
    slots = blocks_per_sm * sm_count

    def cost(n: int) -> Fraction:
        return Fraction(-(-base * n // slots) * (tiles + BLOCK_COST_TILES * n), n)

    return min(range(1, tiles + 1), key=lambda n: (cost(n), n))


def split_tile_ranges(kv_start: int, kv_len: int, max_len: int,
                      n_splits: int) -> list[tuple[int, int]]:
    """The key range [a, b) of each split for one row, as the kernel cuts it:
    the 64-key tiles that hold the window [kv_start, kv_len) shared out
    equally (split i takes tiles [i * n // n_splits, (i + 1) * n //
    n_splits) of the n live ones), clipped to the window."""
    start, end = max(kv_start, 0), min(kv_len, max_len)
    t0 = start // KV_TILE
    n = -(-end // KV_TILE) - t0 if end > start else 0
    out = []
    for i in range(n_splits):
        ta, tb = t0 + i * n // n_splits, t0 + (i + 1) * n // n_splits
        out.append((max(ta * KV_TILE, start), min(tb * KV_TILE, end))
                   if tb > ta else (start, start))
    return out


def split_partials(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   kv_len: torch.Tensor, kv_start: torch.Tensor, n_splits: int,
                   k_scale: torch.Tensor | None = None,
                   v_scale: torch.Tensor | None = None,
                   scale: float | None = None):
    """Per-split fp32 partials of the kernels, densely: o (unnormalised),
    m (the split's max score, NEG_INF if it holds no key) and l (the sum of
    the unscaled p), each [n_splits, B, S, Hq(, D)].

    q [B, S, Hq, D]; k, v [B, Hkv, L, D] of any dtype (the halves of a fused
    buffer too); k_scale, v_scale [B, Hkv, L] per key (an int8 buffer's two
    scale rows) or None."""
    b, s, hq, d = q.shape
    hkv, max_len = k.shape[1], k.shape[2]
    group = hq // hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    qf = (q.float() * scale).reshape(b, s, hkv, group, d)
    sc = torch.einsum("bsjgd,bjld->bjgsl", qf, k.float())
    if k_scale is not None:
        sc = sc * k_scale.float()[:, :, None, None, :]
    pos = torch.arange(max_len, device=q.device)
    o = torch.zeros((n_splits, b, s, hq, d), device=q.device)
    m = torch.full((n_splits, b, s, hq), NEG_INF, device=q.device)
    l = torch.zeros((n_splits, b, s, hq), device=q.device)
    vf = v.float()
    for row in range(b):
        ranges = split_tile_ranges(int(kv_start[row]), int(kv_len[row]), max_len,
                                   n_splits)
        for i, (lo, hi) in enumerate(ranges):
            if hi <= lo:
                continue
            live = (pos >= lo) & (pos < hi)
            x = torch.where(live, sc[row], torch.full((), NEG_INF, device=q.device))
            mi = x.amax(dim=-1, keepdim=True)                     # [j, g, s, 1]
            p = torch.where(live, torch.exp(x - mi), torch.zeros((), device=q.device))
            li = p.sum(dim=-1)
            if v_scale is not None:
                p = p * v_scale.float()[row][:, None, None, :]
            oi = torch.einsum("jgsl,jld->sjgd", p, vf[row])
            o[i, row] = oi.reshape(s, hq, d)
            m[i, row] = mi[..., 0].permute(2, 0, 1).reshape(s, hq)
            l[i, row] = li.permute(2, 0, 1).reshape(s, hq)
    return o, m, l


def merge_partials(o: torch.Tensor, m: torch.Tensor, l: torch.Tensor) -> torch.Tensor:
    """The kernels' merge, in split order: m = max m_i, w_i = exp(m_i - m),
    o = sum w_i o_i / sum w_i l_i, and 0 where that sum is 0."""
    mx = m.amax(dim=0)
    acc = torch.zeros_like(o[0])
    tot = torch.zeros_like(l[0])
    for i in range(o.shape[0]):
        w = torch.exp(m[i] - mx)
        tot = tot + w * l[i]
        acc = acc + w[..., None] * o[i]
    safe = torch.where(tot > 0, tot, torch.ones_like(tot))
    return torch.where(tot[..., None] > 0, acc / safe[..., None],
                       torch.zeros((), device=o.device))


def decode_attention_split_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                 kv_len: torch.Tensor,
                                 kv_start: torch.Tensor | None = None,
                                 n_splits: int = 1,
                                 k_scale: torch.Tensor | None = None,
                                 v_scale: torch.Tensor | None = None,
                                 scale: float | None = None) -> torch.Tensor:
    """Plain twin of the kernels' split and merge (fp32, not rounded), for
    tests: :func:`split_partials` then :func:`merge_partials`, in q's dtype.
    Arguments as :func:`split_partials`."""
    if kv_start is None:
        kv_start = torch.zeros((q.shape[0],), dtype=torch.int32)
    parts = split_partials(q, k, v, kv_len, kv_start, n_splits, k_scale, v_scale,
                           scale)
    return merge_partials(*parts).to(q.dtype)


class DecodeShape(ctypes.Structure):
    """The shapes and options of one kernel call, as the C entries take
    them (``DecodeShape`` in csrc/decode_attention.cu)."""
    _fields_ = [("B", ctypes.c_int), ("S", ctypes.c_int), ("Hq", ctypes.c_int),
                ("Hkv", ctypes.c_int), ("L", ctypes.c_int), ("D", ctypes.c_int),
                ("n_splits", ctypes.c_int), ("scale", ctypes.c_float)]


_PLANS: dict = {}


def _plan(name: str, q: torch.Tensor, hkv: int, max_len: int, quant: bool,
          scale: float | None, n_splits: int | None) -> tuple:
    """(DecodeShape, its address, the scratch's f32 count) of a call, checked
    and built once per shape: a decode step's call is host-bound at short
    windows, so what depends on shapes alone is not redone every call."""
    key = (q.shape, hkv, max_len, quant, q.device.index, scale, n_splits)
    plan = _PLANS.get(key)
    if plan is None:
        b, s, hq, d = q.shape
        tiles = -(-max_len // KV_TILE)
        if n_splits is None:
            n_splits = kernel_splits(q.shape, hkv, max_len, q.device, quant)
        if not 1 <= n_splits <= tiles:
            raise ValueError(f"{name}: n_splits must be in [1, {tiles}], got {n_splits}")
        shape = DecodeShape(b, s, hq, hkv, max_len, d, n_splits,
                            scale if scale is not None else 1.0 / math.sqrt(d))
        plan = _PLANS[key] = (shape, ctypes.addressof(shape),
                              n_splits * b * hq * s * (d + 2))
    return plan


def _launch(name: str, fn, ptrs: tuple, q: torch.Tensor, quant: bool,
            kv_len: torch.Tensor, kv_start: torch.Tensor | None, hkv: int,
            max_len: int, scale: float | None, n_splits: int | None) -> torch.Tensor:
    """Checks shared by both wrappers, the scratch and the launch of the C
    entry ``fn`` (its leading pointers ``ptrs``: q and the cache)."""
    b = q.shape[0]
    dev = q.device
    if kv_start is None:
        kv_start = torch.zeros((b,), dtype=torch.int32, device=dev)
    kv_len, kv_start = _as_index(kv_len, dev), _as_index(kv_start, dev)
    if kv_len.shape != (b,) or kv_start.shape != (b,):
        raise ValueError(f"{name}: kv_len/kv_start must be [{b}]")
    _, shape_ptr, numel = _plan(name, q, hkv, max_len, quant, scale, n_splits)
    out = torch.empty_like(q)
    stream = _cuda.stream_ptr()
    _cuda.check(fn(*ptrs, out.data_ptr(), _scratch(numel, dev, stream).data_ptr(),
                   kv_len.data_ptr(), kv_start.data_ptr(), shape_ptr, stream), name)
    return out


def _as_index(t: torch.Tensor, dev: torch.device) -> torch.Tensor:
    """kv_len / kv_start as contiguous int32 on ``dev`` (no copy when they
    already are, as the model's are)."""
    if t.dtype != torch.int32 or t.device != dev:
        t = t.to(device=dev, dtype=torch.int32)
    return t if t.is_contiguous() else t.contiguous()


_SCRATCH: dict = {}


def _scratch(numel: int, dev: torch.device, stream: int) -> torch.Tensor:
    """The fp32 partials' scratch: one buffer per (device, stream), grown
    when a call needs more. A call's partials are written by its first
    launch and read by its second, in stream order, so later calls on the
    same stream may reuse the buffer (an allocation a call cost host time
    on every decode step). Under CUDA graph capture each call allocates
    its own: a graph keeps the address it captured, which a grown (freed)
    cached buffer would not keep."""
    if torch.cuda.is_current_stream_capturing():
        return torch.empty((numel,), dtype=torch.float32, device=dev)
    key = (dev.index, stream)
    buf = _SCRATCH.get(key)
    if buf is None or buf.numel() < numel:
        buf = _SCRATCH[key] = torch.empty((numel,), dtype=torch.float32, device=dev)
    return buf


_CARD: dict = {}


def kernel_splits(q_shape, hkv: int, max_len: int, device: torch.device,
                  quant: bool) -> int:
    """The split count a wrapper launches for q [B, S, Hq, D] against a
    cache of ``max_len`` on this card (``quant``: an int8 buffer)."""
    b, s, hq, _ = q_shape
    return decode_splits(b, hkv, (hq // hkv) * s, max_len, *_card(device, quant))


def _card(device: torch.device, quant: bool) -> tuple[int, int]:
    """(SMs, resident blocks of the kernel per SM) of this card, once."""
    key = (device.index, quant)        # a tensor's CUDA device has its index
    if key not in _CARD:
        with torch.cuda.device(device):
            per_sm = _cuda.load().bd_decode_blocks_per_sm(int(quant))
        if per_sm < 1:
            raise RuntimeError(f"bd_decode_blocks_per_sm: CUDA error {-per_sm}")
        _CARD[key] = (torch.cuda.get_device_properties(device).multi_processor_count,
                      per_sm)
    return _CARD[key]


def decode_attention_reference(q: torch.Tensor, k_cache: torch.Tensor,
                               v_cache: torch.Tensor, kv_len: torch.Tensor,
                               kv_start: torch.Tensor | None = None,
                               scale: float | None = None) -> torch.Tensor:
    """Dense fp32 version of the kernel.

    q: [B, S, Hq, D]; k/v_cache: [B, Hkv, L, D] head-major; kv_len/kv_start:
    [B] int. Each row attends [kv_start, kv_len); an empty window gives 0.
    """
    b, s, hq, d = q.shape
    hkv, max_len = k_cache.shape[1], k_cache.shape[2]
    group = hq // hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    if kv_start is None:
        kv_start = torch.zeros((b,), dtype=torch.int32, device=q.device)
    qf = (q.float() * scale).reshape(b, s, hkv, group, d)
    sc = torch.einsum("bsjgd,bjld->bjgsl", qf, k_cache.float())
    pos = torch.arange(max_len, device=q.device)
    mask = (pos[None, :] >= kv_start[:, None]) & (pos[None, :] < kv_len[:, None])
    mask = mask[:, None, None, None, :]
    sc = torch.where(mask, sc, torch.full((), NEG_INF, device=q.device))
    m = sc.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(sc - m), torch.zeros((), device=q.device))
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bjgsl,bjld->bsjgd", p, v_cache.float())
    l = l.permute(0, 3, 1, 2, 4)                       # [b, s, hkv, g, 1]
    o = torch.where(l > 0, o / torch.where(l > 0, l, torch.ones_like(l)),
                    torch.zeros((), device=q.device))
    return o.reshape(b, s, hq, d).to(q.dtype)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, kv_len: torch.Tensor,
                     kv_start: torch.Tensor | None = None,
                     scale: float | None = None,
                     n_splits: int | None = None) -> torch.Tensor:
    """Flash decode over the valid window of each row; dispatch by device.

    CPU tensors take :func:`decode_attention_reference`; CUDA tensors launch
    the kernel (bf16, head dim 128, contiguous, 16-byte aligned) or raise.
    ``n_splits`` (1 to the 64-key tiles of the cache) overrides
    :func:`decode_splits` on the card; the CPU path has no splits.
    """
    if q.is_cpu:
        return decode_attention_reference(q, k_cache, v_cache, kv_len,
                                          kv_start, scale)
    if not q.is_cuda:
        raise RuntimeError(f"decode_attention: no kernel for {q.device}")
    _cuda.refuse_grad("decode_attention", q, k_cache, v_cache)
    b, s, hq, d = q.shape
    _, hkv, max_len, _ = k_cache.shape
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache)):
        if t.dtype != torch.bfloat16 or not t.is_contiguous() or t.device != q.device:
            raise ValueError(f"decode_attention: {name} must be contiguous bf16 "
                             f"on {q.device}, got {t.dtype} {tuple(t.shape)}")
    if k_cache.shape != v_cache.shape or k_cache.shape[0] != b or \
            k_cache.shape[3] != d or d != 128 or hq % hkv:
        raise ValueError("decode_attention: kernel takes head dim 128 and "
                         f"matching caches, got q {tuple(q.shape)} "
                         f"k {tuple(k_cache.shape)} v {tuple(v_cache.shape)}")
    ptrs = (q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr())
    if (ptrs[0] | ptrs[1] | ptrs[2]) % 16:
        raise ValueError("decode_attention: the kernel's 16-byte copies need "
                         "16-byte aligned q and caches")
    out = _launch("decode_attention", _cuda.load().bd_decode_attention, ptrs, q, False,
                  kv_len, kv_start, hkv, max_len, scale, n_splits)
    decode_attention.launches += 1
    return out


decode_attention.launches = 0


def windowed_decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                              v_cache: torch.Tensor, kv_len: torch.Tensor,
                              kv_start: torch.Tensor | None = None
                              ) -> torch.Tensor:
    """Decode-block attention over [kv_start, kv_len) of a head-major cache."""
    return decode_attention(q, k_cache, v_cache, kv_len, kv_start)


def pack_kv_rows(k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """[B, S, H, D] x2 -> fused [B, H, S, 2D] (k in lanes [:D], v in [D:])."""
    return torch.cat([k, v], dim=-1).transpose(1, 2)


def quantize_kv_rows(k: torch.Tensor, v: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """[B, S, H, D] x2 -> (int8 fused [B, H, S, 2D], f32 scales [B, H, 2, S]).

    Symmetric per-(head, position) scales max(amax, 1e-8) / 127 (the KV
    floor is 1e-8, not the weights' 1e-12); k at scale row 0, v at row 1."""
    def q(x):
        xf = x.float()
        s = true_div(torch.clamp_min(xf.abs().amax(dim=-1), 1e-8), 127.0)
        return torch.clamp(torch.round(xf / s[..., None]), -127, 127).to(torch.int8), s

    kq, ks = q(k)
    vq, vs = q(v)
    fused = torch.cat([kq, vq], dim=-1).transpose(1, 2)
    scales = torch.stack([ks, vs], dim=3)                  # [B, S, H, 2]
    return fused, scales.permute(0, 2, 3, 1)               # [B, H, 2, S]


def dequantize_fused_kv(kv_cache: torch.Tensor,
                        kv_scales: torch.Tensor | None):
    """Split a fused buffer back to (k, v) [B, Hkv, L, D]; f32 when int8."""
    d = kv_cache.shape[-1] // 2
    k, v = kv_cache[..., :d], kv_cache[..., d:]
    if kv_scales is None:
        return k, v
    return (k.float() * kv_scales[:, :, 0, :, None],
            v.float() * kv_scales[:, :, 1, :, None])


def decode_attention_fusedkv_reference(
        q: torch.Tensor, kv_cache: torch.Tensor, kv_len: torch.Tensor,
        kv_start: torch.Tensor | None = None,
        kv_scales: torch.Tensor | None = None,
        scale: float | None = None) -> torch.Tensor:
    """Dense fp32 version of the fused-buffer kernel.

    q [B, S, Hq, D]; kv_cache [B, Hkv, L, 2D] bf16 or int8 (then kv_scales
    [B, Hkv, 2, L] f32). The scores take the k scale per key, p the v scale
    per key before the PV product, and the normaliser sums the UNSCALED p
    (the TPU kernel's l); an empty window gives 0."""
    b, s, hq, d = q.shape
    hkv, max_len = kv_cache.shape[1], kv_cache.shape[2]
    group = hq // hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    if kv_start is None:
        kv_start = torch.zeros((b,), dtype=torch.int32, device=q.device)
    kv = kv_cache.float()
    qf = (q.float() * scale).reshape(b, s, hkv, group, d)
    sc = torch.einsum("bsjgd,bjld->bjgsl", qf, kv[..., :d])
    if kv_scales is not None:
        sc = sc * kv_scales[:, :, None, None, 0, :]
    pos = torch.arange(max_len, device=q.device)
    mask = (pos[None, :] >= kv_start[:, None]) & (pos[None, :] < kv_len[:, None])
    mask = mask[:, None, None, None, :]
    sc = torch.where(mask, sc, torch.full((), NEG_INF, device=q.device))
    m = sc.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(sc - m), torch.zeros((), device=q.device))
    l = p.sum(dim=-1, keepdim=True)
    if kv_scales is not None:
        p = p * kv_scales[:, :, None, None, 1, :]
    o = torch.einsum("bjgsl,bjld->bsjgd", p, kv[..., d:])
    l = l.permute(0, 3, 1, 2, 4)                       # [b, s, hkv, g, 1]
    o = torch.where(l > 0, o / torch.where(l > 0, l, torch.ones_like(l)),
                    torch.zeros((), device=q.device))
    return o.reshape(b, s, hq, d).to(q.dtype)


def decode_attention_fusedkv(q: torch.Tensor, kv_cache: torch.Tensor,
                             kv_len: torch.Tensor,
                             kv_start: torch.Tensor | None = None,
                             kv_scales: torch.Tensor | None = None,
                             scale: float | None = None,
                             n_splits: int | None = None) -> torch.Tensor:
    """Flash decode over the valid window of a fused bf16 or int8 buffer;
    dispatch by device.

    CPU tensors take :func:`decode_attention_fusedkv_reference`; CUDA
    tensors launch the kernel (bf16 q, head dim 128, contiguous 16-byte
    aligned buffers) or raise. ``n_splits`` as for :func:`decode_attention`."""
    if q.is_cpu:
        return decode_attention_fusedkv_reference(q, kv_cache, kv_len, kv_start,
                                                  kv_scales, scale)
    if not q.is_cuda:
        raise RuntimeError(f"decode_attention_fusedkv: no kernel for {q.device}")
    _cuda.refuse_grad("decode_attention_fusedkv", q, kv_cache)
    b, s, hq, d = q.shape
    _, hkv, max_len, d2 = kv_cache.shape
    quant = kv_scales is not None
    want = torch.int8 if quant else torch.bfloat16
    if q.dtype != torch.bfloat16 or kv_cache.dtype != want or \
            not q.is_contiguous() or not kv_cache.is_contiguous() or \
            kv_cache.device != q.device:
        raise ValueError("decode_attention_fusedkv: contiguous bf16 q and a "
                         f"contiguous {want} buffer on {q.device}, got "
                         f"{q.dtype} {kv_cache.dtype}")
    if d != 128 or d2 != 2 * d or kv_cache.shape[0] != b or hq % hkv:
        raise ValueError("decode_attention_fusedkv: kernel takes head dim 128, "
                         f"got q {tuple(q.shape)} kv {tuple(kv_cache.shape)}")
    if quant and (kv_scales.dtype != torch.float32 or not kv_scales.is_contiguous()
                  or tuple(kv_scales.shape) != (b, hkv, 2, max_len)
                  or kv_scales.device != q.device):
        raise ValueError("decode_attention_fusedkv: kv_scales must be contiguous "
                         f"f32 [{b}, {hkv}, 2, {max_len}]")
    ptrs = (q.data_ptr(), kv_cache.data_ptr(), kv_scales.data_ptr() if quant else None)
    if (ptrs[0] | ptrs[1]) % 16:
        raise ValueError("decode_attention_fusedkv: the kernel's 16-byte copies "
                         "need a 16-byte aligned q and buffer")
    out = _launch("decode_attention_fusedkv", _cuda.load().bd_decode_attention_fusedkv,
                  ptrs, q, quant, kv_len, kv_start, hkv, max_len, scale, n_splits)
    decode_attention_fusedkv.launches += 1
    return out


decode_attention_fusedkv.launches = 0


def windowed_decode_attention_fusedkv(q: torch.Tensor, kv_cache: torch.Tensor,
                                      kv_len: torch.Tensor,
                                      kv_start: torch.Tensor | None = None,
                                      kv_scales: torch.Tensor | None = None
                                      ) -> torch.Tensor:
    """Decode-block attention over [kv_start, kv_len) of a fused buffer."""
    return decode_attention_fusedkv(q, kv_cache, kv_len, kv_start, kv_scales)
