"""Decode attention: a query block against a long head-major KV cache.

Port of bitdance_tpu/ops/decode_attention.py: ``decode_attention_pallas`` and
``windowed_decode_attention`` over separate bf16 k/v caches, and the fused
ring buffer [B, Hkv, L, 2D] (k in lanes [:D], v in [D:]) in bf16 or int8
with per-(head, position) f32 scales [B, Hkv, 2, L]: ``pack_kv_rows``,
``quantize_kv_rows``, ``dequantize_fused_kv``, ``decode_attention_fusedkv``
and ``windowed_decode_attention_fusedkv``. Both kernels are
``csrc/decode_attention.cu``; :func:`decode_attention_reference` and
:func:`decode_attention_fusedkv_reference` are their plain PyTorch versions,
which CPU tensors take. A CUDA tensor always takes the kernel (the JAX
package's ``max_len >= 1024`` and backend routing is a TPU choice and is not
carried over).
"""

from __future__ import annotations

import math

import torch

from bitdance_tpu_torch.ops import _cuda
from bitdance_tpu_torch.ops.int8 import true_div

NEG_INF = -1e30


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
                     scale: float | None = None) -> torch.Tensor:
    """Flash decode over the valid window of each row; dispatch by device.

    CPU tensors take :func:`decode_attention_reference`; CUDA tensors launch
    the kernel (bf16, head dim 128, contiguous) or raise.
    """
    if q.device.type == "cpu":
        return decode_attention_reference(q, k_cache, v_cache, kv_len,
                                          kv_start, scale)
    if q.device.type != "cuda":
        raise RuntimeError(f"decode_attention: no kernel for {q.device}")
    _cuda.refuse_grad("decode_attention", q, k_cache, v_cache)
    b, s, hq, d = q.shape
    _, hkv, max_len, _ = k_cache.shape
    if kv_start is None:
        kv_start = torch.zeros((b,), dtype=torch.int32, device=q.device)
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache)):
        if t.dtype != torch.bfloat16 or not t.is_contiguous() or t.device != q.device:
            raise ValueError(f"decode_attention: {name} must be contiguous bf16 "
                             f"on {q.device}, got {t.dtype} {tuple(t.shape)}")
    if k_cache.shape != v_cache.shape or k_cache.shape[0] != b or \
            k_cache.shape[3] != d or d != 128 or hq % hkv:
        raise ValueError("decode_attention: kernel takes head dim 128 and "
                         f"matching caches, got q {tuple(q.shape)} "
                         f"k {tuple(k_cache.shape)} v {tuple(v_cache.shape)}")
    kv_len = kv_len.to(device=q.device, dtype=torch.int32).contiguous()
    kv_start = kv_start.to(device=q.device, dtype=torch.int32).contiguous()
    if kv_len.shape != (b,) or kv_start.shape != (b,):
        raise ValueError(f"decode_attention: kv_len/kv_start must be [{b}]")
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    out = torch.empty_like(q)
    lib = _cuda.load()
    _cuda.check(lib.bd_decode_attention(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), out.data_ptr(),
        kv_len.data_ptr(), kv_start.data_ptr(), b, s, hq, hkv, max_len, d,
        float(scale), _cuda.stream_ptr()), "decode_attention")
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
                             scale: float | None = None) -> torch.Tensor:
    """Flash decode over the valid window of a fused bf16 or int8 buffer;
    dispatch by device.

    CPU tensors take :func:`decode_attention_fusedkv_reference`; CUDA
    tensors launch the kernel (bf16 q, head dim 128, contiguous buffers) or
    raise."""
    if q.device.type == "cpu":
        return decode_attention_fusedkv_reference(q, kv_cache, kv_len, kv_start,
                                                  kv_scales, scale)
    if q.device.type != "cuda":
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
    if kv_start is None:
        kv_start = torch.zeros((b,), dtype=torch.int32, device=q.device)
    kv_len = kv_len.to(device=q.device, dtype=torch.int32).contiguous()
    kv_start = kv_start.to(device=q.device, dtype=torch.int32).contiguous()
    if kv_len.shape != (b,) or kv_start.shape != (b,):
        raise ValueError(f"decode_attention_fusedkv: kv_len/kv_start must be [{b}]")
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    out = torch.empty_like(q)
    lib = _cuda.load()
    _cuda.check(lib.bd_decode_attention_fusedkv(
        q.data_ptr(), kv_cache.data_ptr(),
        kv_scales.data_ptr() if quant else None, out.data_ptr(),
        kv_len.data_ptr(), kv_start.data_ptr(), b, s, hq, hkv, max_len, d,
        float(scale), _cuda.stream_ptr()), "decode_attention_fusedkv")
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
