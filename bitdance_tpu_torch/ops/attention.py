"""Attention under the (block_id, doc_id) mask model (port of
bitdance_tpu/ops/attention.py: mask_from_ids, attention_xla, flash_attention
with its custom VJP, masked_attention).

Every token carries two int32 ids and query i sees key j iff
``doc_q[i] == doc_k[j]`` and ``block_k[j] <= block_q[i]`` (causal: block =
position; a parallel window shares one block id; packed samples differ in
doc id). The flash path is ``csrc/flash_attention.cu``: one forward kernel
that returns o and the per-row log-sum-exp, and two backward kernels (dq;
dk/dv summed over each GQA group). :func:`flash_attention_reference` is the
plain differentiable version (and the forward kernel's plain version);
``flash_bwd_dq_reference`` and ``flash_bwd_dkv_reference`` are the backward
kernels'. The three wrappers take their plain versions only for CPU
tensors; on a CUDA tensor they launch their kernel or raise.
"""

from __future__ import annotations

import math

import torch

from bitdance_tpu_torch.ops import _cuda

NEG_INF = -1e30
MASKED_LSE = 1e30   # lse of a row that sees no key: exp(s - lse) == 0


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
    return t.to(device=device, dtype=torch.int32).expand(b, n).contiguous()


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
    """Forward saves lse; backward takes delta = sum(do * o) as a plain
    reduction, then the dq and dk/dv kernels (the custom VJP of
    _flash_core, attention.py:508-541)."""

    @staticmethod
    def forward(ctx, q, k, v, qb, qd, kb, kd, scale):
        o, lse = flash_fwd(q, k, v, qb, qd, kb, kd, scale)
        ctx.save_for_backward(q, k, v, qb, qd, kb, kd, o, lse)
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


def masked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     q_block_ids: torch.Tensor, q_doc_ids: torch.Tensor,
                     kv_block_ids: torch.Tensor, kv_doc_ids: torch.Tensor,
                     scale: float | None = None,
                     implementation: str = "auto") -> torch.Tensor:
    """Attention under the (block, doc) mask model; kernel or plain.

    "auto" follows the JAX package's rule (attention.py:1081-1096): the flash
    kernels on the accelerator when Lq * Lk > 256^2, otherwise the plain
    dense-mask ``attention_xla``. "kernel" forces :func:`flash_attention`
    (plain versions on CPU tensors), "plain" the dense path.
    """
    if implementation == "auto":
        big = q.shape[1] * k.shape[1] > 256 * 256
        implementation = "kernel" if (q.device.type == "cuda" and big) else "plain"
    if implementation == "kernel":
        return flash_attention(q, k, v, q_block_ids, q_doc_ids, kv_block_ids,
                               kv_doc_ids, scale)
    if implementation != "plain":
        raise ValueError(f"masked_attention: unknown implementation {implementation!r}")
    mask = mask_from_ids(q_block_ids, q_doc_ids, kv_block_ids, kv_doc_ids)
    return attention_xla(q, k, v, mask[:, None], scale=scale)
