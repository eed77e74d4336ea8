"""One adaLN block of the diffusion head per call (port of
bitdance_tpu/ops/fused_block.py).

  :func:`fused_mlp_block`:  h = LN(x) * (1 + scale) + shift;
      [h1 | h2] = h @ w1.T + b1; out = x + (silu(h1) * h2 @ w2.T + b2) * gate
      (a whole MlpResBlock, or the SwiGLU half of a TransBlock)
  :func:`fused_attn_block`: h = LN(x) * (1 + scale) + shift per group of W
      window tokens; qkv = h @ wqkv.T + bqkv, columns (3, n_head, hd);
      o = softmax(q k^T / sqrt(hd)) v per head; out = x + (o @ wo.T + bo) * gate
      (the attention half of a TransBlock)

Weights keep the torch Linear layout [out, in] (the JAX package stores
[in, out]). Beside each wrapper is its plain version (``*_reference``), with
the TPU kernel's precision: two-pass fp32 LayerNorm statistics, product
operands in the weights' dtype with fp32 accumulation, h12 and qkv kept in
fp32, fp32 softmax, and the output rounded once to x's dtype.

CPU tensors take the plain version; CUDA tensors run ``csrc/fused_block.cu``
(bf16 everywhere) or raise. Both kernels are inference-only: like the JAX
package, which gives them no VJP, the CUDA branch refuses autograd.

Both blocks run their products on the head GEMM (``csrc/head_gemm.cuh``)
by :func:`mlp_block_plans` and :func:`attn_block_plans`, which refuse a
shape that GEMM cannot take (C % 128, H % 64); the ``*_reference(splits=...)``
versions sum each product over the same K splits (the head GEMM's split
twin, :func:`~bitdance_tpu_torch.ops.fused_head.head_gemm_split_plain`). The
attention block's window attention on the card takes head dims 64 and 128
and windows of up to 64 rows.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from bitdance_tpu_torch.ops import _cuda
from bitdance_tpu_torch.ops.fused_head import HeadGemmPlan, _dot_acc_split, head_gemm_plan


def _ln_modulate(x: torch.Tensor, scale, shift, ln_w, ln_b,
                 eps: float) -> torch.Tensor:
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    ln = (xf - mean) * torch.rsqrt(var + eps) * ln_w.float() + ln_b.float()
    return ln * (1.0 + scale.float()) + shift.float()


def _mm(a: torch.Tensor, w: torch.Tensor, splits: int = 1) -> torch.Tensor:
    """a @ w.T with a rounded to w's dtype and an fp32 product, its K
    summed in ``splits`` partials as the head GEMM splits it."""
    out = _dot_acc_split(a.reshape(-1, a.shape[-1]), w, splits)
    return out.reshape(*a.shape[:-1], w.shape[0])


def fused_mlp_block_reference(x, scale, shift, gate, ln_w, ln_b, w1, b1, w2,
                              b2, eps: float = 1e-6,
                              splits: dict | None = None) -> torch.Tensor:
    """Plain PyTorch version of :func:`fused_mlp_block`. splits ({"w1": S,
    "w2": S}, e.g. the splits of :func:`mlp_block_plans`) sums each product
    over the head GEMM's K splits (None: one pass)."""
    sp = splits or {}
    h = _ln_modulate(x, scale, shift, ln_w, ln_b, eps)
    h12 = _mm(h, w1, sp.get("w1", 1)) + b1.float()
    hidden = h12.shape[-1] // 2
    glu = F.silu(h12[..., :hidden]) * h12[..., hidden:]
    out = _mm(glu, w2, sp.get("w2", 1)) + b2.float()
    return (x.float() + out * gate.float()).to(x.dtype)


def fused_attn_block_reference(x, scale, shift, gate, ln_w, ln_b, wqkv, bqkv,
                               wo, bo, n_head: int, eps: float = 1e-6,
                               splits: dict | None = None) -> torch.Tensor:
    """Plain PyTorch version of :func:`fused_attn_block`. splits ({"qkv": S,
    "wo": S}, e.g. the splits of :func:`attn_block_plans`) sums each product
    over the head GEMM's K splits (None: one pass)."""
    sp = splits or {}
    g, w, c = x.shape
    hd = c // n_head
    h = _ln_modulate(x, scale, shift, ln_w, ln_b, eps)
    qkv = (_mm(h, wqkv, sp.get("qkv", 1)) + bqkv.float()).reshape(g, w, 3, n_head, hd)
    q = qkv[:, :, 0] * hd ** -0.5
    s = torch.einsum("gqhd,gkhd->ghqk", q, qkv[:, :, 1])
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("ghqk,gkhd->gqhd", p, qkv[:, :, 2]).reshape(g, w, c)
    proj = _mm(o, wo, sp.get("wo", 1)) + bo.float()
    return (x.float() + proj * gate.float()).to(x.dtype)


def _mod_rows(name: str, m: torch.Tensor, shape, rows: int) -> torch.Tensor:
    """A mod as [rows, C] bf16 with unit column stride and one row stride
    (a slice of the adaLN output, or stride 0 for one broadcast row)."""
    if tuple(m.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(m.shape)} != {tuple(shape)}")
    if m.dim() != 2:
        m = m.reshape(rows, shape[-1])
    if m.stride(1) != 1:
        m = m.contiguous()
    return m


# kernel launches of one fused_mlp_block call on the card: the LN + modulate
# kernel and the two head GEMM products (csrc/fused_block.cu)
MLP_BLOCK_LAUNCHES = 3


@functools.lru_cache(maxsize=64)
def mlp_block_plans(rows: int, c: int, hidden: int,
                    sm_count: int = 132) -> tuple[HeadGemmPlan, HeadGemmPlan]:
    """The head GEMM's plans of the MLP block's w1 ([2H, C], SwiGLU) and w2
    ([C, H]) products at ``rows`` (H-1x at 8 rows: w1 30 tiles x 4 splits,
    w2 10 x 8; B-16x at 512: w1 72 x 1, w2 24 x 4). Raises ValueError for a
    shape the head GEMM cannot take: C % 128 or H % 64 not 0 (every ImageNet
    and T2I head width takes it: C 256 / 768 / 1024 / 1280 / 5120, H =
    1.5 C)."""
    if rows < 1 or c < 1 or hidden < 1 or c % 128 or hidden % 64:
        raise ValueError(f"fused_mlp_block: the head GEMM takes C % 128 == 0 and H % 64 "
                         f"== 0, not C = {c}, H = {hidden} ({rows} rows)")
    return (head_gemm_plan(rows, 2 * hidden, c, sm_count),
            head_gemm_plan(rows, c, hidden, sm_count))


@functools.lru_cache(maxsize=64)
def _mlp_plan_ints(rows: int, c: int, hidden: int, sm_count: int):
    flat = [v for p in mlp_block_plans(rows, c, hidden, sm_count) for v in p]
    return (ctypes.c_int * 6)(*flat)


# kernel launches of one fused_attn_block call on the card: LN + modulate,
# the qkv product, window attention and the wo product (csrc/fused_block.cu)
ATTN_BLOCK_LAUNCHES = 4
# window attention on the card: head dims and the longest window
ATTN_HEAD_DIMS = (64, 128)
ATTN_MAX_WINDOW = 64


@functools.lru_cache(maxsize=64)
def attn_block_plans(rows: int, c: int,
                     sm_count: int = 132) -> tuple[HeadGemmPlan, HeadGemmPlan]:
    """The head GEMM's plans of the attention block's qkv ([3C, C], fp32
    out) and wo ([C, C]) products at ``rows`` (B-16x at 512 rows: qkv 72
    tiles x 1 split, wo 24 x 4; at 1024: 144 x 1, 48 x 2). Raises ValueError
    for a shape the head GEMM cannot take: C % 128 not 0 (every released
    head width takes it: C 256 / 768 / 1024 / 1280 / 5120)."""
    if rows < 1 or c < 1 or c % 128:
        raise ValueError(f"fused_attn_block: the head GEMM takes C % 128 == 0, not "
                         f"C = {c} ({rows} rows)")
    return (head_gemm_plan(rows, 3 * c, c, sm_count), head_gemm_plan(rows, c, c, sm_count))


@functools.lru_cache(maxsize=64)
def _attn_plan_ints(rows: int, c: int, sm_count: int):
    flat = [v for p in attn_block_plans(rows, c, sm_count) for v in p]
    return (ctypes.c_int * 6)(*flat)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """t [rows, C], or a contiguous copy of it: the head GEMM's epilogue
    reads a row's columns 16 bytes at a time, from a 16-byte aligned address
    and a row stride that is a multiple of 8 (0 included)."""
    if t.data_ptr() % 16 or t.stride(0) % 8:
        return t.clone(memory_format=torch.contiguous_format)
    return t


def _check_cuda(name: str, x: torch.Tensor, tensors: dict) -> None:
    for k, t in tensors.items():
        if t.device != x.device or t.dtype != torch.bfloat16:
            raise ValueError(f"{name}: {k} must be bf16 on {x.device}, got "
                             f"{t.dtype} on {t.device}")
        if k not in ("scale", "shift", "gate") and not t.is_contiguous():
            raise ValueError(f"{name}: {k} must be contiguous")


def fused_mlp_block(x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
                    gate: torch.Tensor, ln_w: torch.Tensor, ln_b: torch.Tensor,
                    w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
                    b2: torch.Tensor, eps: float = 1e-6, _pdl: int = 2) -> torch.Tensor:
    """One fused adaLN-SwiGLU residual block; dispatch by device.

    x [rows, C]; scale, shift, gate [rows, C] (any row stride, 0 included);
    ln_w, ln_b [C]; w1 [2H, C], b1 [2H]; w2 [C, H], b2 [C]. Returns
    [rows, C] in x's dtype. On the card C % 128 and H % 64 must be 0
    (:func:`mlp_block_plans`). Its three launches are programmatic
    (``_pdl`` 1: the products only, 0: none, only to measure what that
    saves)."""
    if x.device.type == "cpu":
        return fused_mlp_block_reference(x, scale, shift, gate, ln_w, ln_b, w1,
                                         b1, w2, b2, eps)
    if x.device.type != "cuda":
        raise RuntimeError(f"fused_mlp_block: no kernel for {x.device}")
    params = dict(x=x, scale=scale, shift=shift, gate=gate, ln_w=ln_w,
                  ln_b=ln_b, w1=w1, b1=b1, w2=w2, b2=b2)
    _cuda.refuse_grad("fused_mlp_block", *params.values())
    _check_cuda("fused_mlp_block", x, params)
    if x.ndim != 2:
        raise ValueError(f"fused_mlp_block: x must be [rows, C], got {tuple(x.shape)}")
    rows, c = x.shape
    hidden = w2.shape[1]
    if (tuple(w1.shape) != (2 * hidden, c) or tuple(w2.shape) != (c, hidden)
            or b1.numel() != 2 * hidden or b2.numel() != c
            or ln_w.numel() != c or ln_b.numel() != c):
        raise ValueError(f"fused_mlp_block: weights {tuple(w1.shape)}, "
                         f"{tuple(w2.shape)} do not fit C = {c}")
    plan = _mlp_plan_ints(rows, c, hidden, _cuda.sm_count(x.device.index))
    mods = [_mod_rows(k, params[k], x.shape, rows) for k in ("scale", "shift", "gate")]
    gate, x = _aligned(mods[2]), _aligned(x)
    act = torch.empty((rows, c), dtype=torch.bfloat16, device=x.device)
    glu = torch.empty((rows, hidden), dtype=torch.bfloat16, device=x.device)
    out = torch.empty_like(x)
    code = _cuda.load().bd_fused_mlp_block(
        x.data_ptr(), mods[0].data_ptr(), mods[0].stride(0),
        mods[1].data_ptr(), mods[1].stride(0), gate.data_ptr(),
        gate.stride(0), ln_w.data_ptr(), ln_b.data_ptr(), w1.data_ptr(),
        b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), act.data_ptr(),
        glu.data_ptr(), out.data_ptr(), rows, c, hidden, float(eps), plan,
        int(_pdl), _cuda.stream_ptr())
    _cuda.check(code, "fused_mlp_block")
    fused_mlp_block.launches += 1
    return out


fused_mlp_block.launches = 0


def fused_attn_block(x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
                     gate: torch.Tensor, ln_w: torch.Tensor, ln_b: torch.Tensor,
                     wqkv: torch.Tensor, bqkv: torch.Tensor, wo: torch.Tensor,
                     bo: torch.Tensor, n_head: int, eps: float = 1e-6,
                     _pdl: int = 2) -> torch.Tensor:
    """Fused adaLN window-attention residual block; dispatch by device.

    x [G, W, C], groups of W tokens; scale, shift, gate [G, W, C] (any
    uniform row stride); wqkv [3C, C] with output columns (3, n_head, hd),
    bqkv [3C]; wo [C, C], bo [C]. Returns [G, W, C] in x's dtype. On the
    card C % 128 must be 0 (:func:`attn_block_plans`), C / n_head 64 or 128
    and W at most 64. Its four launches are programmatic (``_pdl`` 1: all
    but the LN, 0: none, only to measure what that saves; all four are as
    fast as the others at B-16x's 512 rows and 0.7 us faster at 1024,
    PERF.md)."""
    if x.device.type == "cpu":
        return fused_attn_block_reference(x, scale, shift, gate, ln_w, ln_b,
                                          wqkv, bqkv, wo, bo, n_head, eps)
    if x.device.type != "cuda":
        raise RuntimeError(f"fused_attn_block: no kernel for {x.device}")
    params = dict(x=x, scale=scale, shift=shift, gate=gate, ln_w=ln_w,
                  ln_b=ln_b, wqkv=wqkv, bqkv=bqkv, wo=wo, bo=bo)
    _cuda.refuse_grad("fused_attn_block", *params.values())
    _check_cuda("fused_attn_block", x, params)
    if x.ndim != 3:
        raise ValueError(f"fused_attn_block: x must be [G, W, C], got {tuple(x.shape)}")
    g, w, c = x.shape
    if (tuple(wqkv.shape) != (3 * c, c) or tuple(wo.shape) != (c, c)
            or bqkv.numel() != 3 * c or bo.numel() != c
            or ln_w.numel() != c or ln_b.numel() != c):
        raise ValueError(f"fused_attn_block: weights {tuple(wqkv.shape)}, "
                         f"{tuple(wo.shape)} do not fit C = {c}")
    hd = c // n_head if n_head > 0 else 0
    if n_head <= 0 or c % n_head or hd not in ATTN_HEAD_DIMS or not 1 <= w <= ATTN_MAX_WINDOW:
        raise ValueError(f"fused_attn_block: C = {c}, n_head = {n_head}, W = {w}: the "
                         f"window attention takes head dims {ATTN_HEAD_DIMS} and windows "
                         f"of 1-{ATTN_MAX_WINDOW} rows")
    rows = g * w
    plan = _attn_plan_ints(rows, c, _cuda.sm_count(x.device.index))
    mods = [_mod_rows(k, params[k], x.shape, rows) for k in ("scale", "shift", "gate")]
    gate, x = _aligned(mods[2]), _aligned(x.reshape(rows, c))
    act = torch.empty((rows, c), dtype=torch.bfloat16, device=x.device)
    qkv = torch.empty((rows, 3 * c), dtype=torch.float32, device=x.device)
    out = torch.empty((g, w, c), dtype=x.dtype, device=x.device)
    code = _cuda.load().bd_fused_attn_block(
        x.data_ptr(), mods[0].data_ptr(), mods[0].stride(0),
        mods[1].data_ptr(), mods[1].stride(0), gate.data_ptr(),
        gate.stride(0), ln_w.data_ptr(), ln_b.data_ptr(), wqkv.data_ptr(),
        bqkv.data_ptr(), wo.data_ptr(), bo.data_ptr(), act.data_ptr(),
        qkv.data_ptr(), out.data_ptr(), g, w, c, n_head, float(eps), plan,
        int(_pdl), _cuda.stream_ptr())
    _cuda.check(code, "fused_attn_block")
    fused_attn_block.launches += 1
    return out


fused_attn_block.launches = 0
