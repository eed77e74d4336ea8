"""Int8 weights for the inference products (port of bitdance_tpu/ops/int8.py).

Weights are stored as int8 with symmetric per-output-column float32 scales;
activations are quantized per row at the product, which then runs as
s8 x s8 -> s32 with the scales applied to the sum. The port keeps the torch
Linear layout: a :class:`QTensor` holds ``q`` int8 [N, K] (out, in) and
``s`` f32 [N] (the JAX package stores q [K, N] and s [1, N]).

The JAX package computes this product in XLA, outside any Pallas kernel, so
on the card :func:`int8_matmul` calls ``torch._int_mm``; on the CPU the
integer sum is taken in float64, which is exact at these sizes (every
partial sum stays below 2^53).
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class QTensor:
    """Symmetric per-output-column int8 weight: w[n, k] ~= q[n, k] * s[n]."""

    q: torch.Tensor
    s: torch.Tensor


def true_div(x: torch.Tensor, d: float) -> torch.Tensor:
    """x / d as an IEEE division, as the JAX package and the kernels divide.
    (PyTorch's CUDA kernels multiply by the reciprocal when the divisor is a
    Python number, which is one ulp off for some values and would move
    scales and quantized values.)"""
    return x / torch.full((), d, dtype=x.dtype, device=x.device)


def quantize_linear(w: torch.Tensor) -> QTensor:
    """[N, K] weight -> int8 per output row n (over K), scale floor 1e-12."""
    wf = w.float()
    scale = torch.clamp_min(true_div(wf.abs().amax(dim=-1), 127.0), 1e-12)
    q = torch.clamp(torch.round(wf / scale[..., None]), -127, 127)
    return QTensor(q=q.to(torch.int8), s=scale)


def dequantize(w: QTensor, dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    return (w.q.float() * w.s[..., None]).to(dtype)


def quantize_rows(x2: torch.Tensor,
                  amax: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Dynamic symmetric per-row int8 quantization of [M, K] activations
    (float32 math, true division, round half to even; scale floor 1e-12).
    ``amax`` [M] replaces the rows' own max |x| (a row-parallel product's
    share quantized in the whole row's units). Returns (int8 [M, K], f32
    scales [M])."""
    xf = x2.float()
    if amax is None:
        amax = xf.abs().amax(dim=1)
    sx = torch.clamp_min(true_div(amax, 127.0), 1e-12)
    xq = torch.clamp(torch.round(xf / sx[:, None]), -127, 127)
    return xq.to(torch.int8), sx


def int_dot(aq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """Exact integer product aq [M, K] int8 x wq [N, K] int8 -> float32 [M, N]
    (the int32 sum converted to float32, as the JAX package's s32 -> f32).

    ``torch._int_mm`` on the card where it takes the shapes (K and N
    multiples of 8; M <= 16 padded with zero rows to the 17 it needs, as a
    batch-1 text step gives 1 row), float64 elsewhere; both sums are exact."""
    m, k = aq.shape
    n = wq.shape[0]
    if aq.is_cuda and k % 8 == 0 and n % 8 == 0:
        if m > 16:
            return torch._int_mm(aq, wq.t()).float()
        padded = torch.zeros((17, k), dtype=aq.dtype, device=aq.device)
        padded[:m] = aq
        return torch._int_mm(padded, wq.t())[:m].float()
    return (aq.double() @ wq.double().t()).float()


def int8_matmul(x: torch.Tensor, w: QTensor) -> torch.Tensor:
    """x [..., K] @ (q * s).T with per-row int8 activations; returns x's dtype."""
    shape = x.shape
    xq, sx = quantize_rows(x.reshape(-1, shape[-1]))
    out = int_dot(xq, w.q) * (sx[:, None] * w.s[None, :])
    return out.reshape(*shape[:-1], w.q.shape[0]).to(x.dtype)


def mm(x: torch.Tensor, w) -> torch.Tensor:
    """Weight application dispatching on the weight's type: QTensor -> W8A8,
    Q4Tensor -> packed-int4 W4A8, a tensor [N, K] -> x @ w.T."""
    if isinstance(w, QTensor):
        return int8_matmul(x, w)
    from bitdance_tpu_torch.ops.int4 import Q4Tensor, int4_matmul

    if isinstance(w, Q4Tensor):
        return int4_matmul(x, w)
    return x @ w.t()
