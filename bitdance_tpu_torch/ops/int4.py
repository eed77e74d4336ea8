"""Packed int4 weights with int8 activations, W4A8 (port of
bitdance_tpu/ops/int4.py).

Layout: a :class:`Q4Tensor` holds ``q`` int8 [N, K/2] and ``s`` f32 [N] (the
JAX package stores q [K/2, N]; the port keeps K contiguous per output
column, which is what the tensor cores' col-major B operand reads). Byte
[n, j] holds k = j in its low nibble and k = j + K/2 in its high nibble, so
the product is two contiguous half-K products, one per nibble plane.

:func:`int4_matmul` row-quantizes the activations and runs the product as
the kernel ``csrc/w4a8.cu`` (replacing the TPU kernel ``_w4a8_kernel``) on a
CUDA tensor; a CPU tensor takes :func:`int4_matmul_reference`. The JAX
package's routing (its kernel only for m <= 1024, m % 32 == 0, K % 256 ==
0) is a TPU choice and is not carried over.
"""

from __future__ import annotations

import dataclasses

import torch

from bitdance_tpu_torch.ops import _cuda
from bitdance_tpu_torch.ops.int8 import int_dot, quantize_rows, true_div


@dataclasses.dataclass
class Q4Tensor:
    """Per-output-column int4 weight, two per byte along K:
    w[n, k] ~= unpack(q)[n, k] * s[n]."""

    q: torch.Tensor
    s: torch.Tensor


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """int8 values in [-8, 7], [..., K] -> packed [..., K/2] (k, k + K/2)."""
    kh = q.shape[-1] // 2
    if 2 * kh != q.shape[-1]:
        raise ValueError(f"odd contraction dim {tuple(q.shape)}")
    return ((q[..., :kh] & 0xF) | (q[..., kh:] << 4)).to(torch.int8)


def quantize_linear_int4(w: torch.Tensor) -> Q4Tensor:
    """[N, K] weight -> packed int4 per output row n, scale floor 1e-12."""
    wf = w.float()
    scale = torch.clamp_min(true_div(wf.abs().amax(dim=-1), 7.0), 1e-12)
    q = torch.clamp(torch.round(wf / scale[..., None]), -7, 7).to(torch.int8)
    return Q4Tensor(q=pack_int4(q), s=scale)


def unpack_int4(packed: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(lo, hi) sign-extended int8 nibble planes of a packed buffer."""
    w32 = packed.to(torch.int32)
    lo = ((w32 << 28) >> 28).to(torch.int8)
    hi = (w32 >> 4).to(torch.int8)
    return lo, hi


def dequantize_int4(w: Q4Tensor, dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    lo, hi = unpack_int4(w.q)
    q = torch.cat([lo, hi], dim=-1)
    return (q.float() * w.s[..., None]).to(dtype)


def int4_matmul_reference(xq: torch.Tensor, sx: torch.Tensor,
                          wq: torch.Tensor, sw: torch.Tensor,
                          out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Plain version of the kernel: int8 [M, K] (row scales sx [M]) x packed
    [N, K/2] (column scales sw [N]) -> out_dtype [M, N], with the integer sum
    exact (ops/int8.int_dot on the unpacked planes)."""
    lo, hi = unpack_int4(wq)
    kh = wq.shape[1]
    acc = int_dot(xq[:, :kh].contiguous(), lo) + int_dot(xq[:, kh:].contiguous(), hi)
    return (acc * (sx[:, None] * sw[None, :])).to(out_dtype)


def int4_matmul(x: torch.Tensor, w: Q4Tensor) -> torch.Tensor:
    """x [..., K] @ unpack(q)*s .T with per-row int8 activations (W4A8);
    returns x's dtype. CPU tensors take :func:`int4_matmul_reference`; CUDA
    tensors run the kernel (bf16 or fp32 x, K % 128 == 0, N % 64 == 0) or
    raise."""
    shape = x.shape
    n, kh = w.q.shape
    if shape[-1] != 2 * kh:
        raise ValueError(f"int4_matmul: x {tuple(shape)} vs packed weight "
                         f"{tuple(w.q.shape)}")
    x2 = x.reshape(-1, shape[-1])
    if x.device.type == "cpu":
        xq, sx = quantize_rows(x2)
        out = int4_matmul_reference(xq, sx, w.q, w.s, x.dtype)
        return out.reshape(*shape[:-1], n)
    if x.device.type != "cuda":
        raise RuntimeError(f"int4_matmul: no kernel for {x.device}")
    _cuda.refuse_grad("int4_matmul", x)
    m, k = x2.shape
    if x.dtype not in (torch.bfloat16, torch.float32) or k % 128 or n % 64:
        raise ValueError(f"int4_matmul: kernel takes bf16/fp32 x with K % 128 "
                         f"== 0 and N % 64 == 0, got {x.dtype} K={k} N={n}")
    for name, t, dt in (("q", w.q, torch.int8), ("s", w.s, torch.float32)):
        if t.dtype != dt or not t.is_contiguous() or t.device != x.device:
            raise ValueError(f"int4_matmul: weight {name} must be contiguous "
                             f"{dt} on {x.device}, got {t.dtype}")
    x2 = x2.contiguous()
    xq = torch.empty((m, k), dtype=torch.int8, device=x.device)
    sx = torch.empty((m,), dtype=torch.float32, device=x.device)
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    lib = _cuda.load()
    _cuda.check(lib.bd_w4a8_matmul(
        x2.data_ptr(), int(x.dtype == torch.bfloat16), xq.data_ptr(),
        sx.data_ptr(), w.q.data_ptr(), w.s.data_ptr(), out.data_ptr(), m, n, k,
        _cuda.stream_ptr()), "int4_matmul")
    int4_matmul.launches += 1
    return out.reshape(*shape[:-1], n)


int4_matmul.launches = 0
