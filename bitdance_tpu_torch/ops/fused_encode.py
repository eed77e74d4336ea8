"""Fused tokenizer-encode tail (port of bitdance_tpu/ops/fused_encode.py):
GroupNorm(32) + swish + 1x1 conv + sign over the encoder trunk's output.

``fused_encode_tail`` runs ``csrc/fused_encode.cu`` on a CUDA tensor (two
launches: per-(image, tile of 32 pixels) group statistics, then, per block
of 64 pixels, their sum in a fixed order, normalise, swish, the 1x1 product
on tensor cores (bf16) or fp32 FMAs (fp32) against the conv weight streamed
in chunks, and the sign) and :func:`fused_encode_tail_reference` on a CPU
tensor. Both follow the TPU
kernel's numerics: fp32 statistics with variance E[x^2] - mean^2, the
activations cast to the weight's type before an fp32-accumulated product,
the bias in fp32, and out > 0 ? 1 : -1 (0 maps to -1).
"""

from __future__ import annotations

import torch

from bitdance_tpu_torch.ops import _cuda

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# pixels of a statistics tile of the card's kernel: its partials' scratch
# holds [B, ceil(h * w / ENCODE_STAT_PIXELS), num_groups, 2] floats
ENCODE_STAT_PIXELS = 32


def fused_encode_tail_reference(x: torch.Tensor, gn_weight: torch.Tensor,
                                gn_bias: torch.Tensor, conv_w: torch.Tensor,
                                conv_b: torch.Tensor, num_groups: int = 32,
                                eps: float = 1e-6,
                                quantize: bool = True) -> torch.Tensor:
    """Plain version. x [B, h, w, C]; gn_weight, gn_bias [C]; conv_w
    [C, z] (the JAX kernel's layout); conv_b [z]. Returns [B, h, w, z] in
    x's dtype."""
    b, h, w, c = x.shape
    cg = c // num_groups
    xf = x.float().reshape(b, h * w, num_groups, cg)
    n = h * w * cg
    mean = xf.sum(dim=(1, 3), keepdim=True) / n
    var = xf.square().sum(dim=(1, 3), keepdim=True) / n - mean * mean
    y = ((xf - mean) * torch.rsqrt(var + eps)).reshape(b, h * w, c)
    y = y * gn_weight.float() + gn_bias.float()
    y = y * torch.sigmoid(y)
    out = y.to(conv_w.dtype).float() @ conv_w.float() + conv_b.float()
    if quantize:
        out = torch.where(out > 0, 1.0, -1.0)
    return out.reshape(b, h, w, -1).to(x.dtype)


def fused_encode_tail(x: torch.Tensor, gn_weight: torch.Tensor,
                      gn_bias: torch.Tensor, conv_w: torch.Tensor,
                      conv_b: torch.Tensor, num_groups: int = 32,
                      eps: float = 1e-6, quantize: bool = True) -> torch.Tensor:
    """GroupNorm + swish + 1x1 conv (+ sign), per image; arguments as
    :func:`fused_encode_tail_reference`. The kernel takes x and conv_w of
    one type (bf16 or fp32), z = 32, C a multiple of num_groups and of 8
    (bf16) or 4 (fp32) with C at most 2048 (bf16) or 1024 (fp32), and at
    most 128 groups."""
    if x.device.type == "cpu":
        return fused_encode_tail_reference(x, gn_weight, gn_bias, conv_w, conv_b,
                                           num_groups, eps, quantize)
    if x.device.type != "cuda":
        raise RuntimeError(f"fused_encode_tail: no kernel for {x.device}")
    _cuda.refuse_grad("fused_encode_tail", x, gn_weight, gn_bias, conv_w, conv_b)
    b, h, w, c = x.shape
    z = conv_w.shape[-1]
    vec = 8 if x.dtype == torch.bfloat16 else 4       # elements of a 16-byte load
    if (x.dtype not in _DTYPE_CODE or conv_w.dtype != x.dtype
            or tuple(conv_w.shape) != (c, z) or z != 32 or c % num_groups
            or conv_b.shape != (z,) or c % vec or c // vec > 256 or num_groups > 128):
        raise ValueError(f"fused_encode_tail: kernel takes bf16/fp32 x and conv_w "
                         f"of one type, [C, 32] weights, C % {num_groups} == 0, C a "
                         f"multiple of {vec} and at most {256 * vec}, and at most 128 "
                         f"groups; got x {x.dtype} {tuple(x.shape)}, conv_w "
                         f"{conv_w.dtype} {tuple(conv_w.shape)}")
    x = x.contiguous()
    f32 = lambda t: t.to(device=x.device, dtype=torch.float32).contiguous()  # noqa: E731
    gw, gb, bias = f32(gn_weight), f32(gn_bias), f32(conv_b)
    wk = conv_w.contiguous()
    out = torch.empty((b, h, w, z), dtype=x.dtype, device=x.device)
    tiles = -(-h * w // ENCODE_STAT_PIXELS)
    stats = torch.empty((b, tiles, num_groups, 2), dtype=torch.float32, device=x.device)
    _cuda.check(_cuda.load().bd_fused_encode_tail(
        x.data_ptr(), gw.data_ptr(), gb.data_ptr(), wk.data_ptr(), bias.data_ptr(),
        out.data_ptr(), stats.data_ptr(), b, h * w, c, num_groups, z, float(eps),
        int(quantize), _DTYPE_CODE[x.dtype], _cuda.stream_ptr()), "fused_encode_tail")
    fused_encode_tail.launches += 1
    return out


fused_encode_tail.launches = 0
