"""Binary visual tokenizer (port of bitdance_tpu/models/tokenizer.py:
GroupNorm32, Conv2D, ResBlock, Encoder (with ``trunk``), depth_to_space,
Upsampler, AdaptiveGroupNorm, Decoder, VQModel.encode / encode_raw /
decode, latents_to_tokens, tokens_to_latents).

``VQModel.encode`` on the card runs the encoder's trunk, then its
GroupNorm / swish / 1x1 conv / sign tail as one kernel
(ops/fused_encode.py, TPU kernel #13), for every geometry: the card has no
VMEM limit to test against (the JAX package's fused_encode_tail_available).

The public functions keep the JAX package's NHWC layout; inside, tensors are
NCHW in channels_last memory, and the convolutions go to cuDNN on the card
(the JAX package leaves them to XLA). Parameter names follow the reference
state dict (``decoder.up.{i}.block.{j}.conv1.weight`` ...), which
``bitdance_tpu/io/torch_import.py::convert_ae_state`` reads.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from bitdance_tpu_torch.ops.fused_encode import fused_encode_tail
from bitdance_tpu_torch.ops.norms import group_norm, swish
from bitdance_tpu_torch.ops.quantize import sign_quantize


def _group_norm(x: torch.Tensor, weight, bias, eps: float) -> torch.Tensor:
    """GroupNorm(32) of an NCHW channels_last tensor through its NHWC view."""
    return group_norm(x.permute(0, 2, 3, 1), 32, weight, bias, eps).permute(0, 3, 1, 2)


class GroupNorm32(nn.Module):
    """GroupNorm(32) with affine weight/bias, fp32 statistics."""

    def __init__(self, channels: int, eps: float = 1e-6, device=None,
                 dtype=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels, device=device, dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(channels, device=device, dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _group_norm(x, self.weight, self.bias, self.eps)


class Conv2D(nn.Conv2d):
    """Conv padded by k // 2 on each side (same-size at stride 1), in the
    module dtype (bf16 on the card)."""

    def __init__(self, cin: int, cout: int, k: int, bias: bool = True,
                 stride: int = 1, device=None, dtype=None):
        super().__init__(cin, cout, k, stride=stride, padding=k // 2, bias=bias,
                         device=device, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.to(self.weight.dtype))


class ResBlock(nn.Module):
    """Pre-GN swish conv block."""

    def __init__(self, cin: int, cout: int, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.norm1 = GroupNorm32(cin, **kw)
        self.norm2 = GroupNorm32(cout, **kw)
        self.conv1 = Conv2D(cin, cout, 3, bias=False, **kw)
        self.conv2 = Conv2D(cout, cout, 3, bias=False, **kw)
        self.nin_shortcut = (Conv2D(cin, cout, 1, bias=False, **kw)
                             if cin != cout else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        residual = x
        x = self.conv1(swish(self.norm1(x)))
        x = self.conv2(swish(self.norm2(x)))
        if self.nin_shortcut is not None:
            residual = self.nin_shortcut(residual)
        return x + residual


class Encoder(nn.Module):
    """Conv downsampling encoder: conv_in, per level num_res_blocks ResBlocks
    and (all but the last level) a stride-2 conv, mid ResBlocks, then
    GroupNorm32, swish and a 1x1 conv_out to z_channels."""

    def __init__(self, ch: int, ch_mult: Sequence[int], num_res_blocks: int,
                 z_channels: int, in_channels: int = 3, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        n = len(ch_mult)
        self.conv_in = Conv2D(in_channels, ch, 3, bias=False, **kw)
        in_ch_mult = (1,) + tuple(ch_mult)
        down = []
        for i_level in range(n):
            block_in = ch * in_ch_mult[i_level]
            block_out = ch * ch_mult[i_level]
            level = nn.Module()
            blocks = []
            for _ in range(num_res_blocks):
                blocks.append(ResBlock(block_in, block_out, **kw))
                block_in = block_out
            level.block = nn.ModuleList(blocks)
            if i_level < n - 1:
                level.downsample = Conv2D(block_out, block_out, 3, stride=2, **kw)
            down.append(level)
        self.down = nn.ModuleList(down)
        block_in = ch * ch_mult[-1]
        self.mid_block = nn.ModuleList(
            [ResBlock(block_in, block_in, **kw) for _ in range(num_res_blocks)])
        self.norm_out = GroupNorm32(block_in, **kw)
        self.conv_out = Conv2D(block_in, z_channels, 1, **kw)

    def trunk(self, x: torch.Tensor) -> torch.Tensor:
        """Everything before the quantization tail (norm_out, swish,
        conv_out), which ``VQModel.encode`` fuses into one kernel."""
        x = self.conv_in(x)
        for level in self.down:
            for blk in level.block:
                x = blk(x)
            if hasattr(level, "downsample"):
                x = level.downsample(x)
        for blk in self.mid_block:
            x = blk(x)
        return x

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv_out(swish(self.norm_out(self.trunk(x))))


def depth_to_space(x: torch.Tensor, block_size: int) -> torch.Tensor:
    """DCR depth-to-space on NCHW: channel (s1, s2, c) -> pixel (h*s+s1,
    w*s+s2), the NCHW twin of the JAX package's NHWC function."""
    b, c, h, w = x.shape
    s = block_size
    cc = c // (s * s)
    x = x.reshape(b, s, s, cc, h, w).permute(0, 3, 4, 1, 5, 2)
    return x.reshape(b, cc, h * s, w * s).contiguous(
        memory_format=torch.channels_last)


class Upsampler(nn.Module):
    def __init__(self, dim: int, device=None, dtype=None):
        super().__init__()
        self.conv1 = Conv2D(dim, dim * 4, 3, device=device, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return depth_to_space(self.conv1(x), 2)


class AdaptiveGroupNorm(nn.Module):
    """GN modulated by the latent's spatial statistics: scale =
    gamma(sqrt(var + eps)), bias = beta(mean); unbiased (N-1) variance."""

    def __init__(self, z_channels: int, in_filters: int, eps: float = 1e-6,
                 device=None, dtype=None):
        super().__init__()
        self.eps = eps
        self.gamma = nn.Linear(z_channels, in_filters, device=device, dtype=dtype)
        self.beta = nn.Linear(z_channels, in_filters, device=device, dtype=dtype)

    def forward(self, x: torch.Tensor, style: torch.Tensor) -> torch.Tensor:
        # style: NCHW latent
        b, zc = style.shape[:2]
        sf = style.float().reshape(b, zc, -1)
        n = sf.shape[-1]
        mean = sf.mean(dim=-1)
        var = (sf - mean[..., None]).square().sum(dim=-1) / max(n - 1, 1)
        dt = self.gamma.weight.dtype
        scale = self.gamma(torch.sqrt(var + self.eps).to(dt))
        bias = self.beta(mean.to(dt))
        x = _group_norm(x, None, None, self.eps)
        return scale[:, :, None, None] * x + bias[:, :, None, None]


class Decoder(nn.Module):
    """Conv upsampling decoder with AdaGN conditioning."""

    def __init__(self, ch: int, ch_mult: Sequence[int], num_res_blocks: int,
                 z_channels: int, out_ch: int = 3, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        n = len(ch_mult)
        self.ch_mult = tuple(ch_mult)
        block_in = ch * ch_mult[-1]
        self.conv_in = Conv2D(z_channels, block_in, 3, **kw)
        self.mid_block = nn.ModuleList(
            [ResBlock(block_in, block_in, **kw) for _ in range(num_res_blocks)])
        up = [None] * n
        adaptive = [None] * n
        bi = block_in
        for i_level in reversed(range(n)):
            block_out = ch * ch_mult[i_level]
            adaptive[i_level] = AdaptiveGroupNorm(z_channels, bi, **kw)
            level = nn.Module()
            blocks = []
            for _ in range(num_res_blocks):
                blocks.append(ResBlock(bi, block_out, **kw))
                bi = block_out
            level.block = nn.ModuleList(blocks)
            if i_level > 0:
                level.upsample = Upsampler(bi, **kw)
            up[i_level] = level
        self.up = nn.ModuleList(up)
        self.adaptive = nn.ModuleList(adaptive)
        self.norm_out = GroupNorm32(bi, **kw)
        self.conv_out = Conv2D(bi, out_ch, 3, **kw)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        style = z
        z = self.conv_in(z)
        for blk in self.mid_block:
            z = blk(z)
        for i_level in reversed(range(len(self.ch_mult))):
            z = self.adaptive[i_level](z, style)
            for blk in self.up[i_level].block:
                z = blk(z)
            if i_level > 0:
                z = self.up[i_level].upsample(z)
        return self.conv_out(swish(self.norm_out(z)))


class VQModel(nn.Module):
    """Sign-quantized conv autoencoder. ``encoder`` / ``decoder`` choose
    which halves exist (serving needs only the decoder, training only the
    encoder)."""

    def __init__(self, ddconfig: dict, device=None,
                 dtype: torch.dtype = torch.float32, encoder: bool = False,
                 decoder: bool = True):
        super().__init__()
        dd = dict(ddconfig)
        self.ddconfig = dd
        if encoder:
            self.encoder = Encoder(dd["ch"], dd["ch_mult"], dd["num_res_blocks"],
                                   dd["z_channels"], dd.get("in_channels", 3),
                                   device=device, dtype=dtype)
        if decoder:
            self.decoder = Decoder(dd["ch"], dd["ch_mult"], dd["num_res_blocks"],
                                   dd["z_channels"], dd.get("out_ch", 3),
                                   device=device, dtype=dtype)

    def _nchw(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.encoder.conv_in.weight.dtype
        return x.to(dt).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)

    def encode_raw(self, x: torch.Tensor) -> torch.Tensor:
        """Image NHWC in [-1, 1] -> pre-quantization encoder output NHWC
        [B, h, w, z] (what GFQ quantizes in training)."""
        return self.encoder(self._nchw(x)).permute(0, 2, 3, 1)

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """Image NHWC in [-1, 1] -> ±1 latents NHWC [B, h, w, z] in the
        model's dtype. On the card: the trunk, then the fused tail kernel
        (trunk channels must be a multiple of 32); on the CPU: the encoder
        and ``sign_quantize``."""
        enc = self.encoder
        if x.device.type == "cpu":
            return sign_quantize(self.encode_raw(x))
        trunk_ch = self.ddconfig["ch"] * self.ddconfig["ch_mult"][-1]
        if trunk_ch % 32:
            raise ValueError(f"VQModel.encode: the fused tail needs trunk channels "
                             f"divisible by 32, got {trunk_ch}")
        h = enc.trunk(self._nchw(x)).permute(0, 2, 3, 1)          # NHWC view
        w = enc.conv_out.weight
        return fused_encode_tail(h, enc.norm_out.weight, enc.norm_out.bias,
                                 w.reshape(w.shape[0], -1).t(), enc.conv_out.bias,
                                 eps=enc.norm_out.eps)

    def decode(self, quant: torch.Tensor) -> torch.Tensor:
        """±1 latents NHWC [B, h, w, z] -> image NHWC [B, H, W, 3]."""
        dt = self.decoder.conv_in.weight.dtype
        z = quant.to(dt).permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last)
        return self.decoder(z).permute(0, 2, 3, 1)


def latents_to_tokens(quant: torch.Tensor, ps: int = 1) -> torch.Tensor:
    """[B, h, w, C] -> [B, h*w, C] with ps-raster ordering (the inverse of
    :func:`tokens_to_latents`)."""
    b, h, w, c = quant.shape
    hh, ww = h // ps, w // ps
    x = quant.reshape(b, hh, ps, ww, ps, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h * w, c)


def tokens_to_latents(tokens: torch.Tensor, h: int, w: int,
                      ps: int = 1) -> torch.Tensor:
    """[B, h*w, C] ps-raster tokens -> [B, h, w, C] NHWC latents."""
    b, n, c = tokens.shape
    assert n == h * w
    hh, ww = h // ps, w // ps
    x = tokens.reshape(b, hh, ww, ps, ps, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h, w, c)


def init_vq(ddconfig: dict, device, dtype: torch.dtype = torch.bfloat16,
            generator: torch.Generator | None = None, encoder: bool = False,
            decoder: bool = True) -> VQModel:
    """Random init on ``device`` (meta first): conv and linear weights
    lecun-normal (std 1/sqrt(fan_in)), biases 0, norm gains 1 — the JAX
    package's flax defaults."""
    with torch.device("meta"):
        m = VQModel(ddconfig, dtype=dtype, encoder=encoder, decoder=decoder)
    m = m.to_empty(device=device)
    with torch.no_grad():
        for name, p in m.named_parameters():
            if p.ndim >= 2:
                fan_in = p[0].numel()
                p.normal_(0.0, fan_in ** -0.5, generator=generator)
            elif "norm" in name and name.endswith("weight"):
                p.fill_(1.0)
            else:
                p.zero_()
    return m.eval().requires_grad_(False)
