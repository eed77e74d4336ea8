"""Binary visual tokenizer (port of bitdance_tpu/models/tokenizer.py:
GroupNorm32, Conv2D with its W8A8 mode, ResBlock, Encoder (with ``trunk``),
depth_to_space, Upsampler, AdaptiveGroupNorm, Decoder with the GAN decoder's
noise input, VQModel.encode / encode_raw / decode, latents_to_tokens,
tokens_to_latents).

``VQModel.encode`` on the card runs the encoder's trunk, then its
GroupNorm / swish / 1x1 conv / sign tail as one kernel
(ops/fused_encode.py, TPU kernel #13), for every geometry: the card has no
VMEM limit to test against (the JAX package's fused_encode_tail_available).

The public functions keep the JAX package's NHWC layout; inside, tensors are
NCHW in channels_last memory, and the convolutions go to cuDNN on the card
(the JAX package leaves them to XLA). Parameter names follow the reference
state dict (``decoder.up.{i}.block.{j}.conv1.weight`` ...), which
``bitdance_tpu/io/torch_import.py::convert_ae_state`` reads.

``conv_int8=True`` runs the decoder's trunk convolutions (its ResBlocks and
Upsamplers; conv_in and conv_out stay in the module dtype) as the JAX
package's W8A8 convolution (:func:`conv_int8`); the parameters stay the
plain ones and quantize per call. ``gan_decoder=True`` concatenates a
gaussian noise block to the latents before conv_in; the noise is passed in
or drawn from an explicit ``torch.Generator`` (:meth:`VQModel.decode`),
never from the global generator.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from bitdance_tpu_torch.ops.fused_encode import fused_encode_tail
from bitdance_tpu_torch.ops.int8 import int_dot, true_div
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


# im2col bytes per chunk of output rows in conv_int8 (a 1024 px decode's
# level-0 conv would need 2.4 GB of columns in one piece)
CONV_INT8_CHUNK_BYTES = 1 << 28


def quantize_conv_weight(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """OIHW weight -> (int8 [O, kh * kw * I] in (kh, kw, I) order, f32 scale
    [O]): symmetric per output channel, scale max(max |w|, 1e-12) / 127,
    round half to even, clip at +-127 (JAX tokenizer.py:80-83)."""
    wf = w.float().permute(0, 2, 3, 1).reshape(w.shape[0], -1)
    ws = true_div(wf.abs().amax(dim=1).clamp_min(1e-12), 127.0)
    wq = torch.clamp(torch.round(wf / ws[:, None]), -127, 127).to(torch.int8)
    return wq, ws


def quantize_conv_input(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """NHWC activations -> (int8 NHWC, f32 scale [B]): symmetric per image
    (JAX tokenizer.py:84-88)."""
    xf = x.float()
    xs = true_div(xf.abs().amax(dim=(1, 2, 3)).clamp_min(1e-12), 127.0)
    xq = torch.clamp(torch.round(xf / xs[:, None, None, None]), -127, 127)
    return xq.to(torch.int8), xs


def conv_int8_acc(xq: torch.Tensor, wq: torch.Tensor, k: int) -> torch.Tensor:
    """The integer sums of a stride-1 'same' k x k convolution: xq int8 NHWC
    [B, H, W, I], wq int8 [O, k * k * I] in (kh, kw, I) order -> float32
    NHWC [B, H, W, O] holding the int32 sums (exact, as JAX's s32 -> f32).
    im2col by shifted slices of the zero-padded input, CONV_INT8_CHUNK_BYTES
    of columns at a time, each chunk one :func:`int_dot` (``torch._int_mm``
    on the card, float64 on the CPU)."""
    b, h, w, ci = xq.shape
    p = k // 2
    xp = F.pad(xq, (0, 0, p, p, p, p)) if p else xq
    rows = max(1, CONV_INT8_CHUNK_BYTES // max(1, b * w * k * k * ci))
    out = torch.empty((b, h, w, wq.shape[0]), dtype=torch.float32, device=xq.device)
    for r0 in range(0, h, rows):
        r1 = min(h, r0 + rows)
        cols = torch.cat([xp[:, r0 + dy:r1 + dy, dx:dx + w]
                          for dy in range(k) for dx in range(k)], dim=-1)
        out[:, r0:r1] = int_dot(cols.reshape(-1, k * k * ci), wq).reshape(
            b, r1 - r0, w, -1)
    return out


def conv_int8(x: torch.Tensor, weight: torch.Tensor,
              bias: torch.Tensor | None) -> torch.Tensor:
    """The JAX package's W8A8 convolution (tokenizer.py:78-92) on an NCHW
    tensor, stride 1, 'same' padding: int8 weights per output channel and
    activations per image, the int32 sums times (xs * ws) in fp32, cast to
    the weight's dtype, then the bias. The JAX package runs it as
    ``lax.conv_general_dilated`` on s8 operands, outside any Pallas kernel."""
    wq, ws = quantize_conv_weight(weight)
    xq, xs = quantize_conv_input(x.permute(0, 2, 3, 1))
    acc = conv_int8_acc(xq, wq, weight.shape[-1])
    y = (acc * (xs[:, None] * ws[None, :])[:, None, None, :]).to(weight.dtype)
    if bias is not None:
        y = y + bias
    return y.permute(0, 3, 1, 2)                     # NCHW, channels_last


class Conv2D(nn.Conv2d):
    """Conv padded by k // 2 on each side (same-size at stride 1), in the
    module dtype (bf16 on the card); ``quant=True`` runs it as
    :func:`conv_int8` (stride 1 only)."""

    def __init__(self, cin: int, cout: int, k: int, bias: bool = True,
                 stride: int = 1, quant: bool = False, device=None, dtype=None):
        super().__init__(cin, cout, k, stride=stride, padding=k // 2, bias=bias,
                         device=device, dtype=dtype)
        if quant and stride != 1:
            raise ValueError("Conv2D(quant=True) takes stride 1 only")
        self.quant = quant

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.quant:
            return conv_int8(x, self.weight, self.bias)
        return super().forward(x.to(self.weight.dtype))


class ResBlock(nn.Module):
    """Pre-GN swish conv block."""

    def __init__(self, cin: int, cout: int, device=None, dtype=None,
                 conv_int8: bool = False):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.norm1 = GroupNorm32(cin, **kw)
        self.norm2 = GroupNorm32(cout, **kw)
        self.conv1 = Conv2D(cin, cout, 3, bias=False, quant=conv_int8, **kw)
        self.conv2 = Conv2D(cout, cout, 3, bias=False, quant=conv_int8, **kw)
        self.nin_shortcut = (Conv2D(cin, cout, 1, bias=False, quant=conv_int8, **kw)
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
    def __init__(self, dim: int, device=None, dtype=None, conv_int8: bool = False):
        super().__init__()
        self.conv1 = Conv2D(dim, dim * 4, 3, quant=conv_int8, device=device,
                            dtype=dtype)

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
    """Conv upsampling decoder with AdaGN conditioning. ``gan_decoder``:
    conv_in takes the latents and a noise block of the same shape,
    concatenated on channels; the AdaGN style stays the un-noised latents.
    ``conv_int8``: the trunk convolutions in W8A8."""

    def __init__(self, ch: int, ch_mult: Sequence[int], num_res_blocks: int,
                 z_channels: int, out_ch: int = 3, gan_decoder: bool = False,
                 conv_int8: bool = False, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        n = len(ch_mult)
        self.ch_mult = tuple(ch_mult)
        self.gan_decoder = gan_decoder
        block_in = ch * ch_mult[-1]
        self.conv_in = Conv2D(2 * z_channels if gan_decoder else z_channels,
                              block_in, 3, **kw)
        self.mid_block = nn.ModuleList(
            [ResBlock(block_in, block_in, conv_int8=conv_int8, **kw)
             for _ in range(num_res_blocks)])
        up = [None] * n
        adaptive = [None] * n
        bi = block_in
        for i_level in reversed(range(n)):
            block_out = ch * ch_mult[i_level]
            adaptive[i_level] = AdaptiveGroupNorm(z_channels, bi, **kw)
            level = nn.Module()
            blocks = []
            for _ in range(num_res_blocks):
                blocks.append(ResBlock(bi, block_out, conv_int8=conv_int8, **kw))
                bi = block_out
            level.block = nn.ModuleList(blocks)
            if i_level > 0:
                level.upsample = Upsampler(bi, conv_int8=conv_int8, **kw)
            up[i_level] = level
        self.up = nn.ModuleList(up)
        self.adaptive = nn.ModuleList(adaptive)
        self.norm_out = GroupNorm32(bi, **kw)
        self.conv_out = Conv2D(bi, out_ch, 3, **kw)

    def forward(self, z: torch.Tensor, noise: torch.Tensor | None = None) -> torch.Tensor:
        """z NCHW latents; ``noise`` (NCHW, z's shape) for a GAN decoder."""
        style = z
        if self.gan_decoder:
            z = torch.cat([z, noise.to(z.dtype)], dim=1)
        z = self.conv_in(z)
        mid_attn = getattr(self, "mid_attn", None)      # UniGANDecoder's stack
        if mid_attn is not None and mid_attn.attn_blocks > 0:
            z = mid_attn(z)
        for blk in self.mid_block:
            z = blk(z)
        for i_level in reversed(range(len(self.ch_mult))):
            z = self.adaptive[i_level](z, style)
            for blk in self.up[i_level].block:
                z = blk(z)
            if i_level > 0:
                z = self.up[i_level].upsample(z)
        return self.conv_out(swish(self.norm_out(z)))


def decoder_noise(quant: torch.Tensor, noise: torch.Tensor | None,
                  generator: torch.Generator | None) -> torch.Tensor:
    """A GAN decoder's noise block, NHWC in ``quant``'s shape: ``noise`` as
    given, else standard normal drawn in float32 from ``generator`` on
    quant's device. Neither raises: the port draws no noise from the global
    generator (the JAX package draws from a flax "noise" rng)."""
    if noise is not None:
        if tuple(noise.shape) != tuple(quant.shape):
            raise ValueError(f"decoder noise {tuple(noise.shape)} != latents "
                             f"{tuple(quant.shape)}")
        return noise
    if generator is None:
        raise ValueError("a GAN decoder needs noise= or generator= (no draw "
                         "from the global generator)")
    return torch.randn(tuple(quant.shape), generator=generator,
                       device=quant.device, dtype=torch.float32)


class VQModel(nn.Module):
    """Sign-quantized conv autoencoder. ``encoder`` / ``decoder`` choose
    which halves exist (serving needs only the decoder, training only the
    encoder)."""

    def __init__(self, ddconfig: dict, device=None,
                 dtype: torch.dtype = torch.float32, encoder: bool = False,
                 decoder: bool = True, gan_decoder: bool = False,
                 conv_int8: bool = False):
        super().__init__()
        dd = dict(ddconfig)
        self.ddconfig = dd
        self.gan_decoder = gan_decoder
        if encoder:
            self.encoder = Encoder(dd["ch"], dd["ch_mult"], dd["num_res_blocks"],
                                   dd["z_channels"], dd.get("in_channels", 3),
                                   device=device, dtype=dtype)
        if decoder:
            self.decoder = Decoder(dd["ch"], dd["ch_mult"], dd["num_res_blocks"],
                                   dd["z_channels"], dd.get("out_ch", 3),
                                   gan_decoder=gan_decoder, conv_int8=conv_int8,
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

    def decode(self, quant: torch.Tensor, noise: torch.Tensor | None = None,
               generator: torch.Generator | None = None) -> torch.Tensor:
        """±1 latents NHWC [B, h, w, z] -> image NHWC [B, H, W, 3]. A GAN
        decoder takes ``noise`` (NHWC, quant's shape) or draws it from
        ``generator`` (:func:`decoder_noise`); a plain decoder ignores
        both, as the JAX decoder ignores its noise rng."""
        dt = self.decoder.conv_in.weight.dtype
        nchw = lambda t: t.to(dt).permute(0, 3, 1, 2).contiguous(  # noqa: E731
            memory_format=torch.channels_last)
        n = (nchw(decoder_noise(quant, noise, generator))
             if self.gan_decoder else None)
        return self.decoder(nchw(quant), n).permute(0, 2, 3, 1)


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
            decoder: bool = True, gan_decoder: bool = False,
            conv_int8: bool = False) -> VQModel:
    """Random init on ``device`` (meta first): conv and linear weights
    lecun-normal (std 1/sqrt(fan_in)), biases 0, norm gains 1 — the JAX
    package's flax defaults."""
    with torch.device("meta"):
        m = VQModel(ddconfig, dtype=dtype, encoder=encoder, decoder=decoder,
                    gan_decoder=gan_decoder, conv_int8=conv_int8)
    return init_module_(m, device, generator)


def init_module_(m: nn.Module, device, generator: torch.Generator | None
                 ) -> nn.Module:
    """Allocate a meta-device tokenizer on ``device`` and draw it: matrices
    and conv kernels lecun-normal, norm gains 1, everything else 0 (the
    flax defaults; UniVQModel's register tokens draw their own)."""
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
