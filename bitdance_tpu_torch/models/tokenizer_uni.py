"""UniWeTok binary tokenizer: conv-attention hybrid autoencoder (port of
bitdance_tpu/models/tokenizer_uni.py).

The conv backbone of models/tokenizer.py gains transformer blocks at the
bottleneck (:class:`MidAttentionStack`: 4 learned register tokens, paired 2D
RoPE over normalised patch centres, non-causal attention); the encoder's
output is bounded by SigLu, 2 * sigmoid(x) - 1 in fp32, before the sign;
the decoder is a GAN decoder (noise concatenated to the latents) with the
same mid-attention after conv_in.

Coordinates (the JAX module's two conventions, :func:`mid_freqs`):
  encoder: y_i = i * 7 / (H - 1) + 0.5
  decoder: y_i = (i + 0.5) * 7.5 / (H - 0.5)

The mid-attention is plain torch (``ops/attention.py::attention_xla``), as
the JAX package runs it on XLA's attention, not on a Pallas kernel. The
token stream of the stack is fp32 (the JAX stack concatenates its fp32
register tokens to the features, which promotes it); each product runs in
the module dtype.

Parameter names are those ``bitdance_tpu/io/torch_import.py::
convert_ae_state`` maps onto the JAX tree (``encoder.mid_attn.block_0.
attention.wqkv.weight``, ``...feed_forward_w1.weight``, ``...attention_norm.
weight``, ``encoder.mid_attn.register_token``); ``io/from_jax.py`` maps the
JAX tree back to them.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from bitdance_tpu_torch.models.tokenizer import (
    Conv2D,
    Decoder,
    GroupNorm32,
    ResBlock,
    VQModel,
    init_module_,
)
from bitdance_tpu_torch.ops.attention import attention_xla
from bitdance_tpu_torch.ops.norms import rms_norm
from bitdance_tpu_torch.ops.quantize import sign_quantize
from bitdance_tpu_torch.ops.rotary import apply_rope_paired, rope_table_2d

NUM_REGISTERS = 4


def find_multiple(n: int, k: int) -> int:
    return n if n % k == 0 else n + k - (n % k)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)


class RMSNormModule(nn.Module):
    def __init__(self, dim: int, device=None, dtype=None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim, device=device, dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rms_norm(x, self.weight)


def _linear(lin: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """A bias-free product in the weights' dtype (flax Dense(dtype=...))."""
    return lin(x.to(lin.weight.dtype))


class MidAttention(nn.Module):
    """Fused-qkv non-causal attention with paired 2D RoPE."""

    def __init__(self, dim: int, n_head: int, device=None, dtype=None):
        super().__init__()
        kw = dict(bias=False, device=device, dtype=dtype)
        self.n_head = n_head
        self.wqkv = nn.Linear(dim, 3 * dim, **kw)
        self.wo = nn.Linear(dim, dim, **kw)

    def forward(self, x: torch.Tensor, freqs_cis: torch.Tensor) -> torch.Tensor:
        b, n, dim = x.shape
        hd = dim // self.n_head
        q, k, v = _linear(self.wqkv, x).chunk(3, dim=-1)
        q = apply_rope_paired(q.reshape(b, n, self.n_head, hd), freqs_cis)
        k = apply_rope_paired(k.reshape(b, n, self.n_head, hd), freqs_cis)
        o = attention_xla(q, k, v.reshape(b, n, self.n_head, hd))
        return _linear(self.wo, o.reshape(b, n, dim))


class UniTransformerBlock(nn.Module):
    """Pre-RMSNorm block with a SwiGLU FFN of hidden find_multiple(8 d / 3,
    256)."""

    def __init__(self, dim: int, n_head: int, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        hidden = find_multiple(int(2 * (4 * dim) / 3), 256)
        self.attention = MidAttention(dim, n_head, **kw)
        self.attention_norm = RMSNormModule(dim, **kw)
        self.ffn_norm = RMSNormModule(dim, **kw)
        self.feed_forward_w1 = nn.Linear(dim, 2 * hidden, bias=False, **kw)
        self.feed_forward_w2 = nn.Linear(hidden, dim, bias=False, **kw)

    def forward(self, x: torch.Tensor, freqs_cis: torch.Tensor) -> torch.Tensor:
        h = x + self.attention(self.attention_norm(x), freqs_cis)
        h1, h2 = _linear(self.feed_forward_w1, self.ffn_norm(h)).chunk(2, dim=-1)
        return h + _linear(self.feed_forward_w2, F.silu(h1) * h2)


def mid_freqs(h: int, w: int, head_dim: int, num_registers: int, decoder: bool,
              device=None) -> torch.Tensor:
    """The stack's RoPE table [num_registers + h * w, head_dim // 2, 2]
    (register rows: identity rotations) in the encoder's or the decoder's
    coordinate convention."""
    ar = lambda n: torch.arange(n, dtype=torch.float32, device=device)  # noqa: E731
    if decoder:
        ys = (ar(h) + 0.5) * (7.5 / (h - 0.5))
        xs = (ar(w) + 0.5) * (7.5 / (w - 0.5))
    else:
        ys = ar(h) * (7.0 / max(h - 1, 1)) + 0.5
        xs = ar(w) * (7.0 / max(w - 1, 1)) + 0.5
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    pos_2d = torch.stack([gx.reshape(-1), gy.reshape(-1)], dim=1)
    return rope_table_2d(pos_2d, head_dim, cls_token_num=num_registers)


class MidAttentionStack(nn.Module):
    """Register tokens + ``attn_blocks`` transformer blocks (``block_{i}``)
    over the flattened feature map."""

    def __init__(self, dim: int, n_head: int, attn_blocks: int,
                 decoder_coords: bool = False, device=None, dtype=None):
        super().__init__()
        self.n_head = n_head
        self.attn_blocks = attn_blocks
        self.decoder_coords = decoder_coords
        self.register_token = nn.Parameter(
            torch.zeros((NUM_REGISTERS, dim), device=device, dtype=dtype))
        for i in range(attn_blocks):
            self.add_module(f"block_{i}", UniTransformerBlock(dim, n_head, device=device,
                                                              dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x NCHW -> NCHW (channels_last), fp32."""
        b, c, h, w = x.shape
        tokens = torch.cat([self.register_token.float()[None].expand(b, -1, -1),
                            _nhwc(x).float().reshape(b, h * w, c)], dim=1)
        freqs = mid_freqs(h, w, c // self.n_head, NUM_REGISTERS,
                          self.decoder_coords, device=x.device)
        for i in range(self.attn_blocks):
            tokens = getattr(self, f"block_{i}")(tokens, freqs)
        return _nchw(tokens[:, NUM_REGISTERS:].reshape(b, h, w, c))


class UniEncoder(nn.Module):
    """conv_in, per level ``num_res_blocks`` same-width ResBlocks and (all
    but the last level) a stride-2 conv to the next level's width, the
    mid-attention stack, GroupNorm32 (no swish), a 1x1 conv_out and SigLu.
    Needs ch_mult[0] == 1 (conv_in writes ch channels), as the reference."""

    def __init__(self, ch: int, ch_mult: Sequence[int], num_res_blocks: int,
                 z_channels: int, attn_blocks: int = 2, n_heads: int = 16,
                 in_channels: int = 3, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        n = len(ch_mult)
        self.attn_blocks = attn_blocks
        self.conv_in = Conv2D(in_channels, ch, 3, bias=False, **kw)
        down = []
        for i_level in range(n):
            block_in = ch * ch_mult[i_level]
            level = nn.Module()
            level.block = nn.ModuleList(
                [ResBlock(block_in, block_in, **kw) for _ in range(num_res_blocks)])
            if i_level < n - 1:
                level.downsample = Conv2D(block_in, ch * ch_mult[i_level + 1], 3,
                                          stride=2, **kw)
            down.append(level)
        self.down = nn.ModuleList(down)
        block_in = ch * ch_mult[-1]
        self.mid_attn = MidAttentionStack(block_in, n_heads, attn_blocks, **kw)
        self.norm_out = GroupNorm32(block_in, **kw)
        self.conv_out = Conv2D(block_in, z_channels, 1, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv_in(x)
        for level in self.down:
            for blk in level.block:
                x = blk(x)
            if hasattr(level, "downsample"):
                x = level.downsample(x)
        if self.attn_blocks > 0:
            x = self.mid_attn(x)
        x = self.conv_out(self.norm_out(x))
        return 2.0 * torch.sigmoid(x.float()) - 1.0


class UniGANDecoder(Decoder):
    """The GAN decoder of models/tokenizer.py with the mid-attention stack
    (decoder coordinates) between conv_in and the mid ResBlocks, which
    ``Decoder.forward`` runs where the module has one."""

    def __init__(self, ch: int, ch_mult: Sequence[int], num_res_blocks: int,
                 z_channels: int, out_ch: int = 3, attn_blocks: int = 2,
                 n_heads: int = 16, device=None, dtype=None):
        super().__init__(ch, ch_mult, num_res_blocks, z_channels, out_ch,
                         gan_decoder=True, device=device, dtype=dtype)
        self.mid_attn = MidAttentionStack(ch * ch_mult[-1], n_heads, attn_blocks,
                                          decoder_coords=True, device=device,
                                          dtype=dtype)


class UniVQModel(VQModel):
    """Sign-quantized UniWeTok autoencoder: ``encode`` (the sign of the
    SigLu output, in fp32), ``encode_raw`` and ``decode`` keep
    :class:`VQModel`'s NHWC interface (``decode`` takes ``noise`` or
    ``generator`` like a GAN VQModel's). ``ddconfig`` may hold
    ``attn_blocks`` (default 2) and ``n_heads`` (16)."""

    def __init__(self, ddconfig: dict, device=None,
                 dtype: torch.dtype = torch.float32, encoder: bool = True,
                 decoder: bool = True):
        nn.Module.__init__(self)
        dd = dict(ddconfig)
        self.ddconfig = dd
        self.gan_decoder = True
        common = dict(ch=dd["ch"], ch_mult=dd["ch_mult"],
                      num_res_blocks=dd["num_res_blocks"], z_channels=dd["z_channels"],
                      attn_blocks=dd.get("attn_blocks", 2), n_heads=dd.get("n_heads", 16),
                      device=device, dtype=dtype)
        if encoder:
            self.encoder = UniEncoder(in_channels=dd.get("in_channels", 3), **common)
        if decoder:
            self.decoder = UniGANDecoder(out_ch=dd.get("out_ch", 3), **common)

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """Image NHWC in [-1, 1] -> ±1 latents NHWC [B, h, w, z], fp32 (the
        SigLu output's sign; no fused tail: the tail differs from #13's)."""
        return sign_quantize(self.encode_raw(x))


def init_uni_vq(ddconfig: dict, device, dtype: torch.dtype = torch.bfloat16,
                generator: torch.Generator | None = None, encoder: bool = True,
                decoder: bool = True) -> UniVQModel:
    """Random init on ``device`` (meta first), as :func:`init_vq` draws a
    VQModel; the register tokens N(0, 0.02), the JAX module's init."""
    with torch.device("meta"):
        m = UniVQModel(ddconfig, dtype=dtype, encoder=encoder, decoder=decoder)
    m = init_module_(m, device, generator)
    with torch.no_grad():
        for name, p in m.named_parameters():
            if name.endswith("register_token"):
                p.normal_(0.0, 0.02, generator=generator)
    return m

