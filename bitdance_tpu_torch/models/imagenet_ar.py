"""ImageNet class-conditional AR models, training forward (port of
bitdance_tpu/models/imagenet_ar.py: configs, make_head, proj_in,
freqs_cis_table, train_ids, _attn_full, ar_backbone, forward_train,
grid_to_tokens / tokens_to_grid).

Llama-style pre-RMSNorm blocks with fused QKV, paired 2D RoPE over patch
centres, SwiGLU FFN, class-embedding prefix tokens, learned query tokens for
parallel prediction, and a flow-matching diffusion head. The module keeps the
reference state-dict names that
``bitdance_tpu/io/torch_import.py::convert_imagenet_ar_state`` reads
(``cls_embedding.weight``, ``layers.{i}.attention.wqkv.weight`` ...), one
module per layer where the JAX package stacks them. Attention goes through
``ops/attention.py::masked_attention``: the flash kernels on the card.
Sampling and its KV cache are not ported yet.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from bitdance_tpu_torch.models.diff_head import DiffHead
from bitdance_tpu_torch.ops.attention import masked_attention
from bitdance_tpu_torch.ops.norms import rms_norm
from bitdance_tpu_torch.ops.quantize import flip_bits_uniform_prob
from bitdance_tpu_torch.ops.rotary import (
    apply_rope_paired,
    patch_center_coords_2d,
    rope_table_2d,
)


def find_multiple(n: int, k: int) -> int:
    return n if n % k == 0 else n + k - (n % k)


@dataclasses.dataclass(frozen=True)
class ImageNetARConfig:
    dim: int = 768
    n_layer: int = 24
    n_head: int = 12
    diff_layers: int = 6
    diff_dim: int = 768
    diff_adanln_layers: int = 2
    latent_dim: int = 16
    down_size: int = 16
    patch_size: int = 1
    resolution: int = 256
    cls_token_num: int = 64
    num_classes: int = 1000
    class_dropout_prob: float = 0.1
    diff_batch_mul: int = 4
    parallel_num: int = 1
    grad_checkpointing: bool = False
    perturb_rate: float = 0.0
    time_schedule: str = "logit_normal"
    time_shift: float = 1.0
    P_std: float = 0.8
    P_mean: float = -0.8

    @property
    def h(self) -> int:
        return self.resolution // (self.down_size * self.patch_size)

    @property
    def w(self) -> int:
        return self.h

    @property
    def num_tokens(self) -> int:
        return self.h * self.w

    @property
    def token_dim(self) -> int:
        return self.latent_dim * self.patch_size * self.patch_size

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_head

    @property
    def ffn_hidden(self) -> int:
        return find_multiple(int(2 * (4 * self.dim) / 3), 256)

    @property
    def prefix_len(self) -> int:
        """cls tokens plus query tokens."""
        return self.cls_token_num + self.parallel_num - 1

    @property
    def total_tokens(self) -> int:
        """Input sequence length: prefix + tokens except the last window."""
        return self.prefix_len + self.num_tokens - self.parallel_num


def config_b(**kw) -> ImageNetARConfig:
    return ImageNetARConfig(dim=768, n_layer=24, n_head=12, diff_layers=6,
                            diff_dim=768, diff_adanln_layers=2, **kw)


def config_l(**kw) -> ImageNetARConfig:
    return ImageNetARConfig(dim=1024, n_layer=32, n_head=16, diff_layers=8,
                            diff_dim=1024, diff_adanln_layers=2, **kw)


def config_h(**kw) -> ImageNetARConfig:
    return ImageNetARConfig(dim=1280, n_layer=40, n_head=20, diff_layers=12,
                            diff_dim=1280, diff_adanln_layers=3, **kw)


def config_s(**kw) -> ImageNetARConfig:
    """Small config for tests, not a reference size."""
    return ImageNetARConfig(dim=256, n_layer=4, n_head=4, diff_layers=2,
                            diff_dim=256, diff_adanln_layers=1, **kw)


IMAGENET_MODELS = {"BitDance-B": config_b, "BitDance-L": config_l,
                   "BitDance-H": config_h, "BitDance-S": config_s}


def make_head(cfg: ImageNetARConfig, device=None,
              dtype: torch.dtype = torch.float32) -> DiffHead:
    """The diffusion head: MlpEncoder for 1x, TransEncoder for Nx."""
    parallel = cfg.parallel_num > 1
    return DiffHead(
        ch_target=cfg.token_dim, ch_cond=cfg.dim, ch_latent=cfg.diff_dim,
        depth_latent=cfg.diff_layers, depth_adanln=cfg.diff_adanln_layers,
        time_shift=cfg.time_shift, time_schedule=cfg.time_schedule,
        P_mean=cfg.P_mean, P_std=cfg.P_std, parallel_num=cfg.parallel_num,
        use_swiglu=parallel, attention=parallel, attn_head_dim=64,
        device=device, dtype=dtype)


class _Weight(nn.Module):
    """A module holding one tensor under ``.weight`` (norm gains, tables)."""

    def __init__(self, *shape, device=None, dtype=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(shape, device=device, dtype=dtype))


class Attention(nn.Module):
    def __init__(self, dim: int, device=None, dtype=None):
        super().__init__()
        self.wqkv = nn.Linear(dim, 3 * dim, bias=False, device=device, dtype=dtype)
        self.wo = nn.Linear(dim, dim, bias=False, device=device, dtype=dtype)


class FeedForward(nn.Module):
    def __init__(self, dim: int, hidden: int, device=None, dtype=None):
        super().__init__()
        self.w1 = nn.Linear(dim, 2 * hidden, bias=False, device=device, dtype=dtype)
        self.w2 = nn.Linear(hidden, dim, bias=False, device=device, dtype=dtype)


class Layer(nn.Module):
    def __init__(self, cfg: ImageNetARConfig, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.attention = Attention(cfg.dim, **kw)
        self.attention_norm = _Weight(cfg.dim, **kw)
        self.ffn_norm = _Weight(cfg.dim, **kw)
        self.feed_forward = FeedForward(cfg.dim, cfg.ffn_hidden, **kw)


class SwiGLUProjIn(nn.Module):
    def __init__(self, cin: int, dim: int, device=None, dtype=None):
        super().__init__()
        hidden = int(dim * 1.5)
        self.w1 = nn.Linear(cin, 2 * hidden, device=device, dtype=dtype)
        self.w2 = nn.Linear(hidden, dim, device=device, dtype=dtype)


class ImageNetAR(nn.Module):
    """The AR backbone's parameters (the head is a separate DiffHead)."""

    def __init__(self, cfg: ImageNetARConfig, device=None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        d = cfg.dim
        self.cls_embedding = nn.Embedding(cfg.num_classes + 1,
                                          d * cfg.cls_token_num, **kw)
        self.proj_in = SwiGLUProjIn(cfg.token_dim, d, **kw)
        self.emb_norm = _Weight(d, **kw)
        self.layers = nn.ModuleList([Layer(cfg, **kw) for _ in range(cfg.n_layer)])
        self.norm = _Weight(d, **kw)
        self.pos_for_diff = _Weight(cfg.num_tokens, d, **kw)
        if cfg.parallel_num > 1:
            self.query_token = nn.Parameter(
                torch.empty((cfg.parallel_num - 1, d), **kw))


def init_ar_params(model: ImageNetAR, generator: torch.Generator | None = None,
                   std: float = 0.02) -> ImageNetAR:
    """The JAX package's init: matrices N(0, 0.02), biases 0, norm gains 1."""
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("bias"):
                p.zero_()
            elif p.ndim == 1:
                p.fill_(1.0)
            else:
                p.normal_(0.0, std, generator=generator)
    return model


def proj_in(model: ImageNetAR, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU connector from latent tokens to the model width."""
    p = model.proj_in
    h1, h2 = p.w1(x).chunk(2, dim=-1)
    return p.w2(F.silu(h1) * h2)


def freqs_cis_table(cfg: ImageNetARConfig, device=None) -> torch.Tensor:
    """2D RoPE table of the input sequence [total_tokens, head_dim // 2, 2]:
    identity for the prefix, patch centres for image tokens (ps-raster order
    in parallel mode), without the last parallel_num positions."""
    coords = patch_center_coords_2d(cfg.resolution, cfg.down_size * cfg.patch_size,
                                    device=device)
    table = rope_table_2d(coords, cfg.head_dim, cls_token_num=cfg.prefix_len)
    if cfg.parallel_num > 1:
        ps = int(math.isqrt(cfg.parallel_num))
        patch = table[cfg.prefix_len:]
        hh, ww = cfg.h // ps, cfg.w // ps
        patch = patch.reshape(hh, ps, ww, ps, *patch.shape[1:])
        patch = patch.permute(0, 2, 1, 3, 4, 5).reshape(cfg.num_tokens,
                                                        *table.shape[1:])
        table = torch.cat([table[: cfg.prefix_len], patch], dim=0)
    return table[: -cfg.parallel_num]


def train_ids(cfg: ImageNetARConfig, device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """(block_ids, doc_ids) [total_tokens] int32 of the training mask:
    causal for parallel_num 1; otherwise the first cls_token_num - 1 tokens
    causal, then windows of parallel_num tokens that see each other."""
    total = cfg.total_tokens
    if cfg.parallel_num == 1:
        block = torch.arange(total, dtype=torch.int32)
    else:
        ncausal = cfg.cls_token_num - 1
        block = torch.zeros((total,), dtype=torch.int32)
        block[:ncausal] = torch.arange(ncausal, dtype=torch.int32)
        block[ncausal:] = ncausal + torch.arange(total - ncausal,
                                                 dtype=torch.int32) // cfg.parallel_num
    return block.to(device), torch.zeros((total,), dtype=torch.int32, device=device)


def _attn_full(cfg: ImageNetARConfig, layer: Layer, x: torch.Tensor,
               freqs: torch.Tensor, block_ids: torch.Tensor,
               doc_ids: torch.Tensor, implementation: str = "auto") -> torch.Tensor:
    """One transformer layer over the full sequence."""
    b, s, _ = x.shape
    nh, hd = cfg.n_head, cfg.head_dim
    h = rms_norm(x, layer.attention_norm.weight)
    q, k, v = layer.attention.wqkv(h).split(cfg.dim, dim=-1)
    q = apply_rope_paired(q.reshape(b, s, nh, hd), freqs)
    k = apply_rope_paired(k.reshape(b, s, nh, hd), freqs)
    v = v.reshape(b, s, nh, hd)
    bids = block_ids[None].expand(b, s)
    dids = doc_ids[None].expand(b, s)
    attn = masked_attention(q, k, v, bids, dids, bids, dids,
                            implementation=implementation)
    x = x + layer.attention.wo(attn.reshape(b, s, -1))
    h = rms_norm(x, layer.ffn_norm.weight)
    h1, h2 = layer.feed_forward.w1(h).chunk(2, dim=-1)
    return x + layer.feed_forward.w2(F.silu(h1) * h2)


def ar_backbone(model: ImageNetAR, cfg: ImageNetARConfig, x: torch.Tensor,
                freqs: torch.Tensor, block_ids: torch.Tensor,
                doc_ids: torch.Tensor, remat: bool = False,
                implementation: str = "auto") -> torch.Tensor:
    """All layers; remat recomputes each layer in the backward
    (activation checkpointing, as jax.checkpoint does)."""
    for layer in model.layers:
        if remat:
            x = checkpoint(_attn_full, cfg, layer, x, freqs, block_ids, doc_ids,
                           implementation, use_reentrant=False)
        else:
            x = _attn_full(cfg, layer, x, freqs, block_ids, doc_ids, implementation)
    return x


def forward_train(model: ImageNetAR, head: DiffHead, cfg: ImageNetARConfig,
                  latent_tokens: torch.Tensor, class_id: torch.Tensor,
                  generator: torch.Generator | None = None, train: bool = True,
                  implementation: str = "auto") -> torch.Tensor:
    """Scalar training loss. latent_tokens: [B, num_tokens, token_dim] ±1,
    raster order (ps-raster in parallel mode); class_id: [B] int.

    Draws from ``generator``: the bit-flip uniforms (perturb_rate > 0), the
    class-dropout uniforms, then the head's t and noise."""
    b = latent_tokens.shape[0]
    dev = latent_tokens.device
    x_in = latent_tokens
    if train and cfg.perturb_rate > 0:
        x_in = flip_bits_uniform_prob(x_in, cfg.perturb_rate, generator)
    x = proj_in(model, x_in[:, : -cfg.parallel_num, :])
    if train and cfg.class_dropout_prob > 0:
        drop = torch.rand((b,), generator=generator, device=dev) < cfg.class_dropout_prob
        class_id = torch.where(drop, torch.full_like(class_id, cfg.num_classes),
                               class_id)
    c = model.cls_embedding(class_id).reshape(b, cfg.cls_token_num, cfg.dim)
    parts = [c]
    if cfg.parallel_num > 1:
        parts.append(model.query_token[None].expand(b, -1, -1))
    parts.append(x)
    x = rms_norm(torch.cat(parts, dim=1), model.emb_norm.weight)

    freqs = freqs_cis_table(cfg, device=dev)
    block_ids, doc_ids = train_ids(cfg, device=dev)
    x = ar_backbone(model, cfg, x, freqs, block_ids, doc_ids,
                    remat=train and cfg.grad_checkpointing,
                    implementation=implementation)

    x = rms_norm(x[:, -cfg.num_tokens:, :], model.norm.weight)
    x = x + model.pos_for_diff.weight[None]
    target = latent_tokens.detach()
    if cfg.parallel_num > 1:
        x = x.reshape(-1, cfg.parallel_num, cfg.dim)
        target = target.reshape(-1, cfg.parallel_num, cfg.token_dim)
        reps = (cfg.diff_batch_mul, 1, 1)
    else:
        x = x.reshape(-1, cfg.dim)
        target = target.reshape(-1, cfg.token_dim)
        reps = (cfg.diff_batch_mul, 1)
    return head(target.repeat(*reps), x.repeat(*reps), generator)


def tokens_to_grid(cfg: ImageNetARConfig, tokens: torch.Tensor) -> torch.Tensor:
    """[B, num_tokens, token_dim] -> NHWC latents [B, h, w, latent_dim]
    (inverse of :func:`grid_to_tokens`)."""
    b = tokens.shape[0]
    if cfg.parallel_num > 1:
        ps = int(math.isqrt(cfg.parallel_num))
        hh, ww = cfg.h // ps, cfg.w // ps
        x = tokens.reshape(b, hh, ww, ps, ps, cfg.token_dim).permute(0, 1, 3, 2, 4, 5)
        return x.reshape(b, cfg.h, cfg.w, cfg.token_dim)
    p = cfg.patch_size
    x = tokens.reshape(b, cfg.h, cfg.w, cfg.latent_dim, p, p).permute(0, 1, 4, 2, 5, 3)
    return x.reshape(b, cfg.h * p, cfg.w * p, cfg.latent_dim)


def grid_to_tokens(cfg: ImageNetARConfig, latents: torch.Tensor) -> torch.Tensor:
    """NHWC latents -> [B, num_tokens, token_dim]: ps-raster tiles in
    parallel mode, else patchify with the token's channels (c, p, q)
    channel-major."""
    b, h, w, c = latents.shape
    if cfg.parallel_num > 1:
        ps = int(math.isqrt(cfg.parallel_num))
        x = latents.reshape(b, h // ps, ps, w // ps, ps, c).permute(0, 1, 3, 2, 4, 5)
        return x.reshape(b, h * w, c)
    p = cfg.patch_size
    x = latents.reshape(b, h // p, p, w // p, p, c).permute(0, 1, 3, 5, 2, 4)
    return x.reshape(b, (h // p) * (w // p), c * p * p)
