"""ImageNet class-conditional AR models: training forward and KV-cached
sampling (port of bitdance_tpu/models/imagenet_ar.py: configs, make_head,
proj_in, freqs_cis_table, train_ids, _attn_full (Layer.forward), ar_backbone,
forward_train, quantize_ar_params, _init_cache, _quant_rows, _forward_cached,
sample, grid_to_tokens / tokens_to_grid).

Llama-style pre-RMSNorm blocks with fused QKV, paired 2D RoPE over patch
centres, SwiGLU FFN, class-embedding prefix tokens, learned query tokens for
parallel prediction, and a flow-matching diffusion head. The module keeps the
reference state-dict names that
``bitdance_tpu/io/torch_import.py::convert_imagenet_ar_state`` reads
(``cls_embedding.weight``, ``layers.{i}.attention.wqkv.weight`` ...), one
module per layer where the JAX package stacks them. Training attention goes
through ``ops/attention.py::masked_attention``: the flash kernels on the
card. Sampling attention is plain torch (``attention_xla``), as it is plain
XLA in the JAX package; the head samples through DiffHead.sample (the
whole-sampler kernel when guided, the head-block kernels per call when not).

Quantized sampling, as in the JAX package: :func:`quantize_ar_params` makes
the backbone's four layer products W8A8 (``ops/int8.py``; plain torch, as
they are plain XLA there), ``sample(kv_int8=True)`` keeps the KV cache in
int8 with a scale per (position, head), and ``make_head(...,
sample_weight_quant=True / "int4")`` gives a head whose guided sampler runs
its block products W8A8 / W4A8 (the whole-sampler kernel's quant modes).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from bitdance_tpu_torch.models.diff_head import DiffHead, make_fused_sampler
from bitdance_tpu_torch.models.qwen3 import QLinear
from bitdance_tpu_torch.ops.attention import attention_xla, masked_attention
from bitdance_tpu_torch.ops.int8 import int8_matmul, true_div
from bitdance_tpu_torch.ops.norms import rms_norm
from bitdance_tpu_torch.ops.quantize import flip_bits_uniform_prob
from bitdance_tpu_torch.ops.rotary import (
    apply_rope_paired,
    patch_center_coords_2d,
    rope_table_2d,
)
from bitdance_tpu_torch.utils.precision import full_fp32
from bitdance_tpu_torch.utils.timing import PhaseTimer


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


def head_kwargs(cfg: ImageNetARConfig) -> dict:
    """DiffHead arguments of the model's head: MlpEncoder for 1x,
    TransEncoder (SwiGLU, head dim 64) for Nx; both unbounded."""
    parallel = cfg.parallel_num > 1
    return dict(
        ch_target=cfg.token_dim, ch_cond=cfg.dim, ch_latent=cfg.diff_dim,
        depth_latent=cfg.diff_layers, depth_adanln=cfg.diff_adanln_layers,
        time_shift=cfg.time_shift, time_schedule=cfg.time_schedule,
        P_mean=cfg.P_mean, P_std=cfg.P_std, parallel_num=cfg.parallel_num,
        use_swiglu=parallel, attention=parallel, bounded_output=False,
        attn_head_dim=64)


def make_head(cfg: ImageNetARConfig, device=None,
              dtype: torch.dtype = torch.float32,
              sample_weight_quant: bool | str = False) -> DiffHead:
    """The diffusion head: MlpEncoder for 1x, TransEncoder for Nx.
    sample_weight_quant (True: int8, "int4": packed int4) quantizes the
    block matrices of the guided sampler's stack (W8A8 / W4A8 products);
    the per-call route keeps the module's own weights."""
    return DiffHead(**head_kwargs(cfg), sample_weight_quant=sample_weight_quant,
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
        self.n_head = cfg.n_head
        self.attention = Attention(cfg.dim, **kw)
        self.attention_norm = _Weight(cfg.dim, **kw)
        self.ffn_norm = _Weight(cfg.dim, **kw)
        self.feed_forward = FeedForward(cfg.dim, cfg.ffn_hidden, **kw)

    def forward(self, x: torch.Tensor, freqs: torch.Tensor, block_ids: torch.Tensor,
                doc_ids: torch.Tensor, implementation: str = "auto") -> torch.Tensor:
        """One transformer layer over the full sequence x [B, S, dim] (the
        JAX package's _attn_full); called as a module so that FSDP's hooks
        gather its weights."""
        b, s, dim = x.shape
        nh = self.n_head
        hd = dim // nh
        h = rms_norm(x, self.attention_norm.weight)
        q, k, v = self.attention.wqkv(h).split(dim, dim=-1)
        q = apply_rope_paired(q.reshape(b, s, nh, hd), freqs)
        k = apply_rope_paired(k.reshape(b, s, nh, hd), freqs)
        v = v.reshape(b, s, nh, hd)
        bids = block_ids[None].expand(b, s)
        dids = doc_ids[None].expand(b, s)
        attn = masked_attention(q, k, v, bids, dids, bids, dids,
                                implementation=implementation)
        x = x + self.attention.wo(attn.reshape(b, s, -1))
        h = rms_norm(x, self.ffn_norm.weight)
        h1, h2 = self.feed_forward.w1(h).chunk(2, dim=-1)
        return x + self.feed_forward.w2(F.silu(h1) * h2)


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


# the layer products quantize_ar_params makes W8A8: (parent, name) in a Layer
_AR_QUANT_PRODUCTS = (("attention", "wqkv"), ("attention", "wo"),
                      ("feed_forward", "w1"), ("feed_forward", "w2"))


def quantized_ar_structure_(model: ImageNetAR, fill: bool = False) -> ImageNetAR:
    """Replace wqkv, wo and the FFN's w1, w2 of every layer by int8
    :class:`QLinear` modules, one at a time (each float weight can be freed
    as its replacement lands). fill=True quantizes each replaced weight into
    its module; otherwise they are left to be loaded (a JAX QTensor tree)."""
    for layer in model.layers:
        for part, name in _AR_QUANT_PRODUCTS:
            parent = getattr(layer, part)
            lin = getattr(parent, name)
            new = QLinear(lin.in_features, lin.out_features, device=lin.weight.device)
            if fill:
                new.fill_(lin.weight.detach())
            setattr(parent, name, new)
    return model


def quantize_ar_params(model: ImageNetAR) -> ImageNetAR:
    """Int8-quantize the backbone's layer products for sampling, IN PLACE
    and layer by layer (the JAX quantize_ar_params): wqkv, wo, ffn w1 and w2
    become W8A8 QLinear modules (per-output-column int8 weights, activations
    quantized per row at the product, ``ops/int8.py``). Norm gains, the
    class embedding, proj_in, pos_for_diff and query_token stay as they are.
    Training paths keep full-precision weights."""
    return quantized_ar_structure_(model, fill=True)


def _linear(x: torch.Tensor, lin: nn.Module) -> torch.Tensor:
    """lin(x) in x's dtype: fp32 activations promote bf16 weights to fp32, as
    a JAX product of an fp32 array with bf16 weights does; a QLinear runs
    W8A8 (``ops/int8.py::int8_matmul``, ``mm`` of the JAX package)."""
    if isinstance(lin, QLinear):
        return int8_matmul(x, lin.weight_q)
    w = lin.weight.to(x.dtype)
    return F.linear(x, w, None if lin.bias is None else lin.bias.to(x.dtype))


def proj_in(model: ImageNetAR, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU connector from latent tokens to the model width, in x's dtype
    (the sampler feeds it fp32 tokens, as the JAX package does)."""
    p = model.proj_in
    h1, h2 = _linear(x, p.w1).chunk(2, dim=-1)
    return _linear(F.silu(h1) * h2, p.w2)


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


def ar_backbone(model: ImageNetAR, cfg: ImageNetARConfig, x: torch.Tensor,
                freqs: torch.Tensor, block_ids: torch.Tensor,
                doc_ids: torch.Tensor, remat: bool = False,
                implementation: str = "auto") -> torch.Tensor:
    """All layers; remat recomputes each layer in the backward
    (activation checkpointing, as jax.checkpoint does)."""
    args = (freqs, block_ids, doc_ids, implementation)
    for layer in model.layers:
        if remat:
            x = checkpoint(layer, x, *args, use_reentrant=False)
        else:
            x = layer(x, *args)
    return x


def forward_train(model: ImageNetAR, head: DiffHead, cfg: ImageNetARConfig,
                  latent_tokens: torch.Tensor, class_id: torch.Tensor,
                  generator: torch.Generator | None = None, train: bool = True,
                  implementation: str = "auto",
                  batch_rows: tuple[int, int] | None = None) -> torch.Tensor:
    """Scalar training loss. latent_tokens: [B, num_tokens, token_dim] ±1,
    raster order (ps-raster in parallel mode); class_id: [B] int.

    Draws from ``generator``: the bit-flip uniforms (perturb_rate > 0), the
    class-dropout uniforms, then the head's t and noise. ``batch_rows``
    (first, global batch) says that these B rows are rows [first, first + B)
    of a global batch: every draw is made at the global batch's shape and
    these rows keep theirs, so a data-parallel rank computes what one
    process computes on the whole batch."""
    b = latent_tokens.shape[0]
    dev = latent_tokens.device
    first, n_global = batch_rows if batch_rows is not None else (0, b)
    x_in = latent_tokens
    if train and cfg.perturb_rate > 0:
        x_in = flip_bits_uniform_prob(x_in, cfg.perturb_rate, generator,
                                      batch_rows=batch_rows)
    x = proj_in(model, x_in[:, : -cfg.parallel_num, :])
    if train and cfg.class_dropout_prob > 0:
        u = torch.rand((n_global,), generator=generator, device=dev)[first:first + b]
        class_id = torch.where(u < cfg.class_dropout_prob,
                               torch.full_like(class_id, cfg.num_classes), class_id)
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
    if batch_rows is None:
        return head(target.repeat(*reps), x.repeat(*reps), generator)
    # the head's rows are diff_batch_mul copies of [image, token]: copy k of
    # image i, token j is row (k * n_global + i) * per + j globally
    per = x.shape[0] // b
    copies = torch.arange(cfg.diff_batch_mul, device=dev)[:, None] * (n_global * per)
    idx = (copies + first * per + torch.arange(b * per, device=dev)[None]).reshape(-1)
    return head(target.repeat(*reps), x.repeat(*reps), generator,
                draw_rows=(idx, cfg.diff_batch_mul * n_global * per))


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


# ---------------------------------------------------------------------------
# KV-cached sampling
# ---------------------------------------------------------------------------

def _init_cache(cfg: ImageNetARConfig, batch: int, dtype=torch.float32,
                device=None, int8: bool = False) -> dict:
    """k/v buffers [L, B, prefix_len + num_tokens, H, D] in ``dtype``; int8
    stores them as int8 with fp32 scales "ks" / "vs" [L, B, len, H], one per
    (position, head)."""
    total = cfg.prefix_len + cfg.num_tokens
    shape = (cfg.n_layer, batch, total, cfg.n_head, cfg.head_dim)
    dt = torch.int8 if int8 else dtype
    cache = {"k": torch.zeros(shape, dtype=dt, device=device),
             "v": torch.zeros(shape, dtype=dt, device=device)}
    if int8:
        for key in ("ks", "vs"):
            cache[key] = torch.zeros(shape[:-1], dtype=torch.float32, device=device)
    return cache


def _quant_rows(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """[B, S, H, D] -> (int8 values, fp32 scales [B, S, H]): symmetric per
    (position, head) over D, as the JAX cache quantizer: s = max(amax, 1e-8)
    / 127, q = clamp(round(x / s), -127, 127) with true divisions and round
    half to even."""
    xf = x.float()
    s = true_div(xf.abs().amax(dim=-1).clamp_min(1e-8), 127.0)
    q = torch.clamp(torch.round(xf / s[..., None]), -127, 127).to(torch.int8)
    return q, s


def _forward_cached(model: ImageNetAR, cfg: ImageNetARConfig, x: torch.Tensor,
                    freqs_slice: torch.Tensor, cache: dict, cache_len: int,
                    causal_block: bool) -> tuple[torch.Tensor, dict]:
    """Cached forward of s new tokens at positions cache_len.. (written into
    ``cache`` in place). causal_block: each new token sees the keys up to
    itself (prefill); otherwise the new tokens see every cached key and each
    other (a decode window). Attention reads only the live prefix
    [:cache_len + s]; the JAX package reads a static window whose dead tail
    is masked out, which gives the same result. An int8 cache
    (:func:`_init_cache`) stores k and v quantized by :func:`_quant_rows`
    and is read dequantized to fp32 (k * ks, v * vs), as in JAX."""
    b, s, _ = x.shape
    nh, hd = cfg.n_head, cfg.head_dim
    end = cache_len + s
    int8 = cache["k"].dtype == torch.int8
    mask = None
    if causal_block:
        q_abs = cache_len + torch.arange(s, device=x.device)
        mask = (torch.arange(end, device=x.device)[None, :]
                <= q_abs[:, None])[None, None]
    x = rms_norm(x, model.emb_norm.weight)
    for li, layer in enumerate(model.layers):
        h = rms_norm(x, layer.attention_norm.weight)
        q, k, v = _linear(h, layer.attention.wqkv).split(cfg.dim, dim=-1)
        q = apply_rope_paired(q.reshape(b, s, nh, hd), freqs_slice)
        k = apply_rope_paired(k.reshape(b, s, nh, hd), freqs_slice)
        v = v.reshape(b, s, nh, hd)
        if int8:
            (k, ks), (v, vs) = _quant_rows(k), _quant_rows(v)
            cache["ks"][li, :, cache_len:end] = ks
            cache["vs"][li, :, cache_len:end] = vs
        cache["k"][li, :, cache_len:end] = k
        cache["v"][li, :, cache_len:end] = v
        k_all, v_all = cache["k"][li, :, :end], cache["v"][li, :, :end]
        if int8:
            k_all = k_all.float() * cache["ks"][li, :, :end][..., None]
            v_all = v_all.float() * cache["vs"][li, :, :end][..., None]
        attn = attention_xla(q, k_all, v_all, mask)
        x = x + _linear(attn.to(x.dtype).reshape(b, s, -1), layer.attention.wo)
        h = rms_norm(x, layer.ffn_norm.weight)
        h1, h2 = _linear(h, layer.feed_forward.w1).chunk(2, dim=-1)
        x = x + _linear(F.silu(h1) * h2, layer.feed_forward.w2)
    return rms_norm(x, model.norm.weight), cache


def sample_freqs(cfg: ImageNetARConfig, device=None) -> torch.Tensor:
    """RoPE table of the whole sampled sequence [prefix_len + num_tokens,
    head_dim // 2, 2] (ps-raster order for parallel_num > 1)."""
    coords = patch_center_coords_2d(cfg.resolution, cfg.down_size * cfg.patch_size,
                                    device=device)
    freqs = rope_table_2d(coords, cfg.head_dim, cls_token_num=cfg.prefix_len)
    p = cfg.parallel_num
    if p > 1:
        ps = int(math.isqrt(p))
        patch = freqs[cfg.prefix_len:]
        hh, ww = cfg.h // ps, cfg.w // ps
        patch = patch.reshape(hh, ps, ww, ps, *patch.shape[1:])
        patch = patch.permute(0, 2, 1, 3, 4, 5).reshape(cfg.num_tokens,
                                                        *freqs.shape[1:])
        freqs = torch.cat([freqs[: cfg.prefix_len], patch], dim=0)
    return freqs


def _sign(pred: torch.Tensor) -> torch.Tensor:
    """sign with 0 -> +1."""
    s = torch.sign(pred)
    return torch.where(s == 0, torch.ones_like(s), s)


@torch.no_grad()
def sample(model: ImageNetAR, head: DiffHead, cfg: ImageNetARConfig,
           class_ids: torch.Tensor, generator: torch.Generator | None,
           num_sampling_steps: int = 100, cfg_scale: float = 1.0,
           cfg_schedule: str = "linear", head_sampler=None,
           timing: dict | None = None, kv_int8: bool = False) -> torch.Tensor:
    """Generate ±1 latent tokens [n, num_tokens, token_dim] for class_ids [n].

    cfg_scale > 1 samples rows [cond; null class] with guidance growing
    linearly over the AR steps (cfg_schedule "linear"), and the head runs
    the whole-sampler kernel; cfg_scale 1 samples the n rows alone, the head
    per call. ``head_sampler`` is a :func:`make_fused_sampler` closure (pass
    one over the head's stacked weights to stack them once for many
    batches; the default stacks them here) or a function of the same
    signature. The head draws from ``generator`` once per AR step. With a
    ``timing`` dict, its keys prefill, decode (the backbone's AR steps) and
    sampler are set to seconds (CUDA events on the card). kv_int8 keeps the
    KV cache in int8 with per-(position, head) scales (:func:`_init_cache`).

    Decode steps feed the sampled tokens back as fp32, as the JAX package
    does: proj_in and the cached backbone then run in fp32 on the weights
    (fp32 activations, bf16 KV cache for a bf16 model), while the prefill
    runs in the weights' dtype."""
    full_fp32()
    dev = class_ids.device
    use_cfg = cfg_scale > 1.0
    cfg_mult = 2 if use_cfg else 1
    cond = (torch.cat([class_ids, torch.full_like(class_ids, cfg.num_classes)])
            if use_cfg else class_ids)
    b2, n, p = cond.shape[0], class_ids.shape[0], cfg.parallel_num
    num_steps = cfg.num_tokens // p
    seq_len = num_steps if p > 1 else cfg.num_tokens
    freqs = sample_freqs(cfg, device=dev)
    c = model.cls_embedding(cond).reshape(b2, cfg.cls_token_num, cfg.dim)
    dtype = c.dtype
    cache = _init_cache(cfg, b2, dtype=dtype, device=dev, int8=kv_int8)
    sampler = head_sampler or make_fused_sampler(head)
    phase = PhaseTimer(dev)

    def head_sample(x: torch.Tensor, step: int) -> torch.Tensor:
        """x [b2, p, dim] -> ±1 tokens [n, p, token_dim] (fp32)."""
        x = x + model.pos_for_diff.weight[step * p:(step + 1) * p][None]
        if cfg_schedule == "linear" and use_cfg:     # fp32, as in JAX
            cfg_iter = float(np.float32(1.0) + np.float32(cfg_scale - 1.0)
                             * np.float32(step) / np.float32(seq_len))
        else:
            cfg_iter = float(cfg_scale)
        if p == 1:
            x = x.reshape(-1, cfg.dim)
        with phase("sampler"):
            pred = sampler(x, generator, cfg_iter, num_sampling_steps,
                           cfg_mult=cfg_mult)
        return _sign(pred).reshape(n, p, cfg.token_dim)

    with phase("prefill"):
        if p > 1:
            # the cls tokens causal, the last window (last cls token and the
            # query tokens) bidirectional
            prefix = torch.cat([c, model.query_token[None].expand(b2, -1, -1)], 1)
            ncausal = cfg.cls_token_num - 1
            _forward_cached(model, cfg, prefix[:, :ncausal], freqs[:ncausal],
                            cache, 0, True)
            x, _ = _forward_cached(model, cfg, prefix[:, ncausal:],
                                   freqs[ncausal:cfg.prefix_len], cache,
                                   ncausal, False)
        else:
            x, _ = _forward_cached(model, cfg, c, freqs[:cfg.cls_token_num],
                                   cache, 0, True)
            x = x[:, -1:]
    preds = [head_sample(x[:, -p:], 0)]
    for step in range(1, num_steps):
        with phase("decode"):
            emb = proj_in(model, preds[-1])
            emb = torch.cat([emb] * cfg_mult, dim=0)
            start = cfg.prefix_len + (step - 1) * p
            x, _ = _forward_cached(model, cfg, emb, freqs[start:start + p],
                                   cache, start, False)
        preds.append(head_sample(x[:, -p:], step))
    if timing is not None:
        timing.clear()
        timing.update(phase.totals())
    out = torch.stack(preds, dim=1)                     # [n, steps, p, td]
    return out.reshape(n, cfg.num_tokens, cfg.token_dim)


@torch.no_grad()
def decode_uint8(ae, cfg: ImageNetARConfig, tokens: torch.Tensor) -> torch.Tensor:
    """±1 tokens [n, num_tokens, token_dim] -> uint8 images [n, H, W, 3]
    through the VQ decoder (eval/fid.py's run_decode: clip(127.5 * img +
    128)), 8 images at a time to bound the decoder's activations."""
    full_fp32()
    grid = tokens_to_grid(cfg, tokens)
    out = []
    for i in range(0, grid.shape[0], 8):
        img = ae.decode(grid[i:i + 8]).float()
        out.append(torch.clamp(127.5 * img + 128.0, 0, 255).to(torch.uint8))
    return torch.cat(out, dim=0)


@dataclasses.dataclass
class ImageNetSampler:
    """What class-conditional sampling needs: the backbone, the head with
    its sampler stack (the head's block weights are views into it), and the
    VQ decoder (a VQModel)."""

    cfg: ImageNetARConfig
    model: ImageNetAR
    head: DiffHead
    head_stacked: dict
    ae: nn.Module
