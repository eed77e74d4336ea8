"""Binary diffusion heads (port of bitdance_tpu/models/diff_head.py).

Two net families, as in the JAX package:
  - TransEncoder (the text-to-image head and the ImageNet Nx heads): window
    attention over the parallel_num tokens, 6 shared adaLN mods per block,
    bounded output unless ``bounded_output`` says otherwise; its MLP half
    SwiGLU, or with ``use_swiglu=False`` the plain mlp.0 -> silu -> mlp.2
    (whose head the whole sampler does not take).
  - MlpEncoder (the ImageNet 1x head): per-token SwiGLU residual blocks,
    3 shared adaLN mods per block, unbounded output.
:meth:`DiffNet.forward` runs either per call: with ``train=True`` (the
flow-matching loss, :meth:`DiffHead.forward`) on plain modules, and at
inference through the head-block kernels (ops/fused_block.py: one
``fused_attn_block`` and one ``fused_mlp_block`` per TransBlock, one
``fused_mlp_block`` per MlpResBlock), as the JAX package takes its Pallas
blocks only when not training. :meth:`DiffHead.sample` sends guided
sampling (cfg_mult 2) of a SwiGLU head to the whole-sampler kernel
(:func:`_run_fused_sample` -> ops/fused_head.py) and anything else to the
per-call
:func:`~bitdance_tpu_torch.models.sampling.euler_maruyama`.

The modules hold the parameters under the reference's state-dict names
(``net.input_proj``, ``net.time_embed.mlp.0``, ``net.res_blocks.{i}.attn.wqkv``
or ``net.res_blocks.{i}.norm``, ``net.ada_ln_blocks.{i}``,
``net.final_layer.ada_ln_modulation`` ...), which
``bitdance_tpu/io/torch_import.py::convert_diffhead_state`` reads. The net
computes in the dtype of the weights it is called with, so casting f32
masters to bf16 for a mixed-precision step makes the head compute in bf16,
as the JAX head does with dtype=bfloat16.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from bitdance_tpu_torch.models.sampling import euler_maruyama, time_shift
from bitdance_tpu_torch.ops.fused_block import fused_attn_block, fused_mlp_block
from bitdance_tpu_torch.ops.fused_head import (
    em_precompute,
    em_sample_stacked,
    fused_em_sample,
    quant_mode,
    stack_diffnet_params,
)
from bitdance_tpu_torch.ops.norms import layer_norm


def timestep_embedding(t: torch.Tensor, dim: int, max_period: float = 10000.0,
                       time_factor: float = 1000.0) -> torch.Tensor:
    """Sinusoidal timestep embedding, cos-first."""
    half = dim // 2
    tf = time_factor * t.float()
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32, device=t.device)
                      / half)
    args = tf[:, None] * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb


class WindowAttention(nn.Module):
    """Non-causal attention over the parallel window, fp32 softmax."""

    def __init__(self, dim: int, n_head: int, device=None, dtype=None):
        super().__init__()
        self.n_head = n_head
        self.wqkv = nn.Linear(dim, 3 * dim, device=device, dtype=dtype)
        self.wo = nn.Linear(dim, dim, device=device, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, dim = x.shape
        hd = dim // self.n_head
        q, k, v = (t.reshape(b, n, self.n_head, hd).float()
                   for t in self.wqkv(x).chunk(3, dim=-1))
        s = torch.einsum("bqhd,bkhd->bhqk", q * hd ** -0.5, k)
        o = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1), v)
        return self.wo(o.reshape(b, n, dim).to(x.dtype))


def _swiglu_half(blk, norm: nn.LayerNorm, x: torch.Tensor, scale, shift, gate,
                 train: bool) -> torch.Tensor:
    """x + w2(silu(h1) * h2) * gate with h = LN(x) * (1 + scale) + shift:
    plain modules in training, the fused_mlp_block kernel otherwise."""
    if train:
        h = layer_norm(x, norm.weight, norm.bias) * (1 + scale) + shift
        h1, h2 = blk.w1(h).chunk(2, dim=-1)
        return x + blk.w2(F.silu(h1) * h2) * gate
    c = x.shape[-1]
    rows = lambda t: t.reshape(-1, c)  # noqa: E731
    return fused_mlp_block(
        rows(x), rows(scale), rows(shift), rows(gate), norm.weight, norm.bias,
        blk.w1.weight, blk.w1.bias, blk.w2.weight, blk.w2.bias,
    ).reshape(x.shape)


class TransBlock(nn.Module):
    """adaLN window-attention + MLP block (6 mods) over [G, W, C] groups of
    window tokens. The MLP half is SwiGLU (``w1``, ``w2``; the
    ``fused_mlp_block`` kernel at inference) or, with ``use_swiglu=False``,
    the plain ``mlp.0`` (C -> 1.5 C) -> silu -> ``mlp.2`` of the JAX block's
    ``mlp_0`` / ``mlp_2`` (plain torch, as the JAX package runs it on XLA).
    The attention half takes ``fused_attn_block`` at inference either way,
    as the JAX block does."""

    def __init__(self, channels: int, n_head: int, use_swiglu: bool = True,
                 device=None, dtype=None):
        super().__init__()
        hidden = int(channels * 1.5)
        kw = dict(device=device, dtype=dtype)
        self.use_swiglu = use_swiglu
        self.norm1 = nn.LayerNorm(channels, eps=1e-6, **kw)
        self.attn = WindowAttention(channels, n_head, **kw)
        self.norm2 = nn.LayerNorm(channels, eps=1e-6, **kw)
        if use_swiglu:
            self.w1 = nn.Linear(channels, 2 * hidden, **kw)
            self.w2 = nn.Linear(hidden, channels, **kw)
        else:
            self.mlp = nn.Sequential(nn.Linear(channels, hidden, **kw), nn.SiLU(),
                                     nn.Linear(hidden, channels, **kw))

    def forward(self, x: torch.Tensor, mods, train: bool = False) -> torch.Tensor:
        scale1, shift1, gate1, scale2, shift2, gate2 = mods
        if train:
            h = layer_norm(x, self.norm1.weight, self.norm1.bias) \
                * (1 + scale1) + shift1
            x = x + self.attn(h) * gate1
        else:
            a = self.attn
            x = fused_attn_block(x, scale1, shift1, gate1, self.norm1.weight,
                                 self.norm1.bias, a.wqkv.weight, a.wqkv.bias,
                                 a.wo.weight, a.wo.bias, a.n_head)
        if not self.use_swiglu:
            h = layer_norm(x, self.norm2.weight, self.norm2.bias) * (1 + scale2) + shift2
            return x + self.mlp(h) * gate2
        return _swiglu_half(self, self.norm2, x, scale2, shift2, gate2, train)


class MlpResBlock(nn.Module):
    """Per-token residual SwiGLU block under 3 adaLN mods (scale, shift,
    gate): x + w2(silu(h1) * h2) * gate, h = LN(x) * (1 + scale) + shift."""

    def __init__(self, channels: int, device=None, dtype=None):
        super().__init__()
        hidden = int(channels * 1.5)
        kw = dict(device=device, dtype=dtype)
        self.norm = nn.LayerNorm(channels, eps=1e-6, **kw)
        self.w1 = nn.Linear(channels, 2 * hidden, **kw)
        self.w2 = nn.Linear(hidden, channels, **kw)

    def forward(self, x: torch.Tensor, mods, train: bool = False) -> torch.Tensor:
        return _swiglu_half(self, self.norm, x, *mods, train)


class FinalLayer(nn.Module):
    def __init__(self, channels: int, out_channels: int, device=None,
                 dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.ada_ln_modulation = nn.Linear(channels, 2 * channels, **kw)
        self.linear = nn.Linear(channels, out_channels, **kw)

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        scale, shift = self.ada_ln_modulation(y).chunk(2, dim=-1)
        return self.linear(layer_norm(x) * (1.0 + scale) + shift)


class TimestepEmbedder(nn.Module):
    def __init__(self, hidden: int, freq_size: int = 256, device=None,
                 dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.freq_size = freq_size
        self.mlp = nn.Sequential(nn.Linear(freq_size, hidden, **kw), nn.SiLU(),
                                 nn.Linear(hidden, hidden, **kw))

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        emb = timestep_embedding(t, self.freq_size)
        return self.mlp(emb.to(self.mlp[0].weight.dtype))


class DiffNet(nn.Module):
    """Shared skeleton: input_proj, time_embed, cond_embed, res_blocks,
    ada_ln_blocks (shared adaLN, switched every num_res_blocks /
    num_ada_ln_blocks blocks), final_layer.

    attention=True  -> TransEncoder (6 mods per block, bounded output)
    attention=False -> MlpEncoder (3 mods per block, unbounded output)
    bounded_output=None means "bounded iff attention".
    """

    def __init__(self, in_channels: int, model_channels: int, z_channels: int,
                 num_res_blocks: int, num_ada_ln_blocks: int = 2,
                 attention: bool = True, bounded_output: bool | None = None,
                 attn_head_dim: int = 128, use_swiglu: bool = True, device=None,
                 dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        c = model_channels
        self.attention = attention
        self.bounded = attention if bounded_output is None else bounded_output
        self.n_mods = 6 if attention else 3
        self.input_proj = nn.Linear(in_channels, c, **kw)
        self.time_embed = TimestepEmbedder(c, **kw)
        self.cond_embed = nn.Linear(z_channels, c, **kw)
        if attention:
            blocks = [TransBlock(c, c // attn_head_dim, use_swiglu, **kw)
                      for _ in range(num_res_blocks)]
        else:
            blocks = [MlpResBlock(c, **kw) for _ in range(num_res_blocks)]
        self.res_blocks = nn.ModuleList(blocks)
        self.ada_ln_blocks = nn.ModuleList(
            [nn.Linear(c, self.n_mods * c, **kw) for _ in range(num_ada_ln_blocks)])
        self.final_layer = FinalLayer(c, in_channels, **kw)
        # recompute each block in the backward (training only): the 14B
        # head's fp32 norm and softmax intermediates at ~30k rows would
        # otherwise hold ~12 GB a block for the backward
        self.grad_checkpointing = False

    def forward(self, x: torch.Tensor, t: torch.Tensor, c: torch.Tensor,
                train: bool = False) -> torch.Tensor:
        """x noisy latents, t [N], c conditioning: [N, C_in] / [N, z] for the
        MlpEncoder, [G, W, C_in] / [G, W, z] (groups of window tokens) for
        the TransEncoder. Computes in the weights' dtype; returns x's dtype.
        ``train`` keeps the plain modules (the kernels have no backward)."""
        dt = self.input_proj.weight.dtype
        h = self.input_proj(x.to(dt))
        t_emb = self.time_embed(t)
        if x.ndim == 3:
            t_emb = t_emb[:, None, :]
        y = F.silu(t_emb + self.cond_embed(c.to(dt)))
        n_blocks, n_ada = len(self.res_blocks), len(self.ada_ln_blocks)
        switch_freq = max(1, n_blocks // n_ada)
        assert n_blocks % switch_freq == 0
        mods = self.ada_ln_blocks[0](y).chunk(self.n_mods, dim=-1)
        for i, blk in enumerate(self.res_blocks):
            if i > 0 and i % switch_freq == 0:
                mods = self.ada_ln_blocks[i // switch_freq](y).chunk(self.n_mods, dim=-1)
            if train and self.grad_checkpointing and torch.is_grad_enabled():
                h = checkpoint(blk, h, mods, train, use_reentrant=False)
            else:
                h = blk(h, mods, train)
        out = self.final_layer(h, y)
        if self.bounded:
            out = 2.0 * torch.sigmoid(out.float()) - 1.0
        return out.to(x.dtype)


def draw_sampler_noise(generator: torch.Generator, half: int, ch: int,
                       num_steps: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """x0 [half, ch] and per-step noise [num_steps, half, ch], fp32, from the
    pipeline's generator. The one place the sampler draws (tests patch it)."""
    x0 = torch.randn((half, ch), generator=generator, device=device)
    noise = torch.randn((num_steps, half, ch), generator=generator, device=device)
    return x0, noise


class DiffHead(nn.Module):
    """Flow-matching x-prediction head: training loss (:meth:`forward`) and
    sampling with CFG by Euler-Maruyama (:meth:`sample`)."""

    def __init__(self, ch_target: int, ch_cond: int, ch_latent: int,
                 depth_latent: int, depth_adanln: int, parallel_num: int = 4,
                 use_swiglu: bool = True, attention: bool = True,
                 P_mean: float = 0.0, P_std: float = 1.0,
                 time_shift: float = 1.0, time_schedule: str = "logit_normal",
                 bounded_output: bool | None = None,
                 attn_head_dim: int = 128, sample_weight_quant: bool | str = False,
                 per_token_loss: bool = False, device=None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.ch_target, self.ch_cond, self.ch_latent = ch_target, ch_cond, ch_latent
        self.depth_latent, self.depth_adanln = depth_latent, depth_adanln
        self.parallel_num = parallel_num
        self.P_mean, self.P_std = P_mean, P_std
        self.time_shift = time_shift
        self.time_schedule = time_schedule
        self.attn_head_dim = attn_head_dim
        self.attention = attention
        # the TransEncoder's MLP family; the MlpEncoder's blocks are SwiGLU
        # whatever it says (JAX _sample_shape_ok)
        self.use_swiglu = use_swiglu
        self.per_token_loss = per_token_loss
        # False, True (int8) or "int4": the format of the block matrices in
        # the sampler's stack (W8A8 / W4A8 sampling); training and the
        # per-call blocks keep the module's weights
        self.sample_weight_quant = sample_weight_quant
        self.net = DiffNet(ch_target, ch_latent, ch_cond, depth_latent,
                           depth_adanln, attention=attention,
                           bounded_output=bounded_output,
                           attn_head_dim=attn_head_dim, use_swiglu=use_swiglu,
                           device=device, dtype=dtype)

    @property
    def bounded(self) -> bool:
        return self.net.bounded

    @property
    def stackable(self) -> bool:
        """Whether the whole-sampler kernels take this head: SwiGLU blocks
        (the MlpEncoder's always are). A plain-MLP TransEncoder samples on
        the per-call route, as JAX's _sample_shape_ok decides."""
        return self.use_swiglu or not self.attention

    def forward(self, x: torch.Tensor, cond: torch.Tensor,
                generator: torch.Generator | None = None,
                draw_rows: tuple[torch.Tensor, int] | None = None) -> torch.Tensor:
        """Flow-matching training loss. x: ±1 targets [N, C] (MlpEncoder) or
        [N, P, C] (TransEncoder, N groups of P window tokens); cond: backbone
        states of the same leading shape. t (one per row of N) is
        logit-normal (P_mean, P_std) or uniform, then time-shifted;
        z = (1-t) e + t x; the net predicts x, the loss is the MSE of the
        implied velocities with 1 - t clamped at 0.05. Draws t then e from
        ``generator``. Scalar, or with ``per_token_loss`` and 3-D x the
        per-token MSE [N, P] (diff_head.py:379-410). ``draw_rows`` (rows [N],
        n) draws t and e for n rows and keeps these N (a data-parallel rank's
        share of a global batch's draws)."""
        xf = x.float()
        rows, n = draw_rows if draw_rows is not None else (None, x.shape[0])
        if self.time_schedule == "logit_normal":
            t = torch.sigmoid(torch.randn((n,), generator=generator, device=x.device)
                              * self.P_std + self.P_mean)
        elif self.time_schedule == "uniform":
            t = torch.rand((n,), generator=generator, device=x.device)
        else:
            raise NotImplementedError(self.time_schedule)
        if self.time_shift != 1.0:
            t = time_shift(t, self.time_shift)
        e = torch.randn((n,) + xf.shape[1:], generator=generator, device=x.device)
        if rows is not None:
            t, e = t[rows], e[rows]
        ti = t.reshape((-1,) + (1,) * (xf.ndim - 1))
        z = (1.0 - ti) * e + ti * xf
        denom = (1.0 - ti).clamp_min(0.05)
        v = (xf - z) / denom
        x_pred = self.net(z.to(self.net.input_proj.weight.dtype), t, cond,
                          train=True)
        v_pred = (x_pred.float() - z) / denom
        sq = (v - v_pred).square()
        if self.per_token_loss and sq.ndim == 3:
            return sq.mean(dim=2)
        return sq.mean()

    @torch.no_grad()
    def sample(self, cond: torch.Tensor, generator: torch.Generator | None,
               cfg: float, num_sampling_steps: int, cfg_mult: int,
               stacked: dict | None = None) -> torch.Tensor:
        """Euler-Maruyama sampling conditioned on ``cond`` (rows [cond;
        uncond] when cfg_mult is 2).

        cfg_mult 2 on a :attr:`stackable` head runs the whole-sampler
        kernel (:func:`_run_fused_sample`)
        on ``stacked`` (stacked here when not given, its block matrices
        quantized as ``sample_weight_quant`` says: the JAX package's
        make_fused_sampler / _can_fuse_sample route, W8A8 / W4A8 on a
        quantized stack); anything else runs the per-call
        :func:`euler_maruyama` over :meth:`DiffNet.forward`, whose blocks
        are the head-block kernels on the module's full-precision weights
        (in JAX only the stacked sampler reads the quantized stack). Both
        draw x0 and the per-step noise through :func:`draw_sampler_noise`."""
        if cfg_mult == 2 and self.stackable:
            if stacked is None:
                stacked = self._stack_for_sampler()
            return _run_fused_sample(self, stacked, cond, generator, cfg,
                                     num_sampling_steps)
        return self.sample_per_call(cond, generator, cfg, num_sampling_steps,
                                    cfg_mult)

    @torch.no_grad()
    def sample_per_call(self, cond: torch.Tensor,
                        generator: torch.Generator | None, cfg: float,
                        num_sampling_steps: int, cfg_mult: int) -> torch.Tensor:
        """:func:`euler_maruyama` over the per-call net forward, any
        cfg_mult, with the whole sampler's draws (same generator, same
        values in the same row order)."""
        x_shape = [cond.shape[0] // cfg_mult, *cond.shape[1:-1], self.ch_target]
        half = math.prod(x_shape[:-1])
        x0, noise = draw_sampler_noise(generator, half, self.ch_target,
                                       num_sampling_steps, cond.device)
        return euler_maruyama(
            self.net, cond, None, self.ch_target, cfg=cfg, cfg_mult=cfg_mult,
            num_sampling_steps=num_sampling_steps, flow_shift=self.time_shift,
            x_init=x0.reshape(x_shape),
            noise=noise.reshape(num_sampling_steps, *x_shape))

    def _stack_for_sampler(self) -> dict | None:
        """The sampler's stacked weights, quantized per
        ``sample_weight_quant``. Unquantized, the module's block and adaLN
        weights become views into them, so the device holds one copy. None
        for a head the whole sampler does not take (:attr:`stackable`)."""
        if not self.stackable:
            return None
        dtype = self.net.input_proj.weight.dtype
        stacked = stack_diffnet_params(
            self.net, self.depth_latent,
            dtype=torch.bfloat16 if dtype == torch.bfloat16 else torch.float32,
            quant=self.sample_weight_quant)
        if stacked["w1"].dtype == dtype:
            _share_stacked_storage(self.net, self.depth_latent, stacked)
        return stacked


def _quant_itemsize(sample_weight_quant) -> float:
    """Bytes per block-matrix weight in the sampler's stack: 2 (bf16), 1
    (int8) or 0.5 (packed int4)."""
    return {None: 2, "int8": 1, "int4": 0.5}[quant_mode(sample_weight_quant)]


def _share_stacked_storage(net: DiffNet, num_blocks: int, stacked: dict) -> None:
    """Point the per-block and adaLN parameters of ``net`` at the matching
    slices of ``stacked`` (same values and dtype), freeing their own copies."""
    pairs = []
    for i, b in enumerate(net.res_blocks[:num_blocks]):
        linears = [(b.w1, "1"), (b.w2, "2")]
        norm2 = b.norm2 if net.attention else b.norm
        pairs += [(norm2.weight, stacked["n2"][i, 0]),
                  (norm2.bias, stacked["n2"][i, 1])]
        if net.attention:
            pairs += [(b.norm1.weight, stacked["n1"][i, 0]),
                      (b.norm1.bias, stacked["n1"][i, 1])]
            linears += [(b.attn.wqkv, "qkv"), (b.attn.wo, "o")]
        for lin, key in linears:
            pairs += [(lin.weight, stacked["w" + key][i]),
                      (lin.bias, stacked["b" + key][i])]
    row = 0
    for lin in [*net.ada_ln_blocks, net.final_layer.ada_ln_modulation]:
        n = lin.weight.shape[0]
        pairs.append((lin.weight, stacked["modcat_w"][row:row + n]))
        row += n
    for p, view in pairs:
        p.data = view


# the head-major sampler's mods chunk (the JAX stacked route's 256 MB)
MODS_CHUNK_BYTES = 256 * 1024 * 1024


def _run_fused_sample(head: DiffHead, stacked: dict, cond: torch.Tensor,
                      generator: torch.Generator, cfg: float,
                      num_sampling_steps: int) -> torch.Tensor:
    """Whole-sampler invocation from pre-stacked weights. cond is [G, W, z]
    (TransEncoder: G = 2n groups of W window tokens; returns [n, W, ch]) or
    [R, z] (MlpEncoder: R = 2n independent rows, one group; returns
    [n, ch]).

    Kernel #2's route (a canonical stack) precomputes the mods of all
    timesteps in one product per AR step ([51, 128, 71680] bf16 per image
    at the 14B head, 0.94 GB), which fits the card, so the step-chunking the
    JAX package's kernel route needs for a 16 GB chip is not used there
    (fused_em_sample still supports final_chunk=False). A head-major stack
    (``"hm_marker"``, parallel/tp.py) runs ``em_sample_stacked``, the
    tensor-parallel sampler, as the JAX package routes it away from its
    kernel, with the JAX route's choices (diff_head.py:583-603): the mods in
    ``mods_chunks`` chunks, the first of the step count's divisors 2, 5, 10,
    25 that brings a chunk to 256 MB (5 at the 14B head's 50 steps), and
    bf16 glue for a quantized stack (fp32 otherwise)."""
    if head.attention:
        g_all, w, _ = cond.shape
    else:
        g_all, w = 1, cond.shape[0]
    rows = g_all * w if head.attention else cond.shape[0]
    half = rows // 2
    last_step = 0.05
    # c_emb in fp32 (cond_w upcast), as the JAX package computes it
    c_emb = cond.reshape(rows, -1).float() @ stacked["cond_w"].float().t() \
        + stacked["cond_b"]
    t_all = torch.linspace(0.0, 1.0 - last_step, num_sampling_steps + 1)
    t_all = time_shift(t_all, head.time_shift).float()
    dt_all = torch.cat([t_all[1:] - t_all[:-1], torch.zeros(1)])
    x0, noise = draw_sampler_noise(generator, half, head.ch_target,
                                   num_sampling_steps, cond.device)
    common = dict(num_blocks=head.depth_latent, num_ada=head.depth_adanln,
                  n_head=head.ch_latent // head.attn_head_dim, groups=g_all,
                  attention=head.attention, bounded=head.bounded,
                  last_step_size=last_step, quant=head.sample_weight_quant)
    mods_dtype = stacked["in_w"].dtype
    if "hm_marker" in stacked:
        # tensor-parallel serving (parallel/tp.py) routes away from kernel #2
        # to the stacked sampler, as the JAX package does
        mods_bytes = (num_sampling_steps + 1) * rows * stacked["modcat_w"].shape[0] \
            * mods_dtype.itemsize
        mods_chunks = 1
        for d in (2, 5, 10, 25):
            if mods_bytes // mods_chunks <= MODS_CHUNK_BYTES:
                break
            if num_sampling_steps % d == 0:
                mods_chunks = d
        glue = torch.bfloat16 if "w1_s" in stacked else torch.float32
        out = em_sample_stacked(stacked, x0, noise, None, t_all, dt_all, cfg, c_emb=c_emb,
                                mods_chunks=mods_chunks, glue_dtype=glue, **common)
    else:
        allmods = em_precompute(stacked, c_emb, t_all, out_dtype=mods_dtype)
        out = fused_em_sample(stacked, x0, noise, allmods, t_all, dt_all, cfg, **common)
    if head.attention:
        return out.reshape(g_all // 2, w, head.ch_target)
    return out


def make_fused_sampler(head: DiffHead, stacked: dict | None = None):
    """A sampling closure over weights stacked once, outside the AR loop
    (here, when ``stacked`` is not given).

    sample_fn(cond, generator, cfg, num_sampling_steps, cfg_mult) ->
    latents, by :meth:`DiffHead.sample`."""
    if stacked is None:
        stacked = head._stack_for_sampler()

    def sample_fn(cond, generator, cfg, num_sampling_steps, cfg_mult):
        return head.sample(cond, generator, cfg, num_sampling_steps,
                           cfg_mult=cfg_mult, stacked=stacked)

    return sample_fn
