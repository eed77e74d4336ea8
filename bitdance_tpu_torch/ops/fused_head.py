"""The diffusion head's whole Euler-Maruyama sampler.

Port of bitdance_tpu/ops/fused_head.py for the bf16 path: the stacked weight
layout (:func:`stack_diffnet_params`), the per-AR-step mods precompute
(:func:`em_precompute`), the plain sampler (:func:`fused_em_sample_reference`,
with :func:`em_sample_stacked` as the JAX twin's counterpart) and the kernel
wrapper :func:`fused_em_sample` (``csrc/fused_head.cu``), which CPU tensors
send to the plain version. Both head families: ``attention=True``, the
TransEncoder (6 mods per block, window attention), and ``attention=False``,
the MlpEncoder (3 mods per block, no attention half); ``bounded`` applies
2*sigmoid-1 to the net's output (the T2I head; the ImageNet heads are
unbounded).

Stacked layout: the block matrices keep the torch Linear layout [out, in]
per block, stacked on a leading block axis (the JAX package stores [in, out]):
  wqkv [L, 3C, C]  bqkv [L, 3C]   wo [L, C, C]  bo [L, C]   (attention only)
  w1   [L, 2H, C]  b1   [L, 2H]   w2 [L, C, H]  b2 [L, C]
  n1 [L, 2, C] (attention only), n2 [L, 2, C] (LayerNorm weight; bias; the
  MlpEncoder's one norm is n2)
  modcat_w [A*m*C + 2C, C], modcat_b: every ada group's projection and
  the final layer's, concatenated, so one product per AR step gives all mods.
allmods rows are [ada_0 mods | ada_1 mods | ... | final scale, shift]; within
an ada group the m = 6 slices are scale1, shift1, gate1, scale2, shift2, gate2
(m = 3 for the MlpEncoder: scale, shift, gate).

Quantized stacks (``quant=True``: int8, ``quant="int4"``: packed int4; the
JAX package's W8A8 / W4A8 sampler, both head families): the block
matrices are stored per output row, wqkv [L, 3C, C] int8 or [L, 3C, C/2]
packed (k, k + C/2), with f32 scales wqkv_s [L, 3C] (likewise wo, w1, w2);
modcat_w is int8 with modcat_w_s whatever the block format. Each stage's
input is quantized per row to int8 once (``quantize_rows``) and each
product runs s8 x s8 -> s32 with the scales applied to the sum, on the
head GEMM's integer kinds (:func:`head_gemm_s8`, with
:func:`head_gemm_s8_split_plain` its plain twin, through which the plain
quant sampler runs). The mode reaches the sampler as an explicit ``quant``
argument, not from the stored shapes.

Residual precision (:func:`rounds_residual`): the JAX package routes its
whole sampler by weight bytes, and the routes round differently. Kernels #3
and #4 (per-block and resident weights; the ImageNet heads, bf16 or
quantized) run ``_block_body``, which carries the residual h and every
elementwise stage in the weights' dtype, a quantized stack quantizing each
product's rounded input (``_mmq``); kernel #2 (streamed weights; the 14B
head, bf16 or quantized) keeps h in fp32. The port applies the same rule to
the same stack, in its plain version and in ``csrc/fused_head.cu``.

A bf16 stack, on either route (kernel #2's fp32 residual, or the ImageNet
heads' kernels #3/#4, ``round_residual``), runs its block products on the
head GEMM of ``csrc/head_gemm.cuh``: :func:`head_gemm_plan` picks each
product's tile and split-K count (:func:`sampler_plans` for a whole block),
:func:`head_gemm` launches one product alone (its checks and timings), and
:func:`head_gemm_split_plain` is the plain twin of a split product (fp32
partials over the planned K ranges, summed in split order, then the
route's epilogue); ``fused_em_sample_reference(splits=...)`` runs the whole
plain sampler on it.

Head-major stacks (parallel/tp.py::reorder_stacked_head_major, marked by
an ``"hm_marker"`` entry, as the JAX package marks them): qkv's
out-features in (n_head, 3, hd) order and w1's in (n_head, 2, H / n_head),
so a share of out-features holds whole heads. ``em_sample_stacked`` on
such a stack is the tensor-parallel sampler (:func:`_net_forward_tp`; on
one device a pure permutation, which samples bit for bit as the canonical
stack does with the head GEMM's splits): with a ``"tp"`` entry
(parallel/tp.py::shard_head_stacked) each rank holds its shares of the
block products, runs every one on the head GEMM (:func:`head_gemm`,
"out_f32"; a quantized stack :func:`head_gemm_s8`, "out_s32"; on the CPU
their split twins) and all-reduces a row-parallel product's sums (fp32, or
int32 before the scales) before the bias, gate and residual, which stay
torch as the rest of the glue does. A quantized head-major stack samples
with bf16 glue, as the JAX package serves it (``glue_dtype``), and its
mods may be computed a chunk of steps at a time (``mods_chunks``). Kernel
#2 and its plain version take canonical stacks only.

:func:`fused_diffnet_forward` is one whole DiffNet forward (the TPU kernel
#5, ``_fused_net_kernel``): the t-embedding MLP, the input projection, every
block with ``_block_body``'s rounding and the final layer, in one host call
(``csrc/fused_net.cu``), with :func:`fused_diffnet_forward_reference` beside
it. It reads the adaLN groups and the final layer's modulation as row
slices of ``modcat_w`` / ``modcat_b`` (:func:`adaln_views`), never copies.
Every product of it runs on the head GEMM too, by :func:`net_plans`, and
its plain version takes the split twin's sums at those plans (``splits=``).
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from bitdance_tpu_torch.ops import _cuda
from bitdance_tpu_torch.ops.int4 import quantize_linear_int4, unpack_int4
from bitdance_tpu_torch.ops.int8 import QTensor, int8_matmul, quantize_linear, quantize_rows

_QUANT_MODES = (None, "int8", "int4")


def quant_mode(quant) -> str | None:
    """DiffHead.sample_weight_quant (False / True / "int4") -> None, "int8"
    or "int4"."""
    mode = {False: None, None: None, True: "int8"}.get(quant, quant)
    if mode not in _QUANT_MODES:
        raise ValueError(f"quant {quant!r}: expected False, True or 'int4'")
    return mode


def quantize_cols(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-output-column int8 of a [out, in] weight: (int8 [out, in], f32
    scales [out]); the JAX function's [in, out] / [1, out], transposed."""
    qt = quantize_linear(w)
    return qt.q, qt.s


def quantize_cols_int4(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-output-column int4 of a [out, in] weight, packed along in: byte
    [n, j] holds in-row j (low nibble) and j + in/2 (high nibble). Returns
    (int8 [out, in/2], f32 scales [out])."""
    qt = quantize_linear_int4(w)
    return qt.q, qt.s


def stack_diffnet_params(net, num_blocks: int,
                         dtype: torch.dtype = torch.bfloat16,
                         quant: bool | str = False) -> dict:
    """DiffNet module -> stacked tensors for the sampler (see module doc).

    The net's family decides the keys: the MlpEncoder's blocks have one
    norm, stacked as n2, and no n1/wqkv/bqkv/wo/bo. Biases of the big
    products and the norm parameters take ``dtype``; in_b, t_b*, cond_b,
    f_out_b and modcat_b stay float32, as in the JAX package. ``quant``
    (True: int8, "int4": packed) stores wqkv, wo, w1, w2 quantized from the
    net's weights, one block at a time, with ``*_s`` scales, and modcat_w as
    int8 (quantized from its ``dtype`` values)."""
    f32 = torch.float32
    mode = quant_mode(quant)
    blk = [net.res_blocks[i] for i in range(num_blocks)]

    def stack(get, dt=dtype):
        return torch.stack([get(b).detach().to(dt) for b in blk]).contiguous()

    def put(key, get):
        if mode is None:
            out[key] = stack(get)
            return
        qfn = quantize_cols_int4 if mode == "int4" else quantize_cols
        qs = [qfn(get(b).detach()) for b in blk]
        out[key] = torch.stack([q for q, _ in qs]).contiguous()
        out[key + "_s"] = torch.stack([sc for _, sc in qs]).contiguous()

    te = net.time_embed.mlp
    fl = net.final_layer
    out = {
        "in_w": net.input_proj.weight.detach().to(dtype).contiguous(),
        "in_b": net.input_proj.bias.detach().to(f32),
        "t_w0": te[0].weight.detach().to(dtype),
        "t_b0": te[0].bias.detach().to(f32),
        "t_w2": te[2].weight.detach().to(dtype),
        "t_b2": te[2].bias.detach().to(f32),
        "cond_w": net.cond_embed.weight.detach().to(dtype),
        "cond_b": net.cond_embed.bias.detach().to(f32),
        "f_out_w": fl.linear.weight.detach().to(dtype).contiguous(),
        "f_out_b": fl.linear.bias.detach().to(f32),
        "b1": stack(lambda b: b.w1.bias),
        "b2": stack(lambda b: b.w2.bias),
    }
    put("w1", lambda b: b.w1.weight)
    put("w2", lambda b: b.w2.weight)
    if net.attention:
        out.update(
            n1=stack(lambda b: torch.stack([b.norm1.weight, b.norm1.bias])),
            n2=stack(lambda b: torch.stack([b.norm2.weight, b.norm2.bias])),
            bqkv=stack(lambda b: b.attn.wqkv.bias),
            bo=stack(lambda b: b.attn.wo.bias))
        put("wqkv", lambda b: b.attn.wqkv.weight)
        put("wo", lambda b: b.attn.wo.weight)
    else:
        out["n2"] = stack(lambda b: torch.stack([b.norm.weight, b.norm.bias]))
    ada = [m.weight.detach() for m in net.ada_ln_blocks]
    ada_b = [m.bias.detach() for m in net.ada_ln_blocks]
    modcat = torch.cat(ada + [fl.ada_ln_modulation.weight.detach()],
                       dim=0).to(dtype).contiguous()
    if mode is None:
        out["modcat_w"] = modcat
    else:
        out["modcat_w"], out["modcat_w_s"] = quantize_cols(modcat)
    out["modcat_b"] = torch.cat(ada_b + [fl.ada_ln_modulation.bias.detach()],
                                dim=0).to(f32)
    return out


def _dot_f32(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a @ w.T with a cast to w's dtype and the sum kept in fp32, as the JAX
    _dot (preferred_element_type f32): on the card a bf16 product is one
    cuBLAS call that reads bf16 and writes fp32 (``torch.mm(...,
    out_dtype=torch.float32)``; the operands upcast to fp32 would run on the
    SIMT units), elsewhere :func:`_dot_acc`. em_precompute's products
    (ROADMAP C8)."""
    if a.is_cuda and w.dtype == torch.bfloat16:
        return torch.mm(a.to(w.dtype), w.t(), out_dtype=torch.float32)
    return _dot_acc(a, w)


HEAD_GEMM_BK = 64                  # k of one bf16 ring stage of csrc/head_gemm.cuh
HEAD_GEMM_BN = 128                 # out-features of an output tile
HEAD_GEMM_MAX_SPLITS = 8           # a product's splits form one thread block cluster
# GemmMode in head_blocks.cuh: "bias" both routes; "gated" and "swiglu" the
# round route's (#3/#4); "gated_f32" and "swiglu_f32" kernel #2's;
# "swiglu_h32" (h1 and h2 in fp32) and "gated_bf16" (bf16(x + y * gate) into
# a new output) the MLP block's (#14), "gated_bf16" also the attention
# block's (#15) wo and "bias_f32" (the fp32 sums plus the bias) its qkv;
# "out_f32" (the fp32 sums, no bias) the whole net's (#5) t-MLP and
# modulation products
HEAD_GEMM_MODES = {"bias": 0, "gated_f32": 1, "swiglu_f32": 2, "swiglu_h32": 3,
                   "bias_f32": 4, "gated_bf16": 5, "out_f32": 7, "gated": 9, "swiglu": 10}
# the C entry of each mode: the head blocks' modes beside their kernels
_HEAD_GEMM_ENTRY = {3: "bd_head_gemm_block", 4: "bd_head_gemm_block", 5: "bd_head_gemm_block",
                    7: "bd_head_gemm_net"}
# the integer kinds: "bias" (qkv, both routes); #2's quant modes'
# "gated_f32" (wo, w2) and "swiglu_q" (w1: fp32 silu(bf16 h1) * bf16 h2, the
# w2 quantization's input); the round route's (#3/#4) "gated" (wo, w2:
# _block_body's bf16 residual) and "swiglu_round" (w1: bf16(silu(bf16 h1))
# * bf16 h2 in bf16, the w2 quantization's input); the tensor-parallel head's
# "out_s32" (the int32 sums, no scale or bias: a row-parallel product
# all-reduces them before it dequantizes)
HEAD_GEMM_S8_MODES = {"bias": 0, "gated_f32": 1, "swiglu_q": 8, "gated": 9,
                      "swiglu_round": 11, "out_s32": 12}
# logical k of one 128-byte ring stage per operand kind: 64 bf16, 128 int8,
# 256 packed int4 (a byte holds k = j and k = K/2 + j)
HEAD_GEMM_STAGE_K = {None: 64, "int8": 128, "int4": 256}


class HeadGemmPlan(NamedTuple):
    bm: int        # rows of an output tile: 64 (one warpgroup) or 128 (two)
    bn: int        # columns (out-features) of an output tile
    splits: int    # K split this many ways


def head_gemm_stages(k: int, quant: str | None = None) -> int:
    """Ring stages of 128 bytes over a weight row of k (logical) columns:
    k / 64 in bf16, ceil(k / 128) in int8, ceil(k / 256) packed (a last
    stage may be half: the kernel reads zeros past the row)."""
    return -(-k // HEAD_GEMM_STAGE_K[quant])


def head_gemm_plan(rows: int, n: int, k: int, sm_count: int = 132,
                   quant: str | None = None) -> HeadGemmPlan:
    """Tile and split-K count of one head GEMM product [rows, k] x [n, k]^T,
    bf16 (quant None) or on the integer kinds ("int8", "int4": packed).

    bm is 64 up to 64 rows, else 128. When the output tiles leave SMs idle,
    K is split in a power of two of ways, at most 8 (the split blocks of a
    tile form one cluster), so that tiles x splits fill one wave of
    ``sm_count`` and no more, every split walking at least two ring stages
    of 128 bytes (:func:`head_gemm_stages`) (H-1x at 64 rows: w1 30 tiles x
    4, w2 10 x 8; B-16x at 1024: qkv and w1 144 tiles x 1, wo and w2 48 x 2;
    the 14B head at 128 rows, bf16, int8 and int4 alike: qkv and w1 120
    tiles x 1, wo and w2 40 x 2; at 256: qkv and w1 240 x 1, wo and w2 80 x
    1). bf16 needs K % 64 == 0, the integer kinds K % 128 == 0."""
    bn = HEAD_GEMM_BN
    if quant not in _QUANT_MODES:
        raise ValueError(f"head_gemm_plan: quant {quant!r} not in {_QUANT_MODES}")
    kq = HEAD_GEMM_BK if quant is None else 128
    if n % bn or k % kq or rows < 1 or k < 1:
        raise ValueError(f"head_gemm_plan: [{rows}, {k}] x [{n}, {k}]^T needs N % "
                         f"{bn} == 0 and K % {kq} == 0")
    bm = 64 if rows <= 64 else 128
    tiles = -(-rows // bm) * (n // bn)
    steps = head_gemm_stages(k, quant)
    cap = max(1, min(sm_count // tiles, steps // 2, HEAD_GEMM_MAX_SPLITS))
    return HeadGemmPlan(bm, bn, 1 << (cap.bit_length() - 1))


def head_gemm_split_ranges(k: int, splits: int,
                           quant: str | None = None) -> list[tuple[int, int]]:
    """The range [c0, c1) of stored weight columns of each split, as the
    kernel walks them: split s takes ring stages [s T / S, (s + 1) T / S) of
    T = :func:`head_gemm_stages`. The columns are k's in bf16 and int8 and
    packed bytes in int4, where column j holds k = j and k = k/2 + j."""
    cols = k // 2 if quant == "int4" else k
    width = HEAD_GEMM_BK if quant is None else 128
    steps = head_gemm_stages(k, quant)
    return [(min(cols, s * steps // splits * width), min(cols, (s + 1) * steps // splits * width))
            for s in range(splits)]


def sampler_plans(rows: int, c: int, hidden: int, attention: bool,
                  sm_count: int = 132, quant: str | None = None) -> dict[str, HeadGemmPlan]:
    """:func:`head_gemm_plan` of each block product of the whole sampler's
    routes (#2 bf16, int8 or int4, and #3/#4)."""
    shapes = {"wqkv": (3 * c, c), "wo": (c, c), "w1": (2 * hidden, c), "w2": (c, hidden)}
    keys = ("wqkv", "wo", "w1", "w2") if attention else ("w1", "w2")
    return {key: head_gemm_plan(rows, *shapes[key], sm_count, quant) for key in keys}


def _ln(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm without affine, one-pass E[x^2] - E[x]^2 statistics in fp32
    (the TPU kernels' _ln)."""
    x = x.float()
    mean = x.mean(dim=-1, keepdim=True)
    var = (x.square().mean(dim=-1, keepdim=True) - mean.square()).clamp_min(0.0)
    return (x - mean) * torch.rsqrt(var + eps)


def _dot_acc(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a @ w.T with a cast to w's dtype and fp32 accumulation, as the TPU
    kernels' _dot (preferred_element_type=f32) and the card kernels' GEMMs:
    the cast operands multiply in fp32 on every device (each product of two
    bf16 values is exact in fp32, with TF32 on or off), so a bias added
    after it meets the fp32 sum, as in the kernels."""
    return torch.matmul(a.to(w.dtype).float(), w.float().t())


def _dot_acc_split(a: torch.Tensor, w: torch.Tensor, splits: int = 1) -> torch.Tensor:
    """:func:`_dot_acc` as the head GEMM's splits sum it: fp32 partials over
    :func:`head_gemm_split_ranges`, added in split order."""
    if splits == 1:
        return _dot_acc(a, w)
    acc = None
    for k0, k1 in head_gemm_split_ranges(w.shape[1], splits):
        part = _dot_acc(a[:, k0:k1], w[:, k0:k1])
        acc = part if acc is None else acc + part
    return acc


def _gated_f32(h: torch.Tensor, y: torch.Tensor, gate: torch.Tensor) -> torch.Tensor:
    """Kernel #2's gated residual: h + y * gate in fp32 (y = the product's
    fp32 sum plus its bias)."""
    return h + y * gate.float()


def _swiglu_f32(h12: torch.Tensor) -> torch.Tensor:
    """Kernel #2's SwiGLU: silu(h1) * h2 in fp32 from h12 = [h1 | h2] in the
    stage dtype."""
    hidden = h12.shape[1] // 2
    return F.silu(h12[:, :hidden].float()) * h12[:, hidden:].float()


def head_gemm_split_plain(a: torch.Tensor, w: torch.Tensor, mode: str, bias: torch.Tensor,
                          gate: torch.Tensor | None = None,
                          resid: torch.Tensor | None = None,
                          splits: int = 1, x: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version of :func:`head_gemm`: y = a @ w.T + bias from the split
    partials (:func:`_dot_acc_split`), then the epilogue: "bias" bf16(y);
    _block_body's "gated", the residual bf16(resid + bf16(bf16(y) * gate)),
    returned as fp32, and "swiglu" (w rows [h1; h2]) bf16(silu(bf16(h1))) *
    bf16(h2); kernel #2's "gated_f32", resid + y * gate in fp32, and
    "swiglu_f32", bf16(silu(bf16(h1)) * bf16(h2)) (:func:`_net_forward`'s
    :func:`_gated_f32` and :func:`_swiglu_f32`); the MLP block's (#14)
    "swiglu_h32", bf16(silu(h1) * h2) from fp32 h1, h2, and "gated_bf16",
    bf16(x + y * gate) (also #15's wo); #15's "bias_f32", y in fp32; #5's
    "out_f32", the fp32 sums without the bias (bias may be None)."""
    if mode == "out_f32":
        return _dot_acc_split(a, w, splits)
    y = _dot_acc_split(a, w, splits) + bias.float()
    if mode == "bias_f32":
        return y
    bf = torch.bfloat16
    if mode == "swiglu_h32":
        hidden = w.shape[0] // 2
        return (F.silu(y[:, :hidden]) * y[:, hidden:]).to(bf)
    if mode == "gated_bf16":
        return (x.float() + y * gate.float()).to(bf)
    if mode == "bias":
        return y.to(bf)
    if mode == "gated":
        return (resid.to(bf) + y.to(bf) * gate.to(bf)).float()
    if mode == "gated_f32":
        return _gated_f32(resid.float(), y, gate)
    if mode == "swiglu":
        h12 = y.to(bf)
        hidden = w.shape[0] // 2
        return F.silu(h12[:, :hidden].float()).to(bf) * h12[:, hidden:]
    if mode == "swiglu_f32":
        return _swiglu_f32(y.to(bf)).to(bf)
    raise ValueError(f"head_gemm: mode {mode!r} not in {sorted(HEAD_GEMM_MODES)}")


def head_gemm(a: torch.Tensor, w: torch.Tensor, mode: str, bias: torch.Tensor | None, *,
              gate: torch.Tensor | None = None, resid: torch.Tensor | None = None,
              x: torch.Tensor | None = None,
              plan: HeadGemmPlan | None = None) -> torch.Tensor:
    """One product of the head GEMM (``csrc/head_gemm.cuh``): a [R, K]
    bf16, w [N, K] bf16 (the torch Linear layout; the "swiglu" modes: rows
    [h1; h2]), bias [N] bf16 ("out_f32": None; it and "bias_f32" write
    fp32). "gated" and "gated_f32" take gate [R, N] bf16 (rows may lie
    apart) and update resid [R, N] fp32 ("gated": bf16 values) in place, as
    the sampler does, and return it; "gated_bf16" takes gate and x [R, N]
    bf16 and returns a new bf16 output. ``plan`` defaults to
    :func:`head_gemm_plan` at the card's SM count. CPU tensors take
    :func:`head_gemm_split_plain` with the plan's splits; CUDA tensors launch
    the kernel or raise."""
    if mode not in HEAD_GEMM_MODES:
        raise ValueError(f"head_gemm: mode {mode!r} not in {sorted(HEAD_GEMM_MODES)}")
    rows, k = a.shape
    n = w.shape[0]
    cuda = a.device.type == "cuda"
    sms = torch.cuda.get_device_properties(a.device).multi_processor_count if cuda else 132
    plan = plan or head_gemm_plan(rows, n, k, sms)
    gated = mode in ("gated", "gated_f32")
    if a.device.type == "cpu":
        out = head_gemm_split_plain(a, w, mode, bias, gate, resid, plan.splits, x)
        return resid.copy_(out) if gated else out
    if not cuda:
        raise RuntimeError(f"head_gemm: no kernel for {a.device}")
    _cuda.refuse_grad("head_gemm", a, w)
    operands = ((a, (rows, k)), (w, (n, k))) + (() if mode == "out_f32" else ((bias, (n,)),))
    for t, want in operands:
        if t.dtype != torch.bfloat16 or tuple(t.shape) != want or not t.is_contiguous():
            raise ValueError(f"head_gemm: want contiguous bf16 {want}, got {t.dtype} "
                             f"{tuple(t.shape)}")
    if gated and (resid is None or resid.dtype != torch.float32
                  or tuple(resid.shape) != (rows, n) or not resid.is_contiguous()):
        raise ValueError(f"head_gemm: {mode!r} needs resid fp32 [R, N]")
    if mode == "gated_bf16" and (x is None or x.dtype != torch.bfloat16
                                 or tuple(x.shape) != (rows, n) or not x.is_contiguous()):
        raise ValueError("head_gemm: 'gated_bf16' needs x bf16 [R, N]")
    uses_gate = gated or mode == "gated_bf16"
    if uses_gate and (gate is None or gate.dtype != torch.bfloat16
                      or tuple(gate.shape) != (rows, n) or gate.stride(1) != 1):
        raise ValueError(f"head_gemm: {mode!r} needs gate bf16 [R, N]")
    dev = a.device
    if gated:
        out = resid
    else:
        cols = n // 2 if mode.startswith("swiglu") else n
        out = torch.empty((rows, cols), device=dev, dtype=torch.float32
                          if mode in ("out_f32", "bias_f32") else torch.bfloat16)
    shape = torch.tensor([rows, n, k, gate.stride(0) if uses_gate else 0,
                          HEAD_GEMM_MODES[mode], *plan], dtype=torch.int32)
    entry = getattr(_cuda.load(), _HEAD_GEMM_ENTRY.get(HEAD_GEMM_MODES[mode], "bd_head_gemm"))
    code = entry(
        a.data_ptr(), w.data_ptr(), None if bias is None else bias.data_ptr(),
        None if gated else out.data_ptr(),
        x.data_ptr() if mode == "gated_bf16" else out.data_ptr() if gated else None,
        gate.data_ptr() if uses_gate else None, shape.data_ptr(), _cuda.stream_ptr())
    _cuda.check(code, "head_gemm")
    head_gemm.launches += 1
    return out


head_gemm.launches = 0


def _int_sums(aq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """Exact integer sums aq [M, K] int8 x wq [N, K]^T int8: int32 from
    ``torch._int_mm`` on the card where it takes the shape (M > 16, K and N
    multiples of 8), else float64 (exact: every sum stays below 2^53)."""
    m, k = aq.shape
    if aq.is_cuda and m > 16 and k % 8 == 0 and wq.shape[0] % 8 == 0:
        return torch._int_mm(aq.contiguous(), wq.contiguous().t())
    return aq.double() @ wq.double().t()


def _int_acc(aq: torch.Tensor, w: torch.Tensor, splits: int = 1,
             quant: str = "int8") -> torch.Tensor:
    """The exact integer sums of aq [R, K] int8 rows and w [N, K] int8
    (quant "int4": packed [N, K/2], each nibble plane against its half of
    aq): the partials over the split ranges of
    :func:`head_gemm_split_ranges`, summed in split order (:func:`_int_sums`:
    int32 or float64, exact either way)."""
    k = aq.shape[1]
    kh = w.shape[1]
    acc = None
    for c0, c1 in head_gemm_split_ranges(k, splits, quant):
        if quant == "int4":
            lo, hi = unpack_int4(w[:, c0:c1])
            part = _int_sums(aq[:, c0:c1], lo) + _int_sums(aq[:, kh + c0:kh + c1], hi)
        else:
            part = _int_sums(aq[:, c0:c1], w[:, c0:c1])
        acc = part if acc is None else acc + part
    return acc


def _dequant(acc: torch.Tensor, sa: torch.Tensor, ws: torch.Tensor) -> torch.Tensor:
    """float(acc) * (sa * ws): integer sums [R, N] to fp32 with row scales sa
    [R] and column scales ws [N], as the TPU kernels' _mmq and stage_dot
    scale them."""
    return acc.float() * (sa.float()[:, None] * ws.float()[None, :])


def _int_product(aq: torch.Tensor, sa: torch.Tensor, w: torch.Tensor, ws: torch.Tensor,
                 splits: int = 1, quant: str = "int8") -> torch.Tensor:
    """The dequantized fp32 product of aq [R, K] int8 rows with scales sa
    [R] and w (as :func:`_int_acc`) with column scales ws [N]: the exact
    split sums (:func:`_int_acc`), then :func:`_dequant`."""
    return _dequant(_int_acc(aq, w, splits, quant), sa, ws)


def head_gemm_s8_split_plain(aq: torch.Tensor, sa: torch.Tensor, w: torch.Tensor,
                             ws: torch.Tensor, mode: str, bias: torch.Tensor,
                             gate: torch.Tensor | None = None,
                             resid: torch.Tensor | None = None, splits: int = 1,
                             quant: str = "int8") -> torch.Tensor:
    """Plain version of :func:`head_gemm_s8`: y = :func:`_int_product` +
    bias, as the TPU kernels' stage_dot, _mmq and _net_forward compute it,
    then the epilogue: "bias" y in bias's dtype; "gated_f32" resid + y *
    gate in fp32; "swiglu_q" (w rows [h1; h2]) silu(h1) * h2 in fp32 from
    h1, h2 rounded to bias's dtype; the round route's "gated", the residual
    bf16(resid + bf16(bf16(y) * gate)) returned as fp32, and "swiglu_round",
    bf16(silu(bf16(h1))) * bf16(h2) in bf16 (_block_body's glu); the
    tensor-parallel head's "out_s32", the exact integer sums as int32 (sa,
    ws and bias unread)."""
    if mode not in HEAD_GEMM_S8_MODES or quant not in ("int8", "int4"):
        raise ValueError(f"head_gemm_s8: mode {mode!r} / quant {quant!r}")
    if mode == "out_s32":
        return _int_acc(aq, w, splits, quant).to(torch.int32)
    y = _int_product(aq, sa, w, ws, splits, quant) + bias.float()
    bf = torch.bfloat16
    if mode == "bias":
        return y.to(bias.dtype)
    if mode == "gated_f32":
        return _gated_f32(resid.float(), y, gate)
    if mode == "gated":
        return (resid.to(bf) + y.to(bf) * gate.to(bf)).float()
    if mode == "swiglu_round":
        h12 = y.to(bf)
        hidden = w.shape[0] // 2
        return F.silu(h12[:, :hidden].float()).to(bf) * h12[:, hidden:]
    return _swiglu_f32(y.to(bias.dtype))


def head_gemm_s8(aq: torch.Tensor, sa: torch.Tensor, w: torch.Tensor, ws: torch.Tensor,
                 mode: str, bias: torch.Tensor, *, gate: torch.Tensor | None = None,
                 resid: torch.Tensor | None = None, plan: HeadGemmPlan | None = None,
                 quant: str = "int8") -> torch.Tensor:
    """One integer product of the sampler's quant modes on the head GEMM
    (``csrc/head_gemm.cuh``, kinds kOpS8 / kOpS4): aq [R, K] int8 rows with
    scales sa [R] fp32 (:func:`quantize_rows`), w [N, K] int8 or, quant
    "int4", packed [N, K/2] with column scales ws [N] fp32, bias [N] bf16;
    modes :data:`HEAD_GEMM_S8_MODES` ("swiglu_q": w rows [h1; h2], fp32 out
    [R, N / 2]; "swiglu_round": the same, bf16 out; "gated_f32" and
    "gated": gate [R, N] bf16, resid [R, N] fp32 ("gated": bf16 values)
    updated in place and returned; "out_s32": the int32 sums [R, N], sa, ws
    and bias may be None). ``plan`` defaults to
    :func:`head_gemm_plan` at the card's SM count. CPU tensors take
    :func:`head_gemm_s8_split_plain` with the plan's splits; CUDA tensors
    launch the kernel or raise."""
    if mode not in HEAD_GEMM_S8_MODES or quant not in ("int8", "int4"):
        raise ValueError(f"head_gemm_s8: mode {mode!r} not in {sorted(HEAD_GEMM_S8_MODES)} "
                         f"or quant {quant!r} not int8 / int4")
    rows, k = aq.shape
    n = w.shape[0]
    cuda = aq.device.type == "cuda"
    sms = torch.cuda.get_device_properties(aq.device).multi_processor_count if cuda else 132
    plan = plan or head_gemm_plan(rows, n, k, sms, quant)
    gated = mode in ("gated_f32", "gated")
    if aq.device.type == "cpu":
        out = head_gemm_s8_split_plain(aq, sa, w, ws, mode, bias, gate, resid, plan.splits,
                                       quant)
        return resid.copy_(out) if gated else out
    if not cuda:
        raise RuntimeError(f"head_gemm_s8: no kernel for {aq.device}")
    wk = k // 2 if quant == "int4" else k
    raw = mode == "out_s32"
    operands = ((aq, (rows, k), torch.int8), (w, (n, wk), torch.int8)) + (() if raw else (
        (sa, (rows,), torch.float32), (ws, (n,), torch.float32), (bias, (n,), torch.bfloat16)))
    for t, want, dt in operands:
        if t.dtype != dt or tuple(t.shape) != want or not t.is_contiguous():
            raise ValueError(f"head_gemm_s8: want contiguous {dt} {want}, got {t.dtype} "
                             f"{tuple(t.shape)}")
    if gated and (resid is None or resid.dtype != torch.float32
                  or tuple(resid.shape) != (rows, n) or not resid.is_contiguous()
                  or gate is None or gate.dtype != torch.bfloat16
                  or tuple(gate.shape) != (rows, n) or gate.stride(1) != 1):
        raise ValueError(f"head_gemm_s8: {mode!r} needs resid fp32 [R, N] and gate bf16 "
                         "[R, N]")
    dev = aq.device
    if gated:
        out = resid
    elif mode == "swiglu_q":
        out = torch.empty((rows, n // 2), dtype=torch.float32, device=dev)
    elif mode == "swiglu_round":
        out = torch.empty((rows, n // 2), dtype=torch.bfloat16, device=dev)
    else:
        out = torch.empty((rows, n), dtype=torch.int32 if raw else torch.bfloat16, device=dev)
    shape = torch.tensor([rows, n, k, gate.stride(0) if gated else 0, HEAD_GEMM_S8_MODES[mode],
                          *plan, int(quant == "int4")], dtype=torch.int32)
    code = _cuda.load().bd_head_gemm_s8(
        aq.data_ptr(), None if raw else sa.data_ptr(), w.data_ptr(),
        None if raw else ws.data_ptr(), None if raw else bias.data_ptr(),
        None if gated else out.data_ptr(), out.data_ptr() if gated else None,
        gate.data_ptr() if gated else None, shape.data_ptr(), _cuda.stream_ptr())
    _cuda.check(code, "head_gemm_s8")
    head_gemm_s8.launches += 1
    return out


head_gemm_s8.launches = 0


_RESIDENT_BYTES = 48 * 1024 * 1024
_STREAM_BLOCK_BYTES = 60 * 1024 * 1024


def block_weight_bytes(stacked: dict, attention: bool) -> int:
    """Bytes of the per-block tensors the JAX router counts
    (fused_head.py:1138-1145): w1, b1, w2, b2, n2, the attention half's
    n1, wqkv, bqkv, wo, bo, and the quantized matrices' scales."""
    mats = ("w1", "w2") + (("wqkv", "wo") if attention else ())
    keys = list(_MLP_KEYS) + (list(_ATTN_KEYS) if attention else []) \
        + [k + "_s" for k in mats if k + "_s" in stacked]
    return sum(stacked[k].numel() * stacked[k].element_size() for k in keys)


def rounds_residual(stacked: dict, num_blocks: int, attention: bool) -> bool:
    """Whether the JAX package's fused_em_sample runs this stack on a kernel
    that rounds the residual to the weights' dtype at each block: resident
    #4 when the block weights are <= 48 MB, else #3 unless
    2 * bytes // num_blocks > 60 MB sends it to the streamed #2, which keeps
    h in fp32 (fused_head.py:1145-1160). The rule reads the stack's bytes
    as the JAX router counts them (:func:`block_weight_bytes`), quantized or
    not: a quantized stack counts its int8 or packed-int4 matrices and their
    fp32 scales. The ImageNet heads (C 768 / 1280) round in bf16 and in
    their quantized forms (make_head(sample_weight_quant=...): H-1x in int8,
    88.9 MB, on #3; H-1x in int4 and B-16x on the resident #4); the 14B
    head (C 5120, bf16, int8 or int4) does not."""
    wb = block_weight_bytes(stacked, attention)
    if wb <= _RESIDENT_BYTES:
        return True
    return not 2 * wb // num_blocks > _STREAM_BLOCK_BYTES


def _block_body(h: torch.Tensor, mods: torch.Tensor, stacked: dict, l: int, *,
                attention: bool, n_head: int, groups: int,
                eps: float = 1e-6, fp32_qkv_h12: bool = False,
                splits: dict | None = None, quant: str | None = None) -> torch.Tensor:
    """One block as the TPU kernels #3-#5 compute it (fused_head.py:248-292):
    h and the mods are cast to the weights' dtype, and so is every
    elementwise stage (LN output, its affine and modulation, qkv, the
    attention output, both gated products and the residual sums, h12 and
    silu(h1)); LN statistics, softmax and product accumulation stay fp32.
    In bf16 each torch op rounds, as each bf16 op of the kernel does.
    fp32_qkv_h12 keeps qkv and h12 in fp32 as the per-call blocks #14 / #15
    do: a twin the card check holds kernel #5 away from. splits ({"w1": S,
    ...}) sums a product's fp32 partials as the head GEMM's split-K does
    (:func:`_dot_acc_split`). quant ("int8" / "int4", a stack of that mode)
    runs each product as _mmq does: its input (the stage value in the
    weights' dtype) quantized per row in fp32, the exact integer sums
    scaled by the row and column scales (:func:`_int_product`, the split
    partials by splits). Returns h in the weights' dtype."""
    elem = stacked["n2"].dtype
    stage = torch.float32 if fp32_qkv_h12 else elem
    c = h.shape[-1]
    hidden = stacked["b1"].shape[1] // 2
    h = h.to(elem)
    mods = mods.to(elem)

    def sl(j):
        return mods[:, j * c:(j + 1) * c]

    def moded(x, which, nrm):
        ln = _ln(x, eps).to(elem) * nrm[0].to(elem) + nrm[1].to(elem)
        return ln * (1.0 + sl(which)) + sl(which + 1)

    def prod(a, key):
        sp = (splits or {}).get(key, 1)
        if quant:
            aq, sa = quantize_rows(a.float())
            return _int_product(aq, sa, stacked[key][l], stacked[key + "_s"][l], sp, quant)
        return _dot_acc_split(a, stacked[key][l], sp)

    mlp = 0
    if attention:
        ha = moded(h, 0, stacked["n1"][l])
        qkv = (prod(ha, "wqkv") + stacked["bqkv"][l].float()).to(stage)
        att = _attn_from_qkv(qkv, n_head, groups, c).to(elem)
        proj = (prod(att, "wo") + stacked["bo"][l].float()).to(elem)
        h = h + proj * sl(2)
        mlp = 3
    hm = moded(h, mlp, stacked["n2"][l])
    h12 = (prod(hm, "w1") + stacked["b1"][l].float()).to(stage)
    glu = F.silu(h12[:, :hidden].float()).to(elem) * h12[:, hidden:]
    mlp_out = (prod(glu, "w2") + stacked["b2"][l].float()).to(elem)
    return h + mlp_out * sl(mlp + 2)


def em_precompute(stacked: dict, c_emb: torch.Tensor, t_all: torch.Tensor,
                  t_freq_size: int = 256,
                  out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """adaLN + final-layer mods of EVERY sampler timestep in one product.

    c_emb: [R, C] fp32 (cond_embed applied; rows [cond; uncond]); t_all [S]
    (any device). Returns allmods [S, R, A*6*C + 2C] in out_dtype. Each
    product keeps its fp32 sum before the fp32 bias, as the JAX
    em_precompute (:func:`_dot_f32`; ROADMAP C8)."""
    return _mods_of(stacked, c_emb, em_time_embed(stacked, t_all, c_emb.device, t_freq_size),
                    out_dtype)


def em_time_embed(stacked: dict, t_all: torch.Tensor, device: torch.device,
                  t_freq_size: int = 256) -> torch.Tensor:
    """The timestep MLP te(t) of every t in t_all [S] (any device): fp32
    [S, C] on ``device``."""
    from bitdance_tpu_torch.models.diff_head import timestep_embedding

    t_all = t_all.to(device=device, dtype=torch.float32)
    tf = timestep_embedding(t_all, t_freq_size)
    te = _dot_f32(tf, stacked["t_w0"]) + stacked["t_b0"]
    return _dot_f32(F.silu(te), stacked["t_w2"]) + stacked["t_b2"]


def em_precompute_rows(stacked: dict, c_emb: torch.Tensor, t_all: torch.Tensor,
                       t_freq_size: int = 256) -> torch.Tensor:
    """The input of :func:`em_precompute`'s modulation product: y =
    silu(te(t) + c_emb), fp32 [S, R, C]."""
    te = em_time_embed(stacked, t_all, c_emb.device, t_freq_size)
    return F.silu(te[:, None, :] + c_emb[None])


def _mods_of(stacked: dict, c_emb: torch.Tensor, te: torch.Tensor,
             out_dtype: torch.dtype) -> torch.Tensor:
    """The mods [S, R, W] in out_dtype of the timestep embeddings te [S, C]:
    the modulation product of y = silu(te + c_emb), each row on its own (an
    int8 modcat quantizes per row; the sums are exact)."""
    y = F.silu(te[:, None, :] + c_emb[None])
    s_dim, r_dim, c_dim = y.shape
    return modcat_product(stacked, y.reshape(s_dim * r_dim, c_dim)).to(
        out_dtype).reshape(s_dim, r_dim, -1)


def modcat_product(stacked: dict, y: torch.Tensor) -> torch.Tensor:
    """:func:`em_precompute`'s modulation product y [M, C] x modcat^T + bias
    in fp32: W8A8 (y quantized per row; plain torch, ``torch._int_mm`` on
    the card) on an int8 modcat, else the fp32 sum of :func:`_dot_f32`."""
    w = stacked["modcat_w"]
    if "modcat_w_s" in stacked:
        allmods = int8_matmul(y, QTensor(w, stacked["modcat_w_s"]))
    else:
        allmods = _dot_f32(y, w)
    return allmods + stacked["modcat_b"]


def _from_head_major(t: torch.Tensor, n_head: int, parts: int) -> torch.Tensor:
    """Columns of a head-major product [R, n_head * parts * w] back in the
    canonical (parts, n_head, w) order, contiguous."""
    rows = t.shape[0]
    return t.reshape(rows, n_head, parts, -1).transpose(1, 2).reshape(rows, -1)


def _attn_from_qkv(qkv: torch.Tensor, n_head: int, groups: int,
                   c_dim: int, head_major: bool = False) -> torch.Tensor:
    """Window attention over packed qkv [R, 3C] (column order (3, n_head,
    hd), or (n_head, 3, hd) when ``head_major``) -> fp32 [R, C]; q is
    scaled (and rounded to qkv's dtype) first."""
    if head_major:
        qkv = _from_head_major(qkv, n_head, 3)
    rows = qkv.shape[0]
    hd = c_dim // n_head
    w = rows // groups
    qkv = qkv.reshape(groups, w, 3, n_head, hd)
    q = (qkv[:, :, 0].float() * hd ** -0.5).to(qkv.dtype).float()
    k = qkv[:, :, 1].float()
    v = qkv[:, :, 2].float()
    s = torch.einsum("gqhd,gkhd->ghqk", q, k)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("ghqk,gkhd->gqhd", p, v).reshape(rows, c_dim)


def _rounded_blocks(h: torch.Tensor, group_mods, group_of, final_mods: torch.Tensor,
                    stacked: dict, *, num_blocks: int, attention: bool,
                    n_head: int, groups: int, bounded: bool, eps: float = 1e-6,
                    fp32_qkv_h12: bool = False, splits: dict | None = None,
                    quant: str | None = None) -> torch.Tensor:
    """The blocks and final layer of kernels #3-#5 from the fp32 input
    projection h [R, C]: block l runs :func:`_block_body` on
    group_mods(group_of(l)) (called once per run of equal groups; quant as
    there), then the final adaLN LayerNorm on final_mods [R, 2C] and the
    output product in fp32, 2*sigmoid-1 when bounded. Returns fp32 [R, ch]."""
    c = stacked["n2"].shape[-1]
    g_prev, mods = None, None
    for l in range(num_blocks):
        g = group_of(l)
        if g != g_prev:
            g_prev, mods = g, group_mods(g)
        h = _block_body(h, mods, stacked, l, attention=attention, n_head=n_head,
                        groups=groups, eps=eps, fp32_qkv_h12=fp32_qkv_h12, splits=splits,
                        quant=quant)
    fm = final_mods.float()
    z = _ln(h, eps) * (1.0 + fm[:, :c]) + fm[:, c:]
    out = _dot_acc(z, stacked["f_out_w"]) + stacked["f_out_b"]
    return 2.0 * torch.sigmoid(out) - 1.0 if bounded else out


def _net_forward(stacked: dict, x: torch.Tensor, mods_row: torch.Tensor, *,
                 num_blocks: int, switch_freq: int, n_head: int, groups: int,
                 attention: bool = True, bounded: bool = True,
                 quant: str | None = None, round_residual: bool = False,
                 eps: float = 1e-6, splits: dict | None = None) -> torch.Tensor:
    """One DiffNet forward on rows [x; x] with precomputed mods -> fp32
    [R, ch]. round_residual=False: precision as the TPU kernel #2
    (fused_head.py:689): fp32 residual h, stage activations in the weights'
    dtype, fp32 statistics, and every product accumulated in fp32 from the
    operands cast to the weights' dtype, as its _dot (preferred_element_type
    f32) and the card's GEMMs do (:func:`_dot_acc`; the block products split
    by splits as the head GEMM sums them). With quant ("int8" / "int4",
    kernel #2's stage_quant and stage_dot) each stage's fp32 input (LN +
    modulate, the attention output, silu(h1) * h2) is row-quantized as it
    is, without the bf16 rounding, each product runs on the integer twin
    :func:`head_gemm_s8_split_plain` (its K splits by splits), and qkv and
    h12 are still stored in the weights' dtype. round_residual=True: the
    blocks of kernels #3 and #4 (:func:`_block_body`, the products split by
    splits, W8A8 / W4A8 as _mmq with quant)."""
    if round_residual:
        c_dim = stacked["n2"].shape[-1]
        mc = (6 if attention else 3) * c_dim
        h = _dot_acc(torch.cat([x, x], dim=0), stacked["in_w"]) + stacked["in_b"]
        return _rounded_blocks(
            h, lambda g: mods_row[:, g * mc:(g + 1) * mc], lambda l: l // switch_freq,
            mods_row[:, -2 * c_dim:], stacked, num_blocks=num_blocks,
            attention=attention, n_head=n_head, groups=groups, bounded=bounded,
            eps=eps, splits=splits, quant=quant)
    elem = stacked["n2"].dtype
    c_dim = stacked["n2"].shape[-1]
    n_mods = 6 if attention else 3

    def stage(a):
        return a if quant else a.to(elem)

    def product(a, key, l, mode, bkey, **kw):
        """Block product ``key`` of block l with its epilogue: "bias" (qkv
        in elem), "gated_f32" (the new residual) or "swiglu" (fp32 silu(h1)
        * h2 from h1, h2 in elem)."""
        bias, sp = stacked[bkey][l], (splits or {}).get(key, 1)
        if quant:
            aq, sa = quantize_rows(a.float())
            return head_gemm_s8_split_plain(
                aq, sa, stacked[key][l], stacked[key + "_s"][l],
                "swiglu_q" if mode == "swiglu" else mode, bias, splits=sp, quant=quant, **kw)
        y = _dot_acc_split(a, stacked[key][l], sp) + bias.float()
        if mode == "bias":
            return y.to(elem)
        if mode == "gated_f32":
            return _gated_f32(kw["resid"], y, kw["gate"])
        return _swiglu_f32(y.to(elem))

    def lnmod(h, nrm, scale, shift):
        ln = _ln(h, eps) * nrm[0].float() + nrm[1].float()
        return stage(ln * (1.0 + scale.float()) + shift.float())

    combined = torch.cat([x, x], dim=0)
    h = _dot_acc(combined, stacked["in_w"]) + stacked["in_b"]
    for l in range(num_blocks):
        g = l // switch_freq
        m = mods_row[:, g * n_mods * c_dim:(g + 1) * n_mods * c_dim]
        sl = lambda j: m[:, j * c_dim:(j + 1) * c_dim]   # noqa: E731
        mlp = 0
        if attention:
            qkv = product(lnmod(h, stacked["n1"][l], sl(0), sl(1)), "wqkv", l, "bias", "bqkv")
            att = stage(_attn_from_qkv(qkv, n_head, groups, c_dim))
            h = product(att, "wo", l, "gated_f32", "bo", gate=sl(2), resid=h)
            mlp = 3
        a = lnmod(h, stacked["n2"][l], sl(mlp), sl(mlp + 1))
        glu = stage(product(a, "w1", l, "swiglu", "b1"))
        h = product(glu, "w2", l, "gated_f32", "b2", gate=sl(mlp + 2), resid=h)
    fm = mods_row[:, -2 * c_dim:].float()
    z = _ln(h, eps) * (1.0 + fm[:, :c_dim]) + fm[:, c_dim:]
    out = _dot_acc(z, stacked["f_out_w"]) + stacked["f_out_b"]
    return 2.0 * torch.sigmoid(out) - 1.0 if bounded else out


def _net_forward_tp(stacked: dict, x: torch.Tensor, mods_row: torch.Tensor, *,
                    num_blocks: int, switch_freq: int, n_head: int, groups: int,
                    attention: bool = True, bounded: bool = True,
                    quant: str | None = None, glue: torch.dtype = torch.float32,
                    eps: float = 1e-6) -> torch.Tensor:
    """One net call of the tensor-parallel sampler on a head-major stack:
    every block product on the head GEMM, and with a ``"tp"`` entry
    (parallel/tp.py::HeadShards) as this rank's shares, qkv and h12 on its
    local heads and a row-parallel product's sums all-reduced before its
    bias (:func:`_tp_product`).

    A bf16 or fp32 stack at fp32 glue keeps :func:`_net_forward`'s
    fp32-residual route (kernel #2's precision; on one device the head-major
    sampler equals the canonical one bit for bit). Otherwise (a quantized
    stack, ``quant``, or bf16 ``glue``) the blocks follow the JAX
    _block_body_xla op by op with elem = glue: the residual h, the mods,
    the modulated LN outputs and proj / h12 / mlp_out in elem; qkv fp32
    (the product plus its bias) and attention in fp32 on the local heads;
    silu(h1) as jax.nn.silu computes it, h1 * sigmoid(h1), each op in elem."""
    c_dim = stacked["n2"].shape[-1]
    n_mods = 6 if attention else 3
    shards = stacked.get("tp")
    place = shards.placements if shards is not None else {}
    # the heads of this rank's qkv and h12 (all of them unless column-parallel)
    n_local = n_head // shards.group.size if place.get("w1") == "col" else n_head
    c_local = c_dim * n_local // n_head
    twin = quant is not None or glue != torch.float32
    elem = glue if twin else stacked["n2"].dtype

    def product(a, key, l, bkey):
        """fp32 a @ w.T + bias of block l's product ``key``."""
        y = _tp_product(a, stacked, key, l, place.get(key) == "row",
                        shards.group if shards is not None else None, quant)
        return y + stacked[bkey][l].float()

    def lnmod(h, nrm, scale, shift):
        if twin:        # JAX moded(): each op in elem
            ln = _ln(h, eps).to(elem) * nrm[0].to(elem) + nrm[1].to(elem)
            return ln * (1.0 + scale) + shift
        ln = _ln(h, eps) * nrm[0].float() + nrm[1].float()
        return (ln * (1.0 + scale.float()) + shift.float()).to(elem)

    h = _dot_acc(torch.cat([x, x], dim=0), stacked["in_w"]) + stacked["in_b"]
    if twin:
        h = h.to(elem)
    for l in range(num_blocks):
        g = l // switch_freq
        m = mods_row[:, g * n_mods * c_dim:(g + 1) * n_mods * c_dim]
        if twin:
            m = m.to(elem)
        sl = lambda j: m[:, j * c_dim:(j + 1) * c_dim]   # noqa: E731
        mlp = 0
        if attention:
            qkv = product(lnmod(h, stacked["n1"][l], sl(0), sl(1)), "wqkv", l, "bqkv")
            if not twin:
                qkv = qkv.to(elem)
            att = _attn_from_qkv(qkv, n_local, groups, c_local, head_major=True)
            if twin:
                h = h + product(att, "wo", l, "bo").to(elem) * sl(2)
            else:
                h = _gated_f32(h, product(att.to(elem), "wo", l, "bo"), sl(2))
            mlp = 3
        a = lnmod(h, stacked["n2"][l], sl(mlp), sl(mlp + 1))
        h12 = _from_head_major(product(a, "w1", l, "b1").to(elem), n_local, 2)
        if twin:
            hidden = h12.shape[1] // 2
            h1 = h12[:, :hidden]
            glu = h1 * torch.sigmoid(h1) * h12[:, hidden:]      # jax.nn.silu: x * sigmoid(x)
            h = h + product(glu, "w2", l, "b2").to(elem) * sl(mlp + 2)
        else:
            glu = _swiglu_f32(h12).to(elem)
            h = _gated_f32(h, product(glu, "w2", l, "b2"), sl(mlp + 2))
    fm = mods_row[:, -2 * c_dim:].float()
    z = _ln(h, eps) * (1.0 + fm[:, :c_dim]) + fm[:, c_dim:]
    out = _dot_acc(z, stacked["f_out_w"]) + stacked["f_out_b"]
    return 2.0 * torch.sigmoid(out) - 1.0 if bounded else out


def _tp_product(a: torch.Tensor, stacked: dict, key: str, l: int, row: bool, group,
                quant: str | None) -> torch.Tensor:
    """fp32 a @ w.T (no bias) of block l's product ``key`` on this rank.
    A row-parallel weight (``row``) holds this rank's in-features: a whole
    input is cut to them, the partial sums are all-reduced over ``group``.
    bf16 / fp32 weights: the head GEMM's fp32 sums (:func:`_head_gemm_sums`),
    an fp32 all-reduce. Quantized (JAX _mmq): the input quantized per row
    in fp32, the scale from the whole row's max |a| (a share's max
    all-reduced by MAX first, so that every rank's int32 partials are in
    the same units), the exact int32 sums on the head GEMM ("out_s32"),
    all-reduced as int32, then float(acc) * (sa * ws)."""
    w = stacked[key][l]
    k = w.shape[1] * (2 if quant == "int4" else 1)
    whole = row and a.shape[1] != k
    if quant is None:
        if whole:
            a = a[:, group.rank * k:(group.rank + 1) * k]
        y = _head_gemm_sums(a, w)
        return group.all_reduce(y) if row else y
    a = a.float()
    amax = a.abs().amax(dim=1)
    if whole:
        a = a[:, group.rank * k:(group.rank + 1) * k]
    elif row:
        amax = group.all_reduce(amax, op="max")
    aq, sa = quantize_rows(a, amax)
    acc = _head_gemm_int_sums(aq.contiguous(), w, quant)
    if row:
        acc = group.all_reduce(acc)
    return _dequant(acc, sa, stacked[key + "_s"][l])


def _head_gemm_sums(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """fp32 sums a @ w.T of one product of the head-major sampler on the
    head GEMM ("out_f32": no bias, no epilogue), a cast to w's dtype. On the
    CPU a shape the card's GEMM cannot tile (a test's narrow head) takes
    one fp32 pass (:func:`_dot_acc`); on the card it raises."""
    a = a.to(w.dtype).contiguous()
    if a.is_cpu:
        try:
            head_gemm_plan(a.shape[0], *w.shape)
        except ValueError:
            return _dot_acc(a, w)
    return head_gemm(a, w, "out_f32", None)


def _head_gemm_int_sums(aq: torch.Tensor, w: torch.Tensor, quant: str) -> torch.Tensor:
    """The exact int32 sums aq @ w.T of one quantized product of the
    head-major sampler on the head GEMM's integer kinds ("out_s32"; w int8
    [N, K] or packed int4 [N, K/2]). On the CPU a shape the card's GEMM
    cannot tile takes :func:`_int_acc` in one pass; on the card it raises."""
    if aq.is_cpu:
        try:
            head_gemm_plan(aq.shape[0], w.shape[0], aq.shape[1], quant=quant)
        except ValueError:
            return _int_acc(aq, w, 1, quant).to(torch.int32)
    return head_gemm_s8(aq, None, w, None, "out_s32", None, quant=quant)


def _as_floats(t) -> list[float]:
    if isinstance(t, torch.Tensor):
        return [float(v) for v in t.detach().float().cpu()]
    return [float(v) for v in t]


def fused_em_sample_reference(stacked: dict, x0: torch.Tensor,
                              noise: torch.Tensor, allmods: torch.Tensor,
                              t_all, dt_all, cfg: float, *, num_blocks: int,
                              num_ada: int, n_head: int = 0, groups: int = 1,
                              attention: bool = True, bounded: bool = True,
                              last_step_size: float = 0.05,
                              final_chunk: bool = True,
                              quant: str | None = None,
                              round_residual: bool | None = None,
                              splits: dict | None = None) -> torch.Tensor:
    """Plain PyTorch version of :func:`fused_em_sample` (same arguments).
    On a bf16 or fp32 stack, splits ({"w1": S, ...}: the split counts of
    :func:`sampler_plans`) sums each block product's K splits as the card's
    head GEMM does; None sums each in one pass."""
    if "hm_marker" in stacked:
        raise ValueError("fused_em_sample_reference: a head-major stack runs "
                         "em_sample_stacked")
    if round_residual is None:
        round_residual = rounds_residual(stacked, num_blocks, attention)
    kw = dict(num_blocks=num_blocks, switch_freq=max(1, num_blocks // num_ada),
              n_head=n_head, groups=groups, attention=attention, bounded=bounded,
              quant=quant_mode(quant), round_residual=round_residual, splits=splits)
    return _em_loop(lambda x, s: _net_forward(stacked, x, allmods[s], **kw),
                    x0, noise, t_all, dt_all, cfg, last_step_size, final_chunk)


def _em_loop(net, x0: torch.Tensor, noise: torch.Tensor, t_all, dt_all, cfg: float,
             last_step_size: float, final_chunk: bool) -> torch.Tensor:
    """The guided Euler-Maruyama loop over ``net(x, s)`` (step s's net call
    on rows [x; x] -> fp32 [R, ch])."""
    num_steps = noise.shape[0]
    half = x0.shape[0]
    ts, dts = _as_floats(t_all), _as_floats(dt_all)
    cfg = float(cfg)
    x = x0.float()
    for s in range(num_steps + (1 if final_chunk else 0)):
        out = net(x, s)
        t, dt = ts[s], dts[s]
        combined = torch.cat([x, x], dim=0)
        v = (out - combined) / max(1.0 - t, 0.05)
        vc = v[half:] + cfg * (v[:half] - v[half:])
        if s < num_steps:
            var = (1.0 - t) ** 2 + t * (1.0 - t)
            score = (t * vc - x) / var
            drift = vc + (1.0 - t) * score
            ns = math.sqrt(2.0 * (1.0 - t) * dt)
            x = x + drift * dt + ns * noise[s].float()
        else:
            x = x + vc * last_step_size
    return x


def em_sample_stacked(stacked: dict, x0: torch.Tensor, noise: torch.Tensor,
                      allmods: torch.Tensor | None, t_all, dt_all, cfg: float,
                      *, num_blocks: int, num_ada: int, n_head: int = 0,
                      groups: int = 1, attention: bool = True,
                      bounded: bool = True, last_step_size: float = 0.05,
                      c_emb: torch.Tensor | None = None,
                      quant: str | None = None, mods_chunks: int = 1,
                      glue_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Counterpart of the JAX stacked sampler (JAX fused_head.py:1382): the plain
    sampler, computing the mods from c_emb when allmods is not given (W8A8
    on a quantized stack). ``mods_chunks`` > 1 (it must divide the step
    count; c_emb given) computes them a chunk of steps at a time inside the
    step loop, and the final step's from its own timestep, so that one
    chunk's mods are held at a time; the values are the same (each mods row
    is computed on its own). A canonical stack runs kernel #2's plain
    version (an fp32 residual; ``glue_dtype`` other than fp32 raises). A
    head-major stack runs the tensor-parallel sampler
    (:func:`_net_forward_tp`, with ``glue_dtype`` its elementwise dtype):
    its block products launch the head GEMM on CUDA tensors."""
    mode = quant_mode(quant)
    head_major = "hm_marker" in stacked
    if not head_major and glue_dtype != torch.float32:
        raise ValueError("em_sample_stacked: a canonical stack runs kernel #2's plain "
                         "version, whose residual is fp32; glue_dtype is the head-major "
                         "sampler's")
    mods = _step_mods(stacked, allmods, c_emb, t_all, noise.shape[0], mods_chunks)
    kw = dict(num_blocks=num_blocks, switch_freq=max(1, num_blocks // num_ada),
              n_head=n_head, groups=groups, attention=attention, bounded=bounded, quant=mode)
    if head_major:
        def net(x, s):
            return _net_forward_tp(stacked, x, mods(s), glue=glue_dtype, **kw)
    else:
        def net(x, s):
            return _net_forward(stacked, x, mods(s), round_residual=False, **kw)
    return _em_loop(net, x0, noise, t_all, dt_all, cfg, last_step_size, True)


def _step_mods(stacked: dict, allmods: torch.Tensor | None, c_emb: torch.Tensor | None,
               t_all, num_steps: int, mods_chunks: int):
    """step s -> its mods [R, W] (s = num_steps: the final step's) for
    :func:`em_sample_stacked`: from allmods, else from c_emb in the stack's
    dtype, all at once or ``mods_chunks`` chunks of num_steps / mods_chunks
    steps, each computed when the loop reaches it (the timestep MLP once)."""
    if allmods is not None:
        if mods_chunks > 1:
            raise ValueError("em_sample_stacked: mods_chunks computes the mods from c_emb; "
                             "pass allmods=None")
        return allmods.__getitem__
    if c_emb is None:
        raise ValueError("em_sample_stacked: allmods or c_emb is needed")
    dtype = stacked["in_w"].dtype
    te = em_time_embed(stacked, torch.as_tensor(t_all), c_emb.device)   # [S + 1, C]
    if mods_chunks <= 1:
        return _mods_of(stacked, c_emb, te, dtype).__getitem__
    if num_steps % mods_chunks:
        raise ValueError(f"em_sample_stacked: mods_chunks {mods_chunks} does not divide "
                         f"{num_steps} steps")
    per = num_steps // mods_chunks
    held: dict = {}

    def at(s: int) -> torch.Tensor:
        c = s // per          # the final step is chunk mods_chunks: te[S:S+1] alone
        if c not in held:
            held.clear()
            held[c] = _mods_of(stacked, c_emb, te[c * per:(c + 1) * per], dtype)
        return held[c][s - c * per]

    return at


_MLP_KEYS = ("n2", "w1", "b1", "w2", "b2")
_ATTN_KEYS = ("n1", "wqkv", "bqkv", "wo", "bo")


def fused_em_sample(stacked: dict, x0: torch.Tensor, noise: torch.Tensor,
                    allmods: torch.Tensor, t_all, dt_all, cfg: float, *,
                    num_blocks: int, num_ada: int, n_head: int = 0,
                    groups: int = 1, attention: bool = True,
                    bounded: bool = True, last_step_size: float = 0.05,
                    final_chunk: bool = True,
                    quant: str | bool | None = None,
                    _pdl: bool = True) -> torch.Tensor:
    """The whole EM sampling loop; dispatch by device.

    x0 [half, ch] f32 (cond rows); noise [num_steps, half, ch] f32; allmods
    [S, R, W] (S = num_steps + 1, or num_steps when final_chunk=False, which
    runs num_steps EM updates and no final Euler step and returns the
    post-EM state); t_all/dt_all [S] (host values; a CPU tensor or a list
    avoids a device sync); cfg a float. CFG rows are [cond; uncond].
    attention selects the head family (groups and n_head matter only for
    it; the MlpEncoder's rows are independent), bounded the 2*sigmoid-1
    output. quant ("int8" or True, "int4"; the stack built with the same
    mode) runs the W8A8 / W4A8 products of the TPU kernels' quant mode.
    :func:`rounds_residual` decides from the stack, as the JAX router does,
    whether the residual is carried in the weights' dtype, as kernels #3
    and #4 do (both families, bf16 or quantized), or in fp32, as kernel #2
    does (the TransEncoder, bf16 or quantized). A bf16 stack runs its block
    products on the head GEMM on both routes (:func:`sampler_plans`; a C or
    H it cannot tile raises), every launch of its chain programmatic
    (``_pdl=False`` only to measure what that saves). A quantized stack runs
    them on the head GEMM's integer kinds (:func:`sampler_plans` with the
    mode), its GEMMs programmatic and its stage kernels plain on kernel
    #2's route, programmatic on the round route. CPU tensors take
    :func:`fused_em_sample_reference`; CUDA tensors run
    ``csrc/fused_head.cu`` (bf16 weights, norms, biases and mods; int8 block
    matrices with f32 scales when quantized) or raise.
    """
    mode = quant_mode(quant)
    if x0.device.type not in ("cpu", "cuda"):
        raise RuntimeError(f"fused_em_sample: no kernel for {x0.device}")
    round_residual = rounds_residual(stacked, num_blocks, attention)
    kw = dict(num_blocks=num_blocks, num_ada=num_ada, n_head=n_head,
              groups=groups, attention=attention, bounded=bounded,
              last_step_size=last_step_size, final_chunk=final_chunk)
    if x0.device.type == "cpu":
        return fused_em_sample_reference(stacked, x0, noise, allmods, t_all,
                                         dt_all, cfg, quant=mode,
                                         round_residual=round_residual, **kw)
    if "hm_marker" in stacked:
        raise ValueError("fused_em_sample: the kernel takes the canonical layout; a "
                         "head-major stack runs em_sample_stacked")
    if mode is not None and not attention and not round_residual:
        raise ValueError("fused_em_sample: a quantized MlpEncoder stack runs on the "
                         "round route (kernels #3/#4); the JAX router never sends "
                         "one to kernel #2")
    mats = ("w1", "w2") + (("wqkv", "wo") if attention else ())
    keys = list(_MLP_KEYS) + (list(_ATTN_KEYS) if attention else []) \
        + ["in_w", "f_out_w"]
    _cuda.refuse_grad("fused_em_sample", x0, noise, allmods,
                      *[stacked[k] for k in keys])
    num_steps = noise.shape[0]
    grid_steps = num_steps + (1 if final_chunk else 0)
    half, ch = x0.shape
    rows = 2 * half
    c_dim = stacked["n2"].shape[-1]
    hidden = stacked["b1"].shape[1] // 2
    dev = x0.device
    for k in keys:
        t = stacked[k]
        want = torch.int8 if (mode and k in mats) else torch.bfloat16
        if t.dtype != want or not t.is_contiguous() or t.device != dev:
            raise ValueError(f"fused_em_sample: stacked[{k!r}] must be "
                             f"contiguous {want} on {dev}, got {t.dtype}")
    if mode is not None:
        div = 2 if mode == "int4" else 1
        shapes = {"wqkv": (3 * c_dim, c_dim), "wo": (c_dim, c_dim),
                  "w1": (2 * hidden, c_dim), "w2": (c_dim, hidden)}
        for k in mats:
            n_out, k_in = shapes[k]
            sc = stacked[k + "_s"]
            if tuple(stacked[k].shape) != (num_blocks, n_out, k_in // div) or \
                    sc.dtype != torch.float32 or tuple(sc.shape) != (num_blocks, n_out) \
                    or not sc.is_contiguous() or sc.device != dev:
                raise ValueError(f"fused_em_sample: {mode} stack {k!r} "
                                 f"{tuple(stacked[k].shape)} / scales "
                                 f"{tuple(sc.shape)} {sc.dtype} do not match")
    width = (num_ada * (6 if attention else 3) + 2) * c_dim
    if allmods.dtype != torch.bfloat16 or tuple(allmods.shape) != \
            (grid_steps, rows, width) or not allmods.is_contiguous():
        raise ValueError("fused_em_sample: allmods must be contiguous bf16 "
                         f"[{grid_steps}, {rows}, {width}], got "
                         f"{allmods.dtype} {tuple(allmods.shape)}")
    if tuple(noise.shape[1:]) != (half, ch):
        raise ValueError(f"fused_em_sample: noise {tuple(noise.shape)} does "
                         f"not match x0 {tuple(x0.shape)}")
    ts = torch.tensor(_as_floats(t_all), dtype=torch.float32)
    dts = torch.tensor(_as_floats(dt_all), dtype=torch.float32)
    if ts.numel() < grid_steps or dts.numel() < grid_steps:
        raise ValueError("fused_em_sample: t_all/dt_all shorter than the grid")
    x = x0.to(torch.float32).clone()
    noise = noise.to(device=dev, dtype=torch.float32).contiguous()
    in_b = stacked["in_b"].to(device=dev, dtype=torch.float32).contiguous()
    f_out_b = stacked["f_out_b"].to(device=dev, dtype=torch.float32).contiguous()
    h = torch.empty((rows, c_dim), dtype=torch.float32, device=dev)
    wide = max(c_dim, hidden)
    act = torch.empty((rows, wide), dtype=torch.bfloat16, device=dev)
    buf = torch.empty((rows, max(3 * c_dim if attention else 0, hidden)),
                      dtype=torch.bfloat16, device=dev)
    ptr = lambda k: stacked[k].data_ptr() if k in stacked else None  # noqa: E731
    q_ptrs = [None] * 7
    if mode is not None:
        # fp32 stage inputs, their int8 rows and the row scales
        qbufs = (torch.empty((rows, wide), dtype=torch.float32, device=dev),
                 torch.empty((rows, wide), dtype=torch.int8, device=dev),
                 torch.empty((rows,), dtype=torch.float32, device=dev))
        q_ptrs = [ptr(k + "_s") for k in ("wqkv", "wo", "w1", "w2")] \
            + [t.data_ptr() for t in qbufs]
    # the products on the head GEMM (bf16, or its integer kinds): their
    # plans (qkv, wo, w1, w2; unused ones zero); a shape it cannot take raises
    gemm_plan = torch.zeros(12, dtype=torch.int32)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    try:
        plans = sampler_plans(rows, c_dim, hidden, attention, sms, mode)
    except ValueError as e:
        raise ValueError(f"fused_em_sample: C = {c_dim}, H = {hidden} do not fit "
                         f"the head GEMM ({e})") from None
    if c_dim > 5120:
        raise ValueError(f"fused_em_sample: C = {c_dim} > 5120, the final layer's "
                         "limit")
    if attention and not round_residual and (c_dim // max(n_head, 1) != 128
                                             or rows // groups > 64):
        raise ValueError(f"fused_em_sample: kernel #2's window attention takes a "
                         f"head dim of 128 and windows of up to 64 rows, not "
                         f"{c_dim // max(n_head, 1)} and {rows // groups}")
    if mode is not None and max(c_dim, hidden) > 8192:
        raise ValueError(f"fused_em_sample: the row quantization takes rows of up to "
                         f"8192 values, not C = {c_dim}, H = {hidden}")
    for i, key in enumerate(("wqkv", "wo", "w1", "w2")):
        if key in plans:
            gemm_plan[3 * i:3 * i + 3] = torch.tensor(plans[key], dtype=torch.int32)
    lib = _cuda.load()
    code = lib.bd_fused_em_sample(
        x.data_ptr(), noise.data_ptr(), allmods.data_ptr(), allmods.shape[2],
        ts.data_ptr(), dts.data_ptr(), float(cfg),
        stacked["in_w"].data_ptr(), in_b.data_ptr(),
        stacked["f_out_w"].data_ptr(), f_out_b.data_ptr(),
        *[ptr(k) if k in keys else None
          for k in ("n1", "n2", "wqkv", "bqkv", "wo", "bo", "w1", "b1", "w2", "b2")],
        h.data_ptr(), act.data_ptr(), buf.data_ptr(),
        half, ch, c_dim, hidden, num_blocks, num_steps,
        max(1, num_blocks // num_ada), max(n_head, 1), groups,
        int(attention), int(bounded), int(final_chunk), float(last_step_size),
        _QUANT_MODES.index(mode), *q_ptrs, int(round_residual), gemm_plan.data_ptr(),
        int(_pdl), _cuda.stream_ptr())
    _cuda.check(code, "fused_em_sample")
    fused_em_sample.launches += 1
    return x


fused_em_sample.launches = 0


# ---------------------------------------------------------------------------
# Kernel #5: one whole DiffNet forward (fused_head.py:_fused_net_kernel)
# ---------------------------------------------------------------------------

def adaln_views(stacked: dict, num_ada: int, attention: bool):
    """The adaLN groups' and the final layer's modulation as row slices of
    ``modcat_w`` [A*m*C + 2C, C] and ``modcat_b``: group g is rows
    [g*m*C, (g+1)*m*C), the final layer's 2C rows come last. Views, not
    copies (the JAX package pops its separate ada_w / f_ada_w stacks, ~660 MB
    at the 14B head). Returns ([(w_g, b_g)], (f_w, f_b))."""
    if "modcat_w_s" in stacked:
        raise ValueError("adaln_views: the modulation is int8 in a quantized "
                         "stack; kernel #5 takes a bf16 or fp32 stack")
    c = stacked["n2"].shape[-1]
    mc = (6 if attention else 3) * c
    w, b = stacked["modcat_w"], stacked["modcat_b"]
    if w.shape[0] != num_ada * mc + 2 * c:
        raise ValueError(f"adaln_views: modcat_w has {w.shape[0]} rows, not "
                         f"{num_ada} groups of {mc} + {2 * c}")
    groups = [(w[g * mc:(g + 1) * mc], b[g * mc:(g + 1) * mc]) for g in range(num_ada)]
    return groups, (w[num_ada * mc:], b[num_ada * mc:])


NET_PRODUCTS = ("wqkv", "wo", "w1", "w2", "t_w0", "t_w2", "mods", "final")


def net_plans(rows: int, c: int, hidden: int, attention: bool, t_freq_size: int = 256,
              sm_count: int = 132) -> dict[str, HeadGemmPlan]:
    """:func:`head_gemm_plan` of every product of one :func:`fused_diffnet_forward`
    call at ``rows`` (:data:`NET_PRODUCTS`: the block products, t_w0 [C, t_freq],
    t_w2 [C, C], an adaLN group's [m, C] with m = 6C or 3C, the final
    modulation's [2C, C]; at H-1x's 8 rows w1 30 tiles x 4 splits, w2 10 x 8,
    the groups 30 x 4). Raises ValueError for a shape the head GEMM cannot
    take: C % 128, H % 64 or t_freq_size % 64 not 0."""
    if c % 128 or hidden % 64 or t_freq_size % 64:
        raise ValueError(f"net_plans: the head GEMM takes C % 128 == 0, H % 64 == 0 and "
                         f"t_freq % 64 == 0, not C = {c}, H = {hidden}, t_freq = "
                         f"{t_freq_size}")
    plans = sampler_plans(rows, c, hidden, attention, sm_count)
    m = (6 if attention else 3) * c
    shapes = {"t_w0": (c, t_freq_size), "t_w2": (c, c), "mods": (m, c), "final": (2 * c, c)}
    plans.update({k: head_gemm_plan(rows, n, kk, sm_count) for k, (n, kk) in shapes.items()})
    return plans


@functools.lru_cache(maxsize=64)
def _net_plan_ints(rows, c, hidden, attention, t_freq_size, sm_count):
    """net_plans as the 24 host ints of bd_fused_diffnet_forward (a plan
    the family does not run is zeros)."""
    plans = net_plans(rows, c, hidden, attention, t_freq_size, sm_count)
    flat = [v for k in NET_PRODUCTS for v in plans.get(k, (0, 0, 0))]
    return (ctypes.c_int * len(flat))(*flat)


def fused_diffnet_forward_reference(stacked: dict, x: torch.Tensor,
                                    t: torch.Tensor, c_emb: torch.Tensor, *,
                                    num_blocks: int, num_ada: int,
                                    n_head: int = 0, attention: bool = True,
                                    bounded: bool = True, t_freq_size: int = 256,
                                    eps: float = 1e-6, group_of=None,
                                    fp32_qkv_h12: bool = False,
                                    splits: dict | None = None) -> torch.Tensor:
    """Plain PyTorch version of :func:`fused_diffnet_forward` (same
    arguments), step for step as the TPU kernel #5: prologue (t-embedding
    MLP, y = silu(te + c_emb), h = x @ in_w + in_b) in fp32, the adaLN mods
    recomputed at each group boundary, :func:`_block_body` per block, then
    the final adaLN LayerNorm and output product in fp32. splits ({key of
    :data:`NET_PRODUCTS`: count}, e.g. the splits of :func:`net_plans`) sums
    each product's K splits as the card's head GEMM does (None: one pass).

    Twins for the card check, which holds the kernel away from them:
    group_of(l) picks block l's adaLN group (default l // switch), and
    fp32_qkv_h12 keeps qkv and h12 in fp32 as #15 does."""
    from bitdance_tpu_torch.models.diff_head import timestep_embedding

    squeeze = x.ndim == 2
    xg = x[None] if squeeze else x
    g, w, ch = xg.shape
    rows = g * w
    c = stacked["n2"].shape[-1]
    switch = max(1, num_blocks // num_ada)
    ada, (f_w, f_b) = adaln_views(stacked, num_ada, attention)
    sp = splits or {}

    def dot(a, w, key):
        return _dot_acc_split(a, w, sp.get(key, 1))

    tf = timestep_embedding(t.reshape(rows).float(), t_freq_size)
    te = dot(tf, stacked["t_w0"], "t_w0") + stacked["t_b0"]
    te = dot(F.silu(te), stacked["t_w2"], "t_w2") + stacked["t_b2"]
    y = F.silu(te + c_emb.reshape(rows, c).float())
    h = _dot_acc(xg.reshape(rows, ch).float(), stacked["in_w"]) + stacked["in_b"]
    out = _rounded_blocks(
        h, lambda gi: dot(y, ada[gi][0], "mods") + ada[gi][1],
        group_of or (lambda l: l // switch), dot(y, f_w, "final") + f_b, stacked,
        num_blocks=num_blocks, attention=attention, n_head=n_head, groups=g,
        bounded=bounded, eps=eps, fp32_qkv_h12=fp32_qkv_h12, splits=splits)
    return out.reshape(x.shape).to(x.dtype)


def net_launches(num_blocks: int, num_ada: int, attention: bool) -> int:
    """Kernel launches of one :func:`fused_diffnet_forward` call on the card:
    6 for the prologue, 2 per adaLN group, 3 per MlpEncoder block or 7 per
    TransEncoder block, 2 for the final layer (csrc/fused_net.cu)."""
    switch = max(1, num_blocks // num_ada)
    groups = len(range(0, num_blocks, switch))
    return 6 + 2 * groups + (7 if attention else 3) * num_blocks + 2


def fused_diffnet_forward(stacked: dict, x: torch.Tensor, t: torch.Tensor,
                          c_emb: torch.Tensor, *, num_blocks: int, num_ada: int,
                          n_head: int = 0, attention: bool = True,
                          bounded: bool = True, t_freq_size: int = 256,
                          _pdl: bool = True) -> torch.Tensor:
    """One whole DiffNet forward; dispatch by device.

    x [G, W, ch] (TransEncoder: G groups of W window rows) or [R, ch]
    (MlpEncoder: independent rows); t the leading dims of x; c_emb the
    leading dims of x and C (cond @ cond_w + cond_b, computed by the
    caller). Returns x's shape and dtype. ``stacked`` is
    :func:`stack_diffnet_params`' layout (unquantized); the adaLN groups are
    read from modcat_w (:func:`adaln_views`). CPU tensors take
    :func:`fused_diffnet_forward_reference`; CUDA tensors run
    ``csrc/fused_net.cu`` on a bf16 stack (an fp32 stack raises), every
    product on the head GEMM by :func:`net_plans` (a shape it cannot take
    raises) and every launch programmatic (``_pdl=False`` only to measure
    what that saves)."""
    kw = dict(num_blocks=num_blocks, num_ada=num_ada, n_head=n_head,
              attention=attention, bounded=bounded, t_freq_size=t_freq_size)
    if x.device.type == "cpu":
        return fused_diffnet_forward_reference(stacked, x, t, c_emb, **kw)
    if x.device.type != "cuda":
        raise RuntimeError(f"fused_diffnet_forward: no kernel for {x.device}")
    keys = list(_MLP_KEYS) + (list(_ATTN_KEYS) if attention else []) \
        + ["in_w", "t_w0", "t_w2", "f_out_w", "modcat_w"]
    f32_keys = ["in_b", "t_b0", "t_b2", "f_out_b", "modcat_b"]
    _cuda.refuse_grad("fused_diffnet_forward", x, t, c_emb,
                      *[stacked[k] for k in keys])
    adaln_views(stacked, num_ada, attention)         # shape check
    dev = x.device
    for k in keys + f32_keys:
        want = torch.float32 if k in f32_keys else torch.bfloat16
        v = stacked[k]
        if v.dtype != want or not v.is_contiguous() or v.device != dev:
            raise ValueError(f"fused_diffnet_forward: stacked[{k!r}] must be "
                             f"contiguous {want} on {dev}, got {v.dtype} on "
                             f"{v.device}")
    squeeze = x.ndim == 2
    groups, w = (1, x.shape[0]) if squeeze else x.shape[:2]
    rows, ch = groups * w, x.shape[-1]
    c = stacked["n2"].shape[-1]
    hidden = stacked["b1"].shape[1] // 2
    switch = max(1, num_blocks // num_ada)
    if (num_blocks - 1) // switch >= num_ada or ch > 32:
        raise ValueError(f"fused_diffnet_forward: {num_blocks} blocks need "
                         f"{(num_blocks - 1) // switch + 1} adaLN groups, the "
                         f"stack has {num_ada}; ch = {ch} (at most 32)")
    if (tuple(t.shape) != tuple(x.shape[:-1])
            or tuple(c_emb.shape) != tuple(x.shape[:-1]) + (c,)):
        raise ValueError(f"fused_diffnet_forward: t {tuple(t.shape)} and c_emb "
                         f"{tuple(c_emb.shape)} do not match x {tuple(x.shape)}")
    if (tuple(stacked["in_w"].shape) != (c, ch)
            or tuple(stacked["t_w0"].shape) != (c, t_freq_size)):
        raise ValueError(f"fused_diffnet_forward: in_w {tuple(stacked['in_w'].shape)}"
                         f" / t_w0 {tuple(stacked['t_w0'].shape)} do not fit C = "
                         f"{c}, ch = {ch}, t_freq_size = {t_freq_size}")
    try:
        plan = _net_plan_ints(rows, c, hidden, attention, t_freq_size,
                              _cuda.sm_count(dev.index))
    except ValueError as e:
        raise ValueError(f"fused_diffnet_forward: {e}") from None
    xf = x.reshape(rows, ch).float().contiguous()
    tf = t.reshape(rows).float().contiguous()
    cf = c_emb.reshape(rows, c).float().contiguous()
    m = (6 if attention else 3) * c
    f32 = lambda *s: torch.empty(s, dtype=torch.float32, device=dev)  # noqa: E731
    b16 = lambda *s: torch.empty(s, dtype=torch.bfloat16, device=dev)  # noqa: E731
    out = f32(rows, ch)
    scratch = dict(tfreq=b16(rows, t_freq_size), f32buf=f32(rows, max(m, 2 * c)),
                   h=f32(rows, c), y=f32(rows, c), y16=b16(rows, c),
                   mods=b16(rows, m), act=b16(rows, max(c, hidden)),
                   buf=b16(rows, max(3 * c if attention else 0, hidden)))
    ptr = lambda k: stacked[k].data_ptr() if k in stacked else None  # noqa: E731
    code = _cuda.load().bd_fused_diffnet_forward(
        xf.data_ptr(), tf.data_ptr(), cf.data_ptr(), out.data_ptr(),
        *[ptr(k) for k in ("in_w", "in_b", "t_w0", "t_b0", "t_w2", "t_b2",
                           "modcat_w", "modcat_b", "f_out_w", "f_out_b",
                           "n1", "n2", "wqkv", "bqkv", "wo", "bo",
                           "w1", "b1", "w2", "b2")],
        *[v.data_ptr() for v in scratch.values()],
        groups, w, ch, c, hidden, num_blocks, num_ada, switch, max(n_head, 1),
        t_freq_size, int(attention), int(bounded), plan, int(_pdl), _cuda.stream_ptr())
    _cuda.check(code, "fused_diffnet_forward")
    fused_diffnet_forward.launches += 1
    return out.reshape(x.shape).to(x.dtype)


fused_diffnet_forward.launches = 0
