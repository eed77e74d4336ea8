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
JAX package's W8A8 / W4A8 sampler): the four block matrices are stored
per output row, wqkv [L, 3C, C] int8 or [L, 3C, C/2] packed (k, k + C/2),
with f32 scales wqkv_s [L, 3C] (likewise wo, w1, w2); modcat_w is int8
with modcat_w_s whatever the block format. Each stage's input is quantized
per row to int8 once (``quantize_rows``) and each product runs s8 x s8 ->
s32 with the scales applied to the sum. The mode reaches the sampler as an
explicit ``quant`` argument, not from the stored shapes.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from bitdance_tpu_torch.ops import _cuda
from bitdance_tpu_torch.ops.int4 import int4_matmul_reference, quantize_linear_int4
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


def _dot(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a @ w.T with a cast to w's dtype, returned as float32. (In bf16 the
    product is rounded to bf16 before the cast; the JAX dot keeps fp32.)"""
    return torch.matmul(a.to(w.dtype), w.t()).float()


def _mmq(a: torch.Tensor, w: torch.Tensor, scale: torch.Tensor | None,
         int4: bool = False) -> torch.Tensor:
    """a @ w.T -> float32: the plain product (scale None), or W8A8 / W4A8:
    a quantized per row from float32, the integer sum exact, then
    acc * (sa * scale). int4: w is packed [out, in/2] and each nibble plane
    contracts its half of a."""
    if scale is None:
        return _dot(a, w)
    if int4:
        return int4_matmul_reference(*quantize_rows(a.float()), w, scale)
    return int8_matmul(a.float(), QTensor(w, scale))


def _ln(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm without affine, one-pass E[x^2] - E[x]^2 statistics in fp32
    (the TPU kernels' _ln)."""
    x = x.float()
    mean = x.mean(dim=-1, keepdim=True)
    var = (x.square().mean(dim=-1, keepdim=True) - mean.square()).clamp_min(0.0)
    return (x - mean) * torch.rsqrt(var + eps)


def em_precompute(stacked: dict, c_emb: torch.Tensor, t_all: torch.Tensor,
                  t_freq_size: int = 256,
                  out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """adaLN + final-layer mods of EVERY sampler timestep in one product.

    c_emb: [R, C] fp32 (cond_embed applied; rows [cond; uncond]); t_all [S]
    (any device). Returns allmods [S, R, A*6*C + 2C] in out_dtype."""
    from bitdance_tpu_torch.models.diff_head import timestep_embedding

    t_all = t_all.to(device=c_emb.device, dtype=torch.float32)
    tf = timestep_embedding(t_all, t_freq_size)
    te = _dot(tf, stacked["t_w0"]) + stacked["t_b0"]
    te = _dot(F.silu(te), stacked["t_w2"]) + stacked["t_b2"]
    y = F.silu(te[:, None, :] + c_emb[None])                # [S, R, C]
    s_dim, r_dim, c_dim = y.shape
    # W8A8 on a quantized stack (plain torch: torch._int_mm on the card)
    allmods = _mmq(y.reshape(s_dim * r_dim, c_dim), stacked["modcat_w"],
                   stacked.get("modcat_w_s")) + stacked["modcat_b"]
    return allmods.to(out_dtype).reshape(s_dim, r_dim, -1)


def _attn_from_qkv(qkv: torch.Tensor, n_head: int, groups: int,
                   c_dim: int) -> torch.Tensor:
    """Window attention over packed qkv [R, 3C] (column order (3, n_head,
    hd)) -> fp32 [R, C]; q is scaled (and rounded to qkv's dtype) first."""
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


def _net_forward(stacked: dict, x: torch.Tensor, mods_row: torch.Tensor, *,
                 num_blocks: int, switch_freq: int, n_head: int, groups: int,
                 attention: bool = True, bounded: bool = True,
                 quant: str | None = None, eps: float = 1e-6) -> torch.Tensor:
    """One DiffNet forward on rows [x; x] with precomputed mods -> fp32
    [R, ch]. Precision as the TPU kernel #2 (fused_head.py:689), for both
    families: fp32 residual h, stage activations in the weights' dtype,
    fp32 statistics. With quant ("int8" / "int4", kernel #2's stage_quant
    and stage_dot) each stage's fp32 input (LN + modulate, the attention
    output, silu(h1) * h2) is row-quantized as it is, without the bf16
    rounding, and qkv and h12 are still stored in the weights' dtype."""
    elem = stacked["n2"].dtype
    c_dim = stacked["n2"].shape[-1]
    hidden = stacked["b1"].shape[1] // 2
    n_mods = 6 if attention else 3
    int4 = quant == "int4"

    def stage(a):
        return a if quant else a.to(elem)

    def prod(a, key, l):
        return _mmq(a, stacked[key][l], stacked[key + "_s"][l] if quant else None,
                    int4)

    def lnmod(h, nrm, scale, shift):
        ln = _ln(h, eps) * nrm[0].float() + nrm[1].float()
        return stage(ln * (1.0 + scale.float()) + shift.float())

    combined = torch.cat([x, x], dim=0)
    h = _dot(combined, stacked["in_w"]) + stacked["in_b"]
    for l in range(num_blocks):
        g = l // switch_freq
        m = mods_row[:, g * n_mods * c_dim:(g + 1) * n_mods * c_dim]
        sl = lambda j: m[:, j * c_dim:(j + 1) * c_dim]   # noqa: E731
        mlp = 0
        if attention:
            a = lnmod(h, stacked["n1"][l], sl(0), sl(1))
            qkv = (prod(a, "wqkv", l) + stacked["bqkv"][l].float()).to(elem)
            att = stage(_attn_from_qkv(qkv, n_head, groups, c_dim))
            proj = prod(att, "wo", l) + stacked["bo"][l].float()
            h = h + proj * sl(2).float()
            mlp = 3
        a = lnmod(h, stacked["n2"][l], sl(mlp), sl(mlp + 1))
        h12 = (prod(a, "w1", l) + stacked["b1"][l].float()).to(elem)
        glu = stage(F.silu(h12[:, :hidden].float()) * h12[:, hidden:].float())
        y = prod(glu, "w2", l) + stacked["b2"][l].float()
        h = h + y * sl(mlp + 2).float()
    fm = mods_row[:, -2 * c_dim:].float()
    z = _ln(h, eps) * (1.0 + fm[:, :c_dim]) + fm[:, c_dim:]
    out = _dot(z, stacked["f_out_w"]) + stacked["f_out_b"]
    return 2.0 * torch.sigmoid(out) - 1.0 if bounded else out


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
                              quant: str | None = None) -> torch.Tensor:
    """Plain PyTorch version of :func:`fused_em_sample` (same arguments)."""
    num_steps = noise.shape[0]
    switch_freq = max(1, num_blocks // num_ada)
    half = x0.shape[0]
    ts, dts = _as_floats(t_all), _as_floats(dt_all)
    cfg = float(cfg)
    x = x0.float()
    kw = dict(num_blocks=num_blocks, switch_freq=switch_freq, n_head=n_head,
              groups=groups, attention=attention, bounded=bounded,
              quant=quant_mode(quant))
    for s in range(num_steps + (1 if final_chunk else 0)):
        out = _net_forward(stacked, x, allmods[s], **kw)
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
                      quant: str | None = None) -> torch.Tensor:
    """Counterpart of the JAX stacked sampler: the plain sampler, computing
    allmods from c_emb when it is not given (W8A8 on a quantized stack)."""
    if allmods is None:
        allmods = em_precompute(stacked, c_emb, torch.as_tensor(t_all),
                                out_dtype=stacked["in_w"].dtype)
    return fused_em_sample_reference(
        stacked, x0, noise, allmods, t_all, dt_all, cfg,
        num_blocks=num_blocks, num_ada=num_ada, n_head=n_head, groups=groups,
        attention=attention, bounded=bounded, last_step_size=last_step_size,
        quant=quant)


_MLP_KEYS = ("n2", "w1", "b1", "w2", "b2")
_ATTN_KEYS = ("n1", "wqkv", "bqkv", "wo", "bo")


def fused_em_sample(stacked: dict, x0: torch.Tensor, noise: torch.Tensor,
                    allmods: torch.Tensor, t_all, dt_all, cfg: float, *,
                    num_blocks: int, num_ada: int, n_head: int = 0,
                    groups: int = 1, attention: bool = True,
                    bounded: bool = True, last_step_size: float = 0.05,
                    final_chunk: bool = True,
                    quant: str | bool | None = None) -> torch.Tensor:
    """The whole EM sampling loop; dispatch by device.

    x0 [half, ch] f32 (cond rows); noise [num_steps, half, ch] f32; allmods
    [S, R, W] (S = num_steps + 1, or num_steps when final_chunk=False, which
    runs num_steps EM updates and no final Euler step and returns the
    post-EM state); t_all/dt_all [S] (host values; a CPU tensor or a list
    avoids a device sync); cfg a float. CFG rows are [cond; uncond].
    attention selects the head family (groups and n_head matter only for
    it; the MlpEncoder's rows are independent), bounded the 2*sigmoid-1
    output. quant ("int8" or True, "int4"; the stack built with the same
    mode) runs the W8A8 / W4A8 products of the TPU kernel's quant mode, for
    the TransEncoder only. CPU tensors take :func:`fused_em_sample_reference`;
    CUDA tensors run ``csrc/fused_head.cu`` (bf16 weights, norms, biases and
    mods; int8 block matrices with f32 scales when quantized) or raise.
    """
    mode = quant_mode(quant)
    kw = dict(num_blocks=num_blocks, num_ada=num_ada, n_head=n_head,
              groups=groups, attention=attention, bounded=bounded,
              last_step_size=last_step_size, final_chunk=final_chunk)
    if x0.device.type == "cpu":
        return fused_em_sample_reference(stacked, x0, noise, allmods, t_all,
                                         dt_all, cfg, quant=mode, **kw)
    if x0.device.type != "cuda":
        raise RuntimeError(f"fused_em_sample: no kernel for {x0.device}")
    if mode is not None and not attention:
        raise ValueError("fused_em_sample: the quantized sampler is checked "
                         "for the TransEncoder only (attention=True)")
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
        _QUANT_MODES.index(mode), *q_ptrs, _cuda.stream_ptr())
    _cuda.check(code, "fused_em_sample")
    fused_em_sample.launches += 1
    return x


fused_em_sample.launches = 0
