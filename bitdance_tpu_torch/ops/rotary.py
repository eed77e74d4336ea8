"""Rotary and sin-cos position embeddings (port of bitdance_tpu/ops/rotary.py).

Half-rotate RoPE for the Qwen3 backbone, paired 2D RoPE over patch centres
for the ImageNet AR backbone, and the 1D/2D sin-cos tables of the image
positions.
"""

from __future__ import annotations

import torch


def apply_rope_half(x: torch.Tensor, cos: torch.Tensor,
                    sin: torch.Tensor) -> torch.Tensor:
    """Half-rotate RoPE. x: [..., L, n_head, head_dim]; cos/sin:
    [..., L, head_dim // 2] (broadcast over heads). Math in float32."""
    xf = x.float()
    half = x.shape[-1] // 2
    x1, x2 = xf[..., :half], xf[..., half:]
    c = cos[..., None, :]
    s = sin[..., None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


def sincos_1d_table(dim: int, max_len: int, pe_interpolation: float = 1.0,
                    device=None) -> torch.Tensor:
    """1D sin-cos table [max_len, dim], float32: [sin | cos]."""
    assert dim % 2 == 0
    omega = torch.arange(dim // 2, dtype=torch.float32, device=device) / (dim / 2.0)
    omega = 1.0 / (10000.0 ** omega)
    pos = torch.arange(max_len, dtype=torch.float32, device=device) / pe_interpolation
    out = torch.outer(pos, omega)
    return torch.cat([torch.sin(out), torch.cos(out)], dim=1)


def pos_embed_2d(table_1d: torch.Tensor, h: int, w: int,
                 ps: int = 1) -> torch.Tensor:
    """2D pos-embed [h*w, D] in ps-raster order: each consecutive ps*ps run
    covers one spatial tile, '(h p1) (w p2) c -> (h w p1 p2) c'."""
    d2 = table_1d.shape[1]
    grid_v = table_1d[:h][:, None, :].expand(h, w, d2)
    grid_h = table_1d[:w][None, :, :].expand(h, w, d2)
    pe = torch.cat([grid_h, grid_v], dim=-1)
    hh, ww = h // ps, w // ps
    pe = pe.reshape(hh, ps, ww, ps, -1).permute(0, 2, 1, 3, 4)
    return pe.reshape(h * w, -1)


def patch_center_coords_2d(resolution: int, patch_size: int,
                           device=None) -> torch.Tensor:
    """Patch centre coordinates [P*P, 2] as (x, y), in units of max_pos/P."""
    max_pos = resolution // patch_size
    p = max_pos  # one scale
    edge = float(max_pos) / p
    centers = (torch.arange(p, dtype=torch.float32, device=device) + 0.5) * edge
    gy, gx = torch.meshgrid(centers, centers, indexing="ij")
    return torch.stack([gx.reshape(-1), gy.reshape(-1)], dim=1)


def rope_table_2d(pos_2d: torch.Tensor, head_dim: int, base: float = 10000.0,
                  cls_token_num: int = 0) -> torch.Tensor:
    """Paired-rotation (cos, sin) table [cls + L, head_dim // 2, 2], fp32.

    The first half of the pair slots rotates by x, the second by y. Patches
    use t = pos + 1; the cls_token_num prefix rows use t = 0 (identity)."""
    half_dim = head_dim // 2
    dev = pos_2d.device
    freqs = 1.0 / (base ** (torch.arange(0, half_dim, 2, dtype=torch.float32,
                                         device=dev)[: half_dim // 2] / half_dim))
    t = pos_2d.float() + 1.0
    if cls_token_num > 0:
        t = torch.cat([torch.zeros((cls_token_num, 2), device=dev), t], dim=0)
    ang = torch.outer(t.reshape(-1), freqs).reshape(t.shape[0], -1)
    return torch.stack([torch.cos(ang), torch.sin(ang)], dim=-1)


def apply_rope_paired(x: torch.Tensor, freqs_cis: torch.Tensor) -> torch.Tensor:
    """Paired-rotation RoPE. x: [B, L, n_head, head_dim]; freqs_cis:
    [L, head_dim // 2, 2]. Math in float32, result in x's dtype."""
    xf = x.float().reshape(*x.shape[:-1], -1, 2)
    fc = freqs_cis.reshape(1, freqs_cis.shape[0], 1, freqs_cis.shape[1], 2)
    cos, sin = fc[..., 0], fc[..., 1]
    xr, xi = xf[..., 0], xf[..., 1]
    out = torch.stack([xr * cos - xi * sin, xi * cos + xr * sin], dim=-1)
    return out.reshape(x.shape).to(x.dtype)
