"""Binary quantization (port of bitdance_tpu/ops/quantize.py)."""

from __future__ import annotations

import torch


def sign_quantize(h: torch.Tensor) -> torch.Tensor:
    """+1 where h > 0 else -1, so 0 maps to -1 (torch.sign would give 0)."""
    one = torch.ones((), dtype=h.dtype, device=h.device)
    return torch.where(h > 0, one, -one)


def _bit_weights(nbits: int, device) -> torch.Tensor:
    assert nbits <= 31, "int32 packing supports <= 31 bits"
    return 2 ** torch.arange(nbits, dtype=torch.int32, device=device)


def bits_to_indices(bits: torch.Tensor) -> torch.Tensor:
    """Pack a {0,1} (or bool) last axis into int32 codes, bit i weighing 2**i."""
    return (bits.to(torch.int32) * _bit_weights(bits.shape[-1], bits.device)).sum(
        dim=-1, dtype=torch.int32)


def indices_to_bits(idx: torch.Tensor, nbits: int) -> torch.Tensor:
    """Unpack int codes into {0,1} int32 bits (little-endian)."""
    return ((idx[..., None].to(torch.int32) & _bit_weights(nbits, idx.device)) != 0
            ).to(torch.int32)


def indices_to_codes(idx: torch.Tensor, nbits: int,
                     dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Int codes -> ±1 latents."""
    return (indices_to_bits(idx, nbits).to(dtype) * 2.0 - 1.0).to(dtype)


def latents_to_indices(latents: torch.Tensor, num_codebooks: int) -> torch.Tensor:
    """±1 latents [..., C] -> grouped codes [..., num_codebooks]: the channel
    axis splits into num_codebooks groups, each packing its sign bits."""
    c = latents.shape[-1]
    assert c % num_codebooks == 0
    grouped = latents.reshape(*latents.shape[:-1], num_codebooks, c // num_codebooks)
    return bits_to_indices(grouped > 0)


def flip_bits_uniform_prob(x: torch.Tensor, p_max: float,
                           generator: torch.Generator | None = None,
                           batch_rows: tuple[int, int] | None = None) -> torch.Tensor:
    """Bit-flip augmentation: flip where r1 < p_max * r2 for independent
    uniforms r1, r2 drawn from ``generator`` (marginal rate p_max / 2).
    ``batch_rows`` (first, n): x holds rows [first, first + B) of an
    n-row batch; the uniforms are drawn for all n rows and these keep
    theirs."""
    first, n = batch_rows if batch_rows is not None else (0, x.shape[0])
    shape = (n,) + tuple(x.shape[1:])
    rows = slice(first, first + x.shape[0])
    r1 = torch.rand(shape, generator=generator, device=x.device)[rows]
    r2 = torch.rand(shape, generator=generator, device=x.device)[rows]
    flip = r1 < p_max * r2
    one = torch.ones((), dtype=x.dtype, device=x.device)
    return x * torch.where(flip, -one, one)
