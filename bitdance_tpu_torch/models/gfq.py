"""Group-wise lookup-free quantization (port of bitdance_tpu/models/gfq.py).

Channels split into ``num_codebooks`` groups, each sign-quantized. With
``training=True`` the entropy terms (per-sample entropy down, codebook
entropy up) and a commitment MSE come back too, and gradients pass through
the straight-through estimator. No parameters; NHWC latents.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from bitdance_tpu_torch.ops.quantize import (
    bits_to_indices,
    indices_to_bits,
    sign_quantize,
)


class GFQOutput(NamedTuple):
    quantized: torch.Tensor        # ±1 (straight-through in training) [B, h, w, C]
    entropy_loss: torch.Tensor     # scalar
    commit_loss: torch.Tensor      # scalar
    indices: torch.Tensor          # [B, h, w, num_codebooks] int32
    per_sample_entropy: torch.Tensor
    codebook_entropy: torch.Tensor


def make_codebook(codebook_dim: int, device=None) -> torch.Tensor:
    """All ±1 codes of one group: [2**dim, dim] fp32."""
    codes = torch.arange(2 ** codebook_dim, device=device)
    return indices_to_bits(codes, codebook_dim).float() * 2.0 - 1.0


def entropy_terms(logits: torch.Tensor, temperature: float = 0.01,
                  eps: float = 1e-5) -> tuple[torch.Tensor, torch.Tensor]:
    """(sample_entropy, avg_entropy) of softmax(logits / T)."""
    probs = torch.softmax(logits / temperature, dim=-1)
    log_probs = torch.log_softmax(logits / temperature + eps, dim=-1)
    avg_probs = probs.reshape(-1, probs.shape[-1]).mean(dim=0)
    avg_entropy = -(avg_probs * torch.log(avg_probs + eps)).sum()
    sample_entropy = (-(probs * log_probs).sum(dim=-1)).mean()
    return sample_entropy, avg_entropy


def gfq_quantize(z: torch.Tensor, num_codebooks: int, *, training: bool = True,
                 sample_minimization_weight: float = 1.0,
                 batch_maximization_weight: float = 1.0) -> GFQOutput:
    """Quantize encoder output z [B, h, w, C]."""
    c = z.shape[-1]
    assert c % num_codebooks == 0
    d = c // num_codebooks
    zf = z.float()
    grouped = zf.reshape(*zf.shape[:-1], num_codebooks, d)
    quantized = sign_quantize(grouped)
    indices = bits_to_indices(quantized > 0)
    if training:
        codebook = make_codebook(d, z.device)
        # 2 <x, code> orders codes as the euclidean distance does
        logits = 2.0 * torch.einsum("...d,jd->...j", grouped, codebook)
        per_sample_entropy, codebook_entropy = entropy_terms(logits)
        entropy_loss = (sample_minimization_weight * per_sample_entropy
                        - batch_maximization_weight * codebook_entropy)
        commit_loss = (grouped - quantized.detach()).square().mean()
        quantized = grouped + (quantized - grouped).detach()
    else:
        zero = torch.zeros((), device=z.device)
        per_sample_entropy = codebook_entropy = entropy_loss = commit_loss = zero
    return GFQOutput(quantized=quantized.reshape(zf.shape).to(z.dtype),
                     entropy_loss=entropy_loss, commit_loss=commit_loss,
                     indices=indices, per_sample_entropy=per_sample_entropy,
                     codebook_entropy=codebook_entropy)
