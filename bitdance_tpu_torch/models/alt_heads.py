"""Alternative vision prediction heads (port of
bitdance_tpu/models/alt_heads.py).

The reference builds four head families (config.head.vision_pred.type); the
shipped models use the diffusion head (models/diff_head.py). The other
three:

  standard            - linear -> CE over the 2^bits visual vocabulary, with
                        an embedding codebook for feeding samples back
  regression          - MLP -> MSE on the ±1 latents
  gaussian_regression - MLP -> (mu, logvar) -> reparameterised sample -> MSE

Plain torch, as the JAX package runs them on XLA. The MLP heads hold their
two products as ``mlp.0`` and ``mlp.2`` (the JAX tree's Dense_0 / Dense_1).
The Gaussian head's eps comes from the caller: passed in, or drawn from an
explicit ``torch.Generator``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from bitdance_tpu_torch.ops.quantize import indices_to_codes, latents_to_indices


class StandardVisionHead(nn.Module):
    """Linear CE head over the visual codebook (practical only for small
    codebooks: the 14B's 2^32 vocabulary is why the reference moved to the
    diffusion head)."""

    def __init__(self, vocab_size_vision: int, hidden_size: int, device=None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.embed_tokens_vision = nn.Embedding(vocab_size_vision, hidden_size, **kw)
        self.vision_head = nn.Linear(hidden_size, vocab_size_vision, **kw)

    def forward(self, hidden: torch.Tensor, token_ids: torch.Tensor):
        return self.logits(hidden), self.embed(token_ids)

    def logits(self, hidden: torch.Tensor) -> torch.Tensor:
        return self.vision_head(hidden.to(self.vision_head.weight.dtype))

    def embed(self, token_ids: torch.Tensor) -> torch.Tensor:
        return self.embed_tokens_vision(token_ids)

    def loss(self, hidden: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        """Per-token CE in fp32; labels: int codes."""
        logp = F.log_softmax(self.logits(hidden).float(), dim=-1)
        return -logp.gather(-1, labels.long()[..., None])[..., 0]


def _mlp(in_dim: int, model_dim: int, out_dim: int, device, dtype) -> nn.Sequential:
    return nn.Sequential(nn.Linear(in_dim, model_dim, device=device, dtype=dtype),
                         nn.SiLU(),
                         nn.Linear(model_dim, out_dim, device=device, dtype=dtype))


class RegressionVisionHead(nn.Module):
    """MLP (hidden -> model_dim -> silu -> latent_dim) -> MSE on latents."""

    def __init__(self, hidden_size: int, latent_dim: int, model_dim: int,
                 device=None, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.mlp = _mlp(hidden_size, model_dim, latent_dim, device, dtype)

    def forward(self, hidden: torch.Tensor) -> torch.Tensor:
        return self.mlp(hidden.to(self.mlp[0].weight.dtype))

    def loss(self, hidden: torch.Tensor, latents: torch.Tensor) -> torch.Tensor:
        return (self(hidden).float() - latents.float()).square()


class GaussianRegressionVisionHead(nn.Module):
    """MLP -> (mu, log_var) -> mu + eps * exp(log_var / 2) in fp32 -> MSE."""

    def __init__(self, hidden_size: int, latent_dim: int, model_dim: int,
                 device=None, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.mlp = _mlp(hidden_size, model_dim, 2 * latent_dim, device, dtype)

    def forward(self, hidden: torch.Tensor, eps: torch.Tensor | None = None,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """A sample; ``eps`` (fp32, mu's shape) or one drawn from
        ``generator`` (neither raises: no draw from the global generator)."""
        mu, log_var = self.mlp(hidden.to(self.mlp[0].weight.dtype)).chunk(2, dim=-1)
        sigma = torch.exp(0.5 * log_var.float())
        if eps is None:
            if generator is None:
                raise ValueError("GaussianRegressionVisionHead needs eps= or generator=")
            eps = torch.randn(tuple(mu.shape), generator=generator, device=mu.device,
                              dtype=torch.float32)
        return mu.float() + eps * sigma

    def loss(self, hidden: torch.Tensor, latents: torch.Tensor,
             eps: torch.Tensor | None = None,
             generator: torch.Generator | None = None) -> torch.Tensor:
        return (self(hidden, eps, generator) - latents.float()).square()


def codes_from_latents(latents: torch.Tensor, num_codebooks: int = 1) -> torch.Tensor:
    """±1 latents -> integer codes, the standard head's CE labels."""
    return latents_to_indices(latents, num_codebooks)


def latents_from_codes(codes: torch.Tensor, nbits: int) -> torch.Tensor:
    return indices_to_codes(codes, nbits)
