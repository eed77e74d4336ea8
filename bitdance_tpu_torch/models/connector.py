"""Vision-embedding projectors (port of bitdance_tpu/models/connector.py:
MLPConnector, SwiGLUConnector)."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class MLPConnector(nn.Module):
    """fc1 -> tanh-GELU -> fc2, mapping ±1 latents to LLM hidden states."""

    def __init__(self, in_dim: int, out_dim: int, device=None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.fc1 = nn.Linear(in_dim, out_dim, device=device, dtype=dtype)
        self.fc2 = nn.Linear(out_dim, out_dim, device=device, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.fc1.weight.dtype)
        return self.fc2(F.gelu(self.fc1(x), approximate="tanh"))


class SwiGLUConnector(nn.Module):
    """w1 -> silu gate -> w2 with hidden int(1.5 * out_dim) (the ImageNet
    stack's proj_in; JAX connector.py:28-39)."""

    def __init__(self, in_dim: int, out_dim: int, device=None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        hidden = int(out_dim * 1.5)
        self.w1 = nn.Linear(in_dim, 2 * hidden, device=device, dtype=dtype)
        self.w2 = nn.Linear(hidden, out_dim, device=device, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h1, h2 = self.w1(x.to(self.w1.weight.dtype)).chunk(2, dim=-1)
        return self.w2(F.silu(h1) * h2)
