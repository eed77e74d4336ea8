"""Categorical token sampling: temperature, top-k / top-p filtering and the
draw (port of bitdance_tpu/ops/token_sampling.py, itself the reference's
top_k_top_p_filtering + sample_codebook). Plain torch: the JAX package
computes it in plain jnp, outside any Pallas kernel. Used for generated
text spans.

The filters give JAX's logits exactly. The draw cannot reproduce JAX's key
stream, so it is made here by Gumbel-max from an explicit
``torch.Generator``: one uniform u per logit from ``torch.rand``, and the
token is ``argmax(logits - log(-log(u)))``, which is distributed as the
softmax of the filtered logits.
"""

from __future__ import annotations

import torch

FILTER_VALUE = -1e30


def top_k_filter(logits: torch.Tensor, k: int) -> torch.Tensor:
    """Keep the logits >= the k-th largest of each row (ties at the k-th
    value survive); k <= 0 keeps all."""
    if k <= 0:
        return logits
    k = min(k, logits.shape[-1])
    kth = torch.topk(logits, k, dim=-1).values[..., -1:]
    return torch.where(logits < kth, torch.full_like(logits, FILTER_VALUE), logits)


def top_p_filter(logits: torch.Tensor, p: float,
                 min_tokens_to_keep: int = 1) -> torch.Tensor:
    """Nucleus filtering with the reference's shift-by-one rule: the first
    sorted token whose cumulative probability crosses p is kept, and so are
    the first ``min_tokens_to_keep``. The threshold is the smallest kept
    sorted logit (non-finite ones aside); p >= 1 keeps all."""
    if p >= 1.0:
        return logits
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
    remove = torch.zeros_like(cum, dtype=torch.bool)
    remove[..., 1:] = cum[..., :-1] > p
    if min_tokens_to_keep > 1:
        remove[..., :min_tokens_to_keep] = False
    kept = sorted_logits.masked_fill(remove, float("-inf"))
    inf = torch.full_like(kept, float("inf"))
    threshold = torch.where(torch.isfinite(kept), kept, inf).amin(dim=-1, keepdim=True)
    return torch.where(logits < threshold, torch.full_like(logits, FILTER_VALUE), logits)


def sample_tokens(generator: torch.Generator | None, logits: torch.Tensor,
                  temperature: float = 1.0, top_k: int = 0, top_p: float = 1.0,
                  do_sample: bool = True) -> torch.Tensor:
    """Temperature (floored at 1e-5), then top-k, then top-p, then a draw:
    token ids [...] (int64) of logits [..., V]. do_sample=False is the
    argmax; otherwise Gumbel-max with ``generator`` (module docstring), one
    ``torch.rand`` of the logits' shape per call."""
    logits = logits / max(temperature, 1e-5)
    if top_k > 0:
        logits = top_k_filter(logits, top_k)
    if top_p < 1.0:
        logits = top_p_filter(logits, top_p)
    if not do_sample:
        return torch.argmax(logits, dim=-1)
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    return torch.argmax(logits.float() - torch.log(-torch.log(u)), dim=-1)
