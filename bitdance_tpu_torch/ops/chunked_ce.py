"""Chunked-vocabulary cross entropy (port of bitdance_tpu/ops/chunked_ce.py).

At the 14B's 152k vocabulary, [N_text, V] fp32 logits would take gigabytes.
This walks the vocabulary in chunks of 8192 with an online log-sum-exp and
a label gather per chunk, each chunk under ``torch.utils.checkpoint`` (the
JAX scan body's ``jax.checkpoint``), so the forward and the backward hold
one [N, chunk] block at a time. hidden and each weight chunk are cast to
fp32 before their product, as the JAX function does; the product is a plain
``torch.matmul`` (the JAX package leaves it to XLA; no kernel here).
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint


def _chunk_step(hf: torch.Tensor, wc: torch.Tensor, labels: torch.Tensor,
                base: int, v: int, m: torch.Tensor, s: torch.Tensor,
                label_logit: torch.Tensor):
    """One vocabulary chunk: logits [N, chunk] in fp32, padding columns
    (col >= v) at -inf, then the online max / sum update and the label's
    logit if it falls in this chunk."""
    chunk = wc.shape[1]
    logits = hf @ wc.float()
    col = base + torch.arange(chunk, device=hf.device)
    logits = torch.where(col < v, logits, torch.full((), float("-inf"), device=hf.device))
    m_new = torch.maximum(m, logits.amax(dim=-1))
    s = s * torch.exp(m - m_new) + torch.exp(logits - m_new[:, None]).sum(dim=-1)
    in_chunk = (labels >= base) & (labels < base + chunk)
    idx = (labels - base).clamp(0, chunk - 1)
    ll = torch.gather(logits, 1, idx[:, None])[:, 0]
    return m_new, s, torch.where(in_chunk, ll, label_logit)


def chunked_cross_entropy(hidden: torch.Tensor, lm_head: torch.Tensor,
                          labels: torch.Tensor,
                          vocab_chunk: int = 8192) -> torch.Tensor:
    """Per-row negative log likelihood [N] fp32 of hidden [N, D] against
    lm_head [D, V] (the JAX layout; a transposed view of a torch Linear
    weight works) at labels [N]: -log_softmax(hidden @ lm_head)[labels],
    without the full logits."""
    n, d = hidden.shape
    v = lm_head.shape[1]
    chunk = min(vocab_chunk, v)
    hf = hidden.float()
    labels = labels.long()
    dev = hidden.device
    m = torch.full((n,), float("-inf"), device=dev)
    s = torch.zeros((n,), device=dev)
    label_logit = torch.full((n,), float("-inf"), device=dev)
    for base in range(0, v, chunk):
        wc = lm_head[:, base:base + chunk]
        if wc.shape[1] < chunk:          # the last chunk, zero-padded
            wc = torch.cat([wc, wc.new_zeros((d, chunk - wc.shape[1]))], dim=1)
        if torch.is_grad_enabled():
            m, s, label_logit = checkpoint(_chunk_step, hf, wc, labels, base, v, m, s,
                                           label_logit, use_reentrant=False)
        else:
            m, s, label_logit = _chunk_step(hf, wc, labels, base, v, m, s, label_logit)
    return m + torch.log(s) - label_logit


def cross_entropy_reference(hidden: torch.Tensor, lm_head: torch.Tensor,
                            labels: torch.Tensor) -> torch.Tensor:
    """Direct CE (for tests and small vocabularies)."""
    logits = hidden.float() @ lm_head.float()
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.gather(logp, 1, labels.long()[:, None])[:, 0]
