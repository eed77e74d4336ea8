"""Packed multimodal training step of BitDance-14B (port of
bitdance_tpu/train/mllm_train.py:38-140: MLLMTrainConfig, make_tx,
make_state, train_step, eval_step).

One card, no mesh: the JAX step's FSDP sharding (make_sharded_train_step)
waits for the port's parallelism (ROADMAP A11). The optimizer follows the
yaml (AdamW betas 0.9 / 0.95, eps 1e-15, clip 1.0; loss weights text 0.01,
vision 1.0). Parameters step in their own dtype, as the JAX step does: a
bf16 model computes, takes gradients and keeps its AdamW moments in bf16;
gradient accumulation sums microbatches in fp32 and casts the mean back to
each parameter's dtype. There is no EMA unless ``ema_decay > 0``.
"""

from __future__ import annotations

import dataclasses

import torch

from bitdance_tpu_torch.models.mllm import (
    MLLM,
    MLLMConfig,
    PackedBatch,
    mllm_forward_train,
    mllm_forward_train_batched,
)
from bitdance_tpu_torch.train import optim as opt_lib
from bitdance_tpu_torch.utils.precision import full_fp32


@dataclasses.dataclass
class MLLMTrainConfig:
    lr: float = 1e-5
    min_lr: float = 1e-7
    weight_decay: float = 0.0
    betas: tuple = (0.9, 0.95)
    eps: float = 1e-15
    warmup_steps: int = 2000
    total_steps: int = 1_000_000
    decay_start: int = -1            # yaml lr_scheduler: constant
    max_grad_norm: float = 1.0
    loss_weight_text: float = 0.01
    loss_weight_vision: float = 1.0
    ema_decay: float = 0.0           # the 14B yaml has no EMA
    grad_accum: int = 1              # microbatches per optimizer step


def make_tx(model: MLLM, tcfg: MLLMTrainConfig) -> opt_lib.AdamW:
    """AdamW with clipping over every parameter (decay mask ndim >= 2)."""
    sched = opt_lib.make_lr_schedule(tcfg.lr, tcfg.warmup_steps, tcfg.total_steps,
                                     tcfg.decay_start, tcfg.min_lr)
    return opt_lib.AdamW(dict(model.named_parameters()), sched,
                         weight_decay=tcfg.weight_decay, betas=tcfg.betas,
                         eps=tcfg.eps, max_grad_norm=tcfg.max_grad_norm)


def make_state(model: MLLM, tx: opt_lib.AdamW, tcfg: MLLMTrainConfig) -> opt_lib.TrainState:
    """TrainState with EMA copies only when the config uses EMA."""
    return opt_lib.TrainState.create(model, tx, with_ema=tcfg.ema_decay > 0)


def _loss(model: MLLM, batch: PackedBatch, seed: int, cfg: MLLMConfig,
          tcfg: MLLMTrainConfig, seq_offset: int, implementation: str):
    out = mllm_forward_train_batched(model, cfg, batch, seed, seq_offset=seq_offset,
                                     implementation=implementation)
    loss = (tcfg.loss_weight_text * out["ce_loss_text"]
            + tcfg.loss_weight_vision * out["ce_loss_vision"])
    return loss, out


def loss_and_grads(state: opt_lib.TrainState, batch: PackedBatch, seed: int, *,
                   cfg: MLLMConfig, tcfg: MLLMTrainConfig,
                   implementation: str = "auto"):
    """(metrics, grads) of one step without the update: metrics {"loss",
    "grad_norm", "ce_loss_text", "ce_loss_vision"} as 0-d tensors on the
    device (no host sync), grads in each parameter's dtype.

    Fields are [B, ...] when tcfg.grad_accum == 1, else [grad_accum, B, ...].
    Gradients are averaged over microbatches and sequence draws follow the
    global sequence index (microbatch a starts at a * B), so the result does
    not depend on how a fixed set of sequences is split between B and
    grad_accum (to fp32 accumulation order)."""
    full_fp32()
    model = state.model
    params = state.tx.params
    if tcfg.grad_accum > 1:
        mb = batch.position_ids.shape[1]
        acc = [torch.zeros_like(p, dtype=torch.float32) for p in params]
        loss = torch.zeros((), device=params[0].device)
        out = {}
        for a in range(tcfg.grad_accum):
            l_a, o_a = _loss(model, batch.row(a), seed, cfg, tcfg, a * mb,
                             implementation)
            torch._foreach_add_(acc, [g.float() for g in torch.autograd.grad(l_a, params)])
            loss = loss + l_a.detach().float()
            out = {k: out.get(k, 0.0) + v.detach().float() for k, v in o_a.items()}
        inv = 1.0 / tcfg.grad_accum
        grads = [(g * inv).to(p.dtype) for g, p in zip(acc, params)]
        loss = loss * inv
        out = {k: v * inv for k, v in out.items()}
    else:
        loss, out = _loss(model, batch, seed, cfg, tcfg, 0, implementation)
        grads = list(torch.autograd.grad(loss, params))
        loss = loss.detach().float()
        out = {k: v.detach().float() for k, v in out.items()}
    return {"loss": loss, "grad_norm": opt_lib.global_norm(grads), **out}, grads


def train_step(state: opt_lib.TrainState, batch: PackedBatch, seed: int, *,
               cfg: MLLMConfig, tcfg: MLLMTrainConfig,
               implementation: str = "auto") -> dict:
    """One optimizer step (:func:`loss_and_grads`, then clip, AdamW and EMA
    if kept); returns the metrics of :func:`loss_and_grads`."""
    metrics, grads = loss_and_grads(state, batch, seed, cfg=cfg, tcfg=tcfg,
                                    implementation=implementation)
    opt_lib.apply_gradients(state, grads,
                            ema_decay=tcfg.ema_decay if tcfg.ema_decay > 0 else 0.9999)
    return metrics


@torch.no_grad()
def eval_step(model: MLLM, batch: PackedBatch, seed: int, *, cfg: MLLMConfig,
              tcfg: MLLMTrainConfig, implementation: str = "auto") -> dict:
    """Validation losses (no perturbation) on a held-out packed batch,
    batched ([B, ...]) or one sequence."""
    if batch.position_ids.ndim == 2:
        out = mllm_forward_train_batched(model, cfg, batch, seed, train=False,
                                         implementation=implementation)
    else:
        out = mllm_forward_train(model, cfg, batch, seed, train=False,
                                 implementation=implementation)
    loss = (tcfg.loss_weight_text * out["ce_loss_text"]
            + tcfg.loss_weight_vision * out["ce_loss_vision"])
    return {"val_loss": loss, "val_ce_text": out["ce_loss_text"],
            "val_ce_vision": out["ce_loss_vision"]}
