"""Packed multimodal training step of BitDance-14B (port of
bitdance_tpu/train/mllm_train.py:38-140: MLLMTrainConfig, make_tx,
make_state, train_step, eval_step).

:func:`train_step` runs on one device without a mesh;
:func:`make_sharded_train_step` (:143-171 of the JAX module) runs it with
FSDP over a device mesh, each data shard on its own sequences. The
optimizer follows the yaml (AdamW betas 0.9 / 0.95, eps 1e-15, clip 1.0;
loss weights text 0.01, vision 1.0). Parameters step in their own dtype, as the JAX step does: a
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
    batched ([B, ...]) or one sequence. The model runs through its own
    ``forward`` (``cfg`` must be its config), so an FSDP model gathers its
    weights; every process then evaluates the same batch."""
    if cfg != model.cfg:
        raise ValueError("eval_step: cfg is not the model's config")
    if batch.position_ids.ndim == 1:
        batch = PackedBatch(*(t[None] for t in batch))
    out = model(batch, seed, train=False, implementation=implementation)
    loss = (tcfg.loss_weight_text * out["ce_loss_text"]
            + tcfg.loss_weight_vision * out["ce_loss_vision"])
    return {"val_loss": loss, "val_ce_text": out["ce_loss_text"],
            "val_ce_vision": out["ce_loss_vision"]}


def make_sharded_train_step(mesh, state: opt_lib.TrainState, cfg: MLLMConfig,
                            tcfg: MLLMTrainConfig):
    """The train step with FSDP over ``mesh`` (parallel/mesh.py): returns
    (step_fn, sharded state). ``state`` is put under FSDP in place (its
    moments and any EMA sharded like the parameters, which keep their
    dtype); use the returned state from then on.

    ``step_fn(state, batch, seed)`` takes this data shard's sequences:
    fields [B, ...], or [grad_accum, B, ...] with the microbatch axis whole
    (the JAX step's P(None, data axes)). Its sequence b of microbatch a is
    global sequence a * B * shards + index * B + b, the key of its draws, so
    the step computes what :func:`train_step` computes on the global batch.
    Each microbatch's sharded gradient is summed in fp32 (as
    :func:`loss_and_grads` sums, never in a bf16 ``.grad``); the metrics are
    means over the data shards. Data is always sharded over the replica and
    fsdp axes together (the JAX step's default ``data_axes``): with tp not
    ported, each process is one data shard."""
    from bitdance_tpu_torch.parallel.mesh import (
        all_reduce_mean,
        data_index,
        data_size,
        shard_train_state,
    )

    if cfg != state.model.cfg:
        raise ValueError("make_sharded_train_step: cfg is not the model's config")
    state = shard_train_state(state, mesh)
    n_data, index = data_size(mesh), data_index(mesh)
    accum = tcfg.grad_accum

    def step_fn(state: opt_lib.TrainState, batch: PackedBatch, seed: int) -> dict:
        full_fp32()
        model, params = state.model, state.tx.params
        mb = batch.position_ids.shape[-2]
        micro = [batch.row(a) for a in range(accum)] if accum > 1 else [batch]
        acc, loss_sum, out_sum = None, 0.0, {}
        for a, part in enumerate(micro):
            out = model(part, seed, seq_offset=(a * n_data + index) * mb)
            loss = (tcfg.loss_weight_text * out["ce_loss_text"]
                    + tcfg.loss_weight_vision * out["ce_loss_vision"])
            loss.backward()
            loss_sum = loss_sum + loss.detach().float()
            out_sum = {k: out_sum.get(k, 0.0) + v.detach().float() for k, v in out.items()}
            if accum > 1:
                shards = [p.grad.to_local().float() for p in params]
                if acc is None:
                    acc = shards
                else:
                    torch._foreach_add_(acc, shards)
                if a < accum - 1:
                    for p in params:
                        p.grad = None
        grads = [p.grad for p in params]
        if accum > 1:
            inv = 1.0 / accum
            for g, s in zip(grads, acc):
                g.to_local().copy_(s * inv)
            loss_sum = loss_sum * inv
            out_sum = {k: v * inv for k, v in out_sum.items()}
        metrics = all_reduce_mean({"loss": loss_sum, **out_sum}, mesh)
        metrics["grad_norm"] = opt_lib.global_norm(grads, state.tx.norm_group)
        opt_lib.apply_gradients(
            state, grads, ema_decay=tcfg.ema_decay if tcfg.ema_decay > 0 else 0.9999)
        return metrics

    return step_fn, state
