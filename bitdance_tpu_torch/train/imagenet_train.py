"""ImageNet class-conditional AR training step (port of
bitdance_tpu/train/imagenet_train.py: ImageNetTrainConfig,
init_train_state, make_tx, train_step, make_sharded_train_step with
opt_state_shardings; plus encode_batch from the training script
scripts/train_imagenet.py).

:func:`train_step` runs on one device without a mesh; it is what
:func:`make_sharded_train_step` (FSDP over a device mesh, each process a
share of the batch) is held against. Mixed precision is the JAX step's:
every fp32 parameter is cast to bf16 for the forward and backward
(``torch.func.functional_call`` on the casts, so the gradients land on the
fp32 masters as the casts' transposes; the sharded step casts in FSDP's
gather), the tokens are cast to bf16, the head computes in bf16, and the
optimizer keeps fp32 masters. Explicit casts, not ``torch.autocast``, which
would keep other ops in fp32 than the JAX step does.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn
from torch.func import functional_call

from bitdance_tpu_torch.models.gfq import gfq_quantize
from bitdance_tpu_torch.models.imagenet_ar import (
    ImageNetAR,
    ImageNetARConfig,
    forward_train,
    grid_to_tokens,
    init_ar_params,
    make_head,
)
from bitdance_tpu_torch.models.tokenizer import VQModel
from bitdance_tpu_torch.train import optim as opt_lib
from bitdance_tpu_torch.utils.precision import full_fp32

NON_DECAY_KEYS = ("proj_in", "cls_embedding", "query_token")


@dataclasses.dataclass
class ImageNetTrainConfig:
    lr: float = 6e-4
    min_lr: float = 0.0
    weight_decay: float = 0.05
    betas: tuple = (0.9, 0.95)
    eps: float = 1e-8
    warmup_steps: int = 2000
    total_steps: int = 500_000
    decay_start: int = -1
    max_grad_norm: float = 1.0
    ema_decay: float = 0.9999
    global_batch_size: int = 256
    mixed_precision: bool = True


class ImageNetTrainModel(nn.Module):
    """Backbone (``ar``) and diffusion head (``head``); forward is the loss."""

    def __init__(self, cfg: ImageNetARConfig, device=None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg = cfg
        self.ar = ImageNetAR(cfg, device=device, dtype=dtype)
        self.head = make_head(cfg, device=device, dtype=dtype)

    def forward(self, latent_tokens: torch.Tensor, class_ids: torch.Tensor,
                generator: torch.Generator | None = None,
                implementation: str = "auto",
                batch_rows: tuple[int, int] | None = None) -> torch.Tensor:
        return forward_train(self.ar, self.head, self.cfg, latent_tokens,
                             class_ids, generator, implementation=implementation,
                             batch_rows=batch_rows)


def init_head_params(head: nn.Module, generator: torch.Generator | None = None,
                     std: float = 0.02) -> nn.Module:
    """The JAX package's head init (flax defaults): Linear weights
    lecun-normal (std 1/sqrt(fan_in)), the timestep MLP N(0, 0.02), biases 0,
    LayerNorm gains 1, and the adaLN and final-layer weights 0."""
    with torch.no_grad():
        for name, p in head.named_parameters():
            if name.endswith("bias"):
                p.zero_()
            elif p.ndim == 1:
                p.fill_(1.0)
            elif "ada_ln" in name or "final_layer.linear" in name:
                p.zero_()
            elif "time_embed" in name:
                p.normal_(0.0, std, generator=generator)
            else:
                p.normal_(0.0, p.shape[1] ** -0.5, generator=generator)
    return head


def make_tx(model: nn.Module, tcfg: ImageNetTrainConfig) -> opt_lib.AdamW:
    sched = opt_lib.make_lr_schedule(tcfg.lr, tcfg.warmup_steps,
                                     tcfg.total_steps, tcfg.decay_start,
                                     tcfg.min_lr)
    return opt_lib.AdamW(
        dict(model.named_parameters()), sched, weight_decay=tcfg.weight_decay,
        betas=tcfg.betas, eps=tcfg.eps, max_grad_norm=tcfg.max_grad_norm,
        non_decay_keys=NON_DECAY_KEYS)


def make_train_state(model: ImageNetTrainModel,
                     tcfg: ImageNetTrainConfig) -> opt_lib.TrainState:
    return opt_lib.TrainState.create(model, make_tx(model, tcfg))


def init_train_state(cfg: ImageNetARConfig, tcfg: ImageNetTrainConfig,
                     device="cuda", generator: torch.Generator | None = None
                     ) -> opt_lib.TrainState:
    """fp32 model with the JAX package's init, its optimizer and EMA, on the
    card unless ``device`` says otherwise."""
    with torch.device("meta"):
        model = ImageNetTrainModel(cfg)
    model = model.to_empty(device=device)
    init_ar_params(model.ar, generator)
    init_head_params(model.head, generator)
    return make_train_state(model, tcfg)


def train_step(state: opt_lib.TrainState, latent_tokens: torch.Tensor,
               class_ids: torch.Tensor,
               generator: torch.Generator | None = None, *,
               ema_decay: float, mixed_precision: bool = True,
               implementation: str = "auto",
               norms_of: dict[str, str] | None = None) -> dict:
    """One step over pre-encoded ±1 latent tokens [B, num_tokens, token_dim];
    returns {"loss", "grad_norm"} (grad norm before clipping) as 0-d
    tensors on the device, without a host sync. ``norms_of`` maps a label to
    a substring of parameter names and adds "grad_norm_<label>", the
    pre-clip gradient norm of those parameters."""
    full_fp32()
    model = state.model
    names = state.tx.names
    params = state.tx.params
    tokens = latent_tokens
    call_params = dict(zip(names, params))
    if mixed_precision:
        call_params = {n: p.to(torch.bfloat16) if p.dtype == torch.float32 else p
                       for n, p in call_params.items()}
        tokens = tokens.to(torch.bfloat16)
    loss = functional_call(model, call_params, (tokens, class_ids, generator),
                           {"implementation": implementation})
    grads = torch.autograd.grad(loss, params)
    grads = [g.float() for g in grads]
    metrics = {"loss": loss.detach().float(), "grad_norm": opt_lib.global_norm(grads)}
    for label, part in (norms_of or {}).items():
        metrics[f"grad_norm_{label}"] = opt_lib.global_norm(
            [g for n, g in zip(names, grads) if part in n])
    opt_lib.apply_gradients(state, grads, ema_decay)
    return metrics


@torch.no_grad()
def encode_batch(ae: VQModel, cfg: ImageNetARConfig,
                 images: torch.Tensor) -> torch.Tensor:
    """Images NHWC in [-1, 1] -> ±1 latent tokens [B, num_tokens, token_dim]:
    encode_raw, GFQ with 4 codebooks (inference), grid_to_tokens."""
    full_fp32()
    raw = ae.encode_raw(images)
    q = gfq_quantize(raw, num_codebooks=4, training=False).quantized
    return grid_to_tokens(cfg, q)


def make_sharded_train_step(mesh, state: opt_lib.TrainState, cfg: ImageNetARConfig,
                            tcfg: ImageNetTrainConfig):
    """The train step with FSDP over ``mesh`` (parallel/mesh.py): returns
    (step_fn, sharded state). ``state`` is put under FSDP in place (its
    model, moments and EMA sharded alike, the JAX package's
    ``opt_state_shardings``); use the returned state from then on.

    ``step_fn(state, latent_tokens, class_ids, generator=None)`` takes this
    process's rows of the global batch
    (:func:`~bitdance_tpu_torch.parallel.mesh.batch_rows`) and returns the
    metrics of :func:`train_step` over the whole batch (means over the
    processes; the grad norm over the sharded gradients). The draws are made
    at the global batch's shapes from ``generator`` (seeded alike in every
    process) and each process keeps its rows, so every world computes what
    :func:`train_step` computes on the whole batch. Mixed precision casts the
    fp32 masters to bf16 in FSDP's gather (as ``.to`` rounds) and reduces
    the gradients in fp32."""
    from bitdance_tpu_torch.parallel.mesh import (
        all_reduce_mean,
        data_index,
        data_size,
        shard_train_state,
    )

    mixed = tcfg.mixed_precision
    state = shard_train_state(state, mesh, torch.bfloat16 if mixed else None)
    n_data, index = data_size(mesh), data_index(mesh)

    def step_fn(state: opt_lib.TrainState, latent_tokens: torch.Tensor,
                class_ids: torch.Tensor, generator: torch.Generator | None = None) -> dict:
        full_fp32()
        b = latent_tokens.shape[0]
        tokens = latent_tokens.to(torch.bfloat16) if mixed else latent_tokens
        rows = (index * b, n_data * b) if n_data > 1 else None
        loss = state.model(tokens, class_ids, generator, batch_rows=rows)
        loss.backward()
        grads = [p.grad for p in state.tx.params]
        metrics = all_reduce_mean({"loss": loss.detach().float()}, mesh)
        metrics["grad_norm"] = opt_lib.global_norm(grads, state.tx.norm_group)
        opt_lib.apply_gradients(state, grads, tcfg.ema_decay)
        return metrics

    return step_fn, state
