"""Binary tokenizer (GFQ) training step (port of
bitdance_tpu/train/tokenizer_train.py).

The recipe the reference's trainable tokenizer modules imply
(imagenet_gen/src/qae.py, gfq.py): reconstruction L1 + L2, the GFQ entropy
loss (per-sample entropy down, codebook entropy up) and the commitment MSE,
with straight-through gradients into the encoder. fp32, as the JAX step
runs. A GAN decoder (``gan_decoder=True``) draws its noise from the step's
generator, as the JAX step passes its rng; there are no perceptual or
adversarial terms, as in the JAX step.
"""

from __future__ import annotations

import dataclasses

import torch

from bitdance_tpu_torch.models.gfq import gfq_quantize
from bitdance_tpu_torch.models.tokenizer import VQModel, init_vq
from bitdance_tpu_torch.train import optim as opt_lib
from bitdance_tpu_torch.utils.precision import full_fp32


@dataclasses.dataclass
class TokenizerTrainConfig:
    lr: float = 1e-4
    betas: tuple = (0.9, 0.99)
    eps: float = 1e-8
    weight_decay: float = 0.0
    warmup_steps: int = 5000
    total_steps: int = 1_000_000
    max_grad_norm: float = 1.0
    ema_decay: float = 0.9999
    num_codebooks: int = 4
    entropy_weight: float = 0.1
    commit_weight: float = 0.25
    l1_weight: float = 1.0
    l2_weight: float = 1.0


def tokenizer_loss(model: VQModel, images: torch.Tensor, tcfg: TokenizerTrainConfig,
                   generator: torch.Generator | None = None) -> tuple[torch.Tensor, dict]:
    """(loss, metrics) of images NHWC in [-1, 1]: encode_raw, GFQ in
    training mode, decode (a GAN decoder's noise from ``generator``), and
    the weighted sum of the four terms."""
    raw = model.encode_raw(images)
    out = gfq_quantize(raw, tcfg.num_codebooks, training=True)
    recon = model.decode(out.quantized, generator=generator)
    diff = recon.float() - images.float()
    l1 = diff.abs().mean()
    l2 = diff.square().mean()
    loss = (tcfg.l1_weight * l1 + tcfg.l2_weight * l2
            + tcfg.entropy_weight * out.entropy_loss
            + tcfg.commit_weight * out.commit_loss)
    metrics = {"loss": loss, "l1": l1, "l2": l2,
               "entropy_loss": out.entropy_loss, "commit_loss": out.commit_loss,
               "codebook_entropy": out.codebook_entropy}
    return loss, metrics


def make_tokenizer_train_step(tcfg: TokenizerTrainConfig):
    """step(state, images, generator=None) -> metrics (0-d tensors on the
    device, no host sync; "grad_norm" before clipping): the loss's
    gradients, clip, AdamW and EMA, in place on ``state``. A GAN decoder
    draws its noise from ``generator`` (seeded per step by the caller)."""

    def step(state: opt_lib.TrainState, images: torch.Tensor,
             generator: torch.Generator | None = None) -> dict:
        full_fp32()
        loss, metrics = tokenizer_loss(state.model, images, tcfg, generator)
        grads = torch.autograd.grad(loss, state.tx.params)
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["grad_norm"] = opt_lib.global_norm(grads)
        opt_lib.apply_gradients(state, grads, tcfg.ema_decay)
        return metrics

    return step


def init_tokenizer_train(ddconfig: dict, tcfg: TokenizerTrainConfig, device="cuda",
                         generator: torch.Generator | None = None,
                         gan_decoder: bool = False) -> opt_lib.TrainState:
    """An fp32 VQModel with encoder and decoder (the flax-default init, from
    ``generator``; ``gan_decoder`` as VQModel's), its AdamW (clip, warmup
    schedule, weight decay on every matrix) and EMA, on the card unless
    ``device`` says otherwise."""
    model = init_vq(ddconfig, device, torch.float32, generator, encoder=True,
                    decoder=True, gan_decoder=gan_decoder).train().requires_grad_(True)
    sched = opt_lib.make_lr_schedule(tcfg.lr, tcfg.warmup_steps, tcfg.total_steps)
    tx = opt_lib.AdamW(dict(model.named_parameters()), sched,
                       weight_decay=tcfg.weight_decay, betas=tcfg.betas,
                       eps=tcfg.eps, max_grad_norm=tcfg.max_grad_norm)
    return opt_lib.TrainState.create(model, tx)
