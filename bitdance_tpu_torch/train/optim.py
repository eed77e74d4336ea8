"""Optimizer, learning-rate schedule and EMA (port of
bitdance_tpu/train/optim.py).

The JAX package chains ``optax.clip_by_global_norm`` and ``optax.adamw``
with a decay mask; this module keeps those semantics on torch tensors:
  - clipping: g unchanged when ||g|| < max, else (g / ||g||) * max;
  - AdamW (torch.optim.AdamW's fused kernel on every device; the same
    update as optax's up to rounding), no weight decay for tensors with
    ndim < 2 or whose name contains a non-decay key;
  - the schedule is read at the count BEFORE the update, as optax does, so
    under warmup the first step's learning rate is 0 and the parameters
    first move at step 2;
  - EMA: ema * d + p * (1 - d) after each update.
Parameters, moments and EMA are updated in place. Under FSDP (the
parameters, their gradients, moments and EMA DTensors sharded alike,
parallel/mesh.py) every update acts on the local shards, and the clip's
norm sums the shards' squares over the fsdp processes first.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Mapping, Sequence

import torch
from torch import nn

from bitdance_tpu_torch.utils.dtensor import local


def make_lr_schedule(lr: float, warmup_steps: int, total_steps: int,
                     decay_start: int = -1,
                     min_lr: float = 0.0) -> Callable[[int], float]:
    """warmup -> constant -> (optional) cosine decay to min_lr."""

    def schedule(step: int) -> float:
        step = float(step)
        warm = lr * step / max(warmup_steps, 1)
        after = lr
        if 0 < decay_start < total_steps and step >= decay_start:
            prog = min(max((step - decay_start)
                           / max(total_steps - decay_start, 1e-8), 0.0), 1.0)
            after = min_lr + (lr - min_lr) * 0.5 * (1.0 + math.cos(math.pi * prog))
        if warmup_steps > 0 and step < warmup_steps:
            return warm
        return after

    return schedule


def decay_mask(named_params: Mapping[str, torch.Tensor],
               non_decay_keys: Sequence[str] = ()) -> dict[str, bool]:
    """True where weight decay applies (ndim >= 2 and no non-decay key in
    the name). The rule reads each tensor as the reference holds it, one per
    layer (the JAX package applies it to layer-stacked arrays, where the
    stacked RMSNorm gains have ndim 2; ROADMAP C4)."""
    return {n: p.ndim >= 2 and not any(k in n for k in non_decay_keys)
            for n, p in named_params.items()}


def global_norm(tensors: Sequence[torch.Tensor], group=None) -> torch.Tensor:
    """sqrt of the sum of squares of every element, fp32 (each tensor's
    norm accumulated in fp32 without an fp32 copy of it). DTensors count
    their local shards; ``group`` (the fsdp processes, whose shards make up
    each tensor) then sums the squares over its processes."""
    norms = torch._foreach_norm([local(t) for t in tensors], 2, dtype=torch.float32)
    norm = torch.linalg.vector_norm(torch.stack(norms))
    if group is None:
        return norm
    import torch.distributed as dist

    sq = norm.square()
    dist.all_reduce(sq, group=group)
    return sq.sqrt()


class AdamW:
    """clip_by_global_norm(max_grad_norm) then AdamW with a decay mask and a
    learning-rate schedule, over the parameters of ``named_params``."""

    def __init__(self, named_params: Mapping[str, nn.Parameter],
                 lr_schedule: Callable[[int], float], weight_decay: float = 0.0,
                 betas: tuple[float, float] = (0.9, 0.95), eps: float = 1e-8,
                 max_grad_norm: float = 1.0, non_decay_keys: Sequence[str] = (),
                 norm_group=None):
        mask = decay_mask(named_params, non_decay_keys)
        self.names = list(named_params)
        self.params = list(named_params.values())
        self.lr_schedule = lr_schedule
        self.max_grad_norm = max_grad_norm
        # the clip's all-reduce group over sharded parameters (None: whole)
        self.norm_group = norm_group
        self._settings = dict(lr_schedule=lr_schedule, weight_decay=weight_decay,
                              betas=betas, eps=eps, max_grad_norm=max_grad_norm,
                              non_decay_keys=non_decay_keys)
        self.count = 0
        groups = [
            {"params": [p for n, p in named_params.items() if mask[n]],
             "weight_decay": weight_decay},
            {"params": [p for n, p in named_params.items() if not mask[n]],
             "weight_decay": 0.0},
        ]
        # the fused kernel: no temporaries the size of the parameters (the
        # bf16 14B step's moments are 18 GB); the CPU has it too, so the
        # tests against optax run the code the card runs
        self.opt = torch.optim.AdamW([g for g in groups if g["params"]], lr=0.0,
                                     betas=betas, eps=eps, fused=True)

    def rebind(self, named_params: Mapping[str, nn.Parameter],
               norm_group=None) -> "AdamW":
        """A fresh AdamW with these settings over other parameters (count 0,
        no moments)."""
        return AdamW(named_params, norm_group=norm_group, **self._settings)

    @torch.no_grad()
    def update(self, grads: Sequence[torch.Tensor]) -> None:
        """One update from ``grads`` (fp32, in the order of ``names``);
        clips them in place."""
        grads = list(grads)
        if self.max_grad_norm and self.max_grad_norm > 0:
            norm = global_norm(grads, self.norm_group)
            clip = norm >= self.max_grad_norm
            one = torch.ones((), device=norm.device)
            shards = [local(g) for g in grads]
            torch._foreach_div_(shards, torch.where(clip, norm, one))
            torch._foreach_mul_(shards, torch.where(
                clip, torch.full((), self.max_grad_norm, device=norm.device), one))
        for p, g in zip(self.params, grads):
            # the fused kernel wants each gradient laid out as its parameter
            # (a transposed view's gradient, e.g. lm_head's, arrives transposed)
            p.grad = g if g.stride() == p.stride() else g.contiguous()
        lr = self.lr_schedule(self.count)
        for group in self.opt.param_groups:
            group["lr"] = lr
        self.opt.step()
        for p in self.params:
            p.grad = None
        self.count += 1


@torch.no_grad()
def ema_update(ema: Sequence[torch.Tensor], params: Sequence[torch.Tensor],
               decay: float = 0.9999) -> None:
    """ema <- ema * decay + params * (1 - decay), in place (on the local
    shards of DTensors)."""
    step = 1.0 - decay
    ema = [local(e) for e in ema]
    torch._foreach_mul_(ema, 1.0 - step)
    torch._foreach_add_(ema, [local(p) for p in params], alpha=step)


@dataclasses.dataclass
class TrainState:
    """Model (master parameters), optimizer, EMA copies (None without EMA),
    step count."""

    model: nn.Module
    tx: AdamW
    ema: dict[str, torch.Tensor] | None
    step: int = 0

    @staticmethod
    def create(model: nn.Module, tx: AdamW, with_ema: bool = True) -> "TrainState":
        ema = ({n: p.detach().clone() for n, p in model.named_parameters()}
               if with_ema else None)
        return TrainState(model=model, tx=tx, ema=ema, step=0)


def apply_gradients(state: TrainState, grads: Sequence[torch.Tensor],
                    ema_decay: float = 0.9999) -> TrainState:
    """Optimizer update, then (if the state keeps one) EMA of the new
    parameters; step + 1."""
    state.tx.update(grads)
    if state.ema is not None:
        ema_update([state.ema[n] for n in state.tx.names], state.tx.params, ema_decay)
    state.step += 1
    return state
