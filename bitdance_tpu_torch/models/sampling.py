"""Flow-matching samplers (port of bitdance_tpu/models/sampling.py).

Guided serving samples through the whole-sampler kernel
(ops/fused_head.py); :func:`euler_maruyama` is the plain loop over any
x-prediction net: the unguided per-call path of DiffHead.sample, and a
second oracle for the kernel. :func:`euler` is the plain Euler ODE variant.
"""

from __future__ import annotations

from typing import Callable

import torch


def time_shift(t: torch.Tensor, flow_shift: float = 1.0,
               sigma: float = 1.0) -> torch.Tensor:
    """(1/s) / ((1/s) + (1/t - 1)**sigma)."""
    if flow_shift == 1.0 and sigma == 1.0:
        return t
    inv = 1.0 / flow_shift
    return inv / (inv + (1.0 / t - 1.0) ** sigma)


def _velocity_from_cfg(v: torch.Tensor, cfg: float, cfg_mult: int) -> torch.Tensor:
    """uncond + cfg * (cond - uncond); rows ordered [cond; uncond]."""
    if cfg_mult == 2:
        v_cond, v_unc = v.chunk(2, dim=0)
        v = v_unc + cfg * (v_cond - v_unc)
    return v


def _initial_x(cond: torch.Tensor, generator, input_dim: int, cfg_mult: int,
               x_init: torch.Tensor | None) -> torch.Tensor:
    x_shape = list(cond.shape)
    x_shape[0] //= cfg_mult
    x_shape[-1] = input_dim
    if x_init is not None:
        return x_init.float()
    return torch.randn(x_shape, generator=generator, device=cond.device)


def euler_maruyama(net_fn: Callable, cond: torch.Tensor,
                   generator: torch.Generator | None, input_dim: int,
                   cfg: float = 1.0, cfg_mult: int | None = None,
                   num_sampling_steps: int = 20, last_step_size: float = 0.05,
                   flow_shift: float = 1.0, x_init: torch.Tensor | None = None,
                   noise: torch.Tensor | None = None,
                   stochastic: bool = True) -> torch.Tensor:
    """Euler-Maruyama sampling conditioned on ``cond`` (rows [cond; uncond]
    when cfg_mult == 2; cfg_mult defaults to 2 if cfg > 1 else 1, as in the
    JAX package). net_fn(x, t_batch, cond) -> x-prediction.

    x_init / noise ([num_sampling_steps, *x.shape]) replace the draws from
    ``generator``; stochastic=False drops the per-step noise."""
    if cfg_mult is None:
        cfg_mult = 2 if cfg > 1.0 else 1
    dev = cond.device
    x = _initial_x(cond, generator, input_dim, cfg_mult, x_init)
    t_all = torch.linspace(0.0, 1.0 - last_step_size, num_sampling_steps + 1)
    t_all = time_shift(t_all, flow_shift)

    def predict_v(x, t):
        combined = torch.cat([x] * cfg_mult, dim=0)
        t_batch = torch.full((cond.shape[0],), t, dtype=torch.float32, device=dev)
        out = net_fn(combined, t_batch, cond).float()
        v = (out - combined) / max(1.0 - t, 0.05)
        return _velocity_from_cfg(v, cfg, cfg_mult)

    for i in range(num_sampling_steps):
        t = float(t_all[i])
        dt = float(t_all[i + 1] - t_all[i])
        v = predict_v(x, t)
        var = (1.0 - t) ** 2 + t * (1.0 - t)
        score = (t * v - x) / var
        x = x + (v + (1.0 - t) * score) * dt
        if stochastic:
            nz = (noise[i] if noise is not None else
                  torch.randn(x.shape, generator=generator, device=dev))
            x = x + (2.0 * (1.0 - t) * dt) ** 0.5 * nz.float()
    v = predict_v(x, 1.0 - last_step_size)
    return x + v * last_step_size


def euler(net_fn: Callable, cond: torch.Tensor,
          generator: torch.Generator | None, input_dim: int,
          cfg: float = 1.0, cfg_mult: int = 2, num_sampling_steps: int = 50,
          x_init: torch.Tensor | None = None) -> torch.Tensor:
    """Plain Euler ODE variant: net_fn predicts the velocity directly;
    t = i / num_sampling_steps, x += v * dt."""
    x = _initial_x(cond, generator, input_dim, cfg_mult, x_init)
    dt = 1.0 / num_sampling_steps
    ts = torch.arange(num_sampling_steps, dtype=torch.float32) * dt
    for t in ts.tolist():
        combined = torch.cat([x] * cfg_mult, dim=0)
        t_batch = torch.full((cond.shape[0],), t, dtype=torch.float32,
                             device=cond.device)
        v = net_fn(combined, t_batch, cond).float()
        x = x + _velocity_from_cfg(v, cfg, cfg_mult) * dt
    return x
