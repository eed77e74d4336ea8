"""Tokenizer reconstruction quality (port of bitdance_tpu/eval/recon.py:
psnr, ssim, and ``reconstruct`` for ``reconstruct_jax``).

``reconstruct`` runs images through the port's VQModel: ``encode`` (on the
card the trunk and the fused tail kernel, ops/fused_encode.py) to ±1
latents, then ``decode``, batch by batch. PSNR over the full dynamic range
and SSIM with an 11x11 gaussian window (sigma 1.5), as the JAX module
measures them, in numpy. ``load_image_folder`` (PIL) and
``reconstruct_torch`` (the reference modules) are not ported.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from bitdance_tpu_torch.utils.precision import full_fp32
from bitdance_tpu_torch.utils.timing import PhaseTimer


def psnr(a: np.ndarray, b: np.ndarray, data_range: float = 2.0) -> float:
    """Peak signal-to-noise ratio in dB. Default range 2.0 = [-1, 1] images."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    mse = float(np.mean((a - b) ** 2))
    if mse == 0.0:
        return float("inf")
    return 10.0 * float(np.log10(data_range ** 2 / mse))


def _gaussian_kernel(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    x = np.arange(size, dtype=np.float64) - (size - 1) / 2.0
    k = np.exp(-(x ** 2) / (2.0 * sigma ** 2))
    return k / k.sum()


def _filter2_sep(img: np.ndarray, k: np.ndarray) -> np.ndarray:
    """Separable 'valid' gaussian filtering over the LAST TWO axes."""
    img = np.apply_along_axis(lambda r: np.convolve(r, k, mode="valid"), -1, img)
    return np.apply_along_axis(lambda c: np.convolve(c, k, mode="valid"), -2, img)


def ssim(a: np.ndarray, b: np.ndarray, data_range: float = 2.0,
         win_size: int = 11, sigma: float = 1.5) -> float:
    """Mean SSIM over [..., H, W] (leading axes = batch/channel), gaussian
    window (skimage's structural_similarity with gaussian_weights=True,
    use_sample_covariance=False)."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    k = _gaussian_kernel(win_size, sigma)
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    mu_a, mu_b = _filter2_sep(a, k), _filter2_sep(b, k)
    var_a = _filter2_sep(a * a, k) - mu_a ** 2
    var_b = _filter2_sep(b * b, k) - mu_b ** 2
    cov = _filter2_sep(a * b, k) - mu_a * mu_b
    s = ((2 * mu_a * mu_b + c1) * (2 * cov + c2)) / (
        (mu_a ** 2 + mu_b ** 2 + c1) * (var_a + var_b + c2))
    return float(np.mean(s))


@torch.no_grad()
def reconstruct(model, images: np.ndarray, batch: int = 8,
                timer: PhaseTimer | None = None,
                latents_out: list | None = None) -> np.ndarray:
    """encode -> ±1 latents -> decode through ``model`` (a VQModel with
    encoder and decoder), ``batch`` images at a time on the model's device.
    images: [N, H, W, 3] in [-1, 1]; returns the same shape and range
    (clipped), float32. ``timer`` gets "encode" and "decode" spans;
    ``latents_out`` collects each batch's latents."""
    full_fp32()
    dev = model.decoder.conv_in.weight.device
    outs = []
    for i in range(0, images.shape[0], batch):
        x = torch.from_numpy(np.ascontiguousarray(images[i:i + batch])).to(dev)
        with timer("encode") if timer else contextlib.nullcontext():
            q = model.encode(x)
        with timer("decode") if timer else contextlib.nullcontext():
            y = model.decode(q)
        if latents_out is not None:
            latents_out.append(q)
        outs.append(y.float().clamp(-1.0, 1.0).cpu().numpy())
    return np.concatenate(outs)

