"""Tokenizer reconstruction quality (port of bitdance_tpu/eval/recon.py:
psnr, ssim, load_image_folder, ``reconstruct`` for ``reconstruct_jax``,
ReconReport and compare_reconstructions).

``reconstruct`` runs images through the port's VQModel or UniVQModel:
``encode`` (a VQModel's on the card: the trunk and the fused tail kernel,
ops/fused_encode.py) to ±1 latents, then ``decode`` (a GAN decoder's noise
from the caller's generator), batch by batch. PSNR over the full dynamic
range and SSIM with an 11x11 gaussian window (sigma 1.5), as the JAX module
measures them, in numpy. ``reconstruct_torch`` (the reference's own torch
modules, which are not part of this repository) is not ported.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os

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


IMG_EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".webp", ".JPEG")


def load_image_folder(path: str, resolution: int = 256,
                      limit: int = 0) -> np.ndarray:
    """The folder's images (sorted by name; the first ``limit`` when it is
    not 0) -> [N, H, W, 3] float32 in [-1, 1], each ADM center-cropped to
    ``resolution`` (data/imagenet.py::center_crop_arr, the protocol of the
    published IN-256 numbers)."""
    from PIL import Image

    from bitdance_tpu_torch.data.imagenet import center_crop_arr

    files = sorted(os.path.join(path, f) for f in os.listdir(path)
                   if f.endswith(IMG_EXTS))
    if limit:
        files = files[:limit]
    if not files:
        raise FileNotFoundError(f"no images under {path}")
    out = []
    for f in files:
        with Image.open(f) as im:
            arr = center_crop_arr(im.convert("RGB"), resolution)
        out.append(arr.astype(np.float32) / 127.5 - 1.0)
    return np.stack(out)


@torch.no_grad()
def reconstruct(model, images: np.ndarray, batch: int = 8,
                timer: PhaseTimer | None = None,
                latents_out: list | None = None,
                generator: torch.Generator | None = None) -> np.ndarray:
    """encode -> ±1 latents -> decode through ``model`` (a VQModel or
    UniVQModel with encoder and decoder), ``batch`` images at a time on the
    model's device; a GAN decoder draws its noise from ``generator``, batch
    after batch. images: [N, H, W, 3] in [-1, 1]; returns the same shape
    and range (clipped), float32. ``timer`` gets "encode" and "decode"
    spans; ``latents_out`` collects each batch's latents."""
    full_fp32()
    dev = model.decoder.conv_in.weight.device
    outs = []
    for i in range(0, images.shape[0], batch):
        x = torch.from_numpy(np.ascontiguousarray(images[i:i + batch])).to(dev)
        with timer("encode") if timer else contextlib.nullcontext():
            q = model.encode(x)
        with timer("decode") if timer else contextlib.nullcontext():
            y = model.decode(q, generator=generator)
        if latents_out is not None:
            latents_out.append(q)
        outs.append(y.float().clamp(-1.0, 1.0).cpu().numpy())
    return np.concatenate(outs)



@dataclasses.dataclass
class ReconReport:
    """PSNR / SSIM of the port's reconstruction and, when one is given, of
    a reference reconstruction of the same images (the JAX report's
    ``*_jax`` and ``*_torch`` fields)."""

    psnr: float
    ssim: float
    psnr_ref: float | None = None
    ssim_ref: float | None = None

    @property
    def psnr_delta(self) -> float | None:
        return None if self.psnr_ref is None else self.psnr - self.psnr_ref

    @property
    def within_north_star(self) -> bool | None:
        """PSNR within 0.05 dB of the reference's (BASELINE.md)."""
        d = self.psnr_delta
        return None if d is None else bool(d >= -0.05)

    def as_dict(self) -> dict:
        r4 = lambda v: None if v is None else round(v, 4)  # noqa: E731
        return {"psnr_db": r4(self.psnr), "ssim": r4(self.ssim),
                "psnr_ref_db": r4(self.psnr_ref), "ssim_ref": r4(self.ssim_ref),
                "psnr_delta_db": r4(self.psnr_delta),
                "within_0p05db": self.within_north_star}


def compare_reconstructions(images: np.ndarray, recon: np.ndarray,
                            recon_ref: np.ndarray | None = None) -> ReconReport:
    """PSNR / SSIM of each reconstruction against the ground-truth images
    (the published-number convention), NHWC in [-1, 1]; SSIM over
    [N, C, H, W]."""
    def metrics(r):
        return psnr(images, r), ssim(images.transpose(0, 3, 1, 2), r.transpose(0, 3, 1, 2))

    p, s = metrics(recon)
    if recon_ref is None:
        return ReconReport(p, s)
    return ReconReport(p, s, *metrics(recon_ref))
