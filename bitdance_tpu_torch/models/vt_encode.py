"""Batched variable-resolution tokenizer encoding (port of
bitdance_tpu/models/vt_encode.py, the reference's VQModel.vt_forward /
vt_forward_maxpad).

A heterogeneous list of images becomes one packed [sum_i h_i * w_i, C]
stack of ±1 latents, in input order: ``vt_forward`` encodes same-(H, W)
images together, ``max_bs`` at a time, and orders each image's tokens in
the ps-raster; ``vt_forward_maxpad`` pads each bucket's images to a shared
stride-aligned size, encodes them together and crops each image's latents
(row-major tokens). Either works on a :class:`~bitdance_tpu_torch.models.
tokenizer.VQModel` with its encoder (``encode``: on the card the trunk and
kernel #13) or a :class:`~bitdance_tpu_torch.models.tokenizer_uni.
UniVQModel`, on the model's device.
"""

from __future__ import annotations

import math
from collections import defaultdict
from typing import Sequence

import numpy as np
import torch

from bitdance_tpu_torch.models.tokenizer import latents_to_tokens

NORMAL_BUCKETS = (384, 512, 768, 1024)


def is_long_image(h: int, w: int) -> bool:
    """A long image: major side >= 1024, minor <= 768, aspect >= 1.5."""
    major, minor = max(h, w), min(h, w)
    return major >= 1024 and minor <= 768 and major / minor >= 1.5


def bucket_of(h: int, w: int, normal_buckets: tuple = NORMAL_BUCKETS):
    """The maxpad bucket of an (H, W) image: "long", or the first normal
    bucket its major side fits (else "long")."""
    if is_long_image(h, w):
        return "long"
    major = max(h, w)
    return next((b for b in normal_buckets if major <= b), "long")


class BatchedEncoder:
    """Batched ±1 encoding of image lists with ``model`` (tokens ps-raster
    ordered with patch ``ps`` in :meth:`vt_forward`)."""

    def __init__(self, model, ps: int = 1):
        self.model = model
        self.ps = ps
        self.device = model.encoder.conv_in.weight.device

    @staticmethod
    def _images(image_list: Sequence) -> list[np.ndarray]:
        """NHWC float arrays, each [1, H, W, 3] or [H, W, 3] -> [1, H, W, 3]."""
        out = []
        for im in image_list:
            a = np.asarray(im, dtype=np.float32)
            out.append(a if a.ndim == 4 else a[None])
        return out

    @torch.no_grad()
    def _encode(self, batch: np.ndarray) -> torch.Tensor:
        return self.model.encode(torch.from_numpy(np.ascontiguousarray(batch)).to(self.device))

    def vt_forward(self, image_list: Sequence, max_bs: int = 32) -> torch.Tensor:
        """Group same-(H, W) images into batches of at most ``max_bs``.
        image_list: NHWC float arrays in [-1, 1]. Returns the packed ±1
        tokens [sum h * w, C] in input order, ps-raster per image."""
        imgs = self._images(image_list)
        groups: dict[tuple, list] = defaultdict(list)
        for i, im in enumerate(imgs):
            groups[im.shape[1:3]].append(i)
        out: list = [None] * len(imgs)
        for idxs in groups.values():
            for start in range(0, len(idxs), max_bs):
                chunk = idxs[start:start + max_bs]
                quant = self._encode(np.concatenate([imgs[i] for i in chunk], axis=0))
                toks = latents_to_tokens(quant, ps=self.ps)
                for bi, i in enumerate(chunk):
                    out[i] = toks[bi]
        return torch.cat(out, dim=0)

    def vt_forward_maxpad(self, image_list: Sequence, max_bs: int = 32,
                          stride: int = 32,
                          normal_buckets: tuple = NORMAL_BUCKETS) -> torch.Tensor:
        """Bucket the images (:func:`bucket_of`), zero-pad each batch of at
        most ``max_bs`` to its largest stride-aligned H and W, encode, and
        keep each image's top-left ceil(H / stride) x ceil(W / stride)
        latents, row-major (``ps`` is not used, as in the reference)."""
        imgs = self._images(image_list)
        groups: dict = defaultdict(list)
        for i, im in enumerate(imgs):
            groups[bucket_of(*im.shape[1:3], normal_buckets)].append(i)
        out: list = [None] * len(imgs)
        for idxs in groups.values():
            for start in range(0, len(idxs), max_bs):
                chunk = idxs[start:start + max_bs]
                h_pad = max(math.ceil(imgs[i].shape[1] / stride) * stride for i in chunk)
                w_pad = max(math.ceil(imgs[i].shape[2] / stride) * stride for i in chunk)
                batch = np.concatenate([
                    np.pad(imgs[i], ((0, 0), (0, h_pad - imgs[i].shape[1]),
                                     (0, w_pad - imgs[i].shape[2]), (0, 0)))
                    for i in chunk], axis=0)
                quant = self._encode(batch)
                for bi, i in enumerate(chunk):
                    hl = math.ceil(imgs[i].shape[1] / stride)
                    wl = math.ceil(imgs[i].shape[2] / stride)
                    out[i] = quant[bi, :hl, :wl].reshape(hl * wl, quant.shape[-1])
        return torch.cat(out, dim=0)
