"""Evaluation base (port of bitdance_tpu/eval/base.py): the pipeline and the
prompt split over processes.

Rank and world come from ``torch.distributed`` when a group is up (a
torchrun launch of the commands, ``utils/fs.py::init_distributed``), else
(0, 1); the seed is ``4396 * world + rank`` and each rank takes a contiguous
share of the prompts, as in the JAX package. Images are written with the
port's PNG writer (cli/common.py::png_bytes), whose bytes are those the JAX
package's Pillow writes for the same uint8 arrays.
"""

from __future__ import annotations

import logging
import os

import numpy as np
import torch.distributed as dist

from bitdance_tpu_torch.cli.common import png_bytes


class BaseEvaluator:
    """``pipeline`` (anything with T2IPipeline.generate's surface) or, when
    None, the release directory ``model_path`` loaded on ``device`` (the
    card unless the caller says otherwise) with ``tokenizer`` (None: the
    directory's own)."""

    def __init__(self, model_path: str, pipeline=None, device="cuda", tokenizer=None):
        if dist.is_available() and dist.is_initialized():
            self.rank, self.world_size = dist.get_rank(), dist.get_world_size()
        else:
            self.rank, self.world_size = 0, 1
        logging.basicConfig(level=logging.INFO, format="[%(asctime)s] %(message)s",
                            datefmt="%Y-%m-%d %H:%M:%S")
        self.logger = logging.getLogger(__name__)
        self.seed = 4396 * self.world_size + self.rank
        self.device = device
        self.model = pipeline or self._build_pipeline(model_path, tokenizer)

    def _build_pipeline(self, model_path: str, tokenizer=None):
        from bitdance_tpu_torch.pipelines.loader import load_t2i_pipeline

        return load_t2i_pipeline(model_path, device=self.device, tokenizer=tokenizer)

    def shard(self, datasets: list) -> list:
        """This rank's contiguous share (the reference's eval_dpg.py:24-29)."""
        total = len(datasets)
        per_rank = (total + self.world_size - 1) // self.world_size
        start = self.rank * per_rank
        return datasets[start: min(start + per_rank, total)]

    def build_dataset(self, *a, **kw):
        raise NotImplementedError

    def eval(self, *a, **kw):
        raise NotImplementedError


def _write(path: str, image: np.ndarray) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(png_bytes(image))


def save_grid(images: np.ndarray, path: str, nrow: int = 2) -> None:
    """Save [N, H, W, 3] uint8 images as a grid PNG of ``nrow`` columns."""
    n, h, w, c = images.shape
    rows = (n + nrow - 1) // nrow
    canvas = np.zeros((rows * h, nrow * w, c), np.uint8)
    for i in range(n):
        r, col = divmod(i, nrow)
        canvas[r * h: (r + 1) * h, col * w: (col + 1) * w] = images[i]
    _write(path, canvas)


def save_images(images: np.ndarray, paths: list[str]) -> None:
    for img, p in zip(images, paths):
        _write(p, img)


def harness_main(evaluator, description: str, data_path: str, save_dir: str,
                 guidance_scale: float, argv=None, tokenizer=None) -> int:
    """The command line both harnesses share (the JAX modules' flags, plus
    ``--max_prompts`` and ``--device``): starts the process group
    (``init_distributed``: a torchrun launch splits the prompts over its
    ranks), loads the release directory and writes this rank's share.
    ``tokenizer`` replaces the directory's HF tokenizer."""
    import argparse

    from bitdance_tpu_torch.cli.common import require_device
    from bitdance_tpu_torch.utils.fs import init_distributed

    p = argparse.ArgumentParser(description=description)
    p.add_argument("--model_path", type=str, required=True)
    p.add_argument("--data_path", type=str, default=data_path,
                   help="the vendored benchmark set; eval_assets/*stub* are the "
                        "test stubs")
    p.add_argument("--save_dir", type=str, default=save_dir)
    p.add_argument("--guidance_scale", type=float, default=guidance_scale)
    p.add_argument("--num_sampling_steps", type=int, default=50)
    p.add_argument("--image_size", type=int, nargs=2, default=[1024, 1024])
    p.add_argument("--max_prompts", type=int, default=0,
                   help="at most this many of a rank's prompts (0: all)")
    p.add_argument("--device", type=str, default="cuda")
    args = p.parse_args(argv)
    device = require_device(args.device)
    init_distributed(device)
    ev = evaluator(args.model_path, device=device, tokenizer=tokenizer)
    ev.eval(args.data_path, args.save_dir, args.guidance_scale,
            args.num_sampling_steps, tuple(args.image_size), max_prompts=args.max_prompts)
    return 0
