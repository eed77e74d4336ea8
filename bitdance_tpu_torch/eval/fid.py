"""ImageNet FID sampling: class-balanced samples as PNGs and the .npz of the
ADM evaluation suite (port of bitdance_tpu/eval/fid.py, the reference's
imagenet_gen/sample_ddp{,_parallel}.py:30-196).

Global sample g has class g % num_classes, in rank-strided batches
(sample_ddp.py:143-151); iteration ``it`` of rank ``rank`` draws from a
generator seeded by seed * world + rank + it * 131. Sampling is
models/imagenet_ar.py::sample (the whole sampler kernel when guided, the
head-block kernels per call when not), then the VQ decoder to uint8.
Computing FID itself needs Inception weights and reference statistics that
are not in the repository.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch

from bitdance_tpu_torch.models.diff_head import make_fused_sampler
from bitdance_tpu_torch.models.imagenet_ar import decode_uint8, sample


@torch.no_grad()
def sampler_from_train_state(state, cfg, ema: bool = True,
                             dtype: torch.dtype = torch.bfloat16):
    """(backbone, head, sampler stack) in ``dtype`` on the state's device
    from a training state's EMA weights (its parameters with ema=False),
    as sample_ddp.py:90-98 loads them."""
    from bitdance_tpu_torch.train.imagenet_train import ImageNetTrainModel

    if ema and state.ema is None:
        raise ValueError("the training state keeps no EMA weights")
    src = state.ema if ema else dict(state.model.named_parameters())
    device = next(state.model.parameters()).device
    with torch.device("meta"):
        m = ImageNetTrainModel(cfg, dtype=dtype)
    m = m.to_empty(device=device).eval().requires_grad_(False)
    for name, p in m.named_parameters():
        p.copy_(src[name])
    return m.ar, m.head, m.head._stack_for_sampler()


def create_npz_from_sample_folder(sample_dir: str, num: int = 50_000) -> str:
    """Pack {0..num-1:06d}.png into <sample_dir>.npz as arr_0, [num, H, W, 3]
    uint8 (sample_ddp.py:30-61)."""
    from PIL import Image

    samples = []
    for i in range(num):
        with Image.open(os.path.join(sample_dir, f"{i:06d}.png")) as im:
            samples.append(np.asarray(im))
    arr = np.stack(samples)
    npz_path = f"{sample_dir}.npz"
    np.savez(npz_path, arr_0=arr)
    return npz_path


@torch.no_grad()
def sample_fid(model, head, cfg, ae, sample_dir: str,
               num_fid_samples: int = 50_000, per_proc_batch_size: int = 32,
               cfg_scale: float = 4.6, sample_steps: int = 100, seed: int = 99,
               save_png: bool = True, pack_npz: bool = True,
               head_stacked: dict | None = None, rank: int = 0,
               world: int = 1) -> str | None:
    """Generate this rank's share of ``num_fid_samples`` class-balanced
    samples with ``model`` (an ImageNetAR) and ``head`` on their device,
    decode them with ``ae`` and save {g:06d}.png; rank 0 then packs the
    npz, after a barrier of the process group when ``world`` > 1, and
    returns its path. ``head_stacked`` is the head's sampler stack
    (stacked here when not given)."""
    from PIL import Image

    device = next(model.parameters()).device
    n = per_proc_batch_size
    num_iters = int(math.ceil(num_fid_samples / (n * world)))
    sampler = make_fused_sampler(head, head_stacked)
    os.makedirs(sample_dir, exist_ok=True)
    for it in range(num_iters):
        gidx = np.arange(n) + world * n * it + rank * n
        cls = torch.from_numpy(gidx % cfg.num_classes).to(device)
        gen = torch.Generator(device=device).manual_seed(seed * world + rank + it * 131)
        tokens = sample(model, head, cfg, cls, gen, num_sampling_steps=sample_steps,
                        cfg_scale=cfg_scale, head_sampler=sampler)
        images = decode_uint8(ae, cfg, tokens).cpu().numpy()
        if save_png:
            for j, g in enumerate(gidx):
                if g < num_fid_samples:
                    Image.fromarray(images[j]).save(
                        os.path.join(sample_dir, f"{g:06d}.png"))
    if world > 1:
        import torch.distributed as dist

        dist.barrier()                      # every rank's PNGs are written
    if pack_npz and rank == 0:
        return create_npz_from_sample_folder(sample_dir, num_fid_samples)
    return None
