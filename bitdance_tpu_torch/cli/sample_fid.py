"""FID sampling from a training checkpoint (the port's counterpart of
scripts/sample_fid.py, the reference's imagenet_gen/sample_ddp.py).

    python -m bitdance_tpu_torch.cli.sample_fid --model BitDance-B \\
        --ckpt results/b1x/checkpoints --num-fid-samples 50000

Restores the latest step of ``--ckpt`` (a CheckpointManager directory of
cli/train_imagenet.py), samples class-balanced images from the EMA weights
(``--no-ema``: the trained weights) in bf16, the card's sampler kernels'
type, saves them as PNGs under
``<sample-dir>/<model>-size-<px>-steps-<n>-cfg-<s>-seed-<seed>/`` and packs
the folder into the .npz of the ADM evaluation suite.
"""

from __future__ import annotations

import argparse
import os
import sys


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--model", type=str, default="BitDance-B")
    p.add_argument("--image-size", type=int, default=256)
    p.add_argument("--latent-dim", type=int, default=16)
    p.add_argument("--parallel-num", type=int, default=1)
    p.add_argument("--ckpt", type=str, required=True,
                   help="checkpoint directory of cli/train_imagenet.py")
    p.add_argument("--trained-vae", type=str, default="")
    p.add_argument("--sample-dir", type=str, default="samples")
    p.add_argument("--per-proc-batch-size", type=int, default=32)
    p.add_argument("--num-fid-samples", type=int, default=50000)
    p.add_argument("--cfg-scale", type=float, default=4.6)
    p.add_argument("--seed", type=int, default=99)
    p.add_argument("--sample-steps", type=int, default=100)
    p.add_argument("--no-ema", action="store_true")
    p.add_argument("--device", type=str, default="cuda")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    import torch

    from bitdance_tpu_torch.cli.common import imagenet_tokenizer, require_device
    from bitdance_tpu_torch.eval.fid import sample_fid, sampler_from_train_state
    from bitdance_tpu_torch.models.imagenet_ar import IMAGENET_MODELS
    from bitdance_tpu_torch.train.checkpoints import CheckpointManager
    from bitdance_tpu_torch.train.imagenet_train import (
        ImageNetTrainConfig,
        init_train_state,
    )
    from bitdance_tpu_torch.utils.fs import init_distributed
    from bitdance_tpu_torch.utils.precision import full_fp32

    device = require_device(args.device)
    full_fp32()
    rank, world = init_distributed(device)
    cfg = IMAGENET_MODELS[args.model](resolution=args.image_size,
                                      latent_dim=args.latent_dim,
                                      parallel_num=args.parallel_num)
    state = init_train_state(cfg, ImageNetTrainConfig(), device)
    ckpt = CheckpointManager(args.ckpt)
    restored, step, _ = ckpt.restore(state)
    ckpt.close()
    if restored is None:
        raise SystemExit(f"no checkpoint found under {args.ckpt}")
    dtype = torch.bfloat16
    model, head, stacked = sampler_from_train_state(state, cfg, ema=not args.no_ema,
                                                    dtype=dtype)
    del state, restored
    print(f"loaded step {step} ({'raw' if args.no_ema else 'EMA'} weights, "
          f"bf16) on {device}")
    ae = imagenet_tokenizer(args.latent_dim, args.trained_vae, device, dtype,
                            encoder=False, seed=1)
    folder = (f"{args.model.replace('/', '-')}-size-{args.image_size}-"
              f"steps-{args.sample_steps}-cfg-{args.cfg_scale}-seed-{args.seed}")
    npz = sample_fid(model, head, cfg, ae, os.path.join(args.sample_dir, folder),
                     num_fid_samples=args.num_fid_samples,
                     per_proc_batch_size=args.per_proc_batch_size,
                     cfg_scale=args.cfg_scale, sample_steps=args.sample_steps,
                     seed=args.seed, head_stacked=stacked, rank=rank, world=world)
    if npz:
        print(f"packed {npz} for the ADM evaluation suite")
    return 0


if __name__ == "__main__":
    sys.exit(main())
