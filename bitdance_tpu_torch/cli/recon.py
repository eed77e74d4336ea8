"""Tokenizer reconstruction quality of an ae safetensors file (the port's
counterpart of scripts/eval_tokenizer_recon.py).

    python -m bitdance_tpu_torch.cli.recon --images DIR --ae ae.safetensors \\
        [--ae-config ae_config.json] [--resolution 256] [--limit 64] \\
        [--batch 8] [--uni] [--seed 0]

Loads the images (sorted, ADM center crop), reconstructs them through the
port's tokenizer (encode to ±1 latents, decode) and prints one JSON line:
``n_images``, ``resolution`` and ReconReport's fields (PSNR in dB, SSIM;
the reference fields are null). ``--uni`` reads a UniWeTok file: its
``model_ema.*`` weights replace the plain ones (io/release.py::
remap_ema_state) and its GAN decoder draws noise from a generator seeded
with ``--seed``. There is no comparison with the reference's torch
modules: they are not part of this repository (the JAX script's
``--no-torch`` route). Runs in fp32, as the JAX script does, on the card
unless ``--device cpu``.

Published numbers (the reference's README): ae_d16c32 (2^32, 16x) IN-256
PSNR 24.90 / SSIM 0.72; ae_d32c128 23.26 / 0.67; ae_d32c256 25.29 / 0.74.
"""

from __future__ import annotations

import argparse
import json
import sys


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0],
                                epilog="No reference side: the reference's torch "
                                "modules are not part of this repository, so only "
                                "the port's metrics are printed.")
    p.add_argument("--images", required=True, help="folder of images (IN-256 val protocol)")
    p.add_argument("--ae", required=True, help="ae_*.safetensors path")
    p.add_argument("--ae-config", default="", help="ae_config.json with a ddconfig "
                   "block (default: the 14B release tokenizer's geometry, "
                   "train/configs/bitdance_14b_64x.yaml:9-16)")
    p.add_argument("--resolution", type=int, default=256)
    p.add_argument("--limit", type=int, default=64, help="max images (0 = all)")
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--uni", action="store_true",
                   help="UniWeTok tokenizer (EMA weights, GAN decoder)")
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the GAN decoder's noise (--uni)")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def load_tokenizer(path: str, ddconfig: dict, uni: bool, device):
    """The fp32 tokenizer (encoder and decoder) of an ae safetensors file."""
    import torch

    from bitdance_tpu_torch.io.release import load_safetensors, load_state_, remap_ema_state
    from bitdance_tpu_torch.models.tokenizer import VQModel
    from bitdance_tpu_torch.models.tokenizer_uni import UniVQModel

    state = load_safetensors(path)
    if uni:
        state = remap_ema_state(state)
    with torch.device("meta"):
        model = (UniVQModel if uni else VQModel)(ddconfig, encoder=True, decoder=True)
    return load_state_(model.to_empty(device=device), state).eval().requires_grad_(False)


def main(argv=None) -> int:
    import torch

    from bitdance_tpu_torch.cli.common import require_device
    from bitdance_tpu_torch.eval.recon import (
        compare_reconstructions,
        load_image_folder,
        reconstruct,
    )
    from bitdance_tpu_torch.io.random_init import BITDANCE_14B_64X
    from bitdance_tpu_torch.utils.precision import full_fp32

    args = parse_args(argv)
    full_fp32()
    device = require_device(args.device)
    ddconfig = BITDANCE_14B_64X["ddconfig"]
    if args.ae_config:
        with open(args.ae_config) as f:
            j = json.load(f)
        ddconfig = j.get("ddconfig", j)
    model = load_tokenizer(args.ae, ddconfig, args.uni, device)
    images = load_image_folder(args.images, args.resolution, args.limit)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    recon = reconstruct(model, images, batch=args.batch, generator=gen)
    report = compare_reconstructions(images, recon)
    print(json.dumps({"n_images": int(images.shape[0]), "resolution": args.resolution,
                      **report.as_dict()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
