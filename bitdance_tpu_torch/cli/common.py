"""What the ImageNet command lines share: the device check and the frozen
tokenizer at the commands' width (scripts/train_imagenet.py:131-132 and
scripts/sample_fid.py of the JAX package)."""

from __future__ import annotations

import re

import torch

# the ImageNet tokenizer of the training and sampling commands; z_channels
# comes from --latent-dim
TOKENIZER_DDCONFIG = dict(in_channels=3, out_ch=3, ch=256, ch_mult=[1, 1, 2, 2, 4],
                          num_res_blocks=4)


def require_device(name: str) -> torch.device:
    """The device a command runs on; a CUDA device without a card raises
    (the commands never fall back to the CPU)."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {name}: no CUDA device is available "
                         "(pass --device cpu to run on the CPU)")
    return device


def imagenet_tokenizer(latent_dim: int, trained_vae: str, device: torch.device,
                       dtype: torch.dtype = torch.float32, *, encoder: bool,
                       seed: int = 0):
    """The frozen VQ tokenizer's encoder (``encoder=True``) or decoder:
    from a reference ae safetensors file when ``trained_vae`` is given
    (the other half's keys are skipped), else drawn with the flax-default
    init from ``seed``."""
    from bitdance_tpu_torch.io.release import load_safetensors, load_state_
    from bitdance_tpu_torch.models.tokenizer import VQModel, init_vq

    dd = dict(TOKENIZER_DDCONFIG, z_channels=latent_dim)
    if not trained_vae:
        gen = torch.Generator(device=device).manual_seed(seed)
        return init_vq(dd, device, dtype, gen, encoder=encoder, decoder=not encoder)
    other = "decoder" if encoder else "encoder"
    with torch.device("meta"):
        ae = VQModel(dd, dtype=dtype, encoder=encoder, decoder=not encoder)
    ae = ae.to_empty(device=device)
    load_state_(ae, load_safetensors(trained_vae), ignore=(re.compile(rf"^{other}\."),))
    return ae.eval().requires_grad_(False)
