"""Text-to-image from a release directory (the port's counterpart of
example_t2i.py).

    python -m bitdance_tpu_torch.cli.t2i models/BitDance-14B-64x \\
        --prompt "A fluffy corgi sitting on a skateboard in Times Square" \\
        --resolution 1024 --seed 1234 --cfg 7.5 --steps 50 --out t2i.png

Loads the directory with pipelines/loader.py (optionally quantized), runs
one request and writes the images as PNG files (a second image of a request
goes to <out>_1.png, ...). The PNG writer is this module's own (zlib), since
the card's machine has no imaging package.
"""

from __future__ import annotations

import argparse
import struct
import sys
import time
import zlib
from pathlib import Path

import numpy as np


def write_png(path, image: np.ndarray) -> None:
    """uint8 RGB [H, W, 3] -> an 8-bit truecolor PNG (filter 0 rows)."""
    img = np.ascontiguousarray(image, dtype=np.uint8)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"write_png: want [H, W, 3] uint8, got {img.shape}")
    h, w, _ = img.shape
    raw = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, w * 3)], axis=1)

    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    png = (b"\x89PNG\r\n\x1a\n"
           + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
           + chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
           + chunk(b"IEND", b""))
    Path(path).write_bytes(png)


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("model_dir", help="release directory (HF Qwen3 + tokenizer, "
                   "ae / vision_head / projector safetensors and configs)")
    p.add_argument("--prompt", default="A fluffy corgi sitting on a skateboard "
                   "in Times Square")
    p.add_argument("--resolution", type=int, default=1024,
                   help="square image side in pixels")
    p.add_argument("--seed", type=int, default=1234)
    p.add_argument("--cfg", type=float, default=7.5, help="guidance scale")
    p.add_argument("--steps", type=int, default=50, help="sampling steps")
    p.add_argument("--images", type=int, default=1)
    p.add_argument("--quantize-llm", action="store_true",
                   help="W8A8 int8 Qwen3 projections")
    p.add_argument("--quantize-head", choices=("int8", "int4"), default=None,
                   help="quantized sampler head (W8A8 or packed W4A8)")
    p.add_argument("--quantize-embed", action="store_true",
                   help="int8 embedding table")
    p.add_argument("--dtype", choices=("bfloat16", "float32"), default="bfloat16")
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default="t2i.png")
    return p.parse_args(argv)


def main(argv=None, tokenizer=None) -> int:
    """Run the command; ``tokenizer`` replaces the directory's HF tokenizer
    (for callers without ``transformers``)."""
    import torch

    from bitdance_tpu_torch.pipelines.loader import load_t2i_pipeline

    args = parse_args(argv)
    head_q = {None: False, "int8": True, "int4": "int4"}[args.quantize_head]
    t0 = time.perf_counter()
    pipe = load_t2i_pipeline(args.model_dir, dtype=getattr(torch, args.dtype),
                             quantize_llm=args.quantize_llm, quantize_head=head_q,
                             quantize_embed=args.quantize_embed,
                             device=args.device, tokenizer=tokenizer)
    t1 = time.perf_counter()
    images = pipe.generate(args.prompt, height=args.resolution,
                           width=args.resolution, num_sampling_steps=args.steps,
                           guidance_scale=args.cfg, num_images=args.images,
                           seed=args.seed)
    t2 = time.perf_counter()
    out = Path(args.out)
    for i, img in enumerate(images):
        path = out if i == 0 else out.with_name(f"{out.stem}_{i}{out.suffix}")
        write_png(path, img)
        print(f"saved {path} ({img.shape[1]}x{img.shape[0]})")
    print(f"load {t1 - t0:.2f} s, generate {t2 - t1:.2f} s on {args.device}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
