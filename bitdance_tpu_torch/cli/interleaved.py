"""Interleaved generation from a release directory (the port's counterpart of
example_interleaved.py): the user asks about an image, the model describes
it and draws a new one.

    python -m bitdance_tpu_torch.cli.interleaved models/BitDance-14B-64x \\
        --image example_t2i.png --image-size 1024 --cfg 7.5 --steps 50 \\
        --max-length-text 256 --seed 0 --out example_interleaved.png

The plan is example_interleaved.py's: the chat user text, the user image
(``--image``, an 8-bit RGB or RGBA PNG, read by cli/common.py), a generated
text span and a generated image of ``--image-size`` pixels a side. The
cache is sized from the plan (pipelines/interleaved.py::plan_slots), so a
1024 px image in and out never overflows it. The model loads in bf16, the
dtype the card's kernels take. Prints what the model said and writes the
image with cli/t2i.py's PNG writer.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

PROMPT = "Describe this image, then draw a night-time version of it."


def chat_text(prompt: str) -> str:
    """The user turn and the assistant's opening, as example_interleaved.py
    writes them."""
    return f"<|im_start|>user\n{prompt}<|im_end|>\n<|im_start|>assistant\n"


def example_plan(prompt: str, user_image_u8: np.ndarray, image_size: int) -> list:
    """example_interleaved.py's plan: user text, the user image (uint8
    [H, W, 3] mapped to [-1, 1]), generated text, a generated image."""
    from bitdance_tpu_torch.pipelines.interleaved import PlanItem

    img = user_image_u8.astype(np.float32) / 127.5 - 1.0
    return [PlanItem(type="text", source="user", text=chat_text(prompt)),
            PlanItem(type="image", source="user", image=img),
            PlanItem(type="text", source="model"),
            PlanItem(type="image", source="model", image_size=(image_size, image_size))]


def to_uint8(image: np.ndarray) -> np.ndarray:
    """A generated float image [H, W, 3] in [-1, 1] -> uint8, as
    example_interleaved.py converts it."""
    return np.clip((image + 1.0) * 127.5, 0, 255).astype(np.uint8)


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("model_dir", help="release directory (HF Qwen3 with its lm_head, "
                   "tokenizer, ae with its encoder, vision_head and projector)")
    p.add_argument("--image", required=True, help="the user image, an 8-bit PNG")
    p.add_argument("--prompt", default=PROMPT, help="the user's request")
    p.add_argument("--image-size", type=int, default=1024,
                   help="side of the generated square image in pixels")
    p.add_argument("--cfg", type=float, default=7.5, help="guidance scale")
    p.add_argument("--steps", type=int, default=50, help="sampling steps")
    p.add_argument("--max-length-text", type=int, default=256,
                   help="most tokens of the generated text")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--quantize-llm", action="store_true",
                   help="W8A8 int8 Qwen3 projections and lm_head")
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default="interleaved.png")
    return p.parse_args(argv)


def main(argv=None, tokenizer=None) -> int:
    """Run the command; ``tokenizer`` replaces the directory's HF tokenizer
    (for callers without ``transformers``)."""
    import torch

    from bitdance_tpu_torch.cli.common import read_png, require_device
    from bitdance_tpu_torch.cli.t2i import write_png
    from bitdance_tpu_torch.pipelines.interleaved import InterleavedGenerator, plan_slots
    from bitdance_tpu_torch.pipelines.loader import load_t2i_pipeline

    args = parse_args(argv)
    device = require_device(args.device)
    t0 = time.perf_counter()
    pipe = load_t2i_pipeline(args.model_dir, dtype=torch.bfloat16,
                             quantize_llm=args.quantize_llm, device=device,
                             tokenizer=tokenizer, interleaved=True)
    plan = example_plan(args.prompt, read_png(args.image), args.image_size)
    slots = plan_slots(plan, pipe.tokenizer, pipe.bundle, args.max_length_text)
    gen = InterleavedGenerator(pipe.bundle, pipe.tokenizer, max_seq_len=slots)
    t1 = time.perf_counter()
    out = gen.generate(plan, cfg_scale=args.cfg, sample_steps=args.steps,
                       max_length_text=args.max_length_text, seed=args.seed)
    t2 = time.perf_counter()
    print("model said:", out["generated_text"][0])
    write_png(args.out, to_uint8(out["generated_image"][0]))
    print(f"saved {args.out} ({args.image_size}x{args.image_size}); cache {slots} "
          f"slots; load {t1 - t0:.2f} s, generate {t2 - t1:.2f} s on {args.device}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
