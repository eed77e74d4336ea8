"""Special-token machinery for the multimodal sequence format (the port's own
copy of bitdance_tpu/data/special_tokens.py; the port imports nothing of the
JAX package).

Chatml markers, vision start/end, resolution tokens <|res_1|>..<|res_{max}|>
(res_i == i latent patches), and query tokens <|query_1|>..<|query_{p-1}|>
appended before an image span so the prompt tail yields ``parallel_num``
hidden states.
"""

from __future__ import annotations

IM_START = "<|im_start|>"
IM_END = "<|im_end|>"
VISION_START = "<|vision_start|>"
VISION_END = "<|vision_end|>"
IMAGE_PAD = "<|image_pad|>"


def res_token(i: int) -> str:
    return f"<|res_{i}|>"


def query_token(i: int) -> str:
    return f"<|query_{i}|>"


def add_special_tokens(tokenizer, max_resolution: int = 4096,
                       patch_size: int = 16, parallel_num: int = 1):
    """Register resolution + query tokens on an HF tokenizer."""
    assert max_resolution % patch_size == 0
    num_levels = max_resolution // patch_size
    extra = [res_token(i) for i in range(1, num_levels + 1)]
    if parallel_num > 1:
        extra += [query_token(i) for i in range(1, parallel_num)]
    tokenizer.add_special_tokens({"additional_special_tokens": extra})
    return tokenizer


def image_start_ids(tokenizer, latent_h: int, latent_w: int,
                    parallel_num: int) -> list[int]:
    """[vision_start, res_h, res_w, query_1..query_{p-1}] token ids."""
    ids = [
        tokenizer.convert_tokens_to_ids(VISION_START),
        tokenizer.convert_tokens_to_ids(res_token(latent_h)),
        tokenizer.convert_tokens_to_ids(res_token(latent_w)),
    ]
    for i in range(1, parallel_num):
        ids.append(tokenizer.convert_tokens_to_ids(query_token(i)))
    return ids


def chatml_prompts(prompt: str) -> tuple[str, str]:
    """(cond, uncond) prompt strings."""
    cond = f"{IM_START}user\n{prompt}{IM_END}\n{IM_START}assistant\n"
    uncond = f"{IM_START}assistant\n"
    return cond, uncond


IMAGE_SIZE_LIST = [
    # --- 1024px area ---
    [2048, 512], [1920, 512], [1536, 640], [1280, 768], [1152, 896],
    [1024, 1024], [896, 1152], [768, 1280], [640, 1536], [512, 1920],
    [512, 2048],
    # --- 512px area ---
    [1024, 256], [896, 256], [640, 384], [512, 512], [384, 640],
    [256, 896], [256, 1024],
]
