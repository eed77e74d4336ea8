"""Release-format export (port of bitdance_tpu/train/checkpoints.py:137-223:
export_release_dir, export_hf_qwen3).

The port's modules keep the release's state-dict names, so an export writes
each module's state dict as it is: ae / vision_head / projector safetensors
and their JSON configs, and the LLM as an HF Qwen3 checkpoint
(model.safetensors in fp32 plus config.json), the layout
pipelines/loader.py (and the JAX package's loader) reads. Tensors are
written one at a time from the device, so no host copy of a whole model
exists. The orbax training checkpoints (CheckpointManager) are not ported
(ROADMAP A10).
"""

from __future__ import annotations

import json
import os

import torch
from torch import nn

from bitdance_tpu_torch.io.safetensors import save_file


def export_release_dir(out_dir: str, ae: nn.Module | None = None,
                       head: nn.Module | None = None,
                       projector: nn.Module | None = None,
                       configs: dict[str, dict] | None = None,
                       dtype: torch.dtype | None = torch.float32) -> None:
    """Write the release layout: ae.safetensors, vision_head.safetensors,
    projector.safetensors and ``configs`` as ``<name>.json``. Floating
    tensors are written as ``dtype`` (fp32, as the JAX package exports; None
    keeps each module's dtype, e.g. bf16 as the released shards are)."""
    os.makedirs(out_dir, exist_ok=True)
    for name, module in (("ae", ae), ("vision_head", head),
                         ("projector", projector)):
        if module is not None:
            save_file(module.state_dict(),
                      os.path.join(out_dir, f"{name}.safetensors"), dtype=dtype)
    for name, cfg in (configs or {}).items():
        with open(os.path.join(out_dir, f"{name}.json"), "w") as f:
            json.dump(cfg, f, indent=2)


def export_hf_qwen3(llm: nn.Module, out_dir: str) -> None:
    """Write a Qwen3Model (unquantized) as an HF Qwen3 checkpoint:
    model.safetensors in fp32 and config.json."""
    os.makedirs(out_dir, exist_ok=True)
    save_file(llm.state_dict(), os.path.join(out_dir, "model.safetensors"),
              dtype=torch.float32)
    c = llm.cfg
    cfg_json = {
        "architectures": ["Qwen3ForCausalLM"],
        "model_type": "qwen3",
        "vocab_size": c.vocab_size,
        "hidden_size": c.hidden_size,
        "intermediate_size": c.intermediate_size,
        "num_hidden_layers": c.num_hidden_layers,
        "num_attention_heads": c.num_attention_heads,
        "num_key_value_heads": c.num_key_value_heads,
        "head_dim": c.head_dim,
        "rms_norm_eps": c.rms_norm_eps,
        "rope_theta": c.rope_theta,
        "tie_word_embeddings": c.tie_word_embeddings,
    }
    with open(os.path.join(out_dir, "config.json"), "w") as f:
        json.dump(cfg_json, f, indent=2)
