"""Readers of a released BitDance model directory (counterparts of the
readers in bitdance_tpu/io/torch_import.py: load_safetensors, remap_ema_state,
load_hf_qwen3_dir).

Directory layout (the reference t2i_pipeline.py:48-74): the HF Qwen3
checkpoint (config.json and model.safetensors, or shards listed in
model.safetensors.index.json) with its tokenizer files, ae_config.json +
ae.safetensors, vision_head_config.json + vision_head.safetensors,
projector.safetensors.

The port's modules keep the release's state-dict names (HF Qwen3 names under
``model.``, the reference DiffHead's ``net.*``, the VQ model's and the
connector's own), so a release file is read into the modules as it is; the
JAX package needs converters for the same files. The one release key no port
module holds is ``net.final_layer.norm_final.*`` (the reference's LayerNorm
without affine weights, which the JAX converter skips too): RELEASE_ONLY
lists it, and :func:`load_state_` refuses any other key a module lacks.
"""

from __future__ import annotations

import json
import os
import re
from typing import Mapping

import torch
from torch import nn

from bitdance_tpu_torch.io.safetensors import load_file

# release keys that map to no parameter of the port's modules
RELEASE_ONLY = (re.compile(r"^net\.final_layer\.norm_final\."),)


def load_safetensors(path: str) -> dict[str, torch.Tensor]:
    """Every tensor of one safetensors file (CPU, memory-mapped)."""
    return load_file(path)


def remap_ema_state(state: Mapping[str, torch.Tensor]) -> dict:
    """Prefer EMA weights: 'model_ema.<key-sans-dots>' replaces '<key>'.

    Matches the UniWeTok checkpoint loader (autoencoder_uni.py:647-670),
    whose EMA entries flatten the dotted key. Non-EMA keys without an EMA
    twin pass through; 'model_ema.*' entries are dropped from the result."""
    out = {}
    for k, v in state.items():
        if k.startswith("model_ema."):
            continue
        out[k] = state.get("model_ema." + k.replace(".", ""), v)
    return out


def load_hf_qwen3_dir(model_dir: str) -> tuple[dict[str, torch.Tensor], dict]:
    """(HF state dict, config.json dict) of an HF Qwen3 directory: the shards
    of model.safetensors.index.json, or model.safetensors."""
    with open(os.path.join(model_dir, "config.json")) as f:
        cfg = json.load(f)
    index_path = os.path.join(model_dir, "model.safetensors.index.json")
    if os.path.exists(index_path):
        with open(index_path) as f:
            index = json.load(f)
        state: dict[str, torch.Tensor] = {}
        for shard in sorted(set(index["weight_map"].values())):
            state.update(load_file(os.path.join(model_dir, shard)))
    else:
        state = load_file(os.path.join(model_dir, "model.safetensors"))
    return state, cfg


def load_state_(module: nn.Module, state: Mapping[str, torch.Tensor],
                ignore: tuple = ()) -> nn.Module:
    """Copy release tensors into ``module`` in place (each into its
    parameter's dtype and device, one tensor at a time). Every key of the
    module must be present; a release key the module lacks raises unless it
    matches RELEASE_ONLY or one of the ``ignore`` patterns (e.g. the
    encoder of a decoder-only VQ model, an untied lm_head)."""
    own = module.state_dict()
    missing = sorted(set(own) - set(state))
    if missing:
        raise KeyError(f"missing weights: {missing[:8]}")
    extra = [k for k in state if k not in own
             and not any(p.search(k) for p in RELEASE_ONLY + tuple(ignore))]
    if extra:
        raise KeyError(f"release keys no module holds: {sorted(extra)[:8]}")
    with torch.no_grad():
        for k, t in own.items():
            src = state[k]
            if tuple(src.shape) != tuple(t.shape):
                raise ValueError(f"{k}: shape {tuple(src.shape)} != {tuple(t.shape)}")
            t.copy_(src)
    return module
