"""Configurations: the YAML and JSON loaders and the config functions of the
14B yaml schema (port of bitdance_tpu/config.py: ConfigDict, load_yaml,
load_json, mllm_config_from_yaml, mllm_train_config_from_yaml,
mesh_shape_from_yaml, head_config_from_json).

The config functions take any dict, a :class:`ConfigDict` from
:func:`load_yaml` included. ``BITDANCE_14B_64X`` mirrors the model, data
and training blocks of train/configs/bitdance_14b_64x.yaml.
"""

from __future__ import annotations

import json
from typing import Any

from bitdance_tpu_torch.models.mllm import MLLMConfig
from bitdance_tpu_torch.models.qwen3 import Qwen3Config
from bitdance_tpu_torch.train.mllm_train import MLLMTrainConfig

class ConfigDict(dict):
    """dict with attribute access, wrapped recursively (the OmegaConf subset
    the reference uses: attribute access and ``.get``)."""

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    @staticmethod
    def wrap(obj):
        if isinstance(obj, dict):
            return ConfigDict({k: ConfigDict.wrap(v) for k, v in obj.items()})
        if isinstance(obj, list):
            return [ConfigDict.wrap(v) for v in obj]
        return obj


def load_yaml(path: str) -> ConfigDict:
    """A YAML file (PyYAML's safe loader, YAML 1.1 scalars) as a ConfigDict."""
    import yaml

    with open(path) as f:
        return ConfigDict.wrap(yaml.safe_load(f))


def load_json(path: str) -> ConfigDict:
    with open(path) as f:
        return ConfigDict.wrap(json.load(f))


# train/configs/bitdance_14b_64x.yaml (model, data and training blocks)
BITDANCE_14B_64X = {
    "model": {
        "vit_patch_size": 16,
        "encoder": {
            "max_bs": 16,
            "vt_forward_func": "group",
            "params": {
                "gan_decoder": False,
                "checkpoint": None,
                "ddconfig": {"double_z": False, "z_channels": 32, "in_channels": 3,
                             "out_ch": 3, "ch": 256, "ch_mult": [1, 1, 2, 2, 4],
                             "num_res_blocks": 4},
            },
        },
        "llm": {"type": "qwen3", "checkpoint": "Qwen/Qwen3-14B"},
        "head": {
            "text_pred": "standard",
            "vision_pred": {
                "type": "diffusion_parallel_x", "model_dim": 5120, "num_blocks": 6,
                "num_adaln": 2, "time_shift": 1.0, "time_schedule": "logit_normal",
                "diff_batch_mul": 1, "parallel_num": 64, "P_mean": -0.8,
                "P_std": 0.8, "use_swiglu": True,
            },
            "vision_perturb": 0.1,
            "pe_max_len": 2048,
        },
    },
    "data": {
        "vit_patch_size": 16,
        "use_native_resolution": True,
        "max_num_tokens_per_sample": 16384,
        "expected_num_tokens": 33280,
        "max_num_tokens": 37376,
        "data_seed": 42,
        "text_cond_dropout_prob": 0.1,
    },
    "training": {
        "results_dir": "results", "global_seed": 4396, "auto_resume": True,
        "log_every": 10, "save_every": 1000, "validate_every": 1000,
        "total_steps": 1_000_000, "grad_accumulation_steps": 1,
        "warmup_steps": 2000, "lr_scheduler": "constant", "lr": 1e-5,
        "min_lr": 1e-7, "beta1": 0.9, "beta2": 0.95, "eps": 1e-15,
        "max_grad_norm": 1.0, "loss_weight_text": 0.01, "loss_weight_vision": 1.0,
        "num_replicate": 1, "num_shard": 8, "sharding_strategy": "HYBRID_SHARD",
    },
}


def mllm_config_from_yaml(cfg: dict, vocab_size: int) -> MLLMConfig:
    """MLLMConfig from a bitdance_14b_*.yaml dict (config.py:51-97). The
    live-kv-tile bound comes from the data block's per-sample token cap,
    ceil(max_num_tokens_per_sample / 512) + 1 tiles of the JAX kernel; an
    explicit model.attn_max_live_kv overrides and 0 means dense."""
    m = cfg["model"]
    vp = m["head"]["vision_pred"]
    max_doc = int(cfg.get("data", {}).get("max_num_tokens_per_sample", 0))
    live_kv = int(m.get("attn_max_live_kv", -(-max_doc // 512) + 1 if max_doc else 0))
    llm_block = m["llm"]
    if llm_block.get("hidden_size"):
        llm = Qwen3Config(
            vocab_size=vocab_size, hidden_size=llm_block["hidden_size"],
            intermediate_size=llm_block["intermediate_size"],
            num_hidden_layers=llm_block["num_hidden_layers"],
            num_attention_heads=llm_block["num_attention_heads"],
            num_key_value_heads=llm_block["num_key_value_heads"],
            head_dim=llm_block["head_dim"])
    else:
        llm = Qwen3Config.qwen3_14b(vocab_size)
    return MLLMConfig(
        llm=llm,
        z_channels=m["encoder"]["params"]["ddconfig"]["z_channels"],
        vit_patch_size=m["vit_patch_size"],
        parallel_num=vp.get("parallel_num", 1),
        head_model_dim=vp.get("model_dim", 1024),
        head_num_blocks=vp.get("num_blocks", 3),
        head_num_adaln=vp.get("num_adaln", 1),
        head_use_swiglu=vp.get("use_swiglu", False),
        P_mean=vp.get("P_mean", 0.0),
        P_std=vp.get("P_std", 1.0),
        time_shift=vp.get("time_shift", 1.0),
        diff_batch_mul=vp.get("diff_batch_mul", 1),
        vision_perturb=m["head"].get("vision_perturb", 0.0),
        pe_max_len=m["head"].get("pe_max_len", 4096),
        attn_max_live_kv=live_kv or None,
    )


def mllm_train_config_from_yaml(cfg: dict) -> MLLMTrainConfig:
    """MLLMTrainConfig from the yaml's training block (config.py:100-118)."""
    t = cfg["training"]
    return MLLMTrainConfig(
        lr=float(t["lr"]),
        min_lr=float(t.get("min_lr", 0.0)),
        betas=(float(t.get("beta1", 0.9)), float(t.get("beta2", 0.95))),
        eps=float(t.get("eps", 1e-8)),
        warmup_steps=int(t.get("warmup_steps", 0)),
        total_steps=int(t.get("total_steps", 1_000_000)),
        decay_start=(int(t.get("warmup_steps", 0))
                     if t.get("lr_scheduler", "constant") == "cosine" else -1),
        max_grad_norm=float(t.get("max_grad_norm", 1.0)),
        loss_weight_text=float(t.get("loss_weight_text", 1.0)),
        loss_weight_vision=float(t.get("loss_weight_vision", 1.0)),
        grad_accum=int(t.get("grad_accum", t.get("gradient_accumulation_steps", 1))),
    )


def mesh_shape_from_yaml(cfg: dict) -> tuple[int, int]:
    """(replica, fsdp) from the training block's FSDP settings (num_replicate,
    num_shard; HYBRID_SHARD in the yaml)."""
    t = cfg["training"]
    return int(t.get("num_replicate", 1)), int(t.get("num_shard", 1))


def head_config_from_json(j: dict) -> dict:
    """vision_head_config.json -> DiffHead kwargs (config.py:127-141, the
    reference t2i_pipeline.py:62-67). ``diff_batch_mul`` repeats the targets
    in training only; the port's DiffHead does not take it."""
    return dict(
        ch_target=j["ch_target"],
        ch_cond=j["ch_cond"],
        ch_latent=j["ch_latent"],
        depth_latent=j["depth_latent"],
        depth_adanln=j["depth_adanln"],
        time_shift=j.get("time_shift", 1.0),
        P_mean=j.get("P_mean", 0.0),
        P_std=j.get("P_std", 1.0),
        parallel_num=j.get("parallel_num", 4),
        diff_batch_mul=j.get("diff_batch_mul", 1),
        use_swiglu=j.get("use_swiglu", False),
    )
