"""Load the JAX package's parameters (as numpy trees) into the port's modules.

The reverse of bitdance_tpu/io/torch_import.py's ``convert_qwen3_state``,
``convert_diffhead_state``, ``convert_projector_state``, ``convert_ae_state``
and ``convert_imagenet_ar_state``:
  - the stacked Qwen3 and ImageNet AR dicts (layer tensors [L, in, out])
    become per-layer torch Linear weights [out, in]; a quantized Qwen3 tree
    (QTensor / Q4Tensor leaves, int8 q [L, in, out] or packed [L, in/2, out]
    with s [L, 1, out]) becomes the port's QLinear / Q4Linear buffers
    (q [out, in] or [out, in/2], s [out]) by a byte transpose that keeps
    the nibble pairing, and an int8 embedding table its QEmbedding; so do
    the QTensor layer products of a quantized ImageNet AR tree;
  - flax trees (DiffHead, MLPConnector, SwiGLUConnector, the alt heads,
    VQModel and UniVQModel encoder and decoder) map module paths back to
    the reference's dotted names; Dense kernels [in, out] become [out, in]
    and conv kernels HWIO become OIHW;
  - a whole ImageNet training state (params and EMA, each {"ar", "head"})
    loads into the port's TrainState;
  - an ImageNet sampling tree (backbone, head, VQ decoder) becomes the
    port's ImageNetSampler;
  - a packed-training tree ``init_mllm_params`` ({"llm": stacked Qwen3
    with lm_head, "projector", "head"}) becomes the port's MLLM, and a
    whole MLLM TrainState (params, the AdamW moments and count of the optax
    state, EMA if any, step) loads into the port's TrainState.
Leaves may be numpy arrays or anything ``np.asarray`` accepts.
"""

from __future__ import annotations

import re
from typing import Mapping

import numpy as np
import torch
from torch import nn

# stacked-dict name -> (HF layer key, stored transposed)
_QWEN_LAYER_KEYS = {
    "q_proj": ("self_attn.q_proj.weight", True),
    "k_proj": ("self_attn.k_proj.weight", True),
    "v_proj": ("self_attn.v_proj.weight", True),
    "o_proj": ("self_attn.o_proj.weight", True),
    "q_norm": ("self_attn.q_norm.weight", False),
    "k_norm": ("self_attn.k_norm.weight", False),
    "input_layernorm": ("input_layernorm.weight", False),
    "post_attention_layernorm": ("post_attention_layernorm.weight", False),
    "gate_proj": ("mlp.gate_proj.weight", True),
    "up_proj": ("mlp.up_proj.weight", True),
    "down_proj": ("mlp.down_proj.weight", True),
}

# flax module-name segment -> reference dotted path
_SEGMENTS = [
    (re.compile(r"^up_(\d+)_block_(\d+)$"), r"up.\1.block.\2"),
    (re.compile(r"^up_(\d+)_upsample$"), r"up.\1.upsample"),
    (re.compile(r"^down_(\d+)_block_(\d+)$"), r"down.\1.block.\2"),
    (re.compile(r"^down_(\d+)_downsample$"), r"down.\1.downsample"),
    (re.compile(r"^mid_block_(\d+)$"), r"mid_block.\1"),
    (re.compile(r"^adaptive_(\d+)$"), r"adaptive.\1"),
    (re.compile(r"^block_(\d+)$"), r"res_blocks.\1"),
    (re.compile(r"^ada_ln_(\d+)$"), r"ada_ln_blocks.\1"),
    (re.compile(r"^mlp_(\d+)$"), r"mlp.\1"),
]


def _np(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32)


def _quant_kind(leaf) -> str | None:
    """"int8" for a QTensor leaf, "int4" for a Q4Tensor, None otherwise (by
    the NamedTuple's class name: the port does not import the JAX package)."""
    return {"QTensor": "int8", "Q4Tensor": "int4"}.get(type(leaf).__name__)


def qwen3_quant_modes(params: Mapping) -> tuple[str | None, bool]:
    """(format of the layer projections: None, "int8" or "int4"; whether
    the embedding table is int8) of a JAX Qwen3 tree."""
    return (_quant_kind(params["layers"]["q_proj"]),
            _quant_kind(params["embed_tokens"]) is not None)


def qwen3_state_from_jax(params: Mapping) -> dict[str, np.ndarray]:
    """Stacked JAX Qwen3 params -> HF-named state dict (numpy), ``lm_head``
    ([D, V] -> ``lm_head.weight`` [V, D]) included when the tree has one.
    Quantized leaves give ``<name>.q`` (int8) and ``<name>.s`` (f32) entries
    instead of ``<name>.weight``."""
    layers = params["layers"]
    emb = params["embed_tokens"]
    if _quant_kind(emb):
        sd = {"model.embed_tokens.q": np.asarray(emb.q, np.int8),
              "model.embed_tokens.s": _np(emb.s).reshape(-1)}
    else:
        sd = {"model.embed_tokens.weight": _np(emb)}
    sd["model.norm.weight"] = _np(params["final_norm"])
    head = params.get("lm_head")
    if _quant_kind(head):
        sd["lm_head.q"] = np.ascontiguousarray(np.asarray(head.q, np.int8).T)
        sd["lm_head.s"] = _np(head.s).reshape(-1)
    elif head is not None:
        sd["lm_head.weight"] = np.ascontiguousarray(_np(head).T)
    for name, (key, transposed) in _QWEN_LAYER_KEYS.items():
        leaf = layers[name]
        if _quant_kind(leaf):
            q, sc = np.asarray(leaf.q, np.int8), _np(leaf.s)
            base = key[:-len(".weight")]
            for i in range(q.shape[0]):
                sd[f"model.layers.{i}.{base}.q"] = np.ascontiguousarray(q[i].T)
                sd[f"model.layers.{i}.{base}.s"] = sc[i].reshape(-1)
            continue
        stack = _np(leaf)
        for i in range(stack.shape[0]):
            sd[f"model.layers.{i}.{key}"] = stack[i].T if transposed else stack[i]
    return sd


def qwen3_from_jax(cfg, params: Mapping, device=None,
                   dtype: torch.dtype = torch.float32):
    """A JAX Qwen3 tree (bf16/f32 or quantized) -> the port's Qwen3Model on
    ``device``, with the quantized modules its leaves call for and an
    ``lm_head`` when the tree has one (a QLinear when its leaf is a
    QTensor)."""
    from bitdance_tpu_torch.models.qwen3 import Qwen3Model, QLinear, quantized_structure_

    model = Qwen3Model(cfg, device=device, dtype=dtype)
    mode, embed_int8 = qwen3_quant_modes(params)
    if mode is not None or embed_int8:
        quantized_structure_(model, mode, embed_int8)
    if "lm_head" in params:
        model.lm_head = (QLinear(cfg.hidden_size, cfg.vocab_size, device=device)
                         if _quant_kind(params["lm_head"]) else
                         nn.Linear(cfg.hidden_size, cfg.vocab_size, bias=False,
                                   device=device, dtype=dtype))
    return load_into(model, qwen3_state_from_jax(params)).eval()


# stacked ImageNet AR layer key -> (reference layer key, stored transposed)
_IMAGENET_LAYER_KEYS = {
    "wqkv": ("attention.wqkv.weight", True),
    "wo": ("attention.wo.weight", True),
    "attention_norm": ("attention_norm.weight", False),
    "ffn_norm": ("ffn_norm.weight", False),
    "ffn_w1": ("feed_forward.w1.weight", True),
    "ffn_w2": ("feed_forward.w2.weight", True),
}


def imagenet_ar_state_from_jax(params: Mapping) -> dict[str, np.ndarray]:
    """Stacked JAX ImageNet AR params -> reference state dict (numpy). The
    QTensor leaves of a quantize_ar_params tree (q [L, in, out] int8, s [L,
    1, out]) give ``<name>.q`` [out, in] and ``<name>.s`` [out] entries, the
    port's QLinear buffers."""
    layers = params["layers"]
    n = np.asarray(layers["ffn_norm"]).shape[0]
    p = params["proj_in"]
    sd = {"cls_embedding.weight": _np(params["cls_embedding"]),
          "proj_in.w1.weight": _np(p["w1"]["kernel"]).T,
          "proj_in.w1.bias": _np(p["w1"]["bias"]),
          "proj_in.w2.weight": _np(p["w2"]["kernel"]).T,
          "proj_in.w2.bias": _np(p["w2"]["bias"]),
          "emb_norm.weight": _np(params["emb_norm"]),
          "norm.weight": _np(params["norm"]),
          "pos_for_diff.weight": _np(params["pos_for_diff"])}
    if "query_token" in params:
        sd["query_token"] = _np(params["query_token"])
    for name, (key, transposed) in _IMAGENET_LAYER_KEYS.items():
        leaf = layers[name]
        if _quant_kind(leaf) == "int8":
            q, sc = np.asarray(leaf.q, np.int8), _np(leaf.s)
            base = key[:-len(".weight")]
            for i in range(n):
                sd[f"layers.{i}.{base}.q"] = q[i].T
                sd[f"layers.{i}.{base}.s"] = sc[i].reshape(-1)
            continue
        stack = _np(leaf)
        for i in range(n):
            sd[f"layers.{i}.{key}"] = stack[i].T if transposed else stack[i]
    return {k: np.ascontiguousarray(v) for k, v in sd.items()}


def imagenet_train_state_from_jax(params: Mapping) -> dict[str, np.ndarray]:
    """{"ar": stacked AR params, "head": flax head params} (a JAX TrainState's
    ``params`` or ``ema_params``) -> state dict of the port's
    ImageNetTrainModel ("ar.*", "head.*")."""
    sd = {f"ar.{k}": v for k, v in imagenet_ar_state_from_jax(params["ar"]).items()}
    sd.update({f"head.{k}": v
               for k, v in flax_state_from_jax(params["head"]).items()})
    return sd


def load_imagenet_train_state(state, jax_state) -> None:
    """Copy a JAX ``TrainState``'s params and EMA (numpy-convertible leaves)
    into the port's ``train.optim.TrainState`` in place; the step count
    follows. Optimizer moments start afresh."""
    load_into(state.model, imagenet_train_state_from_jax(jax_state.params))
    ema = imagenet_train_state_from_jax(jax_state.ema_params)
    with torch.no_grad():
        for k, t in state.ema.items():
            t.copy_(torch.from_numpy(np.array(ema[k], copy=True)).to(t.dtype))
    state.step = int(np.asarray(jax_state.step))
    state.tx.count = state.step


def _segment(name: str, parent: str | None = None) -> str:
    """The reference's dotted path of one flax module name. Under a
    UniWeTok ``mid_attn`` stack the blocks keep their flax names
    (``block_{i}``, which convert_ae_state reads as they are); elsewhere
    ``block_{i}`` is a DiffHead block (``res_blocks.{i}``)."""
    if parent == "mid_attn":
        return name
    for pat, repl in _SEGMENTS:
        if pat.match(name):
            return pat.sub(repl, name)
    return name


def flax_state_from_jax(tree: Mapping) -> dict[str, np.ndarray]:
    """flax param tree (with or without the top 'params' key) -> reference
    torch state dict (numpy)."""
    if "params" in tree:
        tree = tree["params"]
    out: dict[str, np.ndarray] = {}

    def walk(node, path, parent=None):
        for k, v in node.items():
            if isinstance(v, Mapping):
                walk(v, path + [_segment(k, parent)], k)
                continue
            a = _np(v)
            if k == "kernel":
                k = "weight"
                a = a.transpose(3, 2, 0, 1) if a.ndim == 4 else a.T
            elif k == "embedding":                  # nn.Embed's table
                k = "weight"
            out[".".join(path + [k])] = np.ascontiguousarray(a)

    walk(tree, [])
    return out


def load_into(module: nn.Module, state: Mapping[str, np.ndarray]) -> nn.Module:
    """Copy a numpy state dict into ``module`` (its dtype and device). Keys
    the module does not have (e.g. the encoder of a VQModel) are ignored;
    every key the module has must be present."""
    own = module.state_dict()
    missing = sorted(set(own) - set(state))
    if missing:
        raise KeyError(f"missing weights: {missing[:8]}")
    with torch.no_grad():
        for k, t in own.items():
            src = torch.from_numpy(np.array(state[k], copy=True))
            if tuple(src.shape) != tuple(t.shape):
                raise ValueError(f"{k}: shape {tuple(src.shape)} != {tuple(t.shape)}")
            if (src.dtype == torch.int8) != (t.dtype == torch.int8):
                raise ValueError(f"{k}: int8 and float do not convert "
                                 f"({src.dtype} into {t.dtype})")
            t.copy_(src.to(dtype=t.dtype))
    return module


def imagenet_sampler_from_jax(cfg, params: Mapping, head_params: Mapping,
                              ae_params: Mapping | None, *,
                              ddconfig: dict | None = None, device=None,
                              dtype: torch.dtype = torch.float32,
                              sample_weight_quant: bool | str = False):
    """A JAX ImageNet sampling tree -> the port's ImageNetSampler on
    ``device``: the stacked backbone params (with ``query_token`` for Nx
    models; a quantize_ar_params tree gives W8A8 QLinear layer products),
    the flax head params (the MlpEncoder for 1x, the TransEncoder at head
    dim 64 for Nx) and the flax VQModel params (decoder keys; None leaves
    ``ae`` unset). The head's sampler stack is built here, quantized as
    ``sample_weight_quant`` says (make_head's argument); unquantized, the
    head's block weights become views into it."""
    from bitdance_tpu_torch.io.random_init import IMAGENET_TOKENIZER
    from bitdance_tpu_torch.models.imagenet_ar import (
        ImageNetAR,
        ImageNetSampler,
        make_head,
        quantized_ar_structure_,
    )
    from bitdance_tpu_torch.models.tokenizer import VQModel

    kw = dict(device=device, dtype=dtype)
    model = ImageNetAR(cfg, **kw)
    if _quant_kind(params["layers"]["wqkv"]):          # a quantize_ar_params tree
        quantized_ar_structure_(model)
    model = load_into(model, imagenet_ar_state_from_jax(params))
    head = load_into(make_head(cfg, sample_weight_quant=sample_weight_quant, **kw),
                     flax_state_from_jax(head_params))
    ae = None
    if ae_params is not None:
        ae = load_into(VQModel(ddconfig or IMAGENET_TOKENIZER, **kw),
                       flax_state_from_jax(ae_params)).eval()
    return ImageNetSampler(cfg=cfg, model=model.eval(), head=head.eval(),
                           head_stacked=head._stack_for_sampler(), ae=ae)


def mllm_state_from_jax(params: Mapping) -> dict[str, np.ndarray]:
    """``init_mllm_params`` tree -> state dict of the port's MLLM ("llm.*"
    with "llm.lm_head.weight" [V, D], "projector.*", "head.*")."""
    sd = {f"llm.{k}": v for k, v in qwen3_state_from_jax(params["llm"]).items()}
    for part in ("projector", "head"):
        sd.update({f"{part}.{k}": v for k, v in flax_state_from_jax(params[part]).items()})
    return sd


def mllm_from_jax(cfg, params: Mapping, device="cuda",
                  dtype: torch.dtype = torch.float32):
    """A JAX packed-training tree -> the port's MLLM on ``device``."""
    from bitdance_tpu_torch.models.mllm import MLLM

    return load_into(MLLM(cfg, device=device, dtype=dtype), mllm_state_from_jax(params))


def _adam_state(opt_state):
    """The (count, mu, nu) node of an optax state (the chain of
    clip_by_global_norm and adamw), found by its fields."""
    stack = [opt_state]
    while stack:
        node = stack.pop()
        if hasattr(node, "mu") and hasattr(node, "nu") and hasattr(node, "count"):
            return node
        if hasattr(node, "inner_state"):
            stack.append(node.inner_state)
        elif isinstance(node, (tuple, list)):
            stack.extend(node)
    raise ValueError("no AdamW state (mu, nu, count) in the optax state")


def load_mllm_train_state(state, jax_state) -> None:
    """Copy a JAX MLLM ``TrainState`` into the port's ``TrainState`` in
    place: parameters, the AdamW first and second moments and their count
    (torch AdamW's exp_avg, exp_avg_sq, step), EMA when both keep one, and
    the step count."""
    load_into(state.model, mllm_state_from_jax(jax_state.params))
    adam = _adam_state(jax_state.opt_state)
    mu, nu = mllm_state_from_jax(adam.mu), mllm_state_from_jax(adam.nu)
    count = float(np.asarray(adam.count))
    names = dict(zip(state.tx.params, state.tx.names))
    with torch.no_grad():
        for p in state.tx.params:
            n = names[p]
            # laid out like the parameter, as the fused kernel reads them
            # (a transposed JAX kernel's moments arrive in column order)
            as_p = lambda a: torch.empty_like(p).copy_(  # noqa: E731
                torch.from_numpy(np.array(a, copy=True)))
            state.tx.opt.state[p] = {
                "step": torch.tensor(count, dtype=torch.float32, device=p.device),
                "exp_avg": as_p(mu[n]), "exp_avg_sq": as_p(nu[n])}
        if state.ema is not None and jax_state.ema_params is not None:
            ema = mllm_state_from_jax(jax_state.ema_params)
            for k, t in state.ema.items():
                t.copy_(torch.from_numpy(np.array(ema[k], copy=True)).to(t.dtype))
    state.step = int(np.asarray(jax_state.step))
    state.tx.count = state.step
