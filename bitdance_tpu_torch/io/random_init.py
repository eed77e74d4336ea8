"""Random-init models made directly on a device (no weights ship with the
repository): the T2I bundle (counterpart of the bundle building in
benchmarks/bench_t2i.py), the ImageNet training state with its tokenizer
encoder, and the ImageNet class-conditional sampler. One deliberate
difference from the reference: EVERY head weight is drawn non-zero, including the adaLN and final-layer projections that the
reference initialises to zero. With zero adaLN all gates are 0 and the
head's blocks add nothing; with a zero final layer the loss has no gradient
into the backbone, so a training step's backward would run on zeros.
"""

from __future__ import annotations

import copy
import dataclasses

import torch

from bitdance_tpu_torch.models.connector import MLPConnector
from bitdance_tpu_torch.models.diff_head import DiffHead
from bitdance_tpu_torch.models.imagenet_ar import (
    ImageNetAR,
    ImageNetARConfig,
    ImageNetSampler,
    head_kwargs,
    init_ar_params,
    quantize_ar_params,
)
from bitdance_tpu_torch.models.qwen3 import Qwen3Config, init_qwen3, quantize_qwen3_
from bitdance_tpu_torch.models.tokenizer import VQModel, init_vq
from bitdance_tpu_torch.pipelines.t2i import T2IModelBundle
from bitdance_tpu_torch.train.imagenet_train import (
    ImageNetTrainConfig,
    ImageNetTrainModel,
    make_train_state,
)
from bitdance_tpu_torch.train.optim import TrainState

# train/configs/bitdance_14b_64x.yaml: Qwen3-14B + 5120-wide 6-block head,
# 64 tokens per AR step, 16x VQ decoder with 32-bit latents
BITDANCE_14B_64X = dict(
    parallel_num=64,
    vae_patch_size=16,
    head=dict(ch_target=32, ch_cond=5120, ch_latent=5120, depth_latent=6,
              depth_adanln=2, parallel_num=64, use_swiglu=True, P_mean=-0.8,
              P_std=0.8),
    ddconfig=dict(z_channels=32, in_channels=3, out_ch=3, ch=256,
                  ch_mult=[1, 1, 2, 2, 4], num_res_blocks=4),
)


# scripts/train_imagenet.py: the frozen GFQ tokenizer of the ImageNet models
IMAGENET_TOKENIZER = dict(z_channels=16, in_channels=3, out_ch=3, ch=256,
                          ch_mult=[1, 1, 2, 2, 4], num_res_blocks=4)


def draw_head_(head: torch.nn.Module, generator: torch.Generator | None,
               gain: float = 0.5, std: float = 0.02) -> torch.nn.Module:
    """Draw every parameter of a head in place (see :func:`init_head`)."""
    with torch.no_grad():
        for name, p in head.named_parameters():
            if p.ndim == 2:
                p.normal_(0.0, gain * p.shape[1] ** -0.5, generator=generator)
            else:
                p.normal_(0.0, std, generator=generator)
                if ".norm" in name and name.endswith("weight"):
                    p.add_(1.0)
    return head


def init_head(head_kwargs: dict, device, dtype: torch.dtype,
              generator: torch.Generator | None, gain: float = 0.5,
              std: float = 0.02) -> DiffHead:
    """DiffHead with every parameter drawn: Linear weights
    N(0, gain / sqrt(fan_in)), biases N(0, std), LayerNorm gains
    1 + N(0, std) and biases N(0, std).

    Fan-in scaling keeps the net well conditioned at any width: with a fixed
    N(0, 0.02) at width 5120 the adaLN mods reach std ~1.6 and the window
    attention's scores std ~13, so softmax is nearly an argmax and one bf16
    rounding flips its winner. There the plain sampler in bf16 and in fp32
    (same weight values) already differ by O(max |x|) after one step, as
    much as the kernel differs from either (PERF.md, Open questions)."""
    with torch.device("meta"):
        head = DiffHead(**head_kwargs, dtype=dtype)
    head = draw_head_(head.to_empty(device=device), generator, gain, std)
    return head.eval().requires_grad_(False)


def init_projector(z: int, hidden: int, device, dtype: torch.dtype,
                   generator: torch.Generator | None) -> MLPConnector:
    """lecun-normal weights, zero biases (the flax Dense defaults)."""
    with torch.device("meta"):
        proj = MLPConnector(z, hidden, dtype=dtype)
    proj = proj.to_empty(device=device)
    with torch.no_grad():
        for lin in (proj.fc1, proj.fc2):
            lin.weight.normal_(0.0, lin.weight.shape[1] ** -0.5,
                               generator=generator)
            lin.bias.zero_()
    return proj.eval().requires_grad_(False)


def _module_tree_copy(m: torch.nn.Module) -> torch.nn.Module:
    """New module objects down the tree, sharing every parameter and buffer:
    replacing a submodule of the copy leaves the original untouched."""
    c = copy.copy(m)
    c._modules = {k: None if v is None else _module_tree_copy(v)
                  for k, v in m._modules.items()}
    return c


QUANT_CONFIGS = {
    # the JAX package's serving configurations (README "FULL-DEPTH 40/40
    # layers, packed int4 W4A8 LLM+head, int8 KV"; pipelines/loader.py
    # quantize_llm / quantize_head): LLM projections, head block matrices
    "int4": ("int4", "int4"),
    "int8": ("int8", True),
}


def quantize_bundle_(bundle: T2IModelBundle, mode: str, *,
                     keep_source: bool = False) -> T2IModelBundle:
    """Quantize a bundle for serving: ``"int4"`` (packed int4 W4A8 Qwen3
    projections, int8 embedding table, W4A8 head sampler; an lm_head is
    dropped) or ``"int8"`` (W8A8 projections and lm_head, bf16 embedding,
    W8A8 head sampler). The LLM is
    converted layer by layer on its device and the head's sampler stack is
    rebuilt once, quantized. The VQ decoder and projector stay as they are.

    In place by default (each bf16 projection is freed as its quantized
    replacement lands). keep_source=True leaves ``bundle`` as it was and
    returns a new bundle that shares its unquantized parts (module objects
    are copied, tensors are not), so both formats can come from the same
    weights."""
    llm_mode, head_quant = QUANT_CONFIGS[mode]
    llm, head = bundle.llm, bundle.head
    if keep_source:
        llm, head = _module_tree_copy(llm), copy.copy(head)
    quantize_qwen3_(llm, llm_mode)
    head.sample_weight_quant = head_quant
    stacked = head._stack_for_sampler()
    if keep_source:
        return dataclasses.replace(bundle, llm=llm, head=head, head_stacked=stacked)
    bundle.head_stacked = stacked
    return bundle


def build_random_bundle(device, *, llm_cfg: Qwen3Config | None = None,
                        geometry: dict | None = None,
                        dtype: torch.dtype = torch.bfloat16,
                        seed: int = 0, lm_head: bool = False,
                        encoder: bool = False) -> T2IModelBundle:
    """Full bundle on ``device`` from ``seed``; defaults to BitDance-14B-64x
    at full width and depth. The head's sampler stack is built before the
    LLM so the stacking transient never sits beside the 26 GB layer stack.
    lm_head (an untied text head, N(0, 0.02) as the JAX init draws it) and
    encoder (the VQ encoder, flax-default init) add what interleaved
    generation needs; both are drawn after every other module, so the T2I
    weights of a seed do not depend on them.
    :func:`quantize_bundle_` converts it for quantized serving."""
    geo = BITDANCE_14B_64X if geometry is None else geometry
    cfg = llm_cfg or Qwen3Config.qwen3_14b()
    gen = torch.Generator(device=device).manual_seed(seed)
    hidden = cfg.hidden_size
    z = geo["head"]["ch_target"]
    head = init_head(geo["head"], device, dtype, gen)
    stacked = head._stack_for_sampler()
    proj = init_projector(z, hidden, device, dtype, gen)
    ae = init_vq(geo["ddconfig"], device, dtype, gen)
    llm = init_qwen3(cfg, device, dtype, gen)
    if lm_head and not cfg.tie_word_embeddings:
        llm.lm_head = torch.nn.Linear(hidden, cfg.vocab_size, bias=False,
                                      device=device, dtype=dtype).requires_grad_(False)
        llm.lm_head.weight.normal_(0.0, 0.02, generator=gen)
    if encoder:
        ae.encoder = init_vq(geo["ddconfig"], device, dtype, gen, encoder=True,
                             decoder=False).encoder
    return T2IModelBundle(
        llm=llm, ae=ae, head=head, projector=proj,
        parallel_num=geo["parallel_num"], hidden_size=hidden,
        vae_patch_size=geo["vae_patch_size"], head_stacked=stacked)


def build_random_train_state(cfg: ImageNetARConfig, tcfg: ImageNetTrainConfig,
                             device, seed: int = 0,
                             std: float = 0.02) -> TrainState:
    """fp32 ImageNet training state on ``device`` from ``seed``, every weight
    non-zero: backbone matrices and tables N(0, std) (the JAX init), biases
    N(0, std), norm gains 1 + N(0, std); the head as :func:`init_head`
    draws it (fan-in scaled, adaLN and final layer included)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    with torch.device("meta"):
        model = ImageNetTrainModel(cfg)
    model = model.to_empty(device=device)
    with torch.no_grad():
        for name, p in model.ar.named_parameters():
            p.normal_(0.0, std, generator=gen)
            if p.ndim == 1 and "norm" in name:
                p.add_(1.0)
    draw_head_(model.head, gen, std=std)
    return make_train_state(model, tcfg)


def build_random_mllm_train_state(cfg, tcfg, device="cuda",
                                  dtype: torch.dtype = torch.bfloat16, seed: int = 0,
                                  std: float = 0.02) -> TrainState:
    """A packed-training state (models/mllm.py MLLM, its AdamW, EMA only if
    tcfg asks) built on the meta device and drawn on ``device`` from
    ``seed``, in ``dtype`` (parameters, gradients and moments all in it):
    the LLM as the JAX package initialises it (matrices, embedding and
    lm_head N(0, std), norm gains 1), the projector lecun-normal with zero
    biases, the head as :func:`init_head` draws it (fan-in scaled, every
    weight non-zero)."""
    from bitdance_tpu_torch.models.mllm import MLLM
    from bitdance_tpu_torch.train.mllm_train import make_state, make_tx

    gen = torch.Generator(device=device).manual_seed(seed)
    with torch.device("meta"):
        model = MLLM(cfg, dtype=dtype)
    model = model.to_empty(device=device)
    with torch.no_grad():
        for name, p in model.llm.named_parameters():
            if name.endswith("norm.weight"):
                p.fill_(1.0)
            else:
                p.normal_(0.0, std, generator=gen)
        for lin in (model.projector.fc1, model.projector.fc2):
            lin.weight.normal_(0.0, lin.weight.shape[1] ** -0.5, generator=gen)
            lin.bias.zero_()
    draw_head_(model.head, gen, std=std)
    return make_state(model, make_tx(model, tcfg), tcfg)


def build_random_tokenizer_encoder(device, dtype: torch.dtype = torch.float32,
                                   seed: int = 1,
                                   ddconfig: dict | None = None) -> VQModel:
    """The ImageNet tokenizer's encoder (flax-default init) on ``device``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return init_vq(ddconfig or IMAGENET_TOKENIZER, device, dtype, gen,
                   encoder=True, decoder=False)


def build_random_imagenet_sampler(cfg: ImageNetARConfig, device,
                                  dtype: torch.dtype = torch.bfloat16,
                                  seed: int = 0) -> ImageNetSampler:
    """An ImageNet class-conditional sampler on ``device`` from ``seed``:
    the backbone as the JAX package initialises it (matrices and tables
    N(0, 0.02), biases 0, norm gains 1), the head as :func:`init_head`
    draws it (fan-in scaled, every weight non-zero, adaLN and final layer
    included) with its sampler stack, and the frozen z-16 VQ decoder."""
    gen = torch.Generator(device=device).manual_seed(seed)
    with torch.device("meta"):
        model = ImageNetAR(cfg, dtype=dtype)
    model = init_ar_params(model.to_empty(device=device), gen)
    model = model.eval().requires_grad_(False)
    head = init_head(head_kwargs(cfg), device, dtype, gen)
    stacked = head._stack_for_sampler()
    ae = init_vq(IMAGENET_TOKENIZER, device, dtype, gen)
    return ImageNetSampler(cfg=cfg, model=model, head=head,
                           head_stacked=stacked, ae=ae)


def quantize_imagenet_sampler(sampler: ImageNetSampler, *, backbone: bool,
                              head_quant: bool | str) -> ImageNetSampler:
    """A quantized sampler from an ImageNet sampler's own weights, the
    source left as it was: backbone=True makes the layer products W8A8
    (:func:`quantize_ar_params`, layer by layer on a module-tree copy, so
    the bf16 model keeps its modules), and head_quant (True: int8, "int4":
    packed int4) rebuilds the head's sampler stack quantized once (the head
    module keeps its own weights for the per-call route). Unquantized parts
    and the VQ decoder are shared, not copied, so the bf16 and quantized
    forms come from the same seeded weights."""
    model, head = sampler.model, copy.copy(sampler.head)
    if backbone:
        model = quantize_ar_params(_module_tree_copy(model))
    head.sample_weight_quant = head_quant
    return dataclasses.replace(sampler, model=model, head=head,
                               head_stacked=head._stack_for_sampler())
