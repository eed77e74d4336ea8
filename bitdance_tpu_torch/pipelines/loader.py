"""Load a released BitDance model directory into a T2IPipeline (port of
bitdance_tpu/pipelines/loader.py).

Directory layout (the reference t2i_pipeline.py:48-74): HF Qwen3 shards
(an untied lm_head among them, read for interleaved generation only) and
tokenizer files, ae_config.json (its ``gan_decoder`` flag read as the JAX
loader reads it) + ae.safetensors, vision_head_config.json +
vision_head.safetensors, projector.safetensors (io/release.py reads them).
Modules are built on the meta device and filled on ``device`` straight from
the memory-mapped files, one tensor at a time, so no second copy of the
weights exists on the host.
"""

from __future__ import annotations

import json
import os
import re

import torch

from bitdance_tpu_torch.config import head_config_from_json
from bitdance_tpu_torch.io.release import load_hf_qwen3_dir, load_safetensors, load_state_
from bitdance_tpu_torch.models.connector import MLPConnector
from bitdance_tpu_torch.models.diff_head import DiffHead
from bitdance_tpu_torch.models.qwen3 import Qwen3Config, Qwen3Model, quantized_structure_
from bitdance_tpu_torch.models.tokenizer import VQModel
from bitdance_tpu_torch.pipelines.t2i import T2IModelBundle, T2IPipeline
from bitdance_tpu_torch.utils.precision import full_fp32


def _filled(make, state, device, ignore=()):
    """A module built by ``make()`` on the meta device, then allocated on
    ``device`` and filled from ``state``."""
    with torch.device("meta"):
        m = make()
    return load_state_(m.to_empty(device=device), state, ignore).eval() \
        .requires_grad_(False)


def load_tokenizer(model_path: str):
    """The directory's HF tokenizer (its added special tokens ride in the
    tokenizer files)."""
    try:
        from transformers import AutoTokenizer
    except ImportError as e:
        raise RuntimeError(
            "load_t2i_pipeline: the `transformers` package is not installed; "
            "pass tokenizer= (any object with encode() and "
            "convert_tokens_to_ids())") from e
    return AutoTokenizer.from_pretrained(model_path)


def load_t2i_pipeline(model_path: str, dtype: torch.dtype = torch.bfloat16,
                      quantize_llm: bool = False,
                      quantize_head: bool | str = False,
                      quantize_embed: bool = False, device="cuda",
                      tokenizer=None, interleaved: bool = False) -> T2IPipeline:
    """A T2IPipeline on ``device`` (the card unless the caller says
    otherwise) from a release directory, with weights in ``dtype``.

    quantize_llm: W8A8 int8 Qwen3 projections (QLinear), and an untied
    lm_head's too when it is loaded. quantize_head: True (int8) or "int4"
    (packed W4A8), the sampler stack's block matrices
    (DiffHead.sample_weight_quant). quantize_embed: the int8 embedding table
    (QEmbedding). tokenizer=None loads the directory's tokenizer with
    ``transformers``. interleaved=True also loads what
    pipelines/interleaved.py needs and T2I does not: the untied ``lm_head``
    (its text head; a directory without one raises) and the VQ encoder
    (user images). The LLM modes here keep a text head (bf16 or int8); the
    int4 LLM of ``io/random_init.quantize_bundle_`` drops it, as the JAX
    package's int4 quantizer does, and the generator then refuses text."""
    full_fp32()
    device = torch.device(device)
    state, hf = load_hf_qwen3_dir(model_path)
    llm_cfg = Qwen3Config(
        vocab_size=state["model.embed_tokens.weight"].shape[0],
        hidden_size=hf["hidden_size"],
        intermediate_size=hf["intermediate_size"],
        num_hidden_layers=hf["num_hidden_layers"],
        num_attention_heads=hf["num_attention_heads"],
        num_key_value_heads=hf["num_key_value_heads"],
        head_dim=hf.get("head_dim", hf["hidden_size"] // hf["num_attention_heads"]),
        rms_norm_eps=hf.get("rms_norm_eps", 1e-6),
        rope_theta=hf.get("rope_theta", 1e6),
        tie_word_embeddings=hf.get("tie_word_embeddings", False))
    # the T2I path has no text output: an untied lm_head is not loaded
    text_head = interleaved and not llm_cfg.tie_word_embeddings
    if text_head and "lm_head.weight" not in state:
        raise ValueError(f"load_t2i_pipeline(interleaved=True): {model_path} has "
                         "untied embeddings and no lm_head.weight, so no text head")
    llm = _filled(lambda: Qwen3Model(llm_cfg, dtype=dtype, lm_head=text_head), state,
                  device, ignore=() if text_head else (re.compile(r"^lm_head\."),))
    del state
    if quantize_llm or quantize_embed:
        quantized_structure_(llm, "int8" if quantize_llm else None,
                             embed_int8=quantize_embed, fill=True)
    if tokenizer is None:
        tokenizer = load_tokenizer(model_path)

    with open(os.path.join(model_path, "ae_config.json")) as f:
        ae_config = json.load(f)
    dd = ae_config["ddconfig"]
    # the release holds the encoder too; T2I serving needs the decoder only.
    # A GAN decoder draws its noise from each request's generator
    gan = bool(ae_config.get("gan_decoder", False))
    ae = _filled(lambda: VQModel(dd, dtype=dtype, encoder=interleaved, gan_decoder=gan),
                 load_safetensors(os.path.join(model_path, "ae.safetensors")),
                 device, ignore=() if interleaved else (re.compile(r"^encoder\."),))

    with open(os.path.join(model_path, "vision_head_config.json")) as f:
        head_config = json.load(f)
    kw = head_config_from_json(head_config)
    kw.pop("diff_batch_mul")
    # weights first: the sampler stack then takes the block weights over
    # (the head's block parameters become views into it)
    head = _filled(lambda: DiffHead(**kw, dtype=dtype,
                                    sample_weight_quant=quantize_head),
                   load_safetensors(os.path.join(model_path,
                                                 "vision_head.safetensors")),
                   device)
    stacked = head._stack_for_sampler()

    pstate = load_safetensors(os.path.join(model_path, "projector.safetensors"))
    z = pstate["fc1.weight"].shape[1]
    projector = _filled(lambda: MLPConnector(z, llm_cfg.hidden_size, dtype=dtype),
                        pstate, device)
    bundle = T2IModelBundle(
        llm=llm, ae=ae, head=head, projector=projector,
        parallel_num=head_config["parallel_num"],
        hidden_size=llm_cfg.hidden_size,
        vae_patch_size=2 ** (len(dd["ch_mult"]) - 1), pe_max_len=4096,
        head_stacked=stacked)
    return T2IPipeline(bundle, tokenizer=tokenizer)
