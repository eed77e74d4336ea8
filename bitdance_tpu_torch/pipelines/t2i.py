"""Text-to-image generation (port of bitdance_tpu/pipelines/t2i.py).

Same conventions as the JAX pipeline:
  - cond rows come first, then uncond, in one batch;
  - prompts are left-padded to a bucket, positions count from each row's
    first real token (pads clamped to 0), and kv_start masks the pads;
  - prefill pass 1 is causal over [prompt, vision_start, res_h]; pass 2
    covers [res_w, queries] as one bidirectional block;
  - the 2D pos-embed is added both to the head's conditioning and to the
    next step's embeddings; every AR step runs the LLM forward, the last one
    included; each image is decoded on its own.
PyTorch runs eagerly, so there are no compiled programs, layout pins or
environment switches; the KV cache is updated in place.

Over a device mesh (``T2IPipeline(mesh=...)``, :func:`shard_bundle_`) every
rank runs the same request from the same seed: the LLM tensor-parallel over
"tp" (and FSDP over the other axes), the head's sampler head-major and
tensor-parallel with tp > 1 (a plain-MLP head, which has no sampler stack,
whole on every rank), the VQ decoder whole; the ranks' token grids are
checked equal once per request.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from bitdance_tpu_torch.data.special_tokens import chatml_prompts, image_start_ids
from bitdance_tpu_torch.models import qwen3 as q3
from bitdance_tpu_torch.models.connector import MLPConnector
from bitdance_tpu_torch.models.diff_head import DiffHead
from bitdance_tpu_torch.models.tokenizer import VQModel, tokens_to_latents
from bitdance_tpu_torch.ops.quantize import sign_quantize
from bitdance_tpu_torch.ops.rotary import pos_embed_2d, sincos_1d_table
from bitdance_tpu_torch.utils.precision import full_fp32
from bitdance_tpu_torch.utils.timing import PhaseTimer


@dataclasses.dataclass
class T2IModelBundle:
    """All modules for generation (weights live in the modules)."""

    llm: q3.Qwen3Model
    ae: VQModel
    head: DiffHead
    projector: MLPConnector
    parallel_num: int
    hidden_size: int
    vae_patch_size: int
    pe_max_len: int = 4096
    # the head's sampler weights, stacked once (ops/fused_head.py); the
    # head module's block weights are views into them, not a second copy
    head_stacked: dict | None = None

    @property
    def ps(self) -> int:
        return int(self.parallel_num ** 0.5)

    @property
    def llm_cfg(self) -> q3.Qwen3Config:
        return self.llm.cfg

    @property
    def device(self) -> torch.device:
        return self.llm.model.norm.weight.device

    def stacked_head(self) -> dict | None:
        """None for a head the whole sampler does not take
        (DiffHead.stackable): DiffHead.sample then runs its per-call route."""
        if self.head_stacked is None:
            self.head_stacked = self.head._stack_for_sampler()
        return self.head_stacked


def build_pos_table(bundle: T2IModelBundle) -> torch.Tensor:
    """1D sincos table [pe_max_len // vae_patch_size, hidden // 2]."""
    max_len = bundle.pe_max_len // bundle.vae_patch_size
    return sincos_1d_table(bundle.hidden_size // 2, max_len,
                           device=bundle.device)


@torch.no_grad()
def prefill_t2i(bundle: T2IModelBundle, prompt_ids: torch.Tensor,
                prompt_pad: torch.Tensor, img_start_ids: torch.Tensor, *,
                latent_h: int, latent_w: int, num_images: int,
                kv_int8: bool = False):
    """Both prefill passes; returns (cache, hidden [2n, p, D]). kv_int8: the
    fused int8 ring buffer (qwen3.init_kv_cache(int8=True))."""
    llm = bundle.llm
    p = bundle.parallel_num
    n2 = 2 * num_images
    P = prompt_ids.shape[1]
    cache_max = P + 2 + p + latent_h * latent_w

    prompt_emb = q3.embed_tokens(llm, prompt_ids)                 # [2n, P, D]
    start_emb = q3.embed_tokens(llm, img_start_ids)               # [2+p, D]
    start_emb = start_emb[None].expand(n2, 2 + p, start_emb.shape[-1])
    seq_emb = torch.cat([prompt_emb, start_emb], dim=1)

    idx = torch.arange(P + 2 + p, dtype=torch.int32, device=prompt_ids.device)
    positions = torch.clamp(idx[None] - prompt_pad[:, None], min=0)

    cache = q3.init_kv_cache(llm.cfg, n2, cache_max, dtype=prompt_emb.dtype,
                             device=prompt_emb.device, int8=kv_int8,
                             num_kv_heads=q3.kv_heads(llm))
    pre1 = P + 2
    _, cache = q3.qwen3_forward_cached(
        llm, seq_emb[:, :pre1], positions[:, :pre1], cache, 0, prompt_pad,
        causal_block=True)
    hidden, cache = q3.qwen3_forward_cached(
        llm, seq_emb[:, pre1:], positions[:, pre1:], cache, pre1, prompt_pad,
        causal_block=False)
    return cache, hidden


@torch.no_grad()
def decode_t2i(bundle: T2IModelBundle, cache: dict, hidden: torch.Tensor,
               prompt_pad: torch.Tensor, pos_embed_for_diff: torch.Tensor,
               generator: torch.Generator, *, prompt_len: int, latent_h: int,
               latent_w: int, num_images: int, guidance_scale: float,
               num_sampling_steps: int) -> torch.Tensor:
    """AR decode loop; returns ±1 tokens [n, h*w, z] (fp32)."""
    p = bundle.parallel_num
    num_steps = latent_h * latent_w // p
    pre1 = prompt_len + 2
    pos_diff = pos_embed_for_diff.to(hidden.dtype)
    stacked = bundle.stacked_head()
    all_tokens = []
    for step in range(num_steps):
        pe = pos_diff[step * p:(step + 1) * p]
        pred = bundle.head.sample(hidden + pe[None], generator,
                                  guidance_scale, num_sampling_steps,
                                  cfg_mult=2, stacked=stacked)     # [n, p, z]
        tokens = sign_quantize(pred)
        all_tokens.append(tokens)
        emb = (bundle.projector(tokens) + pe[None]).to(hidden.dtype)
        model_input = torch.cat([emb, emb], dim=0)       # cond/uncond share
        cache_len = pre1 + p + step * p
        pos = (cache_len + torch.arange(p, dtype=torch.int32,
                                        device=hidden.device))[None] \
            - prompt_pad[:, None]
        hidden, cache = q3.qwen3_forward_cached(
            bundle.llm, model_input, pos, cache, cache_len, prompt_pad,
            causal_block=False)
    out = torch.stack(all_tokens, dim=1)                  # [n, steps, p, z]
    return out.reshape(num_images, latent_h * latent_w, out.shape[-1])


def generate_tokens(bundle: T2IModelBundle, prompt_ids: torch.Tensor,
                    prompt_pad: torch.Tensor, img_start_ids: torch.Tensor,
                    pos_embed_for_diff: torch.Tensor,
                    generator: torch.Generator, *, latent_h: int,
                    latent_w: int, num_images: int, guidance_scale: float,
                    num_sampling_steps: int, kv_int8: bool = False) -> torch.Tensor:
    """Prefill + AR decode; returns ±1 tokens [n, h*w, z]."""
    cache, hidden = prefill_t2i(bundle, prompt_ids, prompt_pad, img_start_ids,
                                latent_h=latent_h, latent_w=latent_w,
                                num_images=num_images, kv_int8=kv_int8)
    return decode_t2i(bundle, cache, hidden, prompt_pad, pos_embed_for_diff,
                      generator, prompt_len=prompt_ids.shape[1],
                      latent_h=latent_h, latent_w=latent_w,
                      num_images=num_images, guidance_scale=guidance_scale,
                      num_sampling_steps=num_sampling_steps)


@torch.no_grad()
def decode_image(bundle: T2IModelBundle, tokens: torch.Tensor, latent_h: int,
                 latent_w: int, generator: torch.Generator | None = None) -> torch.Tensor:
    """±1 tokens [n, h*w, z] -> images [n, H, W, 3] in [-1, 1]. A GAN
    decoder draws its noise from ``generator`` (the request's, after its
    AR loop; ranks of a tp mesh draw the same noise from the same seed),
    where the JAX package calls its decoder without a noise rng and fails
    (ROADMAP C15)."""
    latents = tokens_to_latents(tokens, latent_h, latent_w, ps=bundle.ps)
    return bundle.ae.decode(latents, generator=generator)


def shard_bundle_(bundle: T2IModelBundle, mesh):
    """Serve ``bundle`` over ``mesh`` IN PLACE (JAX t2i.py:248-282) and
    return this rank's tp group (parallel/tp.py::TPGroup): the LLM
    tensor-parallel by the Qwen3 rules over "tp"; with more than one
    (replica, fsdp) process, FSDP2 over those axes on top, the root's
    parameters (embedding, final norm) then held gathered and each layer
    gathered as the cached forward reaches it; with tp > 1 the head's
    sampler stack reordered head-major and sharded Megatron-style, while a
    plain-MLP head, which has no stack, stays whole on every rank and
    samples on its per-call route there, as the JAX package replicates it;
    the VQ decoder and the connector whole on every rank. The LLM in bf16
    or fp32 (shard_qwen3_ refuses the quantized trees, which the JAX rules
    do not serve); the head's stack in any of its formats (bf16, int8,
    packed int4)."""
    from bitdance_tpu_torch.parallel.mesh import data_size, shard_model, tp_group
    from bitdance_tpu_torch.parallel.tp import shard_head_stacked, shard_qwen3_

    tp = tp_group(mesh)
    head = bundle.head
    shard_qwen3_(bundle.llm, tp)
    if data_size(mesh) > 1:
        shard_model(bundle.llm, mesh)
        bundle.llm.unshard()
    if tp.size > 1 and head.stackable:
        bundle.head_stacked = shard_head_stacked(
            bundle.stacked_head(), tp, head.ch_latent // head.attn_head_dim)
    return tp


def check_ranks_agree(tokens: torch.Tensor) -> None:
    """Raise unless every rank of the default group holds the same ±1
    grid: an fp64 checksum (exact: integer weights) and its negation
    all-reduced by max in one call."""
    w = torch.arange(1, tokens.numel() + 1, dtype=torch.float64, device=tokens.device)
    c = (tokens.reshape(-1).double() * w).sum()
    both = torch.stack([c, -c])
    dist.all_reduce(both, op=dist.ReduceOp.MAX)
    if both[0] != c or both[1] != -c:
        raise RuntimeError(f"rank {dist.get_rank()}: the ranks' token grids differ")


class T2IPipeline:
    """User-facing pipeline: prompt string -> uint8 images [n, H, W, 3].
    With ``mesh`` (parallel/mesh.py::create_mesh) the bundle is sharded in
    place (:func:`shard_bundle_`) and ``last_tp`` holds each request's
    count of tp all-reduces, by kind too (and their seconds when
    ``tp.timed``). ``kv_int8`` serves over a mesh as well: the fused int8
    ring holds a rank's kv heads, and its scales are per (position, head),
    so a shard by heads quantizes as the whole cache does."""

    PROMPT_BUCKETS = (64, 128, 256, 512)

    def __init__(self, bundle: T2IModelBundle, tokenizer=None,
                 kv_int8: bool = False, mesh=None):
        # the serving path is bf16 (TF32 never applies there); its fp32
        # pieces (the head's c_emb, the plain kernel twins) stay full fp32
        full_fp32()
        self.bundle = bundle
        self.tokenizer = tokenizer
        self.kv_int8 = kv_int8
        self.mesh = mesh
        self.tp = shard_bundle_(bundle, mesh) if mesh is not None else None
        self.last_tp: dict = {}
        self.last_timing: dict = {}
        self.pos_table = build_pos_table(bundle)
        self._geom_cache: dict = {}

    def _geometry(self, latent_h: int, latent_w: int):
        geom = self._geom_cache.get((latent_h, latent_w))
        if geom is None:
            b = self.bundle
            start = torch.tensor(
                image_start_ids(self.tokenizer, latent_h, latent_w,
                                b.parallel_num), dtype=torch.long,
                device=b.device)
            pe = pos_embed_2d(self.pos_table, latent_h, latent_w, b.ps)
            geom = (start, pe)
            self._geom_cache[(latent_h, latent_w)] = geom
        return geom

    @torch.no_grad()
    def generate(self, prompt: str, height: int = 1024, width: int = 1024,
                 num_sampling_steps: int = 50, guidance_scale: float = 7.5,
                 num_images: int = 1, seed: int = 1234,
                 return_tokens: bool = False):
        """Returns uint8 images [n, H, W, 3] (numpy); with return_tokens, the
        tuple (images, ±1 tokens [n, h*w, z])."""
        b = self.bundle
        dev = b.device
        vp = b.vae_patch_size
        latent_h, latent_w = height // vp, width // vp
        cond_text, uncond_text = chatml_prompts(prompt)
        cond_ids = self.tokenizer.encode(cond_text)
        uncond_ids = self.tokenizer.encode(uncond_text)
        start_ids, pe = self._geometry(latent_h, latent_w)

        P = next(pb for pb in self.PROMPT_BUCKETS if pb >= len(cond_ids))
        rows, pads = [], []
        for ids in [cond_ids] * num_images + [uncond_ids] * num_images:
            pad = P - len(ids)
            rows.append([0] * pad + list(ids))
            pads.append(pad)
        rows_t = torch.tensor(rows, dtype=torch.long, device=dev)
        pads_t = torch.tensor(pads, dtype=torch.int32, device=dev)
        gen = torch.Generator(device=dev).manual_seed(seed)
        if self.tp is not None:
            self.tp.reset()

        phase = PhaseTimer(dev)
        with phase("prefill"):
            cache, hidden = prefill_t2i(b, rows_t, pads_t, start_ids,
                                        latent_h=latent_h, latent_w=latent_w,
                                        num_images=num_images,
                                        kv_int8=self.kv_int8)
        with phase("decode"):
            tokens = decode_t2i(b, cache, hidden, pads_t, pe, gen, prompt_len=P,
                                latent_h=latent_h, latent_w=latent_w,
                                num_images=num_images,
                                guidance_scale=float(guidance_scale),
                                num_sampling_steps=num_sampling_steps)
            del cache, hidden
            if self.mesh is not None:
                check_ranks_agree(tokens)
                self.last_tp = {"all_reduces": self.tp.all_reduces,
                                "all_reduce_s": self.tp.seconds,
                                "kinds": {k: tuple(v) for k, v in self.tp.kinds.items()}}
        with phase("vae"):
            imgs = []
            for i in range(tokens.shape[0]):
                img = decode_image(b, tokens[i:i + 1], latent_h, latent_w, gen)
                imgs.append(torch.clamp(127.5 * img.float() + 128.0, 0, 255)
                            .to(torch.uint8))
        self.last_timing = phase.totals()
        out = torch.cat(imgs, dim=0).cpu().numpy()
        if return_tokens:
            return out, tokens.float().cpu().numpy()
        return out
