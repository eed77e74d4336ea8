"""Interleaved multimodal generation over a sequence plan (port of
bitdance_tpu/pipelines/interleaved.py, the reference's
MLLModel.forward_inference, modeling/mllm.py:503-897).

A plan is a list of text / image items, each given by the user (prefilled)
or generated by the model. Generated text samples token by token through the
text head (:func:`~bitdance_tpu_torch.models.qwen3.lm_logits`, then
temperature, top-k and top-p, ops/token_sampling.py); a generated image runs
the next-patch diffusion decode of the T2I path.

The JAX package's conventions, kept here:
  - two independent batch-1 KV streams, cond and uncond (the reference's
    past_key_values / past_key_values_un), advanced one after the other;
    the uncond stream sees user text without its first
    ``<|im_start|>user ... <|im_end|>`` block (:func:`remove_first_user_block`);
    user images and image scaffolding go to both; cfg_scale <= 1 runs the
    cond stream alone;
  - a user image is encoded (``VQModel.encode``: the encode tail kernel on
    the card), ordered ps-raster, projected, given the 2D pos-embed and
    framed by ``[vision_start, res_h, res_w]`` and ``<|vision_end|>``;
  - a generated text span samples from the cond stream's newest hidden
    state, stops at ``<|im_end|>`` (not cached) and advances BOTH streams
    with each token;
  - a generated image span prefills ``[vision_start, res_h]`` causally and
    ``[res_w, query_1 .. query_{p-1}]`` as one bidirectional window, then
    each AR step samples p tokens with the head on the streams' last p
    hidden states plus the pos-embed (cond row first), sign-quantizes them,
    and feeds their projection plus the pos-embed back as the next window;
    every window, the last included, is cached once;
  - images come back as float32 numpy [H, W, 3] in the decoder's [-1, 1].
The JAX docstring's two deliberate deviations from the reference (the
uncond stream advances through generated text; the sampled image is cached
exactly once) hold here too, and :func:`plan_parity_matchable` says which
plans the reference's own outputs could match.

Where the port differs from the JAX generator:
  - the caches are allocated in the LLM's dtype on its device (JAX: fp32).
    With bf16 weights k and v are bf16 before they are stored, so the cache
    holds the same values at half the bytes, and the decode-attention
    kernel (bf16 only) reads it in place;
  - :meth:`InterleavedGenerator.generate` raises before a span would write
    past ``max_seq_len`` (JAX's dynamic_update_slice clamps the start and
    overwrites the newest slots, ROADMAP C12); :func:`plan_slots` sizes a
    cache for a plan;
  - a generated text span on a model without a text head (untied, no
    lm_head: an int4 LLM drops it) raises in :func:`lm_logits` (JAX reads
    the embedding as the head, ROADMAP C11);
  - randomness: one ``torch.Generator(device).manual_seed(seed)`` serves
    every draw, in plan order: each text token takes one ``torch.rand`` of
    the vocabulary (Gumbel-max), each image AR step the head's x0 and then
    its per-step noise (``draw_sampler_noise``), and a GAN decoder its
    noise after the image's last AR step. JAX's key stream is not
    reproduced (its GAN decode has none, ROADMAP C15).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from bitdance_tpu_torch.data.special_tokens import IM_END, VISION_END, image_start_ids
from bitdance_tpu_torch.models import qwen3 as q3
from bitdance_tpu_torch.models.tokenizer import latents_to_tokens
from bitdance_tpu_torch.ops.quantize import sign_quantize
from bitdance_tpu_torch.ops.rotary import pos_embed_2d
from bitdance_tpu_torch.ops.token_sampling import sample_tokens
from bitdance_tpu_torch.pipelines.t2i import T2IModelBundle, build_pos_table, decode_image
from bitdance_tpu_torch.utils.precision import full_fp32
from bitdance_tpu_torch.utils.timing import PhaseTimer


@dataclasses.dataclass
class PlanItem:
    type: str              # 'text' | 'image'
    source: str            # 'user' | 'model'
    text: str | None = None           # user text
    image: np.ndarray | None = None   # user image [H, W, 3] in [-1, 1]
    image_size: tuple = (256, 256)    # generated image pixel size (H, W)


def remove_first_user_block(text: str) -> str:
    """Drop the first ``<|im_start|>user\\n ... <|im_end|>\\n`` block
    (reference utils.py:206-216): the uncond stream's view of user text."""
    start_marker = "<|im_start|>user\n"
    end_marker = "<|im_end|>\n"
    i = text.find(start_marker)
    if i == -1:
        return text
    j = text.find(end_marker, i + len(start_marker))
    if j == -1:
        return text
    return text[:i] + text[j + len(end_marker):]


def plan_parity_matchable(plan: list[PlanItem]) -> bool:
    """True iff a plan's outputs could be matched against the reference's:
    False for a generated text span followed later by a generated image
    (the reference's uncond cache goes stale during text) and for any
    generated span after a generated image (the reference double-feeds the
    image's scaffold and never caches its last window)."""
    gen_text_seen = False
    gen_image_seen = False
    for item in plan:
        if item.source != "model":
            continue
        if gen_image_seen:
            return False
        if item.type == "text":
            gen_text_seen = True
        elif item.type == "image":
            if gen_text_seen:
                return False
            gen_image_seen = True
    return True


def plan_slots(plan: list[PlanItem], tokenizer, bundle: T2IModelBundle,
               max_length_text: int) -> int:
    """The most cache slots ``plan`` can take on its cond stream (the longer
    of the two): user text its token count, a user image 3 + h * w + 1
    latent-grid slots, a generated text span ``max_length_text``, a
    generated image 2 + p + h * w. A ``max_seq_len`` of at least this never
    overflows."""
    vp, p = bundle.vae_patch_size, bundle.parallel_num
    n = 0
    for item in plan:
        if item.type == "text":
            n += (len(tokenizer.encode(item.text)) if item.source == "user"
                  else max_length_text)
        else:
            hh, ww = (np.shape(item.image)[:2] if item.source == "user"
                      else item.image_size)
            h, w = hh // vp, ww // vp
            n += 3 + h * w + 1 if item.source == "user" else 2 + p + (h * w // p) * p
    return n


@dataclasses.dataclass
class _Stream:
    """One KV stream (the reference's past_key_values[_un])."""

    cache: dict
    length: int = 0


class InterleavedGenerator:
    """Any-to-any generation over a sequence plan, on the bundle's device.

    ``last_spans`` lists (stream, item index, kind, start, end) cache slot
    ranges of the latest :meth:`generate`; ``last_image_tokens`` its
    generated images' ±1 token grids [h * w, z] (ps-raster); ``last_timing``
    the seconds of each span, keyed "<item index>:<kind>" (CUDA events on the
    card, ``utils/timing.py``)."""

    def __init__(self, bundle: T2IModelBundle, tokenizer, max_seq_len: int = 8192):
        full_fp32()
        self.b = bundle
        self.tokenizer = tokenizer
        self.max_seq_len = max_seq_len
        self.pos_table = build_pos_table(bundle)
        self.last_spans: list = []
        self.last_image_tokens: list = []
        self.last_timing: dict = {}

    @torch.no_grad()
    def generate(self, plan: list[PlanItem], *, cfg_scale: float = 7.5,
                 sample_steps: int = 50, max_length_text: int = 128,
                 temperature: float = 1.0, top_k: int = 1200,
                 top_p: float = 0.95, seed: int = 0) -> dict:
        """Returns {'generated_text': [...], 'generated_image': [...]} (the
        reference's generated_sequence dict, mllm.py:544-547)."""
        b, tok = self.b, self.tokenizer
        llm = b.llm
        dev = b.device
        gen = torch.Generator(device=dev).manual_seed(seed)
        self._streams = [
            _Stream(q3.init_kv_cache(llm.cfg, 1, self.max_seq_len,
                                     dtype=llm.model.norm.weight.dtype, device=dev))
            for _ in range(2 if cfg_scale > 1.0 else 1)]
        self._kv_start = torch.zeros((1,), dtype=torch.int32, device=dev)
        streams = self._streams
        out = {"generated_text": [], "generated_image": []}
        self.last_spans, self.last_image_tokens = [], []
        phase = PhaseTimer(dev)
        last_hidden = None  # [1, D] cond-stream hidden of the newest token

        for item_idx, item in enumerate(plan):
            before = [st.length for st in streams]
            span = (item_idx, f"{item.source}_{item.type}")
            with phase("{}:{}".format(*span)):
                if item.source == "user" and item.type == "text":
                    texts = [item.text, remove_first_user_block(item.text)]
                    ids = [tok.encode(t) for t in texts[:len(streams)]]
                    self._check_room(span, [len(i) for i in ids])
                    last_hidden = [self._prefill(st, self._embed(i))
                                   for st, i in zip(streams, ids)][0][:, -1]
                elif item.source == "user":
                    last_hidden = self._user_image(item, span)
                elif item.type == "text":
                    if last_hidden is None:
                        raise ValueError("InterleavedGenerator: a generated text span "
                                         "needs preceding context (mllm.py:590)")
                    end_id = tok.convert_tokens_to_ids(IM_END)
                    tokens = []
                    for _ in range(max_length_text):
                        logits = q3.lm_logits(llm, last_hidden)
                        t = int(sample_tokens(gen, logits, temperature, top_k, top_p)[0])
                        if t == end_id:
                            break
                        tokens.append(t)
                        self._check_room(span, [1, 1])
                        # the token advances BOTH streams (the JAX deviation)
                        last_hidden = [self._prefill(st, self._embed([t]))
                                       for st in streams][0][:, -1]
                    out["generated_text"].append(tok.decode(tokens))
                else:
                    img, last_hidden = self._model_image(item, span, gen, cfg_scale,
                                                         sample_steps)
                    out["generated_image"].append(img)
            for name, st, b0 in zip(("cond", "uncond"), streams, before):
                self.last_spans.append((name, item_idx, span[1], b0, st.length))
        self.last_timing = phase.totals()
        del self._streams
        return out

    def _embed(self, ids) -> torch.Tensor:
        ids = torch.as_tensor(list(ids), dtype=torch.long, device=self.b.device)
        return q3.embed_tokens(self.b.llm, ids)[None]             # [1, S, D]

    def _check_room(self, span, sizes) -> None:
        """Raise before a span writes past max_seq_len on any stream."""
        for name, st, n in zip(("cond", "uncond"), self._streams, sizes):
            if st.length + n > self.max_seq_len:
                raise ValueError(
                    f"InterleavedGenerator: plan item {span[0]} ({span[1]}) needs {n} "
                    f"cache slots from slot {st.length} of the {name} stream, past "
                    f"max_seq_len {self.max_seq_len} (plan_slots sizes a cache)")

    def _prefill(self, st: _Stream, embeds: torch.Tensor, causal: bool = True):
        """Advance one stream by embeds [1, S, D]; returns its hidden."""
        s = embeds.shape[1]
        pos = (st.length + torch.arange(s, dtype=torch.int32, device=embeds.device))[None]
        hidden, st.cache = q3.qwen3_forward_cached(
            self.b.llm, embeds, pos, st.cache, st.length, self._kv_start,
            causal_block=causal)
        st.length += s
        return hidden

    def _user_image(self, item: PlanItem, span) -> torch.Tensor:
        """Prefill ``[vision_start, res_h, res_w] + projected latents +
        vision_end`` into every stream; returns the cond stream's last
        hidden [1, D]."""
        b, tok = self.b, self.tokenizer
        vp = b.vae_patch_size
        hh, ww = np.shape(item.image)[:2]
        self._check_room(span, [3 + (hh // vp) * (ww // vp) + 1] * 2)
        img = torch.as_tensor(np.asarray(item.image, np.float32), device=b.device)[None]
        quant = b.ae.encode(img)                                  # [1, h, w, z]
        h, w = quant.shape[1:3]
        # ps-raster order for understanding images too (mllm.py:899-907)
        emb = b.projector(latents_to_tokens(quant, ps=b.ps))
        emb = emb + pos_embed_2d(self.pos_table, h, w, b.ps)[None]
        # start ids from the image's own latent grid (the reference reads
        # the global image size there, the same value in its demos)
        start = self._embed(image_start_ids(tok, h, w, 1)[:3])
        end = self._embed([tok.convert_tokens_to_ids(VISION_END)])
        block = torch.cat([start, emb.to(start.dtype), end], dim=1)
        return [self._prefill(st, block) for st in self._streams][0][:, -1]

    def _model_image(self, item: PlanItem, span, gen: torch.Generator,
                     cfg_scale: float, sample_steps: int):
        """The next-patch diffusion decode of one image; returns (float32
        numpy [H, W, 3], the cond stream's last hidden [1, D])."""
        b, tok = self.b, self.tokenizer
        streams = self._streams
        p, vp = b.parallel_num, b.vae_patch_size
        lat_h, lat_w = item.image_size[0] // vp, item.image_size[1] // vp
        num_steps = lat_h * lat_w // p
        self._check_room(span, [2 + p + num_steps * p] * 2)
        start_ids = image_start_ids(tok, lat_h, lat_w, p)
        pe = pos_embed_2d(self.pos_table, lat_h, lat_w, b.ps)
        # causal [vision_start, res_h]; bidirectional [res_w, queries]
        hiddens = []
        for st in streams:
            self._prefill(st, self._embed(start_ids[:2]), causal=True)
            hiddens.append(self._prefill(st, self._embed(start_ids[2:]), causal=False))
        stacked = b.stacked_head()          # stacked once, not per AR step
        all_tokens = []
        for step in range(num_steps):
            pe_step = pe[step * p:(step + 1) * p]
            # conditioning = hidden + pos embed, cond row first
            h_fused = torch.cat(hiddens, dim=0)[:, -p:] + pe_step[None]
            pred = b.head.sample(h_fused, gen, float(cfg_scale), sample_steps,
                                 cfg_mult=len(streams), stacked=stacked)
            toks = sign_quantize(pred)                             # [1, p, z]
            all_tokens.append(toks[0])
            # the pos embed also goes into the next step's input embeds
            emb = (b.projector(toks) + pe_step[None]).to(hiddens[0].dtype)
            hiddens = [self._prefill(st, emb, causal=False) for st in streams]
        grid = torch.cat(all_tokens, dim=0)
        self.last_image_tokens.append(grid)
        img = decode_image(b, grid[None], lat_h, lat_w, gen)
        return img[0].float().cpu().numpy(), hiddens[0][:, -1]
