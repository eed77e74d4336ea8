"""Packed multimodal training model (port of bitdance_tpu/models/mllm.py:
MLLMConfig, PackedBatch, make_head, _assemble_seq, _losses_from_hidden,
mllm_forward_train, mllm_forward_train_batched).

Packed sequences interleave text tokens and projected ±1 image latents under
the (block_id, doc_id) attention mask; the losses are the text CE (chunked
over the vocabulary above 32,768 entries) and the diffusion head's per-token
flow-matching loss, each a weighted mean per sequence, then an unweighted
mean over sequences. The model is one module holding ``llm`` (Qwen3 with
``lm_head``), ``projector`` and ``head``; it computes in its parameters'
dtype, as the JAX step does.

Random draws (the bit-flip perturbation of the latents to be generated, the
head's t and noise) come from one torch.Generator per sequence and stream,
seeded from (seed, global sequence index): splitting a fixed set of
sequences between the batch axis and gradient-accumulation microbatches
gives the same draws, as the JAX function's fold_in by global index does.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch
from torch import nn

from bitdance_tpu_torch.models.connector import MLPConnector
from bitdance_tpu_torch.models.diff_head import DiffHead
from bitdance_tpu_torch.models.qwen3 import Qwen3Config, Qwen3Model, embed_tokens, qwen3_forward
from bitdance_tpu_torch.ops.attention import live_tile_bound
from bitdance_tpu_torch.ops.chunked_ce import chunked_cross_entropy
from bitdance_tpu_torch.ops.quantize import flip_bits_uniform_prob

JAX_KV_TILE = 512       # the JAX sparse kernel's key tile (attn_max_live_kv's unit)


@dataclasses.dataclass(frozen=True)
class MLLMConfig:
    llm: Qwen3Config
    z_channels: int = 32
    vit_patch_size: int = 16
    parallel_num: int = 64
    head_model_dim: int = 5120
    head_num_blocks: int = 6
    head_num_adaln: int = 2
    head_use_swiglu: bool = True
    grad_checkpointing: bool = True
    remat_policy: str = "full"
    P_mean: float = -0.8
    P_std: float = 0.8
    time_shift: float = 1.0
    diff_batch_mul: int = 1
    vision_perturb: float = 0.1
    pe_max_len: int = 2048
    # the JAX config's bound on live 512-key tiles per q tile (None = dense),
    # ceil(max_doc_tokens / 512) + 1 from the packer's per-sample cap
    attn_max_live_kv: int | None = None

    @staticmethod
    def bitdance_14b(vocab_size: int = 152064, parallel_num: int = 64) -> "MLLMConfig":
        """train/configs/bitdance_14b_64x.yaml:1-35 (16x differs only in
        parallel_num)."""
        return MLLMConfig(llm=Qwen3Config.qwen3_14b(vocab_size),
                          parallel_num=parallel_num)

    def attn_live_tiles(self) -> int | None:
        """The same data guarantee in this port's 64-key tiles: a bound of n
        JAX tiles promises documents of at most (n - 1) * 512 tokens, and
        :func:`live_tile_bound` turns that into 64-key tiles for a q tile
        that holds the end of one document and the start of the next (or of
        the packer's padding, one block no longer than a document)."""
        if self.attn_max_live_kv is None:
            return None
        return live_tile_bound((self.attn_max_live_kv - 1) * JAX_KV_TILE)


class PackedBatch(NamedTuple):
    """Fixed-shape packed batch (mllm.py:67-85); every field may carry
    leading batch axes."""

    packed_text_ids: torch.Tensor        # [T_text] int (padded)
    packed_text_indexes: torch.Tensor    # [T_text] positions into the sequence
    vision_latents: torch.Tensor         # [T_vis, z] ±1 (padded)
    vit_token_indexes: torch.Tensor      # [T_vis] positions into the sequence
    position_ids: torch.Tensor           # [L] rope positions
    block_ids: torch.Tensor              # [L] visibility blocks
    doc_ids: torch.Tensor                # [L] (-1 for padding)
    ce_text_indexes: torch.Tensor        # [N_txt] sequence positions
    ce_text_labels: torch.Tensor         # [N_txt]
    ce_text_weights: torch.Tensor        # [N_txt] fp32 (0 for padding)
    vision_loss_indexes: torch.Tensor    # [N_vis] sequence positions
    vision_label_indexes: torch.Tensor   # [N_vis] rows into vision_latents
    vision_loss_weights: torch.Tensor    # [N_vis] fp32 (0 for padding)
    vision_pos_embed: torch.Tensor       # [N_vis, hidden] head pos-embed
    vision_input_pos_embed: torch.Tensor  # [T_vis, hidden] input pos-embed

    @staticmethod
    def from_numpy(raw: dict, device) -> "PackedBatch":
        """The packer's dict of numpy arrays -> tensors on ``device``
        (indexes and ids int64, floats fp32)."""
        def conv(a):
            t = torch.from_numpy(a)
            return t.long() if not t.is_floating_point() else t.float()
        return PackedBatch(**{k: conv(raw[k]).to(device) for k in PackedBatch._fields})

    def row(self, i) -> "PackedBatch":
        return PackedBatch(*(t[i] for t in self))


def make_head(cfg: MLLMConfig, device=None, dtype: torch.dtype = torch.float32) -> DiffHead:
    head = DiffHead(
        ch_target=cfg.z_channels, ch_cond=cfg.llm.hidden_size,
        ch_latent=cfg.head_model_dim, depth_latent=cfg.head_num_blocks,
        depth_adanln=cfg.head_num_adaln, parallel_num=cfg.parallel_num,
        use_swiglu=cfg.head_use_swiglu, attention=True, P_mean=cfg.P_mean,
        P_std=cfg.P_std, time_shift=cfg.time_shift, per_token_loss=True,
        device=device, dtype=dtype)
    head.net.grad_checkpointing = cfg.grad_checkpointing
    return head


class MLLM(nn.Module):
    """``llm`` (Qwen3 with lm_head unless tied), ``projector`` (MLPConnector
    z -> hidden) and ``head`` (the TransEncoder diffusion head)."""

    def __init__(self, cfg: MLLMConfig, device=None, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg = cfg
        self.llm = Qwen3Model(cfg.llm, device=device, dtype=dtype, lm_head=True)
        self.projector = MLPConnector(cfg.z_channels, cfg.llm.hidden_size,
                                      device=device, dtype=dtype)
        self.head = make_head(cfg, device=device, dtype=dtype)

    def forward(self, batch: "PackedBatch", seed: int, train: bool = True,
                seq_offset: int = 0, implementation: str = "auto") -> dict:
        """:func:`mllm_forward_train_batched` on this model, called as a
        module so that FSDP's hooks gather the root's weights."""
        return mllm_forward_train_batched(self, self.cfg, batch, seed, train,
                                          seq_offset, implementation)


def seq_generator(seed: int, index: int, stream: int, device) -> torch.Generator:
    """The generator of one sequence's draws: stream 0 the perturbation,
    stream 1 the head."""
    return torch.Generator(device=device).manual_seed(
        (int(seed) * 1_000_003 + int(index) * 2 + stream) % (2 ** 63))


def _assemble_seq(model: MLLM, cfg: MLLMConfig, batch: PackedBatch,
                  generator: torch.Generator | None, train: bool) -> torch.Tensor:
    """Scatter text embeddings and projected vision latents into one packed
    sequence [L, D] (mllm.py:121-146). In training, latents of tokens to be
    generated (loss weight > 0) are bit-flipped with rate vision_perturb."""
    L = batch.position_ids.shape[0]
    text_emb = embed_tokens(model.llm, batch.packed_text_ids)
    seq = text_emb.new_zeros((L, text_emb.shape[-1]))
    seq = seq.index_put((batch.packed_text_indexes,), text_emb)
    latents = batch.vision_latents
    if train and cfg.vision_perturb > 0:
        flipped = flip_bits_uniform_prob(latents, cfg.vision_perturb, generator)
        gen_mask = torch.zeros(latents.shape[0], dtype=torch.bool, device=latents.device)
        gen_mask = gen_mask.index_put((batch.vision_label_indexes,),
                                      batch.vision_loss_weights > 0)
        latents = torch.where(gen_mask[:, None], flipped, latents)
    vis_emb = model.projector(latents)
    vis_emb = vis_emb + batch.vision_input_pos_embed.to(vis_emb.dtype)
    return seq.index_put((batch.vit_token_indexes,), vis_emb.to(seq.dtype))


def _losses_from_hidden(model: MLLM, cfg: MLLMConfig, batch: PackedBatch,
                        hidden: torch.Tensor,
                        generator: torch.Generator | None) -> dict:
    """Per-sequence weighted-mean losses from the LLM's hidden [L, D]
    (mllm.py:149-192)."""
    txt_hidden = hidden[batch.ce_text_indexes]
    lm_w = model.llm.output_weight()                       # [D, V]
    labels = batch.ce_text_labels
    if cfg.llm.vocab_size > 32768:
        nll = chunked_cross_entropy(txt_hidden, lm_w, labels)
    else:
        logp = torch.log_softmax((txt_hidden @ lm_w).float(), dim=-1)
        nll = -torch.gather(logp, 1, labels.long()[:, None])[:, 0]
    w = batch.ce_text_weights
    ce_loss_text = (nll * w).sum() / w.sum().clamp_min(1e-6)

    p, d, z = cfg.parallel_num, cfg.llm.hidden_size, cfg.z_channels
    vis_hidden = hidden[batch.vision_loss_indexes] + batch.vision_pos_embed.to(hidden.dtype)
    cond = vis_hidden.reshape(-1, p, d)
    target = batch.vision_latents[batch.vision_label_indexes].reshape(-1, p, z)
    vw = batch.vision_loss_weights.reshape(-1, p)
    if cfg.diff_batch_mul > 1:
        cond = cond.repeat(cfg.diff_batch_mul, 1, 1)
        target = target.repeat(cfg.diff_batch_mul, 1, 1)
        vw = vw.repeat(cfg.diff_batch_mul, 1)
    per_token = model.head(target, cond, generator)        # [N/p, p]
    ce_loss_vision = (per_token * vw).sum() / vw.sum().clamp_min(1e-6)
    return {"ce_loss_text": ce_loss_text, "ce_loss_vision": ce_loss_vision}


def mllm_forward_train_batched(model: MLLM, cfg: MLLMConfig, batch: PackedBatch,
                               seed: int, train: bool = True, seq_offset: int = 0,
                               implementation: str = "auto") -> dict:
    """Losses {"ce_loss_text", "ce_loss_vision"} (0-d, fp32) of packed
    sequences whose fields carry a leading batch axis [B, ...]: the LLM runs
    once on [B, L, D]; assembly and losses run per sequence; per-sequence
    weighted means, then the mean over sequences (mllm.py:220-261). Sequence
    b draws from generators seeded by (seed, seq_offset + b)."""
    b = batch.position_ids.shape[0]
    dev = batch.position_ids.device
    seqs = [_assemble_seq(model, cfg, batch.row(i),
                          seq_generator(seed, seq_offset + i, 0, dev), train)
            for i in range(b)]
    hidden = qwen3_forward(
        model.llm, torch.stack(seqs), batch.position_ids, batch.block_ids,
        batch.doc_ids, attn_impl=implementation,
        remat=train and cfg.grad_checkpointing, max_live_kv=cfg.attn_live_tiles(),
        remat_policy=cfg.remat_policy)
    outs = [_losses_from_hidden(model, cfg, batch.row(i), hidden[i],
                                seq_generator(seed, seq_offset + i, 1, dev))
            for i in range(b)]
    return {k: torch.stack([o[k] for o in outs]).mean() for k in outs[0]}


def mllm_forward_train(model: MLLM, cfg: MLLMConfig, batch: PackedBatch, seed: int,
                       train: bool = True, implementation: str = "auto") -> dict:
    """:func:`mllm_forward_train_batched` on ONE packed sequence (fields
    unbatched)."""
    one = PackedBatch(*(t[None] for t in batch))
    return mllm_forward_train_batched(model, cfg, one, seed, train,
                                      implementation=implementation)
