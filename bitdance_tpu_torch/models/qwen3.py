"""Qwen3 decoder backbone (port of bitdance_tpu/models/qwen3.py: the
config, random init, the head-major KV cache, ``embed_tokens``,
``qwen3_forward_cached`` for generation and the uncached ``qwen3_forward``
for training).

Parameter names follow HF ``Qwen3ForCausalLM`` (``model.embed_tokens``,
``model.layers.{i}.self_attn.q_proj`` ..., ``lm_head``), which
``bitdance_tpu/io/torch_import.py::convert_qwen3_state`` reads. T2I
generation never reads ``lm_head``, so a model has one only when built with
``lm_head=True`` (training's text loss, the text logits of interleaved
generation, :func:`lm_logits`). Linear layers are plain
``F.linear`` (the JAX package computes them outside any Pallas kernel); the
windowed decode attention and the training path's (sparse) flash attention
are the port's CUDA kernels on the card.

Quantized serving (:func:`quantize_qwen3_`): the seven projections of every
layer become :class:`QLinear` (int8 W8A8, ``torch._int_mm`` on the card, as
the JAX package leaves it to XLA) or :class:`Q4Linear` (packed int4 W4A8,
the ``csrc/w4a8.cu`` kernel on the card); in int8 mode an ``lm_head``
becomes a QLinear too, in int4 mode it is dropped and the embedding table
becomes :class:`QEmbedding` (int8 rows, dequantized to bf16 on gather).
``init_kv_cache(int8=True)`` gives the fused int8 ring buffer, which the
decode block reads through the fused-KV kernel.

Tensor parallelism (parallel/tp.py::shard_qwen3_) shards a model in place:
each layer's attention then holds its local head counts (``num_heads``,
``num_kv_heads``, which every forward reads) and, with its MLP, the group
its row-parallel product (o_proj, down_proj) all-reduces over (``tp``,
None when whole); a vocabulary-parallel embedding and lm_head carry their
group too. FSDP2 (parallel/mesh.py::shard_model) gathers a unit's weights
in hooks on its ``__call__``; :func:`qwen3_forward_cached` reads a layer's
weights without calling it, so it gathers each sharded layer itself
(:func:`gathered`).
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from bitdance_tpu_torch.ops.attention import attention_xla, masked_attention, sparse_plan
from bitdance_tpu_torch.ops.decode_attention import (
    dequantize_fused_kv,
    quantize_kv_rows,
    windowed_decode_attention,
    windowed_decode_attention_fusedkv,
)
from bitdance_tpu_torch.ops.int4 import Q4Tensor, int4_matmul, quantize_linear_int4
from bitdance_tpu_torch.ops.int8 import QTensor, int8_matmul, quantize_linear
from bitdance_tpu_torch.ops.norms import rms_norm
from bitdance_tpu_torch.ops.rotary import apply_rope_half
from bitdance_tpu_torch.parallel.tp import row_parallel


@dataclasses.dataclass(frozen=True)
class Qwen3Config:
    vocab_size: int = 151936
    hidden_size: int = 5120
    intermediate_size: int = 17408
    num_hidden_layers: int = 40
    num_attention_heads: int = 40
    num_key_value_heads: int = 8
    head_dim: int = 128
    rms_norm_eps: float = 1e-6
    rope_theta: float = 1000000.0
    tie_word_embeddings: bool = False
    max_position_embeddings: int = 40960

    @staticmethod
    def qwen3_14b(vocab_size: int = 151936) -> "Qwen3Config":
        return Qwen3Config(vocab_size=vocab_size)

    @staticmethod
    def tiny(vocab_size: int = 512) -> "Qwen3Config":
        return Qwen3Config(
            vocab_size=vocab_size, hidden_size=128, intermediate_size=256,
            num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
            head_dim=32)


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float, device=None, dtype=None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim, device=device, dtype=dtype))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rms_norm(x, self.weight, self.eps)


class Qwen3Attention(nn.Module):
    def __init__(self, cfg: Qwen3Config, device=None, dtype=None):
        super().__init__()
        kw = dict(bias=False, device=device, dtype=dtype)
        d, hd = cfg.hidden_size, cfg.head_dim
        self.q_proj = nn.Linear(d, cfg.num_attention_heads * hd, **kw)
        self.k_proj = nn.Linear(d, cfg.num_key_value_heads * hd, **kw)
        self.v_proj = nn.Linear(d, cfg.num_key_value_heads * hd, **kw)
        self.o_proj = nn.Linear(cfg.num_attention_heads * hd, d, **kw)
        self.q_norm = RMSNorm(hd, cfg.rms_norm_eps, device, dtype)
        self.k_norm = RMSNorm(hd, cfg.rms_norm_eps, device, dtype)
        # this rank's heads and the tp group of o_proj (parallel/tp.py)
        self.num_heads, self.num_kv_heads = cfg.num_attention_heads, cfg.num_key_value_heads
        self.tp = None


class Qwen3MLP(nn.Module):
    def __init__(self, cfg: Qwen3Config, device=None, dtype=None):
        super().__init__()
        kw = dict(bias=False, device=device, dtype=dtype)
        d, i = cfg.hidden_size, cfg.intermediate_size
        self.gate_proj = nn.Linear(d, i, **kw)
        self.up_proj = nn.Linear(d, i, **kw)
        self.down_proj = nn.Linear(i, d, **kw)
        self.tp = None                     # the tp group of down_proj (parallel/tp.py)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return row_parallel(self.down_proj, F.silu(self.gate_proj(x)) * self.up_proj(x),
                            self.tp)


class Qwen3DecoderLayer(nn.Module):
    def __init__(self, cfg: Qwen3Config, device=None, dtype=None):
        super().__init__()
        self.cfg = cfg
        self.self_attn = Qwen3Attention(cfg, device, dtype)
        self.mlp = Qwen3MLP(cfg, device, dtype)
        self.input_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps,
                                       device, dtype)
        self.post_attention_layernorm = RMSNorm(cfg.hidden_size,
                                                cfg.rms_norm_eps, device, dtype)

    def forward(self, x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                block_ids: torch.Tensor, doc_ids: torch.Tensor,
                attn_impl: str = "auto", plan=None) -> torch.Tensor:
        """One layer of the uncached forward (:func:`qwen3_forward`) over
        x [B, S, D] under the (block, doc) ids; called as a module so that
        FSDP's hooks gather its weights."""
        cfg = self.cfg
        b, s, _ = x.shape
        at = self.self_attn
        hq, hkv, hd = at.num_heads, at.num_kv_heads, cfg.head_dim
        eps = cfg.rms_norm_eps
        h = rms_norm(x, self.input_layernorm.weight, eps)
        q = rms_norm(at.q_proj(h).view(b, s, hq, hd), at.q_norm.weight, eps)
        k = rms_norm(at.k_proj(h).view(b, s, hkv, hd), at.k_norm.weight, eps)
        v = at.v_proj(h).view(b, s, hkv, hd)
        q = apply_rope_half(q, cos, sin)
        k = apply_rope_half(k, cos, sin)
        attn = masked_attention(q, k, v, block_ids, doc_ids, block_ids, doc_ids,
                                implementation=attn_impl, plan=plan)
        x = x + row_parallel(at.o_proj, attn.reshape(b, s, hq * hd), at.tp)
        h = rms_norm(x, self.post_attention_layernorm.weight, eps)
        return x + self.mlp(h)


class Qwen3Body(nn.Module):
    def __init__(self, cfg: Qwen3Config, device=None, dtype=None):
        super().__init__()
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size,
                                         device=device, dtype=dtype)
        self.layers = nn.ModuleList([Qwen3DecoderLayer(cfg, device, dtype)
                                     for _ in range(cfg.num_hidden_layers)])
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, device, dtype)


class Qwen3Model(nn.Module):
    """Holds the backbone under ``model.`` (HF state-dict names) and, with
    ``lm_head`` and untied embeddings, the output projection ``lm_head``."""

    def __init__(self, cfg: Qwen3Config, device=None,
                 dtype: torch.dtype = torch.float32, lm_head: bool = False):
        super().__init__()
        self.cfg = cfg
        self.model = Qwen3Body(cfg, device, dtype)
        if lm_head and not cfg.tie_word_embeddings:
            self.lm_head = nn.Linear(cfg.hidden_size, cfg.vocab_size, bias=False,
                                     device=device, dtype=dtype)

    def output_weight(self) -> torch.Tensor:
        """[D, V] view of the text-loss projection: ``lm_head`` or the tied
        embedding (mllm.py:156-158)."""
        lm = getattr(self, "lm_head", None)
        return (lm if lm is not None else self.model.embed_tokens).weight.t()


def init_qwen3(cfg: Qwen3Config, device, dtype: torch.dtype = torch.bfloat16,
               generator: torch.Generator | None = None,
               std: float = 0.02) -> Qwen3Model:
    """Random init directly on ``device``: linear and embedding weights
    N(0, std), norm gains 1 (the JAX package's init_qwen3_params). The
    module is built on the meta device first, so no host copy exists."""
    with torch.device("meta"):
        m = Qwen3Model(cfg, dtype=dtype)
    m = m.to_empty(device=device)
    with torch.no_grad():
        for name, p in m.named_parameters():
            if name.endswith("norm.weight"):
                p.fill_(1.0)
            else:
                p.normal_(0.0, std, generator=generator)
    return m.eval().requires_grad_(False)


class QLinear(nn.Module):
    """Bias-free int8 W8A8 linear: buffers q int8 [N, K], s f32 [N]."""

    def __init__(self, in_features: int, out_features: int, device=None):
        super().__init__()
        self.register_buffer("q", torch.zeros((out_features, self._stored(in_features)),
                                              dtype=torch.int8, device=device))
        self.register_buffer("s", torch.ones(out_features, dtype=torch.float32,
                                             device=device))

    @staticmethod
    def _stored(in_features: int) -> int:
        return in_features

    @property
    def weight_q(self):
        return QTensor(self.q, self.s)

    @staticmethod
    def _quantize(w: torch.Tensor):
        return quantize_linear(w)

    def fill_(self, w: torch.Tensor) -> None:
        """Quantize the float weight [N, K] into the buffers."""
        qt = self._quantize(w)
        self.q.copy_(qt.q)
        self.s.copy_(qt.s)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return int8_matmul(x, self.weight_q)


class Q4Linear(QLinear):
    """Bias-free packed-int4 W4A8 linear: q int8 [N, K/2], s f32 [N]."""

    @staticmethod
    def _stored(in_features: int) -> int:
        return in_features // 2

    @property
    def weight_q(self):
        return Q4Tensor(self.q, self.s)

    @staticmethod
    def _quantize(w: torch.Tensor):
        return quantize_linear_int4(w)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return int4_matmul(x, self.weight_q)


class QEmbedding(nn.Module):
    """int8 embedding table q [V, D] with per-hidden-column scales s [D]
    (the JAX package's quantize_linear of the [V, D] table)."""

    def __init__(self, num: int, dim: int, device=None):
        super().__init__()
        self.register_buffer("q", torch.zeros((num, dim), dtype=torch.int8,
                                              device=device))
        self.register_buffer("s", torch.ones(dim, dtype=torch.float32, device=device))

    def fill_(self, w: torch.Tensor) -> None:
        """Quantize the float table [V, D], the scale over the vocabulary."""
        qt = quantize_linear(w.t())
        self.q.copy_(qt.q.t())
        self.s.copy_(qt.s)


_PROJ = (("self_attn", ("q_proj", "k_proj", "v_proj", "o_proj")),
         ("mlp", ("gate_proj", "up_proj", "down_proj")))


@torch.no_grad()
def quantized_structure_(model: Qwen3Model, mode: str | None, embed_int8: bool,
                         fill: bool = False) -> Qwen3Model:
    """Replace the seven projections of every layer by ``mode``'s module
    (``"int8"`` QLinear, ``"int4"`` Q4Linear, None keeps them) and, with
    embed_int8, the embedding by a QEmbedding. An ``lm_head`` becomes a
    QLinear in int8 mode (quantize_qwen3_params(quantize_lm_head=True)) and
    is dropped in int4 mode (quantize_qwen3_params_int4), so an untied int4
    model has no text head and :func:`lm_logits` raises. fill=True
    quantizes each replaced weight into its module; otherwise the modules
    are left to be loaded (a JAX QTensor / Q4Tensor tree). Modules are
    replaced on their parents one at a time, so each float weight can be
    freed as its replacement lands."""
    cls = {"int8": QLinear, "int4": Q4Linear, None: None}[mode]

    def replace(parent, name, kind):
        lin = getattr(parent, name)
        new = kind(lin.in_features, lin.out_features, device=lin.weight.device)
        if fill:
            new.fill_(lin.weight.detach())
        setattr(parent, name, new)

    for layer in model.model.layers if cls else ():
        for part, names in _PROJ:
            for name in names:
                replace(getattr(layer, part), name, cls)
    if isinstance(getattr(model, "lm_head", None), nn.Linear):
        if mode == "int8":
            replace(model, "lm_head", QLinear)
        elif mode == "int4":
            del model.lm_head
    emb = model.model.embed_tokens
    if embed_int8 and not isinstance(emb, QEmbedding):
        new = QEmbedding(*emb.weight.shape, device=emb.weight.device)
        if fill:
            new.fill_(emb.weight.detach())
        model.model.embed_tokens = new
    return model


def quantize_qwen3_(model: Qwen3Model, mode: str) -> Qwen3Model:
    """Quantize IN PLACE, layer by layer on the model's device (no second
    bf16 copy): ``"int8"`` -> QLinear projections (quantize_qwen3_params),
    ``"int4"`` -> Q4Linear projections and an int8 QEmbedding
    (quantize_qwen3_params_int4). Norm gains keep their dtype; an lm_head
    goes int8 or is dropped as :func:`quantized_structure_` says. A
    module-tree copy of a model (same parameters, new module objects) can be
    quantized while the original stays bf16."""
    if mode not in ("int8", "int4"):
        raise ValueError(f"quantize_qwen3_: mode {mode!r} is not 'int8' or 'int4'")
    return quantized_structure_(model, mode, embed_int8=mode == "int4", fill=True)


def init_kv_cache(cfg: Qwen3Config, batch: int, max_len: int,
                  dtype: torch.dtype = torch.float32, device=None,
                  int8: bool = False, num_kv_heads: int | None = None) -> dict:
    """HEAD-MAJOR buffers [L, B, Hkv, max_len, D] for k and v (the layout
    the decode-attention kernel reads in place). int8=True: ONE fused int8
    buffer "kv" [L, B, Hkv, max_len, 2D] (k | v lanes) with f32 scales "sc"
    [L, B, Hkv, 2, max_len], a quarter of two bf16 buffers. Hkv is
    ``num_kv_heads`` where given (a tensor-parallel model's local heads,
    :func:`kv_heads`), else the config's."""
    L, hd = cfg.num_hidden_layers, cfg.head_dim
    hkv = cfg.num_key_value_heads if num_kv_heads is None else num_kv_heads
    if int8:
        return {"kv": torch.zeros((L, batch, hkv, max_len, 2 * hd), dtype=torch.int8,
                                  device=device),
                "sc": torch.zeros((L, batch, hkv, 2, max_len), dtype=torch.float32,
                                  device=device)}
    shape = (L, batch, hkv, max_len, hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def kv_heads(model: Qwen3Model) -> int:
    """The kv heads each layer of ``model`` holds (its local ones when
    tensor-parallel): the Hkv of its cache."""
    return model.model.layers[0].self_attn.num_kv_heads


@contextlib.contextmanager
def gathered(module: nn.Module):
    """Hold an FSDP2 unit's parameters gathered (``unshard``) for code that
    reads them without calling the module, then shard them again; a module
    that is not a unit passes through."""
    from torch.distributed.fsdp import FSDPModule

    if not isinstance(module, FSDPModule):
        yield module
        return
    module.unshard()
    try:
        yield module
    finally:
        module.reshard()


def _rope_at(cfg: Qwen3Config, positions: torch.Tensor):
    """cos/sin at given positions: [B, S] int -> [B, S, hd//2] fp32."""
    hd = cfg.head_dim
    inv_freq = 1.0 / (cfg.rope_theta ** (
        torch.arange(0, hd, 2, dtype=torch.float32, device=positions.device) / hd))
    ang = positions.float()[..., None] * inv_freq
    return torch.cos(ang), torch.sin(ang)


def embed_tokens(model: Qwen3Model, token_ids: torch.Tensor) -> torch.Tensor:
    """Rows of the embedding table; a vocabulary-parallel table
    (parallel/tp.py) looks up the ids it holds, zeros elsewhere, and sums
    the ranks' rows in fp32 (one non-zero term: exact)."""
    emb = model.model.embed_tokens
    if isinstance(emb, QEmbedding):
        # gather int8 rows, dequantize just those (bf16, as the JAX package)
        return (emb.q[token_ids].float() * emb.s).to(torch.bfloat16)
    tp = getattr(emb, "tp", None)
    if tp is None:
        return F.embedding(token_ids, emb.weight)
    local = token_ids - emb.vocab_start
    held = (local >= 0) & (local < emb.weight.shape[0])
    rows = F.embedding(torch.where(held, local, 0), emb.weight).float()
    rows = torch.where(held[..., None], rows, 0.0)
    return tp.all_reduce(rows).to(emb.weight.dtype)


def lm_logits(model: Qwen3Model, hidden: torch.Tensor) -> torch.Tensor:
    """Text logits [..., V] in fp32 of final-norm hidden states [..., D]
    (qwen3.py:485-494 of the JAX package): the ``lm_head`` (a QLinear in
    int8 mode), else the tied embedding, a QEmbedding dequantized to
    hidden's dtype first. An untied model without ``lm_head`` raises: the
    JAX function reads the embedding there, which on an untied checkpoint
    (Qwen3-14B) is the wrong matrix (ROADMAP C11)."""
    lm = getattr(model, "lm_head", None)
    if lm is not None:
        tp = getattr(lm, "tp", None)
        return lm(hidden).float() if tp is None else tp.all_gather(lm(hidden).float())
    if not model.cfg.tie_word_embeddings:
        raise ValueError("lm_logits: the model has untied embeddings and no lm_head "
                         "(an int4 model drops it), so it has no text head")
    emb = model.model.embed_tokens
    if isinstance(emb, QEmbedding):
        w = (emb.q.float() * emb.s).to(hidden.dtype)
    else:
        w = emb.weight
    return F.linear(hidden, w).float()


# The aten op a training layer's weight products reach: nn.Linear without
# bias on [B, S, K] folds to aten.mm (aten.linear -> matmul -> mm on the 2-D
# view), on the CPU and on the card alike, 7 a layer. Attention's products
# carry batch dims (aten.bmm on the CPU, the flash kernels' autograd
# Function on the card) and are recomputed, as JAX's policy recomputes
# them. The int8 / W4A8 products (QLinear, Q4Linear) serve only and take no
# part in training.
DOTS_SAVED_OPS = (torch.ops.aten.mm.default,)


def _dots_policy(ctx, op, *args, **kwargs):
    from torch.utils.checkpoint import CheckpointPolicy

    return (CheckpointPolicy.MUST_SAVE if op in DOTS_SAVED_OPS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def dots_context():
    """The (forward, recompute) contexts of remat_policy "dots": save every
    DOTS_SAVED_OPS output, recompute everything else."""
    from torch.utils.checkpoint import create_selective_checkpoint_contexts

    return create_selective_checkpoint_contexts(_dots_policy)


def qwen3_forward(model: Qwen3Model, embeds: torch.Tensor,
                  positions: torch.Tensor, block_ids: torch.Tensor,
                  doc_ids: torch.Tensor, attn_impl: str = "auto",
                  remat: bool = False, max_live_kv: int | None = None,
                  remat_policy: str = "full") -> torch.Tensor:
    """Full (uncached) forward over packed/padded embeds (qwen3.py:300-358).

    embeds [B, S, D]; positions, block_ids, doc_ids [B, S]. Returns the
    final-norm hidden states [B, S, D]. Attention is ``masked_attention``
    under the (block, doc) ids; ``max_live_kv`` (this port's 64-key tiles)
    switches its kernel route to sparse iteration, with the tile lists built
    once here, outside the layers, and shared by all of them. remat=True
    recomputes each layer in the backward (torch.utils.checkpoint,
    non-reentrant): remat_policy "full" keeps only each layer's input;
    "dots" also keeps the outputs of the layer's weight products (q / k / v
    / o_proj, gate / up / down_proj), what JAX's
    ``dots_with_no_batch_dims_saveable`` saves, through torch's selective
    activation checkpointing (:func:`dots_context`), and recomputes the rest
    (norms, RoPE, attention, SwiGLU).
    """
    if remat_policy not in ("full", "dots"):
        raise ValueError(f"qwen3_forward: unknown remat_policy {remat_policy!r}")
    cfg = model.cfg
    s = embeds.shape[1]
    cos, sin = _rope_at(cfg, positions)
    plan = None
    kernel_route = attn_impl == "kernel" or (
        attn_impl == "auto" and embeds.device.type == "cuda" and s * s > 256 * 256)
    if max_live_kv is not None and kernel_route:
        plan = sparse_plan(block_ids, doc_ids, block_ids, doc_ids, max_live_kv)

    x = embeds
    args = (cos, sin, block_ids, doc_ids, attn_impl, plan)
    extra = {"context_fn": dots_context} if remat_policy == "dots" else {}
    for layer in model.model.layers:
        if remat and torch.is_grad_enabled():
            x = checkpoint(layer, x, *args, use_reentrant=False, **extra)
        else:
            x = layer(x, *args)
    return rms_norm(x, model.model.norm.weight, cfg.rms_norm_eps)


def qwen3_forward_cached(model: Qwen3Model, embeds: torch.Tensor,
                         positions: torch.Tensor, cache: dict, cache_len: int,
                         kv_start: torch.Tensor, causal_block: bool):
    """Forward a block of S new tokens against the KV cache.

    embeds [B, S, D]; positions [B, S]; cache_len: tokens already cached
    (same for every row; rows are left-padded and kv_start [B] marks each
    row's first valid slot). causal_block=True: causal prefill (key j
    visible to query i iff kv_start <= j <= cache_len + i), plain attention.
    causal_block=False: the block sees itself and the whole valid cache
    [kv_start, cache_len + S), through the decode-attention kernel.

    An int8 cache (init_kv_cache(int8=True)) takes the new rows quantized
    per (head, position); the causal prefill reads it dequantized (plain
    torch, as the JAX package's XLA path) and the decode block through the
    fused-KV kernel.

    The cache is updated IN PLACE by slice assignment (the JAX function
    returns a new one); it is returned as well. Returns (hidden [B, S, D],
    cache).
    """
    cfg = model.cfg
    b, s, _ = embeds.shape
    int8_cache = "kv" in cache
    max_len = (cache["kv"] if int8_cache else cache["k"]).shape[3]
    dev = embeds.device
    cos, sin = _rope_at(cfg, positions)
    new_len = cache_len + s
    kv_start = kv_start.to(device=dev, dtype=torch.int32)

    mask = None
    if causal_block:
        pos_idx = torch.arange(max_len, device=dev)
        q_abs = cache_len + torch.arange(s, device=dev)
        mask = (pos_idx[None, None, :] >= kv_start[:, None, None]) & (
            pos_idx[None, None, :] <= q_abs[None, :, None])
        mask = mask[:, None]                               # [B, 1, S, L]
    kv_len_vec = torch.full((b,), new_len, dtype=torch.int32, device=dev)

    x = embeds
    for li, layer in enumerate(model.model.layers):
        with gathered(layer):
            x = _cached_layer(layer, x, cos, sin, cache, li, cache_len, new_len, kv_start,
                              kv_len_vec, mask, causal_block)
    hidden = rms_norm(x, model.model.norm.weight, cfg.rms_norm_eps)
    return hidden, cache


def _cached_layer(layer: Qwen3DecoderLayer, x, cos, sin, cache: dict, li: int,
                  cache_len: int, new_len: int, kv_start, kv_len_vec, mask,
                  causal_block: bool) -> torch.Tensor:
    """One layer of :func:`qwen3_forward_cached` on its local heads."""
    b, s, _ = x.shape
    at = layer.self_attn
    hq, hkv, hd = at.num_heads, at.num_kv_heads, layer.cfg.head_dim
    eps = layer.cfg.rms_norm_eps
    int8_cache = "kv" in cache
    h = rms_norm(x, layer.input_layernorm.weight, eps)
    q = rms_norm(at.q_proj(h).view(b, s, hq, hd), at.q_norm.weight, eps)
    k = rms_norm(at.k_proj(h).view(b, s, hkv, hd), at.k_norm.weight, eps)
    v = at.v_proj(h).view(b, s, hkv, hd)
    q = apply_rope_half(q, cos, sin)
    k = apply_rope_half(k, cos, sin)
    if int8_cache:
        kv_new, sc_new = quantize_kv_rows(k, v)
        cache["kv"][li, :, :, cache_len:new_len] = kv_new
        cache["sc"][li, :, :, :, cache_len:new_len] = sc_new
        kv_l, sc_l = cache["kv"][li], cache["sc"][li]
        if causal_block:
            kd, vd = dequantize_fused_kv(kv_l, sc_l)
            attn = attention_xla(q, kd.transpose(1, 2).to(q.dtype),
                                 vd.transpose(1, 2).to(q.dtype), mask)
        else:
            attn = windowed_decode_attention_fusedkv(q, kv_l, kv_len_vec,
                                                     kv_start, sc_l)
    else:
        k_all, v_all = cache["k"], cache["v"]
        k_all[li, :, :, cache_len:new_len] = k.transpose(1, 2).to(k_all.dtype)
        v_all[li, :, :, cache_len:new_len] = v.transpose(1, 2).to(v_all.dtype)
        if causal_block:
            attn = attention_xla(q, k_all[li].transpose(1, 2),
                                 v_all[li].transpose(1, 2), mask)
        else:
            attn = windowed_decode_attention(q, k_all[li], v_all[li],
                                             kv_len_vec, kv_start)
    x = x + row_parallel(at.o_proj, attn.to(x.dtype).reshape(b, s, hq * hd), at.tp)
    h = rms_norm(x, layer.post_attention_layernorm.weight, eps)
    return x + layer.mlp(h)
