"""Tensor parallelism for serving (port of bitdance_tpu/parallel/tp.py).

The JAX package names a "tp" mesh axis and lets GSPMD place the collectives:
the Qwen3 backbone's attention heads and MLP hidden width are sharded over
it (:data:`QWEN3_TP_RULES`), and the diffusion head's stacked sampler is
reordered head-major and sharded Megatron-style (:func:`shard_head_stacked`).
The port shards explicitly, in place, on each rank of a tp group
(:class:`TPGroup`):

- Qwen3 (:func:`shard_qwen3_`): q_proj / o_proj by whole heads, k_proj /
  v_proj by whole kv heads, gate / up / down by columns of the intermediate
  width, the embedding by vocabulary rows (a masked lookup, then an
  all-reduce), lm_head by vocabulary rows (an all-gather of the logits).
  Each decoder layer then runs on its local heads and widths, with one
  all-reduce of fp32 partial sums after o_proj and one after down_proj.
- The head (:func:`shard_head_stacked`): qkv and w1 column-parallel on the
  head-major layout (whole heads per rank), wo and w2 row-parallel; the
  sampler (ops/fused_head.py, ``em_sample_stacked`` on a stack with
  ``"hm_marker"``) runs each rank's products on the head GEMM and
  all-reduces a row-parallel product's sums before its bias, gate and
  residual. The stack may be bf16, fp32, int8 or packed int4 (the column
  scales ``wqkv_s`` / ``w1_s`` split with their columns; ``wo_s`` /
  ``w2_s`` and ``modcat_w_s`` stay whole): a quantized row-parallel
  product quantizes its share in the whole row's units (a MAX all-reduce
  of the rows' max |x|) and all-reduces int32 sums, which GSPMD does with
  the JAX package's int32 dot, so that tp 2 samples the bits of tp 1.

Where tp does not divide a tensor it stays whole, as the JAX rules fall back
to replication. The JAX rule splits a projection's columns by count, so
GSPMD may cut inside a head; explicit TP cannot without resharding, so the
port keeps whole heads (:func:`qwen3_tp_placements`, ROADMAP C14). The
values are the same either way. The Qwen3 backbone is sharded in bf16 or
fp32 only: the JAX rules fail on its quantized trees (``qwen3_tp_shardings``
takes a QTensor for one leaf), so the port refuses them too.
"""

from __future__ import annotations

import time
from typing import NamedTuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from bitdance_tpu_torch.ops.fused_head import HEAD_GEMM_STAGE_K
from bitdance_tpu_torch.ops.int4 import pack_int4, unpack_int4

# The tensor dim each Qwen3 weight splits over tp, in the port's [out, in]
# layout (the JAX specs, on stacked [L, in, out] tensors, in the comments).
# Tensors not listed (the norms) stay whole, as P() does.
QWEN3_TP_RULES = {
    "q_proj": 0,           # P(None, "fsdp", "tp")
    "k_proj": 0,           # P(None, "fsdp", "tp")
    "v_proj": 0,           # P(None, "fsdp", "tp")
    "o_proj": 1,           # P(None, "tp", "fsdp")
    "gate_proj": 0,        # P(None, "fsdp", "tp")
    "up_proj": 0,          # P(None, "fsdp", "tp")
    "down_proj": 1,        # P(None, "tp", "fsdp")
    "embed_tokens": 0,     # P("tp", None): vocabulary rows
    "lm_head": 0,          # P(None, "tp") on [D, V]: vocabulary columns
}
QWEN3_WHOLE = ("q_norm", "k_norm", "input_layernorm", "post_attention_layernorm",
               "final_norm")
# k_proj / v_proj where tp divides the q heads but not the kv heads: each
# rank keeps the kv heads its q heads read (:func:`kv_heads_read`)
KV_READ = "kv_read"

HEAD_COL_PARALLEL = ("wqkv", "wqkv_s", "bqkv", "w1", "w1_s", "b1")
HEAD_ROW_PARALLEL = ("wo", "w2")


class TPGroup:
    """This process's place in one tensor-parallel group: ``rank`` of
    ``size`` and the process group (None at size 1). It counts the
    all-reduces it runs, in all and by kind ("float32 sum", "int32 sum",
    "float32 max": ``kinds`` maps each to [count, seconds]); with ``timed``
    it synchronises the card around each and adds up their seconds (a
    measurement mode: it stalls the host)."""

    def __init__(self, rank: int = 0, size: int = 1, group=None):
        self.rank, self.size, self.group = rank, size, group
        self.timed = False
        self.reset()

    def reset(self) -> None:
        """Zero the all-reduce counts and seconds."""
        self.all_reduces = 0
        self.seconds = 0.0
        self.kinds: dict[str, list] = {}

    def all_reduce(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """Reduce ``t`` over the group in place by ``op`` ("sum" or "max")
        and return it."""
        if self.size == 1:
            return t
        sync = self.timed and t.is_cuda
        if sync:
            torch.cuda.synchronize(t.device)
        t0 = time.perf_counter()
        dist.all_reduce(t, op={"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op],
                        group=self.group)
        if sync:
            torch.cuda.synchronize(t.device)
        kind = self.kinds.setdefault(f"{str(t.dtype).removeprefix('torch.')} {op}", [0, 0.0])
        kind[0] += 1
        if self.timed:
            dt = time.perf_counter() - t0
            self.seconds += dt
            kind[1] += dt
        self.all_reduces += 1
        return t

    def all_gather(self, t: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """The ranks' ``t`` concatenated in rank order along ``dim``."""
        if self.size == 1:
            return t
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(parts, t, group=self.group)
        return torch.cat(parts, dim=dim)


def row_parallel(lin: nn.Linear, x: torch.Tensor, tp: TPGroup | None) -> torch.Tensor:
    """``lin(x)`` for a linear whose in-features are this rank's share
    (None: a whole linear): the partial product summed in fp32 (one cuBLAS
    call reading bf16 and writing fp32 on the card), all-reduced over tp,
    then cast to x's dtype once, as the whole product rounds once."""
    if tp is None:
        return lin(x)
    w = lin.weight
    if x.is_cuda and w.dtype == torch.bfloat16:
        y = torch.mm(x.reshape(-1, x.shape[-1]), w.t(), out_dtype=torch.float32)
        y = y.reshape(*x.shape[:-1], w.shape[0])
    else:
        y = F.linear(x, w).float()
    return tp.all_reduce(y).to(x.dtype)


def kv_heads_read(rank: int, hq: int, hkv: int, tp: int) -> list[int]:
    """The kv heads rank ``rank`` keeps when its q heads are the rank's
    share [rank * hq/tp, (rank + 1) * hq/tp) (tp divides hq): q head j
    reads kv head j // (hq / hkv). Where those q heads read their kv heads
    in equal runs (always when tp divides hkv: kv heads [rank * hkv/tp,
    (rank + 1) * hkv/tp)), each kv head once, so local q head i reads local
    kv head i // (local group); else one kv head for each q head."""
    per, group = hq // tp, hq // hkv
    heads = [j // group for j in range(rank * per, (rank + 1) * per)]
    kept = sorted(set(heads))
    g = per // len(kept)
    if per % len(kept) == 0 and all(h == kept[i // g] for i, h in enumerate(heads)):
        return kept
    return heads


def qwen3_tp_placements(cfg, tp: int) -> dict:
    """Each Qwen3 tensor's placement at tensor-parallel size ``tp``: the dim
    of :data:`QWEN3_TP_RULES` it splits, :data:`KV_READ` for k / v heads
    kept as :func:`kv_heads_read` says, or None (whole). The whole-head rule:
    attention is sharded only where tp divides the q heads (then k / v where
    it divides the kv heads, else KV_READ); the MLP where it divides the
    intermediate width; embed_tokens and lm_head where it divides the
    vocabulary. The JAX rule splits q / k / v / o by column count alone."""
    out = dict.fromkeys((*QWEN3_TP_RULES, *QWEN3_WHOLE))
    if tp == 1:
        return out
    for size, names in ((cfg.num_attention_heads, ("q_proj", "k_proj", "v_proj", "o_proj")),
                        (cfg.intermediate_size, ("gate_proj", "up_proj", "down_proj")),
                        (cfg.vocab_size, ("embed_tokens", "lm_head"))):
        if size % tp == 0:
            out.update({n: QWEN3_TP_RULES[n] for n in names})
    if out["q_proj"] is not None and cfg.num_key_value_heads % tp:
        out.update(k_proj=KV_READ, v_proj=KV_READ)
    return out


def _keep(mod: nn.Module, dim: int, index: torch.Tensor) -> None:
    """Keep the entries ``index`` of dim ``dim`` of mod.weight (a fresh
    contiguous tensor, so the whole one is freed) and its size attributes."""
    w = mod.weight
    w.data = w.data.index_select(dim, index.to(w.device)).contiguous()
    if isinstance(mod, nn.Linear):
        mod.out_features, mod.in_features = w.shape
    elif isinstance(mod, nn.Embedding):
        mod.num_embeddings = w.shape[0]


def _share(rank: int, size: int, n: int) -> torch.Tensor:
    per = n // size
    return torch.arange(rank * per, (rank + 1) * per)


_QUANT_QWEN3 = ("shard_qwen3_: quantized Qwen3 {} are not tensor-parallel; the JAX "
                "package does not serve them either (its qwen3_tp_shardings takes a "
                "QTensor for one leaf and fails)")


@torch.no_grad()
def shard_qwen3_(model: nn.Module, tp: TPGroup) -> nn.Module:
    """Turn a whole port Qwen3Model into this rank's shard IN PLACE by
    :func:`qwen3_tp_placements`. Each layer's attention records its local
    head counts (``num_heads``, ``num_kv_heads``) and, when sharded, the
    group (``tp``) its o_proj all-reduces over; its MLP likewise for
    down_proj. A vocabulary-parallel embedding records its first row
    (``vocab_start``) and group; a sharded lm_head its group. Refuses the
    quantized projections, the int8 embedding and lm_head (the JAX rules
    fail on those trees) and a model sharded before."""
    if getattr(model, "tp", None) is not None:
        raise ValueError("shard_qwen3_: the model is tensor-parallel already")
    cfg = model.cfg
    pl = qwen3_tp_placements(cfg, tp.size)
    dim = QWEN3_TP_RULES
    r, n = tp.rank, tp.size
    hq, hkv, hd = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    for layer in model.model.layers:
        at, mlp = layer.self_attn, layer.mlp
        for lin in (at.q_proj, at.k_proj, at.v_proj, at.o_proj,
                    mlp.gate_proj, mlp.up_proj, mlp.down_proj):
            if not isinstance(lin, nn.Linear):
                raise NotImplementedError(_QUANT_QWEN3.format("projections"))
        if pl["q_proj"] is not None:
            q_rows = _share(r, n, hq * hd)
            kv = torch.tensor(kv_heads_read(r, hq, hkv, n))
            kv_rows = (kv[:, None] * hd + torch.arange(hd)).reshape(-1)
            for name, rows in (("q_proj", q_rows), ("k_proj", kv_rows), ("v_proj", kv_rows),
                               ("o_proj", q_rows)):
                _keep(getattr(at, name), dim[name], rows)
            at.num_heads, at.num_kv_heads, at.tp = hq // n, len(kv), tp
        if pl["gate_proj"] is not None:
            cols = _share(r, n, cfg.intermediate_size)
            for name in ("gate_proj", "up_proj", "down_proj"):
                _keep(getattr(mlp, name), dim[name], cols)
            mlp.tp = tp
    if pl["embed_tokens"] is not None:
        emb = model.model.embed_tokens
        if not isinstance(emb, nn.Embedding):
            raise NotImplementedError(_QUANT_QWEN3.format("embedding"))
        rows = _share(r, n, cfg.vocab_size)
        _keep(emb, dim["embed_tokens"], rows)
        emb.vocab_start, emb.tp = int(rows[0]), tp
        lm = getattr(model, "lm_head", None)
        if lm is not None:
            if not isinstance(lm, nn.Linear):
                raise NotImplementedError(_QUANT_QWEN3.format("lm_head"))
            _keep(lm, dim["lm_head"], rows)
            lm.tp = tp
    model.tp = tp
    return model


class HeadShards(NamedTuple):
    """A head-major stack's tensor parallelism (its ``"tp"`` entry): the
    group and each product's placement, "col", "row" or None."""

    group: TPGroup
    placements: dict


def _to_head_major(t: torch.Tensor, parts: int, n_head: int) -> torch.Tensor:
    """Out-features (dim 1 of [L, N, K] weights and [L, N] biases) from
    (parts, n_head, N / parts / n_head) to (n_head, parts, ...) order."""
    x = t.unflatten(1, (parts, n_head, t.shape[1] // parts // n_head))
    return x.transpose(1, 2).flatten(1, 3).contiguous()


def reorder_stacked_head_major(stacked: dict, n_head: int) -> dict:
    """Canonical stacked head -> head-major layout, with the ``"hm_marker"``
    entry (JAX tp.py:103-136): a pure permutation of out-features, so qkv
    goes from (3, n_head, hd) to (n_head, 3, hd) and w1 / b1 from (2, H) to
    (n_head, 2, H / n_head), a quantized stack's column scales wqkv_s / w1_s
    with them; wo and w2 stay, since the attention output and silu(h1) * h2
    keep their canonical column order. A new dict; bf16, fp32, int8 or
    packed-int4 stacks (packing runs along in-features, which do not move)."""
    out = dict(stacked)
    for k in ("wqkv", "wqkv_s", "bqkv"):
        if k in out:
            out[k] = _to_head_major(out[k], 3, n_head)
    for k in ("w1", "w1_s", "b1"):
        if k in out:
            out[k] = _to_head_major(out[k], 2, n_head)
    out["hm_marker"] = torch.zeros((), dtype=torch.int8)
    return out


def _packed_int4(stacked: dict) -> bool:
    """Whether a quantized stack holds packed int4 block matrices: w1's
    stored in-features are half the width C (ops/fused_head.py)."""
    return "w1_s" in stacked and 2 * stacked["w1"].shape[2] == stacked["n2"].shape[-1]


def _in_features(stacked: dict, key: str) -> int:
    """Logical in-features of a block matrix [L, N, K] (packed: [L, N, K/2])."""
    return stacked[key].shape[2] * (2 if _packed_int4(stacked) else 1)


def head_tp_placements(stacked: dict, n_head: int, tp: int) -> dict:
    """Each block product's placement at size ``tp`` (JAX tp.py:139-153):
    qkv and w1 (weights, column scales and biases) column-parallel, "col",
    where tp divides n_head; wo and w2 row-parallel, "row", where it
    divides their (logical) in-features; else None (whole). Everything
    else stays whole, the row-parallel products' column scales too."""
    out = {k: ("col" if tp > 1 and n_head % tp == 0 else None)
           for k in HEAD_COL_PARALLEL if k in stacked}
    out.update({k: ("row" if tp > 1 and _in_features(stacked, k) % tp == 0 else None)
                for k in HEAD_ROW_PARALLEL if k in stacked})
    return out


def int4_row_share(w: torch.Tensor, rank: int, size: int) -> torch.Tensor:
    """This rank's share of a packed-int4 row-parallel weight [L, N, K/2]
    (byte j holds k = j and k = j + K/2): in-features [rank K/size,
    (rank + 1) K/size) unpacked and packed again as a weight of K/size
    in-features, [L, N, K/(2 size)], its low nibbles the share's first
    half. (A contiguous range of packed bytes is not a range of k: at size
    2, rank 0's bytes would hold every low nibble.)"""
    lo, hi = unpack_int4(w)
    k = 2 * w.shape[2] // size
    return pack_int4(torch.cat([lo, hi], dim=2)[..., rank * k:(rank + 1) * k]).contiguous()


def shard_head_stacked(stacked: dict, tp: TPGroup, n_head: int) -> dict:
    """Reorder to head-major and keep this rank's shards (JAX tp.py:156-162):
    a column-parallel tensor its 1/tp of out-features (whole heads), a
    row-parallel one its 1/tp of in-features (packed int4:
    :func:`int4_row_share`); the ``"tp"`` entry is a :class:`HeadShards`.
    The sampler reads it (ops/fused_head.py). Off the CPU a packed share
    must be whole 256-k stages of the head GEMM's s4 kind (tp 2 at the 14B
    head: wo 2,560 and w2 3,840; tp 4's w2 share of 1,920 raises); the
    CPU's plain twin takes any even share."""
    hm = reorder_stacked_head_major(stacked, n_head)
    pl = head_tp_placements(hm, n_head, tp.size)
    packed = _packed_int4(hm)
    stage = HEAD_GEMM_STAGE_K["int4"]
    for k, p in pl.items():
        share = _in_features(hm, k) // tp.size if p == "row" else 0
        if packed and (share % 2 or hm[k].device.type != "cpu" and share % stage):
            raise ValueError(f"shard_head_stacked: {k}'s packed int4 share of {share} "
                             f"in-features at tp {tp.size} is not a whole number of the "
                             f"head GEMM's {stage}-k s4 stages")
    for k, p in pl.items():
        if p == "row" and packed:
            hm[k] = int4_row_share(hm[k], tp.rank, tp.size)
        elif p is not None:
            dim = 1 if p == "col" else 2
            hm[k] = hm[k].index_select(dim, _share(tp.rank, tp.size, hm[k].shape[dim])
                                       .to(hm[k].device)).contiguous()
    hm["tp"] = HeadShards(tp, pl)
    return hm
