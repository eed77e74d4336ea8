"""Host-side packed-batch builder for multimodal training (port of
bitdance_tpu/data/packing.py; numpy, byte-for-byte the same arrays).

Implements the unreleased 14B loader's contract (SURVEY.md §2.8 D3,
mllm.py:163-184): multiple samples packed into one fixed-budget sequence,
per-token (block_id, doc_id) attention metadata, CE/vision loss indexes.

A T2I training sample packs as:
    [prompt text (causal segment),
     vision_start, res_h, res_w, query_1..query_{p-1}, image tokens
     (parallel segment: first 2 tokens causal, then windows of p)]
Vision loss conditioning: the hidden states of window i (starting with
[res_w, queries] for i=0) condition the diffusion of image window i — i.e.
loss positions are every image-region position shifted back by one window
(mllm.py:220-248 with the query-token scheme of t2i_pipeline.py:191-194).
"""

from __future__ import annotations

import dataclasses

import numpy as np


def sincos_1d_table_np(dim: int, max_len: int,
                       pe_interpolation: float = 1.0) -> np.ndarray:
    """[max_len, dim] sin | cos table of 1-D positions (the JAX package's
    ops/rotary.py:132-144, numpy)."""
    assert dim % 2 == 0
    omega = np.arange(dim // 2, dtype=np.float32) / (dim / 2.0)
    omega = 1.0 / (10000.0 ** omega)
    pos = np.arange(max_len, dtype=np.float32) / pe_interpolation
    out = np.outer(pos, omega)
    return np.concatenate([np.sin(out), np.cos(out)], axis=1)


def pos_embed_2d_np(table_1d: np.ndarray, h: int, w: int, ps: int = 1) -> np.ndarray:
    """[h*w, 2 * table_dim] 2-D sin-cos embedding (column half first) in
    ps-raster order (the JAX package's ops/rotary.py:147-160)."""
    table_1d = np.asarray(table_1d)
    d2 = table_1d.shape[1]
    grid_v = np.broadcast_to(table_1d[:h, None, :], (h, w, d2))
    grid_h = np.broadcast_to(table_1d[None, :w, :], (h, w, d2))
    pe = np.concatenate([grid_h, grid_v], axis=-1)
    hh, ww = h // ps, w // ps
    pe = pe.reshape(hh, ps, ww, ps, -1)
    pe = np.transpose(pe, (0, 2, 1, 3, 4))
    return pe.reshape(h * w, -1)


def sample_token_len(s: "T2ISample", parallel_num: int) -> int:
    """Total packed tokens a sample will occupy."""
    return len(s.text_ids) + 3 + (parallel_num - 1) + s.image_latents.shape[0]


class GreedyPacker:
    """Stream packer: fill sequence budgets from a sample stream.

    Implements the yaml packing contract (bitdance_14b_64x.yaml:45-49):
    samples accumulate in a bounded buffer; batches are emitted once the
    packed length reaches `expected_num_tokens` (never exceeding
    `max_num_tokens`); singles above `max_num_tokens_per_sample` are
    rejected. Greedy-fit keeps utilization high with native-resolution
    variable-length samples.
    """

    def __init__(self, parallel_num: int, expected_num_tokens: int = 33280,
                 max_num_tokens: int = 37376,
                 max_num_tokens_per_sample: int = 16384,
                 max_buffer_size: int = 50):
        self.p = parallel_num
        self.expected = expected_num_tokens
        self.max_tokens = max_num_tokens
        self.max_per_sample = max_num_tokens_per_sample
        self.max_buffer = max_buffer_size
        self.buffer: list = []

    def add(self, sample: "T2ISample") -> list | None:
        """Add a sample; returns a list of samples to pack when a batch is
        ready, else None."""
        if sample_token_len(sample, self.p) > self.max_per_sample:
            return None  # reject oversized (yaml max_num_tokens_per_sample)
        self.buffer.append(sample)
        if len(self.buffer) >= self.max_buffer:
            return self._emit()
        total = sum(sample_token_len(s, self.p) for s in self.buffer)
        if total >= self.expected:
            return self._emit()
        return None

    def _emit(self) -> list:
        """Greedy-fit a batch under max_tokens (reserving the trash slot)."""
        budget = self.max_tokens - 1
        batch, rest, used = [], [], 0
        # largest-first improves fit for heterogeneous resolutions
        for s in sorted(self.buffer, key=lambda x: -sample_token_len(x, self.p)):
            n = sample_token_len(s, self.p)
            if used + n <= budget:
                batch.append(s)
                used += n
            else:
                rest.append(s)
        self.buffer = rest
        return batch

    def flush(self) -> list:
        out = self.buffer
        self.buffer = []
        return out


@dataclasses.dataclass
class T2ISample:
    text_ids: np.ndarray        # [n_text] prompt token ids (incl. chatml)
    image_latents: np.ndarray   # [h*w, z] ±1, ps-raster ordered
    latent_h: int
    latent_w: int
    vision_start_id: int
    res_h_id: int
    res_w_id: int
    query_ids: np.ndarray       # [p-1]
    text_loss: bool = False     # compute CE on the prompt tokens?


def pack_t2i_batch(
    samples: list[T2ISample],
    parallel_num: int,
    seq_budget: int,
    pos_embed_table: np.ndarray,   # [max_side, hidden//2] 1D sincos table
    text_budget: int | None = None,
    vis_budget: int | None = None,
    pad_token_id: int = 0,
):
    """Pack samples into fixed-shape arrays for mllm_forward_train.

    Returns a dict of numpy arrays matching PackedBatch fields. Sequences
    that exceed seq_budget raise; callers choose budgets per yaml
    (expected_num_tokens 33280, bitdance_14b_64x.yaml:45-47).
    """
    p = parallel_num
    hidden = pos_embed_table.shape[1] * 2

    text_ids, text_idx = [], []
    vis_lat, vis_idx, vis_in_pe = [], [], []
    pos_ids, block_ids, doc_ids = [], [], []
    ce_idx, ce_labels = [], []
    vloss_idx, vlabel_idx, v_pe = [], [], []

    offset = 0
    next_block = 0
    for doc, s in enumerate(samples):
        n_text = len(s.text_ids)
        hw = s.image_latents.shape[0]
        assert hw == s.latent_h * s.latent_w
        assert hw % p == 0
        header = [s.vision_start_id, s.res_h_id, s.res_w_id] + list(s.query_ids)
        n_head = len(header)  # 3 + p - 1
        total = n_text + n_head + hw
        # seq position L-1 is a reserved trash slot targeted by padded
        # scatter indexes (doc_id -1, excluded from attention and loss)
        if offset + total > seq_budget - 1:
            raise ValueError(f"sample overflows budget {seq_budget}")

        ps = int(np.sqrt(p))
        pe = pos_embed_2d_np(pos_embed_table, s.latent_h, s.latent_w, ps=ps)

        # --- text + header tokens ------------------------------------------
        all_text = list(s.text_ids) + header
        for j, tid in enumerate(all_text):
            text_ids.append(tid)
            text_idx.append(offset + j)
        if s.text_loss:
            # next-token CE over the prompt span
            for j in range(n_text - 1):
                ce_idx.append(offset + j)
                ce_labels.append(int(s.text_ids[j + 1]))

        # --- vision tokens ---------------------------------------------------
        img_off = offset + n_text + n_head
        for j in range(hw):
            vis_idx.append(img_off + j)
            vis_in_pe.append(pe[j])
        vis_lat.append(s.image_latents)

        # --- attention metadata ----------------------------------------------
        # causal: prompt + vision_start + res_h ; parallel windows from res_w
        ncausal = n_text + 2
        for j in range(ncausal):
            pos_ids.append(j)
            block_ids.append(next_block)
            next_block += 1
            doc_ids.append(doc)
        rest = total - ncausal  # = (p) + hw ... windows of p
        assert rest % p == 0
        for w in range(rest // p):
            for j in range(p):
                pos_ids.append(ncausal + w * p + j)
                block_ids.append(next_block)
                doc_ids.append(doc)
            next_block += 1

        # --- vision loss: window i conditioned on window i-1 positions -------
        # window 0 positions: [res_w, queries] = offset+n_text+2 .. +2+p-1
        base_rows = sum(x.shape[0] for x in vis_lat[:-1])
        first_cond = offset + n_text + 2
        for j in range(hw):
            vloss_idx.append(first_cond + j)
            vlabel_idx.append(base_rows + j)
            v_pe.append(pe[j])

        offset += total

    L = seq_budget

    def pad1(arr, n, val=0, dtype=np.int32):
        a = np.full((n,), val, dtype)
        a[: len(arr)] = np.asarray(arr, dtype)
        return a

    def pad2(arr_list, n, dim, dtype=np.float32):
        a = np.zeros((n, dim), dtype)
        if arr_list:
            stacked = (np.concatenate(arr_list, axis=0)
                       if isinstance(arr_list[0], np.ndarray) and arr_list[0].ndim == 2
                       else np.stack(arr_list))
            a[: stacked.shape[0]] = stacked
        return a

    t_budget = text_budget or L
    n_vis = sum(x.shape[0] for x in vis_lat)
    v_budget = vis_budget or L
    assert n_vis <= v_budget and len(text_ids) <= t_budget

    # pad loss counts to multiples of p
    n_vloss = len(vloss_idx)
    v_loss_budget = ((v_budget + p - 1) // p) * p

    z = samples[0].image_latents.shape[1]
    batch = dict(
        packed_text_ids=pad1(text_ids, t_budget, pad_token_id),
        packed_text_indexes=pad1(text_idx, t_budget, L - 1),
        vision_latents=pad2(vis_lat, v_budget, z),
        vit_token_indexes=pad1(vis_idx, v_budget, L - 1),
        position_ids=pad1(pos_ids, L, 0),
        block_ids=pad1(block_ids, L, next_block),
        doc_ids=pad1(doc_ids, L, -1),
        ce_text_indexes=pad1(ce_idx, t_budget, L - 1),
        ce_text_labels=pad1(ce_labels, t_budget, 0),
        ce_text_weights=pad1([1.0] * len(ce_idx), t_budget, 0.0, np.float32),
        vision_loss_indexes=pad1(vloss_idx, v_loss_budget, L - 1),
        vision_label_indexes=pad1(vlabel_idx, v_loss_budget, v_budget - 1),
        vision_loss_weights=pad1([1.0] * n_vloss, v_loss_budget, 0.0, np.float32),
        vision_pos_embed=pad2(v_pe, v_loss_budget, hidden),
        vision_input_pos_embed=pad2(vis_in_pe, v_budget, hidden),
    )
    return batch


def stack_packed_batches(raws: list[dict], grad_accum: int = 1) -> dict:
    """Stack fixed-shape packed sequences into the batched train-step layout:
    [B, ...] per field, or [grad_accum, B/grad_accum, ...] when accumulating.
    All sequences must share one (seq/text/vis) budget so shapes agree."""
    out = {k: np.stack([r[k] for r in raws]) for k in raws[0]}
    if grad_accum > 1:
        b = len(raws)
        assert b % grad_accum == 0, (
            f"batch {b} not divisible by grad_accum {grad_accum}")
        out = {k: v.reshape(grad_accum, b // grad_accum, *v.shape[1:])
               for k, v in out.items()}
    return out
