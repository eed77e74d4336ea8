"""Packed int4 weights with int8 activations, W4A8 (port of
bitdance_tpu/ops/int4.py).

Layout: a :class:`Q4Tensor` holds ``q`` int8 [N, K/2] and ``s`` f32 [N] (the
JAX package stores q [K/2, N]; the port keeps K contiguous per output
column, which is what the tensor cores' K-major operands read). Byte
[n, j] holds k = j in its low nibble and k = j + K/2 in its high nibble, so
the product is two contiguous half-K products, one per nibble plane.

:func:`int4_matmul` row-quantizes the activations and runs the product as
the kernel ``csrc/w4a8.cu`` (replacing the TPU kernel ``_w4a8_kernel``) on a
CUDA tensor; a CPU tensor takes :func:`int4_matmul_reference`. The kernel
is swap-AB on wgmma: blocks of 128 weight rows, the token rows padded to a
built width (:func:`w4a8_token_tiles`) and, where the weight's row tiles
cannot fill the card, K split across blocks (:func:`w4a8_splits`) with the
int32 partial sums merged by a second launch. :func:`w4a8_split_plain` is
a plain twin of that split and merge, for tests. The JAX package's routing
(its kernel only for m <= 1024, m % 32 == 0, K % 256 == 0) is a TPU choice
and is not carried over.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from bitdance_tpu_torch.ops import _cuda
from bitdance_tpu_torch.ops.int8 import int_dot, quantize_rows, true_div


@dataclasses.dataclass
class Q4Tensor:
    """Per-output-column int4 weight, two per byte along K:
    w[n, k] ~= unpack(q)[n, k] * s[n]."""

    q: torch.Tensor
    s: torch.Tensor


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """int8 values in [-8, 7], [..., K] -> packed [..., K/2] (k, k + K/2)."""
    kh = q.shape[-1] // 2
    if 2 * kh != q.shape[-1]:
        raise ValueError(f"odd contraction dim {tuple(q.shape)}")
    return ((q[..., :kh] & 0xF) | (q[..., kh:] << 4)).to(torch.int8)


def quantize_linear_int4(w: torch.Tensor) -> Q4Tensor:
    """[N, K] weight -> packed int4 per output row n, scale floor 1e-12."""
    wf = w.float()
    scale = torch.clamp_min(true_div(wf.abs().amax(dim=-1), 7.0), 1e-12)
    q = torch.clamp(torch.round(wf / scale[..., None]), -7, 7).to(torch.int8)
    return Q4Tensor(q=pack_int4(q), s=scale)


def unpack_int4(packed: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(lo, hi) sign-extended int8 nibble planes of a packed buffer."""
    w32 = packed.to(torch.int32)
    lo = ((w32 << 28) >> 28).to(torch.int8)
    hi = (w32 >> 4).to(torch.int8)
    return lo, hi


def dequantize_int4(w: Q4Tensor, dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    lo, hi = unpack_int4(w.q)
    q = torch.cat([lo, hi], dim=-1)
    return (q.float() * w.s[..., None]).to(dtype)


def int4_matmul_reference(xq: torch.Tensor, sx: torch.Tensor,
                          wq: torch.Tensor, sw: torch.Tensor,
                          out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Plain version of the kernel: int8 [M, K] (row scales sx [M]) x packed
    [N, K/2] (column scales sw [N]) -> out_dtype [M, N], with the integer sum
    exact (ops/int8.int_dot on the unpacked planes)."""
    lo, hi = unpack_int4(wq)
    kh = wq.shape[1]
    acc = int_dot(xq[:, :kh].contiguous(), lo) + int_dot(xq[:, kh:].contiguous(), hi)
    return (acc * (sx[:, None] * sw[None, :])).to(out_dtype)


ROW_TILE = 128          # weight rows per block of the kernel
STAGE_BYTES = 128       # packed bytes of a weight row per pipeline stage (256 k)
TOKEN_WIDTHS = (16, 32, 64, 128, 144)   # token widths the kernel is built for
MIN_SPLIT_STAGES = 2    # stages a split walks at least (w4a8_splits)


def w4a8_token_tiles(m: int) -> tuple[int, int, int]:
    """(chunks, rows per chunk, built width) for m token rows: the fewest
    equal chunks of at most the widest built width, each padded to the
    narrowest width that holds it (132 -> one chunk at 144; 300 -> three
    of 100 at 128)."""
    chunks = -(-m // TOKEN_WIDTHS[-1])
    rows = -(-m // chunks)
    return chunks, rows, next(w for w in TOKEN_WIDTHS if w >= rows)


def w4a8_stages(k: int) -> int:
    """Pipeline stages of the kernel over K: 128 packed bytes each, the last
    one half when K/2 % 128 == 64."""
    return -(-(k // 2) // STAGE_BYTES)


def w4a8_splits(m: int, n: int, k: int, sm_count: int = 132) -> tuple[int, int]:
    """(tail_from, n_splits): the kernel's 128-row tiles from tail_from on
    take K in n_splits shares, the earlier ones whole.

    A block holds one SM (its ring fills shared memory). Where the tiles of
    one token chunk outnumber the SMs, all but the last ``tiles % sm_count``
    run whole and those are split, so that no SM walks two whole tiles (the
    14B model's gate_proj / up_proj: 136 tiles on 132 SMs, 4 split 10 ways,
    not 4 SMs taking twice the time). Where they are fewer, every tile is
    split as far as the splits fit one block an SM and each walks at least
    MIN_SPLIT_STAGES stages: q_proj / o_proj and down_proj (40 tiles) take 3,
    k_proj / v_proj (8) take 10 (K 5120: 20 stages). Several token chunks
    (m > 144) run whole.
    """
    tiles = -(-n // ROW_TILE)
    stages = w4a8_stages(k)
    cap = max(1, stages // MIN_SPLIT_STAGES)
    if w4a8_token_tiles(m)[0] > 1:
        return tiles, 1
    if tiles >= sm_count:
        tail = tiles % sm_count
        return (tiles, 1) if tail == 0 else (tiles - tail, min(sm_count // tail, cap))
    return 0, min(sm_count // tiles, cap)


def w4a8_split_ranges(k: int, n_splits: int) -> list[tuple[int, int]]:
    """The packed-byte range [a, b) of each split, as the kernel cuts K: its
    stages of 128 packed bytes (w4a8_stages) shared out equally (split i
    takes stages [i * s // n, (i + 1) * s // n)), clipped to K/2. Split i
    pairs packed bytes [a, b) with x columns [a, b) (low nibbles) and
    [k/2 + a, k/2 + b) (high nibbles)."""
    stages = w4a8_stages(k)
    if k % 128 or not 1 <= n_splits <= stages:
        raise ValueError(f"w4a8_split_ranges: K={k} takes 1 to {stages} splits "
                         f"(K % 128 == 0), got {n_splits}")
    return [(min(i * stages // n_splits * STAGE_BYTES, k // 2),
             min((i + 1) * stages // n_splits * STAGE_BYTES, k // 2))
            for i in range(n_splits)]


def w4a8_split_partials(xq: torch.Tensor, wq: torch.Tensor,
                        n_splits: int) -> torch.Tensor:
    """The int32 sums each split writes, [n_splits, M, N], exact: the
    unpacked planes against their x columns over the split's byte range
    (float64 products, exact at these sizes)."""
    lo, hi = unpack_int4(wq)
    kh = wq.shape[1]
    xd = xq.double()
    parts = []
    for a, b in w4a8_split_ranges(2 * kh, n_splits):
        acc = (xd[:, a:b] @ lo[:, a:b].double().t()
               + xd[:, kh + a:kh + b] @ hi[:, a:b].double().t())
        parts.append(acc.to(torch.int32))
    return torch.stack(parts)


def w4a8_split_plain(xq: torch.Tensor, sx: torch.Tensor, wq: torch.Tensor,
                     sw: torch.Tensor, n_splits: int,
                     out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Plain twin of the kernel's split and merge, for tests: the splits'
    int32 sums added in split order, then float(acc) * (sx[m] * sw[n])."""
    parts = w4a8_split_partials(xq, wq, n_splits)
    acc = parts[0]
    for p in parts[1:]:
        acc = acc + p
    return (acc.float() * (sx[:, None] * sw[None, :])).to(out_dtype)


class W4A8Shape(ctypes.Structure):
    """The shapes of one kernel call, as the C entry takes them
    (``W4A8Shape`` in csrc/w4a8.cu)."""
    _fields_ = [(f, ctypes.c_int) for f in ("M", "N", "K", "n_splits", "tail_from", "chunks",
                                            "chunk_rows", "nt", "out_bf16")]


def _plan(m: int, n: int, k: int, dtype: torch.dtype, device: torch.device,
          n_splits: int | None) -> tuple:
    """(W4A8Shape, its address, scratch bytes, sx offset, partials offset)
    of a call; an explicit n_splits splits every tile. The caller keeps the
    W4A8Shape alive while the C entry reads it."""
    chunks, rows, nt = w4a8_token_tiles(m)
    stages = w4a8_stages(k)
    if n_splits is None:
        tail_from, n_splits = w4a8_splits(m, n, k, _sm_count(device))
    elif 1 <= n_splits <= stages:
        tail_from = 0
    else:
        raise ValueError(f"int4_matmul: n_splits must be in [1, {stages}], got {n_splits}")
    shape = W4A8Shape(m, n, k, n_splits, tail_from, chunks, rows, nt,
                      int(dtype == torch.bfloat16))
    # scratch: the rows' image and their int32 sums | sx | partials
    sx_at = chunks * stages * 2 * nt * 128 + -(-4 * m // 16) * 16
    part_at = sx_at + -(-4 * m // 16) * 16
    cols = n - tail_from * ROW_TILE
    total = part_at + (4 * n_splits * m * cols if n_splits > 1 else 0)
    return shape, ctypes.addressof(shape), total, sx_at, part_at


_SCRATCH: dict = {}


def _scratch(nbytes: int, x: torch.Tensor, stream: int) -> torch.Tensor:
    """The quantized rows', their scales' and the split partials' scratch:
    one byte buffer per (device, stream), grown when a call needs more. A
    call's launches write and read it in stream order, so later calls on
    the same stream may reuse it. Under CUDA graph capture each call
    allocates its own: a graph keeps the address it captured, which a
    grown (freed) cached buffer would not keep."""
    if torch.cuda.is_current_stream_capturing():
        return torch.empty((nbytes,), dtype=torch.uint8, device=x.device)
    key = (x.get_device(), stream)
    buf = _SCRATCH.get(key)
    if buf is None or buf.numel() < nbytes:
        buf = _SCRATCH[key] = torch.empty((nbytes,), dtype=torch.uint8, device=x.device)
    return buf


_SMS: dict = {}


def _sm_count(device: torch.device) -> int:
    if device.index not in _SMS:
        _SMS[device.index] = torch.cuda.get_device_properties(device).multi_processor_count
    return _SMS[device.index]


def kernel_splits(m: int, n: int, k: int, device: torch.device) -> tuple[int, int]:
    """(tail_from, n_splits) the wrapper launches for [m, k] x [n, k/2] on
    this card (w4a8_splits with its SM count)."""
    return w4a8_splits(m, n, k, _sm_count(device))


@dataclasses.dataclass
class W4A8Rows:
    """Activations quantized for :func:`int4_matmul` by :func:`w4a8_quantize`:
    ``xq`` the int8 rows [M, K] on the CPU; on the card the layout the
    kernel's bulk copies read and each row's int32 sum (csrc/w4a8.cu,
    ``quantize_image_kernel``). ``sx`` their f32 scales [M]."""

    xq: torch.Tensor
    sx: torch.Tensor


def _check_x(name: str, x2: torch.Tensor, n: int) -> None:
    _cuda.refuse_grad(name, x2)
    if x2.dtype not in (torch.bfloat16, torch.float32) or x2.shape[1] % 128 or n % 64:
        raise ValueError(f"{name}: kernel takes bf16/fp32 x with K % 128 == 0 and "
                         f"N % 64 == 0, got {x2.dtype} K={x2.shape[1]} N={n}")


def _aligned(x2: torch.Tensor) -> torch.Tensor:
    """x2 contiguous and 16-byte aligned, as the kernel's loads need."""
    x2 = x2.contiguous()
    return x2 if x2.data_ptr() % 16 == 0 else x2.clone()


def w4a8_quantize(x: torch.Tensor) -> W4A8Rows:
    """The row quantization of :func:`int4_matmul` alone (its first launch
    on the card, into a buffer of its own): rows for ``int4_matmul(x, w,
    rows=...)``, which then launches the GEMM alone."""
    x2 = x.reshape(-1, x.shape[-1])
    if x.device.type == "cpu":
        return W4A8Rows(*quantize_rows(x2))
    _check_x("w4a8_quantize", x2, 64)
    x2 = _aligned(x2)
    m, k = x2.shape
    shape, shape_ptr, _, sx_at, _ = _plan(m, 64, k, x.dtype, x.device, 1)
    rows = W4A8Rows(torch.empty((sx_at,), dtype=torch.int8, device=x.device),
                    torch.empty((m,), dtype=torch.float32, device=x.device))
    _cuda.check(_cuda.load().bd_w4a8_matmul(
        x2.data_ptr(), rows.xq.data_ptr(), rows.sx.data_ptr(), None, None, None, None,
        shape_ptr, _cuda.stream_ptr()), "w4a8_quantize")
    return rows


def int4_matmul(x: torch.Tensor, w: Q4Tensor, n_splits: int | None = None,
                rows: W4A8Rows | None = None) -> torch.Tensor:
    """x [..., K] @ unpack(q)*s .T with per-row int8 activations (W4A8);
    returns x's dtype. CPU tensors take :func:`int4_matmul_reference`; CUDA
    tensors run the kernel (bf16 or fp32 x, K % 128 == 0, N % 64 == 0) or
    raise. ``n_splits`` (1 to K / 128) overrides :func:`w4a8_splits` on the
    card; the CPU path has no splits. ``rows``, :func:`w4a8_quantize` of x,
    skips the row quantization (the card then launches the GEMM alone; x
    gives the shape and the output dtype)."""
    shape = x.shape
    n, kh = w.q.shape
    if shape[-1] != 2 * kh:
        raise ValueError(f"int4_matmul: x {tuple(shape)} vs packed weight "
                         f"{tuple(w.q.shape)}")
    if not x.is_cuda:
        if x.device.type != "cpu":
            raise RuntimeError(f"int4_matmul: no kernel for {x.device}")
        x2 = x.reshape(-1, shape[-1])
        xq, sx = (rows.xq, rows.sx) if rows is not None else quantize_rows(x2)
        out = int4_matmul_reference(xq, sx, w.q, w.s, x.dtype)
        return out.reshape(*shape[:-1], n)
    # a decode step's products are short, so the host does per call only
    # what the shapes do not settle (checked and planned once per shape)
    dev = x.get_device()
    key = (shape, x.dtype, dev, n, n_splits)
    call = _CALLS.get(key)
    if call is None:
        m = x.numel() // shape[-1]
        _check_x("int4_matmul", x.reshape(m, shape[-1]), n)
        call = _CALLS[key] = (m, *_plan(m, n, 2 * kh, x.dtype, x.device, n_splits))
    m, _, shape_ptr, nbytes, sx_at, part_at = call
    q, s = w.q, w.s
    if (q.dtype is not torch.int8 or s.dtype is not torch.float32 or not q.is_contiguous()
            or not s.is_contiguous() or q.get_device() != dev or s.get_device() != dev):
        raise ValueError(f"int4_matmul: weight q / s must be contiguous int8 / float32 "
                         f"on {x.device}, got {q.dtype} / {s.dtype}")
    if torch.is_grad_enabled() and x.requires_grad:
        _cuda.refuse_grad("int4_matmul", x)
    stream = _cuda.stream_ptr()
    base = _scratch(nbytes, x, stream).data_ptr()
    if rows is None:
        x2 = x                               # kept alive until the launch
        if not x.is_contiguous() or x.data_ptr() % 16:
            x2 = _aligned(x.reshape(m, shape[-1]))
        x_ptr, xi_ptr, sx_ptr = x2.data_ptr(), base, base + sx_at
    else:
        if rows.xq.numel() != sx_at or rows.sx.shape != (m,) or rows.xq.get_device() != dev:
            raise ValueError("int4_matmul: rows must be w4a8_quantize of an x of "
                             f"this shape on {x.device}")
        x_ptr, xi_ptr, sx_ptr = None, rows.xq.data_ptr(), rows.sx.data_ptr()
    out = x.new_empty((*shape[:-1], n))
    _cuda.check(_cuda.load().bd_w4a8_matmul(
        x_ptr, xi_ptr, sx_ptr, q.data_ptr(), s.data_ptr(), out.data_ptr(),
        base + part_at, shape_ptr, stream), "int4_matmul")
    int4_matmul.launches += 1
    return out


_CALLS: dict = {}
int4_matmul.launches = 0
