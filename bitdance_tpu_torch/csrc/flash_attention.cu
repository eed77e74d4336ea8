// Masked flash attention for training: forward, and the two backward kernels.
//
// Replaces the TPU kernels of bitdance_tpu/ops/attention.py behind
// flash_attention / _flash_core:
//   _flash_kernel          (pallas_call :285)  -> flash_fwd_kernel
//   _flash_bwd_dq_kernel   (pallas_call :456)  -> flash_bwd_dq_kernel
//   _flash_bwd_dkv_kernel  (pallas_call :474)  -> flash_bwd_dkv_kernel
// and, behind flash_attention_sparse / _flash_sparse_core, the same three
// kernels instantiated with kSparse = true:
//   _flash_kernel_sparse          (pallas_call :767)   forward
//   _flash_bwd_dq_kernel_sparse   (pallas_call :964)   dq
//   _flash_bwd_dkv_kernel_sparse  (pallas_call :1013)  dk/dv
//
// Mask model: every token carries (block_id, doc_id); query i sees key j iff
// doc_q[i] == doc_k[j] and block_k[j] <= block_q[i]. A row that sees no key
// gets output 0 and lse 1e30, so exp(s - lse) is 0 in the backward.
//
// What bounds it on the H100: at the ImageNet training shapes (B=16, H=20,
// L=319, D=64) one forward is ~8 GFLOP over ~26 MB of q/k/v/o, about 300
// FLOP per byte, right at the card's bf16 balance point; the kernels are
// small enough that tensor-core throughput, latency and the causal triangle's
// load imbalance decide, not bandwidth. The backward moves ~65 MB (dq) and
// ~79 MB (dk/dv) at that shape, 0.020 / 0.024 ms at 3.35 TB/s.
//
// Tensors stay in the model's [B, L, H, D] layout (no transposes); lse and
// delta are [B, Hq, Lq] fp32 (lse in the natural log). Ragged lengths are
// handled in the kernels: rows and keys past L are zero-filled by cp.async
// and masked out.
//
// One design for the forward, dq and dk/dv:
// - A block is one warpgroup owning 64 rows: one (q head, b, 64-row q tile)
//   for the forward and dq, with a loop over 64-key tiles; one (kv head, b,
//   64-key tile) for dk/dv, with a loop over the q heads of its GQA group
//   and their q tiles, so the group sum happens in registers. No atomics:
//   two launches give the same bits.
// - Live tiles decided up front. Each block computes the id ranges of every
//   tile it may visit once, classifies each pair dead, partial or full
//   (pair_class) and lists the live ones in ascending order in shared
//   memory; so the next live tile is known before its copy is issued, and a
//   full tile (every query sees every key) skips the per-element id
//   compares. Dense and sparse instantiations classify identically and
//   visit the same live tiles in the same order: the same bits.
// - A 2-stage cp.async ring. The fixed side (Q, with dO for dq; K and V for
//   dk/dv) is copied once; the other side's tiles (with their ids, and for
//   dk/dv the q rows' lse and delta) arrive in wgmma's 128-byte swizzle, the
//   next tile's copies in flight while the current tile's products run.
// - Products on wgmma (m64nNk16, bf16 in, fp32 accumulate). S = Q K^T and
//   dP = dO V^T (dk/dv: S^T = K Q^T, dP^T = V dO^T) read both operands
//   K-major from shared memory; P and dS stay in registers, rounded to bf16
//   as the A operand of O += P V (forward), dQ += dS K (dV += P^T dO,
//   dK += dS^T Q), whose B is the same tile read MN-major. Nothing is
//   gathered element by element.
// - The forward's softmax runs online in the log2 domain: per row the
//   running max m of the raw scores and p = exp2(s scale log2(e) - m scale
//   log2(e)), one FFMA and one ex2 an element; O is rescaled in registers
//   between a tile's two products, when no wgmma is in flight. The epilogue
//   divides by the row sum, stages O through shared memory for 16-byte
//   stores and writes lse = (m scale log2(e) + log2(l)) ln(2).
//   The backward's p = exp2(s scale log2(e) - lse log2(e)) reads that lse.
// - Load balance: the forward and dq issue the last q tiles (the heaviest
//   under a causal mask) first; dk/dv issues kv tile 0 (the heaviest) first.
//
// Sparse iteration (packed training, where most tiles are dead): the loop
// runs over a per-tile list of live tile indices built on the device
// (ops/attention.py::kv_tile_map), tile_map[b, i, 0:count[b, i]], instead of
// over every tile. Forward and dq read the per-q-tile list of 64-key tiles;
// dk/dv the transposed per-kv-tile list of 64-row q tiles. The dense
// kernels read every tile's ids (and the dead tiles' nothing else); the
// sparse ones only the listed tiles', so their work and traffic follow the
// live pairs. Each visited tile is classified and masked as in the dense
// kernels, so the outputs are the dense kernels'.
#include <climits>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;  // 4 warps: one warpgroup
constexpr int kBQ = 64;        // q rows per block (forward, dq); per q tile (dk/dv)
constexpr int kBK = 64;        // keys per tile; dk/dv: keys per block
constexpr float kNeg = -1e30f;
constexpr float kMaskedLse = 1e30f;
constexpr int kMaxSmem = 226 * 1024;  // dynamic shared memory a block may use
constexpr float kLn2 = 0.6931471805599453f;

// ---------------------------------------------------------------------------
// tile classes, the live-tile list, the swizzled tile copy
// ---------------------------------------------------------------------------
constexpr int kDead = 0, kPartial = 1, kFull = 2;

// {block min, block max, doc min, doc max} over the valid ids of
// [start, min(start + n, L)), n <= 64, computed by one warp; every lane
// returns it. With no valid id the block min is INT_MAX, so every pair with
// the tile is dead.
__device__ __forceinline__ int4 warp_id_range(const int* __restrict__ bid,
                                              const int* __restrict__ did, int start,
                                              int n, int L) {
  const int lane = threadIdx.x & 31;
  int bmin = INT_MAX, bmax = INT_MIN, dmin = INT_MAX, dmax = INT_MIN;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int off = lane + 32 * i, idx = start + off;
    if (off < n && idx < L) {
      const int bb = __ldg(bid + idx), dd = __ldg(did + idx);
      bmin = min(bmin, bb);
      bmax = max(bmax, bb);
      dmin = min(dmin, dd);
      dmax = max(dmax, dd);
    }
  }
  return make_int4(__reduce_min_sync(0xffffffffu, bmin), __reduce_max_sync(0xffffffffu, bmax),
                   __reduce_min_sync(0xffffffffu, dmin), __reduce_max_sync(0xffffffffu, dmax));
}

// A (q tile, kv tile) pair from the two tiles' ranges: dead when no query
// can see a key (the TPU kernel's test, attention.py:170-179, sound for
// unsorted ids), full when every query sees every key (both tiles inside L,
// every key block <= every query block, one doc id on both sides), else
// partial (ops/attention.py::tile_classes is the plain twin).
__device__ __forceinline__ int pair_class(int4 q, int4 k, bool whole) {
  if (k.x > q.y || k.z > q.w || k.w < q.z) return kDead;
  return whole && k.y <= q.x && q.z == q.w && k.z == k.w && q.z == k.z ? kFull : kPartial;
}

// The block's live tiles of the other side, classified against its own
// tile (range `own`; own_whole: it lies inside its L): candidate c is tile
// map[c] (sparse) or c (dense, map null), of kRows ids over [0, L) in
// (bid, did); kOwnIsQ: the block's own tile is the q side. Writes
// tile * 4 + class of the live ones to list[], in candidate order, and
// returns their count (every thread). One warp a candidate; warp 0 then
// compacts the list in place.
template <int kRows, bool kOwnIsQ>
__device__ int live_tiles(int4 own, bool own_whole, const int* __restrict__ bid,
                          const int* __restrict__ did, int L, const int* __restrict__ map,
                          int n_cand, int* list, int* count) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll 2
  for (int c = warp; c < n_cand; c += kThreads / 32) {
    const int t = map != nullptr ? map[c] : c;
    const int4 r = warp_id_range(bid, did, t * kRows, kRows, L);
    const bool whole = own_whole && (t + 1) * kRows <= L;
    if (lane == 0) list[c] = t * 4 + (kOwnIsQ ? pair_class(own, r, whole)
                                              : pair_class(r, own, whole));
  }
  __syncthreads();
  if (warp == 0) {
    int n = 0;
    for (int base = 0; base < n_cand; base += 32) {
      const int c = base + lane;
      const int e = c < n_cand ? list[c] : kDead;
      const bool live = (e & 3) != kDead;
      const unsigned mask = __ballot_sync(0xffffffffu, live);
      if (live) list[n + __popc(mask & ((1u << lane) - 1))] = e;  // at or before c
      n += __popc(mask);
      __syncwarp();
    }
    if (lane == 0) *count = n;
  }
  __syncthreads();
  return *count;
}

// rows [row0, row0 + R) of a [*, L, H, D] head view into a swizzled tile
// (common.cuh::swz<R>); rows past L are zero-filled. Starts cp.async
// copies (no commit).
template <int D, int R>
__device__ __forceinline__ void load_tile(unsigned char* dst, const bf16* src, int row0,
                                          int L, size_t stride) {
  constexpr int kChunks = D / 8;
  static_assert(R * kChunks % kThreads == 0, "whole copies a thread");
#pragma unroll
  for (int i = 0; i < R * kChunks / kThreads; ++i) {
    const int c = threadIdx.x + i * kThreads;
    const int r = c / kChunks, cc = c % kChunks;
    const int row = row0 + r;
    const bool ok = row < L;
    cp_async16(dst + swz<R>(r, cc), src + (size_t)(ok ? row : 0) * stride + cc * 8,
               ok ? 16 : 0);
  }
}

// kv tile t (rows [64 t, 64 t + 64) of the [*, Lk, Hkv, D] head views kh,
// vh) into a ring stage of the forward or dq: the K tile, the V tile, then
// the tile's 64 block ids and 64 doc ids (one id a thread). Starts cp.async
// copies (no commit).
template <int D>
__device__ __forceinline__ void load_kv_stage(unsigned char* slot, const bf16* kh, const bf16* vh,
                                              const int* kb, const int* kd, int t, int Lk,
                                              size_t stride) {
  static_assert(kThreads == 2 * kBK, "one id copy a thread");
  constexpr int kTile = kBK * D * 2;
  load_tile<D, kBK>(slot, kh, t * kBK, Lk, stride);
  load_tile<D, kBK>(slot + kTile, vh, t * kBK, Lk, stride);
  const int tid = threadIdx.x, key = t * kBK + (tid & (kBK - 1));
  const bool ok = key < Lk;
  cp_async4(reinterpret_cast<int*>(slot + 2 * kTile) + tid, (tid < kBK ? kb : kd) + (ok ? key : 0),
            ok ? 4 : 0);
}

// wgmma descriptors of a swizzled tile of kRows rows: K-major at k step kk
// (32 bytes a step inside a 128-byte row, then the next 64-column half),
// and MN-major at k step kk (16 rows a step; the halves as the leading
// offset, 8-row groups as the stride offset)
template <int kRows>
__device__ __forceinline__ uint64_t desc_k(uint32_t addr, int kk) {
  return gmma_desc(addr + (kk >> 2) * (kRows * 128) + (kk & 3) * 32, 16, 1024);
}
template <int kRows>
__device__ __forceinline__ uint64_t desc_mn(uint32_t addr, int kk) {
  return gmma_desc(addr + kk * 2048, kRows * 128, 1024);
}

// Shared memory of the kernels: the fixed tiles, then a 2-stage ring, each
// stage 1024-byte aligned, then the live-tile list (4 bytes a candidate),
// from a base aligned in 1024 bytes of slack. One tile is in flight while
// one is computed (a third stage measured no faster for dq). dq: the Q and
// dO tiles, then two stages of (K tile, V tile, the tile's 64 block and 64
// doc ids); the forward the same without dO.
template <int D>
struct DqSmem {
  static constexpr int kTile = kBK * D * 2;
  static constexpr int kStage = (2 * kTile + 2 * kBK * 4 + 1023) / 1024 * 1024;
  static constexpr int kFixed = 1024 + 2 * kTile + 2 * kStage;
};
template <int D>
struct FwdSmem {
  static constexpr int kTile = DqSmem<D>::kTile;
  static constexpr int kStage = DqSmem<D>::kStage;
  static constexpr int kFixed = 1024 + kTile + 2 * kStage;
};
// dk/dv: the K and V tiles, then two stages of (Q tile, dO tile, and the
// 64 q rows' lse, delta, block ids and doc ids)
template <int D>
struct DkvSmem {
  static constexpr int kKTile = kBK * D * 2;
  static constexpr int kQTile = kBQ * D * 2;
  static constexpr int kStage = (2 * kQTile + 4 * kBQ * 4 + 1023) / 1024 * 1024;
  static constexpr int kFixed = 1024 + 2 * kKTile + 2 * kStage;
};

// The warpgroup's 64 x D fp32 accumulator (C fragments) times `mul` as bf16
// rows [row0, row0 + 64) of a [*, L, H, D] head view (row stride `stride`),
// rows past L not written; 0 where `zero`. Staged through shared memory
// (`stage`, 64 rows of D * 2 + 16 bytes, free for it) so that the stores
// are 16 bytes a thread, whole rows a warp. Starts and ends with a barrier.
template <int D>
__device__ __forceinline__ void store_rows(const float (&acc)[D / 8][4], float mul, bool zero,
                                           unsigned char* stage, bf16* dst, int row0, int L,
                                           size_t stride) {
  constexpr int kPitch = D * 2 + 16;  // 16-byte pad: the fragment writes miss no bank twice
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tq = lane & 3;
  __syncthreads();  // the stage's bytes are read by nothing else now
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    unsigned char* row = stage + (warp * 16 + g + i * 8) * kPitch + tq * 4;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<uint32_t*>(row + n * 16) =
          zero ? 0u : pack_bf16x2(acc[n][2 * i] * mul, acc[n][2 * i + 1] * mul);
  }
  __syncthreads();
#pragma unroll
  for (int x = 0; x < 64 * (D / 8) / kThreads; ++x) {
    const int c = threadIdx.x + x * kThreads;
    const int r = c / (D / 8), cc = c % (D / 8);
    if (row0 + r < L)
      *reinterpret_cast<uint4*>(dst + (size_t)(row0 + r) * stride + cc * 8) =
          *reinterpret_cast<const uint4*>(stage + r * kPitch + cc * 16);
  }
}

// The forward's online softmax over one tile, from S (64 rows x 64 keys, C
// fragments): this thread's two rows' running max m (of the raw scores; kNeg
// while a row has seen no key) and partial sum l (over this thread's
// columns) move on, corr is the factor by which the rows' O must be
// rescaled, and p = exp2(s scale log2(e) - m scale log2(e)), 0 where masked
// (by a select after the exp), is rounded to bf16 as P V's A fragments.
// kMasked: a partial tile (ids = the tile's 64 block ids, then its 64 doc
// ids); a full tile compares no ids. Both run the same instructions on a
// visible p, so the dense and sparse kernels give the same bits.
template <bool kMasked>
__device__ __forceinline__ void fwd_p(uint32_t (&pa)[kBK / 16][4], const float (&s)[kBK / 8][4],
                                      const int* ids, float (&m)[2], float (&l)[2],
                                      float (&corr)[2], const int rb[2], const int rd[2],
                                      float scale_log2, int k0, int Lk, int tq) {
  uint32_t seen = 0;  // bit nt * 4 + i: s[nt][i] is visible (kMasked only)
  float mx[2] = {kNeg, kNeg};
#pragma unroll
  for (int nt = 0; nt < kBK / 8; ++nt) {
    const int c = nt * 8 + tq * 2;
    int2 kbp = make_int2(0, 0), kdp = make_int2(0, 0);
    if (kMasked) {
      kbp = *reinterpret_cast<const int2*>(ids + c);
      kdp = *reinterpret_cast<const int2*>(ids + kBK + c);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = i >> 1, odd = i & 1;
      const bool ok = !kMasked || (k0 + c + odd < Lk && (odd ? kdp.y : kdp.x) == rd[r] &&
                                   (odd ? kbp.y : kbp.x) <= rb[r]);
      if (kMasked) seen |= (ok ? 1u : 0u) << (nt * 4 + i);
      if (ok) mx[r] = fmaxf(mx[r], s[nt][i]);
    }
  }
  float neg_m2[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r]);
    const float m2 = __fmul_rn(m_new, scale_log2);
    // 1 while the max stands (a row that saw no key keeps kNeg), 0 for a
    // row's first visible key
    corr[r] = exp2_approx(__fsub_rn(__fmul_rn(m[r], scale_log2), m2));
    m[r] = m_new;
    neg_m2[r] = -m2;
    l[r] = __fmul_rn(l[r], corr[r]);
  }
#pragma unroll
  for (int nt = 0; nt < kBK / 8; ++nt) {
    float p[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = i >> 1;
      p[i] = exp2_approx(__fmaf_rn(s[nt][i], scale_log2, neg_m2[r]));
      if (kMasked && !(seen >> (nt * 4 + i) & 1u)) p[i] = 0.f;
      l[r] = __fadd_rn(l[r], p[i]);
    }
    pa[nt >> 1][(nt & 1) * 2] = pack_bf16x2(p[0], p[1]);
    pa[nt >> 1][(nt & 1) * 2 + 1] = pack_bf16x2(p[2], p[3]);
  }
}

// ---------------------------------------------------------------------------
// forward: o [B, Lq, Hq, D] bf16, lse [B, Hq, Lq] fp32 (natural log)
// grid (Hq, B, q tiles); the last q tile first
// ---------------------------------------------------------------------------
// At D 64 the registers are capped for 4 blocks an SM (128 a thread, a
// 20-byte spill; 144 uncapped gave 3 blocks and took 1.07x as long at the
// ImageNet shape). At D 128 shared memory (83 KB) allows 2 blocks an SM;
// the bound's 1 lets ptxas take 231 registers (182 without it, 1.03x as
// long at the packed 8,192-token case).
template <int D, bool kSparse>
__global__ void __launch_bounds__(kThreads, D == 64 ? 4 : 1)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ o,
                 float* __restrict__ lse, const int* __restrict__ qb,
                 const int* __restrict__ qd, const int* __restrict__ kb,
                 const int* __restrict__ kd, const int* __restrict__ tmap,
                 const int* __restrict__ tcnt, int S, int Lq, int Lk, int Hq,
                 int Hkv, float scale) {
  using Sm = FwdSmem<D>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* const smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* const ring = smem + Sm::kTile;
  int* const list = reinterpret_cast<int*>(ring + 2 * Sm::kStage);
  __shared__ int n_live_s;

  const int h = blockIdx.x, b = blockIdx.y, n_qt = gridDim.z;
  const int qt = n_qt - 1 - blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int q0 = qt * kBQ;
  const int* qb_b = qb + (size_t)b * Lq;
  const int* qd_b = qd + (size_t)b * Lq;
  const int* kb_b = kb + (size_t)b * Lk;
  const int* kd_b = kd + (size_t)b * Lk;
  const size_t q_stride = (size_t)Hq * D, kv_stride = (size_t)Hkv * D;
  const size_t q_head = ((size_t)b * Lq * Hq + h) * D;
  const bf16* kh = k + ((size_t)b * Lk * Hkv + hk) * D;
  const bf16* vh = v + ((size_t)b * Lk * Hkv + hk) * D;
  auto load_kv = [&](int t, int st) {
    load_kv_stage<D>(ring + st * Sm::kStage, kh, vh, kb_b, kd_b, t, Lk, kv_stride);
  };

  // The Q tile and the first candidate kv tile are in flight while the
  // candidates are classified, as in dq.
  const int* map = kSparse ? tmap + ((size_t)b * n_qt + qt) * S : nullptr;
  const int n_cand = kSparse ? tcnt[b * n_qt + qt] : (Lk + kBK - 1) / kBK;
  const int t_first = kSparse && n_cand > 0 ? map[0] : 0;
  load_tile<D, kBQ>(smem, q + q_head, q0, Lq, q_stride);
  if (n_cand > 0) load_kv(t_first, 0);
  cp_async_commit();
  const int n_live = live_tiles<kBK, true>(warp_id_range(qb_b, qd_b, q0, kBQ, Lq),
                                           q0 + kBQ <= Lq, kb_b, kd_b, Lk, map, n_cand, list,
                                           &n_live_s);
  if (n_live > 0 && list[0] >> 2 != t_first) {
    cp_async_wait<0>();  // this thread's copies into slot 0 have landed
    load_kv(list[0] >> 2, 0);
    cp_async_commit();
  }

  // this thread's two q rows (warp * 16 + g + 8 i); a row past Lq computes
  // on zeros and is not written
  int rb[2], rd[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + warp * 16 + g + i * 8;
    rb[i] = row < Lq ? qb_b[row] : 0;
    rd[i] = row < Lq ? qd_b[row] : 0;
  }
  const float scale_log2 = scale * kLog2e;
  const uint32_t q_addr = smem_u32(smem);

  // O is defined by the first P V wgmma (scale-d 0) and rescaled between
  // tiles only after the wait, before the next fence (no wgmma in flight)
  float acc[D / 8][4];
  float s[kBK / 8][4];
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};
  for (int j = 0; j < n_live; ++j) {
    cp_async_wait<0>();
    fence_async_shared();  // this thread's copies, to wgmma
    // tile j (and on the first pass Q) has landed; every warp is done with
    // tile j - 1, whose slot takes tile j + 1
    __syncthreads();
    if (j + 1 < n_live) load_kv(list[j + 1] >> 2, (j + 1) & 1);
    cp_async_commit();
    const int e = list[j];
    const unsigned char* slot = ring + (j & 1) * Sm::kStage;
    const uint32_t k_addr = smem_u32(slot), v_addr = k_addr + Sm::kTile;

    // S = Q K^T: 64 q rows x 64 keys
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss(s, desc_k<kBQ>(q_addr, kk), desc_k<kBK>(k_addr, kk), kk > 0);
    wgmma_commit_wait();

    uint32_t pa[kBK / 16][4];
    float corr[2];
    const int* ids = reinterpret_cast<const int*>(slot + 2 * Sm::kTile);
    if ((e & 3) == kFull)
      fwd_p<false>(pa, s, ids, m, l, corr, rb, rd, scale_log2, (e >> 2) * kBK, Lk, tq);
    else
      fwd_p<true>(pa, s, ids, m, l, corr, rb, rd, scale_log2, (e >> 2) * kBK, Lk, tq);
    if (j > 0) {
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        acc[n][0] = __fmul_rn(acc[n][0], corr[0]);
        acc[n][1] = __fmul_rn(acc[n][1], corr[0]);
        acc[n][2] = __fmul_rn(acc[n][2], corr[1]);
        acc[n][3] = __fmul_rn(acc[n][3], corr[1]);
      }
    }

    // O += P V: V read MN-major
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
      wgmma_rs_mn(acc, pa[kk], desc_mn<kBK>(v_addr, kk), j > 0 || kk > 0);
    wgmma_commit_wait();
  }
  cp_async_wait<0>();  // no copy may outlive the block

  // the rows' sums over the quad; o = O / l (0 where a row saw no key) and
  // lse = (m scale log2(e) + log2(l)) ln(2) (1e30 there)
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float lt = l[i];
    lt = __fadd_rn(lt, __shfl_xor_sync(0xffffffffu, lt, 1));
    lt = __fadd_rn(lt, __shfl_xor_sync(0xffffffffu, lt, 2));
    const float inv = lt > 0.f ? __fdiv_rn(1.f, lt) : 0.f;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      acc[n][2 * i] = __fmul_rn(acc[n][2 * i], inv);
      acc[n][2 * i + 1] = __fmul_rn(acc[n][2 * i + 1], inv);
    }
    const int row = q0 + warp * 16 + g + i * 8;
    if (tq == 0 && row < Lq)
      lse[((size_t)b * Hq + h) * Lq + row] =
          lt > 0.f ? __fmul_rn(__fadd_rn(__fmul_rn(m[i], scale_log2), log2f(lt)), kLn2)
                   : kMaskedLse;
  }
  // staged where Q and the ring were (0 where no tile was live: acc was
  // never written)
  static_assert(64 * (D * 2 + 16) <= Sm::kTile + 2 * Sm::kStage, "staging fits");
  store_rows<D>(acc, 1.f, n_live == 0, smem, o + q_head, q0, Lq, q_stride);
}

// dq's p and ds for one tile, from S and dP (64 rows x 64 keys, C
// fragments): p = exp2(s scale log2(e) - lse log2(e)), zero where masked
// (kMasked: a partial tile; ids = the tile's 64 block ids, then its 64 doc
// ids), ds = p (dp - delta), rounded to bf16 as dQ's A fragments
template <bool kMasked>
__device__ __forceinline__ void dq_ds(uint32_t (&dsa)[kBK / 16][4], const float (&s)[kBK / 8][4],
                                      const float (&dp)[kBK / 8][4], const int* ids,
                                      const float lse2[2], const float dl[2], const int rb[2],
                                      const int rd[2], float scale_log2, int k0, int Lk,
                                      int tq) {
#pragma unroll
  for (int nt = 0; nt < kBK / 8; ++nt) {
    const int c = nt * 8 + tq * 2;
    int2 kbp = make_int2(0, 0), kdp = make_int2(0, 0);
    if (kMasked) {
      kbp = *reinterpret_cast<const int2*>(ids + c);
      kdp = *reinterpret_cast<const int2*>(ids + kBK + c);
    }
    float ds[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = i >> 1, odd = i & 1;
      float p = exp2_approx(__fmaf_rn(s[nt][i], scale_log2, -lse2[r]));
      if (kMasked && !(k0 + c + odd < Lk && (odd ? kdp.y : kdp.x) == rd[r] &&
                       (odd ? kbp.y : kbp.x) <= rb[r]))
        p = 0.f;
      ds[i] = __fmul_rn(p, __fsub_rn(dp[nt][i], dl[r]));
    }
    dsa[nt >> 1][(nt & 1) * 2] = pack_bf16x2(ds[0], ds[1]);
    dsa[nt >> 1][(nt & 1) * 2 + 1] = pack_bf16x2(ds[2], ds[3]);
  }
}

// dk/dv's p and ds for one item, from S^T and dP^T (64 keys x 64 q rows):
// f = the stage's lse, delta, block ids and doc ids of the q rows; P^T and
// dS^T rounded to bf16 as dV's and dK's A fragments
template <bool kMasked>
__device__ __forceinline__ void dkv_ds(uint32_t (&pa)[kBQ / 16][4], uint32_t (&sa)[kBQ / 16][4],
                                       const float (&s)[kBQ / 8][4], const float (&dp)[kBQ / 8][4],
                                       const float* f, const int kbr[2], const int kdr[2],
                                       float scale_log2, int q0, int Lq, int tq) {
  const int* qb_s = reinterpret_cast<const int*>(f + 2 * kBQ);
  const int* qd_s = qb_s + kBQ;
#pragma unroll
  for (int nt = 0; nt < kBQ / 8; ++nt) {
    const int c = nt * 8 + tq * 2;
    const float2 ls = *reinterpret_cast<const float2*>(f + c);
    const float2 dl = *reinterpret_cast<const float2*>(f + kBQ + c);
    int2 qbp = make_int2(0, 0), qdp = make_int2(0, 0);
    if (kMasked) {
      qbp = *reinterpret_cast<const int2*>(qb_s + c);
      qdp = *reinterpret_cast<const int2*>(qd_s + c);
    }
    float p[4], ds[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = i >> 1, odd = i & 1;
      const float lse2 = __fmul_rn(odd ? ls.y : ls.x, kLog2e);
      float pv = exp2_approx(__fmaf_rn(s[nt][i], scale_log2, -lse2));
      if (kMasked && !(q0 + c + odd < Lq && (odd ? qdp.y : qdp.x) == kdr[r] &&
                       kbr[r] <= (odd ? qbp.y : qbp.x)))
        pv = 0.f;
      p[i] = pv;
      ds[i] = __fmul_rn(pv, __fsub_rn(dp[nt][i], odd ? dl.y : dl.x));
    }
    pa[nt >> 1][(nt & 1) * 2] = pack_bf16x2(p[0], p[1]);
    pa[nt >> 1][(nt & 1) * 2 + 1] = pack_bf16x2(p[2], p[3]);
    sa[nt >> 1][(nt & 1) * 2] = pack_bf16x2(ds[0], ds[1]);
    sa[nt >> 1][(nt & 1) * 2 + 1] = pack_bf16x2(ds[2], ds[3]);
  }
}

// ---------------------------------------------------------------------------
// backward dq: p = exp(s - lse), ds = p (dp - delta), dq = scale * ds K
// grid (Hq, B, q tiles); the last q tile first
// ---------------------------------------------------------------------------
template <int D, bool kSparse>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, bf16* __restrict__ dq,
                    const int* __restrict__ qb, const int* __restrict__ qd,
                    const int* __restrict__ kb, const int* __restrict__ kd,
                    const int* __restrict__ tmap, const int* __restrict__ tcnt,
                    int S, int Lq, int Lk, int Hq, int Hkv, float scale) {
  using Sm = DqSmem<D>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* const smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* const ring = smem + 2 * Sm::kTile;
  int* const list = reinterpret_cast<int*>(ring + 2 * Sm::kStage);
  __shared__ int n_live_s;

  const int h = blockIdx.x, b = blockIdx.y, n_qt = gridDim.z;
  const int qt = n_qt - 1 - blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int q0 = qt * kBQ;
  const int* qb_b = qb + (size_t)b * Lq;
  const int* qd_b = qd + (size_t)b * Lq;
  const int* kb_b = kb + (size_t)b * Lk;
  const int* kd_b = kd + (size_t)b * Lk;
  const size_t q_stride = (size_t)Hq * D, kv_stride = (size_t)Hkv * D;
  const size_t q_head = ((size_t)b * Lq * Hq + h) * D;
  const bf16* kh = k + ((size_t)b * Lk * Hkv + hk) * D;
  const bf16* vh = v + ((size_t)b * Lk * Hkv + hk) * D;
  auto load_kv = [&](int t, int st) {
    load_kv_stage<D>(ring + st * Sm::kStage, kh, vh, kb_b, kd_b, t, Lk, kv_stride);
  };

  // The block's Q and dO tiles and the first candidate kv tile are in
  // flight while the candidates are classified (under a causal mask the
  // first one is live); if it is not the first live tile, the live one is
  // copied over it once it has landed.
  const int* map = kSparse ? tmap + ((size_t)b * n_qt + qt) * S : nullptr;
  const int n_cand = kSparse ? tcnt[b * n_qt + qt] : (Lk + kBK - 1) / kBK;
  const int t_first = kSparse && n_cand > 0 ? map[0] : 0;
  load_tile<D, kBQ>(smem, q + q_head, q0, Lq, q_stride);
  load_tile<D, kBQ>(smem + Sm::kTile, dout + q_head, q0, Lq, q_stride);
  if (n_cand > 0) load_kv(t_first, 0);
  cp_async_commit();
  const int n_live = live_tiles<kBK, true>(warp_id_range(qb_b, qd_b, q0, kBQ, Lq),
                                           q0 + kBQ <= Lq, kb_b, kd_b, Lk, map, n_cand, list,
                                           &n_live_s);
  if (n_live > 0 && list[0] >> 2 != t_first) {
    cp_async_wait<0>();  // this thread's copies into slot 0 have landed
    load_kv(list[0] >> 2, 0);
    cp_async_commit();
  }

  // this thread's two q rows (warp * 16 + g + 8 i): ids, lse in the log2
  // domain and delta; a row past Lq gets lse 1e30, so its p is 0
  int rb[2], rd[2];
  float lse2[2], dl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + warp * 16 + g + i * 8;
    const bool ok = row < Lq;
    const size_t at = ((size_t)b * Hq + h) * Lq + (ok ? row : 0);
    rb[i] = ok ? qb_b[row] : 0;
    rd[i] = ok ? qd_b[row] : 0;
    lse2[i] = ok ? __fmul_rn(lse[at], kLog2e) : kMaskedLse;
    dl[i] = ok ? delta[at] : 0.f;
  }
  const float scale_log2 = scale * kLog2e;
  const uint32_t q_addr = smem_u32(smem), do_addr = q_addr + Sm::kTile;

  // no instruction but a wgmma defines the accumulators (ptxas would
  // serialize every wgmma): each product's first wgmma overwrites them
  float acc[D / 8][4];
  float s[kBK / 8][4], dp[kBK / 8][4];
  for (int j = 0; j < n_live; ++j) {
    cp_async_wait<0>();
    fence_async_shared();  // this thread's copies, to wgmma
    // tile j (and on the first pass Q, dO) has landed; every warp is done
    // with tile j - 1, whose slot takes tile j + 1
    __syncthreads();
    if (j + 1 < n_live) load_kv(list[j + 1] >> 2, (j + 1) & 1);
    cp_async_commit();
    const int e = list[j];
    const unsigned char* slot = ring + (j & 1) * Sm::kStage;
    const uint32_t k_addr = smem_u32(slot), v_addr = k_addr + Sm::kTile;

    // S = Q K^T and dP = dO V^T: 64 q rows x 64 keys
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss(s, desc_k<kBQ>(q_addr, kk), desc_k<kBK>(k_addr, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss(dp, desc_k<kBQ>(do_addr, kk), desc_k<kBK>(v_addr, kk), kk > 0);
    wgmma_commit_wait();

    uint32_t dsa[kBK / 16][4];
    const int* ids = reinterpret_cast<const int*>(slot + 2 * Sm::kTile);
    if ((e & 3) == kFull)
      dq_ds<false>(dsa, s, dp, ids, lse2, dl, rb, rd, scale_log2, (e >> 2) * kBK, Lk, tq);
    else
      dq_ds<true>(dsa, s, dp, ids, lse2, dl, rb, rd, scale_log2, (e >> 2) * kBK, Lk, tq);

    // dQ += dS K: K read MN-major
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
      wgmma_rs_mn(acc, dsa[kk], desc_mn<kBK>(k_addr, kk), j > 0 || kk > 0);
    wgmma_commit_wait();
  }
  cp_async_wait<0>();  // no copy may outlive the block
  // dq = scale dQ (0 where no tile was live: acc was never written),
  // staged where Q and dO were
  static_assert(64 * (D * 2 + 16) <= 2 * Sm::kTile, "staging fits");
  store_rows<D>(acc, scale, n_live == 0, smem, dq + q_head, q0, Lq, q_stride);
}

// ---------------------------------------------------------------------------
// backward dk/dv: summed over the q heads of the GQA group in registers
//   dv = sum_h P^T dO,  dk = scale * sum_h dS^T Q
// grid (Hkv, B, kv tiles); kv tile 0 first
// ---------------------------------------------------------------------------
// At D 64 the registers are capped for 3 blocks an SM (168 a thread; 204
// uncapped gave 2 blocks and took 1.16x as long at the ImageNet shape). At
// D 128 a block takes 255 (2 an SM): 64-row q tiles there took 0.82x the
// time of 32-row ones, whose S^T and dP^T are half as wide.
template <int D, bool kSparse>
__global__ void __launch_bounds__(kThreads, D == 64 ? 3 : 1)
flash_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, bf16* __restrict__ dk,
                     bf16* __restrict__ dv, const int* __restrict__ qb,
                     const int* __restrict__ qd, const int* __restrict__ kb,
                     const int* __restrict__ kd, const int* __restrict__ tmap,
                     const int* __restrict__ tcnt, int S, int Lq, int Lk,
                     int Hq, int Hkv, float scale) {
  using Sm = DkvSmem<D>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* const smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* const ring = smem + 2 * Sm::kKTile;
  int* const list = reinterpret_cast<int*>(ring + 2 * Sm::kStage);
  __shared__ int n_live_s;

  const int hk = blockIdx.x, b = blockIdx.y, kt = blockIdx.z, n_kt = gridDim.z;
  const int group = Hq / Hkv;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int k0 = kt * kBK;
  const int* qb_b = qb + (size_t)b * Lq;
  const int* qd_b = qd + (size_t)b * Lq;
  const int* kb_b = kb + (size_t)b * Lk;
  const int* kd_b = kd + (size_t)b * Lk;
  const size_t q_stride = (size_t)Hq * D, kv_stride = (size_t)Hkv * D;
  const size_t kv_head = ((size_t)b * Lk * Hkv + hk) * D;
  // q tile t of q head h into ring slot st: the Q and dO tiles, then its
  // rows' lse, delta, block ids and doc ids
  auto load_q = [&](int t, int h, int st) {
    unsigned char* slot = ring + st * Sm::kStage;
    const size_t q_head = ((size_t)b * Lq * Hq + h) * D;
    load_tile<D, kBQ>(slot, q + q_head, t * kBQ, Lq, q_stride);
    load_tile<D, kBQ>(slot + Sm::kQTile, dout + q_head, t * kBQ, Lq, q_stride);
    int* f = reinterpret_cast<int*>(slot + 2 * Sm::kQTile);
    const size_t row_h = ((size_t)b * Hq + h) * Lq;
#pragma unroll
    for (int x = 0; x < 4 * kBQ / kThreads; ++x) {
      const int i = tid + x * kThreads;
      const int arr = i / kBQ, row = t * kBQ + i % kBQ;
      const bool ok = row < Lq;
      const int* src = arr == 0 ? reinterpret_cast<const int*>(lse + row_h)
                     : arr == 1 ? reinterpret_cast<const int*>(delta + row_h)
                     : arr == 2 ? qb_b : qd_b;
      cp_async4(f + i, src + (ok ? row : 0), ok ? 4 : 0);
    }
  };

  // The block's K and V tiles and the first candidate q tile of the
  // group's first head are in flight while the candidates are classified
  // (see the dq kernel).
  const int* map = kSparse ? tmap + ((size_t)b * n_kt + kt) * S : nullptr;
  const int n_cand = kSparse ? tcnt[b * n_kt + kt] : (Lq + kBQ - 1) / kBQ;
  const int t_first = kSparse && n_cand > 0 ? map[0] : 0;
  load_tile<D, kBK>(smem, k + kv_head, k0, Lk, kv_stride);
  load_tile<D, kBK>(smem + Sm::kKTile, v + kv_head, k0, Lk, kv_stride);
  if (n_cand > 0) load_q(t_first, hk * group, 0);
  cp_async_commit();
  const int n_live = live_tiles<kBQ, false>(warp_id_range(kb_b, kd_b, k0, kBK, Lk),
                                           k0 + kBK <= Lk, qb_b, qd_b, Lq, map, n_cand, list,
                                           &n_live_s);
  if (n_live > 0 && list[0] >> 2 != t_first) {
    cp_async_wait<0>();
    load_q(list[0] >> 2, hk * group, 0);
    cp_async_commit();
  }
  const int n_items = group * n_live;  // item j: q head j / n_live, tile j % n_live

  // this thread's two keys (warp * 16 + g + 8 i)
  int kbr[2], kdr[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = k0 + warp * 16 + g + i * 8;
    kbr[i] = key < Lk ? kb_b[key] : 0;
    kdr[i] = key < Lk ? kd_b[key] : 0;
  }
  const float scale_log2 = scale * kLog2e;
  const uint32_t k_addr = smem_u32(smem), v_addr = k_addr + Sm::kKTile;

  // accumulators defined by wgmmas only (see the dq kernel)
  float dka[D / 8][4], dva[D / 8][4];
  float s[kBQ / 8][4], dp[kBQ / 8][4];
  for (int j = 0; j < n_items; ++j) {
    cp_async_wait<0>();
    fence_async_shared();
    __syncthreads();  // item j (and on the first pass K, V) has landed
    if (j + 1 < n_items) {
      const int gh = (j + 1) / n_live;
      load_q(list[j + 1 - gh * n_live] >> 2, hk * group + gh, (j + 1) & 1);
    }
    cp_async_commit();
    const int e = list[j % n_live];
    const unsigned char* slot = ring + (j & 1) * Sm::kStage;
    const uint32_t qs_addr = smem_u32(slot), do_addr = qs_addr + Sm::kQTile;

    // S^T = K Q^T and dP^T = V dO^T: 64 keys x kBQ q rows
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss(s, desc_k<kBK>(k_addr, kk), desc_k<kBQ>(qs_addr, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss(dp, desc_k<kBK>(v_addr, kk), desc_k<kBQ>(do_addr, kk), kk > 0);
    wgmma_commit_wait();

    uint32_t pa[kBQ / 16][4], sa[kBQ / 16][4];
    const float* f = reinterpret_cast<const float*>(slot + 2 * Sm::kQTile);
    if ((e & 3) == kFull)
      dkv_ds<false>(pa, sa, s, dp, f, kbr, kdr, scale_log2, (e >> 2) * kBQ, Lq, tq);
    else
      dkv_ds<true>(pa, sa, s, dp, f, kbr, kdr, scale_log2, (e >> 2) * kBQ, Lq, tq);

    // dV += P^T dO and dK += dS^T Q: dO and Q read MN-major
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBQ / 16; ++kk) {
      wgmma_rs_mn(dva, pa[kk], desc_mn<kBQ>(do_addr, kk), j > 0 || kk > 0);
      wgmma_rs_mn(dka, sa[kk], desc_mn<kBQ>(qs_addr, kk), j > 0 || kk > 0);
    }
    wgmma_commit_wait();
  }
  cp_async_wait<0>();  // no copy may outlive the block
  // dk = scale dK, dv = dV (0 where no item was live), staged where K, V
  // and the ring were
  static_assert(2 * 64 * (D * 2 + 16) <= 2 * Sm::kKTile + 2 * Sm::kStage, "staging fits");
  store_rows<D>(dka, scale, n_items == 0, smem, dk + kv_head, k0, Lk, kv_stride);
  store_rows<D>(dva, 1.f, n_items == 0, smem + 64 * (D * 2 + 16), dv + kv_head, k0, Lk,
                kv_stride);
}

// MaxDynamicSharedMemorySize of a kernel at its most, once per device (bit
// per device in `done`, one per instantiation)
template <typename Kernel>
cudaError_t allow_smem_once(Kernel kernel, unsigned& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < 32 && (done >> dev & 1u))) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (err == cudaSuccess && dev < 32) done |= 1u << dev;
  return err;
}

bool bad_shape(int B, int Lq, int Lk, int Hq, int Hkv, int D) {
  return B <= 0 || Lq <= 0 || Lk <= 0 || Hkv <= 0 || Hq % Hkv != 0 ||
         (D != 64 && D != 128) || B > 65535 || Hq > 65535 ||
         Lq > 64 * 65535 || Lk > 64 * 65535;
}

// The tile list of a sparse launch: tmap [B, n_tiles, S] int32 (tile
// indices, ascending; entries past the count are not read) and tcnt
// [B, n_tiles] int32, n_tiles the launch's q tiles (forward, dq) or kv
// tiles (dk/dv). Dense launches pass null.
struct TileList {
  const int* map;
  const int* cnt;
  int S;
};

template <int D, bool kSparse>
int launch_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
               const void* qb, const void* qd, const void* kb, const void* kd,
               TileList tl, int B, int Lq, int Lk, int Hq, int Hkv, float scale,
               cudaStream_t st) {
  const int n_list = kSparse ? tl.S : (Lk + kBK - 1) / kBK;
  const int smem = FwdSmem<D>::kFixed + 4 * n_list;
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  auto kern = flash_fwd_kernel<D, kSparse>;
  static unsigned done = 0;
  cudaError_t e = allow_smem_once(kern, done);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid(Hq, B, (Lq + kBQ - 1) / kBQ);
  kern<<<grid, kThreads, smem, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o),
      static_cast<float*>(lse), static_cast<const int*>(qb),
      static_cast<const int*>(qd), static_cast<const int*>(kb),
      static_cast<const int*>(kd), tl.map, tl.cnt, tl.S, Lq, Lk, Hq, Hkv,
      scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D, bool kSparse>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dq, const void* qb,
              const void* qd, const void* kb, const void* kd, TileList tl,
              int B, int Lq, int Lk, int Hq, int Hkv, float scale,
              cudaStream_t st) {
  const int n_list = kSparse ? tl.S : (Lk + kBK - 1) / kBK;
  const int smem = DqSmem<D>::kFixed + 4 * n_list;
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  auto kern = flash_bwd_dq_kernel<D, kSparse>;
  static unsigned done = 0;
  cudaError_t e = allow_smem_once(kern, done);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid(Hq, B, (Lq + kBQ - 1) / kBQ);
  kern<<<grid, kThreads, smem, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dq), static_cast<const int*>(qb),
      static_cast<const int*>(qd), static_cast<const int*>(kb),
      static_cast<const int*>(kd), tl.map, tl.cnt, tl.S, Lq, Lk, Hq, Hkv,
      scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D, bool kSparse>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, void* dk, void* dv,
               const void* qb, const void* qd, const void* kb, const void* kd,
               TileList tl, int B, int Lq, int Lk, int Hq, int Hkv, float scale,
               cudaStream_t st) {
  const int n_list = kSparse ? tl.S : (Lq + kBQ - 1) / kBQ;
  const int smem = DkvSmem<D>::kFixed + 4 * n_list;
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  auto kern = flash_bwd_dkv_kernel<D, kSparse>;
  static unsigned done = 0;
  cudaError_t e = allow_smem_once(kern, done);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid(Hkv, B, (Lk + kBK - 1) / kBK);
  kern<<<grid, kThreads, smem, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv),
      static_cast<const int*>(qb), static_cast<const int*>(qd),
      static_cast<const int*>(kb), static_cast<const int*>(kd), tl.map,
      tl.cnt, tl.S, Lq, Lk, Hq, Hkv, scale);
  return static_cast<int>(cudaGetLastError());
}

template <bool kSparse>
int run_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
        const void* qb, const void* qd, const void* kb, const void* kd,
        TileList tl, int B, int Lq, int Lk, int Hq, int Hkv, int D,
        float scale, void* stream) {
  if (bad_shape(B, Lq, Lk, Hq, Hkv, D))
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  return D == 64 ? launch_fwd<64, kSparse>(q, k, v, o, lse, qb, qd, kb, kd, tl,
                                           B, Lq, Lk, Hq, Hkv, scale, st)
                 : launch_fwd<128, kSparse>(q, k, v, o, lse, qb, qd, kb, kd,
                                            tl, B, Lq, Lk, Hq, Hkv, scale, st);
}

template <bool kSparse>
int run_dq(const void* q, const void* k, const void* v, const void* dout,
       const void* lse, const void* delta, void* dqp, const void* qb,
       const void* qd, const void* kb, const void* kd, TileList tl, int B,
       int Lq, int Lk, int Hq, int Hkv, int D, float scale, void* stream) {
  if (bad_shape(B, Lq, Lk, Hq, Hkv, D))
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  return D == 64 ? launch_dq<64, kSparse>(q, k, v, dout, lse, delta, dqp, qb,
                                          qd, kb, kd, tl, B, Lq, Lk, Hq, Hkv,
                                          scale, st)
                 : launch_dq<128, kSparse>(q, k, v, dout, lse, delta, dqp, qb,
                                           qd, kb, kd, tl, B, Lq, Lk, Hq, Hkv,
                                           scale, st);
}

template <bool kSparse>
int run_dkv(const void* q, const void* k, const void* v, const void* dout,
        const void* lse, const void* delta, void* dk, void* dv, const void* qb,
        const void* qd, const void* kb, const void* kd, TileList tl, int B,
        int Lq, int Lk, int Hq, int Hkv, int D, float scale, void* stream) {
  if (bad_shape(B, Lq, Lk, Hq, Hkv, D))
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  return D == 64 ? launch_dkv<64, kSparse>(q, k, v, dout, lse, delta, dk, dv,
                                           qb, qd, kb, kd, tl, B, Lq, Lk, Hq,
                                           Hkv, scale, st)
                 : launch_dkv<128, kSparse>(q, k, v, dout, lse, delta, dk, dv,
                                            qb, qd, kb, kd, tl, B, Lq, Lk, Hq,
                                            Hkv, scale, st);
}

}  // namespace

// q [B,Lq,Hq,D], k/v [B,Lk,Hkv,D] bf16 contiguous; ids [B,L] int32.
// Writes o like q and lse [B,Hq,Lq] fp32. Returns cudaGetLastError().
extern "C" int bd_flash_fwd(const void* q, const void* k, const void* v,
                            void* o, void* lse, const void* qb, const void* qd,
                            const void* kb, const void* kd, int B, int Lq,
                            int Lk, int Hq, int Hkv, int D, float scale,
                            void* stream) {
  return run_fwd<false>(q, k, v, o, lse, qb, qd, kb, kd, TileList{nullptr, nullptr, 0},
                    B, Lq, Lk, Hq, Hkv, D, scale, stream);
}

// dout like q; lse, delta [B,Hq,Lq] fp32. Writes dq like q.
extern "C" int bd_flash_bwd_dq(const void* q, const void* k, const void* v,
                               const void* dout, const void* lse,
                               const void* delta, void* dq, const void* qb,
                               const void* qd, const void* kb, const void* kd,
                               int B, int Lq, int Lk, int Hq, int Hkv, int D,
                               float scale, void* stream) {
  return run_dq<false>(q, k, v, dout, lse, delta, dq, qb, qd, kb, kd,
                     TileList{nullptr, nullptr, 0}, B, Lq, Lk, Hq, Hkv, D,
                     scale, stream);
}

// Writes dk, dv like k (bf16), each summed over its GQA group of q heads.
extern "C" int bd_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* delta, void* dk, void* dv,
                                const void* qb, const void* qd, const void* kb,
                                const void* kd, int B, int Lq, int Lk, int Hq,
                                int Hkv, int D, float scale, void* stream) {
  return run_dkv<false>(q, k, v, dout, lse, delta, dk, dv, qb, qd, kb, kd,
                    TileList{nullptr, nullptr, 0}, B, Lq, Lk, Hq, Hkv, D,
                    scale, stream);
}

// The sparse entries take the same tensors plus a tile list: tmap
// [B, ceil(Lq/64), S] and tcnt [B, ceil(Lq/64)] of 64-key tiles (forward,
// dq); for dk/dv tmap [B, ceil(Lk/64), S] and tcnt [B, ceil(Lk/64)] of
// 64-row q tiles.
extern "C" int bd_flash_fwd_sparse(const void* q, const void* k, const void* v,
                                   void* o, void* lse, const void* qb,
                                   const void* qd, const void* kb,
                                   const void* kd, const void* tmap,
                                   const void* tcnt, int S, int B, int Lq,
                                   int Lk, int Hq, int Hkv, int D, float scale,
                                   void* stream) {
  return run_fwd<true>(q, k, v, o, lse, qb, qd, kb, kd,
                   TileList{static_cast<const int*>(tmap),
                            static_cast<const int*>(tcnt), S},
                   B, Lq, Lk, Hq, Hkv, D, scale, stream);
}

extern "C" int bd_flash_bwd_dq_sparse(const void* q, const void* k,
                                      const void* v, const void* dout,
                                      const void* lse, const void* delta,
                                      void* dqp, const void* qb, const void* qd,
                                      const void* kb, const void* kd,
                                      const void* tmap, const void* tcnt,
                                      int S, int B, int Lq, int Lk, int Hq,
                                      int Hkv, int D, float scale,
                                      void* stream) {
  return run_dq<true>(q, k, v, dout, lse, delta, dqp, qb, qd, kb, kd,
                    TileList{static_cast<const int*>(tmap),
                             static_cast<const int*>(tcnt), S},
                    B, Lq, Lk, Hq, Hkv, D, scale, stream);
}

extern "C" int bd_flash_bwd_dkv_sparse(const void* q, const void* k,
                                       const void* v, const void* dout,
                                       const void* lse, const void* delta,
                                       void* dk, void* dv, const void* qb,
                                       const void* qd, const void* kb,
                                       const void* kd, const void* tmap,
                                       const void* tcnt, int S, int B, int Lq,
                                       int Lk, int Hq, int Hkv, int D,
                                       float scale, void* stream) {
  return run_dkv<true>(q, k, v, dout, lse, delta, dk, dv, qb, qd, kb, kd,
                   TileList{static_cast<const int*>(tmap),
                            static_cast<const int*>(tcnt), S},
                   B, Lq, Lk, Hq, Hkv, D, scale, stream);
}
