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
// load imbalance decide, not bandwidth.
//
// Design: tensors stay in the model's [B, L, H, D] layout (no transposes);
// lse and delta are [B, Hq, Lq] fp32. A block is 4 warps. Forward and dq:
// one (b, q head, 64-row q tile) per block, each warp owning 16 rows, a loop
// over 64-key tiles in place of the TPU's sequential grid axis. dk/dv: one
// (b, kv head, 64-key tile) per block, each warp owning 16 keys, a loop over
// the q heads of its GQA group and their q tiles, so the group sum happens in
// registers and no [B, Hq, Lk, D] temporary exists. Products run on the
// tensor cores (mma.sync m16n8k16, bf16 in, fp32 accumulate); P and dS are
// rounded to bf16 as product operands, softmax statistics stay fp32. A tile
// is skipped with the TPU kernel's conservative test (min key block > max
// query block, or disjoint doc ranges), which holds for unsorted ids. Ragged
// lengths are handled in the kernel: rows and keys past L are zero-filled by
// cp.async and masked out.
//
// Sparse iteration (packed training, where most tiles are dead): the loop
// runs over a per-tile list of live tile indices built on the device
// (ops/attention.py::kv_tile_map), tile_map[b, i, 0:count[b, i]], instead of
// over every tile with a skip. Forward and dq read the per-q-tile list of
// 64-key tiles; dk/dv the transposed per-kv-tile list of BQ-row q tiles.
// The dense kernels read every tile's ids (and the dead tiles' nothing
// else); the sparse ones read only the listed tiles, so their work and
// traffic follow the live pairs. The id mask is applied inside every listed
// tile as in the dense kernels, so the outputs are the dense kernels'.
#include <climits>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;  // 4 warps
constexpr int kBQ = 64;        // forward / dq: q rows per block
constexpr int kBK = 64;        // keys per tile; dk/dv: keys per block
constexpr float kNeg = -1e30f;
constexpr float kMaskedLse = 1e30f;

// {block min, block max, doc min, doc max} over the valid ids
// [start, min(start + N, L)), computed by warp 0 into out[4] (shared).
// With no valid id the block min is INT_MAX, so the tile test fails.
template <int N>
__device__ __forceinline__ void id_range(const int* __restrict__ bid,
                                         const int* __restrict__ did,
                                         int start, int L, int* out) {
  if (threadIdx.x >= 32) return;
  int bmin = INT_MAX, bmax = INT_MIN, dmin = INT_MAX, dmax = INT_MIN;
  for (int i = threadIdx.x; i < N; i += 32) {
    const int idx = start + i;
    if (idx < L) {
      const int bb = bid[idx], dd = did[idx];
      bmin = min(bmin, bb);
      bmax = max(bmax, bb);
      dmin = min(dmin, dd);
      dmax = max(dmax, dd);
    }
  }
  bmin = __reduce_min_sync(0xffffffffu, bmin);
  bmax = __reduce_max_sync(0xffffffffu, bmax);
  dmin = __reduce_min_sync(0xffffffffu, dmin);
  dmax = __reduce_max_sync(0xffffffffu, dmax);
  if (threadIdx.x == 0) {
    out[0] = bmin;
    out[1] = bmax;
    out[2] = dmin;
    out[3] = dmax;
  }
}

// the TPU kernel's live-tile test (attention.py:170-179)
__device__ __forceinline__ bool tile_live(const int* qr, const int* kr) {
  return kr[0] <= qr[1] && !(kr[2] > qr[3] || kr[3] < qr[2]);
}

// rows [row0, row0 + R) of a [*, L, H, D] head view into smem (row pitch
// D + 8); rows past L are zero-filled. Starts cp.async copies (no commit).
template <int D, int R>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src, int row0,
                                          int L, size_t stride) {
  constexpr int LDS = D + 8;
  for (int c = threadIdx.x; c < R * (D / 8); c += kThreads) {
    const int r = c / (D / 8), cc = (c % (D / 8)) * 8;
    const int row = row0 + r;
    const bf16* p = src + (size_t)min(row, L - 1) * stride + cc;
    cp_async16(dst + r * LDS + cc, p, row < L ? 16 : 0);
  }
}

// A fragment (16 x 16, rows r0.., cols kk*16..) of a smem tile
template <int LDS>
__device__ __forceinline__ void frag_a(uint32_t a[4], const bf16* tile, int r0,
                                       int kk, int g, int tq) {
  const bf16* p = tile + (r0 + g) * LDS + kk * 16 + tq * 2;
  a[0] = lds32(p);
  a[1] = lds32(p + 8 * LDS);
  a[2] = lds32(p + 8);
  a[3] = lds32(p + 8 * LDS + 8);
}

// B fragment where the tile's rows are the n index and columns the k index
// (K rows for Q K^T): n = n0 + g, k = kk*16 + 2t..
template <int LDS>
__device__ __forceinline__ void frag_b_rows(uint32_t bf[2], const bf16* tile,
                                            int n0, int kk, int g, int tq) {
  const bf16* p = tile + (n0 + g) * LDS + kk * 16 + tq * 2;
  bf[0] = lds32(p);
  bf[1] = lds32(p + 8);
}

// B fragment where the tile's rows are the k index and columns the n index
// (V rows for P V): k = k0 + 2t.., n = n0 + g
template <int LDS>
__device__ __forceinline__ void frag_b_cols(uint32_t bf[2], const bf16* tile,
                                            int k0, int n0, int g, int tq) {
  const bf16* p = tile + (k0 + tq * 2) * LDS + n0 + g;
  __nv_bfloat162 lo, hi;
  lo.x = p[0];
  lo.y = p[LDS];
  hi.x = p[8 * LDS];
  hi.y = p[9 * LDS];
  bf[0] = *reinterpret_cast<uint32_t*>(&lo);
  bf[1] = *reinterpret_cast<uint32_t*>(&hi);
}

// the C fragments of two adjacent n-tiles (16 x 8 each) as one A fragment
__device__ __forceinline__ void c_to_a(uint32_t a[4], const float c0[4],
                                       const float c1[4]) {
  a[0] = pack_bf16x2(c0[0], c0[1]);
  a[1] = pack_bf16x2(c0[2], c0[3]);
  a[2] = pack_bf16x2(c1[0], c1[1]);
  a[3] = pack_bf16x2(c1[2], c1[3]);
}

// ---------------------------------------------------------------------------
// forward: o [B, Lq, Hq, D] bf16, lse [B, Hq, Lq] fp32
// ---------------------------------------------------------------------------
template <int D, bool kSparse>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ o,
                 float* __restrict__ lse, const int* __restrict__ qb,
                 const int* __restrict__ qd, const int* __restrict__ kb,
                 const int* __restrict__ kd, const int* __restrict__ tmap,
                 const int* __restrict__ tcnt, int S, int Lq, int Lk, int Hq,
                 int Hkv, float scale) {
  constexpr int LDS = D + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + kBK * LDS;
  int* kb_s = reinterpret_cast<int*>(Vs + kBK * LDS);
  int* kd_s = kb_s + kBK;
  __shared__ int qr[4], kr[4];

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int q0 = qt * kBQ;
  const int* qb_b = qb + (size_t)b * Lq;
  const int* qd_b = qd + (size_t)b * Lq;
  const int* kb_b = kb + (size_t)b * Lk;
  const int* kd_b = kd + (size_t)b * Lk;
  if (!kSparse) id_range<kBQ>(qb_b, qd_b, q0, Lq, qr);

  int row[2], rb[2], rd[2];
  bool rv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    row[i] = q0 + warp * 16 + g + i * 8;
    rv[i] = row[i] < Lq;
    rb[i] = rv[i] ? qb_b[row[i]] : 0;
    rd[i] = rv[i] ? qd_b[row[i]] : 0;
  }

  const size_t q_stride = (size_t)Hq * D;
  const bf16* qh = q + ((size_t)b * Lq * Hq + h) * D;
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const bf16* qrow = qh + (size_t)(rv[i] ? row[i] : 0) * q_stride;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int c = kk * 16 + tq * 2;
      qf[kk][i] = rv[i] ? lds32(qrow + c) : 0u;
      qf[kk][i + 2] = rv[i] ? lds32(qrow + c + 8) : 0u;
    }
  }

  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m_i[2] = {kNeg, kNeg};
  float l_i[2] = {0.f, 0.f};

  const size_t kv_stride = (size_t)Hkv * D;
  const bf16* kh = k + ((size_t)b * Lk * Hkv + hk) * D;
  const bf16* vh = v + ((size_t)b * Lk * Hkv + hk) * D;
  const int* tm = tmap + ((size_t)b * gridDim.x + qt) * S;
  const int n_it = kSparse ? tcnt[b * gridDim.x + qt] : (Lk + kBK - 1) / kBK;

  for (int it = 0; it < n_it; ++it) {
    const int k0 = (kSparse ? tm[it] : it) * kBK;
    __syncthreads();  // previous tile consumed; qr visible on the first pass
    if (!kSparse) id_range<kBK>(kb_b, kd_b, k0, Lk, kr);
    if (threadIdx.x < kBK) {
      const int idx = k0 + threadIdx.x;
      kb_s[threadIdx.x] = idx < Lk ? kb_b[idx] : 0;
      kd_s[threadIdx.x] = idx < Lk ? kd_b[idx] : 0;
    }
    __syncthreads();
    if (!kSparse && !tile_live(qr, kr)) continue;  // block-uniform
    load_rows<D, kBK>(Ks, kh, k0, Lk, kv_stride);
    load_rows<D, kBK>(Vs, vh, k0, Lk, kv_stride);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();

    float s[kBK / 8][4];
#pragma unroll
    for (int nt = 0; nt < kBK / 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t bf[2];
        frag_b_rows<LDS>(bf, Ks, nt * 8, kk, g, tq);
        mma_16816(s[nt], qf[kk], bf);
      }
    }

    float mx[2] = {kNeg, kNeg};
#pragma unroll
    for (int nt = 0; nt < kBK / 8; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kl = nt * 8 + tq * 2 + (i & 1), r = i >> 1;
        const bool ok = rv[r] && k0 + kl < Lk && kd_s[kl] == rd[r] &&
                        kb_s[kl] <= rb[r];
        s[nt][i] = ok ? s[nt][i] * scale : kNeg;
        mx[r] = fmaxf(mx[r], s[nt][i]);
      }
    }
    float corr[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      mx[j] = fmaxf(mx[j], __shfl_xor_sync(0xffffffffu, mx[j], 1));
      mx[j] = fmaxf(mx[j], __shfl_xor_sync(0xffffffffu, mx[j], 2));
      const float m_new = fmaxf(m_i[j], mx[j]);
      corr[j] = __expf(m_i[j] - m_new);
      m_i[j] = m_new;
      l_i[j] *= corr[j];
    }
#pragma unroll
    for (int nt = 0; nt < kBK / 8; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kl = nt * 8 + tq * 2 + (i & 1), r = i >> 1;
        const bool ok = rv[r] && k0 + kl < Lk && kd_s[kl] == rd[r] &&
                        kb_s[kl] <= rb[r];
        // masked again after exp: a row masked so far has m_i == kNeg
        const float p = ok ? __expf(s[nt][i] - m_i[r]) : 0.f;
        s[nt][i] = p;
        l_i[r] += p;  // per-thread partial, reduced over the quad at the end
      }
    }
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      acc[n][0] *= corr[0];
      acc[n][1] *= corr[0];
      acc[n][2] *= corr[1];
      acc[n][3] *= corr[1];
    }
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t pa[4];
      c_to_a(pa, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        uint32_t bf[2];
        frag_b_cols<LDS>(bf, Vs, kk * 16, n * 8, g, tq);
        mma_16816(acc[n], pa, bf);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = l_i[i];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    if (!rv[i]) continue;
    const float inv = l > 0.f ? 1.f / l : 0.f;  // fully masked row -> 0
    bf16* orow = o + (((size_t)b * Lq + row[i]) * Hq + h) * D;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const int c = n * 8 + tq * 2;
      *reinterpret_cast<__nv_bfloat162*>(orow + c) = __floats2bfloat162_rn(
          acc[n][2 * i] * inv, acc[n][2 * i + 1] * inv);
    }
    if (tq == 0)
      lse[((size_t)b * Hq + h) * Lq + row[i]] =
          l > 0.f ? m_i[i] + logf(l) : kMaskedLse;
  }
}

// ---------------------------------------------------------------------------
// backward dq: p = exp(s - lse), ds = p (dp - delta), dq = scale * ds K
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
  constexpr int LDS = D + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* dOs = Qs + kBQ * LDS;
  bf16* Ks = dOs + kBQ * LDS;
  bf16* Vs = Ks + kBK * LDS;
  int* kb_s = reinterpret_cast<int*>(Vs + kBK * LDS);
  int* kd_s = kb_s + kBK;
  __shared__ int qr[4], kr[4];

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int q0 = qt * kBQ;
  const int* qb_b = qb + (size_t)b * Lq;
  const int* qd_b = qd + (size_t)b * Lq;
  const int* kb_b = kb + (size_t)b * Lk;
  const int* kd_b = kd + (size_t)b * Lk;
  if (!kSparse) id_range<kBQ>(qb_b, qd_b, q0, Lq, qr);

  const size_t q_stride = (size_t)Hq * D;
  const size_t q_head = ((size_t)b * Lq * Hq + h) * D;
  load_rows<D, kBQ>(Qs, q + q_head, q0, Lq, q_stride);
  load_rows<D, kBQ>(dOs, dout + q_head, q0, Lq, q_stride);
  cp_async_commit();

  int row[2], rb[2], rd[2];
  bool rv[2];
  float lse_r[2], dl_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    row[i] = q0 + warp * 16 + g + i * 8;
    rv[i] = row[i] < Lq;
    rb[i] = rv[i] ? qb_b[row[i]] : 0;
    rd[i] = rv[i] ? qd_b[row[i]] : 0;
    const size_t r = ((size_t)b * Hq + h) * Lq + (rv[i] ? row[i] : 0);
    lse_r[i] = rv[i] ? lse[r] : 0.f;
    dl_r[i] = rv[i] ? delta[r] : 0.f;
  }

  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  const size_t kv_stride = (size_t)Hkv * D;
  const bf16* kh = k + ((size_t)b * Lk * Hkv + hk) * D;
  const bf16* vh = v + ((size_t)b * Lk * Hkv + hk) * D;
  const int r0 = warp * 16;
  const int* tm = tmap + ((size_t)b * gridDim.x + qt) * S;
  const int n_it = kSparse ? tcnt[b * gridDim.x + qt] : (Lk + kBK - 1) / kBK;

  for (int it = 0; it < n_it; ++it) {
    const int k0 = (kSparse ? tm[it] : it) * kBK;
    __syncthreads();
    if (!kSparse) id_range<kBK>(kb_b, kd_b, k0, Lk, kr);
    if (threadIdx.x < kBK) {
      const int idx = k0 + threadIdx.x;
      kb_s[threadIdx.x] = idx < Lk ? kb_b[idx] : 0;
      kd_s[threadIdx.x] = idx < Lk ? kd_b[idx] : 0;
    }
    __syncthreads();
    if (!kSparse && !tile_live(qr, kr)) continue;
    load_rows<D, kBK>(Ks, kh, k0, Lk, kv_stride);
    load_rows<D, kBK>(Vs, vh, k0, Lk, kv_stride);
    cp_async_commit();
    cp_async_wait<0>();  // also the Q / dO tiles on the first live pass
    __syncthreads();

    float s[kBK / 8][4], dp[kBK / 8][4];
#pragma unroll
    for (int nt = 0; nt < kBK / 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[nt][i] = dp[nt][i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t qa[4], da[4];
      frag_a<LDS>(qa, Qs, r0, kk, g, tq);
      frag_a<LDS>(da, dOs, r0, kk, g, tq);
#pragma unroll
      for (int nt = 0; nt < kBK / 8; ++nt) {
        uint32_t bk[2], bv[2];
        frag_b_rows<LDS>(bk, Ks, nt * 8, kk, g, tq);
        frag_b_rows<LDS>(bv, Vs, nt * 8, kk, g, tq);
        mma_16816(s[nt], qa, bk);
        mma_16816(dp[nt], da, bv);
      }
    }
#pragma unroll
    for (int nt = 0; nt < kBK / 8; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kl = nt * 8 + tq * 2 + (i & 1), r = i >> 1;
        const bool ok = rv[r] && k0 + kl < Lk && kd_s[kl] == rd[r] &&
                        kb_s[kl] <= rb[r];
        const float p = ok ? __expf(s[nt][i] * scale - lse_r[r]) : 0.f;
        s[nt][i] = p * (dp[nt][i] - dl_r[r]);  // ds
      }
    }
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t sa[4];
      c_to_a(sa, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        uint32_t bf[2];
        frag_b_cols<LDS>(bf, Ks, kk * 16, n * 8, g, tq);
        mma_16816(acc[n], sa, bf);
      }
    }
  }
  cp_async_wait<0>();  // the Q / dO copies, if no tile was live

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (!rv[i]) continue;
    bf16* drow = dq + (((size_t)b * Lq + row[i]) * Hq + h) * D;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const int c = n * 8 + tq * 2;
      *reinterpret_cast<__nv_bfloat162*>(drow + c) = __floats2bfloat162_rn(
          acc[n][2 * i] * scale, acc[n][2 * i + 1] * scale);
    }
  }
}

// ---------------------------------------------------------------------------
// backward dk/dv: summed over the q heads of the GQA group in registers
//   dv = sum_h P^T dO,  dk = scale * sum_h dS^T Q
// ---------------------------------------------------------------------------
template <int D, int BQ, bool kSparse>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, bf16* __restrict__ dk,
                     bf16* __restrict__ dv, const int* __restrict__ qb,
                     const int* __restrict__ qd, const int* __restrict__ kb,
                     const int* __restrict__ kd, const int* __restrict__ tmap,
                     const int* __restrict__ tcnt, int S, int Lq, int Lk,
                     int Hq, int Hkv, float scale) {
  constexpr int LDS = D + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + kBK * LDS;
  bf16* Qs = Vs + kBK * LDS;
  bf16* dOs = Qs + BQ * LDS;
  float* lse_s = reinterpret_cast<float*>(dOs + BQ * LDS);
  float* dl_s = lse_s + BQ;
  int* qb_s = reinterpret_cast<int*>(dl_s + BQ);
  int* qd_s = qb_s + BQ;
  __shared__ int qr[4], kr[4];

  const int kt = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int group = Hq / Hkv;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int k0 = kt * kBK;
  const int* qb_b = qb + (size_t)b * Lq;
  const int* qd_b = qd + (size_t)b * Lq;
  const int* kb_b = kb + (size_t)b * Lk;
  const int* kd_b = kd + (size_t)b * Lk;
  if (!kSparse) id_range<kBK>(kb_b, kd_b, k0, Lk, kr);

  const size_t kv_stride = (size_t)Hkv * D;
  const size_t kv_head = ((size_t)b * Lk * Hkv + hk) * D;
  load_rows<D, kBK>(Ks, k + kv_head, k0, Lk, kv_stride);
  load_rows<D, kBK>(Vs, v + kv_head, k0, Lk, kv_stride);
  cp_async_commit();

  int key[2], kbr[2], kdr[2];
  bool kvv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    key[i] = k0 + warp * 16 + g + i * 8;
    kvv[i] = key[i] < Lk;
    kbr[i] = kvv[i] ? kb_b[key[i]] : 0;
    kdr[i] = kvv[i] ? kd_b[key[i]] : 0;
  }

  float dka[D / 8][4], dva[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) dka[n][i] = dva[n][i] = 0.f;

  const size_t q_stride = (size_t)Hq * D;
  const int r0 = warp * 16;
  const int* tm = tmap + ((size_t)b * gridDim.x + kt) * S;
  const int n_it = kSparse ? tcnt[b * gridDim.x + kt] : (Lq + BQ - 1) / BQ;

  for (int gh = 0; gh < group; ++gh) {
    const int h = hk * group + gh;
    const size_t q_head = ((size_t)b * Lq * Hq + h) * D;
    const float* lse_h = lse + ((size_t)b * Hq + h) * Lq;
    const float* dl_h = delta + ((size_t)b * Hq + h) * Lq;
    for (int it = 0; it < n_it; ++it) {
      const int q0 = (kSparse ? tm[it] : it) * BQ;
      __syncthreads();  // previous q tile consumed; kr visible on first pass
      if (!kSparse) id_range<BQ>(qb_b, qd_b, q0, Lq, qr);
      if (threadIdx.x < BQ) {
        const int idx = q0 + threadIdx.x;
        const bool ok = idx < Lq;
        qb_s[threadIdx.x] = ok ? qb_b[idx] : 0;
        qd_s[threadIdx.x] = ok ? qd_b[idx] : 0;
        lse_s[threadIdx.x] = ok ? lse_h[idx] : 0.f;
        dl_s[threadIdx.x] = ok ? dl_h[idx] : 0.f;
      }
      __syncthreads();
      if (!kSparse && !tile_live(qr, kr)) continue;
      load_rows<D, BQ>(Qs, q + q_head, q0, Lq, q_stride);
      load_rows<D, BQ>(dOs, dout + q_head, q0, Lq, q_stride);
      cp_async_commit();
      cp_async_wait<0>();  // also the K / V tiles on the first live pass
      __syncthreads();

      // S^T and dP^T for this warp's 16 keys x BQ query rows
      float s[BQ / 8][4], dp[BQ / 8][4];
#pragma unroll
      for (int nt = 0; nt < BQ / 8; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) s[nt][i] = dp[nt][i] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t ka[4], va[4];
        frag_a<LDS>(ka, Ks, r0, kk, g, tq);
        frag_a<LDS>(va, Vs, r0, kk, g, tq);
#pragma unroll
        for (int nt = 0; nt < BQ / 8; ++nt) {
          uint32_t bq[2], bd[2];
          frag_b_rows<LDS>(bq, Qs, nt * 8, kk, g, tq);
          frag_b_rows<LDS>(bd, dOs, nt * 8, kk, g, tq);
          mma_16816(s[nt], ka, bq);
          mma_16816(dp[nt], va, bd);
        }
      }
#pragma unroll
      for (int nt = 0; nt < BQ / 8; ++nt) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int qc = nt * 8 + tq * 2 + (i & 1), r = i >> 1;
          const bool ok = kvv[r] && q0 + qc < Lq && qd_s[qc] == kdr[r] &&
                          kbr[r] <= qb_s[qc];
          const float p = ok ? __expf(s[nt][i] * scale - lse_s[qc]) : 0.f;
          s[nt][i] = p;
          dp[nt][i] = p * (dp[nt][i] - dl_s[qc]);  // ds^T
        }
      }
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
        uint32_t pa[4], sa[4];
        c_to_a(pa, s[2 * kk], s[2 * kk + 1]);
        c_to_a(sa, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
        for (int n = 0; n < D / 8; ++n) {
          uint32_t bd[2], bq[2];
          frag_b_cols<LDS>(bd, dOs, kk * 16, n * 8, g, tq);
          frag_b_cols<LDS>(bq, Qs, kk * 16, n * 8, g, tq);
          mma_16816(dva[n], pa, bd);
          mma_16816(dka[n], sa, bq);
        }
      }
    }
  }
  cp_async_wait<0>();  // the K / V copies, if no tile was live

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (!kvv[i]) continue;
    const size_t off = (((size_t)b * Lk + key[i]) * Hkv + hk) * D;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const int c = n * 8 + tq * 2;
      *reinterpret_cast<__nv_bfloat162*>(dk + off + c) = __floats2bfloat162_rn(
          dka[n][2 * i] * scale, dka[n][2 * i + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + off + c) =
          __floats2bfloat162_rn(dva[n][2 * i], dva[n][2 * i + 1]);
    }
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

bool bad_shape(int B, int Lq, int Lk, int Hq, int Hkv, int D) {
  return B <= 0 || Lq <= 0 || Lk <= 0 || Hkv <= 0 || Hq % Hkv != 0 ||
         (D != 64 && D != 128) || B > 65535 || Hq > 65535;
}

// The tile list of a sparse launch: tmap [B, n_tiles, S] int32 (tile
// indices, ascending; entries past the count are not read) and tcnt
// [B, n_tiles] int32, n_tiles the launch's grid.x. Dense launches pass null.
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
  const int smem = 2 * kBK * (D + 8) * 2 + 2 * kBK * 4;
  auto kern = flash_fwd_kernel<D, kSparse>;
  cudaError_t e = allow_smem(kern, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((Lq + kBQ - 1) / kBQ, Hq, B);
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
  const int smem = (2 * kBQ + 2 * kBK) * (D + 8) * 2 + 2 * kBK * 4;
  auto kern = flash_bwd_dq_kernel<D, kSparse>;
  cudaError_t e = allow_smem(kern, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((Lq + kBQ - 1) / kBQ, Hq, B);
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

// q tile of the dk/dv kernel: 64 rows at D=64; 32 at D=128, so the two
// fp32 accumulators (2 x 64 registers a thread) leave room for S and dP.
// A sparse launch's transposed list counts q tiles of this size.
template <int D>
constexpr int dkv_bq() {
  return D == 64 ? 64 : 32;
}

template <int D, bool kSparse>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, void* dk, void* dv,
               const void* qb, const void* qd, const void* kb, const void* kd,
               TileList tl, int B, int Lq, int Lk, int Hq, int Hkv, float scale,
               cudaStream_t st) {
  constexpr int BQ = dkv_bq<D>();
  const int smem = (2 * kBK + 2 * BQ) * (D + 8) * 2 + 4 * BQ * 4;
  auto kern = flash_bwd_dkv_kernel<D, BQ, kSparse>;
  cudaError_t e = allow_smem(kern, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((Lk + kBK - 1) / kBK, Hkv, B);
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
// q tiles of 64 rows (D=64) or 32 rows (D=128).
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
