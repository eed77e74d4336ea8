// Split-KV ("flash decoding") attention of a query block against a
// head-major KV cache.
//
// Replaces two TPU kernels of bitdance_tpu/ops/decode_attention.py:
//   _decode_kernel (entry decode_attention_pallas): separate bf16 k and v
//     caches [B, Hkv, L, D];
//   _decode_fusedkv_kernel (entry decode_attention_fusedkv): one fused ring
//     buffer [B, Hkv, L, 2D] (k in lanes [:D], v in [D:]), bf16, or int8 with
//     f32 scales [B, Hkv, 2, L] (k scales in row 0, v scales in row 1).
// An S-row query block per (row b, q head) attends the valid window
// [kv_start[b], kv_len[b]) of the cache, online softmax in fp32, and a row
// whose window is empty returns 0. With an int8 buffer the scores take the k
// scale of each key, p takes the v scale of each key before the PV product,
// and the normaliser l sums the unscaled p, as the TPU kernel does.
//
// What bounds it on the H100: at the 14B model's last AR step (2 CFG rows x
// 8 kv heads x 4226 keys x 128, 40 q heads of 64 tokens) one call reads
// 34.6 MB of bf16 cache and does 11.1 GFLOP: ~0.011 ms either way, so the
// kernel is held back by how many SMs stream the cache and how much latency
// each hides. The first design gave one block to each (b, kv head, 64-row q
// tile): 80 blocks of 4 warps on 132 SMs, each walking the whole window one
// tile at a time (global -> registers -> shared between two barriers,
// nothing in flight), with B fragments gathered by scalar shared loads; it
// took 37x the bound.
//
// Design:
// - Split-KV. The grid is (B * Hkv * n_qtiles) x n_splits; the host picks
//   n_splits (ops/decode_attention.py::decode_splits) from the waves of
//   resident blocks (bd_decode_blocks_per_sm per SM, 2 here) that many
//   splits take against the tiles each block then walks: 3 at the 14B
//   model's shape, at B 2 (one wave) as at B 4 (two). Each block takes an
//   equal share of the whole 64-key tiles that hold its row's window,
//   computed here from kv_start[b] and kv_len[b], so every split is busy
//   at kv_len 130 as at 4226 with no host read. It writes fp32 partials (the unnormalised o, the running max m in
//   the log2 domain and the normaliser l per (split, b, kv head, q row)) to
//   scratch; a split with no live key writes m = -1e30, l = 0, o = 0. A
//   second launch, split_combine_kernel (one warp per output row), merges
//   the splits in split order (m = max m_i, w_i = 2^(m_i - m), o = sum w_i
//   o_i / sum w_i l_i, 0 where the sum is 0): no atomics, the same bits on
//   every run. (Merging in the last block of each q tile to finish, told by
//   an integer counter, was slower on the H100: its 4 warps wait out the L2
//   latency of the partials' reads that the combine's 640 blocks hide.)
// - A ring of tiles. K/V tiles arrive by 16-byte cp.async.cg in a 2-stage
//   ring in dynamic shared memory (65 KB a block); the next tile is in
//   flight while the current one is on the tensor cores. Keys outside the
//   window are zero-filled, never read. An int8 tile is copied raw (a
//   quarter of the bytes of two bf16 caches, its two f32 scales per key
//   beside it) two tiles ahead, and widened to bf16 in shared memory one
//   tile ahead of the products (two widened stages; 100 KB a block), off
//   the load path and with one barrier a tile: |q| <= 127 is exact in
//   bf16, so the same tensor-core products serve both formats. Registers
//   (over 200 a thread) hold 2 blocks an SM.
// - Products on wgmma. GQA is folded into the q rows (the 5 q heads of a kv
//   head form 5*S rows), so a K/V tile feeds all of them; the 5 q tiles of
//   one (b, kv head, split) are neighbours in the grid and read the tile
//   from L2 together. A block is one warpgroup over 64 q rows: S = Q K^T is
//   wgmma m64n64k16 and O += P V wgmma m64n128k16 (bf16 in, fp32 out), both
//   reading K and V straight from the 128-byte-swizzled tiles in shared
//   memory (K-major for Q K^T, MN-major for P V), so each tile is read from
//   shared memory once for all 64 rows, not once per 16-row warp as
//   mma.sync with ldmatrix would. The A operands stay in registers: Q's
//   fragments, loaded once by ldmatrix.x4 from the q tile staged in shared
//   memory, and P, rounded to bf16 and reused from the C to the A fragment.
// What still bounds it: the softmax between the two products and, for
// int8, the widening pass each block repeats for its tile.
#include "common.cuh"

namespace {

constexpr int kD = 128;        // head dim (the kernel is specialised to it)
constexpr int kBQ = 64;        // q rows per block: 4 warps x 16
constexpr int kBKV = 64;       // keys per tile
constexpr int kStages = 2;     // tiles in the ring
constexpr int kThreads = 128;  // one warpgroup
constexpr float kNeg = -1e30f;

// A bf16 K or V tile in shared memory is wgmma's 128-byte swizzle of 64
// rows (common.cuh::swz): two 8 KB halves (d 0-63, d 64-127). The same
// bytes are K-major for Q K^T (rows = keys, 8-row groups 1024 B apart) and
// MN-major for P V (d contiguous, 8-key groups 1024 B apart, the d halves
// 8 KB apart).
constexpr int kTileBytes = kBKV * kD * 2;

// one block's dynamic shared memory, from a 1024-byte aligned base:
// kStages raw stages (K tile, V tile, then for int8 the 2 x 64 f32 scales),
// then for int8 two widened stages (swizzled bf16 K and V, the scales)
template <typename T>
struct Smem {
  static constexpr bool kQuant = sizeof(T) == 1;
  static constexpr int kTile = kBKV * kD * sizeof(T);
  static constexpr int kScales = kQuant ? 2 * kBKV * 4 : 0;
  static constexpr int kStage = 2 * kTile + kScales;
  static constexpr int kWide = (2 * kTileBytes + kScales + 1023) / 1024 * 1024;
  static constexpr int kBytes = kStages * kStage + (kQuant ? 2 * kWide : 0) + 1024;
};

// 16 int8 values in shared memory -> 16 bf16 (two 8-value chunks), off the quarter-rate
// conversion unit: each byte, biased to u = x + 128, becomes the low
// mantissa bits of 2^23 (exact in fp32), 2^23 + 128 is taken off, and the
// high halves of two such floats are the bf16 pair (exact: |x| <= 128 has
// no bits in the low half)
__device__ __forceinline__ void widen16(bf16* lo, bf16* hi, const int8_t* src) {
  const uint4 raw = *reinterpret_cast<const uint4*>(src);
  const uint32_t in[4] = {raw.x ^ 0x80808080u, raw.y ^ 0x80808080u,
                          raw.z ^ 0x80808080u, raw.w ^ 0x80808080u};
  uint32_t w[8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    uint32_t f[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      f[j] = __float_as_uint(__uint_as_float(__byte_perm(in[i], 0x4B000000u, 0x7540 + j)) -
                             8388736.f);
    w[2 * i] = __byte_perm(f[0], f[1], 0x7632);
    w[2 * i + 1] = __byte_perm(f[2], f[3], 0x7632);
  }
  *reinterpret_cast<uint4*>(lo) = make_uint4(w[0], w[1], w[2], w[3]);
  *reinterpret_cast<uint4*>(hi) = make_uint4(w[4], w[5], w[6], w[7]);
}

// T: cache element (bf16, or int8 with kv_sc [B*Hkv, 2, L] f32 scales);
// k and v point at row 0 of head 0 and rows are ld elements apart (D for
// separate caches, 2D for the fused buffer, whose v starts at k + D).
// Partials: part_o [n_splits, B, Hkv, rows, D], part_ml [.., rows, 2].
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
split_decode_kernel(const bf16* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, int ld,
                    const float* __restrict__ kv_sc, float* __restrict__ part_o,
                    float* __restrict__ part_ml, const int* __restrict__ kv_len,
                    const int* __restrict__ kv_start, int B, int S, int Hq,
                    int Hkv, int L, float scale_log2, int n_qtiles) {
  using Sm = Smem<T>;
  constexpr bool kQuant = Sm::kQuant;
  constexpr int kE = 16 / sizeof(T);       // elements per 16-byte copy
  constexpr int kChunks = kD / kE;         // copies per row of K or V
  static_assert(kThreads == 2 * kBKV, "one scale copy per thread");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* const smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);

  const int qt = blockIdx.x % n_qtiles;
  const int bh = blockIdx.x / n_qtiles;
  const int hk = bh % Hkv;
  const int b = bh / Hkv;
  const int split = blockIdx.y, n_splits = gridDim.y;
  const int group = Hq / Hkv;
  const int rows = group * S;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;

  const int len = min(kv_len[b], L);
  const int start = max(kv_start[b], 0);
  // this split's equal share [ta, tb) of the tiles that hold the window
  const int t0 = start / kBKV;
  const int n_live = len > start ? (len + kBKV - 1) / kBKV - t0 : 0;
  const int ta = t0 + split * n_live / n_splits;
  const int tb = t0 + (split + 1) * n_live / n_splits;

  const size_t head = (size_t)b * Hkv + hk;
  const T* kh = k + head * L * ld;
  const T* vh = v + head * L * ld;
  const float* sch = kQuant ? kv_sc + head * 2 * L : nullptr;

  // issue the copies of tile t into ring stage st
  // (bf16 tiles land swizzled, int8 tiles row by row for the widening)
  auto load_tile = [&](int t, int st) {
    unsigned char* ks = smem + st * Sm::kStage;
    unsigned char* vs = ks + Sm::kTile;
    const int kb = t * kBKV;
#pragma unroll
    for (int i = 0; i < kBKV * kChunks / kThreads; ++i) {
      const int c = tid + i * kThreads;
      const int r = c / kChunks, cc = c % kChunks;
      const int key = kb + r;
      const bool ok = key >= start && key < len;
      const size_t off = (size_t)(ok ? key : 0) * ld + cc * kE;
      const int at = kQuant ? r * kD + cc * 16 : swz(r, cc);
      cp_async16(ks + at, kh + off, ok ? 16 : 0);
      cp_async16(vs + at, vh + off, ok ? 16 : 0);
    }
    if constexpr (kQuant) {
      float* sc = reinterpret_cast<float*>(vs + Sm::kTile);  // [2][64]
      const int key = kb + tid % kBKV;
      const bool ok = key >= start && key < len;
      cp_async4(sc + tid, sch + (tid / kBKV) * L + (ok ? key : 0), ok ? 4 : 0);
    }
  };

  // the block's 64 q rows (row r -> head hk*group + r/S, s = r%S) are staged
  // swizzled in shared memory, in a ring slot the pipeline has not reached
  // yet (bf16 stage 1, int8 widened stage 1), and read back as wgmma's A
  // fragments by ldmatrix: this warp's 16 rows
  const int r0 = qt * kBQ + warp * 16;
  unsigned char* const q_tile =
      smem + (kQuant ? kStages * Sm::kStage + Sm::kWide : Sm::kStage);
#pragma unroll
  for (int i = 0; i < kBQ * 16 / kThreads; ++i) {
    const int c = tid + i * kThreads;
    const int r = c >> 4, cc = c & 15;
    const int rr = qt * kBQ + r;
    const bool ok = rr < rows;
    const bf16* src = q + (ok ? (((size_t)b * S + rr % S) * Hq + hk * group + rr / S) * kD : 0);
    cp_async16(q_tile + swz(r, cc), src + cc * 8, ok ? 16 : 0);
  }
  float acc[kD / 8][4];
#pragma unroll
  for (int n = 0; n < kD / 8; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m_i[2] = {kNeg, kNeg};
  float l_i[2] = {0.f, 0.f};

  // int8: raw stage st -> widened stage w (swizzled bf16 K, V; the scales)
  unsigned char* const wide = smem + kStages * Sm::kStage;
  auto widen_tile = [&](int st, int w) {
    const int8_t* ks = reinterpret_cast<const int8_t*>(smem + st * Sm::kStage);
    unsigned char* kw = wide + w * Sm::kWide;
#pragma unroll
    for (int i = 0; i < kBKV * kChunks / kThreads; ++i) {
      const int c = tid + i * kThreads;
      const int r = c / kChunks, cc = c % kChunks;   // 16 int8 = bf16 chunks 2cc, 2cc+1
      widen16(reinterpret_cast<bf16*>(kw + swz(r, 2 * cc)),
              reinterpret_cast<bf16*>(kw + swz(r, 2 * cc + 1)), ks + r * kD + cc * 16);
      widen16(reinterpret_cast<bf16*>(kw + kTileBytes + swz(r, 2 * cc)),
              reinterpret_cast<bf16*>(kw + kTileBytes + swz(r, 2 * cc + 1)),
              ks + Sm::kTile + r * kD + cc * 16);
    }
    reinterpret_cast<float*>(kw + 2 * kTileBytes)[tid] =
        reinterpret_cast<const float*>(ks + 2 * Sm::kTile)[tid];
  };

  // Tiles copied ahead of the one on the tensor cores: bf16 1 (a 2-stage
  // ring); int8 2, so that tile t+1 lands while tile t is computed and is
  // widened in the same step (two widened stages, one barrier a tile).
  constexpr int kAhead = kQuant ? 2 : 1;
  static_assert(kAhead <= kStages, "the ring holds the tiles in flight");
#pragma unroll
  for (int i = 0; i < kAhead; ++i) {
    if (ta + i < tb) load_tile(ta + i, i);
    cp_async_commit();  // the q tile rides in the first group
  }
  cp_async_wait<kAhead - 1>();
  __syncthreads();
  uint32_t qf[kD / 16][4];
  {
    const int row = warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk)
      ldsm_x4(qf[kk], smem_u32(q_tile + swz(row, 2 * kk + (lane >> 4))));
  }
  if constexpr (kQuant) {
    if (ta < tb) widen_tile(0, 0);
  }
  for (int t = ta; t < tb; ++t) {
    const int j = t - ta;
    cp_async_wait<0>();
    fence_async_shared();  // this thread's copies and widening, to wgmma
    // bf16: tile t has landed and every warp is done with tile t-1 (its
    // slot takes tile t+1); int8: raw tile t+1 has landed, tile t is
    // widened, and raw tile t (widened) and widened tile t-1 are free; on
    // the first pass every warp has read its q fragments
    __syncthreads();
    if (t + kAhead < tb) load_tile(t + kAhead, (j + kAhead) % kStages);
    cp_async_commit();

    const unsigned char* Kt;
    const float* kS = nullptr;
    if constexpr (kQuant) {
      if (t + 1 < tb) widen_tile((j + 1) % kStages, (j + 1) % 2);
      Kt = wide + (j % 2) * Sm::kWide;
      kS = reinterpret_cast<const float*>(Kt + 2 * kTileBytes);
    } else {
      Kt = smem + (j % kStages) * Sm::kStage;
    }
    const uint32_t k_addr = smem_u32(Kt), v_addr = k_addr + kTileBytes;

    // S = Q K^T for the block's 64 rows x 64 keys (K-major B: 32 bytes a
    // k step inside a 128-byte row, then the second d half)
    float s[kBKV / 8][4];
#pragma unroll
    for (int nt = 0; nt < kBKV / 8; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk)
      wgmma_m64n64k16<0>(s, qf[kk],
                         gmma_desc(k_addr + (kk >> 2) * (kTileBytes / 2) + (kk & 3) * 32, 16,
                                   1024),
                         kk > 0);
    wgmma_commit_wait();

    // scale (log2 domain), mask the window's edge tiles, running max
    const int kb = t * kBKV;
    const bool edge = kb < start || kb + kBKV > len;
    float mx[2] = {kNeg, kNeg};
#pragma unroll
    for (int nt = 0; nt < kBKV / 8; ++nt) {
      // int8: this lane's two keys' k scales, one 8-byte shared load
      float2 ksc = make_float2(1.f, 1.f);
      if constexpr (kQuant) ksc = *reinterpret_cast<const float2*>(kS + nt * 8 + tq * 2);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kl = nt * 8 + tq * 2 + (i & 1);
        float sv = s[nt][i] * scale_log2;
        if constexpr (kQuant) sv *= (i & 1) ? ksc.y : ksc.x;
        if (edge && (kb + kl < start || kb + kl >= len)) sv = kNeg;
        s[nt][i] = sv;
        mx[i >> 1] = fmaxf(mx[i >> 1], sv);
      }
    }
    float corr[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      mx[j] = fmaxf(mx[j], __shfl_xor_sync(0xffffffffu, mx[j], 1));
      mx[j] = fmaxf(mx[j], __shfl_xor_sync(0xffffffffu, mx[j], 2));
      const float m_new = fmaxf(m_i[j], mx[j]);
      corr[j] = exp2_approx(m_i[j] - m_new);
      m_i[j] = m_new;
      l_i[j] *= corr[j];
    }
#pragma unroll
    for (int nt = 0; nt < kBKV / 8; ++nt) {
      float2 vsc = make_float2(1.f, 1.f);
      if constexpr (kQuant) vsc = *reinterpret_cast<const float2*>(kS + kBKV + nt * 8 + tq * 2);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kl = nt * 8 + tq * 2 + (i & 1);
        const bool dead = edge && (kb + kl < start || kb + kl >= len);
        const float p = dead ? 0.f : exp2_approx(s[nt][i] - m_i[i >> 1]);
        l_i[i >> 1] += p;  // per-thread partial; reduced over the quad at the end
        // the PV operand; int8: p times the key's v scale
        s[nt][i] = kQuant ? p * ((i & 1) ? vsc.y : vsc.x) : p;
      }
    }
#pragma unroll
    for (int n = 0; n < kD / 8; ++n) {
      acc[n][0] *= corr[0];
      acc[n][1] *= corr[0];
      acc[n][2] *= corr[1];
      acc[n][3] *= corr[1];
    }

    // O += P V: the C fragments of two adjacent key tiles form one A
    // fragment; V is MN-major B: the d halves 8 KB apart (leading offset),
    // 8-key groups 1024 B apart (stride offset), 16 keys a k step
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBKV / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16x2(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_bf16x2(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      wgmma_m64n128k16<1>(acc, pa, gmma_desc(v_addr + kk * 2048, kTileBytes / 2, 1024), 1);
    }
    wgmma_commit_wait();
  }
  cp_async_wait<0>();  // no copy may outlive the block

  // this split's partials (a split with no tile: m = -1e30, l = 0, o = 0)
  const size_t pr0 = (split * (size_t)B + b) * Hkv + hk;   // then * rows + r
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = l_i[i];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int r = r0 + g + i * 8;
    if (r >= rows) continue;
    const size_t pr = pr0 * rows + r;
    float* po = part_o + pr * kD;
#pragma unroll
    for (int n = 0; n < kD / 8; ++n)
      *reinterpret_cast<float2*>(po + n * 8 + tq * 2) =
          make_float2(acc[n][2 * i], acc[n][2 * i + 1]);
    if (tq == 0) *reinterpret_cast<float2*>(part_ml + pr * 2) = make_float2(m_i[i], l);
  }

}

// One warp per output row (b, s, q head), 4 of its 128 values per lane: the
// splits' partials merged in split order.
__global__ void __launch_bounds__(256)
split_combine_kernel(const float* __restrict__ part_o,
                     const float* __restrict__ part_ml, bf16* __restrict__ o,
                     int n_splits, int B, int S, int Hq, int Hkv) {
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= B * S * Hq) return;
  const int h = row % Hq, s = (row / Hq) % S, b = row / (Hq * S);
  const int group = Hq / Hkv, rows = group * S;
  const size_t pr = ((size_t)b * Hkv + h / group) * rows + (h % group) * S + s;
  const size_t stride = (size_t)B * Hkv * rows;  // from one split to the next
  float m = kNeg;
#pragma unroll 4
  for (int i = 0; i < n_splits; ++i) m = fmaxf(m, part_ml[(pr + i * stride) * 2]);
  float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
  float l = 0.f;
#pragma unroll 4
  for (int i = 0; i < n_splits; ++i) {
    const size_t at = pr + i * stride;
    const float2 ml = *reinterpret_cast<const float2*>(part_ml + at * 2);
    const float4 po = reinterpret_cast<const float4*>(part_o + at * kD)[lane];
    const float w = exp2_approx(ml.x - m);
    l += w * ml.y;
    sum.x += w * po.x;
    sum.y += w * po.y;
    sum.z += w * po.z;
    sum.w += w * po.w;
  }
  const float inv = l > 0.f ? 1.f / l : 0.f;  // empty window -> 0
  *reinterpret_cast<uint2*>(o + (size_t)row * kD + lane * 4) =
      make_uint2(pack_bf16x2(sum.x * inv, sum.y * inv), pack_bf16x2(sum.z * inv, sum.w * inv));
}

// MaxDynamicSharedMemorySize of split_decode_kernel<T>, once per device
template <typename T>
cudaError_t allow_smem() {
  static unsigned done = 0;  // bit per device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < 32 && (done >> dev & 1u))) return err;
  err = cudaFuncSetAttribute(split_decode_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, Smem<T>::kBytes);
  if (err == cudaSuccess && dev < 32) done |= 1u << dev;
  return err;
}

template <typename T>
int launch_decode(const void* q, const T* k, const T* v, int ld, const void* kv_sc,
                  void* out, void* scratch, const void* kv_len, const void* kv_start,
                  int B, int S, int Hq, int Hkv, int L, int D, int n_splits, float scale,
                  void* stream) {
  if (D != kD || Hkv <= 0 || Hq % Hkv != 0 || B <= 0 || S <= 0 || L <= 0 ||
      n_splits < 1 || n_splits > (L + kBKV - 1) / kBKV)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = allow_smem<T>();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rows = (Hq / Hkv) * S;
  const int n_qtiles = (rows + kBQ - 1) / kBQ;
  float* part_o = static_cast<float*>(scratch);
  float* part_ml = part_o + (size_t)n_splits * B * Hkv * rows * kD;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  split_decode_kernel<T><<<dim3(B * Hkv * n_qtiles, n_splits), kThreads, Smem<T>::kBytes, st>>>(
      static_cast<const bf16*>(q), k, v, ld, static_cast<const float*>(kv_sc), part_o,
      part_ml, static_cast<const int*>(kv_len), static_cast<const int*>(kv_start), B, S,
      Hq, Hkv, L, scale * kLog2e, n_qtiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  split_combine_kernel<<<(B * S * Hq + 7) / 8, 256, 0, st>>>(
      part_o, part_ml, static_cast<bf16*>(out), n_splits, B, S, Hq, Hkv);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int blocks_per_sm() {
  int n = 0;
  cudaError_t err = allow_smem<T>();
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, split_decode_kernel<T>, kThreads,
                                                        Smem<T>::kBytes);
  return err == cudaSuccess ? n : -static_cast<int>(err);
}

}  // namespace

// The shapes and options of one call, built once per shape by the host
// (ops/decode_attention.py::DecodeShape, the same layout): a call passes 9
// arguments where it passed 16, which took host time on every decode call.
struct DecodeShape {
  int B, S, Hq, Hkv, L, D, n_splits;
  float scale;
};

// q [B,S,Hq,D], k/v [B,Hkv,L,D] (one layer of the head-major cache), out like
// q; scratch n_splits * B * Hkv * (Hq/Hkv * S) * (D + 2) f32; kv_len and
// kv_start [B] int32 on the device; 1 <= n_splits <= ceil(L / 64). Returns
// cudaGetLastError().
extern "C" int bd_decode_attention(const void* q, const void* k, const void* v,
                                   void* out, void* scratch, const void* kv_len,
                                   const void* kv_start, const DecodeShape* sh,
                                   void* stream) {
  return launch_decode(q, static_cast<const bf16*>(k), static_cast<const bf16*>(v), sh->D,
                       nullptr, out, scratch, kv_len, kv_start, sh->B, sh->S, sh->Hq,
                       sh->Hkv, sh->L, sh->D, sh->n_splits, sh->scale, stream);
}

// q [B,S,Hq,D] bf16; kv [B,Hkv,L,2D] (one layer of the fused ring buffer):
// bf16 when kv_sc is null, else int8 with kv_sc [B,Hkv,2,L] f32. out,
// scratch and the shape as for bd_decode_attention.
extern "C" int bd_decode_attention_fusedkv(const void* q, const void* kv,
                                           const void* kv_sc, void* out,
                                           void* scratch, const void* kv_len,
                                           const void* kv_start, const DecodeShape* sh,
                                           void* stream) {
  const int D = sh->D;
  if (kv_sc != nullptr) {
    const auto* p = static_cast<const int8_t*>(kv);
    return launch_decode(q, p, p + D, 2 * D, kv_sc, out, scratch, kv_len, kv_start, sh->B,
                         sh->S, sh->Hq, sh->Hkv, sh->L, D, sh->n_splits, sh->scale, stream);
  }
  const auto* p = static_cast<const bf16*>(kv);
  return launch_decode(q, p, p + D, 2 * D, nullptr, out, scratch, kv_len, kv_start, sh->B,
                       sh->S, sh->Hq, sh->Hkv, sh->L, D, sh->n_splits, sh->scale, stream);
}

// Blocks of the kernel an SM holds at once (int8 buffer when quant != 0),
// or minus a CUDA error: the host sizes n_splits from the waves of them.
extern "C" int bd_decode_blocks_per_sm(int quant) {
  return quant ? blocks_per_sm<int8_t>() : blocks_per_sm<bf16>();
}
