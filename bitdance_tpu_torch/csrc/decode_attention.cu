// Flash decode of a query block against a head-major KV cache.
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
// What bounds it on the H100: one AR step of the 14B model reads the whole
// valid cache of each layer (2 CFG rows x 8 kv heads x up to 4226 x 128 x 2
// tensors, ~17 MB bf16 per layer) while the query block is only 64 tokens x
// 40 heads, so the kernel is bound by cache bytes and by how many SMs stream
// them, not by FLOPs.
//
// Design: GQA is folded into the query rows exactly as on the TPU (the 5 q
// heads that share a kv head form 5*S rows), so each K/V tile is read once
// per (b, kv head, 64-row q tile) and feeds all of them. A block is 4 warps,
// each owning 16 q rows; QK^T and PV run on the tensor cores (mma.sync
// m16n8k16, bf16 in, fp32 accumulate); P is rounded to bf16 for the PV
// product, scores, the running max and the normaliser stay fp32. Tiles of
// 64 keys outside the window are never loaded. The cache is read in place in
// its head-major layout. An int8 tile is widened to bf16 as it is staged in
// shared memory: |q| <= 127 is exact in bf16, so the same tensor-core
// products serve both formats, and the int8 buffer moves a quarter of the
// bytes of two bf16 caches (each key's scales ride beside it, 8 bytes).
#include "common.cuh"

namespace {

constexpr int kD = 128;        // head dim (the kernel is specialised to it)
constexpr int kBQ = 64;        // q rows per block: 4 warps x 16
constexpr int kBKV = 64;       // keys per tile
constexpr int kLDS = kD + 8;   // padded smem row (bf16): conflict-free reads
constexpr float kNeg = -1e30f;

// 16 bytes of a cache row -> bf16 in shared memory (8 bf16 or 16 int8 values)
__device__ __forceinline__ void stage16(bf16* dst, const bf16* src, bool ok) {
  *reinterpret_cast<uint4*>(dst) =
      ok ? *reinterpret_cast<const uint4*>(src) : make_uint4(0, 0, 0, 0);
}

__device__ __forceinline__ void stage16(bf16* dst, const int8_t* src, bool ok) {
  const uint4 raw = ok ? *reinterpret_cast<const uint4*>(src) : make_uint4(0, 0, 0, 0);
  const int8_t* b = reinterpret_cast<const int8_t*>(&raw);
  uint32_t w[8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
    w[i] = pack_bf16x2(static_cast<float>(b[2 * i]), static_cast<float>(b[2 * i + 1]));
  *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
  *reinterpret_cast<uint4*>(dst + 8) = make_uint4(w[4], w[5], w[6], w[7]);
}

// T: cache element (bf16, or int8 with kv_sc [B*Hkv, 2, L] f32 scales);
// k and v point at row 0 of head 0 and rows are ld elements apart (D for
// separate caches, 2D for the fused buffer, whose v starts at k + D).
template <typename T>
__global__ void __launch_bounds__(128)
decode_attention_kernel(const bf16* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, int ld,
                        const float* __restrict__ kv_sc, bf16* __restrict__ o,
                        const int* __restrict__ kv_len,
                        const int* __restrict__ kv_start, int S, int Hq,
                        int Hkv, int L, float scale, int n_qtiles) {
  constexpr bool kQuant = sizeof(T) == 1;
  constexpr int kE = 16 / sizeof(T);  // elements per 16-byte load
  __shared__ __align__(16) bf16 Ks[kBKV * kLDS];
  __shared__ __align__(16) bf16 Vs[kBKV * kLDS];
  __shared__ float kS[kBKV], vS[kBKV];

  const int qt = blockIdx.x % n_qtiles;
  const int bh = blockIdx.x / n_qtiles;
  const int hk = bh % Hkv;
  const int b = bh / Hkv;
  const int group = Hq / Hkv;
  const int rows = group * S;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;

  const int len = min(kv_len[b], L);
  const int start = max(kv_start[b], 0);

  // q fragments of this warp's 16 rows (row r -> head hk*group + r/S, s = r%S)
  const int r0 = qt * kBQ + warp * 16;
  uint32_t qf[kD / 16][4];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + g + i * 8;
    const bool ok = r < rows;
    const int h = hk * group + (ok ? r / S : 0);
    const int s = ok ? r % S : 0;
    const bf16* qrow = q + (((size_t)b * S + s) * Hq + h) * kD;
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
      const int c = kk * 16 + tq * 2;
      qf[kk][i] = ok ? lds32(qrow + c) : 0u;
      qf[kk][i + 2] = ok ? lds32(qrow + c + 8) : 0u;
    }
  }

  float acc[kD / 8][4];
#pragma unroll
  for (int n = 0; n < kD / 8; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m_i[2] = {kNeg, kNeg};
  float l_i[2] = {0.f, 0.f};

  const size_t head_off = ((size_t)b * Hkv + hk) * (size_t)L * ld;
  const T* kh = k + head_off;
  const T* vh = v + head_off;
  const float* ksc = kQuant ? kv_sc + ((size_t)b * Hkv + hk) * 2 * (size_t)L : nullptr;

  for (int kb = (start / kBKV) * kBKV; kb < len; kb += kBKV) {
    __syncthreads();  // previous tile fully consumed
    for (int c = threadIdx.x; c < kBKV * (kD / kE); c += blockDim.x) {
      const int r = c / (kD / kE), cc = (c % (kD / kE)) * kE;
      const int key = kb + r;
      const bool ok = key < L;
      const size_t off = (size_t)(ok ? key : 0) * ld + cc;
      stage16(Ks + r * kLDS + cc, kh + off, ok);
      stage16(Vs + r * kLDS + cc, vh + off, ok);
    }
    if (kQuant && threadIdx.x < kBKV) {
      const int key = kb + threadIdx.x;
      kS[threadIdx.x] = key < L ? ksc[key] : 0.f;
      vS[threadIdx.x] = key < L ? ksc[L + key] : 0.f;
    }
    __syncthreads();

    // S = Q K^T for this warp: 16 rows x 64 keys
    float s[kBKV / 8][4];
#pragma unroll
    for (int nt = 0; nt < kBKV / 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      const bf16* krow = Ks + (nt * 8 + g) * kLDS + tq * 2;
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk) {
        uint32_t bfrag[2] = {lds32(krow + kk * 16), lds32(krow + kk * 16 + 8)};
        mma_16816(s[nt], qf[kk], bfrag);
      }
    }

    // mask to the window, scale, running max
    float mx[2] = {kNeg, kNeg};
#pragma unroll
    for (int nt = 0; nt < kBKV / 8; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int key = kb + nt * 8 + tq * 2 + (i & 1);
        const bool valid = key >= start && key < len;
        float sv = s[nt][i] * scale;
        if (kQuant) sv *= kS[key - kb];
        s[nt][i] = valid ? sv : kNeg;
        mx[i >> 1] = fmaxf(mx[i >> 1], s[nt][i]);
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
    for (int nt = 0; nt < kBKV / 8; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int key = kb + nt * 8 + tq * 2 + (i & 1);
        const bool valid = key >= start && key < len;
        const float p = valid ? __expf(s[nt][i] - m_i[i >> 1]) : 0.f;
        l_i[i >> 1] += p;  // per-thread partial; reduced over the quad at the end
        s[nt][i] = kQuant ? p * vS[key - kb] : p;  // the PV operand
      }
    }
#pragma unroll
    for (int n = 0; n < kD / 8; ++n) {
      acc[n][0] *= corr[0];
      acc[n][1] *= corr[0];
      acc[n][2] *= corr[1];
      acc[n][3] *= corr[1];
    }

    // O += P V: the C fragments of two adjacent key tiles form one A fragment
#pragma unroll
    for (int kk = 0; kk < kBKV / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16x2(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_bf16x2(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      const bf16* v0 = Vs + (kk * 16 + tq * 2) * kLDS + g;
#pragma unroll
      for (int n = 0; n < kD / 8; ++n) {
        const bf16* vp = v0 + n * 8;
        __nv_bfloat162 lo, hi;
        lo.x = vp[0];
        lo.y = vp[kLDS];
        hi.x = vp[8 * kLDS];
        hi.y = vp[9 * kLDS];
        uint32_t bfrag[2] = {*reinterpret_cast<uint32_t*>(&lo),
                             *reinterpret_cast<uint32_t*>(&hi)};
        mma_16816(acc[n], pa, bfrag);
      }
    }
  }

  float inv[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    float l = l_i[j];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    inv[j] = l > 0.f ? 1.f / l : 0.f;  // empty window -> 0
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + g + i * 8;
    if (r >= rows) continue;
    const int h = hk * group + r / S;
    const int s_idx = r % S;
    bf16* orow = o + (((size_t)b * S + s_idx) * Hq + h) * kD;
#pragma unroll
    for (int n = 0; n < kD / 8; ++n) {
      const int c = n * 8 + tq * 2;
      *reinterpret_cast<__nv_bfloat162*>(orow + c) = __floats2bfloat162_rn(
          acc[n][2 * i] * inv[i], acc[n][2 * i + 1] * inv[i]);
    }
  }
}

}  // namespace

static int launch_decode(const void* q, const void* k, const void* v, int ld,
                         const void* kv_sc, void* out, const void* kv_len,
                         const void* kv_start, int B, int S, int Hq, int Hkv,
                         int L, int D, float scale, void* stream) {
  if (D != kD || Hq % Hkv != 0 || B <= 0 || S <= 0 || L <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int rows = (Hq / Hkv) * S;
  const int n_qtiles = (rows + kBQ - 1) / kBQ;
  dim3 grid(B * Hkv * n_qtiles);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* qp = static_cast<const bf16*>(q);
  const auto* lens = static_cast<const int*>(kv_len);
  const auto* starts = static_cast<const int*>(kv_start);
  if (kv_sc != nullptr) {
    decode_attention_kernel<int8_t><<<grid, 128, 0, st>>>(
        qp, static_cast<const int8_t*>(k), static_cast<const int8_t*>(v), ld,
        static_cast<const float*>(kv_sc), static_cast<bf16*>(out), lens, starts,
        S, Hq, Hkv, L, scale, n_qtiles);
  } else {
    decode_attention_kernel<bf16><<<grid, 128, 0, st>>>(
        qp, static_cast<const bf16*>(k), static_cast<const bf16*>(v), ld, nullptr,
        static_cast<bf16*>(out), lens, starts, S, Hq, Hkv, L, scale, n_qtiles);
  }
  return static_cast<int>(cudaGetLastError());
}

// q [B,S,Hq,D], k/v [B,Hkv,L,D] (one layer of the head-major cache), out like
// q; kv_len/kv_start [B] int32 on the device. Returns cudaGetLastError().
extern "C" int bd_decode_attention(const void* q, const void* k, const void* v,
                                   void* out, const void* kv_len,
                                   const void* kv_start, int B, int S, int Hq,
                                   int Hkv, int L, int D, float scale,
                                   void* stream) {
  return launch_decode(q, k, v, D, nullptr, out, kv_len, kv_start, B, S, Hq,
                       Hkv, L, D, scale, stream);
}

// q [B,S,Hq,D] bf16; kv [B,Hkv,L,2D] (one layer of the fused ring buffer):
// bf16 when kv_sc is null, else int8 with kv_sc [B,Hkv,2,L] f32. out like q.
extern "C" int bd_decode_attention_fusedkv(const void* q, const void* kv,
                                           const void* kv_sc, void* out,
                                           const void* kv_len,
                                           const void* kv_start, int B, int S,
                                           int Hq, int Hkv, int L, int D,
                                           float scale, void* stream) {
  if (kv_sc != nullptr)
    return launch_decode(q, kv, static_cast<const int8_t*>(kv) + D, 2 * D, kv_sc,
                         out, kv_len, kv_start, B, S, Hq, Hkv, L, D, scale, stream);
  return launch_decode(q, kv, static_cast<const bf16*>(kv) + D, 2 * D, nullptr,
                       out, kv_len, kv_start, B, S, Hq, Hkv, L, D, scale, stream);
}
