// Integer products for the quantized paths: per-row int8 quantization of
// activations and an s8 x s8 -> s32 tensor-core GEMM whose B operand is int8
// [N, K] or packed int4 [N, K/2], with the head GEMM's epilogues
// (head_blocks.cuh) after the dequantization y = acc * (sa[row] * ws[col]).
//
// mma.sync.m16n8k32 s8 fragments (PTX ISA, "Matrix fragments for
// mma.m16n8k32"), g = lane / 4, t = lane % 4, four int8 per 32-bit register:
//   A (16x32, row-major): a0 = (g, 4t..4t+3)    a1 = (g+8, 4t..4t+3)
//                         a2 = (g, 16+4t..+3)   a3 = (g+8, 16+4t..+3)
//   B (32x8, col-major) : b0 = (k 4t..4t+3, n g)   b1 = (k 16+4t..+3, n g)
//   C (16x8, s32)       : as the bf16 m16n8k16 (common.cuh).
// B wants K contiguous per output column, so weights stay [N, K] (packed:
// [N, K/2]); sm_90's ldmatrix has no transpose for 8-bit data. A packed
// byte [n, j] holds k = j (low nibble) and k = j + K/2 (high nibble): one
// 32-bit word of 4 bytes unpacks in registers into the b register of the
// low plane (against A columns j..j+3) and of the high plane (against
// A columns K/2 + j..), each nibble sign-extended by a per-byte xor and
// subtract.
#pragma once

#include "head_blocks.cuh"

namespace {

constexpr int kQBK = 64;          // bytes of a W row per pipeline stage
constexpr int kQLD = kQBK + 16;   // padded smem row: conflict-free 32-bit reads

__device__ __forceinline__ void mma_s8_16832(int c[4], const uint32_t a[4],
                                             const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// four packed bytes -> their sign-extended low / high nibbles as int8 x4
__device__ __forceinline__ uint32_t nibbles_lo(uint32_t w) {
  return __vsub4((w & 0x0F0F0F0Fu) ^ 0x08080808u, 0x08080808u);
}

__device__ __forceinline__ uint32_t nibbles_hi(uint32_t w) {
  return __vsub4(((w >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u, 0x08080808u);
}

__device__ __forceinline__ float block_max(float v) {
  __shared__ float red[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_max(v);
  __syncthreads();  // red may still be read by a previous call
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = lane < (int)(blockDim.x >> 5) ? red[lane] : 0.f;
  return warp_max(v);
}

// Per-row int8 quantization, one block per row: s = max(amax / 127, 1e-12),
// q = clamp(rint(x / s), -127, 127) with a true division and round half to
// even (the JAX package's _quantize_rows / stage_quant, bit for bit).
template <typename T>
__global__ void __launch_bounds__(256)
quantize_rows_kernel(const T* __restrict__ x, int ldx, int K,
                     int8_t* __restrict__ q, int ldq, float* __restrict__ sx) {
  const T* xr = x + (size_t)blockIdx.x * ldx;
  float amax = 0.f;
  for (int i = threadIdx.x; i < K; i += blockDim.x)
    amax = fmaxf(amax, fabsf(to_f32(xr[i])));
  amax = block_max(amax);
  const float s = fmaxf(amax / 127.f, 1e-12f);
  int8_t* qr = q + (size_t)blockIdx.x * ldq;
  for (int i = threadIdx.x; i < K; i += blockDim.x) {
    const int v = __float2int_rn(to_f32(xr[i]) / s);
    qr[i] = static_cast<int8_t>(max(-127, min(127, v)));
  }
  if (threadIdx.x == 0) sx[blockIdx.x] = s;
}

template <typename T>
cudaError_t launch_quantize_rows(const T* x, int ldx, int K, int8_t* q,
                                 int ldq, float* sx, int M, cudaStream_t st) {
  quantize_rows_kernel<T><<<M, 256, 0, st>>>(x, ldx, K, q, ldq, sx);
  return cudaGetLastError();
}

// epilogue(dequant(A[M,K] @ W^T)): A int8 row-major (lda) with row scales
// sa [M]; W int8 [N, ldw] with column scales ws [N], ldw = K (INT4 false) or
// K/2 packed (INT4 true). 64x64 output tiles, 4 warps of 32x32, 3-stage
// cp.async pipeline over 64-byte slices of the W rows (64 k, or 128 k when
// packed: the slice's low and high planes pair with A columns [j0, j0+64)
// and [K/2 + j0, K/2 + j0 + 64)). Needs K % 64 == 0 (128 packed) and
// N % 64 == 0; rows of A past M are zero-filled and not stored.
template <int MODE, bool INT4>
__global__ void __launch_bounds__(128)
gemm_s8_kernel(const int8_t* __restrict__ A, int lda, const float* __restrict__ sa,
               const int8_t* __restrict__ W, int ldw, const float* __restrict__ ws,
               int K, int M, const bf16* __restrict__ bias, bf16* __restrict__ out,
               float* __restrict__ out_f32, int ldo, float* __restrict__ resid,
               int ldr, const bf16* __restrict__ gate, int ldg,
               const bf16* __restrict__ xres, int ldx, int hidden) {
  constexpr int kPlanes = INT4 ? 2 : 1;
  __shared__ __align__(16) int8_t As[kStages][kPlanes][kBM][kQLD];
  __shared__ __align__(16) int8_t Bs[kStages][kBN][kQLD];

  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int wm = warp & 1, wn = warp >> 1;
  const int khalf = K / 2;

  auto load_stage = [&](int slot, int kt) {
    const int k0 = kt * kQBK;
#pragma unroll
    for (int c = tid; c < kBM * (kQBK / 16); c += 128) {
      const int r = c >> 2, cc = (c & 3) * 16;
      const int row = m0 + r;
      const int8_t* src = A + (size_t)min(row, M - 1) * lda + k0 + cc;
      cp_async16(&As[slot][0][r][cc], src, row < M ? 16 : 0);
      if (INT4) cp_async16(&As[slot][kPlanes - 1][r][cc], src + khalf, row < M ? 16 : 0);
    }
#pragma unroll
    for (int c = tid; c < kBN * (kQBK / 16); c += 128) {
      const int r = c >> 2, cc = (c & 3) * 16;
      const int8_t* src =
          W + (size_t)weight_row<MODE>(n0, r, hidden) * ldw + k0 + cc;
      cp_async16(&Bs[slot][r][cc], src, 16);
    }
  };

  int acc[2][4][4];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b)
      acc[a][b][0] = acc[a][b][1] = acc[a][b][2] = acc[a][b][3] = 0;

  const int KT = ldw / kQBK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < KT) load_stage(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const int pf = kt + kStages - 1;
    if (pf < KT) load_stage(pf % kStages, pf);
    cp_async_commit();
    const int slot = kt % kStages;
#pragma unroll
    for (int ks = 0; ks < kQBK / 32; ++ks) {
      const int c = ks * 32 + tq * 4;
      uint32_t af[kPlanes][2][4], bw[4][2];
#pragma unroll
      for (int p = 0; p < kPlanes; ++p)
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const int r = wm * 32 + mt * 16 + g;
          af[p][mt][0] = *reinterpret_cast<const uint32_t*>(&As[slot][p][r][c]);
          af[p][mt][1] = *reinterpret_cast<const uint32_t*>(&As[slot][p][r + 8][c]);
          af[p][mt][2] = *reinterpret_cast<const uint32_t*>(&As[slot][p][r][c + 16]);
          af[p][mt][3] = *reinterpret_cast<const uint32_t*>(&As[slot][p][r + 8][c + 16]);
        }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int r = wn * 32 + nt * 8 + g;
        bw[nt][0] = *reinterpret_cast<const uint32_t*>(&Bs[slot][r][c]);
        bw[nt][1] = *reinterpret_cast<const uint32_t*>(&Bs[slot][r][c + 16]);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        if (INT4) {
          const uint32_t lo[2] = {nibbles_lo(bw[nt][0]), nibbles_lo(bw[nt][1])};
          const uint32_t hi[2] = {nibbles_hi(bw[nt][0]), nibbles_hi(bw[nt][1])};
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            mma_s8_16832(acc[mt][nt], af[0][mt], lo);
            mma_s8_16832(acc[mt][nt], af[kPlanes - 1][mt], hi);
          }
        } else {
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) mma_s8_16832(acc[mt][nt], af[0][mt], bw[nt]);
        }
      }
    }
  }
  cp_async_wait<0>();

  // y = float(acc) * (sa[row] * ws[col]); ws follows the tile's weight rows
  float y[2][4][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = m0 + wm * 32 + mt * 16 + g + (i >> 1) * 8;
      const float s_row = sa[min(row, M - 1)];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int wr = weight_row<MODE>(n0, wn * 32 + nt * 8 + tq * 2 + (i & 1), hidden);
        y[mt][nt][i] = static_cast<float>(acc[mt][nt][i]) * (s_row * ws[wr]);
      }
    }
  store_tile<MODE>(y, m0, n0, M, bias, out, out_f32, ldo, resid, ldr, gate, ldg,
                   xres, ldx, hidden);
}

// K is the logical contraction length (the packed weight rows hold K/2)
template <int MODE, bool INT4>
cudaError_t launch_gemm_s8(const int8_t* A, int lda, const float* sa,
                           const int8_t* W, const float* ws, int K, int M, int N,
                           const Epilogue& ep, cudaStream_t st) {
  const int ldw = INT4 ? K / 2 : K;
  if (ldw % kQBK != 0 || N % kBN != 0) return cudaErrorInvalidValue;
  dim3 grid((M + kBM - 1) / kBM, N / kBN);
  gemm_s8_kernel<MODE, INT4><<<grid, 128, 0, st>>>(
      A, lda, sa, W, ldw, ws, K, M, ep.bias,
      out_is_f32(MODE) ? nullptr : static_cast<bf16*>(ep.out),
      out_is_f32(MODE) ? static_cast<float*>(ep.out) : nullptr, ep.ldo,
      ep.resid, ep.ldr, ep.gate, ep.ldg, ep.x, ep.ldx, ep.hidden);
  return cudaGetLastError();
}

}  // namespace
