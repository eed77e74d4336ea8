// Tokenizer-encode tail: GroupNorm(G) -> swish -> 1x1 conv [C -> z] + bias
// -> sign, per image.
//
// Replaces the TPU kernel of bitdance_tpu/ops/fused_encode.py behind
// fused_encode_tail:
//   _fused_encode_tail_kernel  (pallas_call :83)
//
// The TPU kernel keeps one image's whole feature map in VMEM and runs the
// tail in one pass. A block here holds at most a few hundred KB, so the tail
// is two launches:
//   encode_stats_kernel  one block per (image, group): sum and sum of squares
//                        in fp32 over h*w*C/G values -> mean and
//                        rsqrt(E[x^2] - mean^2 + eps), the TPU kernel's
//                        variance (fused_encode.py:43-45)
//   encode_tail_kernel   one block per (image, 32 pixels): the conv weight
//                        [C, z] staged once in shared memory as fp32, the
//                        normalised, swished activations staged in chunks of
//                        128 channels after rounding to the weight's type (as
//                        the TPU kernel casts y before its product,
//                        fused_encode.py:55-58), each thread accumulating 4
//                        of the 32 pixels x z outputs in fp32; bias, then
//                        out > 0 ? 1 : -1 (0 maps to -1).
// What bounds it on the H100: the feature map is read twice (once per
// launch) and the product is ~64 FLOP per input byte at z = 32, far below
// the tensor cores' balance point, so bytes bound it; the products run on
// the CUDA cores in fp32.
#include "common.cuh"

namespace {

constexpr int kStatThreads = 256;
constexpr int kThreads = 256;
constexpr int kPix = 32;    // pixels per block of the tail kernel
constexpr int kChunk = 128;  // channels staged at a time
constexpr int kZ = 32;       // outputs per pixel (z_channels)

template <typename T>
__device__ __forceinline__ float to_f(T v);
template <>
__device__ __forceinline__ float to_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f<bf16>(bf16 v) { return bf2f(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16(v);
}

// x [B, HW, C]; stats [B, G, 2] = (mean, rstd)
template <typename T>
__global__ void __launch_bounds__(kStatThreads)
encode_stats_kernel(const T* __restrict__ x, float* __restrict__ stats,
                    int HW, int C, int G, float eps) {
  const int g = blockIdx.x, b = blockIdx.y;
  const int cg = C / G;
  const T* xb = x + (size_t)b * HW * C + (size_t)g * cg;
  float s = 0.f, s2 = 0.f;
  const int n = HW * cg;
  for (int i = threadIdx.x; i < n; i += kStatThreads) {
    const int p = i / cg, c = i - p * cg;
    const float v = to_f(xb[(size_t)p * C + c]);
    s += v;
    s2 += v * v;
  }
  block_sum2(s, s2);
  if (threadIdx.x == 0) {
    const float mean = s / n;
    const float var = s2 / n - mean * mean;
    stats[((size_t)b * G + g) * 2] = mean;
    stats[((size_t)b * G + g) * 2 + 1] = rsqrtf(var + eps);
  }
}

// out [B, HW, z] like x; w [C, z] of type TW (the product's operand type)
template <typename T, typename TW>
__global__ void __launch_bounds__(kThreads)
encode_tail_kernel(const T* __restrict__ x, const float* __restrict__ stats,
                   const float* __restrict__ gn_w, const float* __restrict__ gn_b,
                   const TW* __restrict__ w, const float* __restrict__ bias,
                   T* __restrict__ out, int HW, int C, int G, int quantize) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* Ws = reinterpret_cast<float*>(smem);   // [C][kZ]
  float* Ys = Ws + (size_t)C * kZ;              // [kPix][kChunk + 1]
  constexpr int YLD = kChunk + 1;
  const int b = blockIdx.y, p0 = blockIdx.x * kPix;
  const int cg = C / G;
  const float* st = stats + (size_t)b * G * 2;

  for (int i = threadIdx.x; i < C * kZ; i += kThreads) Ws[i] = to_f(w[i]);

  const int tp = threadIdx.x >> 3;          // this thread's pixel
  const int j0 = (threadIdx.x & 7) * 4;     // and its 4 outputs
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  const T* xb = x + (size_t)b * HW * C;

  for (int c0 = 0; c0 < C; c0 += kChunk) {
    const int nc = min(kChunk, C - c0);
    __syncthreads();  // Ws staged / previous chunk consumed
    for (int i = threadIdx.x; i < kPix * kChunk; i += kThreads) {
      const int pp = i / kChunk, cc = i - pp * kChunk;
      const int p = p0 + pp, c = c0 + cc;
      float y = 0.f;
      if (p < HW && cc < nc) {
        const int g = c / cg;
        y = (to_f(xb[(size_t)p * C + c]) - st[2 * g]) * st[2 * g + 1];
        y = y * gn_w[c] + gn_b[c];
        y = y * (1.f / (1.f + expf(-y)));            // swish
        y = to_f(from_f<TW>(y));                     // the product's operand
      }
      Ys[pp * YLD + cc] = y;
    }
    __syncthreads();
    const float* yrow = Ys + tp * YLD;
    const float* wc = Ws + (size_t)c0 * kZ + j0;
    for (int cc = 0; cc < nc; ++cc) {
      const float yv = yrow[cc];
      const float4 wv = *reinterpret_cast<const float4*>(wc + cc * kZ);
      acc[0] = fmaf(yv, wv.x, acc[0]);
      acc[1] = fmaf(yv, wv.y, acc[1]);
      acc[2] = fmaf(yv, wv.z, acc[2]);
      acc[3] = fmaf(yv, wv.w, acc[3]);
    }
  }

  const int p = p0 + tp;
  if (p >= HW) return;
  T* o = out + ((size_t)b * HW + p) * kZ + j0;
#pragma unroll
  for (int jj = 0; jj < 4; ++jj) {
    float r = acc[jj] + bias[j0 + jj];
    if (quantize) r = r > 0.f ? 1.f : -1.f;
    o[jj] = from_f<T>(r);
  }
}

template <typename T, typename TW>
int launch(const void* x, const void* gn_w, const void* gn_b, const void* w,
           const void* bias, void* out, void* stats, int B, int HW, int C,
           int G, float eps, int quantize, cudaStream_t st) {
  encode_stats_kernel<T><<<dim3(G, B), kStatThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<float*>(stats), HW, C, G, eps);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int smem = (C * kZ + kPix * (kChunk + 1)) * 4;
  auto kern = encode_tail_kernel<T, TW>;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  kern<<<dim3((HW + kPix - 1) / kPix, B), kThreads, smem, st>>>(
      static_cast<const T*>(x), static_cast<const float*>(stats),
      static_cast<const float*>(gn_w), static_cast<const float*>(gn_b),
      static_cast<const TW*>(w), static_cast<const float*>(bias),
      static_cast<T*>(out), HW, C, G, quantize);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x [B, HW, C] contiguous (NHWC), bf16 (dtype 1) or fp32 (dtype 0); gn_w,
// gn_b [C] and bias [z] fp32; w [C, z] of x's type; z must be 32 and C a
// multiple of G with C * 32 * 4 bytes of weights fitting shared memory.
// stats: scratch [B, G, 2] fp32. Writes out [B, HW, z] of x's type.
extern "C" int bd_fused_encode_tail(const void* x, const void* gn_w,
                                    const void* gn_b, const void* w,
                                    const void* bias, void* out, void* stats,
                                    int B, int HW, int C, int G, int z,
                                    float eps, int quantize, int dtype,
                                    void* stream) {
  if (B <= 0 || HW <= 0 || G <= 0 || C % G != 0 || z != kZ || B > 65535 ||
      (C * kZ + kPix * (kChunk + 1)) * 4 > 227 * 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  return dtype == 1
             ? launch<bf16, bf16>(x, gn_w, gn_b, w, bias, out, stats, B, HW, C,
                                  G, eps, quantize, st)
             : launch<float, float>(x, gn_w, gn_b, w, bias, out, stats, B, HW,
                                    C, G, eps, quantize, st);
}
