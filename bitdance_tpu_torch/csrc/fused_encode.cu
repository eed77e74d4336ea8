// Tokenizer-encode tail: GroupNorm(G) -> swish -> 1x1 conv [C -> z] + bias
// -> sign, per image.
//
// Replaces the TPU kernel of bitdance_tpu/ops/fused_encode.py behind
// fused_encode_tail:
//   _fused_encode_tail_kernel  (pallas_call :83)
//
// What bounds it on the H100: bytes. The feature map is read (16.8 MB of
// bf16 at 1024 px: B 2, 64 x 64 pixels, C 1024) for 64 FLOP of product a
// pixel's channel, far below the tensor cores' balance point: 5.2 us at
// 1024 px if it were read once.
//
// The TPU kernel keeps one image's whole feature map in VMEM and runs the
// tail in one pass. A block here holds at most a few hundred KB, so the tail
// is two launches, with the feature map read twice (the second read mostly
// from the 50 MB L2, which holds the 16.8 MB map):
//   encode_stats_kernel  one block per (image, tile of kStatPix pixels),
//                        reading the tile across all channels with 16-byte
//                        loads: per-channel sums and sums of squares in fp32,
//                        then per-group partials [B, tiles, G, 2] summed in a
//                        fixed order (no atomics: two launches give equal
//                        bits). 256 blocks at 1024 px where the first design
//                        ran one block per (image, group), 64, each reading
//                        64-byte pieces of rows 2 KB apart.
//   encode_tail_kernel   one block of 16 warps per (image, kPix pixels),
//                        launched programmatic so that it stages its first
//                        weight chunk while the statistics finish. Its
//                        prologue sums the image's partials in a fixed order
//                        into mean and rstd = rsqrt(E[x^2] - mean^2 + eps),
//                        the TPU kernel's variance (fused_encode.py:43-45),
//                        and those into a scale and shift per channel. Then,
//                        per chunk of channels, x comes in with 16-byte loads
//                        (the next chunk's in flight while this one is
//                        computed), is normalised (one FMA), swished and, on
//                        the bf16 route, rounded to bf16 (as the TPU kernel
//                        casts y before its product, fused_encode.py:55-58)
//                        into shared memory; the weight chunk arrives by
//                        cp.async in the weight's own type, double-buffered.
//                        bf16: swish on the approximate exp and divide, the
//                        product on mma.sync m16n8k16 (fp32 sums, B read by
//                        ldmatrix.trans from the [C, z] layout); fp32: expf,
//                        an IEEE reciprocal and fp32 FMAs (its 1e-5 bound
//                        rules out TF32). Then the fp32 bias and out > 0 ? 1
//                        : -1 (0 maps to -1).
// The first design staged the whole [C, z] weight widened to fp32 in every
// block of 32 pixels (128 KB at C 1024, one block an SM, 32 MB of staging at
// 1024 px) and ran the bf16 route's product on fp32 FMAs too. A tail of 8
// warps with the TPU kernel's four-op normalisation and an IEEE expf and
// reciprocal on the bf16 route took ~31 us a block at every size (an SM's
// elementwise work, latency-bound with 8 warps; PERF.md).
#include "common.cuh"

namespace {

constexpr int kThreads = 256;      // the statistics kernel
constexpr int kTailThreads = 512;  // the tail: 16 warps, 4 m x 4 n mma tiles
constexpr int kStatPix = 32;       // pixels of a statistics tile
constexpr int kPix = 64;      // pixels of a tail block
constexpr int kZ = 32;        // outputs per pixel (z_channels)

template <typename T>
constexpr int kVec = 16 / static_cast<int>(sizeof(T));  // elements of a 16-byte load
template <typename T>
constexpr int kChunk = 16 * kVec<T>;  // channels of a tail step: 16 loads a pixel
template <typename T>
constexpr int kYld = kChunk<T> + kVec<T>;  // y tile row: a 16-byte pad
template <typename T>
constexpr int kWld = sizeof(T) == 2 ? kZ + 8 : kZ;  // weight chunk row

template <typename T>
__device__ __forceinline__ void unpack16(const uint4& u, float (&f)[kVec<T>]) {
  if constexpr (sizeof(T) == 2) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 v = __bfloat1622float2(h[i]);
      f[2 * i] = v.x;
      f[2 * i + 1] = v.y;
    }
  } else {
    f[0] = __uint_as_float(u.x), f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z), f[3] = __uint_as_float(u.w);
  }
}

template <typename T>
__device__ __forceinline__ uint4 pack16(const float (&f)[kVec<T>]) {
  if constexpr (sizeof(T) == 2)
    return make_uint4(pack_bf16x2(f[0], f[1]), pack_bf16x2(f[2], f[3]), pack_bf16x2(f[4], f[5]),
                      pack_bf16x2(f[6], f[7]));
  else
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                      __float_as_uint(f[3]));
}

__device__ __forceinline__ void ldsm_x2_trans(uint32_t (&r)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
}

// x [B, HW, C] (C / kVec <= kThreads); part [B, tiles, G, 2]: the sum and the
// sum of squares of each group over the tile's pixels. Thread t takes the
// 16-byte unit t % (C / kVec) of pixel rows t / (C / kVec), + rows a pass,
// ...; then a warp takes each (group, sum): lane l the group's channels l,
// l + 32, ... over the rows, then the lanes' butterfly sum.
template <typename T>
__global__ void __launch_bounds__(kThreads)
encode_stats_kernel(const T* __restrict__ x, float* __restrict__ part, int HW, int C, int G) {
  constexpr int V = kVec<T>;
  __shared__ __align__(16) float red[2][kThreads * V];
  pdl_trigger();  // the tail may launch and stage its weights
  const int nch = C / V, rp = kThreads / nch;
  const int t = threadIdx.x, ch = t % nch, r = t / nch;
  const int b = blockIdx.y, p0 = blockIdx.x * kStatPix, p1 = min(p0 + kStatPix, HW);
  if (r < rp) {
    float s[V], ss[V];
#pragma unroll
    for (int e = 0; e < V; ++e) s[e] = ss[e] = 0.f;
    const T* xp = x + (size_t)b * HW * C + (size_t)ch * V;
#pragma unroll 8
    for (int p = p0 + r; p < p1; p += rp) {
      float f[V];
      unpack16<T>(*reinterpret_cast<const uint4*>(xp + (size_t)p * C), f);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        s[e] += f[e];
        ss[e] += f[e] * f[e];
      }
    }
#pragma unroll
    for (int e = 0; e < V; e += 4) {
      *reinterpret_cast<float4*>(&red[0][r * C + ch * V + e]) =
          make_float4(s[e], s[e + 1], s[e + 2], s[e + 3]);
      *reinterpret_cast<float4*>(&red[1][r * C + ch * V + e]) =
          make_float4(ss[e], ss[e + 1], ss[e + 2], ss[e + 3]);
    }
  }
  __syncthreads();
  const int warp = t >> 5, lane = t & 31, cg = C / G;
  for (int pk = warp; pk < 2 * G; pk += kThreads / 32) {
    const int g = pk >> 1, k = pk & 1;
    float acc = 0.f;
    for (int rr = 0; rr < rp; ++rr)
      for (int c = lane; c < cg; c += 32) acc += red[k][rr * C + g * cg + c];
    acc = warp_sum(acc);
    if (lane == 0) part[(((size_t)b * gridDim.x + blockIdx.x) * G + g) * 2 + k] = acc;
  }
}

// Shared memory of the tail at C channels: the group statistics and their
// partial sums, each channel's scale and shift, two y tiles and a ring of
// three weight chunks
template <typename T>
size_t tail_smem(int C) {
  return (size_t)(2 * kTailThreads + 2 * C) * sizeof(float) +
         (size_t)2 * kPix * kYld<T> * sizeof(T) + (size_t)3 * kChunk<T> * kWld<T> * sizeof(T);
}

// swish of y: bf16 route y / (1 + 2^(-y log2 e)) on the approximate units
// (its result is rounded to bf16), fp32 route with expf and an IEEE
// reciprocal, as the first design and the plain version
template <typename T>
__device__ __forceinline__ float swish(float y) {
  if constexpr (sizeof(T) == 2) return __fdividef(y, 1.f + __expf(-y));
  else return y * (1.f / (1.f + expf(-y)));
}

// out [B, HW, z] like x; w [C, z] of x's type; part from encode_stats_kernel
// (n_tiles tiles an image). The prologue turns the group statistics into a
// scale a = rstd gn_w and a shift gn_b - mean a per channel, so that y =
// x a + shift is one FMA an element. Thread t loads 16-byte unit t % 16 of
// pixel rows t / 16 and t / 16 + 32 of each chunk. x, the weights and the
// norm's affine do not depend on the statistics kernel (x was written before
// it started): the first two chunks of x and of the weights, and gn_w /
// gn_b, are requested before the wait for it; then x and the weights run
// two chunks ahead of the chunk being computed.
template <typename T>
__global__ void __launch_bounds__(kTailThreads)
encode_tail_kernel(const T* __restrict__ x, const float* __restrict__ part, int n_tiles,
                   const float* __restrict__ gn_w, const float* __restrict__ gn_b,
                   const T* __restrict__ w, const float* __restrict__ bias,
                   T* __restrict__ out, int HW, int C, int G, float eps, int quantize) {
  constexpr int V = kVec<T>, KC = kChunk<T>, YLD = kYld<T>, WLD = kWld<T>;
  constexpr int kRows = kTailThreads / 16;  // pixel rows a load pass
  extern __shared__ __align__(16) unsigned char smem[];
  float* const stat = reinterpret_cast<float*>(smem);  // mean [G], rstd [G]
  float* const red = stat + kTailThreads;
  T* const ybuf = reinterpret_cast<T*>(red + kTailThreads);  // [2][kPix][YLD]
  T* const wbuf = ybuf + 2 * kPix * YLD;                      // [3][KC][WLD]
  float* const aff = reinterpret_cast<float*>(wbuf + 3 * KC * WLD);  // scale [C], shift [C]
  const int tid = threadIdx.x, b = blockIdx.y, p0 = blockIdx.x * kPix;
  const int nk = (C + KC - 1) / KC, cg = C / G;

  auto load_w = [&](int k) {  // chunk k into slot k % 3 (none past nk: an empty group)
    constexpr int kUnits = kZ / V;  // 16-byte units of a weight row
    T* dst = wbuf + (k % 3) * KC * WLD;
#pragma unroll
    for (int u = tid; u < KC * kUnits; u += kTailThreads) {
      const int r = u / kUnits, q = u % kUnits, c = k * KC + r;
      if (k < nk)  // rows past C arrive as zeros
        cp_async16(dst + r * WLD + q * V, w + (size_t)min(c, C - 1) * kZ + q * V,
                   c < C ? 16 : 0);
    }
    cp_async_commit();
  };
  const int u = tid & 15, pr = tid >> 4;
  const T* xb = x + (size_t)b * HW * C;
  auto load_x = [&](int k, uint4(&dst)[2]) {
    const int c = k * KC + V * u;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int p = p0 + pr + kRows * i;
      dst[i] = p < HW && c < C ? *reinterpret_cast<const uint4*>(xb + (size_t)p * C + c)
                               : make_uint4(0u, 0u, 0u, 0u);
    }
  };
  constexpr int kAffine = 4;  // channels a thread: C <= 2048
  float gwv[kAffine], gbv[kAffine];
#pragma unroll
  for (int j = 0; j < kAffine; ++j) {
    const int c = min(tid + j * kTailThreads, C - 1);
    gwv[j] = gn_w[c], gbv[j] = gn_b[c];
  }
  uint4 x0[2], x1[2], x2[2];
  load_x(0, x0);
  load_x(1, x1);
  load_w(0);
  load_w(1);
  pdl_wait();

  // the image's partials summed in a fixed order: slice k of the threads
  // takes tiles k, k + slices, ...; then the slices in order
  {
    const int q = tid % (2 * G), k = tid / (2 * G), slices = kTailThreads / (2 * G);
    float acc = 0.f;
    if (k < slices) {
      const float* pp = part + (size_t)b * n_tiles * 2 * G + q;
#pragma unroll 8
      for (int i = k; i < n_tiles; i += slices) acc += pp[(size_t)i * 2 * G];
    }
    red[tid] = acc;
    __syncthreads();
    if (tid < G) {
      float s = 0.f, ss = 0.f;
      for (int kk = 0; kk < slices; ++kk) {
        s += red[kk * 2 * G + 2 * tid];
        ss += red[kk * 2 * G + 2 * tid + 1];
      }
      const float n = static_cast<float>(HW) * cg;
      const float mean = s / n;
      const float var = ss / n - mean * mean;
      stat[tid] = mean;
      stat[G + tid] = rsqrtf(var + eps);
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kAffine; ++j) {
      const int c = tid + j * kTailThreads;
      if (c >= C) break;
      const int g = c / cg;
      const float a = stat[G + g] * gwv[j];
      aff[c] = a;
      aff[C + c] = gbv[j] - stat[g] * a;
    }
    __syncthreads();
  }

  const int warp = tid >> 5, lane = tid & 31, g8 = lane >> 2, t4 = lane & 3;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int k = 0; k < nk; ++k) {
    if (k + 2 < nk) load_x(k + 2, x2);
    T* const ys = ybuf + (k & 1) * kPix * YLD;
    {
      const int c = k * KC + V * u;
      float sc[V], sh[V];
#pragma unroll
      for (int e = 0; e < V; e += 4) {
        const int ce = min(c, C - V) + e;
        const float4 a = *reinterpret_cast<const float4*>(aff + ce);
        const float4 h = *reinterpret_cast<const float4*>(aff + C + ce);
        sc[e] = a.x, sc[e + 1] = a.y, sc[e + 2] = a.z, sc[e + 3] = a.w;
        sh[e] = h.x, sh[e + 1] = h.y, sh[e + 2] = h.z, sh[e + 3] = h.w;
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float f[V];
        unpack16<T>(x0[i], f);
#pragma unroll
        for (int e = 0; e < V; ++e) f[e] = c < C ? swish<T>(fmaf(f[e], sc[e], sh[e])) : 0.f;
        *reinterpret_cast<uint4*>(ys + (pr + kRows * i) * YLD + V * u) = pack16<T>(f);
      }
    }
    cp_async_wait<1>();  // weight chunk k (chunk k + 1 may be in flight)
    __syncthreads();     // y and the weights visible; chunk k - 1's buffers free
    load_w(k + 2);
    const T* const ws = wbuf + (k % 3) * KC * WLD;
    if constexpr (sizeof(T) == 2) {
      // warp: rows 16 (warp % 4) .. + 15, outputs 8 (warp / 4) .. + 7
      const int r0 = 16 * (warp & 3), n0 = 8 * (warp >> 2);
#pragma unroll
      for (int kk = 0; kk < KC; kk += 16) {
        const bf16* ya = reinterpret_cast<const bf16*>(ys) + (r0 + g8) * YLD + kk + 2 * t4;
        const uint32_t a[4] = {lds32(ya), lds32(ya + 8 * YLD), lds32(ya + 8),
                               lds32(ya + 8 * YLD + 8)};
        uint32_t bw[2];
        ldsm_x2_trans(bw, smem_u32(ws + (kk + (lane & 15)) * WLD + n0));
        mma_16816(acc, a, bw);
      }
    } else {
      // thread: pixel tid / 8, outputs 4 (tid % 8) .. + 3
      const float* yr = reinterpret_cast<const float*>(ys) + (tid >> 3) * YLD;
      const float* wc = reinterpret_cast<const float*>(ws) + 4 * (tid & 7);
#pragma unroll 8
      for (int kk = 0; kk < KC; ++kk) {
        const float yv = yr[kk];
        const float4 w0 = *reinterpret_cast<const float4*>(wc + kk * WLD);
        acc[0] = fmaf(yv, w0.x, acc[0]), acc[1] = fmaf(yv, w0.y, acc[1]);
        acc[2] = fmaf(yv, w0.z, acc[2]), acc[3] = fmaf(yv, w0.w, acc[3]);
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) x0[i] = x1[i], x1[i] = x2[i];
  }

  auto fin = [&](float v, int col) {
    const float r = v + bias[col];
    return quantize ? (r > 0.f ? 1.f : -1.f) : r;
  };
  if constexpr (sizeof(T) == 2) {
    const int r0 = 16 * (warp & 3), col = 8 * (warp >> 2) + 2 * t4;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = p0 + r0 + g8 + 8 * h;
      if (p < HW)
        *reinterpret_cast<uint32_t*>(out + ((size_t)b * HW + p) * kZ + col) =
            pack_bf16x2(fin(acc[2 * h], col), fin(acc[2 * h + 1], col + 1));
    }
  } else {
    const int p = p0 + (tid >> 3), col = 4 * (tid & 7);
    if (p < HW)
      *reinterpret_cast<float4*>(out + ((size_t)b * HW + p) * kZ + col) =
          make_float4(fin(acc[0], col), fin(acc[1], col + 1), fin(acc[2], col + 2),
                      fin(acc[3], col + 3));
  }
}

template <typename T>
int launch(const void* x, const void* gn_w, const void* gn_b, const void* w,
           const void* bias, void* out, void* part, int B, int HW, int C,
           int G, float eps, int quantize, cudaStream_t st) {
  const int n_tiles = (HW + kStatPix - 1) / kStatPix;
  encode_stats_kernel<T><<<dim3(n_tiles, B), kThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<float*>(part), HW, C, G);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const size_t smem = tail_smem<T>(C);
  auto kern = encode_tail_kernel<T>;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((HW + kPix - 1) / kPix, B);
  cfg.blockDim = dim3(kTailThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(
      &cfg, kern, static_cast<const T*>(x), static_cast<const float*>(part), n_tiles,
      static_cast<const float*>(gn_w), static_cast<const float*>(gn_b),
      static_cast<const T*>(w), static_cast<const float*>(bias), static_cast<T*>(out), HW, C, G,
      eps, quantize));
}

}  // namespace

// x [B, HW, C] contiguous (NHWC), bf16 (dtype 1) or fp32 (dtype 0); gn_w,
// gn_b [C] and bias [z] fp32; w [C, z] of x's type; z must be 32, C a
// multiple of G and of 16 bytes' elements (8 bf16, 4 fp32) with C / 8 (bf16)
// or C / 4 (fp32) <= 256, and G <= 128. stats: scratch [B, ceil(HW / 32),
// G, 2] fp32 (the per-tile partials). Writes out [B, HW, z] of x's type.
extern "C" int bd_fused_encode_tail(const void* x, const void* gn_w,
                                    const void* gn_b, const void* w,
                                    const void* bias, void* out, void* stats,
                                    int B, int HW, int C, int G, int z,
                                    float eps, int quantize, int dtype,
                                    void* stream) {
  const int vec = dtype == 1 ? 8 : 4;
  if (B <= 0 || HW <= 0 || G <= 0 || G > 128 || C % G != 0 || z != kZ || B > 65535 ||
      C % vec != 0 || C / vec > kThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  return dtype == 1
             ? launch<bf16>(x, gn_w, gn_b, w, bias, out, stats, B, HW, C, G, eps, quantize, st)
             : launch<float>(x, gn_w, gn_b, w, bias, out, stats, B, HW, C, G, eps, quantize,
                             st);
}
