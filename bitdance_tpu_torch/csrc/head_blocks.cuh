// Building blocks shared by the diffusion head's kernels (fused_head.cu, the
// whole sampler; fused_block.cu, one head block per call; fused_net.cu, one
// whole net forward): the epilogue modes and operands of their GEMMs (every
// product runs on head_gemm.cuh), the LayerNorm + adaLN modulate kernels,
// row quantization, window attention on bf16 qkv, the input projection and
// one whole bf16 head block (head_block).
#pragma once

#include "common.cuh"

#define BD_CHECK(expr)                                  \
  do {                                                  \
    cudaError_t e_ = (expr);                            \
    if (e_ != cudaSuccess) return static_cast<int>(e_); \
  } while (0)

#define BD_CHECK_ERR(expr)                \
  do {                                    \
    cudaError_t e_ = (expr);              \
    if (e_ != cudaSuccess) return e_;     \
  } while (0)

namespace {

enum GemmMode {
  kBiasBf16 = 0,       // out bf16 = acc + bias
  kGatedResidual = 1,  // resid fp32 += (acc + bias) * gate
  kSwiGLU = 2,         // out bf16 = silu(bf16(h1)) * bf16(h2), h = acc + bias
  kSwiGLUF32 = 3,      // out bf16 = silu(h1) * h2 with h1, h2 kept in fp32
  kBiasF32 = 4,        // out fp32 = acc + bias
  kGatedResidualBf16 = 5,  // out bf16 = x + (acc + bias) * gate
  kOutF32 = 7,         // out fp32 = acc (no bias)
  kSwiGLUQ = 8,        // out fp32 = silu(bf16(h1)) * bf16(h2), h = acc + bias (head GEMM)
  // the TPU kernels' _block_body in bf16 (every elementwise op rounds):
  kGatedResidualRound = 9,  // resid = bf16(resid + bf16(bf16(acc + bias) * gate))
  kSwiGLURound = 10,   // out bf16 = bf16(silu(bf16(h1))) * bf16(h2)
  // kSwiGLURound with torch's IEEE silu, on the integer kinds (the round
  // route's quant modes: its bf16 output is the w2 row quantization's input)
  kSwiGLURoundQ = 11,
  // the integer kinds' raw sums: out int32 = acc (no scale, no bias), for a
  // row-parallel product whose int32 partials are all-reduced before the
  // scales apply (the tensor-parallel head)
  kOutS32 = 12,
};

__host__ __device__ constexpr bool is_swiglu(int mode) {
  return mode == kSwiGLU || mode == kSwiGLUF32 || mode == kSwiGLUQ ||
         mode == kSwiGLURound || mode == kSwiGLURoundQ;
}

__host__ __device__ constexpr bool is_gated(int mode) {
  return mode == kGatedResidual || mode == kGatedResidualRound;
}

// What the epilogue reads and writes; unused fields are ignored by a mode.
// The head GEMM hands each field to the kernel as its own __restrict__
// parameter: with the pointers behind a struct the compiler must assume they
// alias and serialises the epilogue's loads behind its stores (the 14B
// head's 50-step sample took 290 ms that way, 219 ms with __restrict__).
struct Epilogue {
  const bf16* bias;
  void* out;           // bf16, or fp32 for kBiasF32
  int ldo;
  float* resid;        // kGatedResidual
  int ldr;
  const bf16* gate;    // gated modes; ldg 0 broadcasts one row
  int ldg;
  const bf16* x;       // kGatedResidualBf16: the residual input
  int ldx;
  int hidden;          // SwiGLU modes: columns of h1 (h2 follows)
  const float* sa;     // the head GEMM's integer routes: row scales [R]
  const float* ws;     // and column scales, indexed as bias
};

// out[r] = bf16((LN(h[r]) * nw + nb) * (1 + scale[r]) + shift[r]), fp32
// math; h rows are C apart, scale and shift rows ld_scale / ld_shift apart
// (0 broadcasts one row). One block per row. TWO_PASS takes the centred
// variance (the block kernels' LN); otherwise E[x^2] - E[x]^2 (the sampler's).
// CHAIN rounds as _block_body's bf16 ops do: the LN output, its affine
// (product, then sum), 1 + scale, the modulated product and the final sum.
template <typename T, bool TWO_PASS, bool CHAIN = false>
__global__ void __launch_bounds__(256)
ln_modulate_kernel(const T* __restrict__ h, int C,
                   const bf16* __restrict__ nw, const bf16* __restrict__ nb,
                   const bf16* __restrict__ scale, int ld_scale,
                   const bf16* __restrict__ shift, int ld_shift,
                   bf16* __restrict__ out, float eps) {
  pdl_trigger();
  pdl_wait();
  const int r = blockIdx.x;
  const T* hr = h + (size_t)r * C;
  auto val = [&](int i) -> float {
    if constexpr (sizeof(T) == 4) return hr[i];
    else return bf2f(hr[i]);
  };
  float s = 0.f, ss = 0.f;
  for (int i = threadIdx.x; i < C; i += blockDim.x) {
    const float x = val(i);
    s += x;
    if (!TWO_PASS) ss += x * x;
  }
  block_sum2(s, ss);
  const float mean = s / C;
  float var;
  if (TWO_PASS) {
    float dd = 0.f, unused = 0.f;
    for (int i = threadIdx.x; i < C; i += blockDim.x) {
      const float d = val(i) - mean;
      dd += d * d;
    }
    block_sum2(dd, unused);
    var = dd / C;
  } else {
    var = fmaxf(ss / C - mean * mean, 0.f);
  }
  const float rstd = rsqrtf(var + eps);
  const bf16* sc = scale + (size_t)r * ld_scale;
  const bf16* sh = shift + (size_t)r * ld_shift;
  for (int i = threadIdx.x; i < C; i += blockDim.x) {
    float y;
    if (CHAIN) {
      const float a = round_bf16((val(i) - mean) * rstd);
      const float b = round_bf16(round_bf16(a * bf2f(nw[i])) + bf2f(nb[i]));
      y = round_bf16(b * round_bf16(1.f + bf2f(sc[i]))) + bf2f(sh[i]);
    } else {
      const float ln = (val(i) - mean) * rstd * bf2f(nw[i]) + bf2f(nb[i]);
      y = ln * (1.f + bf2f(sc[i])) + bf2f(sh[i]);
    }
    out[(size_t)r * C + i] = __float2bfloat16(y);
  }
}

// 8 bf16 in 16 bytes <-> 8 floats; 4 bf16 in 8 bytes -> 4 floats
__device__ __forceinline__ void unpack8(const uint4& u, float (&f)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 v = __bfloat1622float2(h[i]);
    f[2 * i] = v.x;
    f[2 * i + 1] = v.y;
  }
}

__device__ __forceinline__ uint4 pack8(const float (&f)[8]) {
  return make_uint4(pack_bf16x2(f[0], f[1]), pack_bf16x2(f[2], f[3]), pack_bf16x2(f[4], f[5]),
                    pack_bf16x2(f[6], f[7]));
}

__device__ __forceinline__ float4 unpack4(const uint2& u) {
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

// The quant mode's row quantization (quantize_rows): the scale of a row
// from its max |x|, and four values quantized with it
constexpr int kQuantVec = 8;

__device__ __forceinline__ float row_quant_scale(float amax) {
  return fmaxf(__fdiv_rn(amax, 127.f), 1e-12f);
}

__device__ __forceinline__ uint32_t quant4(const float4& v, float s) {
  auto q = [&](float x) {
    return static_cast<uint32_t>(max(-127, min(127, __float2int_rn(__fdiv_rn(x, s))))) & 0xFFu;
  };
  return q(v.x) | q(v.y) << 8 | q(v.z) << 16 | q(v.w) << 24;
}

// ln_modulate_kernel's function for kernel #2's blocks (fp32 h, one-pass
// statistics, fp32 math; C % 4 == 0, C <= 1024 kLnVec) with every load of a
// row issued together: each thread's kLnVec float4 groups of h and their
// 4-value groups of the norm's weight and bias and of the row's scale and
// shift go into registers before the block's sums (the first version's
// three loops of dependent scalar loads took 15.5 us a launch at the 14B
// head's C 5120, R 128; this one 3.3 us). OutT bf16: the bf16 stage input;
// int8_t (the quant mode's stage_quant): the fp32 row quantized as
// quantize_rows_vec_kernel does, its scale to row_scale[r], with the row
// held in registers.
constexpr int kLnVec = 5;

template <typename OutT>
__global__ void __launch_bounds__(256)
ln_modulate_rows_kernel(const float* __restrict__ h, int C, const bf16* __restrict__ nw,
                        const bf16* __restrict__ nb, const bf16* __restrict__ scale,
                        int ld_scale, const bf16* __restrict__ shift, int ld_shift,
                        OutT* __restrict__ out, float* __restrict__ row_scale, float eps) {
  pdl_trigger();
  const int r = blockIdx.x, c4 = C / 4;
  const float4* hr = reinterpret_cast<const float4*>(h + (size_t)r * C);
  const uint2* w4 = reinterpret_cast<const uint2*>(nw);
  const uint2* b4 = reinterpret_cast<const uint2*>(nb);
  const uint2* s4 = reinterpret_cast<const uint2*>(scale + (size_t)r * ld_scale);
  const uint2* t4 = reinterpret_cast<const uint2*>(shift + (size_t)r * ld_shift);
  uint2 wv[kLnVec], bv[kLnVec], sv[kLnVec], tv[kLnVec];
#pragma unroll
  for (int q = 0; q < kLnVec; ++q) {  // the weights and mods never depend on the kernel ahead
    const int i = threadIdx.x + q * 256;
    if (i < c4) wv[q] = w4[i], bv[q] = b4[i], sv[q] = s4[i], tv[q] = t4[i];
  }
  pdl_wait();
  float4 x[kLnVec];
#pragma unroll
  for (int q = 0; q < kLnVec; ++q) {
    const int i = threadIdx.x + q * 256;
    x[q] = i < c4 ? hr[i] : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  float s = 0.f, ss = 0.f;
#pragma unroll
  for (int q = 0; q < kLnVec; ++q) {
    s += (x[q].x + x[q].y) + (x[q].z + x[q].w);
    ss += (x[q].x * x[q].x + x[q].y * x[q].y) + (x[q].z * x[q].z + x[q].w * x[q].w);
  }
  block_sum2(s, ss);
  const float mean = s / C;
  const float rstd = rsqrtf(fmaxf(ss / C - mean * mean, 0.f) + eps);
  float amax = 0.f;
#pragma unroll
  for (int q = 0; q < kLnVec; ++q) {
    const int i = threadIdx.x + q * 256;
    if (i >= c4) continue;
    const float4 w = unpack4(wv[q]), b = unpack4(bv[q]), a = unpack4(sv[q]), t = unpack4(tv[q]);
    x[q].x = ((x[q].x - mean) * rstd * w.x + b.x) * (1.f + a.x) + t.x;
    x[q].y = ((x[q].y - mean) * rstd * w.y + b.y) * (1.f + a.y) + t.y;
    x[q].z = ((x[q].z - mean) * rstd * w.z + b.z) * (1.f + a.z) + t.z;
    x[q].w = ((x[q].w - mean) * rstd * w.w + b.w) * (1.f + a.w) + t.w;
    amax = fmaxf(fmaxf(amax, fmaxf(fabsf(x[q].x), fabsf(x[q].y))),
                 fmaxf(fabsf(x[q].z), fabsf(x[q].w)));
  }
  if constexpr (sizeof(OutT) == 1) {
    const float sc = row_quant_scale(block_max(amax));
    uint32_t* o4 = reinterpret_cast<uint32_t*>(out + (size_t)r * C);
#pragma unroll
    for (int q = 0; q < kLnVec; ++q) {
      const int i = threadIdx.x + q * 256;
      if (i < c4) o4[i] = quant4(x[q], sc);
    }
    if (threadIdx.x == 0) row_scale[r] = sc;
  } else {
    uint2* o4 = reinterpret_cast<uint2*>(out + (size_t)r * C);
#pragma unroll
    for (int q = 0; q < kLnVec; ++q) {
      const int i = threadIdx.x + q * 256;
      if (i < c4) o4[i] = make_uint2(pack_bf16x2(x[q].x, x[q].y), pack_bf16x2(x[q].z, x[q].w));
    }
  }
}

// Per-row int8 quantization of fp32 or bf16 rows [R, K] (K % 4 == 0, K <=
// 1024 kQuantVec), one block of 256 per row with the row held in registers
// (its 4-value loads issued together): the scale s = max(amax / 127, 1e-12)
// to sx[r], q = clamp(rint(x / s), -127, 127) with a true division and round
// half to even (quantize_rows, the JAX stage_quant and _mmq, bit for bit).
// fp32: kernel #2's quant modes' window-attention and SwiGLU outputs; bf16:
// the round route's (#3/#4).
template <typename T>
__global__ void __launch_bounds__(256)
quantize_rows_vec_kernel(const T* __restrict__ x, int K, int8_t* __restrict__ q,
                         float* __restrict__ sx) {
  pdl_trigger();
  pdl_wait();
  const int r = blockIdx.x, k4 = K / 4;
  float4 v[kQuantVec];
  float amax = 0.f;
#pragma unroll
  for (int j = 0; j < kQuantVec; ++j) {
    const int i = threadIdx.x + j * 256;
    v[j] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (i < k4) {
      if constexpr (sizeof(T) == 4)
        v[j] = reinterpret_cast<const float4*>(x + (size_t)r * K)[i];
      else
        v[j] = unpack4(reinterpret_cast<const uint2*>(x + (size_t)r * K)[i]);
    }
    amax = fmaxf(fmaxf(amax, fmaxf(fabsf(v[j].x), fabsf(v[j].y))),
                 fmaxf(fabsf(v[j].z), fabsf(v[j].w)));
  }
  const float s = row_quant_scale(block_max(amax));
  uint32_t* o4 = reinterpret_cast<uint32_t*>(q + (size_t)r * K);
#pragma unroll
  for (int j = 0; j < kQuantVec; ++j) {
    const int i = threadIdx.x + j * 256;
    if (i < k4) o4[i] = quant4(v[j], s);
  }
  if (threadIdx.x == 0) sx[r] = s;
}

// ln_modulate_kernel<float, false, true>'s function for the round route's
// quant modes (#3/#4, _block_body's moded() then _mmq's quantization): the
// bf16 chain of every element of row r (C <= kLnChainMax) kept in shared
// memory, its max |value| reduced, then the row quantized as
// quantize_rows_vec_kernel does, its scale to row_scale[r].
constexpr int kLnChainMax = 5120;

__global__ void __launch_bounds__(256)
ln_modulate_chain_q_kernel(const float* __restrict__ h, int C, const bf16* __restrict__ nw,
                           const bf16* __restrict__ nb, const bf16* __restrict__ scale,
                           int ld_scale, const bf16* __restrict__ shift, int ld_shift,
                           int8_t* __restrict__ out, float* __restrict__ row_scale,
                           float eps) {
  __shared__ float ys[kLnChainMax];
  pdl_trigger();
  pdl_wait();
  const int r = blockIdx.x;
  const float* hr = h + (size_t)r * C;
  float s = 0.f, ss = 0.f;
  for (int i = threadIdx.x; i < C; i += blockDim.x) {
    const float x = hr[i];
    s += x;
    ss += x * x;
  }
  block_sum2(s, ss);
  const float mean = s / C;
  const float rstd = rsqrtf(fmaxf(ss / C - mean * mean, 0.f) + eps);
  const bf16* sc = scale + (size_t)r * ld_scale;
  const bf16* sh = shift + (size_t)r * ld_shift;
  float amax = 0.f;
  for (int i = threadIdx.x; i < C; i += blockDim.x) {  // each thread reads back its own
    const float a = round_bf16((hr[i] - mean) * rstd);
    const float b = round_bf16(round_bf16(a * bf2f(nw[i])) + bf2f(nb[i]));
    const float y = round_bf16(round_bf16(b * round_bf16(1.f + bf2f(sc[i]))) + bf2f(sh[i]));
    ys[i] = y;
    amax = fmaxf(amax, fabsf(y));
  }
  const float rs = row_quant_scale(block_max(amax));
  for (int i = threadIdx.x; i < C; i += blockDim.x)
    out[(size_t)r * C + i] =
        static_cast<int8_t>(max(-127, min(127, __float2int_rn(__fdiv_rn(ys[i], rs)))));
  if (threadIdx.x == 0) row_scale[r] = rs;
}

template <typename T>
__device__ __forceinline__ float to_f32(T v) {
  if constexpr (sizeof(T) == 4) return v;
  else return bf2f(v);
}

// Row stride of the q, k, v tiles in shared memory (bf16): an odd number
// of 32-bit words, so that the rows fall in distinct banks.
__host__ __device__ constexpr int window_ld(int hd) { return hd + 2; }

inline size_t window_attention_smem(int w, int hd) {
  return (size_t)3 * w * window_ld(hd) * sizeof(bf16) + (size_t)w * w * sizeof(float);
}

// Window attention over bf16 qkv [R, 3C] (column order (3, n_head, hd)), the
// round route's stage activations (#3/#4, #5). One CTA per (group of w rows,
// head); q is scaled and stored as bf16; scores, softmax and accumulation in
// fp32; out [R, C] bf16. Dynamic shared memory: window_attention_smem(w, hd).
__global__ void __launch_bounds__(256)
window_attention_kernel(const bf16* __restrict__ qkv, int C, int w, int hd,
                        int n_head, float scale, bf16* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ldw = window_ld(hd);
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* ks = qs + w * ldw;
  bf16* vs = ks + w * ldw;
  float* ps = reinterpret_cast<float*>(vs + w * ldw);
  pdl_trigger();
  pdl_wait();

  const int gi = blockIdx.x / n_head, hh = blockIdx.x % n_head;
  const int row0 = gi * w;
  const size_t ld = 3 * (size_t)C;
  for (int idx = threadIdx.x; idx < w * hd; idx += blockDim.x) {
    const int i = idx / hd, d = idx % hd;
    const bf16* src = qkv + (size_t)(row0 + i) * ld + hh * hd + d;
    qs[i * ldw + d] = __float2bfloat16(bf2f(src[0]) * scale);
    ks[i * ldw + d] = src[C];
    vs[i * ldw + d] = src[2 * C];
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < w * w; idx += blockDim.x) {
    const int i = idx / w, j = idx % w;
    float acc = 0.f;
    const __nv_bfloat162* qa = reinterpret_cast<const __nv_bfloat162*>(qs + i * ldw);
    const __nv_bfloat162* ka = reinterpret_cast<const __nv_bfloat162*>(ks + j * ldw);
    for (int d = 0; d < hd / 2; ++d) {
      const float2 a = __bfloat1622float2(qa[d]);
      const float2 b = __bfloat1622float2(ka[d]);
      acc += a.x * b.x + a.y * b.y;
    }
    ps[idx] = acc;
  }
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int i = warp; i < w; i += blockDim.x >> 5) {
    float m = -INFINITY;
    for (int j = lane; j < w; j += 32) m = fmaxf(m, ps[i * w + j]);
    m = warp_max(m);
    float sum = 0.f;
    for (int j = lane; j < w; j += 32) {
      const float e = expf(ps[i * w + j] - m);
      ps[i * w + j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    const float inv = 1.f / sum;
    for (int j = lane; j < w; j += 32) ps[i * w + j] *= inv;
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < w * hd; idx += blockDim.x) {
    const int i = idx / hd, d = idx % hd;
    float acc = 0.f;
    for (int j = 0; j < w; ++j) acc += ps[i * w + j] * bf2f(vs[j * ldw + d]);
    out[(size_t)(row0 + i) * C + hh * hd + d] = __float2bfloat16(acc);
  }
}

// Window attention for kernel #2's blocks: window_attention_kernel's
// function with a head dim of 128 and windows of up to 64 rows
// (scores, softmax and P V in fp32, q scaled and rounded to bf16 first, bf16
// out), one CTA of 256 threads per (window, head). q, k and v come in with
// 16-byte loads (rows 272 bytes apart in shared memory: no bank conflict);
// the scores come from mma.sync (bf16 products exact, fp32 sums) into fp32
// over q's tile; thread (it, jt) = (tid / 8, tid % 8) runs the softmax of
// rows it + 32 r (r < 2) over keys jt + 8 c (c < 8) (a row's scores on 8
// neighbouring lanes), writes P back in place, and computes the output of
// the same rows at columns 8 jt + e and 64 + 8 jt + e (e < 8), bf16 (OutT
// bf16) or fp32 (float: the quant mode's stage input, row-quantized after).
// At the 14B head (C 5120, R 128) it takes 11.7 us a launch; the first
// version (scalar 2-byte loads, one score or output per thread per pass)
// took 74.5 us, the scores in fp32 FMAs from shared memory 16.8 (19.7 on
// 128 threads, 19.6 with two CTAs a window and head).
constexpr int kWinHd = 128, kWinMax = 64;
constexpr int kWinLd = kWinHd + 8;      // bf16: rows 17 16-byte units apart
constexpr int kWinPld = kWinMax + 4;    // fp32 P rows
constexpr size_t kWinSmem = (size_t)3 * kWinMax * kWinLd * sizeof(bf16);
static_assert(kWinMax * kWinPld * sizeof(float) <= kWinMax * kWinLd * sizeof(bf16),
              "P fits over q's tile");

template <typename OutT>
__global__ void __launch_bounds__(256)
window_attention_rows_kernel(const bf16* __restrict__ qkv, int C, int w, int n_head,
                             float scale, OutT* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* const qs = reinterpret_cast<bf16*>(smem);
  bf16* const ks = qs + kWinMax * kWinLd;
  bf16* const vs = ks + kWinMax * kWinLd;
  float* const ps = reinterpret_cast<float*>(smem);  // over qs once the scores are done
  pdl_trigger();
  pdl_wait();
  const int tid = threadIdx.x, it = tid >> 3, jt = tid & 7;
  const int gi = blockIdx.x / n_head, hh = blockIdx.x % n_head;
  const int row0 = gi * w;
  const size_t ld = 3 * (size_t)C;
  constexpr int kUnits = kWinHd / 8;  // 16-byte units of a head's row
#pragma unroll
  for (int n = 0; n < 3 * kWinMax * kUnits / 256; ++n) {  // the loads go out together
    const int idx = tid + 256 * n;
    const int mat = idx / (kWinMax * kUnits), rest = idx % (kWinMax * kUnits);
    const int i = rest / kUnits, u = rest % kUnits;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (i < w) {
      v = *reinterpret_cast<const uint4*>(qkv + (size_t)(row0 + i) * ld + (size_t)mat * C +
                                          hh * kWinHd + 8 * u);
      if (mat == 0) {
        float f[8];
        unpack8(v, f);
#pragma unroll
        for (int e = 0; e < 8; ++e) f[e] *= scale;
        v = pack8(f);
      }
    }
    *reinterpret_cast<uint4*>(qs + (size_t)mat * kWinMax * kWinLd + i * kWinLd + 8 * u) = v;
  }
  __syncthreads();

  // S = Q K^T on mma.sync m16n8k16 (bf16 products exact, fp32 sums): warp
  // wi takes rows 16 (wi / 2) .. + 15 and keys 32 (wi % 2) .. + 31
  {
    const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
    const int r0 = 16 * (warp >> 1), n0 = 32 * (warp & 1);
    float acc[4][4];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kWinHd; kk += 16) {
      const int c = kk + 2 * t;
      const uint32_t af[4] = {lds32(qs + (r0 + g) * kWinLd + c), lds32(qs + (r0 + g + 8) * kWinLd + c),
                              lds32(qs + (r0 + g) * kWinLd + c + 8),
                              lds32(qs + (r0 + g + 8) * kWinLd + c + 8)};
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const bf16* kr = ks + (n0 + 8 * nt + g) * kWinLd + c;
        const uint32_t bfr[2] = {lds32(kr), lds32(kr + 8)};
        mma_16816(acc[nt], af, bfr);
      }
    }
    __syncthreads();  // every warp has read q: the scores go over it
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      float* row = ps + (r0 + g) * kWinPld + n0 + 8 * nt + 2 * t;
      *reinterpret_cast<float2*>(row) = make_float2(acc[nt][0], acc[nt][1]);
      *reinterpret_cast<float2*>(row + 8 * kWinPld) = make_float2(acc[nt][2], acc[nt][3]);
    }
  }
  __syncthreads();
  // softmax over each row's keys j < w: thread (it, jt) holds rows it + 32 r,
  // keys jt + 8 c, a row's scores on the 8 lanes of one it
  float s[2][8];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c) s[r][c] = ps[(it + 32 * r) * kWinPld + jt + 8 * c];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float m = -INFINITY;
#pragma unroll
    for (int c = 0; c < 8; ++c)
      if (jt + 8 * c < w) m = fmaxf(m, s[r][c]);
#pragma unroll
    for (int o = 1; o < 8; o <<= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    float sum = 0.f;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      s[r][c] = jt + 8 * c < w ? expf(s[r][c] - m) : 0.f;
      sum += s[r][c];
    }
#pragma unroll
    for (int o = 1; o < 8; o <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    const float inv = 1.f / sum;
#pragma unroll
    for (int c = 0; c < 8; ++c) ps[(it + 32 * r) * kWinPld + jt + 8 * c] = s[r][c] * inv;
  }
  __syncthreads();

  float o[2][16];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int e = 0; e < 16; ++e) o[r][e] = 0.f;
#pragma unroll 4
  for (int j = 0; j < w; ++j) {
    float v[16], p[2];
    unpack8(*reinterpret_cast<const uint4*>(vs + j * kWinLd + 8 * jt),
            *reinterpret_cast<float(*)[8]>(v));
    unpack8(*reinterpret_cast<const uint4*>(vs + j * kWinLd + 64 + 8 * jt),
            *reinterpret_cast<float(*)[8]>(v + 8));
#pragma unroll
    for (int r = 0; r < 2; ++r) p[r] = ps[(it + 32 * r) * kWinPld + j];
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int e = 0; e < 16; ++e) o[r][e] = fmaf(p[r], v[e], o[r][e]);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = it + 32 * r;
    if (i >= w) continue;
    OutT* dst = out + (size_t)(row0 + i) * C + hh * kWinHd + 8 * jt;
    if constexpr (sizeof(OutT) == 4) {
      float4* d4 = reinterpret_cast<float4*>(dst);
      d4[0] = make_float4(o[r][0], o[r][1], o[r][2], o[r][3]);
      d4[1] = make_float4(o[r][4], o[r][5], o[r][6], o[r][7]);
      d4[16] = make_float4(o[r][8], o[r][9], o[r][10], o[r][11]);
      d4[17] = make_float4(o[r][12], o[r][13], o[r][14], o[r][15]);
    } else {
      *reinterpret_cast<uint4*>(dst) = pack8(*reinterpret_cast<const float(*)[8]>(o[r]));
      *reinterpret_cast<uint4*>(dst + 64) = pack8(*reinterpret_cast<const float(*)[8]>(o[r] + 8));
    }
  }
}

// h[r, n] = in_b[n] + sum_k bf16(x[r % x_rows, k]) * w[n, k] in fp32 (rows
// [x; x] for the sampler, x_rows = R for one net call), rounded to bf16
// when round_out (the residual of _block_body). One thread per output; ch is
// the latent width (16 or 32), too narrow for the tensor-core GEMM.
__global__ void proj_in_kernel(const float* __restrict__ x, int x_rows, int ch,
                               const bf16* __restrict__ w,
                               const float* __restrict__ b, float* __restrict__ h,
                               int R, int C, int round_out) {
  pdl_trigger();
  pdl_wait();
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (size_t)R * C) return;
  const int r = static_cast<int>(idx / C), n = static_cast<int>(idx % C);
  const float* xr = x + (size_t)(r % x_rows) * ch;
  const bf16* wr = w + (size_t)n * ch;
  float acc = 0.f;
  for (int kk = 0; kk < ch; ++kk) acc += round_bf16(xr[kk]) * bf2f(wr[kk]);
  const float v = acc + b[n];
  h[idx] = round_out ? round_bf16(v) : v;
}

// The bf16 weights of a head's blocks, stacked per block in the torch Linear
// layout ([L, out, in]); n1, wqkv, bqkv, wo, bo only for the TransEncoder.
struct HeadBlockWeights {
  const bf16 *n1, *n2, *wqkv, *bqkv, *wo, *bo, *w1, *b1, *w2, *b2;
};

// The products of a head block, in the order a plan lists them.
enum BlockProduct { kQkv = 0, kWo = 1, kW1 = 2, kW2 = 3 };

// One bf16 block l on the residual h (fp32 [R, C]) as a chain of launches:
// attention half (TransEncoder: LN + modulate, qkv product, window attention
// over groups of R / groups rows, output product with its gated residual),
// then the MLP half (LN + modulate, SwiGLU product, down product with its
// gated residual), each launched by `go` (head_gemm.cuh's hg::GemmLaunch:
// go.stage launches a stage kernel, go.gemm<MODE>(p, w_row0, ep) product p
// of the block on weight rows from w_row0).
// m: the block's mods, bf16 rows ldm apart (scale, shift, gate [, scale,
// shift, gate]). act (bf16 [R, max(C, H)]) and buf (bf16 [R, max(3C, H)])
// are scratch. ROUND=false is the TPU kernel #2's precision (fp32
// residual), with its LN and window attention on the stage kernels redone
// for the 14B head (ln_modulate_rows_kernel; window_attention_rows_kernel:
// head dim 128, windows of up to 64 rows, C <= 5120); ROUND=true is
// _block_body's (#3-#5): every elementwise stage and the residual rounded to
// bf16. The caller sets the window attention's shared-memory limit when it
// exceeds 48 KB.
template <bool ROUND, typename Launch>
cudaError_t head_block(const HeadBlockWeights& w, int l, float* h, const bf16* m,
                       int ldm, bf16* act, bf16* buf, int R, int C, int H,
                       bool attention, int n_head, int groups, float eps,
                       const Launch& go) {
  constexpr int kResid = ROUND ? kGatedResidualRound : kGatedResidual;
  constexpr int kGlu = ROUND ? kSwiGLURound : kSwiGLU;
  auto ln = [&](const bf16* nrm, const bf16* mm) {
    if constexpr (ROUND)
      return go.stage(dim3(R), 256, 0, ln_modulate_kernel<float, false, true>,
                      static_cast<const float*>(h), C, nrm, nrm + C, mm, ldm, mm + C, ldm, act,
                      eps);
    else
      return go.stage(dim3(R), 256, 0, ln_modulate_rows_kernel<bf16>,
                      static_cast<const float*>(h), C, nrm, nrm + C, mm, ldm, mm + C, ldm, act,
                      nullptr, eps);
  };
  if (attention) {
    const int wtok = R / groups, hd = C / n_head;
    const float scale = 1.f / sqrtf(static_cast<float>(hd));
    BD_CHECK_ERR(ln(w.n1 + (size_t)l * 2 * C, m));
    Epilogue qkv_ep{};
    qkv_ep.bias = w.bqkv + (size_t)l * 3 * C;
    qkv_ep.out = buf;
    qkv_ep.ldo = 3 * C;
    BD_CHECK_ERR(go.template gemm<kBiasBf16>(kQkv, l * 3 * C, qkv_ep));
    if constexpr (ROUND)
      BD_CHECK_ERR(go.stage(dim3(groups * n_head), 256, window_attention_smem(wtok, hd),
                            window_attention_kernel, static_cast<const bf16*>(buf), C,
                            wtok, hd, n_head, scale, act));
    else  // hd 128, wtok <= 64 (the caller checks)
      BD_CHECK_ERR(go.stage(dim3(groups * n_head), 256, kWinSmem,
                            window_attention_rows_kernel<bf16>, static_cast<const bf16*>(buf), C,
                            wtok, n_head, scale, act));
    Epilogue o_ep{};
    o_ep.bias = w.bo + (size_t)l * C;
    o_ep.resid = h;
    o_ep.ldr = C;
    o_ep.gate = m + 2 * C;
    o_ep.ldg = ldm;
    BD_CHECK_ERR(go.template gemm<kResid>(kWo, l * C, o_ep));
  }
  const bf16* mm = m + (size_t)(attention ? 3 : 0) * C;
  BD_CHECK_ERR(ln(w.n2 + (size_t)l * 2 * C, mm));
  Epilogue glu_ep{};
  glu_ep.bias = w.b1 + (size_t)l * 2 * H;
  glu_ep.out = buf;
  glu_ep.ldo = H;
  glu_ep.hidden = H;
  BD_CHECK_ERR(go.template gemm<kGlu>(kW1, l * 2 * H, glu_ep));
  Epilogue down_ep{};
  down_ep.bias = w.b2 + (size_t)l * C;
  down_ep.resid = h;
  down_ep.ldr = C;
  down_ep.gate = mm + 2 * C;
  down_ep.ldg = ldm;
  return go.template gemm<kResid>(kW2, l * C, down_ep);
}

}  // namespace
