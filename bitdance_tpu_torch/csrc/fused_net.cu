// One whole DiffNet forward of the diffusion head per host call.
//
// Replaces the TPU kernel #5 of bitdance_tpu/ops/fused_head.py,
// _fused_net_kernel (launched by fused_diffnet_forward at :426, body at
// :295-358): the sinusoidal t-embedding ([cos, sin] of t * 1000 *
// exp(-ln(1e4) i / half)) and its two-layer SiLU MLP, y = silu(te + c_emb),
// the input projection h = x @ in_w + in_b, every adaLN block (the mods
// y @ ada_w[g] + ada_b[g] recomputed at each group boundary, then window
// attention over G groups of W rows for the TransEncoder and the SwiGLU MLP),
// and the final layer (adaLN LayerNorm, output product, 2*sigmoid-1 when
// bounded), for x [G, W, ch] (TransEncoder) or [R, ch] (MlpEncoder).
//
// Precision follows the TPU kernel: prologue, mods accumulation, LN
// statistics, softmax and every product's accumulation in fp32; product
// operands cast to bf16; the blocks as _block_body computes them in bf16
// (head_block<true>: h and the mods cast to bf16 at each block, qkv, the
// attention output, both gated products, h12, silu(h1) and every residual
// sum rounded to bf16). The adaLN groups and the final modulation are row
// slices of the sampler stack's modcat_w / modcat_b, never separate copies.
//
// What bounds it on the H100: the weights. One call reads every weight once
// (88.5 M block parameters and 19.7 M of modulation at the BitDance-H-1x
// MlpEncoder, C 1280; 30.1 M and 7.1 M at the B-16x TransEncoder, C 768,
// in bf16) for 8-512 rows, i.e. at most ~2 x rows FLOP per weight byte,
// under the ~295 FLOP/byte at which the tensor cores become the limit
// except at the largest row counts.
//
// Design: the TPU kernel walks the blocks as its sequential grid with h, y
// and the mods in VMEM. Here one host call chains launches on the caller's
// stream (a single persistent launch is later speed work): 6 for the
// prologue (t-frequencies, two products with their bias + SiLU epilogues,
// y, the input projection), 2 per adaLN group (product, bias + bf16
// round), head_block's 3 (MlpEncoder) or 7 (TransEncoder) per block, 2 for
// the final layer (modulation product, LN + output product). Every product
// runs on the wgmma head GEMM (head_gemm.cuh) by the plans of
// ops/fused_head.py::net_plans: the blocks' through head_block<true> with
// hg::GemmLaunch (the round route of the whole sampler #3/#4, over tensor
// maps of the whole stacks), the t-MLP's, the adaLN groups' and the final
// modulation's with the kOutF32 epilogue (fp32 sums; the fp32 bias follows
// in bias_silu / bias_round / final_net_kernel). Every launch of the chain
// is programmatic (PDL): each stage kernel lets the next launch at its start
// and waits for the one ahead, so each GEMM's weight tiles are in flight
// before the kernel ahead has finished. The first design ran every product
// on an mma.sync GEMM since removed (64x64 tiles walked by every thread,
// each launch waiting for the one ahead to drain; 0.764 ms an H-1x net call
// at 8 rows, PERF.md). The 16-wide input and output projections of the
// ImageNet heads are too narrow for the GEMM and run as small kernels
// (proj_in_kernel, final_net_kernel).
#include "head_gemm.cuh"

namespace {

constexpr int kMaxOut = 32;

// [cos | sin] of t[r] * 1000 * exp(-ln(1e4) * i / half), rounded to bf16 (the
// operand of the first t-MLP product): out [R, 2 * half].
__global__ void t_freq_kernel(const float* __restrict__ t, int R, int half,
                              bf16* __restrict__ out) {
  pdl_trigger();
  pdl_wait();
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (size_t)R * half) return;
  const int r = static_cast<int>(idx / half), i = static_cast<int>(idx % half);
  const float freq = expf((-9.210340371976184f * static_cast<float>(i)) /
                          static_cast<float>(half));
  const float a = (t[r] * 1000.f) * freq;
  out[(size_t)r * 2 * half + i] = __float2bfloat16(cosf(a));
  out[(size_t)r * 2 * half + half + i] = __float2bfloat16(sinf(a));
}

// out = bf16(silu(a + b)) over [R, N]; a fp32 [R, N], b fp32 [N]
__global__ void bias_silu_kernel(const float* __restrict__ a,
                                 const float* __restrict__ b, int R, int N,
                                 bf16* __restrict__ out) {
  pdl_trigger();
  pdl_wait();
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (size_t)R * N) return;
  const float v = a[idx] + b[idx % N];
  out[idx] = __float2bfloat16(v / (1.f + expf(-v)));
}

// y = silu(a + b + c_emb) in fp32, and its bf16 cast (the mods' operand)
__global__ void y_kernel(const float* __restrict__ a, const float* __restrict__ b,
                         const float* __restrict__ c_emb, int R, int C,
                         float* __restrict__ y, bf16* __restrict__ y16) {
  pdl_trigger();
  pdl_wait();
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (size_t)R * C) return;
  const float v = a[idx] + b[idx % C] + c_emb[idx];
  const float s = v / (1.f + expf(-v));
  y[idx] = s;
  y16[idx] = __float2bfloat16(s);
}

// out = bf16(a + b) over [R, N] (one adaLN group's mods)
__global__ void bias_round_kernel(const float* __restrict__ a,
                                  const float* __restrict__ b, int R, int N,
                                  bf16* __restrict__ out) {
  pdl_trigger();
  pdl_wait();
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (size_t)R * N) return;
  out[idx] = __float2bfloat16(a[idx] + b[idx % N]);
}

// The final layer of row r: fmod fp32 [R, 2C] (the modulation product
// without its bias fb_mod), z = bf16(LN(h[r]) * (1 + scale) + shift), out[r]
// = z @ fw^T + fb (fw [ch, C] bf16), 2*sigmoid-1 when bounded. One block per
// row; LN statistics E[x^2] - E[x]^2 in fp32, as the TPU kernels' _ln.
__global__ void __launch_bounds__(256)
final_net_kernel(const float* __restrict__ h, int C, const float* __restrict__ fmod,
                 const float* __restrict__ fb_mod, const bf16* __restrict__ fw,
                 const float* __restrict__ fb, float* __restrict__ out, int ch,
                 int bounded, float eps) {
  __shared__ float red[8][kMaxOut];
  pdl_trigger();
  pdl_wait();
  const int r = blockIdx.x;
  const float* hr = h + (size_t)r * C;
  const float* fm = fmod + (size_t)r * 2 * C;
  float s = 0.f, ss = 0.f;
  for (int k = threadIdx.x; k < C; k += blockDim.x) {
    s += hr[k];
    ss += hr[k] * hr[k];
  }
  block_sum2(s, ss);
  const float mean = s / C;
  const float rstd = rsqrtf(fmaxf(ss / C - mean * mean, 0.f) + eps);
  float acc[kMaxOut];
#pragma unroll
  for (int c = 0; c < kMaxOut; ++c) acc[c] = 0.f;
  for (int k = threadIdx.x; k < C; k += blockDim.x) {
    const float scale = fm[k] + fb_mod[k], shift = fm[C + k] + fb_mod[C + k];
    const float z = round_bf16((hr[k] - mean) * rstd * (1.f + scale) + shift);
#pragma unroll
    for (int c = 0; c < kMaxOut; ++c)
      if (c < ch) acc[c] += z * bf2f(fw[(size_t)c * C + k]);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int c = 0; c < kMaxOut; ++c) {
    const float a = warp_sum(acc[c]);
    if (lane == 0) red[warp][c] = a;
  }
  __syncthreads();
  if (threadIdx.x < ch) {
    float v = fb[threadIdx.x];
    for (int wi = 0; wi < (int)(blockDim.x >> 5); ++wi) v += red[wi][threadIdx.x];
    out[(size_t)r * ch + threadIdx.x] = bounded ? 2.f / (1.f + expf(-v)) - 1.f : v;
  }
}

int blocks_for(size_t n) { return static_cast<int>((n + 255) / 256); }

}  // namespace

// One DiffNet forward on `stream`. x [R, ch], t [R], c_emb [R, C] fp32 (R =
// groups * w; the TransEncoder's windows are the groups of w consecutive
// rows); out [R, ch] fp32. Weights in the sampler stack's layout (torch
// Linear [out, in], bf16; in_b, t_b0, t_b2, modcat_b, f_out_b fp32):
// t_w0 [C, t_freq], t_w2 [C, C], in_w [C, ch], modcat_w [A*m*C + 2C, C]
// (m = 6 or 3 mods per group, A = num_ada groups, the final layer's 2C rows
// last), f_out_w [ch, C], per-block n1, n2, wqkv, bqkv, wo, bo, w1, b1, w2,
// b2 (n1, wqkv, bqkv, wo, bo read only when attention=1). Scratch: tfreq
// (bf16 [R, t_freq]), f32buf (fp32 [R, max(m*C, 2C)]), h, y (fp32 [R, C]),
// y16 (bf16 [R, C]), mods (bf16 [R, m*C]), act (bf16 [R, max(C, H)]), buf
// (bf16 [R, max(3C, H)]). gemm_plan (host, 24 ints): {bm, bn, splits} of
// qkv, wo, w1, w2, t_w0, t_w2, an adaLN group's product and the final
// modulation's (ops/fused_head.py::net_plans); the head GEMM takes C % 128 ==
// 0, H % 64 == 0 and t_freq % 64 == 0. pdl 0 launches the chain plain (only
// to measure what PDL saves). Returns the first CUDA error, or 0; a shape
// the head GEMM cannot take is refused (cudaErrorInvalidValue).
extern "C" int bd_fused_diffnet_forward(
    const void* x, const void* t, const void* c_emb, void* out, const void* in_w,
    const void* in_b, const void* t_w0, const void* t_b0, const void* t_w2,
    const void* t_b2, const void* modcat_w, const void* modcat_b,
    const void* f_out_w, const void* f_out_b, const void* n1, const void* n2,
    const void* wqkv, const void* bqkv, const void* wo, const void* bo,
    const void* w1, const void* b1, const void* w2, const void* b2,
    void* tfreq_scratch, void* f32_scratch, void* h_scratch, void* y_scratch,
    void* y16_scratch, void* mods_scratch, void* act_scratch, void* buf_scratch,
    int groups, int w, int ch, int C, int H, int num_blocks, int num_ada,
    int switch_freq, int n_head, int t_freq, int attention, int bounded,
    const int* gemm_plan, int pdl, void* stream) {
  const int R = groups * w;
  if (R <= 0 || ch <= 0 || ch > kMaxOut || C % 128 != 0 || H % 64 != 0 || t_freq % 64 != 0 ||
      switch_freq <= 0 || num_ada <= 0 || (num_blocks - 1) / switch_freq >= num_ada)
    return static_cast<int>(cudaErrorInvalidValue);
  if (attention && (n_head <= 0 || C % n_head != 0 || (C / n_head) % 2 != 0 ||
                    w > 64))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float eps = 1e-6f;
  const int m = (attention ? 6 : 3) * C;
  const bf16* MW = static_cast<const bf16*>(modcat_w);
  const float* MB = static_cast<const float*>(modcat_b);
  bf16* tfreq = static_cast<bf16*>(tfreq_scratch);
  float* f32buf = static_cast<float*>(f32_scratch);
  float* h = static_cast<float*>(h_scratch);
  float* y = static_cast<float*>(y_scratch);
  bf16* y16 = static_cast<bf16*>(y16_scratch);
  bf16* mods = static_cast<bf16*>(mods_scratch);
  bf16* act = static_cast<bf16*>(act_scratch);
  bf16* buf = static_cast<bf16*>(buf_scratch);
  const HeadBlockWeights wts{
      static_cast<const bf16*>(n1), static_cast<const bf16*>(n2),
      static_cast<const bf16*>(wqkv), static_cast<const bf16*>(bqkv),
      static_cast<const bf16*>(wo), static_cast<const bf16*>(bo),
      static_cast<const bf16*>(w1), static_cast<const bf16*>(b1),
      static_cast<const bf16*>(w2), static_cast<const bf16*>(b2)};
  // the products: the blocks' (indexed by BlockProduct) over the whole
  // stacks, then t_w0, t_w2, an adaLN group's rows of modcat_w and the final
  // modulation's rows
  enum { kTw0 = 4, kTw2 = 5, kMods = 6, kFinal = 7 };
  hg::Plan plan[8];
  hg::Product pr[8];
  for (int i = 0; i < 8; ++i)
    plan[i] = {gemm_plan[3 * i], gemm_plan[3 * i + 1], gemm_plan[3 * i + 2]};
  const int L = num_blocks, mw_rows = num_ada * m + 2 * C;
  bool ok =
      hg::make_product(hg::kOpBf16, act, R, C, w1, L * 2 * H, 2 * H, true, plan[kW1], &pr[kW1]) &&
      hg::make_product(hg::kOpBf16, buf, R, H, w2, L * C, C, false, plan[kW2], &pr[kW2]) &&
      hg::make_product(hg::kOpBf16, tfreq, R, t_freq, t_w0, C, C, false, plan[kTw0], &pr[kTw0]) &&
      hg::make_product(hg::kOpBf16, act, R, C, t_w2, C, C, false, plan[kTw2], &pr[kTw2]) &&
      hg::make_product(hg::kOpBf16, y16, R, C, MW, mw_rows, m, false, plan[kMods], &pr[kMods]) &&
      hg::make_product(hg::kOpBf16, y16, R, C, MW, mw_rows, 2 * C, false, plan[kFinal],
                       &pr[kFinal]);
  if (attention)
    ok = ok &&
         hg::make_product(hg::kOpBf16, act, R, C, wqkv, L * 3 * C, 3 * C, false, plan[kQkv],
                          &pr[kQkv]) &&
         hg::make_product(hg::kOpBf16, act, R, C, wo, L * C, C, false, plan[kWo], &pr[kWo]);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  const hg::GemmLaunch go{pr, plan, pdl != 0, pdl != 0, st};
  auto out_f32 = [&](int p, int w_row0, int ldo) {
    Epilogue ep{};
    ep.out = f32buf;
    ep.ldo = ldo;
    return hg::gemm<kOutF32>(pr[p], w_row0, plan[p], ep, pdl != 0, st);
  };
  if (attention) {
    const size_t smem = window_attention_smem(w, C / n_head);
    if (smem > 227 * 1024) return static_cast<int>(cudaErrorInvalidValue);
    if (smem > 48 * 1024)
      BD_CHECK(cudaFuncSetAttribute(window_attention_kernel,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    static_cast<int>(smem)));
  }

  // prologue: t-embedding MLP, y, input projection
  const int half = t_freq / 2;
  BD_CHECK(go.stage(dim3(blocks_for((size_t)R * half)), 256, 0, t_freq_kernel,
                    static_cast<const float*>(t), R, half, tfreq));
  BD_CHECK(out_f32(kTw0, 0, C));
  BD_CHECK(go.stage(dim3(blocks_for((size_t)R * C)), 256, 0, bias_silu_kernel,
                    static_cast<const float*>(f32buf), static_cast<const float*>(t_b0), R, C,
                    act));
  BD_CHECK(out_f32(kTw2, 0, C));
  BD_CHECK(go.stage(dim3(blocks_for((size_t)R * C)), 256, 0, y_kernel,
                    static_cast<const float*>(f32buf), static_cast<const float*>(t_b2),
                    static_cast<const float*>(c_emb), R, C, y, y16));
  BD_CHECK(go.stage(dim3(blocks_for((size_t)R * C)), 256, 0, proj_in_kernel,
                    static_cast<const float*>(x), R, ch, static_cast<const bf16*>(in_w),
                    static_cast<const float*>(in_b), h, R, C, 1));

  // blocks, the adaLN mods recomputed at each group boundary
  for (int l = 0; l < num_blocks; ++l) {
    if (l % switch_freq == 0) {
      const int g = l / switch_freq;
      BD_CHECK(out_f32(kMods, g * m, m));
      BD_CHECK(go.stage(dim3(blocks_for((size_t)R * m)), 256, 0, bias_round_kernel,
                        static_cast<const float*>(f32buf), MB + (size_t)g * m, R, m, mods));
    }
    BD_CHECK((head_block<true, hg::GemmLaunch>(wts, l, h, mods, m, act, buf, R, C, H,
                                               attention != 0, n_head, groups, eps, go)));
  }

  // final layer
  BD_CHECK(out_f32(kFinal, num_ada * m, 2 * C));
  return static_cast<int>(go.stage(dim3(R), 256, 0, final_net_kernel,
                                   static_cast<const float*>(h), C,
                                   static_cast<const float*>(f32buf), MB + (size_t)num_ada * m,
                                   static_cast<const bf16*>(f_out_w),
                                   static_cast<const float*>(f_out_b), static_cast<float*>(out),
                                   ch, bounded, eps));
}

// One product of #5 on the head GEMM alone (ops/fused_head.py::head_gemm,
// hg::single_product), for its checks and timings: mode 7 (kOutF32).
// Returns the first CUDA error, or 0.
extern "C" int bd_head_gemm_net(const void* a, const void* w, const void* bias, void* out,
                                void* resid, const void* gate, const int* shape, void* stream) {
  hg::Product pr;
  hg::Plan plan;
  Epilogue ep;
  if (shape[4] != kOutF32 ||
      !hg::single_product(a, w, bias, out, resid, gate, shape, &pr, &plan, &ep))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(
      hg::gemm<kOutF32>(pr, 0, plan, ep, false, static_cast<cudaStream_t>(stream)));
}
