// The whole Euler-Maruyama sampler of the diffusion head, driven by a host
// loop over (sampler step, block) that launches this file's kernels.
//
// Replaces the TPU kernels of bitdance_tpu/ops/fused_head.py::fused_em_sample:
// _fused_em_kernel_streamed_dma (the regime the 5120-wide 14B head takes),
// _fused_em_kernel (per-block streamed weights) and _fused_em_kernel_resident
// (whole head in VMEM). The three exist because a TPU core's VMEM decides how
// the weights are staged; one design serves all of them here, for both head
// families. Per sampler step: input projection of [x; x], then per block
//   attention=1 (TransEncoder, 6 mods per block): LN + adaLN modulate, qkv
//     product, window attention over each group of parallel_num tokens, the
//     output product with its gated residual, then the MLP half;
//   attention=0 (MlpEncoder, 3 mods per block: scale, shift, gate): the MLP
//     half only;
// where the MLP half is LN + modulate, the SwiGLU product and the down
// product with its gated residual; then the final adaLN layer, 2*sigmoid-1
// when bounded=1 (the T2I head; the ImageNet heads are unbounded), velocity,
// CFG ([cond; uncond] rows) and the score-augmented EM update with the given
// noise, or the deterministic last step.
//
// What bounds it on the H100: each net call reads every block weight once
// (1.34 G parameters, 2.7 GB in bf16, at the 14B head; 88.5 M, 177 MB, at
// the BitDance-H-1x MlpEncoder) for 128 (resp. 64) rows, i.e. ~64-128 FLOP
// per weight byte, well under the ~295 FLOP/byte at which the tensor cores
// become the limit. The sampler is bound by weight bytes streamed from HBM
// once per net call, 51 or 101 times per AR step.
//
// Design: the products run on the wgmma head GEMM of head_gemm.cuh (a TMA
// ring, split-K by ops/fused_head.py::head_gemm_plan) with the epilogues
// fused: bias (qkv, stored bf16), bias + gated residual into the residual
// stream (out and down products), and SwiGLU (the w1 product loads matching
// h1/h2 weight rows into one tile so each thread holds both halves of its
// output column); every launch of the chain is programmatic, so each
// product's first weight tiles are in flight before the kernel ahead of it
// ends (head_block on hg::GemmLaunch). LN + modulate, window attention and
// the final layer + EM update are small fp32 kernels. Precision follows the
// TPU kernel the JAX package routes the stack to (round_residual, decided by
// the caller from the block weights' bytes): #2 (the 14B head) keeps an
// fp32 residual h with bf16 stage activations (kGatedResidual, kSwiGLU);
// #3/#4 (the ImageNet heads) run _block_body, which rounds h and every
// elementwise stage to bf16 (kGatedResidualRound, kSwiGLURound). LN
// statistics, softmax and accumulation stay fp32 in both. Two stage kernels
// were redesigned once the products no longer hid them (at B-16x the stage
// kernels held a third of a net call on the card): the input projection
// loads vectors (proj_in_rows_kernel), and the final layer issues its loads
// together and spreads its product over the warps (final_em_rows_kernel,
// up to C 5120). Tried and not kept:
// window attention with a warp per window and head (31 against 14 us a
// launch at B-16x: its k and v rows came from device memory one vector load
// at a time), LN + modulate with a warp per row (6.5 against 4.4 us at
// H-1x: 8 blocks for 64 rows) or with each thread's loads issued together
// (no faster at H-1x, slower at B-16x).
//
// Quant mode on kernel #2's route (quant = 1 int8, 2 packed int4; the TPU
// kernel's W8A8 / W4A8 mode, stage_quant + stage_dot, the TransEncoder): each of the four block
// products takes its fp32 stage input (LN + modulate, the window attention's
// output, silu(h1) * h2), quantized per row to int8 once, and runs on the
// head GEMM's integer kinds (kOpS8 on int8 [out, in], kOpS4 on packed
// [out, in/2] weights, per-output-column scales), y = float(acc) * (sa * ws)
// before the bias, fp32 gated residual (wo, w2) and kSwiGLUQ (w1) epilogues;
// qkv and h1/h2 are still rounded to bf16. The stage kernels are the bf16
// route's at the quant mode's precision: the LN writes the int8 row and its
// scale itself (ln_modulate_rows_kernel<int8_t>), window attention writes
// fp32 (window_attention_rows_kernel<float>), which, like the SwiGLU
// output, then takes one row-quantization launch (quantize_rows_vec_kernel):
// 9 launches a block; its GEMMs are launched programmatic, its stage kernels
// plain (hg::GemmLaunch). The first design (gemm_s8_kernel: mma.sync m16n8k32 on
// 64x64 tiles, a cp.async ring every thread walked, with the first stage
// kernels and four quantization launches a block) took 2.87 (int8) and 2.46
// ms (int4) a net call at the 14B head, over 1.21 for the bf16 route.
// Weight bytes per net call halve (int8) or quarter (int4), so does the
// bound.
//
// Quant mode on the round route (#3/#4 with a quantized stack, the ImageNet
// heads under sample_weight_quant, both families; quant_round_block): each
// product's input is _block_body's bf16 stage value, quantized per row
// (_mmq): the rounding LN chain writes the int8 row and its scale itself
// (ln_modulate_chain_q_kernel), the bf16 window-attention output and the
// bf16 glu take one row quantization each (quantize_rows_vec_kernel<bf16>),
// and the products run on the integer kinds with the round route's
// epilogues (kGatedResidualRound, and kSwiGLURoundQ for the glu).
#include "head_gemm.cuh"

namespace {

constexpr int kMaxCh = 32;

// Final adaLN layer + (bounded: 2*sigmoid-1) + velocity + CFG + EM (or last
// Euler) update of x row i, one block per cond row handling rows i and i +
// half, its loads in flight together and its product spread over the warps
// (every route: #2, its quant modes, #3/#4): each thread's
// values of the two rows (C <= 256 kPer) loaded into registers at once,
// their modulated LN z (bf16 values) staged in shared memory (dynamic, 2 C
// floats, at most 40 KB), then warp v takes channels v, v + 8, v + 16, v +
// 24 (+ 32 ...) for both rows, each lane 8 consecutive k of every 256 with
// 16-byte loads, 4 steps of the four channels' loads in flight, eight
// accumulators a lane and eight warp sums (the first version's 64
// accumulators a thread and 64 warp sums took 19-26 us a launch at C <=
// 2048; at C 5120, with each (row, channel) on its own warp slot and w read
// twice a block: a 2-byte load of w per k 43 us, one step of 16-byte loads
// in flight 36, four 35, the product spread over 4 blocks a row pair 40).
template <int kPer>
__global__ void __launch_bounds__(256)
final_em_rows_kernel(const float* __restrict__ h, int C, const bf16* __restrict__ fmods,
                     int ld_mods, const bf16* __restrict__ fw, const float* __restrict__ fb,
                     float* __restrict__ x, const float* __restrict__ noise, int half, int ch,
                     float t, float dt, float cfg, float last_step, int bounded, float eps) {
  pdl_trigger();
  pdl_wait();
  extern __shared__ float z[];  // [2][C]
  __shared__ float outs[2][kMaxCh];
  const int i = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  float hv[2][kPer], sc[2][kPer], sh[2][kPer];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const float* hr = h + (size_t)(i + j * half) * C;
    const bf16* fm = fmods + (size_t)(i + j * half) * ld_mods;
#pragma unroll
    for (int q = 0; q < kPer; ++q)
      if (tid + q * 256 < C) {
        hv[j][q] = hr[tid + q * 256];
        sc[j][q] = bf2f(fm[tid + q * 256]);
        sh[j][q] = bf2f(fm[C + tid + q * 256]);
      }
  }
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    float s = 0.f, ss = 0.f;
#pragma unroll
    for (int q = 0; q < kPer; ++q)
      if (tid + q * 256 < C) {
        s += hv[j][q];
        ss += hv[j][q] * hv[j][q];
      }
    block_sum2(s, ss);
    const float mean = s / C;
    const float rstd = rsqrtf(fmaxf(ss / C - mean * mean, 0.f) + eps);
#pragma unroll
    for (int q = 0; q < kPer; ++q)
      if (tid + q * 256 < C)
        z[j * C + tid + q * 256] =
            round_bf16((hv[j][q] - mean) * rstd * (1.f + sc[j][q]) + sh[j][q]);
  }
  __syncthreads();
  // warp v: channels v, v + 8, v + 16, v + 24 (+ 32 ...), each for both
  // rows, so that a w row is loaded once a block and z's once a warp step
  for (int c0 = warp; c0 < ch; c0 += 32) {
    float acc[4][2] = {};
    const bf16* wr[4];
#pragma unroll
    for (int q = 0; q < 4; ++q)  // a channel past ch reads channel c0 and is not stored
      wr[q] = fw + (size_t)(c0 + 8 * q < ch ? c0 + 8 * q : c0) * C;
    // 16-byte loads of w (C % 8 == 0), 4 steps of 4 channels in flight
#pragma unroll 4
    for (int k = 8 * lane; k < C; k += 256) {
      float zz[2][8];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float4 z0 = *reinterpret_cast<const float4*>(z + j * C + k);
        const float4 z1 = *reinterpret_cast<const float4*>(z + j * C + k + 4);
        zz[j][0] = z0.x, zz[j][1] = z0.y, zz[j][2] = z0.z, zz[j][3] = z0.w;
        zz[j][4] = z1.x, zz[j][5] = z1.y, zz[j][6] = z1.z, zz[j][7] = z1.w;
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float ww[8];
        unpack8(*reinterpret_cast<const uint4*>(wr[q] + k), ww);
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[q][j] = fmaf(zz[j][e], ww[e], acc[q][j]);
      }
    }
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = c0 + 8 * q;
        const float v = warp_sum(acc[q][j]);
        if (lane == 0 && c < ch) {
          const float o = v + fb[c];
          outs[j][c] = bounded ? 2.f / (1.f + expf(-o)) - 1.f : o;
        }
      }
  }
  __syncthreads();
  if (threadIdx.x < ch) {
    const int c = threadIdx.x;
    const float xv = x[(size_t)i * ch + c];
    const float denom = fmaxf(1.f - t, 0.05f);
    const float v_cond = (outs[0][c] - xv) / denom;
    const float v_unc = (outs[1][c] - xv) / denom;
    const float vc = v_unc + cfg * (v_cond - v_unc);
    float xn;
    if (noise != nullptr) {
      const float var = (1.f - t) * (1.f - t) + t * (1.f - t);
      const float score = (t * vc - xv) / var;
      const float drift = vc + (1.f - t) * score;
      const float ns = sqrtf(2.f * (1.f - t) * dt);
      xn = xv + drift * dt + ns * noise[(size_t)i * ch + c];
    } else {
      xn = xv + vc * last_step;
    }
    x[(size_t)i * ch + c] = xn;
  }
}

// proj_in_kernel's function for the bf16 routes with the latent width CH a
// template constant, so that each thread's x and w rows load as vectors
// (proj_in_kernel took 16 us a launch at B-16x's 1024 x 768), and each
// thread takes output column n for kProjRows rows, its w row loaded once
// (a thread an output re-read w 128 times: 27 us at the 14B head's 128 x
// 5120); ROUND rounds h to bf16 (#3/#4), #2 keeps it in fp32
constexpr int kProjRows = 8;

template <int CH, bool ROUND>
__global__ void __launch_bounds__(256)
proj_in_rows_kernel(const float* __restrict__ x, int x_rows, const bf16* __restrict__ w,
                    const float* __restrict__ b, float* __restrict__ h, int R, int C) {
  pdl_trigger();
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (size_t)((R + kProjRows - 1) / kProjRows) * C) return;
  const int r0 = static_cast<int>(idx / C) * kProjRows, n = static_cast<int>(idx % C);
  const uint4* wr = reinterpret_cast<const uint4*>(w + (size_t)n * CH);
  float ws[CH];
#pragma unroll
  for (int k = 0; k < CH / 8; ++k) {  // w never depends on the kernel ahead
    float f[8];
    unpack8(wr[k], f);
#pragma unroll
    for (int e = 0; e < 8; ++e) ws[8 * k + e] = f[e];
  }
  const float bn = b[n];
  pdl_wait();
#pragma unroll 2
  for (int r = r0; r < min(r0 + kProjRows, R); ++r) {
    const float4* xr = reinterpret_cast<const float4*>(x + (size_t)(r % x_rows) * CH);
    float xs[CH];
#pragma unroll
    for (int k = 0; k < CH / 4; ++k) {
      const float4 v = xr[k];
      xs[4 * k] = v.x, xs[4 * k + 1] = v.y, xs[4 * k + 2] = v.z, xs[4 * k + 3] = v.w;
    }
    float acc = 0.f;
#pragma unroll
    for (int k = 0; k < CH; ++k) acc += round_bf16(xs[k]) * ws[k];
    h[(size_t)r * C + n] = ROUND ? round_bf16(acc + bn) : acc + bn;
  }
}

// The quantized sampler's per-output-column scales of its four matrices
// and its scratch: the fp32 stage outputs that are row-quantized (window
// attention, SwiGLU), the int8 rows and their scales.
struct QuantBlock {
  const float *wqkv_s, *wo_s, *w1_s, *w2_s;
  float* actf;
  int8_t* aq;
  float* sa;
};

// One TransEncoder block with W8A8 (KIND hg::kOpS8) / W4A8 (hg::kOpS4)
// products on the head GEMM (go.pr / go.plan: the four products over aq and
// the quantized stacks), each stage input quantized per row once: LN +
// modulate + quantize, qkv, window attention (fp32), quantize, wo, LN +
// modulate + quantize, w1 (SwiGLU, fp32), quantize, w2. The caller sets the
// fp32 window attention's shared-memory limit.
template <int KIND>
cudaError_t quant_block(const HeadBlockWeights& w, const QuantBlock& qb, int l, float* h,
                        const bf16* m, int ldm, bf16* buf, int R, int C, int H, int n_head,
                        int groups, float eps, const hg::GemmLaunch& go) {
  const float scale = 1.f / sqrtf(static_cast<float>(kWinHd));
  auto ln = [&](const bf16* nrm, const bf16* mm) {
    return go.stage(dim3(R), 256, 0, ln_modulate_rows_kernel<int8_t>,
                    static_cast<const float*>(h), C, nrm, nrm + C, mm, ldm, mm + C, ldm, qb.aq,
                    qb.sa, eps);
  };
  auto quantize = [&](int K) {
    return go.stage(dim3(R), 256, 0, quantize_rows_vec_kernel<float>,
                    static_cast<const float*>(qb.actf), K, qb.aq, qb.sa);
  };
  BD_CHECK_ERR(ln(w.n1 + (size_t)l * 2 * C, m));
  Epilogue qkv_ep{};
  qkv_ep.bias = w.bqkv + (size_t)l * 3 * C;
  qkv_ep.out = buf;
  qkv_ep.ldo = 3 * C;
  qkv_ep.sa = qb.sa;
  qkv_ep.ws = qb.wqkv_s + (size_t)l * 3 * C;
  BD_CHECK_ERR((go.gemm_q<kBiasBf16, KIND>(kQkv, l * 3 * C, qkv_ep)));
  BD_CHECK_ERR(go.stage(dim3(groups * n_head), 256, kWinSmem, window_attention_rows_kernel<float>,
                        static_cast<const bf16*>(buf), C, R / groups, n_head, scale, qb.actf));
  BD_CHECK_ERR(quantize(C));
  Epilogue o_ep{};
  o_ep.bias = w.bo + (size_t)l * C;
  o_ep.resid = h;
  o_ep.ldr = C;
  o_ep.gate = m + 2 * C;
  o_ep.ldg = ldm;
  o_ep.sa = qb.sa;
  o_ep.ws = qb.wo_s + (size_t)l * C;
  BD_CHECK_ERR((go.gemm_q<kGatedResidual, KIND>(kWo, l * C, o_ep)));
  const bf16* mm = m + (size_t)3 * C;  // scale2, shift2, gate2
  BD_CHECK_ERR(ln(w.n2 + (size_t)l * 2 * C, mm));
  Epilogue glu_ep{};
  glu_ep.bias = w.b1 + (size_t)l * 2 * H;
  glu_ep.out = qb.actf;
  glu_ep.ldo = H;
  glu_ep.hidden = H;
  glu_ep.sa = qb.sa;
  glu_ep.ws = qb.w1_s + (size_t)l * 2 * H;
  BD_CHECK_ERR((go.gemm_q<kSwiGLUQ, KIND>(kW1, l * 2 * H, glu_ep)));
  BD_CHECK_ERR(quantize(H));
  Epilogue down_ep{};
  down_ep.bias = w.b2 + (size_t)l * C;
  down_ep.resid = h;
  down_ep.ldr = C;
  down_ep.gate = mm + 2 * C;
  down_ep.ldg = ldm;
  down_ep.sa = qb.sa;
  down_ep.ws = qb.w2_s + (size_t)l * C;
  return go.gemm_q<kGatedResidual, KIND>(kW2, l * C, down_ep);
}

// One block of the round route's quant modes (#3/#4 with a quantized stack:
// _block_body with _mmq), KIND hg::kOpS8 (W8A8) or hg::kOpS4 (W4A8), either
// family: the attention half (TransEncoder) is LN + modulate rounded as
// _block_body's bf16 ops and quantized in one launch
// (ln_modulate_chain_q_kernel), qkv (kBiasBf16), window attention on the
// bf16 qkv into act (bf16, window_attention_kernel), the row quantization of
// that bf16 output, wo (kGatedResidualRound); the MLP half is LN + modulate
// + quantize, w1 (kSwiGLURoundQ: the bf16 glu into buf), its row
// quantization, w2 (kGatedResidualRound). 9 launches a TransEncoder block, 4
// an MlpEncoder block, the stage kernels programmatic with the products. The
// caller sets the window attention's shared-memory limit when it exceeds
// 48 KB.
template <int KIND>
cudaError_t quant_round_block(const HeadBlockWeights& w, const QuantBlock& qb, int l, float* h,
                              const bf16* m, int ldm, bf16* act, bf16* buf, int R, int C,
                              int H, bool attention, int n_head, int groups, float eps,
                              const hg::GemmLaunch& go) {
  auto ln = [&](const bf16* nrm, const bf16* mm) {
    return go.stage(dim3(R), 256, 0, ln_modulate_chain_q_kernel,
                    static_cast<const float*>(h), C, nrm, nrm + C, mm, ldm, mm + C, ldm, qb.aq,
                    qb.sa, eps);
  };
  auto quantize = [&](const bf16* x, int K) {
    return go.stage(dim3(R), 256, 0, quantize_rows_vec_kernel<bf16>, x, K, qb.aq, qb.sa);
  };
  if (attention) {
    const int wtok = R / groups, hd = C / n_head;
    const float scale = 1.f / sqrtf(static_cast<float>(hd));
    BD_CHECK_ERR(ln(w.n1 + (size_t)l * 2 * C, m));
    Epilogue qkv_ep{};
    qkv_ep.bias = w.bqkv + (size_t)l * 3 * C;
    qkv_ep.out = buf;
    qkv_ep.ldo = 3 * C;
    qkv_ep.sa = qb.sa;
    qkv_ep.ws = qb.wqkv_s + (size_t)l * 3 * C;
    BD_CHECK_ERR((go.gemm_q<kBiasBf16, KIND>(kQkv, l * 3 * C, qkv_ep)));
    BD_CHECK_ERR(go.stage(dim3(groups * n_head), 256, window_attention_smem(wtok, hd),
                          window_attention_kernel, static_cast<const bf16*>(buf), C, wtok, hd,
                          n_head, scale, act));
    BD_CHECK_ERR(quantize(act, C));
    Epilogue o_ep{};
    o_ep.bias = w.bo + (size_t)l * C;
    o_ep.resid = h;
    o_ep.ldr = C;
    o_ep.gate = m + 2 * C;
    o_ep.ldg = ldm;
    o_ep.sa = qb.sa;
    o_ep.ws = qb.wo_s + (size_t)l * C;
    BD_CHECK_ERR((go.gemm_q<kGatedResidualRound, KIND>(kWo, l * C, o_ep)));
  }
  const bf16* mm = m + (size_t)(attention ? 3 : 0) * C;
  BD_CHECK_ERR(ln(w.n2 + (size_t)l * 2 * C, mm));
  Epilogue glu_ep{};
  glu_ep.bias = w.b1 + (size_t)l * 2 * H;
  glu_ep.out = buf;
  glu_ep.ldo = H;
  glu_ep.hidden = H;
  glu_ep.sa = qb.sa;
  glu_ep.ws = qb.w1_s + (size_t)l * 2 * H;
  BD_CHECK_ERR((go.gemm_q<kSwiGLURoundQ, KIND>(kW1, l * 2 * H, glu_ep)));
  BD_CHECK_ERR(quantize(buf, H));
  Epilogue down_ep{};
  down_ep.bias = w.b2 + (size_t)l * C;
  down_ep.resid = h;
  down_ep.ldr = C;
  down_ep.gate = mm + 2 * C;
  down_ep.ldg = ldm;
  down_ep.sa = qb.sa;
  down_ep.ws = qb.w2_s + (size_t)l * C;
  return go.gemm_q<kGatedResidualRound, KIND>(kW2, l * C, down_ep);
}

}  // namespace

// Runs the whole sampler on `stream`. x [half, ch] fp32 holds x0 on entry and
// the result on return; noise [num_steps, half, ch] fp32; allmods
// [grid_steps, 2*half, W] bf16 with W = (num_ada * n_mods + 2) * C, n_mods 6
// (attention) or 3; t_host / dt_host are host arrays of grid_steps entries.
// Weights are stacked per block in the torch Linear layout ([L, out, in]);
// n1, wqkv, bqkv, wo and bo are read only when attention=1. h (fp32 [R, C]),
// act (bf16 [R, max(C, H)]) and buf (bf16 [R, max(3C, H)]) are scratch.
// quant 1 (int8) / 2 (packed int4): wqkv, wo, w1, w2 are int8 [L, out, in]
// / [L, out, in/2] with f32 scales *_s [L, out]; actf (fp32 [R, max(C, H)],
// kernel #2's route), aq (int8 [R, max(C, H)]) and sa (fp32 [R]) are
// scratch. round_residual 1: _block_body's rounding (#3/#4; quantized,
// quant_round_block, either family); 0: kernel #2's fp32 residual (the
// TransEncoder when quantized). Every route runs its products on the head
// GEMM of head_gemm.cuh (the quant modes on its integer kinds): gemm_plan
// (host, 12 ints) is {bm, bn, splits} of qkv, wo, w1 and w2
// (ops/fused_head.py::sampler_plans), and every launch of the chain is
// programmatic when pdl (0 only to measure what that saves; the quant
// modes' stage kernels are launched plain). Returns the first CUDA error,
// or 0.
extern "C" int bd_fused_em_sample(
    void* x, const void* noise, const void* allmods, int W,
    const float* t_host, const float* dt_host, float cfg, const void* in_w,
    const void* in_b, const void* f_out_w, const void* f_out_b, const void* n1,
    const void* n2, const void* wqkv, const void* bqkv, const void* wo,
    const void* bo, const void* w1, const void* b1, const void* w2,
    const void* b2, void* h_scratch, void* act_scratch, void* buf_scratch,
    int half, int ch, int C, int H, int num_blocks, int num_steps,
    int switch_freq, int n_head, int groups, int attention, int bounded,
    int final_chunk, float last_step, int quant, const void* wqkv_s,
    const void* wo_s, const void* w1_s, const void* w2_s, void* actf, void* aq,
    void* sa, int round_residual, const int* gemm_plan, int pdl, void* stream) {
  const int R = 2 * half;
  const int n_mods = attention ? 6 : 3;
  if (ch > kMaxCh || C % 64 != 0 || H % 32 != 0 || gemm_plan == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  if (quant < 0 || quant > 2 || (quant && !attention && !round_residual) ||
      (quant && round_residual && C > kLnChainMax))
    return static_cast<int>(cudaErrorInvalidValue);
  const QuantBlock qb{static_cast<const float*>(wqkv_s), static_cast<const float*>(wo_s),
                      static_cast<const float*>(w1_s), static_cast<const float*>(w2_s),
                      static_cast<float*>(actf), static_cast<int8_t*>(aq),
                      static_cast<float*>(sa)};
  if (attention && (C % n_head != 0 || R % groups != 0 || R / groups > 64 ||
                    (C / n_head) % 2))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float eps = 1e-6f;
  float* xf = static_cast<float*>(x);
  const float* nz = static_cast<const float*>(noise);
  const bf16* mods = static_cast<const bf16*>(allmods);
  float* h = static_cast<float*>(h_scratch);
  bf16* act = static_cast<bf16*>(act_scratch);
  bf16* buf = static_cast<bf16*>(buf_scratch);
  const HeadBlockWeights wts{
      static_cast<const bf16*>(n1), static_cast<const bf16*>(n2),
      static_cast<const bf16*>(wqkv), static_cast<const bf16*>(bqkv),
      static_cast<const bf16*>(wo), static_cast<const bf16*>(bo),
      static_cast<const bf16*>(w1), static_cast<const bf16*>(b1),
      static_cast<const bf16*>(w2), static_cast<const bf16*>(b2)};

  const int hd = attention ? C / n_head : 0;
  const int wtok = attention ? R / groups : 0;
  const size_t attn_smem = window_attention_smem(wtok, hd);
  if (attn_smem > 48 * 1024)
    BD_CHECK(cudaFuncSetAttribute(window_attention_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  static_cast<int>(attn_smem)));
  // go launches the stage kernels and their products on head_gemm.cuh,
  // the launches of that chain programmatic when pdl (kernel #2's quant
  // modes' stage kernels plain: hg::GemmLaunch; the round route's quant
  // modes gain from programmatic stage kernels as its bf16 mode does: 13%
  // of a 100-step H-1x int8 call, 6% at B-16x, PERF.md §6); a shape its GEMM
  // cannot take is refused. The products read the stage inputs: act (bf16)
  // or, quantized, aq (int8) for qkv, wo and w1 ([R, C]); buf (bf16) or aq
  // for w2 ([R, H]).
  hg::Plan plan[4] = {};
  hg::Product pr[4];
  const hg::GemmLaunch go{pr, plan, pdl != 0, pdl != 0 && (!quant || round_residual != 0), st};
  for (int i = 0; i < 4; ++i)
    plan[i] = {gemm_plan[3 * i], gemm_plan[3 * i + 1], gemm_plan[3 * i + 2]};
  const int L = num_blocks;
  const int kind = quant == 2 ? hg::kOpS4 : quant == 1 ? hg::kOpS8 : hg::kOpBf16;
  const void* a_in = quant ? static_cast<const void*>(aq) : act;
  const void* a_w2 = quant ? static_cast<const void*>(aq) : buf;
  bool ok = hg::make_product(kind, a_in, R, C, w1, L * 2 * H, 2 * H, true, plan[kW1], &pr[kW1]) &&
            hg::make_product(kind, a_w2, R, H, w2, L * C, C, false, plan[kW2], &pr[kW2]);
  if (attention)
    ok = ok &&
         hg::make_product(kind, a_in, R, C, wqkv, L * 3 * C, 3 * C, false, plan[kQkv],
                          &pr[kQkv]) &&
         hg::make_product(kind, a_in, R, C, wo, L * C, C, false, plan[kWo], &pr[kWo]);
  // at most 20 values a thread in final_em_rows_kernel, 16-byte rows of w
  ok = ok && C <= 20 * 256 && C % 8 == 0;
  // #2's window attention: head dim 128, windows of up to 64 rows; its row
  // quantizations: rows of at most 1024 kQuantVec
  ok = ok && (round_residual || !attention || hd == kWinHd) &&
       (!quant || (C <= 1024 * kQuantVec && H <= 1024 * kQuantVec));
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  if (!round_residual && attention) {
    BD_CHECK(cudaFuncSetAttribute(window_attention_rows_kernel<bf16>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  static_cast<int>(kWinSmem)));
    BD_CHECK(cudaFuncSetAttribute(window_attention_rows_kernel<float>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  static_cast<int>(kWinSmem)));
  }
  const int grid_steps = num_steps + (final_chunk ? 1 : 0);
  const int proj_blocks = static_cast<int>(((size_t)R * C + 255) / 256);
  const int proj_rows_blocks =
      static_cast<int>(((size_t)(R + kProjRows - 1) / kProjRows * C + 255) / 256);
  const size_t final_smem = 2 * C * sizeof(float);
  const auto final_kernel = C <= 8 * 256 ? final_em_rows_kernel<8> : final_em_rows_kernel<20>;

  for (int s = 0; s < grid_steps; ++s) {
    const bf16* mods_s = mods + (size_t)s * R * W;
    const bf16* iw = static_cast<const bf16*>(in_w);
    const float* ib = static_cast<const float*>(in_b);
    const float* xc = xf;
    if (ch == 16)
      BD_CHECK(go.stage(dim3(proj_rows_blocks), 256, 0,
                        round_residual ? proj_in_rows_kernel<16, true>
                                       : proj_in_rows_kernel<16, false>,
                        xc, half, iw, ib, h, R, C));
    else if (ch == 32)
      BD_CHECK(go.stage(dim3(proj_rows_blocks), 256, 0,
                        round_residual ? proj_in_rows_kernel<32, true>
                                       : proj_in_rows_kernel<32, false>,
                        xc, half, iw, ib, h, R, C));
    else
      BD_CHECK(go.stage(dim3(proj_blocks), 256, 0, proj_in_kernel, xc, half, ch, iw, ib, h, R,
                        C, round_residual));
    for (int l = 0; l < num_blocks; ++l) {
      const bf16* m = mods_s + (size_t)(l / switch_freq) * n_mods * C;
      if (quant && round_residual)
        BD_CHECK((quant == 2 ? quant_round_block<hg::kOpS4> : quant_round_block<hg::kOpS8>)(
            wts, qb, l, h, m, W, act, buf, R, C, H, attention != 0, n_head, groups, eps, go));
      else if (quant)
        BD_CHECK((quant == 2 ? quant_block<hg::kOpS4> : quant_block<hg::kOpS8>)(
            wts, qb, l, h, m, W, buf, R, C, H, n_head, groups, eps, go));
      else
        BD_CHECK((round_residual ? head_block<true, hg::GemmLaunch>
                                 : head_block<false, hg::GemmLaunch>)(
            wts, l, h, m, W, act, buf, R, C, H, attention != 0, n_head, groups, eps, go));
    }
    const bool stochastic = s < num_steps;
    BD_CHECK(go.stage(dim3(half), 256, final_smem, final_kernel,
                      static_cast<const float*>(h), C, mods_s + (W - 2 * C), W,
                      static_cast<const bf16*>(f_out_w),
                      static_cast<const float*>(f_out_b), xf,
                      stochastic ? nz + (size_t)s * half * ch : nullptr, half, ch,
                      t_host[s], dt_host[s], cfg, last_step, bounded, eps));
  }
  return 0;
}

// One product of the sampler's head GEMM (ops/fused_head.py::head_gemm), for
// its checks and timings (hg::single_product): mode 0 (kBiasBf16), 1 / 9
// (kGatedResidual / kGatedResidualRound) or 2 / 10 (kSwiGLU / kSwiGLURound).
// The head blocks' modes have their entries beside their kernels
// (fused_block.cu, fused_net.cu). Returns the first CUDA error, or 0.
extern "C" int bd_head_gemm(const void* a, const void* w, const void* bias, void* out,
                            void* resid, const void* gate, const int* shape, void* stream) {
  hg::Product pr;
  hg::Plan plan;
  Epilogue ep;
  if (!hg::single_product(a, w, bias, out, resid, gate, shape, &pr, &plan, &ep))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (shape[4]) {
    case kBiasBf16: return static_cast<int>(hg::gemm<kBiasBf16>(pr, 0, plan, ep, false, st));
    case kGatedResidual:
      return static_cast<int>(hg::gemm<kGatedResidual>(pr, 0, plan, ep, false, st));
    case kSwiGLU: return static_cast<int>(hg::gemm<kSwiGLU>(pr, 0, plan, ep, false, st));
    case kGatedResidualRound:
      return static_cast<int>(hg::gemm<kGatedResidualRound>(pr, 0, plan, ep, false, st));
    case kSwiGLURound:
      return static_cast<int>(hg::gemm<kSwiGLURound>(pr, 0, plan, ep, false, st));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

namespace {

template <int KIND>
cudaError_t head_gemm_s8(const hg::Product& pr, int mode, const hg::Plan& plan,
                         const Epilogue& ep, cudaStream_t st) {
  switch (mode) {
    case kBiasBf16: return hg::gemm<kBiasBf16, KIND>(pr, 0, plan, ep, false, st);
    case kGatedResidual: return hg::gemm<kGatedResidual, KIND>(pr, 0, plan, ep, false, st);
    case kSwiGLUQ: return hg::gemm<kSwiGLUQ, KIND>(pr, 0, plan, ep, false, st);
    case kGatedResidualRound:
      return hg::gemm<kGatedResidualRound, KIND>(pr, 0, plan, ep, false, st);
    case kSwiGLURoundQ: return hg::gemm<kSwiGLURoundQ, KIND>(pr, 0, plan, ep, false, st);
    case kOutS32: return hg::gemm<kOutS32, KIND>(pr, 0, plan, ep, false, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// One integer product of the sampler's quant modes on the head GEMM
// (ops/fused_head.py::head_gemm_s8), for its checks and timings: a [R, K]
// int8 rows with row scales sa [R]; w [N, K] int8 (packed int4: [N, K/2])
// with column scales ws [N]; bias bf16 [N]; shape {R, N, K, ldg, mode, bm,
// bn, splits, int4}; mode 0 (kBiasBf16: out bf16 [R, N]), 1 / 9
// (kGatedResidual / kGatedResidualRound: resid fp32 [R, N] in place, gate
// bf16 rows ldg apart), 8 (kSwiGLUQ, w rows [h1; h2]: out fp32 [R, N / 2])
// or 11 (kSwiGLURoundQ: out bf16 [R, N / 2]) or 12 (kOutS32: out int32 [R,
// N], the raw sums; sa, ws and bias unread). Returns the first CUDA error,
// or 0.
extern "C" int bd_head_gemm_s8(const void* a, const void* sa, const void* w, const void* ws,
                               const void* bias, void* out, void* resid, const void* gate,
                               const int* shape, void* stream) {
  const int R = shape[0], N = shape[1], K = shape[2], ldg = shape[3], mode = shape[4];
  const hg::Plan plan{shape[5], shape[6], shape[7]};
  const int kind = shape[8] ? hg::kOpS4 : hg::kOpS8;
  hg::Product pr;
  if (!hg::make_product(kind, a, R, K, w, N, N, is_swiglu(mode), plan, &pr) || N % 16 != 0 ||
      ldg % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Epilogue ep{};
  ep.bias = static_cast<const bf16*>(bias);
  ep.out = out;
  ep.ldo = is_swiglu(mode) ? N / 2 : N;
  ep.resid = static_cast<float*>(resid);
  ep.ldr = N;
  ep.gate = static_cast<const bf16*>(gate);
  ep.ldg = ldg;
  ep.hidden = N / 2;
  ep.sa = static_cast<const float*>(sa);
  ep.ws = static_cast<const float*>(ws);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(kind == hg::kOpS4 ? head_gemm_s8<hg::kOpS4>(pr, mode, plan, ep, st)
                                            : head_gemm_s8<hg::kOpS8>(pr, mode, plan, ep, st));
}
