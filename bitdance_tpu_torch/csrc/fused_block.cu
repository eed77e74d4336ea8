// One adaLN block of the diffusion head per call, for the per-call head
// forward (DiffNet.forward at inference: the unguided sampler, cfg_mult 1).
//
// Replaces the TPU kernels of bitdance_tpu/ops/fused_block.py:
//   bd_fused_mlp_block  <- _fused_mlp_block_kernel (launched at :95):
//     h = LN(x) * (1 + scale) + shift; [h1 | h2] = h @ w1 + b1;
//     out = x + (silu(h1) * h2 @ w2 + b2) * gate
//     (every MlpResBlock of the MlpEncoder; the SwiGLU half of a TransBlock)
//   bd_fused_attn_block <- _fused_attn_block_kernel (launched at :183):
//     h = LN(x) * (1 + scale) + shift; qkv = h @ wqkv + bqkv, columns
//     (3, n_head, hd); per group of W tokens and head softmax(q k^T / sqrt(hd))
//     v; out = x + (o @ wo + bo) * gate
//     (the attention half of a TransBlock)
// Precision as the TPU kernels: two-pass fp32 LN statistics, bf16 product
// operands, fp32 accumulation, h12 and qkv kept in fp32, softmax in fp32,
// output (x + y * gate) rounded once to x's dtype (bf16).
//
// What bounds it on the H100: the weights. At the head's row counts (8-512
// rows per call) one call reads 14.75 MB (C 1280) or 5.3 MB / 4.7 MB (C 768)
// of bf16 weights for at most ~2 x rows FLOP per weight element, far under
// the ~295 FLOP/byte at which the tensor cores limit; the least time is
// 1.4-4.4 us of HBM traffic, so launch and latency costs dominate.
//
// Design: the TPU kernel holds a whole row block in VMEM and runs both
// products back to back. Here the w1 product needs the LN of the full row
// first and the w2 product the whole GLU row, so each block is a short
// chain on the caller's stream. The MLP block (#14): LN + modulate (one CTA
// per row, bf16 out), then both products on the wgmma head GEMM
// (head_gemm.cuh) by the plans of ops/fused_block.py::mlp_block_plans (H-1x
// at 8 rows: w1 30 tiles x 4 splits, w2 10 x 8; B-16x at 512: w1 72 x 1, w2
// 24 x 4), w1 with the kSwiGLUF32 epilogue (fp32 h1 / h2), w2 with
// kGatedResidualBf16 (reads x, writes x's dtype), both launched
// programmatic so that their weight tiles are in flight while the kernel
// ahead finishes; their tensor maps come from the head GEMM's cache, so a
// call encodes none once its shapes were seen. The first design ran both
// products on head_blocks.cuh's mma.sync GEMM (64x64 tiles: 20-60 CTAs a
// product at C 1280 and a few rows, each walking K alone; 0.093 ms a call at
// H-1x's 8 rows, PERF.md). The attention block (#15) still runs that GEMM:
// the qkv product into an fp32 buffer, one CTA per (group, head) for the
// window softmax, then the wo product with the gated-residual epilogue that
// reads x. The mods are read through a row stride (the caller's [rows, C]
// slices of the adaLN output, or 0 to broadcast one row), never copied.
#include "head_gemm.cuh"

namespace {

bool shapes_ok(int C, int H) {
  return C > 0 && C % kBN == 0 && C % kBK == 0 && H % kBK == 0 &&
         (2 * H) % kBN == 0;
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// out [rows, C] bf16 = one MlpResBlock / SwiGLU half on x [rows, C] bf16
// (contiguous, 16-byte aligned). scale, shift: bf16 rows ld_* elements apart
// (0 broadcasts row 0); gate likewise, 16-byte aligned with ld_gate % 8 == 0.
// ln_w, ln_b [C]; w1 [2H, C], b1 [2H]; w2 [C, H], b2 [C] (torch Linear
// layout, bf16); C % 128 == 0 and H % 64 == 0 (the head GEMM's tiles).
// act (bf16 [rows, C]) and glu (bf16 [rows, H]) are scratch. plan: {bm, bn,
// splits} of w1, then of w2. pdl 2 launches all three kernels programmatic
// (the LN's launch faster by 0.4 us a call at H-1x's 8 rows, slower by as
// much at B-16x's 512, PERF.md), 1 the products only, 0 none (only to
// measure what that saves).
// Returns the first CUDA error, or 0; a shape the head GEMM cannot take is
// refused (cudaErrorInvalidValue), never run on another GEMM.
extern "C" int bd_fused_mlp_block(
    const void* x, const void* scale, int ld_scale, const void* shift,
    int ld_shift, const void* gate, int ld_gate, const void* ln_w,
    const void* ln_b, const void* w1, const void* b1, const void* w2,
    const void* b2, void* act_scratch, void* glu_scratch, void* out, int rows,
    int C, int H, float eps, const int* plan, int pdl, void* stream) {
  const hg::Plan p1{plan[0], plan[1], plan[2]}, p2{plan[3], plan[4], plan[5]};
  hg::Product pr1, pr2;
  if (rows <= 0 || C % 128 != 0 || H % 64 != 0 || ld_gate % 8 != 0 || !aligned16(x) ||
      !aligned16(gate) || !aligned16(out) || !aligned16(b1) || !aligned16(b2) ||
      !hg::make_product(hg::kOpBf16, act_scratch, rows, C, w1, 2 * H, 2 * H, true, p1, &pr1) ||
      !hg::make_product(hg::kOpBf16, glu_scratch, rows, H, w2, C, C, false, p2, &pr2))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* X = static_cast<const bf16*>(x);
  BD_CHECK(hg::launch(pdl > 1, dim3(rows), 256, 0, st, ln_modulate_kernel<bf16, true>, X, C,
                      static_cast<const bf16*>(ln_w), static_cast<const bf16*>(ln_b),
                      static_cast<const bf16*>(scale), ld_scale,
                      static_cast<const bf16*>(shift), ld_shift,
                      static_cast<bf16*>(act_scratch), eps));
  Epilogue glu_ep{};
  glu_ep.bias = static_cast<const bf16*>(b1);
  glu_ep.out = glu_scratch;
  glu_ep.ldo = H;
  glu_ep.hidden = H;
  BD_CHECK(hg::gemm<kSwiGLUF32>(pr1, 0, p1, glu_ep, pdl > 0, st));
  Epilogue out_ep{};
  out_ep.bias = static_cast<const bf16*>(b2);
  out_ep.out = out;
  out_ep.ldo = C;
  out_ep.gate = static_cast<const bf16*>(gate);
  out_ep.ldg = ld_gate;
  out_ep.x = X;
  out_ep.ldx = C;
  return static_cast<int>(hg::gemm<kGatedResidualBf16>(pr2, 0, p2, out_ep, pdl > 0, st));
}

// One product of #14 on the head GEMM alone (ops/fused_head.py::head_gemm,
// hg::single_product), for its checks and timings: mode 3 (kSwiGLUF32) or 5
// (kGatedResidualBf16). Returns the first CUDA error, or 0.
extern "C" int bd_head_gemm_block(const void* a, const void* w, const void* bias, void* out,
                                  void* resid, const void* gate, const int* shape,
                                  void* stream) {
  hg::Product pr;
  hg::Plan plan;
  Epilogue ep;
  if (!hg::single_product(a, w, bias, out, resid, gate, shape, &pr, &plan, &ep))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (shape[4]) {
    case kSwiGLUF32: return static_cast<int>(hg::gemm<kSwiGLUF32>(pr, 0, plan, ep, false, st));
    case kGatedResidualBf16:
      return static_cast<int>(hg::gemm<kGatedResidualBf16>(pr, 0, plan, ep, false, st));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// out [G*w, C] bf16 = the attention half of a TransBlock on x [G, w, C] bf16
// (contiguous), groups of w tokens attending to each other. Mods as in
// bd_fused_mlp_block; wqkv [3C, C], bqkv [3C], wo [C, C], bo [C]. act (bf16
// [G*w, C]) and qkv (fp32 [G*w, 3C]) are scratch. Returns the first CUDA
// error, or 0.
extern "C" int bd_fused_attn_block(
    const void* x, const void* scale, int ld_scale, const void* shift,
    int ld_shift, const void* gate, int ld_gate, const void* ln_w,
    const void* ln_b, const void* wqkv, const void* bqkv, const void* wo,
    const void* bo, void* act_scratch, void* qkv_scratch, void* out,
    int groups, int w, int C, int n_head, float eps, void* stream) {
  const int rows = groups * w;
  if (rows <= 0 || !shapes_ok(C, C) || n_head <= 0 || C % n_head != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int hd = C / n_head;
  const size_t smem = window_attention_smem<float>(w, hd);
  if (smem > 227 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (smem > 48 * 1024)
    BD_CHECK(cudaFuncSetAttribute(window_attention_kernel<float>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  static_cast<int>(smem)));
  const bf16* X = static_cast<const bf16*>(x);
  bf16* act = static_cast<bf16*>(act_scratch);
  float* qkv = static_cast<float*>(qkv_scratch);
  ln_modulate_kernel<bf16, true><<<rows, 256, 0, st>>>(
      X, C, static_cast<const bf16*>(ln_w), static_cast<const bf16*>(ln_b),
      static_cast<const bf16*>(scale), ld_scale,
      static_cast<const bf16*>(shift), ld_shift, act, eps);
  BD_CHECK(cudaGetLastError());
  Epilogue qkv_ep{};
  qkv_ep.bias = static_cast<const bf16*>(bqkv);
  qkv_ep.out = qkv;
  qkv_ep.ldo = 3 * C;
  BD_CHECK(launch_gemm<kBiasF32>(act, C, static_cast<const bf16*>(wqkv), C,
                                 rows, 3 * C, qkv_ep, st));
  // the LN output is consumed; act now holds the attention output
  window_attention_kernel<float><<<groups * n_head, 256, smem, st>>>(
      qkv, C, w, hd, n_head, 1.f / sqrtf(static_cast<float>(hd)), act);
  BD_CHECK(cudaGetLastError());
  Epilogue out_ep{};
  out_ep.bias = static_cast<const bf16*>(bo);
  out_ep.out = out;
  out_ep.ldo = C;
  out_ep.gate = static_cast<const bf16*>(gate);
  out_ep.ldg = ld_gate;
  out_ep.x = X;
  out_ep.ldx = C;
  return static_cast<int>(launch_gemm<kGatedResidualBf16>(
      act, C, static_cast<const bf16*>(wo), C, rows, C, out_ep, st));
}
