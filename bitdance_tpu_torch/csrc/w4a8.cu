// W4A8 matmul: activations quantized per row to int8, times packed int4
// weights, s8 x s8 -> s32 on the tensor cores, out = acc * (sx[m] * sw[n]).
//
// Replaces the TPU kernel bitdance_tpu/ops/int4.py::_w4a8_kernel (entry
// _w4a8_matmul_tpu, with the row quantization _quantize_rows that the JAX
// package runs beside it in XLA): int8 x [M, K] (row scales sx) times the
// nibble-packed weight, unpacked in registers, into f32 scaled by the row
// and column scales. Here the weight is [N, K/2] (K contiguous per output
// column) where the JAX package stores [K/2, N]; the byte pairing (k,
// k + K/2) is the same.
//
// What bounds it on the H100: at the serving shapes (M = 128-256 rows, K
// 5120 or 17408, N up to 17408) each call streams the packed weight once
// (e.g. gate_proj 17408 x 2560 bytes, 44.6 MB, 13.3 us at 3.35 TB/s) for
// 2*M*N*K integer operations (22.8 GOP at M = 128, 11.5 us at 1,979 TOP/s):
// bytes and operations are close, and the activations are re-read from L2
// by every column tile.
//
// Design: a row-quantization kernel writes int8 x and sx (the same values as
// the plain version: true division, round half to even), then the s8 GEMM
// of int8_gemm.cuh with packed B: 64x64 output tiles, m tiles fastest in the
// grid so the tiles sharing a weight slice run together and read it from L2
// once more at most, a 3-stage cp.async pipeline, and the nibble unpack in
// registers (two tensor-core products per packed word, one per plane). The
// epilogue writes bf16 or fp32 (the caller's activation dtype).
#include "int8_gemm.cuh"

// x [M, K] bf16 (x_bf16 = 1) or fp32; xq [M, K] int8 and sx [M] f32 are
// scratch (they hold the quantized rows afterwards); wq [N, K/2] packed
// int8, sw [N] f32; out [M, N] in x's dtype. K % 128 == 0, N % 64 == 0.
// Returns the first CUDA error, or 0.
extern "C" int bd_w4a8_matmul(const void* x, int x_bf16, void* xq, void* sx,
                              const void* wq, const void* sw, void* out, int M,
                              int N, int K, void* stream) {
  if (M <= 0 || K % 128 != 0 || N % 64 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int8_t* q = static_cast<int8_t*>(xq);
  float* s = static_cast<float*>(sx);
  cudaError_t e =
      x_bf16 ? launch_quantize_rows(static_cast<const bf16*>(x), K, K, q, K, s, M, st)
             : launch_quantize_rows(static_cast<const float*>(x), K, K, q, K, s, M, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  Epilogue ep{};
  ep.out = out;
  ep.ldo = N;
  const int8_t* w = static_cast<const int8_t*>(wq);
  const float* ws = static_cast<const float*>(sw);
  e = x_bf16 ? launch_gemm_s8<kOutBf16, true>(q, K, s, w, ws, K, M, N, ep, st)
             : launch_gemm_s8<kOutF32, true>(q, K, s, w, ws, K, M, N, ep, st);
  return static_cast<int>(e);
}
