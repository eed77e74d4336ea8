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
// What bounds it on the H100: at the serving shapes (M = 128 or 132 rows,
// K 5120 or 17408, N 1024 to 17408) each call must stream the packed weight
// once (gate_proj 17408 x 2560 bytes, 44.6 MB, 13.3 us at 3.35 TB/s) for
// 2*M*N*K integer operations (22.8 GOP at M = 128, 11.5 us at 1,979
// TOP/s); the seven products of one Qwen3-14B layer are 57 us of bytes and
// 43 us of operations. In a decode step each layer's 165 MB of weight
// comes cold from HBM. The first design (an mma.sync m16n8k32 GEMM,
// 64 x 64 output tiles) streamed each weight slice twice or three times,
// re-read the activations once per 64 output columns (5x the weight's
// bytes at M = 128), ran k_proj / v_proj on 32 blocks, and reached only
// part of the int8 rate: 0.544 ms for the seven products.
//
// Design (swap-AB on wgmma; each point answers one of those faults):
// - D^T[N, M] = W[N, K] . Xq[M, K]^T: the weight rows are wgmma's 64-row M
//   side and the token rows its N side, padded to a width the kernel is
//   built for (16, 32, 64, 128, 144; 132 rows -> 144). Above 144 rows the
//   tokens are cut into equal chunks (grid z), each a pass over the weight.
//   Rows past M are never stored.
// - A block is two warpgroups over 128 weight rows and holds an SM: each
//   weight byte is streamed once per product and the activations are read
//   once per 128 output columns. A ring of 4 stages in shared memory (two
//   in flight ahead of the tensor cores) holds per stage 128 packed bytes
//   of each weight row (256 k: the low plane against Xq columns [j, j+128),
//   the high plane against [K/2 + j, K/2 + j + 128)), brought by one TMA
//   tensor copy in the 128-byte swizzle (the host encodes the weight's
//   tensor map once per weight), and the two Xq tiles of the stage, brought
//   by one bulk copy from the image the row quantization writes (each
//   plane's tile already in wgmma's 128-byte swizzle, K-major). Thread 0
//   issues both; they complete on the slot's mbarrier.
// - Each warp reads its 16 weight rows of packed bytes by ldmatrix.x4,
//   which gives exactly the 8-bit A fragment of 32 packed bytes; each
//   nibble v (s = v - 16 [v >= 8]) becomes the u8 s + 8 = v ^ 8 in one LOP3,
//   and eight wgmma.m64nNk32.s32.u8.s8 with A from registers take a stage,
//   each its own commit group, so seven stay in flight while the next
//   fragment is unpacked. The epilogue takes 8 * sum_k xq[m, k] (computed
//   by the row quantization) off each sum: exact in int32. The unpacked
//   weights never touch shared memory. No instruction but a wgmma writes
//   the accumulators (ptxas serializes the wgmmas otherwise).
// - Split-K where the 128-row tiles alone would leave SMs idle or load
//   some twice (ops/int4.py::w4a8_splits): the tiles from tail_from on take
//   an equal share of the stages each (k_proj / v_proj 10 ways, q / o /
//   down_proj 3; gate / up_proj's 136 tiles on 132 SMs: 132 whole, the
//   last 4 split 10 ways) and write their exact int32 sums to scratch; a
//   second launch adds them in split order and scales. Integer sums: the
//   result is bit-equal at every split count and on every run.
// - The epilogue scales in fp32 as the plain version does, y =
//   float(acc) * (sx[m] * sw[n]), and stages the transposed tile through
//   shared memory so the [M, N] output is written in 16-byte stores.
// - The row quantization stays its own launch (quantize_image_kernel, bit
//   for bit the plain version's values); the host can launch the GEMM alone
//   on rows it quantized before (x null), which is how its time is taken
//   apart.
//
// Measured (chip_smoke.py and scripts/torch_w4a8_times.py, NVIDIA H100 80GB
// HBM3, 700.00 W), the seven products of one layer at M 128: 0.223 ms warm
// (the first design 0.53-0.54), 0.174-0.177 ms over six layers' weights in
// turn (cold L2; the first design 0.471), the
// GEMM launches alone 0.179 ms warm; torch._int_mm on int8 weights 0.245 /
// 0.227. What still bounds it: integer work between register-A wgmmas
// (unpack, fences) adds to their tensor time instead of overlapping it,
// gate / up_proj are as much operations as bytes at M 128, and an eager
// call of a short product is host-bound (three launches).
#include <cuda.h>
#include <cudaTypedefs.h>

#include "head_blocks.cuh"

// The shapes of one call, built once per shape by the host
// (ops/int4.py::W4A8Shape, the same layout). The 128-row tiles from
// tail_from on take K in n_splits parts (1 <= n_splits <= the 256-k stages),
// the earlier ones whole. nt: the token width the kernel is built for (16,
// 32, 64, 128 or 144) >= chunk_rows; chunks * chunk_rows >= M.
struct W4A8Shape {
  int M, N, K, n_splits, tail_from, chunks, chunk_rows, nt, out_bf16;
};

namespace w4a8 {

constexpr int kRows = 128;       // weight rows per block: two warpgroups of 64
constexpr int kThreads = 256;
constexpr int kSlice = 128;      // packed bytes of a weight row per stage (256 k)
constexpr int kRing = 4;         // stages in the ring
constexpr int kAhead = kRing - 2;  // stages in flight ahead of the tensor cores
constexpr int kWBytes = kRows * kSlice;
constexpr int kLd = kRows + 4;   // epilogue tile row (32-bit words): conflict-free

template <int NT>
struct Smem {
  static constexpr int kPlane = NT * 128;        // one plane's Xq: NT rows of 128 bytes
  static constexpr int kX = 2 * kPlane;
  static constexpr int kStage = kX + kWBytes;    // a multiple of 1024
  static constexpr int kBars = kRing * kStage;   // the ring's mbarriers
  static constexpr int kBytes = kBars + 8 * kRing + 1024;
  static_assert(NT * kLd * 4 <= kRing * kStage, "the epilogue tile fits the ring");
};

// the low nibbles of four packed bytes as four u8, offset by 8: a nibble
// v holds s = v - 16 [v >= 8], and s + 8 = v ^ 8 (one LOP3). The GEMM sums
// (s + 8) x and takes 8 sum_k x off per token row (xsum), exactly.
__device__ __forceinline__ uint32_t nibbles_u8(uint32_t w) {
  return (w & 0x0F0F0F0Fu) ^ 0x08080808u;
}

#define WG_D8(i)                                                              \
  "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3]), "+r"(d[i + 4]), \
      "+r"(d[i + 5]), "+r"(d[i + 6]), "+r"(d[i + 7])

// D[64 x NT] (+)= A[64 x 32] (registers: this warp's 16 rows, the 8-bit
// fragment of mma.m16n8k32; unsigned) x B[32 x NT] (shared memory, signed,
// K-major, descriptor); scale_d = 0 overwrites D
template <int NT>
__device__ __forceinline__ void wgmma_s8(int (&d)[NT / 2], const uint32_t (&a)[4],
                                         uint64_t desc, int scale_d);

template <>
__device__ __forceinline__ void wgmma_s8<16>(int (&d)[8], const uint32_t (&a)[4],
                                             uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k32.s32.u8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p;\n}\n"
      : WG_D8(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_s8<32>(int (&d)[16], const uint32_t (&a)[4],
                                             uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.u8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p;\n}\n"
      : WG_D8(0), WG_D8(8)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_s8<64>(int (&d)[32], const uint32_t (&a)[4],
                                             uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.u8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p;\n}\n"
      : WG_D8(0), WG_D8(8), WG_D8(16), WG_D8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_s8<128>(int (&d)[64], const uint32_t (&a)[4],
                                             uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.u8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p;\n}\n"
      : WG_D8(0), WG_D8(8), WG_D8(16), WG_D8(24),
        WG_D8(32), WG_D8(40), WG_D8(48), WG_D8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_s8<144>(int (&d)[72], const uint32_t (&a)[4],
                                             uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %77, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n144k32.s32.u8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71"
      "}, {%72, %73, %74, %75}, %76, p;\n}\n"
      : WG_D8(0), WG_D8(8), WG_D8(16), WG_D8(24),
        WG_D8(32), WG_D8(40), WG_D8(48), WG_D8(56),
        WG_D8(64)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

#undef WG_D8

// 16-byte chunk c (0-7) of weight row r in a stage, as the tensor map's
// 128-byte swizzle places it: the 8 row addresses of an ldmatrix fall in 8
// distinct bank groups
__device__ __forceinline__ int w_at(int r, int c) {
  return r * kSlice + ((c ^ (r & 7)) << 4);
}

// grid (work units, 1, chunks of chunk_rows tokens). Units [0, tail_from)
// are the first 128-row tiles, whole; the rest are the later tiles times
// n_splits shares of K, the split index slowest. xi: the quantized rows as
// quantize_image_kernel lays them out. A whole tile writes out (bf16 when
// out_b, else out_f); a split writes its int32 sums to part [n_splits, M,
// N - 128 tail_from].
template <int NT>
__global__ void __launch_bounds__(kThreads, 1)
gemm_kernel(const int8_t* __restrict__ xi, const float* __restrict__ sx,
            const int* __restrict__ xsum, const __grid_constant__ CUtensorMap w_map,
            const float* __restrict__ sw,
            bf16* __restrict__ out_b, float* __restrict__ out_f, int* __restrict__ part,
            int M, int N, int K, int chunk_rows, int n_splits, int tail_from) {
  using Sm = Smem<NT>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* const smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);

  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int unit = blockIdx.x;
  const int tail_tiles = (N + kRows - 1) / kRows - tail_from;
  const bool whole = unit < tail_from;
  const int tile = whole ? unit : tail_from + (unit - tail_from) % tail_tiles;
  const int split = whole ? 0 : (unit - tail_from) / tail_tiles;
  const int splits = whole ? 1 : n_splits;
  const int n0 = tile * kRows;
  const int m0 = blockIdx.z * chunk_rows;
  const int rows = min(chunk_rows, M - m0);
  const int kh = K / 2;
  const int stages = (kh + kSlice - 1) / kSlice;  // the last may be half: its tail reads 0
  const int sa = split * stages / splits, sb = (split + 1) * stages / splits;
  const bool live = n0 + 64 * wg < N;  // N % 128 == 64: the last tile's second half idles

  // the ring: per slot, the stage's Xq tiles (both planes, one bulk copy
  // from the image) and its 128 weight rows x 128 packed bytes (one tensor
  // copy), both issued by thread 0 and completing on the slot's mbarrier
  uint64_t* const full = reinterpret_cast<uint64_t*>(smem + Sm::kBars);
  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < kRing; ++i) mbar_init(smem_u32(full + i), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int8_t* const x_img = xi + (size_t)blockIdx.z * stages * Sm::kX;
  auto load_stage = [&](int s, int slot) {
    const uint32_t xs = smem_u32(smem + slot * Sm::kStage), bar = smem_u32(full + slot);
    mbar_expect_tx(bar, Sm::kStage);
    bulk_g2s(xs, x_img + (size_t)s * Sm::kX, Sm::kX, bar);
    // rows past N and bytes past K/2 arrive as 0
    tma_2d(xs + Sm::kX, &w_map, s * kSlice, n0, bar);
  };

  // no instruction but a wgmma may define the accumulators (ptxas would
  // serialize every wgmma): the block's first one overwrites them
  int acc[NT / 2];

  if (tid == 0)
    for (int i = 0; i < kAhead && sa + i < sb; ++i) load_stage(sa + i, i);
  // this lane's ldmatrix row: matrix q = lane / 8 is rows (q & 1) * 8 + 0-7
  // of the warp's 16, 16-byte chunk q / 2 of a 32-byte k step
  const int q = lane >> 3;
  const int a_row = wg * 64 + warp * 16 + (q & 1) * 8 + (lane & 7);

  // A stage is eight wgmmas, one per A fragment (four k steps, each the low
  // plane's, then the high plane's), each committed as its own group. A
  // fragment's registers are rewritten once the same fragment of the
  // previous stage has been read (wait_group 7), so seven wgmmas stay in
  // flight while the next is unpacked.
  uint32_t a[8][4];
  for (int s = sa; s < sb; ++s) {
    const int j = s - sa;
    // every warpgroup's wgmmas of stage j - 2 are done (each waited in stage
    // j - 1), so its slot takes stage j + kAhead
    __syncthreads();
    if (tid == 0 && s + kAhead < sb) load_stage(s + kAhead, (j + kAhead) % kRing);
    if (!live) continue;
    mbar_wait(smem_u32(full + j % kRing), (j / kRing) & 1);  // stage j has landed
    const unsigned char* xs = smem + (j % kRing) * Sm::kStage;
    const unsigned char* ws = xs + Sm::kX;
    // K-major B: 32 bytes a k step inside a plane's 128-byte rows, 8-row
    // groups 1024 B apart
    const uint32_t xa = smem_u32(xs);
    uint32_t p[4][4];
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) ldsm_x4(p[ks], smem_u32(ws + w_at(a_row, 2 * ks + (q >> 1))));
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int f = 2 * ks + h;
        wgmma_wait<7>();  // fragment f of stage j - 1 has been read
#pragma unroll
        for (int i = 0; i < 4; ++i) a[f][i] = nibbles_u8(h ? p[ks][i] >> 4 : p[ks][i]);
        wgmma_fence();
        wgmma_s8<NT>(acc, a[f], gmma_desc(xa + h * Sm::kPlane + 32 * ks, 16, 1024),
                     j > 0 || f > 0);
        wgmma_commit();
      }
    }
  }
  wgmma_wait<0>();
  __syncthreads();  // the ring is free for the epilogue tile

  // the tile transposed into shared memory as [token][weight row]: the
  // scaled fp32 outputs, or a split's int32 sums
  const bool split_k = splits > 1;
  float* tile_f = reinterpret_cast<float*>(smem);
  int* tile_i = reinterpret_cast<int*>(smem);
  if (live) {
    const int g = lane >> 2, t = lane & 3;
    const int r0 = wg * 64 + warp * 16 + g;
    const float sw0 = split_k ? 0.f : sw[n0 + r0], sw1 = split_k ? 0.f : sw[n0 + r0 + 8];
#pragma unroll
    for (int jn = 0; jn < NT / 8; ++jn)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int tok = jn * 8 + 2 * t + (i & 1), r = r0 + (i >> 1) * 8;
        const int m = m0 + min(tok, rows - 1);
        if (split_k)
          tile_i[tok * kLd + r] = acc[jn * 4 + i];  // the merge takes 8 xsum off
        else
          tile_f[tok * kLd + r] = static_cast<float>(acc[jn * 4 + i] - 8 * xsum[m]) *
                                  (sx[m] * ((i >> 1) ? sw1 : sw0));
      }
  }
  __syncthreads();
  const int nv = min(kRows, N - n0);  // 64 or 128 valid weight rows
  if (split_k) {
    const int nt_cols = N - tail_from * kRows;  // the split tiles' columns
    int* dst = part + ((size_t)split * M + m0) * nt_cols + n0 - tail_from * kRows;
    for (int c = tid; c < rows * nv / 4; c += kThreads) {
      const int tok = c / (nv / 4), at = (c % (nv / 4)) * 4;
      *reinterpret_cast<int4*>(dst + (size_t)tok * nt_cols + at) =
          *reinterpret_cast<const int4*>(tile_i + tok * kLd + at);
    }
  } else if (out_b != nullptr) {
    bf16* dst = out_b + (size_t)m0 * N + n0;
    for (int c = tid; c < rows * nv / 8; c += kThreads) {
      const int tok = c / (nv / 8), at = (c % (nv / 8)) * 8;
      const float4 a = *reinterpret_cast<const float4*>(tile_f + tok * kLd + at);
      const float4 b = *reinterpret_cast<const float4*>(tile_f + tok * kLd + at + 4);
      *reinterpret_cast<uint4*>(dst + (size_t)tok * N + at) =
          make_uint4(pack_bf16x2(a.x, a.y), pack_bf16x2(a.z, a.w), pack_bf16x2(b.x, b.y),
                     pack_bf16x2(b.z, b.w));
    }
  } else {
    float* dst = out_f + (size_t)m0 * N + n0;
    for (int c = tid; c < rows * nv / 4; c += kThreads) {
      const int tok = c / (nv / 4), at = (c % (nv / 4)) * 4;
      *reinterpret_cast<float4*>(dst + (size_t)tok * N + at) =
          *reinterpret_cast<const float4*>(tile_f + tok * kLd + at);
    }
  }
}

// Per-row int8 quantization of x [M, K] (bf16 or fp32; 16-byte aligned
// rows) into sx [M] and the image the GEMM's bulk copies read: for token
// chunk z (chunk_rows rows each, padded to nt) and stage s (128 k of each
// plane), the low plane's tile then the high plane's, each nt rows of 128
// bytes; row r of plane p holds k = p K/2 + 128 s + 16 c.. in its 16-byte
// chunk c ^ (r % 8), wgmma's 128-byte swizzle; the second half of a last
// stage when K/2 % 128 == 64 is written as 0. Padding rows are never
// written: they only reach output columns that are not stored. Also xsum
// [M], each row's sum of its int8 values (the GEMM's offset correction).
// One block per row, 16-byte loads, the values of the plain version (true
// division, round half to even).
template <typename T>
__global__ void __launch_bounds__(256)
quantize_image_kernel(const T* __restrict__ x, int K, int chunk_rows, int nt,
                      int8_t* __restrict__ img, float* __restrict__ sx, int* __restrict__ xsum) {
  const T* xr = x + (size_t)blockIdx.x * K;
  auto load8 = [&](int k, float (&f)[8]) {  // x[k..k+8)
    const uint4* v = reinterpret_cast<const uint4*>(xr + k);
#pragma unroll
    for (int h = 0; h < (int)sizeof(T) / 2; ++h) {
      const uint4 u = v[h];
      const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
      for (int i = 0; i < 8 / ((int)sizeof(T) / 2); ++i)
        f[h * (8 / ((int)sizeof(T) / 2)) + i] = to_f32(e[i]);
    }
  };
  float amax = 0.f;
  for (int k = threadIdx.x * 8; k < K; k += 256 * 8) {
    float f[8];
    load8(k, f);
#pragma unroll
    for (int i = 0; i < 8; ++i) amax = fmaxf(amax, fabsf(f[i]));
  }
  amax = block_max(amax);
  const float s = fmaxf(amax / 127.f, 1e-12f);
  const int z = blockIdx.x / chunk_rows, r = blockIdx.x % chunk_rows;
  const int kh = K / 2, stages = (kh + kSlice - 1) / kSlice;
  int8_t* const base = img + ((size_t)z * stages * 2 * nt + r) * 128;
  int qsum = 0;
  for (int k = threadIdx.x * 8; k < K; k += 256 * 8) {
    float f[8];
    load8(k, f);
    uint32_t w[2] = {0u, 0u};
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int t = max(-127, min(127, __float2int_rn(f[i] / s)));
      qsum += t;
      w[i >> 2] |= static_cast<uint32_t>(t & 0xFF) << (8 * (i & 3));
    }
    const int hi = k >= kh, kk = k - hi * kh;  // plane, k inside it
    const int c = (kk % kSlice) / 16;
    *reinterpret_cast<uint2*>(base + ((size_t)(kk / kSlice) * 2 + hi) * nt * 128 +
                              ((c ^ (r & 7)) << 4) + (kk & 8)) = make_uint2(w[0], w[1]);
  }
  // a half last stage: its second half meets weight bytes that arrive as
  // 0, which the GEMM reads as 0 + 8, so the rows there must be 0
  if (kh % kSlice != 0 && threadIdx.x < 8) {
    const int hi = threadIdx.x >> 2, c = 4 + (threadIdx.x & 3);
    *reinterpret_cast<uint4*>(base + ((size_t)(stages - 1) * 2 + hi) * nt * 128 +
                              ((c ^ (r & 7)) << 4)) = make_uint4(0u, 0u, 0u, 0u);
  }
  __shared__ int red_q[8];
  qsum = __reduce_add_sync(0xffffffffu, qsum);
  if ((threadIdx.x & 31) == 0) red_q[threadIdx.x >> 5] = qsum;
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) total += red_q[i];
    sx[blockIdx.x] = s;
    xsum[blockIdx.x] = total;
  }
}

// The splits' int32 sums added in split order, less 8 xsum[m], then scaled
// as a whole tile's epilogue does: one thread per 4 outputs of a row, over the split
// tiles' columns [n0, N) (part [n_splits, M, N - n0]).
__global__ void __launch_bounds__(256)
merge_kernel(const int* __restrict__ part, const float* __restrict__ sx,
             const int* __restrict__ xsum, const float* __restrict__ sw, bf16* __restrict__ out_b,
             float* __restrict__ out_f, int M, int N, int n0, int n_splits) {
  const int cols = N - n0, c4 = cols / 4;
  const int idx = blockIdx.x * 256 + threadIdx.x;
  if (idx >= M * c4) return;
  const int m = idx / c4, c = (idx % c4) * 4, n = n0 + c;
  const int off = -8 * xsum[m];
  int4 s = make_int4(off, off, off, off);
  for (int i = 0; i < n_splits; ++i) {
    const int4 p = *reinterpret_cast<const int4*>(part + ((size_t)i * M + m) * cols + c);
    s.x += p.x;
    s.y += p.y;
    s.z += p.z;
    s.w += p.w;
  }
  const float a = sx[m];
  const float4 w = *reinterpret_cast<const float4*>(sw + n);
  const float y0 = static_cast<float>(s.x) * (a * w.x), y1 = static_cast<float>(s.y) * (a * w.y);
  const float y2 = static_cast<float>(s.z) * (a * w.z), y3 = static_cast<float>(s.w) * (a * w.w);
  if (out_b != nullptr)
    *reinterpret_cast<uint2*>(out_b + (size_t)m * N + n) =
        make_uint2(pack_bf16x2(y0, y1), pack_bf16x2(y2, y3));
  else
    *reinterpret_cast<float4*>(out_f + (size_t)m * N + n) = make_float4(y0, y1, y2, y3);
}

// MaxDynamicSharedMemorySize of gemm_kernel<NT>, once per device
template <int NT>
cudaError_t allow_smem() {
  static unsigned done = 0;  // bit per device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < 32 && (done >> dev & 1u))) return err;
  err = cudaFuncSetAttribute(gemm_kernel<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             Smem<NT>::kBytes);
  if (err == cudaSuccess && dev < 32) done |= 1u << dev;
  return err;
}

constexpr int kMapCache = 1024;  // tensor maps kept (a 14B model has 280 weights)

// The tensor map of a packed weight [N, K/2] for boxes of 128 rows x 128
// bytes in the 128-byte swizzle, cached by (address, N, K): a map holds
// nothing else, so a hit is the map a fresh encode would give. False if
// the driver has no cuTensorMapEncodeTiled or refuses the shape.
bool weight_map(const void* wq, int N, int K, CUtensorMap* out) {
  static PFN_cuTensorMapEncodeTiled encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found) !=
            cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      return false;
    encode = reinterpret_cast<PFN_cuTensorMapEncodeTiled>(fn);
  }
  struct Entry {
    const void* ptr;
    int N, K;
    CUtensorMap map;
  };
  static Entry cache[kMapCache];
  Entry& e = cache[(reinterpret_cast<uintptr_t>(wq) >> 8) % kMapCache];
  if (e.ptr != wq || e.N != N || e.K != K) {
    const cuuint64_t dims[2] = {static_cast<cuuint64_t>(K / 2), static_cast<cuuint64_t>(N)};
    const cuuint64_t strides[1] = {static_cast<cuuint64_t>(K / 2)};
    const cuuint32_t box[2] = {kSlice, kRows}, unit[2] = {1, 1};
    if (encode(&e.map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(wq), dims, strides,
               box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
               CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS) {
      e.ptr = nullptr;
      return false;
    }
    e.ptr = wq;
    e.N = N;
    e.K = K;
  }
  *out = e.map;
  return true;
}

template <int NT>
cudaError_t launch(const int8_t* xi, const float* sx, const int* xsum, const CUtensorMap& w_map,
                   const float* sw, void* out, int* part, const W4A8Shape& sh,
                   cudaStream_t st) {
  cudaError_t err = allow_smem<NT>();
  if (err != cudaSuccess) return err;
  bf16* ob = sh.out_bf16 ? static_cast<bf16*>(out) : nullptr;
  float* of = sh.out_bf16 ? nullptr : static_cast<float*>(out);
  const int tiles = (sh.N + kRows - 1) / kRows;
  const int units = sh.tail_from + (tiles - sh.tail_from) * sh.n_splits;
  gemm_kernel<NT><<<dim3(units, 1, sh.chunks), kThreads, Smem<NT>::kBytes, st>>>(
      xi, sx, xsum, w_map, sw, ob, of, part, sh.M, sh.N, sh.K, sh.chunk_rows, sh.n_splits,
      sh.tail_from);
  err = cudaGetLastError();
  if (err != cudaSuccess || sh.n_splits == 1 || sh.tail_from == tiles) return err;
  const int n0 = sh.tail_from * kRows, threads = sh.M * ((sh.N - n0) / 4);
  merge_kernel<<<(threads + 255) / 256, 256, 0, st>>>(part, sx, xsum, sw, ob, of, sh.M, sh.N,
                                                      n0, sh.n_splits);
  return cudaGetLastError();
}

}  // namespace w4a8

// x [M, K] bf16 (out_bf16) or fp32 (16-byte aligned), or null when xi and
// sx already hold the quantized rows; else they are scratch the row
// quantization fills: xi the image (chunks * stages * 2 * nt * 128 bytes,
// stages = ceil(K / 256); 16-byte aligned) followed by xsum [M] int32 (each
// row's sum of int8 values), sx [M] f32. wq [N, K/2] packed
// int8 (null: quantize only), sw [N] f32; out [M, N] in x's dtype; part:
// n_splits * M * (N - 128 tail_from) int32 scratch when tiles are split.
// K % 128 == 0, N % 64 == 0. Returns the first CUDA error, or 0.
extern "C" int bd_w4a8_matmul(const void* x, void* xi, void* sx, const void* wq,
                              const void* sw, void* out, void* part, const W4A8Shape* sh,
                              void* stream) {
  const W4A8Shape s = *sh;
  const int tiles = (s.N + w4a8::kRows - 1) / w4a8::kRows;
  if (s.M <= 0 || s.K % 128 != 0 || s.N % 64 != 0 || s.n_splits < 1 ||
      s.n_splits > (s.K / 2 + w4a8::kSlice - 1) / w4a8::kSlice || s.tail_from < 0 ||
      s.tail_from > tiles || s.chunk_rows > s.nt || s.chunks * s.chunk_rows < s.M ||
      (s.n_splits > 1 && s.tail_from < tiles && part == nullptr) ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(xi) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int8_t* img = static_cast<int8_t*>(xi);
  float* scale = static_cast<float*>(sx);
  const int stages = (s.K / 2 + w4a8::kSlice - 1) / w4a8::kSlice;
  int* xsum = reinterpret_cast<int*>(img + (size_t)s.chunks * stages * 2 * s.nt * 128);
  if (x != nullptr) {
    if (s.out_bf16)
      w4a8::quantize_image_kernel<<<s.M, 256, 0, st>>>(static_cast<const bf16*>(x), s.K,
                                                       s.chunk_rows, s.nt, img, scale, xsum);
    else
      w4a8::quantize_image_kernel<<<s.M, 256, 0, st>>>(static_cast<const float*>(x), s.K,
                                                       s.chunk_rows, s.nt, img, scale, xsum);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess || wq == nullptr) return static_cast<int>(e);
  }
  CUtensorMap w;
  if (!w4a8::weight_map(wq, s.N, s.K, &w)) return static_cast<int>(cudaErrorInvalidValue);
  const float* ws = static_cast<const float*>(sw);
  int* p = static_cast<int*>(part);
  cudaError_t e;
  switch (s.nt) {
    case 16: e = w4a8::launch<16>(img, scale, xsum, w, ws, out, p, s, st); break;
    case 32: e = w4a8::launch<32>(img, scale, xsum, w, ws, out, p, s, st); break;
    case 64: e = w4a8::launch<64>(img, scale, xsum, w, ws, out, p, s, st); break;
    case 128: e = w4a8::launch<128>(img, scale, xsum, w, ws, out, p, s, st); break;
    case 144: e = w4a8::launch<144>(img, scale, xsum, w, ws, out, p, s, st); break;
    default: e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}
