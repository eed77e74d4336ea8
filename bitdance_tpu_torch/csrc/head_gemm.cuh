// The head GEMM of the diffusion head's kernels: the whole sampler
// (fused_head.cu: kernel #2, the 14B head, bf16 and its W8A8 / W4A8 quant
// modes, and #3/#4, the ImageNet heads' round_residual route), one head block
// per call (fused_block.cu: #14 and #15) and one whole net per call
// (fused_net.cu: #5): epilogue(A[R, K] @ W[N, K]^T) on wgmma, bf16 with fp32 accumulators or
// int8 with int32 accumulators, fed by a TMA ring, split-K where the output
// tiles alone leave SMs idle, and every launch of the block chain
// programmatic (PDL) so that a product's weight tiles are in flight before
// the kernel ahead of it has finished; with head_block's launches on it
// (GemmLaunch).
//
// What bounds it on the H100: BitDance-H-1x runs 64 rows (32 images, CFG)
// through 12 blocks of w1 [3840, 1280] and w2 [1280, 1920]; each net call
// streams the 177 MB stack (3.5x the L2) for 11.3 GFLOP, ~64 FLOP a weight
// byte, far under the ~295 at which the tensor cores become the limit: 53 us
// of bytes a net call, ~1.5-3 us a product. BitDance-B-16x runs 1024 rows
// through 6 blocks (qkv [2304, 768], wo [768, 768], w1 [2304, 768], w2 [768,
// 1152]): 62 GFLOP a net call, bound by operations (62 us). The first
// design (mma.sync on 64x64 tiles, a cp.async ring walked by every thread,
// since removed) gave w2 at 64 rows 20 blocks on 132 SMs, each walking K
// serially, and left every launch waiting for the previous one to drain.
// The 14B head runs 128 rows (one image, CFG) or 256 through 6 blocks of qkv
// and w1 [15360, 5120], wo [5120, 5120] and w2 [5120, 7680]: 2.67 GB a net
// call in bf16, ~0.8 ms of bytes, with ~100 FLOP a weight byte; its quant
// modes stream 1.34 GB (int8) or 0.67 GB (packed int4) for the same integer
// operations, so int4 at 128 rows is as much operations (20 GOP a qkv, 10 us
// at the int8 peak) as bytes (11.7 us).
//
// Design:
// - Orientation: the token rows are wgmma's M side, one consumer warpgroup
//   per 64 rows (bm 64, or 128 on two warpgroups when R > 64); the weights'
//   out-features are its N side (bn 128; 256 was slower). A (row-major,
//   K contiguous) and W (the torch Linear layout [out, in]) are then both
//   K-major in shared memory, which wgmma reads with no transpose; 8-bit
//   wgmma takes K-major operands only, which [R, K] int8 rows and [out, in]
//   int8 weights already are.
// - Feeding: a ring of kRing stages (3-7, about 190 KB), each one 128-byte
//   k slice of the A tile and of the W tile (64 k of bf16, 128 k of int8),
//   brought by TMA tensor copies in the 128-byte swizzle (tensor maps over
//   the whole stacks, encoded on the host) and completing on the slot's
//   mbarrier. Thread 0 issues every copy. Rows past R and columns past K
//   arrive as zeros; rows past R are never stored. SwiGLU tiles take bn/2
//   h1 rows and the bn/2 matching h2 rows (two boxes), so one thread holds
//   both halves of an output column.
// - Packed int4 (kOpS4): a weight slice of 128 packed bytes a row holds
//   k = j (low nibble) and k = K/2 + j (high nibble), 256 k a stage, so the
//   stage takes two boxes of the activations' map, [j0, j0 + 128) and
//   [K/2 + j0, ...). The packed slice lands on the stage's high weight plane;
//   a third warpgroup unpacks it in place, each 16 bytes into the same
//   swizzled offset of the low plane (the low nibbles, sign-extended) and of
//   the high plane, one stage ahead of the consumer warpgroups, which then
//   run plain shared-memory wgmmas on (A low, W low) and (A high, W high)
//   with no integer work between them. A last stage that is half (K/2 % 128
//   == 64) reads zero weight bytes past K/2, which unpack to 0.
// - Split-K: grid (splits, ceil(R / bm), N / bn), the row tiles that share
//   a weight tile adjacent so that they run together and the second read of
//   the tile comes from L2 (at 256 rows the 14B head's qkv and w1 take 240
//   tiles, two waves); split s walks k stages
//   [s KT / S, (s + 1) KT / S). ops/fused_head.py::head_gemm_plan picks S, a
//   power of two up to 8, so that the tiles fill one wave of the SMs and
//   every split walks two stages or more (H-1x: w1 30 tiles x 4, w2 10 x 8;
//   the 14B head's wo and w2 at 128 rows 40 x 2; 3 splits, clusters of 3,
//   were slower there than 2 or 4).
//   The S blocks of a tile form one thread block cluster: each stages its
//   tile (fp32, or int32 sums) in its shared memory; after a cluster barrier
//   each copies rows [d bm / S, (d + 1) bm / S) of it into block d's receive
//   area (one bulk copy per block, completing on d's mbarrier), and block d
//   sums its rows over the S tiles in split order 0..S-1 and finishes them,
//   so the bits do not depend on the timing and no partial goes through
//   device memory (reading the other tiles through distributed shared memory
//   instead cost 2-3 us a product on the card). Writing the split tiles to
//   device memory for a second, merging launch was slower too, and is not
//   kept. The integer routes sum int32 partials and dequantize after the
//   sum, so their outputs are the same bits at every split count.
// - PDL: the kernel issues the weight tiles of its first ring stages and
//   only then waits for the kernel ahead (griddepcontrol) before it loads A:
//   the weights never depend on it. It lets its own dependents launch when
//   its main loop is done, so that they start while it finishes its tile.
//   Letting them launch at its start (or once its last stage's copies were
//   issued) kept the 14B head's LN and attention blocks resident through
//   its long main loops: a net call 0.12 (0.09) ms slower device-only than
//   with the launch after the main loop, and slower than no PDL at all; the
//   ImageNet heads' times did not change (PERF.md §6).
//   Bringing the next head block's weight tiles into L2 as well (TMA
//   prefetch) was slower on the card (H-1x 0.242 against 0.235 ms a net
//   call, B-16x 0.519 against 0.449), and is not done.
// - Epilogues: kBiasBf16 (qkv); on the round route, where every elementwise
//   op rounds to bf16 as _block_body's, kGatedResidualRound (wo, w2; the
//   residual h in place) and kSwiGLURound (w1; on the integer kinds
//   kSwiGLURoundQ, its silu IEEE as kSwiGLUQ's); on #2's, which keeps the
//   residual in fp32, kGatedResidual and kSwiGLU, and on #2's quant modes
//   kSwiGLUQ (fp32 silu(bf16 h1) * bf16 h2, the input of the w2 row
//   quantization); #14's kSwiGLUF32 (h1 and h2 kept in fp32, the product
//   rounded once) and kGatedResidualBf16 (bf16(x + y * gate) from bf16 rows
//   of x into a new output; #15's wo too); #15's kBiasF32 (qkv kept in
//   fp32: the sums plus the bias); #5's kOutF32 (the fp32 sums, no bias); the
//   tensor-parallel head's kOutS32 (an integer kind's int32 sums as they are,
//   split partials summed in split order, no scale: a row-parallel product
//   all-reduces them before it dequantizes). The
//   integer routes first dequantize y = float(acc) * (sa[row] * ws[col]), in
//   the plain version's order. The accumulators are staged through shared
//   memory and each thread finishes 8 consecutive columns of a row with
//   16-byte loads and stores, the loads of up to 4 such units issued before
//   the sums are ready. The bf16 SwiGLUs' silu divides with __fdividef: an
//   IEEE division took ~2 us of a w1 tile's epilogue; kSwiGLUQ's fp32 output
//   takes the IEEE division and expf, and every rounding step of the integer
//   routes is written with __fmul_rn / __fadd_rn, so that each product is
//   bit-equal to its plain twin.
// - No instruction but a wgmma writes the accumulators (the first wgmma of
//   a block has scale-d 0): ptxas would serialize every wgmma (C7515).
#pragma once

#include <cooperative_groups.h>
#include <cudaTypedefs.h>

#include <mutex>
#include <type_traits>

#include "head_blocks.cuh"

namespace {  // every source that includes this header has its own kernels
namespace hg {

namespace cg = cooperative_groups;
using ::wgmma_ss;  // the bf16 overloads (common.cuh) beside the int8 one below

constexpr int kBK = 64;        // k of one bf16 stage: one 128-byte swizzle row
constexpr int kMaxSplits = 8;  // a split's blocks form one cluster (portable size)

// The operands of a product: bf16 A and W; int8 rows (row scales) and int8
// weights (column scales); int8 rows and packed int4 weights [N, K/2]
enum GemmKind { kOpBf16 = 0, kOpS8 = 1, kOpS4 = 2 };

// Plan of one product (ops/fused_head.py::head_gemm_plan): rows and columns
// of an output tile, and the split count (1, 2, 4 or 8).
struct Plan {
  int bm, bn, splits;
};

template <int KIND, int NWG, int BN>
struct Geom {
  static constexpr bool kUnpack = KIND == kOpS4;  // a third warpgroup unpacks the nibbles
  static constexpr int kConsumers = 128 * NWG;
  static constexpr int kThreads = kConsumers + (kUnpack ? 128 : 0);
  static constexpr int kRows = 64 * NWG;
  static constexpr int kPlanes = kUnpack ? 2 : 1;  // k = j and k = K/2 + j
  static constexpr int kA = kPlanes * kRows * 128;  // bytes of the A slices of a stage
  static constexpr int kW = kPlanes * BN * 128;     // bytes of the W slices
  static constexpr int kStage = kA + kW;            // a multiple of 1024
  static constexpr int kTx = kA + BN * 128;         // bytes the copies of a stage bring
  static constexpr int kRingBytes = (kUnpack ? 192 : 190) * 1024;
  static constexpr int kRing = kRingBytes / kStage < 7 ? kRingBytes / kStage : 7;
  // one warpgroup keeps no wgmma in flight across a stage (the products are
  // bound by bytes at 64 rows) and so refills the slot it just read; two
  // keep one group in flight, except under the unpacking warpgroup, which
  // holds the stage after the consumers' (three slots of 64 KB at bm 128;
  // 64-byte packed stages, six slots of 32 KB, with or without a group in
  // flight, made a net call 12% slower: PERF.md §6, PR 14)
  static constexpr int kLag = NWG == 1 || kUnpack ? 0 : 1;
  static constexpr int kAhead = kRing - 1 - kLag;
  static constexpr int kLdt = BN + 8;     // staged tile row (4-byte words): conflict-free
  static constexpr int kBytes = kRing * kStage + 8 * (kRing + 1) + 1024;
  // the staged tile and the receive area of a split's rows
  static_assert(2 * kRows * kLdt * 4 <= kRing * kStage, "the tile and receive area fit");
  static_assert(!kUnpack || kRing >= 3, "the unpacking warpgroup works one stage ahead");
};

// The accumulator of a kind: fp32 sums of bf16 products, exact int32 sums
template <int KIND>
using Acc = std::conditional_t<KIND == kOpBf16, float, int>;

// Columns of a stage's 128-byte box in each kind: 64 bf16 or 128 int8 (packed)
template <int KIND>
constexpr int kBoxCols = KIND == kOpBf16 ? 64 : 128;

// Stages of 128 bytes over a weight row of K (logical) columns
__host__ __device__ constexpr int stages_of(int kind, int K) {
  return kind == kOpBf16 ? K / kBK : kind == kOpS8 ? (K + 127) / 128 : (K / 2 + 127) / 128;
}

// D[64 x 128] (+)= A[64 x 32] x B[32 x 128], both int8 and K-major in
// shared memory (descriptors), exact int32 sums; scale_d = 0 overwrites D
__device__ __forceinline__ void wgmma_ss(int (&d)[16][4], uint64_t desc_a, uint64_t desc_b,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n}\n"
      : "+r"(d[0][0]), "+r"(d[0][1]), "+r"(d[0][2]), "+r"(d[0][3]),
        "+r"(d[1][0]), "+r"(d[1][1]), "+r"(d[1][2]), "+r"(d[1][3]),
        "+r"(d[2][0]), "+r"(d[2][1]), "+r"(d[2][2]), "+r"(d[2][3]),
        "+r"(d[3][0]), "+r"(d[3][1]), "+r"(d[3][2]), "+r"(d[3][3]),
        "+r"(d[4][0]), "+r"(d[4][1]), "+r"(d[4][2]), "+r"(d[4][3]),
        "+r"(d[5][0]), "+r"(d[5][1]), "+r"(d[5][2]), "+r"(d[5][3]),
        "+r"(d[6][0]), "+r"(d[6][1]), "+r"(d[6][2]), "+r"(d[6][3]),
        "+r"(d[7][0]), "+r"(d[7][1]), "+r"(d[7][2]), "+r"(d[7][3]),
        "+r"(d[8][0]), "+r"(d[8][1]), "+r"(d[8][2]), "+r"(d[8][3]),
        "+r"(d[9][0]), "+r"(d[9][1]), "+r"(d[9][2]), "+r"(d[9][3]),
        "+r"(d[10][0]), "+r"(d[10][1]), "+r"(d[10][2]), "+r"(d[10][3]),
        "+r"(d[11][0]), "+r"(d[11][1]), "+r"(d[11][2]), "+r"(d[11][3]),
        "+r"(d[12][0]), "+r"(d[12][1]), "+r"(d[12][2]), "+r"(d[12][3]),
        "+r"(d[13][0]), "+r"(d[13][1]), "+r"(d[13][2]), "+r"(d[13][3]),
        "+r"(d[14][0]), "+r"(d[14][1]), "+r"(d[14][2]), "+r"(d[14][3]),
        "+r"(d[15][0]), "+r"(d[15][1]), "+r"(d[15][2]), "+r"(d[15][3])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// four packed bytes -> their low / high nibbles, each sign-extended to int8
__device__ __forceinline__ uint32_t nibbles_lo(uint32_t w) {
  return __vsub4((w & 0x0F0F0F0Fu) ^ 0x08080808u, 0x08080808u);
}
__device__ __forceinline__ uint32_t nibbles_hi(uint32_t w) {
  return __vsub4(((w >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u, 0x08080808u);
}

__device__ __forceinline__ void add8(const float* p, float (&v)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] += a.x, v[1] += a.y, v[2] += a.z, v[3] += a.w;
  v[4] += b.x, v[5] += b.y, v[6] += b.z, v[7] += b.w;
}
__device__ __forceinline__ void add8(const int* p, int (&v)[8]) {
  const int4 a = *reinterpret_cast<const int4*>(p);
  const int4 b = *reinterpret_cast<const int4*>(p + 4);
  v[0] += a.x, v[1] += a.y, v[2] += a.z, v[3] += a.w;
  v[4] += b.x, v[5] += b.y, v[6] += b.z, v[7] += b.w;
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(int* p, int a, int b) {
  *reinterpret_cast<int2*>(p) = make_int2(a, b);
}

// What the epilogue of one unit (a row, 8 consecutive output columns)
// reads besides the sums, loaded ahead of them so that a thread's loads
// are in flight together
struct UnitIn {
  uint4 b, b2, g, x;       // bias (SwiGLU: h1's, b2 h2's), gate, kGatedResidualBf16's x
  float4 r0, r1;           // residual
  float4 s0, s1, t0, t1;   // the integer routes' column scales (SwiGLU: t h2's)
  float sa;                // and the row's scale
};

template <int MODE, int KIND>
__device__ __forceinline__ void load_unit(UnitIn& in, int row, int col,
                                          const bf16* __restrict__ bias,
                                          const float* __restrict__ resid, int ldr,
                                          const bf16* __restrict__ gate, int ldg,
                                          const bf16* __restrict__ xres, int ldx, int hidden,
                                          const float* __restrict__ sa,
                                          const float* __restrict__ ws) {
  if (MODE == kOutS32) return;  // the raw sums: nothing else is read
  if (MODE != kOutF32) in.b = *reinterpret_cast<const uint4*>(bias + col);
  if (is_swiglu(MODE)) in.b2 = *reinterpret_cast<const uint4*>(bias + hidden + col);
  if (is_gated(MODE) || MODE == kGatedResidualBf16)
    in.g = *reinterpret_cast<const uint4*>(gate + (size_t)row * ldg + col);
  if (is_gated(MODE)) {
    const float4* r = reinterpret_cast<const float4*>(resid + (size_t)row * ldr + col);
    in.r0 = r[0];
    in.r1 = r[1];
  }
  if (MODE == kGatedResidualBf16)
    in.x = *reinterpret_cast<const uint4*>(xres + (size_t)row * ldx + col);
  if (KIND != kOpBf16) {
    in.sa = sa[row];
    const float4* s = reinterpret_cast<const float4*>(ws + col);
    in.s0 = s[0];
    in.s1 = s[1];
    if (is_swiglu(MODE)) {
      const float4* t = reinterpret_cast<const float4*>(ws + hidden + col);
      in.t0 = t[0];
      in.t1 = t[1];
    }
  }
}

// The sums of 8 columns as floats: the bf16 route's fp32 sums as they are;
// the integer routes' int32 sums dequantized as the plain version does,
// float(acc) * (sa * ws)
template <int KIND>
__device__ __forceinline__ void dequant8(const Acc<KIND> (&v)[8], float sa, const float4& s0,
                                         const float4& s1, float (&f)[8]) {
  if constexpr (KIND == kOpBf16) {
#pragma unroll
    for (int i = 0; i < 8; ++i) f[i] = v[i];
  } else {
    const float s[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
#pragma unroll
    for (int i = 0; i < 8; ++i) f[i] = __fmul_rn(static_cast<float>(v[i]), __fmul_rn(sa, s[i]));
  }
}

// Finishes output row `row` (< R), 8 consecutive columns from `col` (an
// output column: of N, or of the SwiGLU's N / 2 = hidden), from the product
// sums v (SwiGLU: v the h1 sums, v2 the h2 sums of the same columns). The
// round modes round every elementwise op to bf16 as _block_body's; kernel
// #2's keep the residual in fp32 and round only h1, h2 and the bf16
// SwiGLU's output, with the products and sums in torch's order (the plain
// twin's); #14's keep h1, h2 and y in fp32 and round only their output.
// kSwiGLUQ, kOutF32 and kBiasF32 write fp32 (out holds floats, ldo of them).
template <int MODE>
__device__ __forceinline__ void finish8(int row, int col, const float (&v)[8],
                                        const float (&v2)[8], const UnitIn& in,
                                        bf16* __restrict__ out, int ldo,
                                        float* __restrict__ resid, int ldr) {
  float b[8], o[8];
  unpack8(in.b, b);
  if (is_swiglu(MODE)) {
    float b2[8];
    unpack8(in.b2, b2);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float y1 = __fadd_rn(v[i], b[i]), y2 = __fadd_rn(v2[i], b2[i]);
      if (MODE != kSwiGLUF32) y1 = round_bf16(y1), y2 = round_bf16(y2);
      if (MODE == kSwiGLUQ || MODE == kSwiGLURoundQ) {  // torch's silu: x / (1 + exp(-x)), IEEE
        const float s = __fdiv_rn(y1, __fadd_rn(1.f, expf(-y1)));
        o[i] = __fmul_rn(MODE == kSwiGLURoundQ ? round_bf16(s) : s, y2);
      } else {
        const float s = __fdividef(y1, 1.f + __expf(-y1));
        o[i] = (MODE == kSwiGLURound ? round_bf16(s) : s) * y2;
      }
    }
    if (MODE == kSwiGLUQ) {
      float4* dst = reinterpret_cast<float4*>(reinterpret_cast<float*>(out) + (size_t)row * ldo + col);
      dst[0] = make_float4(o[0], o[1], o[2], o[3]);
      dst[1] = make_float4(o[4], o[5], o[6], o[7]);
    } else {
      *reinterpret_cast<uint4*>(out + (size_t)row * ldo + col) = pack8(o);
    }
  } else if (MODE == kBiasBf16) {
#pragma unroll
    for (int i = 0; i < 8; ++i) o[i] = __fadd_rn(v[i], b[i]);
    *reinterpret_cast<uint4*>(out + (size_t)row * ldo + col) = pack8(o);
  } else if (MODE == kOutF32 || MODE == kBiasF32) {
#pragma unroll
    for (int i = 0; i < 8; ++i) o[i] = MODE == kBiasF32 ? __fadd_rn(v[i], b[i]) : v[i];
    float4* dst =
        reinterpret_cast<float4*>(reinterpret_cast<float*>(out) + (size_t)row * ldo + col);
    dst[0] = make_float4(o[0], o[1], o[2], o[3]);
    dst[1] = make_float4(o[4], o[5], o[6], o[7]);
  } else if (MODE == kGatedResidualBf16) {
    float g[8], x[8];
    unpack8(in.g, g);
    unpack8(in.x, x);
#pragma unroll
    for (int i = 0; i < 8; ++i) o[i] = __fadd_rn(x[i], __fmul_rn(__fadd_rn(v[i], b[i]), g[i]));
    *reinterpret_cast<uint4*>(out + (size_t)row * ldo + col) = pack8(o);
  } else {  // kGatedResidualRound, kGatedResidual
    float g[8];
    unpack8(in.g, g);
    const float h[8] = {in.r0.x, in.r0.y, in.r0.z, in.r0.w, in.r1.x, in.r1.y, in.r1.z, in.r1.w};
#pragma unroll
    for (int i = 0; i < 8; ++i)
      o[i] = MODE == kGatedResidualRound
                 ? round_bf16(h[i] + round_bf16(round_bf16(v[i] + b[i]) * g[i]))
                 : __fadd_rn(h[i], __fmul_rn(__fadd_rn(v[i], b[i]), g[i]));
    float4* r = reinterpret_cast<float4*>(resid + (size_t)row * ldr + col);
    r[0] = make_float4(o[0], o[1], o[2], o[3]);
    r[1] = make_float4(o[4], o[5], o[6], o[7]);
  }
}

// The epilogue of `units` units (unit u: tile row r0 + u / (out columns /
// 8), its 8-column group u % that) over kThreads threads, thread t taking
// units t, t + kThreads, ..., kChunk at a time with their loads issued
// first. The first chunk's loads go out before ready() (called by every
// thread), so that they overlap what ready() waits for. get(r, c, v) sets v
// to the sums of tile row r, tile columns c..c+7.
template <int MODE, int KIND, int NWG, int BN, typename Ready, typename Get>
__device__ __forceinline__ void finish_rows(Ready ready, Get get, int r0, int units, int m0,
                                            int n0, int R, int tid,
                                            const bf16* __restrict__ bias,
                                            bf16* __restrict__ out, int ldo,
                                            float* __restrict__ resid, int ldr,
                                            const bf16* __restrict__ gate, int ldg,
                                            const bf16* __restrict__ xres, int ldx, int hidden,
                                            const float* __restrict__ sa,
                                            const float* __restrict__ ws) {
  constexpr bool kGlu = is_swiglu(MODE);
  constexpr int kGroups = (kGlu ? BN / 2 : BN) / 8;  // 8-column groups of a row
  constexpr int kT = Geom<KIND, NWG, BN>::kThreads, kChunk = KIND == kOpBf16 ? 4 : 2;
  UnitIn in[kChunk];
  auto load = [&](int base) {
#pragma unroll
    for (int i = 0; i < kChunk; ++i) {
      const int u = base + i * kT, r = r0 + u / kGroups, c = (u % kGroups) * 8;
      if (u < units && m0 + r < R)
        load_unit<MODE, KIND>(in[i], m0 + r, (kGlu ? n0 / 2 : n0) + c, bias, resid, ldr, gate,
                              ldg, xres, ldx, hidden, sa, ws);
    }
  };
  load(tid);
  ready();
  for (int base = tid; base < units; base += kT * kChunk) {
    if (base != tid) load(base);
#pragma unroll
    for (int i = 0; i < kChunk; ++i) {
      const int u = base + i * kT, r = r0 + u / kGroups, c = (u % kGroups) * 8;
      if (u >= units || m0 + r >= R) continue;
      Acc<KIND> v[8], v2[8];
      float f[8], f2[8];
      get(r, c, v);
      if constexpr (MODE == kOutS32) {
        static_assert(KIND != kOpBf16, "kOutS32 is an integer kind's mode");
        int4* dst = reinterpret_cast<int4*>(reinterpret_cast<int*>(out) + (size_t)(m0 + r) * ldo +
                                            n0 + c);
        dst[0] = make_int4(v[0], v[1], v[2], v[3]);
        dst[1] = make_int4(v[4], v[5], v[6], v[7]);
        continue;
      }
      dequant8<KIND>(v, in[i].sa, in[i].s0, in[i].s1, f);
      if (kGlu) {
        get(r, BN / 2 + c, v2);
        dequant8<KIND>(v2, in[i].sa, in[i].t0, in[i].t1, f2);
      }
      finish8<MODE>(m0 + r, (kGlu ? n0 / 2 : n0) + c, f, f2, in[i], out, ldo, resid, ldr);
    }
  }
}

// mapa: the address of the same shared memory location in block `rank` of
// the cluster, and a bulk copy from this block's shared memory into
// another's that completes on that block's mbarrier
__device__ __forceinline__ uint32_t cluster_addr(uint32_t addr, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}
__device__ __forceinline__ void bulk_s2s(uint32_t dst, uint32_t src, int bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];\n" ::"r"(dst),
      "r"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// grid (splits, ceil(R / (64 NWG)), N / BN), clusters of (splits, 1, 1),
// Geom::kThreads threads. a_map: A [R, K] (bf16 or int8), boxes of 128
// bytes x 64 NWG rows; w_map: the weight stack [rows, K] (bf16 or int8;
// packed int4 [rows, K/2]), boxes of 128 bytes x BN rows (SwiGLU: BN / 2),
// this product's rows from w_row0 (SwiGLU: h1 from w_row0, h2 from w_row0 +
// hidden). K is the logical contraction length. Split s (the block's rank in
// its cluster) walks k stages [s KT / S, (s + 1) KT / S); the cluster's
// blocks then sum each other's staged tiles in split order, each for 1 / S
// of the tile's rows, and finish them. The integer kinds dequantize with the
// row scales sa [R] and the column scales ws (indexed as bias).
template <int MODE, int KIND, int NWG, int BN>
__global__ void __launch_bounds__(Geom<KIND, NWG, BN>::kThreads, 1)
head_gemm_kernel(const __grid_constant__ CUtensorMap a_map,
                 const __grid_constant__ CUtensorMap w_map, int w_row0, int R, int K,
                 const bf16* __restrict__ bias, bf16* __restrict__ out, int ldo,
                 float* __restrict__ resid, int ldr, const bf16* __restrict__ gate, int ldg,
                 const bf16* __restrict__ xres, int ldx, int hidden,
                 const float* __restrict__ sa, const float* __restrict__ ws) {
  using G = Geom<KIND, NWG, BN>;
  using T = Acc<KIND>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // the same offset in every block of a cluster: the staged tiles line up
  unsigned char* const smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* const full = reinterpret_cast<uint64_t*>(smem + G::kRing * G::kStage);

  const int tid = threadIdx.x, wg = tid >> 7;
  const int splits = gridDim.x, split = blockIdx.x;
  const int m0 = blockIdx.y * G::kRows, n0 = blockIdx.z * BN;
  const int kt = stages_of(KIND, K), ka = split * kt / splits,
            steps = (split + 1) * kt / splits - ka;
  if (tid == 0) {
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&w_map))
                 : "memory");
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&a_map))
                 : "memory");
#pragma unroll
    for (int i = 0; i <= G::kRing; ++i) mbar_init(smem_u32(full + i), 1);  // + receive
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // a stage's slot: A planes [kPlanes][kRows][128 B], then W planes
  // [kPlanes][BN][128 B]; a packed int4 slice lands on the high W plane
  auto load_w = [&](int s) {  // weight slice of step s, and the slot's byte count
    const int slot = s % G::kRing;
    const uint32_t ws_ = smem_u32(smem + slot * G::kStage + G::kA + (G::kPlanes - 1) * BN * 128),
                   bar = smem_u32(full + slot);
    const int c0 = (ka + s) * kBoxCols<KIND>;
    mbar_expect_tx(bar, G::kTx);
    if (is_swiglu(MODE)) {
      tma_2d(ws_, &w_map, c0, w_row0 + n0 / 2, bar);
      tma_2d(ws_ + BN * 64, &w_map, c0, w_row0 + hidden + n0 / 2, bar);
    } else {
      tma_2d(ws_, &w_map, c0, w_row0 + n0, bar);
    }
  };
  auto load_a = [&](int s) {
    const int slot = s % G::kRing;
    const uint32_t as = smem_u32(smem + slot * G::kStage), bar = smem_u32(full + slot);
    const int c0 = (ka + s) * kBoxCols<KIND>;
    tma_2d(as, &a_map, c0, m0, bar);
    if (G::kUnpack) tma_2d(as + G::kRows * 128, &a_map, K / 2 + c0, m0, bar);
  };
  // the unpacking warpgroup: the packed slice of step s (on the high plane)
  // into the low plane's nibbles and, in place, the high plane's
  auto unpack = [&](int s) {
    const int slot = s % G::kRing;
    mbar_wait(smem_u32(full + slot), (s / G::kRing) & 1);
    uint4* const lo = reinterpret_cast<uint4*>(smem + slot * G::kStage + G::kA);
    uint4* const hi = lo + BN * 8;
#pragma unroll
    for (int u = tid - G::kConsumers; u < BN * 8; u += 128) {
      const uint4 v = hi[u];
      lo[u] = make_uint4(nibbles_lo(v.x), nibbles_lo(v.y), nibbles_lo(v.z), nibbles_lo(v.w));
      hi[u] = make_uint4(nibbles_hi(v.x), nibbles_hi(v.y), nibbles_hi(v.z), nibbles_hi(v.w));
    }
    fence_async_shared();  // the planes are visible to the consumers' wgmmas
  };
  const int pre = min(G::kAhead, steps);
  if (tid == 0)
    for (int s = 0; s < pre; ++s) load_w(s);  // weights never depend on the kernel ahead
  pdl_wait();
  if (tid == 0)
    for (int s = 0; s < pre; ++s) load_a(s);
  const bool consumer = !G::kUnpack || wg < NWG;  // known at compile time without the unpacker
  if (!consumer && steps > 0) unpack(0);

  T acc[BN / 8][4];
  for (int j = 0; j < steps; ++j) {
    // every thread has waited for the wgmmas of step j - 1 - kLag, whose
    // slot takes step j + kAhead (and the unpacking warpgroup has finished
    // step j)
    __syncthreads();
    if (tid == 0 && j + G::kAhead < steps) {
      load_w(j + G::kAhead);
      load_a(j + G::kAhead);
    }
    const int slot = j % G::kRing;
    if (consumer) {
      mbar_wait(smem_u32(full + slot), (j / G::kRing) & 1);
      wgmma_fence();
#pragma unroll
      for (int p = 0; p < G::kPlanes; ++p) {
        const uint32_t a_addr =
            smem_u32(smem + slot * G::kStage) + p * G::kRows * 128 + wg * 64 * 128;
        const uint32_t w_addr = smem_u32(smem + slot * G::kStage + G::kA) + p * BN * 128;
        // 32 bytes a k step: 16 bf16 or 32 int8
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss(acc, gmma_desc(a_addr + kk * 32, 16, 1024),
                   gmma_desc(w_addr + kk * 32, 16, 1024), j > 0 || p > 0 || kk > 0);
      }
      wgmma_commit();
      wgmma_wait<G::kLag>();
    } else if (j + 1 < steps) {
      unpack(j + 1);
    }
  }
  if (consumer) wgmma_wait<0>();
  pdl_trigger();    // the next kernel waits for this one before it reads h or act
  __syncthreads();  // the ring is free for the staged tile

  // the accumulators staged as the tile [kRows][kLdt] (wgmma's C layout:
  // warp w's rows 16 w + g and + 8, columns 8 j + 2 t, + 1)
  T* const tile = reinterpret_cast<T*>(smem);
  if (consumer) {
    const int warp = (tid >> 5) & 3, lane = tid & 31;
    const int r = wg * 64 + warp * 16 + (lane >> 2), c = 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      store2(tile + r * G::kLdt + 8 * j + c, acc[j][0], acc[j][1]);
      store2(tile + (r + 8) * G::kLdt + 8 * j + c, acc[j][2], acc[j][3]);
    }
  }
  constexpr int kGroups = (is_swiglu(MODE) ? BN / 2 : BN) / 8;
  if (splits == 1) {
    finish_rows<MODE, KIND, NWG, BN>(
        [] { __syncthreads(); },
        [&](int r, int c, T(&v)[8]) {
#pragma unroll
          for (int i = 0; i < 8; ++i) v[i] = 0;
          add8(tile + r * G::kLdt + c, v);
        },
        0, G::kRows * kGroups, m0, n0, R, tid, bias, out, ldo, resid, ldr, gate, ldg, xres, ldx,
        hidden, sa, ws);
    return;
  }
  // Block s finishes rows [s kRows / S, (s + 1) kRows / S) of the tile: every
  // other block of the cluster copies those rows of its staged tile into
  // slot (its rank) of this block's receive area (bulk copies, completing on
  // this block's mbarrier), and the slices are summed in split order.
  cg::cluster_group cluster = cg::this_cluster();
  const int rows = G::kRows / splits;
  const int slice = rows * G::kLdt;  // words
  T* const recv = tile + G::kRows * G::kLdt;
  const uint32_t rbar = smem_u32(full + G::kRing);
  if (tid == 0) mbar_expect_tx(rbar, (splits - 1) * slice * 4);
  fence_async_shared();  // the staged tile is visible to the bulk copies
  cluster.sync();        // every tile staged, every ring free, every count set
  if (tid == 0)
    for (int d = 0; d < splits; ++d)
      if (d != split)
        bulk_s2s(cluster_addr(smem_u32(recv + split * slice), d), smem_u32(tile + d * slice),
                 slice * 4, cluster_addr(rbar, d));
  finish_rows<MODE, KIND, NWG, BN>(
      [&] { mbar_wait(rbar, 0); },
      [&](int r, int c, T(&v)[8]) {
        const int rr = r - split * rows;
#pragma unroll
        for (int i = 0; i < 8; ++i) v[i] = 0;
        for (int s = 0; s < splits; ++s)
          add8((s == split ? tile + r * G::kLdt : recv + s * slice + rr * G::kLdt) + c, v);
      },
      split * rows, rows * kGroups, m0, n0, R, tid, bias, out, ldo, resid, ldr, gate, ldg, xres,
      ldx, hidden, sa, ws);
  cluster.sync();  // every copy has landed: no block leaves while one reads its tile
}

// Launches kernel on `st`, programmatic (it may start before the kernel
// ahead of it finishes; it waits with pdl_wait) when pdl, in clusters of
// (cluster, 1, 1) blocks when cluster > 1.
template <typename... Params, typename... Args>
cudaError_t launch_clusters(bool pdl, int cluster, dim3 grid, int threads, size_t smem,
                            cudaStream_t st, void (*kernel)(Params...), Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[2];
  int n = 0;
  if (pdl) {
    attr[n].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[n++].val.programmaticStreamSerializationAllowed = 1;
  }
  if (cluster > 1) {
    attr[n].id = cudaLaunchAttributeClusterDimension;
    attr[n++].val.clusterDim = {static_cast<unsigned>(cluster), 1, 1};
  }
  cfg.attrs = attr;
  cfg.numAttrs = n;
  return cudaLaunchKernelEx(&cfg, kernel, static_cast<Params>(args)...);
}

template <typename... Params, typename... Args>
cudaError_t launch(bool pdl, dim3 grid, int threads, size_t smem, cudaStream_t st,
                   void (*kernel)(Params...), Args... args) {
  return launch_clusters(pdl, 1, grid, threads, smem, st, kernel, args...);
}

// The tensor map of a matrix [rows, cols] (row stride cols) of bf16 or
// bytes in boxes of 128 bytes x box_rows rows, 128-byte swizzle;
// out-of-range rows and columns read 0. False if cuTensorMapEncodeTiled is
// not found or refuses the shape.
inline bool tile_map(bool bytes, const void* ptr, int rows, int cols, int box_rows,
                     CUtensorMap* out) {
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
  const int elem = bytes ? 1 : 2;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * elem};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(128 / elem),
                             static_cast<cuuint32_t>(box_rows)},
                   unit[2] = {1, 1};
  return encode(out, bytes ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                const_cast<void*>(ptr), dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// tile_map through a cache keyed by every argument: a map holds nothing
// else, so a hit is the map a fresh encode would give. The weight stacks and
// the wrappers' scratch (whose addresses PyTorch's caching allocator hands
// out again call after call) hit, so a per-call kernel (#14, #5) encodes no
// map in the steady state. One entry per hashed key, replaced on a miss.
constexpr int kMapCache = 512;

inline bool cached_map(bool bytes, const void* ptr, int rows, int cols, int box_rows,
                       CUtensorMap* out) {
  struct Entry {
    CUtensorMap map;
    const void* ptr;
    int rows, cols, box_rows;
    bool bytes;
  };
  static Entry cache[kMapCache];
  static std::mutex mu;
  const uintptr_t p = reinterpret_cast<uintptr_t>(ptr);
  const size_t slot = ((p >> 4) ^ (p >> 17) ^ static_cast<size_t>(rows) * 40503u ^
                       static_cast<size_t>(cols) * 131u ^ static_cast<size_t>(box_rows)) %
                      kMapCache;
  std::lock_guard<std::mutex> lock(mu);
  Entry& e = cache[slot];
  if (e.ptr != ptr || e.rows != rows || e.cols != cols || e.box_rows != box_rows ||
      e.bytes != bytes) {
    e.ptr = nullptr;
    if (!tile_map(bytes, ptr, rows, cols, box_rows, &e.map)) return false;
    e.ptr = ptr, e.rows = rows, e.cols = cols, e.box_rows = box_rows, e.bytes = bytes;
  }
  *out = e.map;
  return true;
}

// One product's operands: the tensor maps of A [R, K] and of the weight
// stack [w_rows, K] (packed: [w_rows, K/2]) for a plan; N out-features a
// block, K the logical contraction length.
struct Product {
  CUtensorMap a_map, w_map;
  int R, N, K;
};

// The tensor maps of a product of `kind` with N out-features (SwiGLU: 2
// hidden) on a weight stack of w_rows rows; false if the plan does not fit
// the shape (bf16: K % 64 == 0; int8 and packed int4: K % 128 == 0, a packed
// last stage may be half).
inline bool make_product(int kind, const void* A, int R, int K, const void* W, int w_rows, int N,
                         bool swiglu, const Plan& p, Product* out) {
  const bool k_ok = kind == kOpBf16 ? K % kBK == 0 : K % 128 == 0;
  const bool splits_ok = (p.splits & (p.splits - 1)) == 0 && p.splits >= 1 &&
                         p.splits <= kMaxSplits && k_ok && p.splits <= stages_of(kind, K);
  const bool shape_ok = (p.bm == 64 || p.bm == 128) && p.bn == 128 && R > 0 && K > 0 &&
                        N % p.bn == 0 && splits_ok &&
                        reinterpret_cast<uintptr_t>(A) % 16 == 0 &&
                        reinterpret_cast<uintptr_t>(W) % 16 == 0;
  if (!shape_ok) return false;
  out->R = R;
  out->N = N;
  out->K = K;
  const bool bytes = kind != kOpBf16;
  return cached_map(bytes, A, R, K, p.bm, &out->a_map) &&
         cached_map(bytes, W, w_rows, kind == kOpS4 ? K / 2 : K, swiglu ? p.bn / 2 : p.bn,
                    &out->w_map);
}

// MaxDynamicSharedMemorySize of head_gemm_kernel<MODE, KIND, NWG, BN>, once
// per device
template <int MODE, int KIND, int NWG, int BN>
cudaError_t allow_smem() {
  static unsigned done = 0;  // bit per device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < 32 && (done >> dev & 1u))) return err;
  err = cudaFuncSetAttribute(head_gemm_kernel<MODE, KIND, NWG, BN>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             Geom<KIND, NWG, BN>::kBytes);
  if (err == cudaSuccess && dev < 32) done |= 1u << dev;
  return err;
}

template <int MODE, int KIND, int NWG, int BN>
cudaError_t run(const Product& pr, int w_row0, const Plan& p, const Epilogue& ep, bool pdl,
                cudaStream_t st) {
  using G = Geom<KIND, NWG, BN>;
  BD_CHECK_ERR((allow_smem<MODE, KIND, NWG, BN>()));
  const int n_tiles = pr.N / BN, m_tiles = (pr.R + G::kRows - 1) / G::kRows;
  return launch_clusters(pdl, p.splits, dim3(p.splits, m_tiles, n_tiles), G::kThreads,
                         G::kBytes, st, head_gemm_kernel<MODE, KIND, NWG, BN>, pr.a_map,
                         pr.w_map, w_row0, pr.R, pr.K, ep.bias, static_cast<bf16*>(ep.out),
                         ep.ldo, ep.resid, ep.ldr, ep.gate, ep.ldg, ep.x, ep.ldx, ep.hidden,
                         ep.sa, ep.ws);
}

// epilogue(A @ W^T) of one product by its plan, on weight rows from w_row0
// (SwiGLU: h1 from w_row0, h2 from w_row0 + hidden)
template <int MODE, int KIND = kOpBf16>
cudaError_t gemm(const Product& pr, int w_row0, const Plan& p, const Epilogue& ep, bool pdl,
                 cudaStream_t st) {
  if (p.bm == 64 && p.bn == 128) return run<MODE, KIND, 1, 128>(pr, w_row0, p, ep, pdl, st);
  if (p.bm == 128 && p.bn == 128) return run<MODE, KIND, 2, 128>(pr, w_row0, p, ep, pdl, st);
  return cudaErrorInvalidValue;
}

// One bf16 product of a C entry for checks and timings (ops/fused_head.py::
// head_gemm): a [R, K], w [N, K], bias [N] bf16; shape {R, N, K, ldg, mode,
// bm, bn, splits}. Modes: kBiasBf16 (out bf16 [R, N]); the gated residuals
// (resid fp32 [R, N] in place, gate bf16 rows ldg apart); the SwiGLUs (w
// rows [h1; h2], out bf16 [R, N / 2]); kGatedResidualBf16 (x bf16 [R, N]
// passed as resid, gate as above, out bf16 [R, N]); kOutF32 (out fp32 [R,
// N], bias unread); kBiasF32 (out fp32 [R, N]). False if the plan does not
// fit the shape.
inline bool single_product(const void* a, const void* w, const void* bias, void* out,
                           void* resid, const void* gate, const int* shape, Product* pr,
                           Plan* plan, Epilogue* ep) {
  const int R = shape[0], N = shape[1], K = shape[2], ldg = shape[3], mode = shape[4];
  *plan = {shape[5], shape[6], shape[7]};
  if (!make_product(kOpBf16, a, R, K, w, N, N, is_swiglu(mode), *plan, pr) || N % 16 != 0 ||
      ldg % 8 != 0)
    return false;
  *ep = Epilogue{};
  ep->bias = static_cast<const bf16*>(bias);
  ep->out = out;
  ep->ldo = is_swiglu(mode) ? N / 2 : N;
  ep->gate = static_cast<const bf16*>(gate);
  ep->ldg = ldg;
  ep->hidden = N / 2;
  if (mode == kGatedResidualBf16) {
    ep->x = static_cast<const bf16*>(resid);
    ep->ldx = N;
  } else {
    ep->resid = static_cast<float*>(resid);
    ep->ldr = N;
  }
  return true;
}

// head_block's launches on the head GEMM (#2, #3/#4 and #5): each
// product on head_gemm by its plan, over the tensor maps of the whole stacks
// (pr, plan: indexed by BlockProduct), programmatic when pdl, and each stage
// kernel programmatic when pdl_stages; gemm_q runs the quant mode's integer
// products. Kernel #2's quant route launches its stage kernels plain (they
// still let the next GEMM launch at their start): launched programmatic
// after the integer GEMM's main loop they made a net call 12-16% slower
// device-only (PERF.md §6), where the bf16 routes and the round route's
// quant modes gain from it.
struct GemmLaunch {
  const Product* pr;
  const Plan* plan;
  bool pdl, pdl_stages;
  cudaStream_t st;

  template <typename... Params, typename... Args>
  cudaError_t stage(dim3 grid, int threads, size_t smem, void (*kernel)(Params...),
                    Args... args) const {
    return launch(pdl_stages, grid, threads, smem, st, kernel, args...);
  }

  template <int MODE>
  cudaError_t gemm(BlockProduct p, int w_row0, const Epilogue& ep) const {
    return hg::gemm<MODE>(pr[p], w_row0, plan[p], ep, pdl, st);
  }

  template <int MODE, int KIND>
  cudaError_t gemm_q(BlockProduct p, int w_row0, const Epilogue& ep) const {
    return hg::gemm<MODE, KIND>(pr[p], w_row0, plan[p], ep, pdl, st);
  }
};

}  // namespace hg
}  // namespace
