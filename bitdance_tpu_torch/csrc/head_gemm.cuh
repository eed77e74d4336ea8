// The head GEMM of the whole sampler's bf16 routes (fused_head.cu: kernel
// #2, the 14B head, and #3/#4, the ImageNet heads' round_residual route):
// epilogue(A[R, K] @ W[N, K]^T) in bf16 with fp32 accumulators on wgmma, fed
// by a TMA ring, split-K where the output tiles alone leave SMs idle, and
// every launch of the block chain programmatic (PDL) so that a product's
// weight tiles are in flight before the kernel ahead of it has finished;
// with head_block's launches on it (GemmLaunch).
//
// What bounds it on the H100: BitDance-H-1x runs 64 rows (32 images, CFG)
// through 12 blocks of w1 [3840, 1280] and w2 [1280, 1920]; each net call
// streams the 177 MB stack (3.5x the L2) for 11.3 GFLOP, ~64 FLOP a weight
// byte, far under the ~295 at which the tensor cores become the limit: 53 us
// of bytes a net call, ~1.5-3 us a product. BitDance-B-16x runs 1024 rows
// through 6 blocks (qkv [2304, 768], wo [768, 768], w1 [2304, 768], w2 [768,
// 1152]): 62 GFLOP a net call, bound by operations (62 us). The first
// design (gemm_bf16_kernel: mma.sync on 64x64 tiles, a cp.async ring walked
// by every thread) gave w2 at 64 rows 20 blocks on 132 SMs, each walking K
// serially, and left every launch waiting for the previous one to drain.
// The 14B head runs 128 rows (one image, CFG) or 256 through 6 blocks of qkv
// and w1 [15360, 5120], wo [5120, 5120] and w2 [5120, 7680]: 2.67 GB a net
// call, ~0.8 ms of bytes, with ~100 FLOP a weight byte.
//
// Design:
// - Orientation: the token rows are wgmma's M side, one consumer warpgroup
//   per 64 rows (bm 64, or 128 on two warpgroups when R > 64); the weights'
//   out-features are its N side (bn 128; 256 was slower). A (row-major,
//   K contiguous) and W (the torch Linear layout [out, in]) are then both
//   K-major in shared memory, which wgmma reads with no transpose.
// - Feeding: a ring of kRing stages (5-7, about 190 KB), each one 64-wide
//   k slice of the A tile and of the W tile, brought by TMA tensor copies in
//   the 128-byte swizzle (tensor maps encoded on the host) and completing on
//   the slot's mbarrier. Thread 0 issues every copy. Rows past R arrive as
//   zeros and are never stored. SwiGLU tiles take bn/2 h1 rows and the bn/2
//   matching h2 rows (two boxes), so one thread holds both halves of an
//   output column.
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
//   fp32 tile in its shared memory; after a cluster barrier each copies rows
//   [d bm / S, (d + 1) bm / S) of it into block d's receive area (one bulk
//   copy per block, completing on d's mbarrier), and block d sums its rows
//   over the S tiles in split order 0..S-1 and finishes them, so the bits
//   do not depend on the timing and no partial goes through device memory
//   (reading the other tiles through distributed shared memory instead cost
//   2-3 us a product on the card). Writing the split tiles to device
//   memory for a second, merging launch was slower too, and is not kept.
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
//   residual h in place) and kSwiGLURound (w1); on #2's, which keeps the
//   residual in fp32, kGatedResidual and kSwiGLU. The accumulators are staged through shared memory
//   and each thread finishes 8 consecutive columns of a row with 16-byte
//   loads and stores, the loads of up to 4 such units issued before the
//   sums are ready. The SwiGLU's silu divides with __fdividef: an IEEE
//   division took ~2 us of a w1 tile's epilogue.
// - No instruction but a wgmma writes the accumulators (the first wgmma of
//   a block has scale-d 0): ptxas would serialize every wgmma (C7515).
#pragma once

#include <cooperative_groups.h>
#include <cudaTypedefs.h>

#include "head_blocks.cuh"

namespace hg {

namespace cg = cooperative_groups;

constexpr int kBK = 64;        // k of one stage: one 128-byte swizzle row of bf16
constexpr int kMaxSplits = 8;  // a split's blocks form one cluster (portable size)

// Plan of one product (ops/fused_head.py::head_gemm_plan): rows and columns
// of an output tile, and the split count (1, 2, 4 or 8).
struct Plan {
  int bm, bn, splits;
};

template <int NWG, int BN>
struct Geom {
  static constexpr int kThreads = 128 * NWG;
  static constexpr int kRows = 64 * NWG;
  static constexpr int kA = kRows * 128;  // bytes of the A slice of a stage
  static constexpr int kW = BN * 128;     // bytes of the W slice
  static constexpr int kStage = kA + kW;  // a multiple of 1024
  static constexpr int kRing = 190 * 1024 / kStage < 7 ? 190 * 1024 / kStage : 7;
  // one warpgroup keeps no wgmma in flight across a stage (the products are
  // bound by bytes at 64 rows) and so refills the slot it just read; two
  // keep one group in flight
  static constexpr int kLag = NWG == 1 ? 0 : 1;
  static constexpr int kAhead = kRing - 1 - kLag;
  static constexpr int kLdt = BN + 8;     // staged tile row (floats): conflict-free
  static constexpr int kBytes = kRing * kStage + 8 * (kRing + 1) + 1024;
  // the staged tile and the receive area of a split's rows
  static_assert(2 * kRows * kLdt * 4 <= kRing * kStage, "the tile and receive area fit");
};

__device__ __forceinline__ void add8(const float* p, float (&v)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] += a.x, v[1] += a.y, v[2] += a.z, v[3] += a.w;
  v[4] += b.x, v[5] += b.y, v[6] += b.z, v[7] += b.w;
}

// What the epilogue of one unit (a row, 8 consecutive output columns)
// reads besides the sums, loaded ahead of them so that a thread's loads
// are in flight together
struct UnitIn {
  uint4 b, b2, g;  // bias (SwiGLU: h1's, b2 h2's), gate
  float4 r0, r1;   // residual
};

template <int MODE>
__device__ __forceinline__ void load_unit(UnitIn& in, int row, int col,
                                          const bf16* __restrict__ bias,
                                          const float* __restrict__ resid, int ldr,
                                          const bf16* __restrict__ gate, int ldg, int hidden) {
  in.b = *reinterpret_cast<const uint4*>(bias + col);
  if (is_swiglu(MODE)) in.b2 = *reinterpret_cast<const uint4*>(bias + hidden + col);
  if (is_gated(MODE)) {
    in.g = *reinterpret_cast<const uint4*>(gate + (size_t)row * ldg + col);
    const float4* r = reinterpret_cast<const float4*>(resid + (size_t)row * ldr + col);
    in.r0 = r[0];
    in.r1 = r[1];
  }
}

// Finishes output row `row` (< R), 8 consecutive columns from `col` (an
// output column: of N, or of the SwiGLU's N / 2 = hidden), from the product
// sums v (SwiGLU: v the h1 sums, v2 the h2 sums of the same columns). The
// round modes round every elementwise op to bf16 as _block_body's; kernel
// #2's keep the residual in fp32 and round only h1, h2 and the SwiGLU's
// output, with the products and sums in torch's order (the plain twin's).
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
      const float y1 = round_bf16(v[i] + b[i]);
      const float y2 = round_bf16(v2[i] + b2[i]);
      const float s = __fdividef(y1, 1.f + __expf(-y1));
      o[i] = (MODE == kSwiGLURound ? round_bf16(s) : s) * y2;
    }
    *reinterpret_cast<uint4*>(out + (size_t)row * ldo + col) = pack8(o);
  } else if (MODE == kBiasBf16) {
#pragma unroll
    for (int i = 0; i < 8; ++i) o[i] = v[i] + b[i];
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
template <int MODE, int NWG, int BN, typename Ready, typename Get>
__device__ __forceinline__ void finish_rows(Ready ready, Get get, int r0, int units, int m0,
                                            int n0, int R, int tid,
                                            const bf16* __restrict__ bias,
                                            bf16* __restrict__ out, int ldo,
                                            float* __restrict__ resid, int ldr,
                                            const bf16* __restrict__ gate, int ldg, int hidden) {
  constexpr bool kGlu = is_swiglu(MODE);
  constexpr int kGroups = (kGlu ? BN / 2 : BN) / 8;  // 8-column groups of a row
  constexpr int kT = Geom<NWG, BN>::kThreads, kChunk = 4;
  UnitIn in[kChunk];
  auto load = [&](int base) {
#pragma unroll
    for (int i = 0; i < kChunk; ++i) {
      const int u = base + i * kT, r = r0 + u / kGroups, c = (u % kGroups) * 8;
      if (u < units && m0 + r < R)
        load_unit<MODE>(in[i], m0 + r, (kGlu ? n0 / 2 : n0) + c, bias, resid, ldr, gate, ldg,
                        hidden);
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
      float v[8], v2[8];
      get(r, c, v);
      if (kGlu) get(r, BN / 2 + c, v2);
      finish8<MODE>(m0 + r, (kGlu ? n0 / 2 : n0) + c, v, v2, in[i], out, ldo, resid, ldr);
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
// 128 NWG threads. a_map: A [R, K] bf16, boxes of 64 k x 64 NWG rows;
// w_map: the weight stack [rows, K] bf16, boxes of 64 k x BN rows (SwiGLU:
// BN / 2), this product's rows from w_row0 (SwiGLU: h1 from w_row0, h2 from
// w_row0 + hidden). Split s (the block's rank in its cluster) walks k
// stages [s KT / S, (s + 1) KT / S); the cluster's blocks then sum each
// other's staged tiles in split order, each for 1 / S of the tile's rows,
// and finish them.
template <int MODE, int NWG, int BN>
__global__ void __launch_bounds__(128 * NWG, 1)
head_gemm_kernel(const __grid_constant__ CUtensorMap a_map,
                 const __grid_constant__ CUtensorMap w_map, int w_row0, int R, int K,
                 const bf16* __restrict__ bias, bf16* __restrict__ out, int ldo,
                 float* __restrict__ resid, int ldr, const bf16* __restrict__ gate, int ldg,
                 int hidden) {
  using G = Geom<NWG, BN>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // the same offset in every block of a cluster: the staged tiles line up
  unsigned char* const smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* const full = reinterpret_cast<uint64_t*>(smem + G::kRing * G::kStage);

  const int tid = threadIdx.x, wg = tid >> 7;
  const int splits = gridDim.x, split = blockIdx.x;
  const int m0 = blockIdx.y * G::kRows, n0 = blockIdx.z * BN;
  const int kt = K / kBK, ka = split * kt / splits, steps = (split + 1) * kt / splits - ka;
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

  auto load_w = [&](int s) {  // weight slice of step s, and the slot's byte count
    const int slot = s % G::kRing;
    const uint32_t ws = smem_u32(smem + slot * G::kStage + G::kA), bar = smem_u32(full + slot);
    const int k0 = (ka + s) * kBK;
    mbar_expect_tx(bar, G::kStage);
    if (is_swiglu(MODE)) {
      tma_2d(ws, &w_map, k0, w_row0 + n0 / 2, bar);
      tma_2d(ws + G::kW / 2, &w_map, k0, w_row0 + hidden + n0 / 2, bar);
    } else {
      tma_2d(ws, &w_map, k0, w_row0 + n0, bar);
    }
  };
  auto load_a = [&](int s) {
    const int slot = s % G::kRing;
    tma_2d(smem_u32(smem + slot * G::kStage), &a_map, (ka + s) * kBK, m0,
           smem_u32(full + slot));
  };
  const int pre = min(G::kAhead, steps);
  if (tid == 0)
    for (int s = 0; s < pre; ++s) load_w(s);  // weights never depend on the kernel ahead
  pdl_wait();
  if (tid == 0)
    for (int s = 0; s < pre; ++s) load_a(s);

  float acc[BN / 8][4];
  for (int j = 0; j < steps; ++j) {
    // every thread has waited for the wgmmas of step j - 1 - kLag, whose
    // slot takes step j + kAhead
    __syncthreads();
    if (tid == 0 && j + G::kAhead < steps) {
      load_w(j + G::kAhead);
      load_a(j + G::kAhead);
    }
    const int slot = j % G::kRing;
    mbar_wait(smem_u32(full + slot), (j / G::kRing) & 1);
    const uint32_t a_addr = smem_u32(smem + slot * G::kStage) + wg * 64 * 128;
    const uint32_t w_addr = smem_u32(smem + slot * G::kStage + G::kA);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
      wgmma_ss(acc, gmma_desc(a_addr + kk * 32, 16, 1024), gmma_desc(w_addr + kk * 32, 16, 1024),
               j > 0 || kk > 0);
    wgmma_commit();
    wgmma_wait<G::kLag>();
  }
  wgmma_wait<0>();
  pdl_trigger();    // the next kernel waits for this one before it reads h or act
  __syncthreads();  // the ring is free for the staged tile

  // the accumulators staged as the tile [kRows][kLdt] fp32 (wgmma's C
  // layout: warp w's rows 16 w + g and + 8, columns 8 j + 2 t, + 1)
  float* const tile = reinterpret_cast<float*>(smem);
  {
    const int warp = (tid >> 5) & 3, lane = tid & 31;
    const int r = wg * 64 + warp * 16 + (lane >> 2), c = 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      *reinterpret_cast<float2*>(tile + r * G::kLdt + 8 * j + c) = make_float2(acc[j][0], acc[j][1]);
      *reinterpret_cast<float2*>(tile + (r + 8) * G::kLdt + 8 * j + c) =
          make_float2(acc[j][2], acc[j][3]);
    }
  }
  constexpr int kGroups = (is_swiglu(MODE) ? BN / 2 : BN) / 8;
  if (splits == 1) {
    finish_rows<MODE, NWG, BN>(
        [] { __syncthreads(); },
        [&](int r, int c, float(&v)[8]) {
#pragma unroll
          for (int i = 0; i < 8; ++i) v[i] = 0.f;
          add8(tile + r * G::kLdt + c, v);
        },
        0, G::kRows * kGroups, m0, n0, R, tid, bias, out, ldo, resid, ldr, gate, ldg, hidden);
    return;
  }
  // Block s finishes rows [s kRows / S, (s + 1) kRows / S) of the tile: every
  // other block of the cluster copies those rows of its staged tile into
  // slot (its rank) of this block's receive area (bulk copies, completing on
  // this block's mbarrier), and the slices are summed in split order.
  cg::cluster_group cluster = cg::this_cluster();
  const int rows = G::kRows / splits;
  const int slice = rows * G::kLdt;  // floats
  float* const recv = tile + G::kRows * G::kLdt;
  const uint32_t rbar = smem_u32(full + G::kRing);
  if (tid == 0) mbar_expect_tx(rbar, (splits - 1) * slice * 4);
  fence_async_shared();  // the staged tile is visible to the bulk copies
  cluster.sync();        // every tile staged, every ring free, every count set
  if (tid == 0)
    for (int d = 0; d < splits; ++d)
      if (d != split)
        bulk_s2s(cluster_addr(smem_u32(recv + split * slice), d), smem_u32(tile + d * slice),
                 slice * 4, cluster_addr(rbar, d));
  finish_rows<MODE, NWG, BN>(
      [&] { mbar_wait(rbar, 0); },
      [&](int r, int c, float(&v)[8]) {
        const int rr = r - split * rows;
#pragma unroll
        for (int i = 0; i < 8; ++i) v[i] = 0.f;
        for (int s = 0; s < splits; ++s)
          add8((s == split ? tile + r * G::kLdt : recv + s * slice + rr * G::kLdt) + c, v);
      },
      split * rows, rows * kGroups, m0, n0, R, tid, bias, out, ldo, resid, ldr, gate, ldg,
      hidden);
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

// The tensor map of a bf16 matrix [rows, cols] (row stride cols) in boxes of
// 64 columns x box_rows rows, 128-byte swizzle; out-of-range rows read 0.
// False if cuTensorMapEncodeTiled is not found or refuses the shape.
inline bool bf16_map(const void* ptr, int rows, int cols, int box_rows, CUtensorMap* out) {
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
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * 2};
  const cuuint32_t box[2] = {kBK, static_cast<cuuint32_t>(box_rows)}, unit[2] = {1, 1};
  return encode(out, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims, strides,
                box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// One product's operands: the tensor maps of A [R, K] and of the weight
// stack [w_rows, K] for a plan; N out-features a block.
struct Product {
  CUtensorMap a_map, w_map;
  int R, N, K;
};

// The tensor maps of a product with N out-features (SwiGLU: 2 hidden) on a
// weight stack of w_rows rows; false if the plan does not fit the shape.
inline bool make_product(const bf16* A, int R, int K, const bf16* W, int w_rows, int N,
                         bool swiglu, const Plan& p, Product* out) {
  const bool splits_ok = (p.splits & (p.splits - 1)) == 0 && p.splits >= 1 &&
                         p.splits <= kMaxSplits && p.splits <= K / kBK;
  const bool shape_ok = (p.bm == 64 || p.bm == 128) &&
                        p.bn == 128 && R > 0 &&
                        K % kBK == 0 && N % p.bn == 0 && splits_ok &&
                        reinterpret_cast<uintptr_t>(A) % 16 == 0 &&
                        reinterpret_cast<uintptr_t>(W) % 16 == 0;
  if (!shape_ok) return false;
  out->R = R;
  out->N = N;
  out->K = K;
  return bf16_map(A, R, K, p.bm, &out->a_map) &&
         bf16_map(W, w_rows, K, swiglu ? p.bn / 2 : p.bn, &out->w_map);
}

// MaxDynamicSharedMemorySize of head_gemm_kernel<MODE, NWG, BN>, once per
// device
template <int MODE, int NWG, int BN>
cudaError_t allow_smem() {
  static unsigned done = 0;  // bit per device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < 32 && (done >> dev & 1u))) return err;
  err = cudaFuncSetAttribute(head_gemm_kernel<MODE, NWG, BN>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, Geom<NWG, BN>::kBytes);
  if (err == cudaSuccess && dev < 32) done |= 1u << dev;
  return err;
}

template <int MODE, int NWG, int BN>
cudaError_t run(const Product& pr, int w_row0, const Plan& p, const Epilogue& ep, bool pdl,
                cudaStream_t st) {
  BD_CHECK_ERR((allow_smem<MODE, NWG, BN>()));
  const int n_tiles = pr.N / BN, m_tiles = (pr.R + 64 * NWG - 1) / (64 * NWG);
  return launch_clusters(pdl, p.splits, dim3(p.splits, m_tiles, n_tiles), 128 * NWG,
                         Geom<NWG, BN>::kBytes, st, head_gemm_kernel<MODE, NWG, BN>, pr.a_map,
                         pr.w_map, w_row0, pr.R, pr.K, ep.bias, static_cast<bf16*>(ep.out),
                         ep.ldo, ep.resid, ep.ldr, ep.gate, ep.ldg, ep.hidden);
}

// epilogue(A @ W^T) of one product by its plan, on weight rows from w_row0
// (SwiGLU: h1 from w_row0, h2 from w_row0 + hidden)
template <int MODE>
cudaError_t gemm(const Product& pr, int w_row0, const Plan& p, const Epilogue& ep, bool pdl,
                 cudaStream_t st) {
  if (p.bm == 64 && p.bn == 128) return run<MODE, 1, 128>(pr, w_row0, p, ep, pdl, st);
  if (p.bm == 128 && p.bn == 128) return run<MODE, 2, 128>(pr, w_row0, p, ep, pdl, st);
  return cudaErrorInvalidValue;
}

// head_block's launches on the whole sampler's bf16 routes (#2 and #3/#4):
// each product on head_gemm by its plan, over the tensor maps of the whole
// stacks (pr, plan: indexed by BlockProduct), and every launch programmatic
// when pdl.
struct GemmLaunch {
  const Product* pr;
  const Plan* plan;
  bool pdl;
  cudaStream_t st;

  template <typename... Params, typename... Args>
  cudaError_t stage(dim3 grid, int threads, size_t smem, void (*kernel)(Params...),
                    Args... args) const {
    return launch(pdl, grid, threads, smem, st, kernel, args...);
  }

  template <int MODE>
  cudaError_t gemm(BlockProduct p, const bf16*, int, const bf16*, int w_row0, int, int, int,
                   const Epilogue& ep) const {
    return hg::gemm<MODE>(pr[p], w_row0, plan[p], ep, pdl, st);
  }
};

}  // namespace hg
