// Bias-preloaded GEMM for Hopper: out[M,N] = x[M,K] @ w[K,N] + bias[N].
//
// Replaces the Pallas TPU kernel repro.kernels.matmul_ws.matmul_ws
// (_mm_kernel): int8 x int8 -> int32, f32 -> f32 (no TF32), and bf16 x bf16
// with f32 products and sums, plus an f32 bias, rounded once to bf16 (the
// reference's ops.matmul_ws casts its f32 result back to the operand type).
// Kept from the TPU kernel: the accumulators start at the bias (its preload
// at K block 0), and the contraction runs as a loop inside a block; where K
// is split over blocks, the slices' sums meet after the bias in slice order,
// the reference's own order of K blocks.  The TPU grid order (n, k, m),
// which kept a weight block resident across a sequential grid, is not kept:
// blocks here run in parallel.  x and w are row-major; w is [K,N] as the
// model stores it and is never repacked.
//
// Five forms, picked on the host by geometry alone (kernels/matmul_ws.py,
// mm_path); none falls back to another:
//
// wgmma (bf16, M > 16, K and N multiples of 8).  Prefill GEMMs such as
//   [3000,3072]@[3072,8192] are bound by operations: 151 GFLOP, 0.153 ms at
//   989 TFLOP/s.  One block of 384 threads per 128 x BN output tile: one
//   producer warpgroup, of which one thread issues every TMA load, and two
//   consumer warpgroups of 64 rows each.  A kStages-deep ring of 64-deep K
//   steps: the x tile (128 rows x 64 bf16, K-major, 128-byte rows under the
//   128-byte swizzle) and the w tile (64 K rows x BN, loaded as BN/64 boxes
//   of 64 columns straight from the N-major [K,N] weight), each stage
//   signalled full by an mbarrier with its byte count and released by one
//   arrival of each consumer warpgroup.  Consumers run wgmma m64nBNk16 with
//   B through the transpose bit, wait for each step's products and release
//   its stage; the ring keeps the loads ahead.  setmaxnreg moves registers
//   from the producer (40) to the consumers (232) for the f32 accumulators.
//   TMA zero-fills rows past M and columns past K or N; the epilogue rounds
//   once to bf16 and stores bf16 pairs, masked at the ragged M and N edges.
//   Blocks walk M fastest, so one wave shares the weight tiles it reads in
//   L2.  The tile width BN (128 or 256) is the host's choice (wgmma_bn).
//
// stream (bf16 or int8, M <= 16).  Decode ([4,3072]@[3072,8192] bf16:
//   50.3 MB of weights, 15.0 us at 3.35 TB/s) and the dense heads ([8,256]
//   @[256,1000] int8, launch-bound) are bound by the bytes of w.  A block
//   of 256 threads covers 256 columns and one K slice of kc rows: x's slice
//   sits in shared memory as f32 (or int32), each warp takes every 8th row
//   of the slice, and each lane reads 8 contiguous columns of a row at once
//   (16 bytes of bf16, 8 of int8), four rows in flight, into 8·MT register
//   accumulators (f32 FMAs, or int32 MADs, exact).  The 8 warps' sums meet
//   in shared memory in a fixed order.  Where one slice per column block
//   would leave the card short of loads in flight, K is split over
//   blockIdx.y: each block writes its partial sums, and a second kernel adds
//   bias and partials in slice order and rounds.  No atomics, so a result
//   does not change from run to run.
//
// simt (every f32 GEMM).  f32 has no tensor-core path that keeps f32
//   operands (TF32 rounds them to 10 mantissa bits, which the gradients'
//   parity forbids), so the bound is 67 TFLOP/s of FFMA: LM training's
//   backward ([4096,8192]@[8192,3072]: 206 GFLOP, 3.08 ms) is bound by
//   operations; the conv weight-gradient taps ([C, N·OH·OW] @ [N·OH·OW, K],
//   M = C of 4-256, K to 401,408, N of 32-256) mostly by the bytes of their
//   two operands (conv 1's [32,401408]@[401408,32]: 103 MB, 30.7 us at 3.35
//   TB/s, against 0.82 GFLOP, 12.3 us).  256 threads a block own a BM x BN
//   tile: 128 x 128 with 8 x 8 outputs a thread, or 64 x 64, 32 x 32 and
//   8 x 32 where M or N is small, where the threads form `groups` copies of
//   the tile's thread grid and group g takes rows g, g + groups, ... of each
//   16-deep K stage (their sums meet in shared memory in group order at the
//   end).  Stages arrive by cp.async in a 3-deep ring: x transposed to
//   K-major (xs[k][m], four-byte copies, rows padded by 4 floats) so that a
//   thread's rows come as float4 reads, and w as it lies (16-byte copies
//   where N is a multiple of 4, else four-byte ones); zero-filled past M, N
//   and the K slice.  Where the output tiles alone fill less than two waves
//   of the card, K is split over blockIdx.z (simt_plan) and the stream
//   form's reduce kernel adds bias and partials in slice order, so one call
//   gives the same bits on every run.
//
// mma (int8, M > 16, K and N multiples of 4).  w8 prefill GEMMs such as
//   [3000,3072]@[3072,8192] are bound by operations: 151 GOP, 0.076 ms at
//   1,979 TOP/s.  mma.sync m16n8k32 s8 (the instruction and fragments of
//   the conv kernels' tensor-core path) with int32 accumulators that start
//   at the bias: exact, so equal to any other order's sum.  8 warps own a
//   128 x 128 tile, 64 x 32 each.  The x tile (128 rows x 64 K) and the w
//   tile (64 K rows x 128 columns, N-major as w lies) arrive by cp.async in
//   a 4-deep ring (16-byte copies where K and N are multiples of 16, else
//   four-byte ones; zero-filled past the edges).  B fragments need 4
//   consecutive K of one column in a register and 8-bit wgmma takes only
//   K-major operands, so each stage's w tile is transposed in shared memory
//   once: a thread reads a 4 K x 4 column block as four words, regroups
//   their bytes with 8 __byte_perm, and writes four words of a K-major
//   tile.  XOR swizzles of both tiles (the copied tile's 16-byte chunks by
//   K row, the K-major tile's words by column) keep the transpose's reads
//   and the fragment loads free of bank conflicts and its writes at two to
//   a bank.  The epilogue stores int32 pairs, masked at the ragged M and N
//   edges.
//
// scalar (bf16 with K or N not a multiple of 8, whose rows TMA cannot
//   address; int8 with K or N not a multiple of 4, whose rows cp.async
//   cannot copy).  The first port's kernel: one block per 64x64
//   output tile, 32-deep slices of x and w staged in shared memory, a 4x4
//   register tile of outputs a thread, scalar FMAs (no tensor cores).  Its
//   int8 and bf16 instantiations are the only ones: every f32 GEMM runs
//   simt.
#include <cstdint>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <type_traits>

#include "hopper_common.cuh"

namespace {

using bf16 = __nv_bfloat16;

template <typename Tout, typename Tacc>
__device__ __forceinline__ Tout to_out(Tacc v) {
  if constexpr (std::is_same<Tout, bf16>::value) return __float2bfloat16_rn(v);
  else return v;
}

// out = bias + the K slices' partial sums, added in slice order (the
// stream and simt forms' second kernel)
template <typename Acc, typename Out>
__global__ void __launch_bounds__(256)
mm_split_reduce_kernel(const Acc* __restrict__ part,
                       const Acc* __restrict__ bias, Out* __restrict__ out,
                       int M, int N, int split) {
  const long long mn = static_cast<long long>(M) * N;
  const long long i = static_cast<long long>(blockIdx.x) * 256 + threadIdx.x;
  if (i >= mn) return;
  Acc v = bias != nullptr ? bias[i % N] : Acc(0);
  // the adds stay in slice order; unrolled, 16 slices' loads are in flight
  // at once (a simt tap splits K up to 523 ways over a few hundred sums)
#pragma unroll 16
  for (int s = 0; s < split; ++s) v += part[s * mn + i];
  out[i] = to_out<Out>(v);
}

// ------------------------------------------------------------------------
// scalar: the first port's kernel

namespace scalar {

constexpr int BM = 64, BN = 64, BK = 32, TM = 4, TN = 4;
constexpr int kThreads = (BM / TM) * (BN / TN);  // 256

template <typename Tacc, typename Tin>
__device__ __forceinline__ Tacc widen(Tin v) {
  if constexpr (std::is_same<Tin, bf16>::value) return __bfloat162float(v);
  else return static_cast<Tacc>(v);
}

template <typename Tin, typename Tacc, typename Tout>
__global__ void __launch_bounds__(kThreads)
matmul_ws_kernel(const Tin* __restrict__ x, const Tin* __restrict__ w,
                 const Tacc* __restrict__ bias, Tout* __restrict__ out,
                 int M, int N, int K) {
  __shared__ Tin xs[BK][BM + 1];  // x slice, transposed: xs[k][m]
  __shared__ Tin ws[BK][BN];
  const int tx = threadIdx.x % (BN / TN), ty = threadIdx.x / (BN / TN);
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  Tacc acc[TM][TN];
#pragma unroll
  for (int j = 0; j < TN; ++j) {
    const int n = n0 + tx + j * (BN / TN);
    const Tacc b = (bias != nullptr && n < N) ? bias[n] : Tacc(0);
#pragma unroll
    for (int i = 0; i < TM; ++i) acc[i][j] = b;
  }

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int i = threadIdx.x; i < BM * BK; i += kThreads) {
      const int r = i / BK, c = i % BK;
      const int m = m0 + r, k = k0 + c;
      xs[c][r] = (m < M && k < K) ? x[static_cast<long long>(m) * K + k] : Tin{};
    }
    for (int i = threadIdx.x; i < BK * BN; i += kThreads) {
      const int r = i / BN, c = i % BN;
      const int k = k0 + r, n = n0 + c;
      ws[r][c] = (k < K && n < N) ? w[static_cast<long long>(k) * N + n] : Tin{};
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      Tacc a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i)
        a[i] = widen<Tacc>(xs[kk][ty + i * (BM / TM)]);
#pragma unroll
      for (int j = 0; j < TN; ++j)
        b[j] = widen<Tacc>(ws[kk][tx + j * (BN / TN)]);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] += a[i] * b[j];
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty + i * (BM / TM);
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tx + j * (BN / TN);
      if (n < N)
        out[static_cast<long long>(m) * N + n] = to_out<Tout>(acc[i][j]);
    }
  }
}

template <typename Tin, typename Tacc, typename Tout>
int launch(const void* x, const void* w, const void* bias, void* out, int M,
           int N, int K, cudaStream_t stream) {
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  matmul_ws_kernel<Tin, Tacc, Tout><<<grid, kThreads, 0, stream>>>(
      static_cast<const Tin*>(x), static_cast<const Tin*>(w),
      static_cast<const Tacc*>(bias), static_cast<Tout*>(out), M, N, K);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace scalar

// ------------------------------------------------------------------------
// stream: short M, w streamed once

namespace stream {

constexpr int kThreads = 256;
constexpr int kGroups = kThreads / 32;  // warps, each a share of the K slice
constexpr int kVec = 8;                 // columns a lane
constexpr int BN = 32 * kVec;           // columns a block
constexpr int kUnroll = 4;              // rows a lane has in flight

template <typename Tin>
struct Traits;

template <>
struct Traits<bf16> {
  using Acc = float;
  using Out = bf16;
  using Vec = uint4;  // 8 bf16
  static __device__ __forceinline__ void unpack(const Vec& v, float (&f)[kVec]) {
    const uint32_t u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(u[i] << 16);
      f[2 * i + 1] = __uint_as_float(u[i] & 0xFFFF0000u);
    }
  }
  static __device__ __forceinline__ Acc widen(bf16 v) {
    return __bfloat162float(v);
  }
  static __device__ __forceinline__ Acc from_bits(uint32_t u) {
    return __uint_as_float(u);
  }
};

template <>
struct Traits<int8_t> {
  using Acc = int;
  using Out = int32_t;
  using Vec = uint2;  // 8 int8
  static __device__ __forceinline__ void unpack(const Vec& v, int (&f)[kVec]) {
    const uint32_t u[2] = {v.x, v.y};
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int b = 0; b < 4; ++b)
        f[4 * i + b] = static_cast<int8_t>((u[i] >> (8 * b)) & 0xFF);
  }
  static __device__ __forceinline__ Acc widen(int8_t v) { return v; }
  static __device__ __forceinline__ Acc from_bits(uint32_t u) {
    return static_cast<int>(u);
  }
};

// One (256-column block, K slice) of out, or of the slice's partial sums
// when part is not null.  Shared memory: x's slice as xs[kc][MT], then the
// warps' sums of one row, red[kGroups][BN].
template <typename Tin, int MT>
__global__ void __launch_bounds__(kThreads)
mm_stream_kernel(const Tin* __restrict__ x, const Tin* __restrict__ w,
                 const typename Traits<Tin>::Acc* __restrict__ bias,
                 typename Traits<Tin>::Out* __restrict__ out,
                 typename Traits<Tin>::Acc* __restrict__ part, int M, int N,
                 int K, int kc) {
  using T = Traits<Tin>;
  using Acc = typename T::Acc;
  extern __shared__ uint4 smem4[];
  Acc* xs = reinterpret_cast<Acc*>(smem4);
  Acc* red = xs + kc * MT;

  const int n0 = blockIdx.x * BN, k0 = blockIdx.y * kc;
  const int kce = min(kc, K - k0);
  const int g = threadIdx.x / 32, lane = threadIdx.x % 32;

  for (int i = threadIdx.x; i < MT * kc; i += kThreads) {
    const int m = i / kc, kk = i % kc;
    Acc v = Acc(0);
    if (m < M && kk < kce)
      v = T::widen(x[static_cast<long long>(m) * K + k0 + kk]);
    xs[kk * MT + m] = v;
  }
  __syncthreads();

  Acc acc[MT][kVec];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < kVec; ++j) acc[m][j] = Acc(0);

  // one row of w: 8 columns into the accumulators
  auto fma_row = [&](const typename T::Vec& v, int kk) {
    Acc wv[kVec];
    T::unpack(v, wv);
    Acc xv[MT];
#pragma unroll
    for (int q = 0; q < MT / 4; ++q) {
      const uint4 u = *reinterpret_cast<const uint4*>(xs + kk * MT + 4 * q);
      xv[4 * q] = T::from_bits(u.x);
      xv[4 * q + 1] = T::from_bits(u.y);
      xv[4 * q + 2] = T::from_bits(u.z);
      xv[4 * q + 3] = T::from_bits(u.w);
    }
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int j = 0; j < kVec; ++j) acc[m][j] += xv[m] * wv[j];
  };

  const int n = n0 + kVec * lane;
  if (n < N) {  // N is a multiple of 8: a lane's columns are all in or out
    const long long row = N;
    const typename T::Vec* wp = reinterpret_cast<const typename T::Vec*>(
        w + (static_cast<long long>(k0) + g) * row + n);
    const long long step = kGroups * row / kVec;  // in vectors
    int kk = g;
    for (; kk + (kUnroll - 1) * kGroups < kce; kk += kUnroll * kGroups) {
      typename T::Vec v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) v[u] = __ldg(wp + u * step);
      wp += kUnroll * step;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) fma_row(v[u], kk + u * kGroups);
    }
    for (; kk < kce; kk += kGroups) {
      fma_row(__ldg(wp), kk);
      wp += step;
    }
  }

  // the warps' sums of each row, added in warp order
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    if (m >= M) break;  // uniform over the block
#pragma unroll
    for (int j = 0; j < kVec; ++j) red[g * BN + kVec * lane + j] = acc[m][j];
    __syncthreads();
    const int c = n0 + threadIdx.x;
    if (c < N) {
      Acc v = (part == nullptr && bias != nullptr) ? bias[c] : Acc(0);
#pragma unroll
      for (int s = 0; s < kGroups; ++s) v += red[s * BN + threadIdx.x];
      if (part != nullptr)
        part[(static_cast<long long>(blockIdx.y) * M + m) * N + c] = v;
      else
        out[static_cast<long long>(m) * N + c] = to_out<typename T::Out>(v);
    }
    __syncthreads();
  }
}

template <typename Tin, int MT>
int launch_mt(const void* x, const void* w, const void* bias, void* out,
              void* part, int M, int N, int K, int kc, int split,
              cudaStream_t stream) {
  using T = Traits<Tin>;
  using Acc = typename T::Acc;
  const int smem = static_cast<int>(sizeof(Acc)) * (kc * MT + kGroups * BN);
  const dim3 grid((N + BN - 1) / BN, split);
  mm_stream_kernel<Tin, MT><<<grid, kThreads, smem, stream>>>(
      static_cast<const Tin*>(x), static_cast<const Tin*>(w),
      static_cast<const Acc*>(bias), static_cast<typename T::Out*>(out),
      split > 1 ? static_cast<Acc*>(part) : nullptr, M, N, K, kc);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || split == 1) return static_cast<int>(err);
  const long long mn = static_cast<long long>(M) * N;
  mm_split_reduce_kernel<Acc, typename T::Out>
      <<<static_cast<unsigned>((mn + 255) / 256), 256, 0, stream>>>(
      static_cast<const Acc*>(part), static_cast<const Acc*>(bias),
      static_cast<typename T::Out*>(out), M, N, split);
  return static_cast<int>(cudaGetLastError());
}

template <typename Tin>
int launch(const void* x, const void* w, const void* bias, void* out,
           void* part, int M, int N, int K, int kc, int split,
           cudaStream_t stream) {
  if (M <= 4)
    return launch_mt<Tin, 4>(x, w, bias, out, part, M, N, K, kc, split, stream);
  if (M <= 8)
    return launch_mt<Tin, 8>(x, w, bias, out, part, M, N, K, kc, split, stream);
  return launch_mt<Tin, 16>(x, w, bias, out, part, M, N, K, kc, split, stream);
}

}  // namespace stream

// ------------------------------------------------------------------------
// wgmma: long M, bf16, TMA-fed ring

namespace wg {

using namespace hopper;

constexpr int BM = 128;          // rows a block: two consumer warpgroups of 64
constexpr int BK = 64;           // K step: one 128-byte swizzled row of bf16
constexpr int kStages = 4;       // ring depth
constexpr int kConsumers = 2;
constexpr int kThreads = 128 * (kConsumers + 1);  // and a producer warpgroup

template <int BN>
struct Tile {
  static constexpr int kABytes = BM * BK * 2;      // one box, 16 KB
  static constexpr int kBBox = BK * 64 * 2;        // 64 K rows x 64 columns
  static constexpr int kBBytes = (BN / 64) * kBBox;
  static constexpr int kStageBytes = kABytes + kBBytes;
  static constexpr int kBarOffset = kStages * kStageBytes;
  static constexpr int kSmem = 1024 + kBarOffset + 16 * kStages;
};

template <int BN>
__global__ void __launch_bounds__(kThreads, 1)
mm_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                const __grid_constant__ CUtensorMap wmap,
                const float* __restrict__ bias, bf16* __restrict__ out, int M,
                int N, int K) {
  using T = Tile<BN>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  // swizzled tiles need 1024-byte alignment of the shared address itself
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t bars = base + T::kBarOffset;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (kStages + s); };
  auto a_tile = [&](int s) { return base + s * T::kStageBytes; };
  auto b_tile = [&](int s) { return a_tile(s) + T::kABytes; };

  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int nk = (K + BK - 1) / BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), kConsumers);
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int wgi = threadIdx.x / 128;
  if (wgi == kConsumers) {
    // producer: one thread issues every load
    regs_dealloc<40>();
    if (threadIdx.x % 128 == 0) {
      for (int it = 0; it < nk; ++it) {
        const int s = it % kStages;
        if (it >= kStages) mbar_wait(empty(s), ((it / kStages) - 1) & 1);
        mbar_expect_tx(full(s), T::kStageBytes);
        tma_load_2d(a_tile(s), &xmap, full(s), it * BK, m0);
#pragma unroll
        for (int c = 0; c < BN / 64; ++c)
          tma_load_2d(b_tile(s) + c * T::kBBox, &wmap, full(s), n0 + 64 * c,
                      it * BK);
      }
    }
  } else {
    regs_alloc<232>();
    // consumer warpgroup wgi: rows [64·wgi, 64·wgi + 64) of the tile.  This
    // thread holds rows r0 and r0 + 8 of them; in every n8 column chunk j,
    // accumulator element 4j + e is (row r0 + 8·(e / 2), column
    // 8j + cq + e % 2).
    const int t = threadIdx.x % 128, lane = t % 32;
    const int r0 = 16 * (t / 32) + lane / 4, cq = 2 * (lane % 4);

    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) {
      const int n = n0 + 8 * (i / 4) + cq + i % 2;
      acc[i] = (bias != nullptr && n < N) ? bias[n] : 0.f;
    }
    // the bias values are settled before the first wgmma.fence
    fence_regs(acc);

    // x: K-major, 8-row groups 1024 bytes apart, a k16 step 32 bytes along
    // the row.  w: MN-major (transpose bit), 8-K-row groups 1024 bytes
    // apart, 64-column boxes kBBox apart, a k16 step 16 rows down.
    for (int it = 0; it < nk; ++it) {
      const int s = it % kStages;
      mbar_wait(full(s), (it / kStages) & 1);
      __syncwarp();
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint64_t da =
            make_desc(a_tile(s) + wgi * 64 * 128 + kk * 32, 16, 1024, 1);
        const uint64_t db =
            make_desc(b_tile(s) + kk * 16 * 128, T::kBBox, 1024, 1);
        wgmma_ss_tb<BN>(acc, da, db);
      }
      wgmma_commit();
      // wait for this step's products, then release the stage.  Keeping
      // a step in flight across the loop made ptxas serialize the wgmmas
      // (C7515) and measured no faster on the H100
      wgmma_wait<0>();
      fence_regs(acc);
      if (t == 0) mbar_arrive(empty(s));
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int m = m0 + wgi * 64 + r0 + 8 * r;
      if (m >= M) continue;
      bf16* dst = out + static_cast<long long>(m) * N;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int n = n0 + 8 * j + cq;  // N is a multiple of 8
        if (n < N)
          *reinterpret_cast<__nv_bfloat162*>(dst + n) = __floats2bfloat162_rn(
              acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
      }
    }
  }
}

// a rank-2 map over a row-major bf16 [rows, cols] matrix, box (64 columns,
// box_rows rows), 128-byte swizzle, zero fill past the edges
bool make_map(CUtensorMap* map, const void* ptr, int rows, int cols,
              int box_rows) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {2ull * cols};  // bytes
  const cuuint32_t box[2] = {64, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t step[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                const_cast<void*>(ptr), dims, strides, box, step,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int BN>
int launch(const void* x, const void* w, const void* bias, void* out, int M,
           int N, int K, cudaStream_t stream) {
  CUtensorMap xm, wm;
  if (!make_map(&xm, x, M, K, BM) || !make_map(&wm, w, K, N, BK))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = mm_wgmma_kernel<BN>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Tile<BN>::kSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
  kernel<<<grid, kThreads, Tile<BN>::kSmem, stream>>>(
      xm, wm, static_cast<const float*>(bias), static_cast<bf16*>(out), M, N,
      K);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace wg

// ------------------------------------------------------------------------
// simt: f32, register-tiled, K split over blocks where the tiles are few

namespace simt {

using hopper::cp_async_commit;
using hopper::cp_async_wait;
using hopper::cp_async_zfill;

constexpr int kThreads = 256;
constexpr int BK = 16;      // K rows a stage
constexpr int kStages = 3;  // ring depth

// A BM x BN output tile, TM x TN outputs a thread: RT x CT threads cover
// it, and the block's 256 threads make KW such groups, group g taking K rows
// g, g + KW, ... of each stage.  A thread's rows are TM/4 runs of 4, RT·4
// apart (ty·4 within each), its columns TN/4 runs of 4, CT·4 apart, so
// that each run is one float4 read of shared memory.
template <int BM_, int BN_, int TM_, int TN_>
struct Tile {
  static constexpr int BM = BM_, BN = BN_, TM = TM_, TN = TN_;
  static constexpr int RT = BM / TM, CT = BN / TN;
  static constexpr int KW = kThreads / (RT * CT);
  static constexpr int AS = BM + 4;  // xs row stride in floats (xs[k][m])
  static constexpr int kStageFloats = BK * (AS + BN);
  static constexpr int kRingBytes = kStages * kStageFloats * 4;
  static constexpr int kRedBytes = KW > 1 ? KW * BM * BN * 4 : 0;
  static constexpr int kSmem = kRingBytes > kRedBytes ? kRingBytes : kRedBytes;
  static constexpr int kMinBlocks = TM * TN >= 64 ? 2 : 4;
  static_assert(KW * RT * CT == kThreads && BK % KW == 0, "thread groups");
  static_assert(TM % 4 == 0 && TN % 4 == 0, "float4 runs");
};

// the tiles, by BM (kernels/matmul_ws.py: SIMT_TILES)
using T128 = Tile<128, 128, 8, 8>;  // KW 1
using T64 = Tile<64, 64, 8, 8>;     // KW 4
using T32 = Tile<32, 32, 4, 4>;     // KW 4
using T8 = Tile<8, 32, 4, 4>;       // KW 16

template <class T>
__device__ __forceinline__ int row_of(int ty, int i) {
  return (i / 4) * 4 * T::RT + ty * 4 + i % 4;
}

template <class T>
__device__ __forceinline__ int col_of(int tx, int j) {
  return (j / 4) * 4 * T::CT + tx * 4 + j % 4;
}

// One (tile, K slice) of out, or of the slice's partial sums when part is
// not null.  BVEC: 4 where N is a multiple of 4 (16-byte copies of w's
// rows, float4 stores), else 1.
template <int BM, int BN, int TM, int TN, int BVEC>
__global__ void __launch_bounds__(kThreads, (Tile<BM, BN, TM, TN>::kMinBlocks))
mm_simt_kernel(const float* __restrict__ x, const float* __restrict__ w,
               const float* __restrict__ bias, float* __restrict__ out,
               float* __restrict__ part, int M, int N, int K, int kc) {
  using T = Tile<BM, BN, TM, TN>;
  constexpr int RT = T::RT, CT = T::CT, KW = T::KW, AS = T::AS;
  extern __shared__ float4 smem_f4[];
  float* ring = reinterpret_cast<float*>(smem_f4);

  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int kb = blockIdx.z * kc, ke = min(K, kb + kc);
  const int nt = (ke - kb + BK - 1) / BK;
  const int tid = threadIdx.x;
  const int grp = tid / (RT * CT), lt = tid % (RT * CT);
  const int ty = lt / CT, tx = lt % CT;

  // stage `stage` <- K rows [k0, k0 + BK) of the slice
  auto load = [&](int stage, int k0) {
    float* xs = ring + stage * T::kStageFloats;
    float* ws = xs + BK * AS;
    for (int e = tid; e < BM * BK; e += kThreads) {
      const int r = e / BK, c = e % BK;  // 16 lanes read one row's 64 bytes
      const int m = m0 + r, k = k0 + c;
      const bool ok = m < M && k < ke;
      cp_async_zfill(xs + c * AS + r,
                     ok ? x + static_cast<long long>(m) * K + k : x, 4,
                     ok ? 4 : 0);
    }
    for (int e = tid; e < BK * BN / BVEC; e += kThreads) {
      const int r = e / (BN / BVEC), c = BVEC * (e % (BN / BVEC));
      const int k = k0 + r, n = n0 + c;
      const bool ok = k < ke && n < N;  // N % BVEC == 0: a vector is whole
      cp_async_zfill(ws + r * BN + c,
                     ok ? w + static_cast<long long>(k) * N + n : w,
                     4 * BVEC, ok ? 4 * BVEC : 0);
    }
  };

  // group 0 starts at the bias where K is whole (the preload), the rest at 0
  float acc[TM][TN];
#pragma unroll
  for (int j = 0; j < TN; ++j) {
    const int n = n0 + col_of<T>(tx, j);
    const float b = (grp == 0 && part == nullptr && bias != nullptr && n < N)
                        ? bias[n] : 0.f;
#pragma unroll
    for (int i = 0; i < TM; ++i) acc[i][j] = b;
  }

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nt) load(s, kb + s * BK);
    cp_async_commit();
  }
  for (int t = 0; t < nt; ++t) {
    cp_async_wait<kStages - 2>();  // stage t has landed
    __syncthreads();               // ... and stage t - 1 is read by all
    if (t + kStages - 1 < nt)
      load((t + kStages - 1) % kStages, kb + (t + kStages - 1) * BK);
    cp_async_commit();
    const float* xs = ring + (t % kStages) * T::kStageFloats;
    const float* ws = xs + BK * AS;
#pragma unroll
    for (int q = 0; q < BK / KW; ++q) {
      const int kk = grp + q * KW;
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM / 4; ++i) {
        const float4 v = *reinterpret_cast<const float4*>(
            xs + kk * AS + i * 4 * RT + ty * 4);
        a[4 * i] = v.x, a[4 * i + 1] = v.y, a[4 * i + 2] = v.z,
        a[4 * i + 3] = v.w;
      }
#pragma unroll
      for (int j = 0; j < TN / 4; ++j) {
        const float4 v = *reinterpret_cast<const float4*>(
            ws + kk * BN + j * 4 * CT + tx * 4);
        b[4 * j] = v.x, b[4 * j + 1] = v.y, b[4 * j + 2] = v.z,
        b[4 * j + 3] = v.w;
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }

  float* dst = part != nullptr
                   ? part + static_cast<long long>(blockIdx.z) * M * N
                   : out;
  if constexpr (KW == 1) {
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int m = m0 + row_of<T>(ty, i);
      if (m >= M) continue;
      float* row = dst + static_cast<long long>(m) * N;
#pragma unroll
      for (int j = 0; j < TN; j += 4) {
        const int n = n0 + col_of<T>(tx, j);
        if (BVEC == 4) {
          if (n < N)
            *reinterpret_cast<float4*>(row + n) = make_float4(
                acc[i][j], acc[i][j + 1], acc[i][j + 2], acc[i][j + 3]);
        } else {
#pragma unroll
          for (int u = 0; u < 4; ++u)
            if (n + u < N) row[n + u] = acc[i][j + u];
        }
      }
    }
  } else {
    // the groups' sums meet in shared memory, added in group order
    cp_async_wait<0>();
    __syncthreads();
    float* red = ring;  // [KW][BM][BN]
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; j += 4)
        *reinterpret_cast<float4*>(
            red + (grp * BM + row_of<T>(ty, i)) * BN + col_of<T>(tx, j)) =
            make_float4(acc[i][j], acc[i][j + 1], acc[i][j + 2],
                        acc[i][j + 3]);
    __syncthreads();
    for (int e = tid; e < BM * BN; e += kThreads) {
      const int m = m0 + e / BN, n = n0 + e % BN;
      if (m >= M || n >= N) continue;
      float v = red[e];
#pragma unroll
      for (int g = 1; g < KW; ++g) v += red[g * BM * BN + e];
      dst[static_cast<long long>(m) * N + n] = v;
    }
  }
}

template <class T, int BVEC>
int launch_tile(const float* x, const float* w, const float* bias,
                float* out, float* part, int M, int N, int K, int kc,
                int split, cudaStream_t stream) {
  auto kernel = mm_simt_kernel<T::BM, T::BN, T::TM, T::TN, BVEC>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((N + T::BN - 1) / T::BN, (M + T::BM - 1) / T::BM, split);
  kernel<<<grid, kThreads, T::kSmem, stream>>>(
      x, w, bias, out, split > 1 ? part : nullptr, M, N, K, kc);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || split == 1) return static_cast<int>(err);
  const long long mn = static_cast<long long>(M) * N;
  mm_split_reduce_kernel<float, float>
      <<<static_cast<unsigned>((mn + 255) / 256), 256, 0, stream>>>(
          part, bias, out, M, N, split);
  return static_cast<int>(cudaGetLastError());
}

template <class T>
int launch(const void* x, const void* w, const void* bias, void* out,
           void* part, int M, int N, int K, int kc, int split,
           cudaStream_t stream) {
  if ((M + T::BM - 1) / T::BM > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* xf = static_cast<const float*>(x);
  const auto* wf = static_cast<const float*>(w);
  const auto* bf = static_cast<const float*>(bias);
  auto* of = static_cast<float*>(out);
  auto* pf = static_cast<float*>(part);
  if (N % 4 == 0)
    return launch_tile<T, 4>(xf, wf, bf, of, pf, M, N, K, kc, split, stream);
  return launch_tile<T, 1>(xf, wf, bf, of, pf, M, N, K, kc, split, stream);
}

}  // namespace simt

// ------------------------------------------------------------------------
// mma: int8 at long M on the tensor cores (mma.sync m16n8k32 s8)

namespace imma {

using hopper::cp_async_commit;
using hopper::cp_async_wait;
using hopper::cp_async_zfill;
using hopper::mma_s8;

constexpr int BM = 128, BN = 128, BK = 64;
constexpr int kStages = 4;
constexpr int kThreads = 256;            // 8 warps: 2 along M x 4 along N
constexpr int WM = 64, WN = 32;          // a warp's outputs
constexpr int MI = WM / 16, NI = WN / 8; // its m16 and n8 tiles
constexpr int AS = BK + 16;              // x tile row stride, bytes
constexpr int kABytes = BM * AS;         // x tile [BM][BK], rows padded
constexpr int kBBytes = BK * BN;         // w tile [BK][BN], N-major
constexpr int kStageBytes = kABytes + kBBytes;
constexpr int kTBytes = BN * BK;         // w tile K-major [BN][BK], swizzled
constexpr int kSmem = kStages * kStageBytes + kTBytes;

// Two swizzles keep the transpose and the fragment loads off shared
// memory's bank conflicts.  The w tile as copied (N-major, 128-byte rows of
// eight 16-byte chunks) holds chunk q of K row r at chunk q ^ ((r / 4) % 8):
// the transpose's reads of one instruction take rows 4kq + j (kq = 0..7)
// at 4 consecutive words of one chunk and meet 32 banks.  The K-major tile
// (64-byte rows of 16 words, 4 K each) holds word kw of column n at
// kw ^ swz(n), swz(n) = 4·((n / 2) % 4): the fragment loads of one
// instruction take rows 8q + g (g = 0..7) at words base + t (t = 0..3) and
// meet 32 banks, and as swz depends on n % 8 alone a thread's fragment
// addresses are one base and constant offsets; the transpose's writes of
// one instruction meet two to a bank (rows of one parity reach 16 banks).
__device__ __forceinline__ int wt_swz(int n) { return ((n >> 1) & 3) << 2; }

__device__ __forceinline__ int ws_off(int r, int byte) {
  return r * BN + ((((byte >> 4) ^ (r >> 2)) & 7) << 4 | (byte & 15));
}

__device__ __forceinline__ uint32_t lds_u32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// V: the copies' bytes, 16 where K and N are multiples of 16, else 4
template <int V>
__global__ void __launch_bounds__(kThreads, 2)
mm_imma_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
               const int32_t* __restrict__ bias, int32_t* __restrict__ out,
               int M, int N, int K) {
  extern __shared__ uint4 smem_u4[];
  int8_t* smem = reinterpret_cast<int8_t*>(smem_u4);
  int8_t* wt = smem + kStages * kStageBytes;

  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int nk = (K + BK - 1) / BK;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int wm0 = (warp / 4) * WM, wn0 = (warp % 4) * WN;

  auto load = [&](int stage, int k0) {
    int8_t* xs = smem + stage * kStageBytes;
    int8_t* ws = xs + kABytes;
    for (int e = tid; e < BM * BK / V; e += kThreads) {
      const int r = e / (BK / V), c = V * (e % (BK / V));
      const int m = m0 + r, k = k0 + c;
      const bool ok = m < M && k < K;  // K % V == 0: a copy is whole
      cp_async_zfill(xs + r * AS + c,
                     ok ? x + static_cast<long long>(m) * K + k : x, V,
                     ok ? V : 0);
    }
    for (int e = tid; e < BK * BN / V; e += kThreads) {
      const int r = e / (BN / V), c = V * (e % (BN / V));
      const int k = k0 + r, n = n0 + c;
      const bool ok = k < K && n < N;  // N % V == 0
      cp_async_zfill(ws + ws_off(r, c),
                     ok ? w + static_cast<long long>(k) * N + n : w, V,
                     ok ? V : 0);
    }
  };

  // the w tile of `stage` into wt, K-major: a thread takes two 4 K x 4
  // column blocks, (kq, c) = (lane / 4 + 8h, 4·warp + lane % 4) for h = 0,
  // 1; its four words of rows 4kq..4kq+3 regroup by __byte_perm into the
  // four columns' words of K 4kq..4kq+3
  auto transpose = [&](int stage) {
    const int8_t* ws = smem + stage * kStageBytes + kABytes;
    const int c = 4 * warp + (lane & 3);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int kq = (lane >> 2) + 8 * h;
      uint32_t r[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) r[j] = lds_u32(ws + ws_off(4 * kq + j, 4 * c));
      const uint32_t lo01 = __byte_perm(r[0], r[1], 0x5140);
      const uint32_t hi01 = __byte_perm(r[0], r[1], 0x7362);
      const uint32_t lo23 = __byte_perm(r[2], r[3], 0x5140);
      const uint32_t hi23 = __byte_perm(r[2], r[3], 0x7362);
      const uint32_t col[4] = {__byte_perm(lo01, lo23, 0x5410),
                               __byte_perm(lo01, lo23, 0x7632),
                               __byte_perm(hi01, hi23, 0x5410),
                               __byte_perm(hi01, hi23, 0x7632)};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int n = 4 * c + i;
        *reinterpret_cast<uint32_t*>(wt + n * BK + 4 * (kq ^ wt_swz(n))) =
            col[i];
      }
    }
  };

  int acc[MI][NI][4];
#pragma unroll
  for (int ni = 0; ni < NI; ++ni) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int n = n0 + wn0 + ni * 8 + 2 * t + e;
      const int b = (bias != nullptr && n < N) ? bias[n] : 0;
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) acc[mi][ni][e] = acc[mi][ni][2 + e] = b;
    }
  }

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) load(s, s * BK);
    cp_async_commit();
  }
  for (int it = 0; it < nk; ++it) {
    const int s = it % kStages;
    cp_async_wait<kStages - 2>();  // stage it has landed
    __syncthreads();               // ... and stage it - 1 and wt are read
    if (it + kStages - 1 < nk)
      load((it + kStages - 1) % kStages, (it + kStages - 1) * BK);
    cp_async_commit();
    transpose(s);
    __syncthreads();
    const int8_t* xs = smem + s * kStageBytes;
#pragma unroll
    for (int ks = 0; ks < BK / 32; ++ks) {
      // a step's B fragments, then one m16 row of A fragments at a time
      // (24 fragment registers live at once spilled at the 128 that two
      // blocks an SM leave a thread)
      uint32_t b[NI][2];
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) {
        const int8_t* p = wt + (wn0 + ni * 8 + g) * BK;
        b[ni][0] = lds_u32(p + 4 * ((8 * ks + t) ^ wt_swz(g)));
        b[ni][1] = lds_u32(p + 4 * ((8 * ks + 4 + t) ^ wt_swz(g)));
      }
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
        const int8_t* p = xs + (wm0 + mi * 16 + g) * AS + 32 * ks + 4 * t;
        const uint32_t a[4] = {lds_u32(p), lds_u32(p + 8 * AS),
                               lds_u32(p + 16), lds_u32(p + 8 * AS + 16)};
#pragma unroll
        for (int ni = 0; ni < NI; ++ni) mma_s8(acc[mi][ni], a, b[ni]);
      }
    }
  }

#pragma unroll
  for (int mi = 0; mi < MI; ++mi) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm0 + mi * 16 + g + 8 * h;
      if (m >= M) continue;
      int32_t* row = out + static_cast<long long>(m) * N;
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) {
        const int n = n0 + wn0 + ni * 8 + 2 * t;  // N even: n + 1 < N too
        if (n < N)
          *reinterpret_cast<int2*>(row + n) =
              make_int2(acc[mi][ni][2 * h], acc[mi][ni][2 * h + 1]);
      }
    }
  }
}

template <int V>
int launch_v(const void* x, const void* w, const void* bias, void* out,
             int M, int N, int K, cudaStream_t stream) {
  auto kernel = mm_imma_kernel<V>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
  kernel<<<grid, kThreads, kSmem, stream>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
      static_cast<const int32_t*>(bias), static_cast<int32_t*>(out), M, N, K);
  return static_cast<int>(cudaGetLastError());
}

int launch(const void* x, const void* w, const void* bias, void* out, int M,
           int N, int K, cudaStream_t stream) {
  if (K % 16 == 0 && N % 16 == 0)
    return launch_v<16>(x, w, bias, out, M, N, K, stream);
  return launch_v<4>(x, w, bias, out, M, N, K, stream);
}

}  // namespace imma

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

extern "C" {

// Every entry takes row-major x [M,K], w [K,N] and out [M,N]; bias is [N]
// in the accumulator type (int32, or f32 for f32 and bf16), or null for
// none.  dtype 0: int8 -> int32; 1: f32 -> f32; 2: bf16 -> bf16.

// the first port's 64x64-tile kernel, any shape, dtype 0 or 2 (the form
// mm_path picks for ragged int8 and bf16; every f32 GEMM runs simt)
int matmul_ws_scalar(const void* x, const void* w, const void* bias,
                     void* out, int M, int N, int K, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M < 1 || N < 1 || K < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return scalar::launch<int8_t, int32_t, int32_t>(x, w, bias, out, M, N, K, s);
  if (dtype == 2)
    return scalar::launch<bf16, float, bf16>(x, w, bias, out, M, N, K, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// the weight-streaming form, dtype 0 or 2: M <= 16, N a multiple of 8, w
// 16-byte aligned; K sliced into `split` slices of kc rows (kc <= 512, a
// multiple of 4); part holds split·M·N partial sums when split > 1
int matmul_ws_stream(const void* x, const void* w, const void* bias,
                     void* out, void* part, int M, int N, int K, int kc,
                     int split, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M < 1 || M > 16 || N < 1 || N % 8 || K < 1 || kc < 1 || kc > 512 ||
      kc % 4 || split < 1 || static_cast<long long>(kc) * split < K ||
      static_cast<long long>(kc) * (split - 1) >= K || split > 65535 ||
      (split > 1 && part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (!aligned16(w)) return static_cast<int>(cudaErrorMisalignedAddress);
  if (dtype == 0)
    return stream::launch<int8_t>(x, w, bias, out, part, M, N, K, kc, split, s);
  if (dtype == 2)
    return stream::launch<bf16>(x, w, bias, out, part, M, N, K, kc, split, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// the wgmma form, bf16: K and N multiples of 8, x and w 16-byte aligned;
// bn (128 or 256) is the output tile's width
int matmul_ws_wgmma(const void* x, const void* w, const void* bias, void* out,
                    int M, int N, int K, int bn, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M < 1 || N < 1 || K < 1 || N % 8 || K % 8 || N / 128 >= 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (!aligned16(x) || !aligned16(w))
    return static_cast<int>(cudaErrorMisalignedAddress);
  if (bn == 128) return wg::launch<128>(x, w, bias, out, M, N, K, s);
  if (bn == 256) return wg::launch<256>(x, w, bias, out, M, N, K, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// the register-tiled f32 form, any shape: bm (128, 64, 32 or 8) names the
// tile (matmul_ws.py: SIMT_TILES); K in `split` slices of kc rows (a
// multiple of 16); part holds split·M·N partial sums when split > 1; w
// 16-byte aligned where N is a multiple of 4
int matmul_ws_simt(const void* x, const void* w, const void* bias, void* out,
                   void* part, int M, int N, int K, int kc, int split, int bm,
                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M < 1 || N < 1 || K < 1 || kc < 1 || kc % simt::BK || split < 1 ||
      static_cast<long long>(kc) * split < K ||
      static_cast<long long>(kc) * (split - 1) >= K || split > 65535 ||
      (split > 1 && part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (N % 4 == 0 && !aligned16(w))
    return static_cast<int>(cudaErrorMisalignedAddress);
  switch (bm) {
    case 128:
      return simt::launch<simt::T128>(x, w, bias, out, part, M, N, K, kc,
                                      split, s);
    case 64:
      return simt::launch<simt::T64>(x, w, bias, out, part, M, N, K, kc,
                                     split, s);
    case 32:
      return simt::launch<simt::T32>(x, w, bias, out, part, M, N, K, kc,
                                     split, s);
    case 8:
      return simt::launch<simt::T8>(x, w, bias, out, part, M, N, K, kc,
                                    split, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// the int8 tensor-core form: K and N multiples of 4, x and w 16-byte aligned
int matmul_ws_mma(const void* x, const void* w, const void* bias, void* out,
                  int M, int N, int K, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M < 1 || N < 1 || K < 1 || N % 4 || K % 4 ||
      (N + imma::BN - 1) / imma::BN > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (!aligned16(x) || !aligned16(w))
    return static_cast<int>(cudaErrorMisalignedAddress);
  return imma::launch(x, w, bias, out, M, N, K, s);
}

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
