// Bias-preloaded GEMM for Hopper: out[M,N] = x[M,K] @ w[K,N] + bias[N].
//
// Replaces the Pallas TPU kernel repro.kernels.matmul_ws.matmul_ws
// (_mm_kernel): int8 x int8 -> int32, f32 -> f32 (no TF32), and bf16 x bf16
// with f32 products and sums, plus an f32 bias, rounded once to bf16 (the
// reference's ops.matmul_ws casts its f32 result back to the operand type).
// Kept from the TPU kernel: the accumulators start at the bias (its preload
// at K block 0), and the contraction runs as a loop inside a block.  The TPU
// grid order (n, k, m), which kept a weight block resident across a
// sequential grid, is not kept: blocks here run in parallel.  x and w are
// row-major; w is [K,N] as the model stores it and is never repacked.
//
// Three forms, picked on the host by geometry alone (kernels/matmul_ws.py,
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
// scalar (f32; int8 at M > 16; bf16 with K or N not a multiple of 8, whose
//   rows TMA cannot address).  The first port's kernel: one block per 64x64
//   output tile, 32-deep slices of x and w staged in shared memory, a 4x4
//   register tile of outputs a thread, scalar FMAs (no tensor cores).
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

// out = bias + the K slices' partial sums, added in slice order
template <typename Tin>
__global__ void __launch_bounds__(256)
mm_split_reduce_kernel(const typename Traits<Tin>::Acc* __restrict__ part,
                       const typename Traits<Tin>::Acc* __restrict__ bias,
                       typename Traits<Tin>::Out* __restrict__ out, int M,
                       int N, int split) {
  using Acc = typename Traits<Tin>::Acc;
  const long long mn = static_cast<long long>(M) * N;
  const long long i = static_cast<long long>(blockIdx.x) * 256 + threadIdx.x;
  if (i >= mn) return;
  Acc v = bias != nullptr ? bias[i % N] : Acc(0);
  for (int s = 0; s < split; ++s) v += part[s * mn + i];
  out[i] = to_out<typename Traits<Tin>::Out>(v);
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
  mm_split_reduce_kernel<Tin><<<static_cast<unsigned>((mn + 255) / 256), 256,
                                0, stream>>>(
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

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

extern "C" {

// Every entry takes row-major x [M,K], w [K,N] and out [M,N]; bias is [N]
// in the accumulator type (int32, or f32 for f32 and bf16), or null for
// none.  dtype 0: int8 -> int32; 1: f32 -> f32; 2: bf16 -> bf16.

// the first port's 64x64-tile kernel, any shape, dtype 0, 1 or 2
int matmul_ws_scalar(const void* x, const void* w, const void* bias,
                     void* out, int M, int N, int K, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M < 1 || N < 1 || K < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return scalar::launch<int8_t, int32_t, int32_t>(x, w, bias, out, M, N, K, s);
  if (dtype == 1)
    return scalar::launch<float, float, float>(x, w, bias, out, M, N, K, s);
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

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
