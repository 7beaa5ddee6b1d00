// Causal (or full) online-softmax attention for Hopper:
// out[b,s,h,:] = softmax(q[b,s,h,:]·k[b,:,h,:]ᵀ / sqrt(D)) @ v[b,:,h,:].
//
// Replaces the Pallas TPU kernel repro.kernels.flash_attention.flash_attention
// (_flash_kernel).  q, k, v and out are [B,S,H,D] (k/v already broadcast to
// H heads), bf16 or f32, self-attention only (Sq = Sk).  Kept from the TPU
// kernel in both variants below: one block per (b·h, q tile) sweeps the KV
// tiles (a loop inside the block takes the place of the sequential nk grid
// axis); KV tiles wholly above the diagonal are skipped; the running max m,
// sum l and accumulator acc are f32; masked scores are -2e38; p is taken
// against the running max; the output is acc / max(l, 1e-30), rounded once to
// the input type.  The TPU's 512-row blocks are not kept (a 512x128 f32 q
// block alone is 256 KB, more than a block's 227 KB of shared memory), and
// any S is taken: rows past S are zero-filled, their columns masked, and they
// are never stored.  Every row's first KV tile holds column 0, which no mask
// hides, so the running max is finite from the first tile on and a later
// wholly masked tile adds exp(-2e38 - m) = 0.
//
// What bounds it on the H100: the work is 4·D flops per unmasked (q, k) pair
// (26 GFLOP per llama3.2-3b layer at S = 2048) against about 50 MB read and
// written, so it is bound by operations: 0.026 ms at 989 TFLOP/s bf16.
//
// bf16, D in {16, 32, 64, 128, 256}: tensor cores (wgmma) fed by TMA.  The
// wrapper zero-pads any other bf16 D ≤ 256 up to the next of these widths
// and passes the scale of the true D: the zero columns add exact zeros to
// q·kᵀ and give zero output columns, which it slices off.
//   * Work split: one block of 288 threads per (b·h, 128-row q tile): two
//     consumer warpgroups of 64 q rows each and one producer warp.  At
//     D = 256 the producer is a whole warpgroup (384 threads) that gives its
//     registers to the consumers with setmaxnreg (40 / 232), since a
//     consumer holds a 64 × 256 f32 accumulator (128 registers a thread);
//     it takes p·v one k-step's three terms at a time, and its ring is 2
//     stages deep (q 64 KB and two K/V stages of 64 KB).  q tiles
//     run in reverse order (blockIdx.y), the longest causal sweeps first, so
//     the tail of the grid is short.
//   * TMA: one rank-4 tensor map per operand over the [B,S,H,D] tensor, box
//     (min(D,64), 1, 64, 1), so rows past S of a (b, h) slice come back
//     zero-filled instead of reading the next batch.  A box row is one
//     swizzle span (128/64/32 bytes at D = 128 or 64 / 32 / 16); a D = 128
//     tile is two boxes, and the wgmma k-steps walk across both.  The
//     producer loads q once and streams K and V through a ring of kStages
//     64-row tiles, each stage signalled full by an mbarrier with its byte
//     count and released by one arrival of each consumer warpgroup.
//   * S = Q·Kᵀ: wgmma m64n64k16, q and k both K-major in shared memory, f32
//     accumulator.  The scale 1/sqrt(D) multiplies the f32 scores after the
//     product: rounding q·scale to bf16 first would add error, while this
//     order differs from the reference's (f32 q times scale, then the dot)
//     only in f32 rounding.
//   * Softmax in registers: a row's 64 scores sit in four lanes of a quad,
//     whose two xor-shuffles give the row max; p = expf(s - m) (precise expf,
//     no fast-math); l is summed from the unrounded f32 p; alpha rescales the
//     accumulator.
//   * O += P·V with p in three bf16 terms: p1 = bf16(p), p2 = bf16(p - p1),
//     p3 = bf16(p - p1 - p2).  The reference's p·v product is f32; one bf16
//     term (the textbook FA2/FA3 kernel) moves outputs past one bf16 ulp of
//     it (tests/test_torch_flash.py emulates both), while three terms carry
//     p to f32 precision.  Each term is a wgmma m64nDk16 with A from
//     registers (the S accumulator fragment is the A fragment of P·V) and V
//     MN-major from shared memory through the transpose bit, into one f32
//     accumulator.  That is 8·D tensor flops per pair, twice the operation
//     count above.
//   * The output is written from registers as bf16 pairs.
//
// f32, any D a multiple of 4 (the wrapper zero-pads other D up to one, and
// runs bf16 D > 256 on f32 copies of q, k and v): the first port's scalar
// kernel, still scalar.  The served model computes in bf16 and never
// reaches it; f32 models (the checks, the reduced model) do.  Its tiles are
// 64 q rows by 64 KV rows in shared memory, q scaled in f32 before the
// product, and both products are scalar f32 FMAs from shared memory
// (67 TFLOP/s peak, no tensor cores), with float4 shared loads and padded
// rows so that a quarter-warp's loads hit distinct banks.  A block writes
// at most 128 output columns (grid.z slices a wider head) and takes q·kᵀ
// in 128-column passes, so shared memory stays at the D = 128 size for any
// D; a head wider than 128 recomputes q·kᵀ once for each output slice.
// B·H is on grid.x, which takes up to 2^31 − 1 blocks.
#include <cstdint>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper_common.cuh"

namespace {

constexpr float kNegInf = -2.0e38f;

// ------------------------------------------------------------------------
// f32: the scalar kernel

namespace scalar {

constexpr int BQ = 64, BK = 64, kThreads = 256;
constexpr int DC = 128;      // head-dim columns of q·kᵀ per pass and of the
                             // output per block
constexpr int PS = BK + 16;  // p tile row stride: the two half-warps' rows
                             // land 16 banks apart

// rows [row0, row0 + 64) and columns [c0, c0 + w) of one (b, h) slice into
// dst (row stride dst_stride), each element times `scale`; rows at or past S
// are zero.
__device__ void load_tile(float* dst, int dst_stride, const float* src,
                          long long row_stride, int row0, int S, int c0,
                          int w, float scale) {
  for (int i = threadIdx.x; i < BQ * w; i += kThreads) {
    const int r = i / w, c = i % w;
    float x = 0.f;
    if (row0 + r < S) x = src[(row0 + r) * row_stride + c0 + c] * scale;
    dst[r * dst_stride + c] = x;
  }
}

// shared floats of one block at head dim D
__host__ __device__ constexpr int smem_floats(int D) {
  return BQ * ((D < DC ? D : DC) + 4) * 2 + BK * (D < DC ? D : DC) + BQ * PS;
}

__global__ void __launch_bounds__(kThreads)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out, int S,
                 int H, int D, int causal, float scale) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int KW = min(D, DC);       // q/k columns per pass
  const int QS = KW + 4;           // q/k row stride, 16-byte aligned
  const int c0 = blockIdx.z * DC;  // this block's output columns
  const int VW = min(D - c0, DC);
  float* qs = smem;                // [BQ][QS]
  float* ks = qs + BQ * QS;        // [BK][QS]
  float* vs = ks + BK * QS;        // [BK][VW]
  float* ps = vs + BK * KW;        // [BQ][PS]

  const int q0 = blockIdx.y * BQ;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const long long row_stride = static_cast<long long>(H) * D;
  const long long base = static_cast<long long>(b) * S * row_stride +
                         static_cast<long long>(h) * D;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  // a thread owns rows ty + 16i (i < 4) in both products; in q·kᵀ the
  // columns tx + 16j (j < 4), in p·v the float4 columns 4tx + 64jj (jj < 2)

  // one pass holds all of q for D ≤ 128; a wider head is reloaded in DC
  // column slices for each KV tile
  const bool one_pass = D <= DC;
  if (one_pass) load_tile(qs, QS, q + base, row_stride, q0, S, 0, D, scale);

  float m[4], l[4];
  float4 acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
    acc[i][0] = acc[i][1] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  const int k_end = causal ? min(S, q0 + BQ) : S;  // skip tiles above the
  for (int k0 = 0; k0 < k_end; k0 += BK) {          // diagonal
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d0 = 0; d0 < D; d0 += DC) {
      const int w = min(D - d0, DC);
      __syncthreads();  // the previous pass and p·v are done with the tiles
      if (!one_pass)
        load_tile(qs, QS, q + base, row_stride, q0, S, d0, w, scale);
      load_tile(ks, QS, k + base, row_stride, k0, S, d0, w, 1.f);
      if (d0 == 0) load_tile(vs, VW, v + base, row_stride, k0, S, c0, VW, 1.f);
      __syncthreads();
      for (int d = 0; d < w; d += 4) {
        float4 a[4], c[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          a[i] = *reinterpret_cast<const float4*>(qs + (ty + 16 * i) * QS + d);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          c[j] = *reinterpret_cast<const float4*>(ks + (tx + 16 * j) * QS + d);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            s[i][j] = fmaf(a[i].x, c[j].x, s[i][j]);
            s[i][j] = fmaf(a[i].y, c[j].y, s[i][j]);
            s[i][j] = fmaf(a[i].z, c[j].z, s[i][j]);
            s[i][j] = fmaf(a[i].w, c[j].w, s[i][j]);
          }
      }
    }

    // online softmax; a row's 64 columns sit in the 16 lanes of one
    // half-warp, whose xor-butterflies give every lane the same value
    float alpha[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        if (kpos >= S || (causal && kpos > qpos)) s[i][j] = kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 1; off < 16; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      alpha[i] = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        ps[(ty + 16 * i) * PS + tx + 16 * j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 1; off < 16; off <<= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = alpha[i] * l[i] + sum;
      m[i] = m_new;
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        acc[i][jj].x *= alpha[i];
        acc[i][jj].y *= alpha[i];
        acc[i][jj].z *= alpha[i];
        acc[i][jj].w *= alpha[i];
      }
    for (int kk = 0; kk < BK; kk += 4) {
      float4 p4[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        p4[i] = *reinterpret_cast<const float4*>(ps + (ty + 16 * i) * PS + kk);
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        float4 w[2];
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const int c = 4 * tx + 64 * jj;
          w[jj] = c < VW
                      ? *reinterpret_cast<const float4*>(vs + (kk + t) * VW + c)
                      : make_float4(0.f, 0.f, 0.f, 0.f);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = t == 0 ? p4[i].x : t == 1 ? p4[i].y
                        : t == 2 ? p4[i].z : p4[i].w;
#pragma unroll
          for (int jj = 0; jj < 2; ++jj) {
            acc[i][jj].x = fmaf(p, w[jj].x, acc[i][jj].x);
            acc[i][jj].y = fmaf(p, w[jj].y, acc[i][jj].y);
            acc[i][jj].z = fmaf(p, w[jj].z, acc[i][jj].z);
            acc[i][jj].w = fmaf(p, w[jj].w, acc[i][jj].w);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= S) continue;
    const float den = fmaxf(l[i], 1e-30f);
    float* o = out + base + row * row_stride + c0;
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      const int c = 4 * tx + 64 * jj;
      if (c >= VW) continue;
      o[c] = acc[i][jj].x / den;
      o[c + 1] = acc[i][jj].y / den;
      o[c + 2] = acc[i][jj].z / den;
      o[c + 3] = acc[i][jj].w / den;
    }
  }
}

// B·H on grid.x (up to 2^31 − 1), q tiles on grid.y, output column slices
// on grid.z
int launch_f32(const void* q, const void* k, const void* v, void* out, int B,
               int S, int H, int D, int causal, float scale,
               cudaStream_t stream) {
  const long long bh = static_cast<long long>(B) * H;
  const int q_tiles = (S + BQ - 1) / BQ;
  if (bh > 0x7fffffffLL || q_tiles > 65535 || D % 4)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = static_cast<int>(sizeof(float)) * smem_floats(D);
  auto kernel = flash_f32_kernel;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(static_cast<unsigned>(bh), q_tiles, (D + DC - 1) / DC);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), S, H, D, causal,
      scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace scalar

// ------------------------------------------------------------------------
// bf16: wgmma fed by TMA

namespace tc {

using namespace hopper;

constexpr int kRows = 64;       // q rows per consumer warpgroup; KV tile rows
constexpr int kConsumers = 2;   // consumer warpgroups

template <int D>
struct Tile {
  // D = 256: the producer is a whole warpgroup, so that setmaxnreg can move
  // its registers to the consumers' 128 accumulator registers, and the ring
  // is 2 deep (two q tiles and two K/V stages are 192 KB)
  static constexpr bool kWide = D == 256;
  static constexpr int kThreads = 128 * kConsumers + (kWide ? 128 : 32);
  static constexpr int kStages = kWide ? 2 : 4;        // K/V ring depth
  static constexpr int kBoxCols = D < 64 ? D : 64;     // one swizzle span
  static constexpr int kBoxes = D / kBoxCols;          // boxes per tile
  static constexpr int kRowBytes = 2 * kBoxCols;       // 32, 64 or 128
  static constexpr int kBoxBytes = kRows * kRowBytes;
  static constexpr int kBytes = kRows * D * 2;         // one q, k or v tile
  // the wgmma descriptor's swizzle code: 1 = 128 B, 2 = 64 B, 3 = 32 B
  static constexpr uint64_t kSwizzle = kRowBytes == 128 ? 1
                                       : kRowBytes == 64 ? 2 : 3;
  // q tiles, then kStages (k, v) pairs, then the mbarriers
  static constexpr int kBarOffset = (kConsumers + 2 * kStages) * kBytes;
  static constexpr int kSmem = 1024 + kBarOffset + 8 * (2 * kStages + 1);
};

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// (x0, x1) as three bf16 pairs whose sum carries them to f32 precision:
// t[0] = bf16(x), t[1] = bf16(x - t[0]), t[2] = bf16(x - t[0] - t[1]); each
// difference is exact in f32
__device__ __forceinline__ void split3(float x0, float x1, uint32_t& t0,
                                       uint32_t& t1, uint32_t& t2) {
  const __nv_bfloat162 h0 = __floats2bfloat162_rn(x0, x1);
  const float2 f0 = __bfloat1622float2(h0);
  const float y0 = x0 - f0.x, y1 = x1 - f0.y;
  const __nv_bfloat162 h1 = __floats2bfloat162_rn(y0, y1);
  const float2 f1 = __bfloat1622float2(h1);
  t0 = bf16x2_bits(h0);
  t1 = bf16x2_bits(h1);
  t2 = bf16x2_bits(__floats2bfloat162_rn(y0 - f1.x, y1 - f1.y));
}

template <int D>
__global__ void __launch_bounds__(Tile<D>::kThreads, 1)
flash_bf16_kernel(const __grid_constant__ CUtensorMap qmap,
                  const __grid_constant__ CUtensorMap kmap,
                  const __grid_constant__ CUtensorMap vmap,
                  __nv_bfloat16* __restrict__ out, int S, int H, int causal,
                  float scale) {
  using T = Tile<D>;
  constexpr int kStages = T::kStages;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  // swizzled tiles need 1024-byte alignment of the shared address itself
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t bars = base + T::kBarOffset;  // full[kStages], empty[kStages],
  const uint32_t q_full = bars + 16 * kStages;  // then q's
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (kStages + s); };
  auto q_tile = [&](int wg) { return base + wg * T::kBytes; };
  auto k_tile = [&](int s) { return base + (kConsumers + 2 * s) * T::kBytes; };
  auto v_tile = [&](int s) {
    return base + (kConsumers + 2 * s + 1) * T::kBytes;
  };

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kConsumers * kRows;
  const int n_all = (S + kRows - 1) / kRows;
  // KV tiles a warpgroup whose first row is qlo needs: up to its diagonal
  auto n_tiles = [&](int qlo) {
    return causal ? min(n_all, qlo / kRows + 1) : n_all;
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), kConsumers);
    }
    mbar_init(q_full, 1);
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == kConsumers) {
    // producer: one thread issues every load
    if constexpr (T::kWide) regs_dealloc<40>();
    if (threadIdx.x % 128 != 0) return;
    mbar_expect_tx(q_full, kConsumers * T::kBytes);
    for (int w = 0; w < kConsumers; ++w)
      for (int c = 0; c < T::kBoxes; ++c)
        tma_load_4d(q_tile(w) + c * T::kBoxBytes, &qmap, q_full,
                 c * T::kBoxCols, h, q0 + w * kRows, b);
    const int n = n_tiles(q0 + (kConsumers - 1) * kRows);
    for (int it = 0; it < n; ++it) {
      const int s = it % kStages;
      if (it >= kStages) mbar_wait(empty(s), ((it / kStages) - 1) & 1);
      mbar_expect_tx(full(s), 2 * T::kBytes);
      for (int c = 0; c < T::kBoxes; ++c) {
        tma_load_4d(k_tile(s) + c * T::kBoxBytes, &kmap, full(s),
                 c * T::kBoxCols, h, it * kRows, b);
        tma_load_4d(v_tile(s) + c * T::kBoxBytes, &vmap, full(s),
                 c * T::kBoxCols, h, it * kRows, b);
      }
    }
    return;
  }

  if constexpr (T::kWide) regs_alloc<232>();
  // consumer warpgroup wg: q rows [qlo, qlo + 64).  This thread holds rows
  // r0 and r0 + 8 of them; in every n8 column chunk j of an accumulator,
  // element 4j + e is (row r0 + 8·(e / 2), column 8j + cq + e % 2).
  const int t = threadIdx.x % 128, lane = t % 32;
  const int r0 = 16 * (t / 32) + lane / 4, cq = 2 * (lane % 4);
  const int qlo = q0 + wg * kRows;
  const int n = n_tiles(qlo);

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  // K-major descriptors (q, k): 8-row groups 8 box rows apart; a k-step of
  // 16 columns is 32 bytes along a box row, and D = 128 spans two boxes
  constexpr uint32_t kSbo = 8 * T::kRowBytes;
  auto kmajor = [&](uint32_t tile, int kk) {
    constexpr int kSteps = T::kBoxCols / 16;  // k-steps per box
    return make_desc(tile + (kk / kSteps) * T::kBoxBytes + (kk % kSteps) * 32,
                     16, kSbo, T::kSwizzle);
  };

  mbar_wait(q_full, 0);
  __syncwarp();
  for (int it = 0; it < n; ++it) {
    const int s = it % kStages;
    mbar_wait(full(s), (it / kStages) & 1);
    __syncwarp();

    float sc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64(sc, kmajor(q_tile(wg), kk), kmajor(k_tile(s), kk), kk);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);

    // scale, mask, and the new running max of rows r0 and r0 + 8
    const int k0 = it * kRows;
    const bool edge = k0 + kRows > S || (causal && k0 + kRows - 1 > qlo);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      float x = sc[i] * scale;
      if (edge) {
        const int kpos = k0 + 8 * (i / 4) + cq + i % 2;
        const int qpos = qlo + r0 + 8 * ((i / 2) % 2);
        if (kpos >= S || (causal && kpos > qpos)) x = kNegInf;
      }
      sc[i] = x;
      mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], x);
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = expf(m[r] - mx[r]);
      m[r] = mx[r];
    }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      sc[i] = expf(sc[i] - m[(i / 2) % 2]);
      sum[(i / 2) % 2] += sc[i];
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = alpha[r] * l[r] + sum[r];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i / 2) % 2];

    // P's A fragment for keys [16kk, 16kk + 16) is sc[8kk .. 8kk + 8), in
    // three bf16 terms.  V is [keys][D], MN-major for the product: 8-key
    // groups 8 box rows apart, each further 64 columns one box further on
    auto v_desc = [&](int kk) {
      return make_desc(v_tile(s) + kk * 16 * T::kRowBytes, T::kBoxBytes, kSbo,
                       T::kSwizzle);
    };
    if constexpr (T::kWide) {
      // beside 128 accumulator registers, one k-step's terms at a time
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t p[3][4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          split3(sc[8 * kk + 2 * j], sc[8 * kk + 2 * j + 1], p[0][j], p[1][j],
                 p[2][j]);
        wgmma_fence();
#pragma unroll
        for (int term = 0; term < 3; ++term) wgmma_rs<D>(o, p[term], v_desc(kk));
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(o);
      }
    } else {
      uint32_t p[3][4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          split3(sc[8 * kk + 2 * j], sc[8 * kk + 2 * j + 1], p[0][kk][j],
                 p[1][kk][j], p[2][kk][j]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int term = 0; term < 3; ++term)
          wgmma_rs<D>(o, p[term][kk], v_desc(kk));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
    }
    if (t == 0) mbar_arrive(empty(s));
    __syncwarp();
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = qlo + r0 + 8 * r;
    if (row >= S) continue;
    const float den = fmaxf(l[r], 1e-30f);
    __nv_bfloat16* dst =
        out + ((static_cast<long long>(b) * S + row) * H + h) * D + cq;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) = __floats2bfloat162_rn(
          o[4 * j + 2 * r] / den, o[4 * j + 2 * r + 1] / den);
  }
}

// a rank-4 map over a [B,S,H,D] bf16 tensor, box (min(D,64), 1, 64, 1)
template <int D>
bool make_map(CUtensorMap* map, const void* ptr, int B, int S, int H) {
  using T = Tile<D>;
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t row = 2ull * D;  // bytes
  const cuuint64_t strides[3] = {row, row * H, row * H * S};
  const cuuint32_t box[4] = {T::kBoxCols, 1, kRows, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swizzle =
      T::kRowBytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
      : T::kRowBytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                           : CU_TENSOR_MAP_SWIZZLE_32B;
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims, strides, box, step,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int S, int H, int causal, float scale, cudaStream_t stream) {
  CUtensorMap qm, km, vm;
  if (!make_map<D>(&qm, q, B, S, H) || !make_map<D>(&km, k, B, S, H) ||
      !make_map<D>(&vm, v, B, S, H))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = flash_bf16_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Tile<D>::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B * H, (S + kConsumers * kRows - 1) / (kConsumers * kRows));
  kernel<<<grid, Tile<D>::kThreads, Tile<D>::kSmem, stream>>>(
      qm, km, vm, static_cast<__nv_bfloat16*>(out), S, H, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

}  // namespace

extern "C" {

// dtype 0: f32, the scalar kernel, D a multiple of 4.
// dtype 1: bf16, the tensor-core kernel, D in {16, 32, 64, 128, 256}; q, k,
// v and out 16-byte aligned.  The wrapper pads other head dims up to these.
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* out, int B, int S, int H, int D, int causal,
                           float scale, int dtype, void* stream) {
  if (B < 1 || H < 1 || S < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (D < 4) return static_cast<int>(cudaErrorInvalidValue);
    return scalar::launch_f32(q, k, v, out, B, S, H, D, causal, scale, s);
  }
  if (dtype == 1) {
    if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
         reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(out)) %
        16)
      return static_cast<int>(cudaErrorMisalignedAddress);
    switch (D) {
      case 16: return tc::launch<16>(q, k, v, out, B, S, H, causal, scale, s);
      case 32: return tc::launch<32>(q, k, v, out, B, S, H, causal, scale, s);
      case 64: return tc::launch<64>(q, k, v, out, B, S, H, causal, scale, s);
      case 128:
        return tc::launch<128>(q, k, v, out, B, S, H, causal, scale, s);
      case 256:
        return tc::launch<256>(q, k, v, out, B, S, H, causal, scale, s);
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
