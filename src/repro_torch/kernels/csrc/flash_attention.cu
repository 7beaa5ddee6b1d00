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
// bf16, D in {16, 32, 64, 128}: tensor cores (wgmma) fed by TMA.
//   * Work split: one block of 288 threads per (b·h, 128-row q tile): two
//     consumer warpgroups of 64 q rows each and one producer warp.  q tiles
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
// f32, D a multiple of 4 up to 128: the first port's scalar kernel, kept as
// it was and still scalar.  The served model computes in bf16 and never
// reaches it; f32 models (the checks, the reduced model) do.  Its tiles are 64 q rows by 64 KV rows in shared memory, q scaled
// in f32 before the product, and both products are scalar f32 FMAs from
// shared memory (67 TFLOP/s peak, no tensor cores), with float4 shared loads
// and padded rows so that a quarter-warp's loads hit distinct banks.
#include <cstdint>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -2.0e38f;

// ------------------------------------------------------------------------
// f32: the scalar kernel

namespace scalar {

constexpr int BQ = 64, BK = 64, kThreads = 256, DMAX = 128;
constexpr int PS = BK + 16;  // p tile row stride: the two half-warps' rows
                             // land 16 banks apart

// rows [row0, row0 + 64) of one (b, h) slice into dst (row stride dst_stride),
// each element times `scale`; rows at or past S are zero.
__device__ void load_tile(float* dst, int dst_stride, const float* src,
                          long long row_stride, int row0, int S, int D,
                          float scale) {
  for (int i = threadIdx.x; i < BQ * D; i += kThreads) {
    const int r = i / D, c = i % D;
    float x = 0.f;
    if (row0 + r < S) x = src[(row0 + r) * row_stride + c] * scale;
    dst[r * dst_stride + c] = x;
  }
}

__global__ void __launch_bounds__(kThreads)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out, int S,
                 int H, int D, int causal, float scale) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int QS = D + 4;            // q/k row stride, 16-byte aligned
  float* qs = smem;                // [BQ][QS]
  float* ks = qs + BQ * QS;        // [BK][QS]
  float* vs = ks + BK * QS;        // [BK][D]
  float* ps = vs + BK * D;         // [BQ][PS]

  const int q0 = blockIdx.x * BQ;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const long long row_stride = static_cast<long long>(H) * D;
  const long long base = static_cast<long long>(b) * S * row_stride +
                         static_cast<long long>(h) * D;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  // a thread owns rows ty + 16i (i < 4) in both products; in q·kᵀ the
  // columns tx + 16j (j < 4), in p·v the float4 columns 4tx + 64jj (jj < 2)

  load_tile(qs, QS, q + base, row_stride, q0, S, D, scale);

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
    __syncthreads();  // the previous tile's p·v is done with ks, vs, ps
    load_tile(ks, QS, k + base, row_stride, k0, S, D, 1.f);
    load_tile(vs, D, v + base, row_stride, k0, S, D, 1.f);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d = 0; d < D; d += 4) {
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
          w[jj] = c < D ? *reinterpret_cast<const float4*>(vs + (kk + t) * D + c)
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
    float* o = out + base + row * row_stride;
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      const int c = 4 * tx + 64 * jj;
      if (c >= D) continue;
      o[c] = acc[i][jj].x / den;
      o[c + 1] = acc[i][jj].y / den;
      o[c + 2] = acc[i][jj].z / den;
      o[c + 3] = acc[i][jj].w / den;
    }
  }
}

int launch_f32(const void* q, const void* k, const void* v, void* out, int B,
               int S, int H, int D, int causal, float scale,
               cudaStream_t stream) {
  const int smem = static_cast<int>(sizeof(float)) *
                   (BQ * (D + 4) + BK * (D + 4) + BK * D + BQ * PS);
  auto kernel = flash_f32_kernel;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((S + BQ - 1) / BQ, B * H);
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

constexpr int kRows = 64;       // q rows per consumer warpgroup; KV tile rows
constexpr int kConsumers = 2;   // consumer warpgroups
constexpr int kThreads = 128 * kConsumers + 32;  // and one producer warp
constexpr int kStages = 4;      // K/V ring depth

template <int D>
struct Tile {
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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// returns once the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// box (d0, h, row0, b) of `map` into shared memory at dst; completes on bar
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int d0, int h,
                                         int row0, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(d0), "r"(h),
      "r"(row0), "r"(b)
      : "memory");
}

// wgmma shared-memory matrix descriptor: start address, leading and stride
// byte offsets (16-byte units), swizzle code in bits 62-63
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint64_t swizzle) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 | swizzle << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keeps the compiler from moving reads or writes of an accumulator across
// the wgmma that writes it asynchronously
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// D[64x64] (+)= A[64x16] * B[16x64], both K-major in shared memory;
// D is overwritten where scale_d is 0
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, "
      "%13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
      "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),
      "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),
      "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]),
      "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D[64x16] += A[64x16] (registers) * B[16x16] (shared memory, MN-major)
__device__ __forceinline__ void wgmma_rs_n16(float (&d)[8], const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
      "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64x32] += A[64x16] (registers) * B[16x32] (shared memory, MN-major)
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16], const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, "
      "%13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
      "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64x64] += A[64x16] (registers) * B[16x64] (shared memory, MN-major)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, "
      "%13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
      "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),
      "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),
      "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]),
      "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64x128] += A[64x16] (registers) * B[16x128] (shared memory, MN-major)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, "
      "%13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, "
      "%35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, "
      "%46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
      "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),
      "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),
      "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]),
      "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
      "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
      "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
      "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]),
      "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
      "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]),
      "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
      "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t db) {
  if constexpr (N == 16) wgmma_rs_n16(d, a, db);
  else if constexpr (N == 32) wgmma_rs_n32(d, a, db);
  else if constexpr (N == 64) wgmma_rs_n64(d, a, db);
  else wgmma_rs_n128(d, a, db);
}

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
__global__ void __launch_bounds__(kThreads, 1)
flash_bf16_kernel(const __grid_constant__ CUtensorMap qmap,
                  const __grid_constant__ CUtensorMap kmap,
                  const __grid_constant__ CUtensorMap vmap,
                  __nv_bfloat16* __restrict__ out, int S, int H, int causal,
                  float scale) {
  using T = Tile<D>;
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
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == kConsumers) {
    // producer: one thread issues every load
    if (threadIdx.x % 128 != 0) return;
    mbar_expect_tx(q_full, kConsumers * T::kBytes);
    for (int w = 0; w < kConsumers; ++w)
      for (int c = 0; c < T::kBoxes; ++c)
        tma_load(q_tile(w) + c * T::kBoxBytes, &qmap, q_full,
                 c * T::kBoxCols, h, q0 + w * kRows, b);
    const int n = n_tiles(q0 + (kConsumers - 1) * kRows);
    for (int it = 0; it < n; ++it) {
      const int s = it % kStages;
      if (it >= kStages) mbar_wait(empty(s), ((it / kStages) - 1) & 1);
      mbar_expect_tx(full(s), 2 * T::kBytes);
      for (int c = 0; c < T::kBoxes; ++c) {
        tma_load(k_tile(s) + c * T::kBoxBytes, &kmap, full(s),
                 c * T::kBoxCols, h, it * kRows, b);
        tma_load(v_tile(s) + c * T::kBoxBytes, &vmap, full(s),
                 c * T::kBoxCols, h, it * kRows, b);
      }
    }
    return;
  }

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
    wgmma_wait_all();
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
    // three bf16 terms
    uint32_t p[3][4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        split3(sc[8 * kk + 2 * j], sc[8 * kk + 2 * j + 1], p[0][kk][j],
               p[1][kk][j], p[2][kk][j]);

    // V is [keys][D], MN-major for the product: 8-key groups 8 box rows
    // apart, the D = 128 tile's second 64 columns one box further on
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t dv = make_desc(v_tile(s) + kk * 16 * T::kRowBytes,
                                    T::kBoxBytes, kSbo, T::kSwizzle);
#pragma unroll
      for (int term = 0; term < 3; ++term) wgmma_rs<D>(o, p[term][kk], dv);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o);
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

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled is a driver-API function; the runtime hands out its
// address, so the library needs no link against libcuda
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
#if CUDART_VERSION >= 12050
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault, &found) !=
            cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      p = nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault) != cudaSuccess)
      p = nullptr;
#endif
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
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
  kernel<<<grid, kThreads, Tile<D>::kSmem, stream>>>(
      qm, km, vm, static_cast<__nv_bfloat16*>(out), S, H, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

}  // namespace

extern "C" {

// dtype 0: f32, the scalar kernel, D a multiple of 4 up to 128.
// dtype 1: bf16, the tensor-core kernel, D in {16, 32, 64, 128}; q, k, v
// and out 16-byte aligned.
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* out, int B, int S, int H, int D, int causal,
                           float scale, int dtype, void* stream) {
  if (B < 1 || H < 1 || S < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (D < 4 || D > scalar::DMAX || D % 4 || B * H > 65535)
      return static_cast<int>(cudaErrorInvalidValue);
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
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
