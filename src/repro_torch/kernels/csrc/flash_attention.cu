// Causal (or full) online-softmax attention for Hopper:
// out[b,s,h,:] = softmax(q[b,s,h,:]·k[b,:,h,:]ᵀ / sqrt(D)) @ v[b,:,h,:].
//
// Replaces the Pallas TPU kernel repro.kernels.flash_attention.flash_attention
// (_flash_kernel).  q, k, v and out are [B,S,H,D] (k/v already broadcast to
// H heads), f32 or bf16, self-attention only (Sq = Sk).
//
// Kept from the TPU kernel: one block per (b·h, q tile) sweeps the KV tiles
// (a loop inside the block takes the place of the sequential nk grid axis);
// KV tiles wholly above the diagonal are skipped; q is scaled by 1/sqrt(D) in
// f32 before the product; the running max m, sum l and accumulator acc are
// f32; masked scores are -2e38; the output is acc / max(l, 1e-30), rounded to
// the input type (bf16 loads and the store go through the intrinsics).
//
// Not kept: the TPU's 512-row blocks.  A 512x128 f32 q block alone is 256 KB,
// more than a block's 227 KB of shared memory, so the tiles here are 64 q rows
// by 64 KV rows for any D <= 128 (D % 4 == 0), and any S is taken: rows and
// columns past S are zero-filled in shared memory, columns are masked, rows
// are never stored.  The TPU kernel halves its blocks until they divide S;
// that rule is not copied.  Every row's first KV tile holds column 0, which
// no mask hides, so the running max is finite from the first tile on; a row
// whose later tile is wholly masked gets p = exp(-2e38 - m) = 0 because p is
// taken against the running max, never against a fresh -2e38.
//
// What bounds it on the H100.  The work is 4·D flops per unmasked (q, k) pair,
// about 26 GFLOP per llama3.2-3b layer at S = 2048, and it reads q, k, v and
// writes out once (about 50 MB), so on the tensor cores it would be bound by
// operations (0.026 ms at 989 TFLOP/s).  This first kernel uses no tensor
// cores: both products are scalar f32 FMAs from shared memory (67 TFLOP/s
// peak), with float4 shared loads (2 FMAs per loaded float in q·kᵀ, 2.7 in
// p·v) and padded rows so that a quarter-warp's loads hit distinct banks.
// Its ~121 KB of shared memory at D = 128 allows one block (8 warps) per SM.
// The redesign for speed is wgmma with TMA-fed K/V rings; keeping p in bf16
// for the p·v product there would change the numbers against the reference,
// whose p·v product is f32.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64, BK = 64, kThreads = 256, DMAX = 128;
constexpr int PS = BK + 16;  // p tile row stride: the two half-warps' rows
                             // land 16 banks apart
constexpr float kNegInf = -2.0e38f;

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// rows [row0, row0 + 64) of one (b, h) slice into dst (row stride dst_stride),
// each element times `scale`; rows at or past S are zero.
template <typename T>
__device__ void load_tile(float* dst, int dst_stride, const T* src,
                          long long row_stride, int row0, int S, int D,
                          float scale) {
  for (int i = threadIdx.x; i < BQ * D; i += kThreads) {
    const int r = i / D, c = i % D;
    float x = 0.f;
    if (row0 + r < S) x = load_f32(src + (row0 + r) * row_stride + c) * scale;
    dst[r * dst_stride + c] = x;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int S,
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
    T* o = out + base + row * row_stride;
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      const int c = 4 * tx + 64 * jj;
      if (c >= D) continue;
      store(o + c, acc[i][jj].x / den);
      store(o + c + 1, acc[i][jj].y / den);
      store(o + c + 2, acc[i][jj].z / den);
      store(o + c + 3, acc[i][jj].w / den);
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int S, int H, int D, int causal, float scale, cudaStream_t stream) {
  const int smem = static_cast<int>(sizeof(float)) *
                   (BQ * (D + 4) + BK * (D + 4) + BK * D + BQ * PS);
  auto kernel = flash_attention_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((S + BQ - 1) / BQ, B * H);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), S, H, D, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dtype 0: f32; dtype 1: bf16.  D must be a multiple of 4, at most 128.
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* out, int B, int S, int H, int D, int causal,
                           float scale, int dtype, void* stream) {
  if (D < 4 || D > DMAX || D % 4 || B * H > 65535 || S < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k, v, out, B, S, H, D, causal, scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, out, B, S, H, D, causal, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
