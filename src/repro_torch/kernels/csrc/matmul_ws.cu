// Bias-preloaded blocked GEMM for Hopper: out[M,N] = x[M,K] @ w[K,N] + bias[N].
//
// Replaces the Pallas TPU kernel repro.kernels.matmul_ws.matmul_ws
// (_mm_kernel): int8 x int8 -> int32, or f32 -> f32 (scalar FMAs, no TF32).
//
// Design.  One block per 64x64 output tile; the contraction runs as a loop
// inside the block over 32-deep slices of x and w staged in shared memory,
// and the accumulators start as the bias (the TPU kernel's preload at K block
// 0).  The TPU grid order (n, k, m) existed to keep a weight block resident
// across a sequential grid; blocks here are independent, so it is not kept.
// Each of the 256 threads holds a 4x4 register tile of outputs.
//
// What bounds it on the H100.  On the main path it runs the dense heads:
// M is the serving batch (8), so the weights dominate the bytes and the
// kernel is bound by bytes (w read once at 3.35 TB/s).  Rows beyond M are
// zero-filled in shared memory and never stored.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 64, BN = 64, BK = 32, TM = 4, TN = 4;
constexpr int kThreads = (BM / TM) * (BN / TN);  // 256

template <typename Tin, typename Tacc>
__global__ void __launch_bounds__(kThreads)
matmul_ws_kernel(const Tin* __restrict__ x, const Tin* __restrict__ w,
                 const Tacc* __restrict__ bias, Tacc* __restrict__ out,
                 int M, int N, int K) {
  __shared__ Tin xs[BK][BM + 1];  // x slice, transposed: xs[k][m]
  __shared__ Tin ws[BK][BN];
  const int tx = threadIdx.x % (BN / TN), ty = threadIdx.x / (BN / TN);
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  Tacc acc[TM][TN];
#pragma unroll
  for (int j = 0; j < TN; ++j) {
    const int n = n0 + tx + j * (BN / TN);
    const Tacc b = n < N ? bias[n] : Tacc(0);
#pragma unroll
    for (int i = 0; i < TM; ++i) acc[i][j] = b;
  }

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int i = threadIdx.x; i < BM * BK; i += kThreads) {
      const int r = i / BK, c = i % BK;
      const int m = m0 + r, k = k0 + c;
      xs[c][r] = (m < M && k < K) ? x[static_cast<long long>(m) * K + k] : Tin(0);
    }
    for (int i = threadIdx.x; i < BK * BN; i += kThreads) {
      const int r = i / BN, c = i % BN;
      const int k = k0 + r, n = n0 + c;
      ws[r][c] = (k < K && n < N) ? w[static_cast<long long>(k) * N + n] : Tin(0);
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      Tacc a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = static_cast<Tacc>(xs[kk][ty + i * (BM / TM)]);
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = static_cast<Tacc>(ws[kk][tx + j * (BN / TN)]);
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
      if (n < N) out[static_cast<long long>(m) * N + n] = acc[i][j];
    }
  }
}

template <typename Tin, typename Tacc>
int launch(const void* x, const void* w, const void* bias, void* out, int M,
           int N, int K, cudaStream_t stream) {
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  matmul_ws_kernel<Tin, Tacc><<<grid, kThreads, 0, stream>>>(
      static_cast<const Tin*>(x), static_cast<const Tin*>(w),
      static_cast<const Tacc*>(bias), static_cast<Tacc*>(out), M, N, K);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// mode 0: int8 -> int32; mode 1: f32 -> f32.
int matmul_ws_launch(const void* x, const void* w, const void* bias, void* out,
                     int M, int N, int K, int mode, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == 0) return launch<int8_t, int32_t>(x, w, bias, out, M, N, K, s);
  if (mode == 1) return launch<float, float>(x, w, bias, out, M, N, K, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
