// Weight-stationary, channel-banked conv with the fused epilogue, for Hopper.
//
// Replaces the Pallas TPU kernel repro.kernels.conv2d_ws.conv2d_ws
// (_conv_kernel): NHWC x [N,H,W,C] (int8 or f32) convolved with
// w [KH,KW,C/groups,K], bias preloaded into the accumulator, stride / zero
// padding / dilation / groups, then ReLU -> 2x2 max-pool -> requantize.
//
// Design.  One block per (image, output tile of the TilePlan, kout bank).
// The TPU's sequential cin grid axis becomes a loop inside the block over the
// cin banks of the bank's group (channel base (ko / bpg) * cgrp).  For every
// cin bank the halo'd input window [in_th, in_tw, cb] and the weight block
// [KH, KW, cb, kb] are staged in shared memory with ordinary loads (zero
// padding is written in place, exact for zero-point 0), then every
// accumulator entry adds its taps.  The accumulator [th, tw, kb] lives in
// shared memory like the TPU's VMEM scratch and starts as the bias; the
// epilogue reads it into registers on the last bank.
//
// What bounds it on the H100.  An output costs 2*KH*KW*C/g operations and
// every input byte is reused by up to KH*KW*K/g outputs, so the wide layers
// of the main path sit above the card's operations-per-byte line and are
// bound by the int8 tensor-core rate; thin layers (C=1..4, depthwise) are
// bound by bytes.  This simple form issues scalar int32 multiply-adds from
// shared memory, far below the tensor-core bound; it is the correct baseline
// that faster kernels (dp4a or mma.sync on the same tiles) are held against.
#include "conv_common.cuh"

namespace {

template <typename Tin>
__device__ void load_slab(Tin* xs, Tin* ws, const Tin* x, const Tin* w,
                          const ConvParams& p, const BlockCoord& bc, int co) {
  const int c0 = bc.chan(p, co);
  const int iy0 = bc.iy0(p), ix0 = bc.ix0(p);
  const int xn = p.in_th * p.in_tw * p.cb;
  for (int i = threadIdx.x; i < xn; i += blockDim.x) {
    const int c = i % p.cb;
    const int pix = i / p.cb;
    const int iy = iy0 + pix / p.in_tw, ix = ix0 + pix % p.in_tw;
    Tin v = Tin(0);
    if (iy >= 0 && iy < p.h && ix >= 0 && ix < p.w)
      v = x[((static_cast<long long>(bc.n) * p.h + iy) * p.w + ix) * p.c + c0 + c];
    xs[i] = v;
  }
  const int wn = p.kh * p.kw * p.cb * p.kb;
  for (int i = threadIdx.x; i < wn; i += blockDim.x) {
    const int kk = i % p.kb;
    const int r = i / p.kb;
    const int c = r % p.cb, tap = r / p.cb;
    ws[i] = w[(static_cast<long long>(tap) * p.cgrp + co * p.cb + c) * p.k +
              bc.ko * p.kb + kk];
  }
}

template <typename Tin, typename Tacc, bool REQUANT>
__global__ void __launch_bounds__(kConvThreads)
conv_ws_kernel(const Tin* __restrict__ x, const Tin* __restrict__ w,
               const Tacc* __restrict__ bias, const float* __restrict__ scale,
               void* __restrict__ out, ConvParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const SmemLayout<Tin, Tacc> lay(p);
  Tacc* acc = reinterpret_cast<Tacc*>(smem);
  Tin* xs = reinterpret_cast<Tin*>(smem + lay.x_off(0));
  Tin* ws = reinterpret_cast<Tin*>(smem + lay.w_off(1, 0));
  const BlockCoord bc(p);

  preload_bias(acc, bias, p, bc.ko);
  for (int co = 0; co < p.cin_banks; ++co) {
    __syncthreads();  // the previous slab's compute is done with xs / ws
    load_slab(xs, ws, x, w, p, bc, co);
    __syncthreads();
    accumulate_slab(acc, xs, ws, p);
  }
  __syncthreads();
  epilogue<Tacc, REQUANT>(acc, scale, out, p, bc);
}

template <typename Tin, typename Tacc, bool REQUANT>
int launch(const void* x, const void* w, const void* bias, const float* scale,
           void* out, const ConvParams& p, cudaStream_t stream) {
  const int smem = SmemLayout<Tin, Tacc>(p).total(1);
  auto kernel = conv_ws_kernel<Tin, Tacc, REQUANT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(p.n_th * p.n_tw * p.kout_banks, p.n);
  kernel<<<grid, kConvThreads, smem, stream>>>(
      static_cast<const Tin*>(x), static_cast<const Tin*>(w),
      static_cast<const Tacc*>(bias), scale, out, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int conv2d_ws_launch(const void* x, const void* w, const void* bias,
                     const float* scale, void* out, const int* geom,
                     int n_fields, int mode, void* stream) {
  if (n_fields != kConvParamsFields)
    return static_cast<int>(cudaErrorInvalidValue);
  ConvParams p = *reinterpret_cast<const ConvParams*>(geom);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  CONV_DISPATCH(mode, launch, x, w, bias, scale, out, p, s)
}

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
