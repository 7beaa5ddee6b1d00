// Double-buffered variant of the weight-stationary conv, for Hopper.
//
// Replaces the Pallas TPU kernel repro.kernels.conv2d_ws_pipe.conv2d_ws_pipe
// (_pipe_kernel), which writes the conv2d_ws data movement out by hand with a
// 2-slot ping-pong of the input window and weight bank.  Same function as
// conv2d_ws.cu and the same block decomposition (one block per image, output
// tile and kout bank; a loop over the group's cin banks), with the slab
// motion made explicit: cin-bank slabs stream into a 2-stage shared-memory
// ring with cp.async, so slab g+1 is in flight while slab g computes
// (commit_group / wait_group 1; an empty group is committed after the last
// slab so the wait count stays uniform).  The compute and the epilogue are the
// shared device functions of conv_common.cuh, so the result is bit-equal to
// conv2d_ws.cu on the int and the f32 paths.
//
// Narrow slabs.  cp.async copies only 4, 8 or 16 aligned bytes.  The wrapper
// picks the widest chunk that divides the slab rows and their offsets
// (xvec / wvec); rows that no chunk fits (lenet's C=1 input, vgg_imagenet's
// 1-byte slabs of a C=4 map, depthwise cgrp=1) use ordinary loads into the
// same ring, and zero padding is stored in place.  The TPU kernel's prefetch
// chain across grid steps and its overlapped output store have no
// counterpart: blocks are independent here, and the epilogue stores from
// registers.
//
// What bounds it on the H100: as conv2d_ws.cu, the int8 tensor-core rate for
// the wide layers and bytes for the thin ones; the ring hides the slab loads
// behind the scalar compute, which is what limits both kernels today.
#include "conv_common.cuh"

namespace {

__device__ inline void cp_async(void* dst, const void* src, int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  switch (bytes) {
    case 16:
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
      break;
    case 8:
      asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d), "l"(src));
      break;
    default:
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
      break;
  }
}

__device__ inline void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ inline void cp_async_wait_one() { asm volatile("cp.async.wait_group 1;\n" ::); }

__device__ inline void zero_bytes(unsigned char* dst, int bytes) {
  for (int b = 0; b < bytes; b += 4) *reinterpret_cast<int*>(dst + b) = 0;
}

// Issue the copies of cin bank `co` into one ring slot (not waited here).
template <typename Tin>
__device__ void issue_slab(Tin* xs, Tin* ws, const Tin* x, const Tin* w,
                           const ConvParams& p, const BlockCoord& bc, int co) {
  const int c0 = bc.chan(p, co);
  const int iy0 = bc.iy0(p), ix0 = bc.ix0(p);
  const int npix = p.in_th * p.in_tw;
  if (p.xvec) {
    const int row = p.cb * static_cast<int>(sizeof(Tin));  // bytes per pixel
    const int chunks = row / p.xvec;
    for (int i = threadIdx.x; i < npix * chunks; i += blockDim.x) {
      const int pix = i / chunks, ch = i % chunks;
      const int iy = iy0 + pix / p.in_tw, ix = ix0 + pix % p.in_tw;
      unsigned char* dst = reinterpret_cast<unsigned char*>(xs) + pix * row + ch * p.xvec;
      if (iy >= 0 && iy < p.h && ix >= 0 && ix < p.w) {
        const Tin* src =
            x + ((static_cast<long long>(bc.n) * p.h + iy) * p.w + ix) * p.c + c0;
        cp_async(dst, reinterpret_cast<const unsigned char*>(src) + ch * p.xvec, p.xvec);
      } else {
        zero_bytes(dst, p.xvec);
      }
    }
  } else {
    for (int i = threadIdx.x; i < npix * p.cb; i += blockDim.x) {
      const int c = i % p.cb, pix = i / p.cb;
      const int iy = iy0 + pix / p.in_tw, ix = ix0 + pix % p.in_tw;
      Tin v = Tin(0);
      if (iy >= 0 && iy < p.h && ix >= 0 && ix < p.w)
        v = x[((static_cast<long long>(bc.n) * p.h + iy) * p.w + ix) * p.c + c0 + c];
      xs[i] = v;
    }
  }
  const int wrows = p.kh * p.kw * p.cb;  // one row = the bank's kb kernels
  if (p.wvec) {
    const int row = p.kb * static_cast<int>(sizeof(Tin));
    const int chunks = row / p.wvec;
    for (int i = threadIdx.x; i < wrows * chunks; i += blockDim.x) {
      const int r = i / chunks, ch = i % chunks;
      const int c = r % p.cb, tap = r / p.cb;
      const Tin* src = w + (static_cast<long long>(tap) * p.cgrp + co * p.cb + c) * p.k +
                       bc.ko * p.kb;
      cp_async(reinterpret_cast<unsigned char*>(ws) + r * row + ch * p.wvec,
               reinterpret_cast<const unsigned char*>(src) + ch * p.wvec, p.wvec);
    }
  } else {
    for (int i = threadIdx.x; i < wrows * p.kb; i += blockDim.x) {
      const int kk = i % p.kb, r = i / p.kb;
      const int c = r % p.cb, tap = r / p.cb;
      ws[i] = w[(static_cast<long long>(tap) * p.cgrp + co * p.cb + c) * p.k +
                bc.ko * p.kb + kk];
    }
  }
}

template <typename Tin, typename Tacc, bool REQUANT>
__global__ void __launch_bounds__(kConvThreads)
conv_ws_pipe_kernel(const Tin* __restrict__ x, const Tin* __restrict__ w,
                    const Tacc* __restrict__ bias, const float* __restrict__ scale,
                    void* __restrict__ out, ConvParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const SmemLayout<Tin, Tacc> lay(p);
  Tacc* acc = reinterpret_cast<Tacc*>(smem);
  Tin* xs[2] = {reinterpret_cast<Tin*>(smem + lay.x_off(0)),
                reinterpret_cast<Tin*>(smem + lay.x_off(1))};
  Tin* ws[2] = {reinterpret_cast<Tin*>(smem + lay.w_off(2, 0)),
                reinterpret_cast<Tin*>(smem + lay.w_off(2, 1))};
  const BlockCoord bc(p);

  issue_slab(xs[0], ws[0], x, w, p, bc, 0);  // prime the ring
  cp_async_commit();
  preload_bias(acc, bias, p, bc.ko);
  for (int co = 0; co < p.cin_banks; ++co) {
    const int slot = co & 1;
    // slab co+1 streams into the other slot while slab co computes; the
    // trailing __syncthreads of the previous iteration freed that slot
    if (co + 1 < p.cin_banks)
      issue_slab(xs[slot ^ 1], ws[slot ^ 1], x, w, p, bc, co + 1);
    cp_async_commit();
    cp_async_wait_one();  // slab co has landed (only co+1 may be pending)
    __syncthreads();
    accumulate_slab(acc, xs[slot], ws[slot], p);
    __syncthreads();
  }
  epilogue<Tacc, REQUANT>(acc, scale, out, p, bc);
}

template <typename Tin, typename Tacc, bool REQUANT>
int launch(const void* x, const void* w, const void* bias, const float* scale,
           void* out, const ConvParams& p, cudaStream_t stream) {
  const int smem = SmemLayout<Tin, Tacc>(p).total(2);
  auto kernel = conv_ws_pipe_kernel<Tin, Tacc, REQUANT>;
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

int conv2d_ws_pipe_launch(const void* x, const void* w, const void* bias,
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
