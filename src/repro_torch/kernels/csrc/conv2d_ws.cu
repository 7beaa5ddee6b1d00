// Weight-stationary conv with the fused epilogue, for Hopper: the
// single-buffered kernel.
//
// Replaces the Pallas TPU kernel repro.kernels.conv2d_ws.conv2d_ws
// (_conv_kernel): NHWC x [N,H,W,C] (int8 or f32) convolved with
// w [KH,KW,C/groups,K], bias preloaded into the accumulator, stride / zero
// padding / dilation / groups, then ReLU -> 2x2 max-pool -> requantize.
//
// What bounds each layer on the H100 (conv_common.cuh's note has the tables):
// at batch 8, vgg_imagenet's conv 0 and 1 in int8 by bytes (4.31 and 4.80
// us at 3.35 TB/s), conv 2-5 by int8 operations (1.87, 1.87, 1.87 and 0.93
// us at 1,979 TOP/s); in f32 conv 0 by bytes (17.26 us) and conv 1-5 by
// FFMA (110.43, 55.21, 55.21, 55.21, 27.61 us at 67 TFLOP/s); a depthwise
// layer by its bytes in either type (mobilenet_small's at batch 8 in int8:
// 1.92, 2.40, 1.92 us; recurrentgemma-9b's temporal conv at [1, 4096,
// 4096] in f32: 40.1 us); a narrow-output layer by its bytes too
// (unet_small's 3-class head at batch 8 in int8, int32 out: 2.40 us).
// That note also gives the design of the five paths and the rule that
// picks one: K/groups >= 8 runs an implicit GEMM (int8 "tc", f32 "simt"),
// one input channel a group with fewer outputs the direct conv "dw",
// several input channels a group with fewer outputs the direct conv "nk",
// and a geometry no plan takes the scalar kernel.
//
// Tensor-core path (int8, K/groups >= 8): conv_ws_tc_kernel, an implicit
// GEMM on mma.sync m16n8k32 s8 with register accumulators, one block per
// (128-pixel rectangle of an image, 32/64-channel N-tile of a group).  Its
// blocks are sized for the card and do not follow the TilePlan.  This kernel
// moves data the simple way: for each K-chunk it issues the window and
// weight-slab copies, waits for them, then runs the chunk's mma steps, so a
// block's loads and its tensor-core work take turns (other resident blocks
// fill the gaps).  conv2d_ws_pipe.cu streams the same chunks through a ring.
//
// Simt path (f32, K/groups >= 8): conv_ws_simt_kernel, an implicit GEMM on
// register-tiled FFMA (8 x 8 outputs a thread), one block per (rectangle
// of an image, 32/64/128-channel N-tile of a group, K slice), sized by
// geometry alone; the K split's reduce is conv_simt_reduce_kernel.  Like
// the tensor-core kernel, it loads each chunk, waits for it and then
// computes it; conv2d_ws_pipe.cu runs the same device functions through a
// ring, so the two are bit-equal.
//
// Depthwise path (C/groups == 1, K/groups < 8, int8 or f32):
// conv_ws_dw_kernel, a direct conv, one block per (pool-aligned rectangle
// of an image, run of output channels contiguous in NHWC), sized by
// geometry alone.  Its threads take 4-channel vectors across the run and
// 4-pixel strips along the rectangle's rows; it loads the rectangle's
// halo'd window and the run's weights with cp.async, waits, sums bias and
// taps in (dy, dx) order in registers, and stores through a shared tile.
// conv2d_ws_pipe.cu runs the same device functions in persistent blocks
// with a prefetched next window, so the two are bit-equal.
//
// Narrow-output path (C/groups > 1, K/groups < 8, int8 or f32):
// conv_ws_nk_kernel, a direct conv that sums channels, one block per
// (pool-aligned rectangle of an image, run of groups), sized by geometry
// alone.  A thread owns a strip of 4 pixels of one group and all of that
// group's outputs in registers; the group's channels go in chunks, each
// chunk's halo'd window and weights landing with cp.async, waited for and
// summed (int8 through __dp4a, f32 by FFMA in a fixed order), then the
// accumulators go out through a shared tile.  conv2d_ws_pipe.cu streams
// the same chunks through a 2-slot ring, so the two are bit-equal.
//
// Scalar path (a geometry no other plan takes, int8 or f32):
// conv_ws_kernel, the first port's form.  One block per (image,
// output tile of the TilePlan, kout bank); the TPU's sequential cin grid
// axis becomes a loop over the cin banks of the bank's group (channel base
// (ko / bpg) * cgrp).  Each cin bank's halo'd input window [in_th, in_tw,
// cb] and weight block [KH, KW, cb, kb] are staged in shared memory with
// ordinary loads (zero padding written in place), then every accumulator
// entry adds its taps; the accumulator [th, tw, kb] lives in shared memory
// like the TPU's VMEM scratch and starts as the bias.
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

// 32-wide N-tiles fit 64 registers a thread, so four blocks share an SM
template <int NT, bool REQUANT>
__global__ void __launch_bounds__(kConvThreads, NT == 2 ? 4 : 2)
conv_ws_tc_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ wp,
                  const int32_t* __restrict__ bias,
                  const float* __restrict__ scale, void* __restrict__ out,
                  TcParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* tbl = reinterpret_cast<int*>(smem);
  int8_t* win = reinterpret_cast<int8_t*>(smem + p.slot0);
  int8_t* wsl = win + p.win_bytes;
  const TcBlock bc(p);

  tc_build_table(tbl, p);
  tc_zero_tail(wsl, p);
  int acc[2][NT][4];
  tc_init_acc<NT>(acc, bias, p, bc);
  int rb[2][2];
  tc_row_bases(rb, p);
  for (int s = 0; s < p.n_slices; ++s) {
    __syncthreads();  // the previous chunk's mma steps are done with the slot
    tc_issue_chunk(win, wsl, x, wp, p, bc, s);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    tc_mma_chunk<NT>(acc, win, wsl, tbl, rb, p);
  }
  __syncthreads();
  tc_epilogue<NT, REQUANT>(acc, reinterpret_cast<int*>(smem + p.slot0),
                           scale, out, p, bc);
}

template <int NT, bool REQUANT>
int launch_tc(const void* x, const void* w, const void* bias,
              const float* scale, void* out, const TcParams& p,
              cudaStream_t stream) {
  auto kernel = conv_ws_tc_kernel<NT, REQUANT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(p.n * p.n_ry * p.n_rx, (p.k / p.kgrp) * p.n_nt);
  kernel<<<grid, kConvThreads, p.smem, stream>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
      static_cast<const int32_t*>(bias), scale, out, p);
  return static_cast<int>(cudaGetLastError());
}

// Two 8 x 8 register tiles of 256 threads fit 128 registers a thread, so two
// blocks share an SM
template <int BN, bool REQUANT>
__global__ void __launch_bounds__(kConvThreads, 2)
conv_ws_simt_kernel(const float* __restrict__ x, const float* __restrict__ w,
                    const float* __restrict__ bias,
                    const float* __restrict__ scale, void* __restrict__ out,
                    float* __restrict__ part, SimtParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* win = reinterpret_cast<float*>(smem);
  float* wsl = win + p.win_floats;
  const SimtBlock bc(p);

  float acc[kSimtTM][kSimtTN];
  simt_init_acc<BN>(acc, bias, p, bc);
  int rb[kSimtTM];
  simt_row_bases<BN>(rb, p);
  const int s0 = bc.slice * p.kcs, s1 = min(p.n_chunks, s0 + p.kcs);
  for (int s = s0; s < s1; ++s) {
    __syncthreads();  // the previous chunk's FMAs are done with the slot
    simt_issue_chunk(win, wsl, x, w, p, bc, s);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    simt_chunk<BN>(acc, win, wsl, rb, p);
  }
  __syncthreads();
  simt_finish<BN, REQUANT>(acc, reinterpret_cast<float*>(smem), scale, out,
                           part, p, bc);
}

template <int BN, bool REQUANT>
int launch_simt(const void* x, const void* w, const void* bias,
                const float* scale, void* out, void* part,
                const SimtParams& p, cudaStream_t stream) {
  auto kernel = conv_ws_simt_kernel<BN, REQUANT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(p.n * p.n_ry * p.n_rx, (p.k / p.kgrp) * p.n_nt, p.split);
  kernel<<<grid, kConvThreads, p.smem, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<const float*>(bias), scale, out, static_cast<float*>(part),
      p);
  return simt_reduce<REQUANT>(part, bias, scale, out, p, stream);
}

// Registers for a strip of 4 pixels x 4 channels and a window row of up to
// 7 vectors fit 80 a thread, so three blocks share an SM
template <typename Tin, typename Tacc, bool REQUANT, int KW_T>
__global__ void __launch_bounds__(kConvThreads, 3)
conv_ws_dw_kernel(const Tin* __restrict__ x, const Tin* __restrict__ w,
                  const Tacc* __restrict__ bias,
                  const float* __restrict__ scale, void* __restrict__ out,
                  DwParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const DwRect rc(p, blockIdx.x);
  const DwThread th(p);
  dw_issue<Tin>(smem, x, w, p, rc);
  cp_async_commit();
  DwChannels<Tacc> ch;
  dw_channels<Tacc, REQUANT>(ch, bias, scale, p, th, rc);
  cp_async_wait<0>();
  __syncthreads();
  Tacc acc[kDwSP][kDwV];
  dw_compute<Tin, Tacc, KW_T>(acc, smem, ch.bias, p, th);
  __syncthreads();  // every strip is done with the window: the tile replaces it
  dw_stage(acc, smem, p, th);
  __syncthreads();
  dw_store<Tacc, REQUANT>(smem, ch.scale, scale, out, p, rc);
}

template <typename Tin, typename Tacc, bool REQUANT, int KW_T>
int launch_dw(const void* x, const void* w, const void* bias,
              const float* scale, void* out, const DwParams& p,
              cudaStream_t stream) {
  auto kernel = conv_ws_dw_kernel<Tin, Tacc, REQUANT, KW_T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<p.n_rect, kConvThreads, p.smem, stream>>>(
      static_cast<const Tin*>(x), static_cast<const Tin*>(w),
      static_cast<const Tacc*>(bias), scale, out, p);
  return static_cast<int>(cudaGetLastError());
}

// A strip of 4 pixels x up to 8 outputs with its weight vectors fits 128
// registers a thread (f32 at KP = 8: 32 accumulators, 8 float4 weights), so
// two blocks share an SM at least.  Each chunk in one slot (nk_block).
template <typename Tin, typename Tacc, bool REQUANT, int KP, int VB>
__global__ void __launch_bounds__(kConvThreads, 2)
conv_ws_nk_kernel(const Tin* __restrict__ x, const Tin* __restrict__ w,
                  const Tacc* __restrict__ bias,
                  const float* __restrict__ scale, void* __restrict__ out,
                  NkParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  nk_block<Tin, Tacc, REQUANT, KP, VB, false>(x, w, bias, scale, out, p,
                                               smem);
}

template <typename Tin, typename Tacc, bool REQUANT, int KP, int VB>
int launch_nk(const void* x, const void* w, const void* bias,
              const float* scale, void* out, const NkParams& p,
              cudaStream_t stream) {
  auto kernel = conv_ws_nk_kernel<Tin, Tacc, REQUANT, KP, VB>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<p.n_rect, kConvThreads, p.smem, stream>>>(
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

int conv2d_ws_tc_launch(const void* x, const void* w, const void* bias,
                        const float* scale, void* out, const int* geom,
                        int n_fields, int mode, void* stream) {
  if (n_fields != kTcParamsFields)
    return static_cast<int>(cudaErrorInvalidValue);
  TcParams p = *reinterpret_cast<const TcParams*>(geom);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  TC_DISPATCH(mode, p.bn, launch_tc, x, w, bias, scale, out, p, s)
}

int conv2d_ws_simt_launch(const void* x, const void* w, const void* bias,
                          const float* scale, void* out, void* part,
                          const int* geom, int n_fields, int mode,
                          void* stream) {
  if (n_fields != kSimtParamsFields)
    return static_cast<int>(cudaErrorInvalidValue);
  SimtParams p = *reinterpret_cast<const SimtParams*>(geom);
  if (p.split > 1 && part == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  SIMT_DISPATCH(mode, p.bn, launch_simt, x, w, bias, scale, out, part, p, s)
}

int conv2d_ws_dw_launch(const void* x, const void* w, const void* bias,
                        const float* scale, void* out, const int* geom,
                        int n_fields, int mode, void* stream) {
  if (n_fields != kDwParamsFields)
    return static_cast<int>(cudaErrorInvalidValue);
  DwParams p = *reinterpret_cast<const DwParams*>(geom);
  if (!dw_valid(p) || p.slots != 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  DW_DISPATCH(mode, p, launch_dw, x, w, bias, scale, out, p, s)
}

int conv2d_ws_nk_launch(const void* x, const void* w, const void* bias,
                        const float* scale, void* out, const int* geom,
                        int n_fields, int mode, void* stream) {
  if (n_fields != kNkParamsFields)
    return static_cast<int>(cudaErrorInvalidValue);
  NkParams p = *reinterpret_cast<const NkParams*>(geom);
  if (!nk_valid(p, mode >= 2 ? 4 : 1) || p.slots != 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  NK_DISPATCH(mode, p, launch_nk, x, w, bias, scale, out, p, s)
}

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
