// Pipelined variant of the weight-stationary conv, for Hopper.
//
// Replaces the Pallas TPU kernel repro.kernels.conv2d_ws_pipe.conv2d_ws_pipe
// (_pipe_kernel), which writes the conv2d_ws data movement out by hand with a
// 2-slot ping-pong of the input window and weight bank.  Same function as
// conv2d_ws.cu, the same five paths and the same path rule
// (conv_common.cuh's note), and the same compute and epilogue device
// functions, so the result is bit-equal to conv2d_ws.cu on every path; only
// the data motion differs.  What bounds each layer on the H100 is as there:
// at batch 8, vgg_imagenet's conv 0 and 1 in int8 by bytes (4.31 and 4.80
// us), conv 2-5 by int8 operations (1.87 us each for 2-4, 0.93 us for 5);
// in f32 conv 0 by bytes (17.26 us), conv 1-5 by FFMA (110.43, 55.21 x 3,
// 27.61 us); a depthwise layer by its bytes (mobilenet_small's at batch 8
// in int8: 1.92, 2.40, 1.92 us; the [1, 4096, 4096] temporal conv in f32:
// 40.1 us); a narrow-output layer by its bytes too (unet_small's 3-class
// head at batch 8 in int8, int32 out: 2.40 us).
//
// Tensor-core path (int8, K/groups >= 8): conv_ws_pipe_tc_kernel.  Blocks
// as in conv2d_ws.cu (128-pixel rectangles x 32/64-channel N-tiles, sized
// for the card, not by the TilePlan).  Its K-chunks stream through a ring of
// `stages` cp.async groups, 2 to 4 deep, chosen on the host as deep as the
// SM still holds as many blocks as it holds of conv2d_ws.cu's (conv2d_ws.py:
// tc_plan, blocks_per_sm).  The ring starts full; at chunk s the block waits
// for that chunk's group, passes a barrier (after which nobody reads the
// slot of chunk s-1), refills that slot with chunk s-1+stages and runs chunk
// s's mma steps, so up to stages-1 chunks load while the tensor cores work.
// A layer with one chunk (C/g <= 32) gets one slot and runs as conv2d_ws.cu
// does; so does a layer whose second slot would cost the SM a block
// (stages = 1: each chunk is loaded, waited for and computed in turn).
//
// Simt path (f32, K/groups >= 8): conv_ws_pipe_simt_kernel.  Blocks, K
// chunks, K split and reduce as conv2d_ws.cu's simt kernel; the chunks of
// a block's K slice stream through the same kind of ring, 2 to 4 deep
// (conv2d_ws.py: simt_plan, simt_blocks_per_sm; the epilogue's f32 tile,
// which aliases the ring, often leaves room for it at no cost in blocks).
//
// Depthwise path (C/groups == 1, K/groups < 8, int8 or f32):
// conv_ws_pipe_dw_kernel.  Work items and plan as conv2d_ws.cu's dw kernel
// (a pool-aligned rectangle x a run of output channels), walked by
// persistent blocks, as many as stay resident (the occupancy query at
// launch; the grid changes no value).  A block issues its next item's
// window and weights into the other slot of a 2-slot cp.async ring before
// it computes the current one, and stages the current one's accumulators
// in the current slot, so a load is in flight through every compute and
// epilogue.
//
// Narrow-output path (C/groups > 1, K/groups < 8, int8 or f32):
// conv_ws_pipe_nk_kernel.  Blocks, chunks and plan as conv2d_ws.cu's nk
// kernel (a pool-aligned rectangle x a run of groups, sized by geometry);
// where the group's channels take more than one chunk, they stream through
// a 2-slot cp.async ring, the reference's ping-pong of window and weight
// bank, so chunk s+1 loads while chunk s computes; with one chunk, or where
// two slots fit no block, it is conv2d_ws.cu's kernel.  One body
// (conv_common.cuh: nk_block), so the two are bit-equal.
//
// Scalar path (a geometry no other plan takes, int8 or f32):
// conv_ws_pipe_kernel, the first port's form.  The same block
// decomposition as conv2d_ws.cu's scalar kernel (one block per image,
// TilePlan tile and kout bank; a loop over the group's cin banks), with
// cin-bank slabs streamed into a 2-stage shared-memory ring with cp.async,
// so slab g+1 is in flight while slab g computes (commit_group / wait_group
// 1; an empty group is committed after the last slab so the wait count
// stays uniform).  cp.async copies only 4, 8 or 16 aligned bytes: the
// wrapper picks the widest chunk that divides the slab rows and their
// offsets (xvec / wvec); rows no chunk fits (depthwise cgrp = 1) use
// ordinary loads into the same ring, and zero padding is stored in place.
#include "conv_common.cuh"

namespace {

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
        cp_async_zfill(dst, reinterpret_cast<const unsigned char*>(src) + ch * p.xvec,
                       p.xvec, p.xvec);
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
      cp_async_zfill(reinterpret_cast<unsigned char*>(ws) + r * row + ch * p.wvec,
                     reinterpret_cast<const unsigned char*>(src) + ch * p.wvec,
                     p.wvec, p.wvec);
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
    cp_async_wait<1>();  // slab co has landed (only co+1 may be pending)
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

// 32-wide N-tiles fit 64 registers a thread, so four blocks share an SM
template <int NT, bool REQUANT>
__global__ void __launch_bounds__(kConvThreads, NT == 2 ? 4 : 2)
conv_ws_pipe_tc_kernel(const int8_t* __restrict__ x,
                       const int8_t* __restrict__ wp,
                       const int32_t* __restrict__ bias,
                       const float* __restrict__ scale,
                       void* __restrict__ out, TcParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* tbl = reinterpret_cast<int*>(smem);
  auto win = [&](int slot) {
    return reinterpret_cast<int8_t*>(smem + p.slot0 + slot * p.slot_bytes);
  };
  auto wsl = [&](int slot) { return win(slot) + p.win_bytes; };
  const TcBlock bc(p);
  const int ns = p.n_slices, S = p.stages;

  tc_build_table(tbl, p);
  for (int q = 0; q < p.slots; ++q) tc_zero_tail(wsl(q), p);
  for (int q = 0; q < p.slots; ++q) {  // fill the ring: slots = min(S, ns)
    tc_issue_chunk(win(q), wsl(q), x, wp, p, bc, q);
    cp_async_commit();
  }
  int acc[2][NT][4];
  tc_init_acc<NT>(acc, bias, p, bc);
  int rb[2][2];
  tc_row_bases(rb, p);
  for (int s = 0; s < ns; ++s) {
    if (S == 1 && s >= 1) {  // one slot: refill it once chunk s-1 is read
      __syncthreads();
      tc_issue_chunk(win(0), wsl(0), x, wp, p, bc, s);
      cp_async_commit();
    }
    // groups committed so far end at chunk min(ns-1, S-1+max(s-1, 0)); chunk
    // s has landed once no more than the ones after it are pending
    cp_async_wait_pending(S == 1 ? 0
                          : s == 0 ? min(ns - 1, S - 1) : min(ns - 1 - s, S - 2));
    __syncthreads();  // chunk s visible to all; chunk s-1's slot is free
    if (S >= 2 && s >= 1 && s - 1 + S < ns) {
      const int slot = (s - 1) % S;
      tc_issue_chunk(win(slot), wsl(slot), x, wp, p, bc, s - 1 + S);
      cp_async_commit();
    }
    tc_mma_chunk<NT>(acc, win(s % S), wsl(s % S), tbl, rb, p);
  }
  __syncthreads();  // every copy has landed (the last wait was for all)
  tc_epilogue<NT, REQUANT>(acc, reinterpret_cast<int*>(smem + p.slot0),
                           scale, out, p, bc);
}

template <int NT, bool REQUANT>
int launch_tc(const void* x, const void* w, const void* bias,
              const float* scale, void* out, const TcParams& p,
              cudaStream_t stream) {
  auto kernel = conv_ws_pipe_tc_kernel<NT, REQUANT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(p.n * p.n_ry * p.n_rx, (p.k / p.kgrp) * p.n_nt);
  kernel<<<grid, kConvThreads, p.smem, stream>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
      static_cast<const int32_t*>(bias), scale, out, p);
  return static_cast<int>(cudaGetLastError());
}

template <int BN, bool REQUANT>
__global__ void __launch_bounds__(kConvThreads, 2)
conv_ws_pipe_simt_kernel(const float* __restrict__ x,
                         const float* __restrict__ w,
                         const float* __restrict__ bias,
                         const float* __restrict__ scale,
                         void* __restrict__ out, float* __restrict__ part,
                         SimtParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  auto win = [&](int slot) {
    return reinterpret_cast<float*>(smem) + slot * p.slot_floats;
  };
  auto wsl = [&](int slot) { return win(slot) + p.win_floats; };
  const SimtBlock bc(p);
  const int s0 = bc.slice * p.kcs;
  const int ns = min(p.n_chunks - s0, p.kcs), S = p.stages;

  for (int q = 0; q < min(S, ns); ++q) {  // fill the ring
    simt_issue_chunk(win(q), wsl(q), x, w, p, bc, s0 + q);
    cp_async_commit();
  }
  float acc[kSimtTM][kSimtTN];
  simt_init_acc<BN>(acc, bias, p, bc);
  int rb[kSimtTM];
  simt_row_bases<BN>(rb, p);
  for (int s = 0; s < ns; ++s) {
    if (S == 1 && s >= 1) {  // one slot: refill it once chunk s-1 is read
      __syncthreads();
      simt_issue_chunk(win(0), wsl(0), x, w, p, bc, s0 + s);
      cp_async_commit();
    }
    // groups committed so far end at chunk min(ns-1, S-1+max(s-1, 0)); chunk
    // s has landed once no more than the ones after it are pending
    cp_async_wait_pending(S == 1   ? 0
                          : s == 0 ? min(ns - 1, S - 1)
                                   : min(ns - 1 - s, S - 2));
    __syncthreads();  // chunk s visible to all; chunk s-1's slot is free
    if (S >= 2 && s >= 1 && s - 1 + S < ns) {
      const int slot = (s - 1) % S;
      simt_issue_chunk(win(slot), wsl(slot), x, w, p, bc, s0 + s - 1 + S);
      cp_async_commit();
    }
    simt_chunk<BN>(acc, win(s % S), wsl(s % S), rb, p);
  }
  __syncthreads();  // every copy has landed (the last wait was for all)
  simt_finish<BN, REQUANT>(acc, reinterpret_cast<float*>(smem), scale, out,
                           part, p, bc);
}

template <int BN, bool REQUANT>
int launch_simt(const void* x, const void* w, const void* bias,
                const float* scale, void* out, void* part,
                const SimtParams& p, cudaStream_t stream) {
  auto kernel = conv_ws_pipe_simt_kernel<BN, REQUANT>;
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

// Persistent blocks over the work items (rectangle x channel run): the
// next item's window and weights stream into the other slot of a 2-slot
// ring while this one computes; the tile of an item takes the place of its
// own slot's window, so the prefetch never waits for the epilogue.
template <typename Tin, typename Tacc, bool REQUANT, int KW_T>
__global__ void __launch_bounds__(kConvThreads, 3)
conv_ws_pipe_dw_kernel(const Tin* __restrict__ x, const Tin* __restrict__ w,
                       const Tacc* __restrict__ bias,
                       const float* __restrict__ scale,
                       void* __restrict__ out, DwParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const DwThread th(p);
  int r = blockIdx.x;
  if (r < p.n_rect) dw_issue<Tin>(smem, x, w, p, DwRect(p, r));
  cp_async_commit();
  for (int i = 0; r < p.n_rect; ++i, r += gridDim.x) {
    unsigned char* cur = smem + (i & 1) * p.slot_bytes;
    const int nxt = r + gridDim.x;
    if (nxt < p.n_rect)  // the other slot was freed by the last barrier
      dw_issue<Tin>(smem + ((i + 1) & 1) * p.slot_bytes, x, w, p,
                    DwRect(p, nxt));
    cp_async_commit();
    const DwRect rc(p, r);
    DwChannels<Tacc> ch;
    dw_channels<Tacc, REQUANT>(ch, bias, scale, p, th, rc);
    cp_async_wait<1>();  // item r has landed; only nxt may be in flight
    __syncthreads();
    Tacc acc[kDwSP][kDwV];
    dw_compute<Tin, Tacc, KW_T>(acc, cur, ch.bias, p, th);
    __syncthreads();  // every strip is done with the window
    dw_stage(acc, cur, p, th);
    __syncthreads();
    dw_store<Tacc, REQUANT>(cur, ch.scale, scale, out, p, rc);
    __syncthreads();  // the tile is read: the slot takes item r + 2 grids
  }
}

template <typename Tin, typename Tacc, bool REQUANT, int KW_T>
int launch_dw(const void* x, const void* w, const void* bias,
              const float* scale, void* out, const DwParams& p,
              cudaStream_t stream) {
  auto kernel = conv_ws_pipe_dw_kernel<Tin, Tacc, REQUANT, KW_T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0, per_sm = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kConvThreads, p.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  // as many blocks as stay resident: the grid only spreads the items, so
  // its size changes no value
  const int resident = (per_sm > 1 ? per_sm : 1) * sms;
  const int grid = p.n_rect < resident ? p.n_rect : resident;
  kernel<<<grid, kConvThreads, p.smem, stream>>>(
      static_cast<const Tin*>(x), static_cast<const Tin*>(w),
      static_cast<const Tacc*>(bias), scale, out, p);
  return static_cast<int>(cudaGetLastError());
}

// Blocks and chunks as conv2d_ws.cu's nk kernel, and its body (nk_block):
// where the group takes more than one chunk and two slots fit, chunk s+1's
// window and weights stream into the other slot of a 2-slot ring while
// chunk s computes (RING); with one chunk, or where two slots fit no block
// (nk_plan), the ring has one slot and the kernel is conv2d_ws.cu's.
template <typename Tin, typename Tacc, bool REQUANT, int KP, int VB,
          bool RING>
__global__ void __launch_bounds__(kConvThreads, 2)
conv_ws_pipe_nk_kernel(const Tin* __restrict__ x, const Tin* __restrict__ w,
                       const Tacc* __restrict__ bias,
                       const float* __restrict__ scale,
                       void* __restrict__ out, NkParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  nk_block<Tin, Tacc, REQUANT, KP, VB, RING>(x, w, bias, scale, out, p,
                                              smem);
}

template <typename Tin, typename Tacc, bool REQUANT, int KP, int VB>
int launch_nk(const void* x, const void* w, const void* bias,
              const float* scale, void* out, const NkParams& p,
              cudaStream_t stream) {
  auto kernel = p.slots == 2
                    ? conv_ws_pipe_nk_kernel<Tin, Tacc, REQUANT, KP, VB, true>
                    : conv_ws_pipe_nk_kernel<Tin, Tacc, REQUANT, KP, VB,
                                             false>;
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

int conv2d_ws_pipe_launch(const void* x, const void* w, const void* bias,
                          const float* scale, void* out, const int* geom,
                          int n_fields, int mode, void* stream) {
  if (n_fields != kConvParamsFields)
    return static_cast<int>(cudaErrorInvalidValue);
  ConvParams p = *reinterpret_cast<const ConvParams*>(geom);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  CONV_DISPATCH(mode, launch, x, w, bias, scale, out, p, s)
}

int conv2d_ws_pipe_tc_launch(const void* x, const void* w, const void* bias,
                             const float* scale, void* out, const int* geom,
                             int n_fields, int mode, void* stream) {
  if (n_fields != kTcParamsFields)
    return static_cast<int>(cudaErrorInvalidValue);
  TcParams p = *reinterpret_cast<const TcParams*>(geom);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  TC_DISPATCH(mode, p.bn, launch_tc, x, w, bias, scale, out, p, s)
}

int conv2d_ws_pipe_simt_launch(const void* x, const void* w, const void* bias,
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

int conv2d_ws_pipe_dw_launch(const void* x, const void* w, const void* bias,
                             const float* scale, void* out, const int* geom,
                             int n_fields, int mode, void* stream) {
  if (n_fields != kDwParamsFields)
    return static_cast<int>(cudaErrorInvalidValue);
  DwParams p = *reinterpret_cast<const DwParams*>(geom);
  if (!dw_valid(p) || p.slots != 2)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  DW_DISPATCH(mode, p, launch_dw, x, w, bias, scale, out, p, s)
}

int conv2d_ws_pipe_nk_launch(const void* x, const void* w, const void* bias,
                             const float* scale, void* out, const int* geom,
                             int n_fields, int mode, void* stream) {
  if (n_fields != kNkParamsFields)
    return static_cast<int>(cudaErrorInvalidValue);
  NkParams p = *reinterpret_cast<const NkParams*>(geom);
  if (!nk_valid(p, mode >= 2 ? 4 : 1) || p.slots < 1 || p.slots > 2 ||
      p.slots > p.n_chunks)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  NK_DISPATCH(mode, p, launch_nk, x, w, bias, scale, out, p, s)
}

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
