// Shared pieces of the two weight-stationary conv kernels (conv2d_ws.cu,
// conv2d_ws_pipe.cu), which replace the Pallas TPU kernels
// repro.kernels.conv2d_ws.conv2d_ws (_conv_kernel) and
// repro.kernels.conv2d_ws_pipe.conv2d_ws_pipe (_pipe_kernel): NHWC x ⊛
// w[KH,KW,C/g,K], bias preloaded, stride / padding / dilation / groups, then
// ReLU -> 2x2 max-pool -> requantize.  Both kernels run exactly these device
// functions on the same shared-memory layout, so they agree bit for bit;
// they differ only in how a chunk reaches shared memory.
//
// What bounds each layer on the H100 (vgg_imagenet at batch 8, int8; bytes
// counted once in and once out; 1,979 TOP/s int8, 3.35 TB/s):
//
//   conv  map, C->K            GOP    MB     bound us  by
//   0     224^2, 4->32         0.925  14.45  4.31      bytes
//   1     224^2, 32->32 +pool  7.399  16.07  4.80      bytes
//   2     112^2, 32->64 +pool  3.699   4.84  1.87      operations
//   3     56^2, 64->128 +pool  3.699   2.48  1.87      operations
//   4     28^2, 128->256 +pool 3.699   1.50  1.87      operations
//   5     14^2, 256->256       1.850   1.39  0.93      operations
//
// so conv 0 and 1 are bound by their bytes (every byte read and written
// once) and conv 2-5 by the int8 tensor-core rate.  In f32 (the QAT step's
// forward convs, and its input gradients: stride-1 convs of the cotangent
// with channel-swapped, flipped weights) there is no tensor-core rate that
// keeps f32 operands (TF32 rounds them, which the gradients' parity
// forbids), so the bound is 67 TFLOP/s of FFMA:
//
//   conv  map, C->K            GFLOP  MB     bound us  by    dx bound us
//   0     224^2, 4->32         0.925  57.81  17.26     bytes  (none)
//   1     224^2, 32->32 +pool  7.399  64.26  110.43    FFMA   110.43
//   2     112^2, 32->64 +pool  3.699  19.34  55.21     FFMA   55.21
//   3     56^2, 64->128 +pool  3.699   9.93  55.21     FFMA   55.21
//   4     28^2, 128->256 +pool 3.699   6.00  55.21     FFMA   55.21
//   5     14^2, 256->256       1.850   5.57  27.61     FFMA   27.61
//
// A depthwise layer is bound by its bytes in either type: it does KH*KW
// multiply-adds an output and sums no channels (mobilenet_small's at 224
// and batch 8, int8 in and out; recurrentgemma-9b's temporal conv in f32):
//
//   layer                          MB      bound us  by
//   d1 224^2 x 8, 3x3              6.42    1.92      bytes
//   d2 224^2 x 16, 3x3, stride 2   8.03    2.40      bytes
//   d3 112^2 x 32, 3x3             6.42    1.92      bytes
//   conv1d [1, 4096, 4096], 1x4    134.3   40.1      bytes (f32)
//
// (f32 d1-d3 move 4x the bytes: 7.7, 9.6 and 7.7 us.)  A layer of several
// input channels a group and fewer than 8 outputs is bound by its bytes too
// (the segmentation heads, 1x1 with 3 classes, at 224 and batch 8, int32
// out; groups2 is CASES' [2,10,10,8] x [3,3,4,8]):
//
//   layer                              MB      bound us  by
//   unet_small head 8->3 int8          8.03    2.40      bytes
//   dilated_context head 16->3 int8    11.24   3.36      bytes
//   unet_small head 8->3 f32           17.66   5.27      bytes
//   groups2 f32                        0.014   0.004     bytes
//
// Five paths, chosen on the host by geometry (conv2d_ws.py: conv_path):
// K/groups >= 8 runs an implicit GEMM, "tc" for int8 and "simt" for f32;
// one input channel a group with fewer than 8 outputs runs the direct conv
// "dw", in int8 and in f32; several input channels a group with fewer than
// 8 outputs the direct conv "nk", in int8 and in f32; a geometry no plan
// takes runs "scalar".
//
// * Tensor cores ("tc": int8 operands, K/groups >= 8, one K-chunk fits a
//   block).  An implicit GEMM: M = the conv-output pixels of a block, N =
//   the output channels of one group, K = KH*KW*C/g in (tap, channel) order.
//   mma.sync.m16n8k32.row.col.s32.s8.s8.s32 (signed) with int32 accumulators
//   in registers that start at the bias (the M5 preload).  A block is 8 warps
//   over a 128-pixel pool-aligned rectangle of one image (8x16, 16x8 or 32x4)
//   times a 32- or 64-channel N-tile; each warp owns 32 rows x BN/2 columns.
//   The blocks are sized for the card, not by the TilePlan: int32 sums are
//   exact in any order, so the plan's cin banks and tiles are validated by
//   setup_conv and then shape no grid here.  The K loop runs over chunks of
//   `cs` input channels x all taps: a chunk's halo'd input window lands in
//   shared memory with cp.async (`ps` bytes a pixel, 16 more than the
//   channels where that keeps the 8 rows of a fragment load on distinct
//   banks; padding and map edges zero-filled by the copy, exact for
//   zero-point 0), and its weight slab [BN][ksp] from the K-major packed
//   weights [K][kpad].  A fragments are built by address arithmetic: a row
//   base per pixel plus a per-column table over (tap, channel); where the
//   chunk's channels come in fours (cs % 4 == 0) one 32-bit load feeds four
//   K columns, else (C = 1, lenet) four byte loads do.  Padded K columns
//   read 0 in A and are 0 in B.  The epilogue stages the int32 tile through
//   shared memory and runs ReLU -> 2x2 max-pool -> rint(v * scale[k])
//   clipped to int8 (or the raw int32), masking the ragged edge.
// * FFMA ("simt": f32 operands, K/groups >= 8).  The same implicit GEMM
//   shape on register-tiled FFMA, no tensor cores: 256 threads a block,
//   each 8 pixels x 8 channels of f32 accumulators in registers that start
//   at the bias; a BN-wide N-tile (128, 64 or 32 channels of one group,
//   BN/8 threads across) times a pool-aligned rectangle of 256*64/BN
//   pixels of one image (16x32 at BN 32, 16x16 at 64, 8x16 or 4x32 at 128;
//   the plan's shape pads the map least).  Blocks are sized by geometry
//   alone, so each output's order of sums depends on the shape only: a
//   whole-map and a tiled call, and the two kernels, give the same bits.
//   K runs over chunks of `cs` channels x all taps (at most 72 K rows); a
//   chunk's halo'd window lands pixel-major in shared memory, `ps` = cs
//   rounded up to odd floats a pixel (four-byte cp.async, zero-filled at
//   padding and map edges), so that a warp's pixels of one load (32/CT
//   consecutive pixels of one rectangle row, CT = BN/8) sit on distinct
//   banks at stride 1, 2 and 4 and under dilation; the weight slab
//   [taps*cs][BN] is copied from w's rows as they lie (contiguous in K,
//   16-byte cp.async where K/g and K come in fours).  Each K step a thread
//   reads 8 window floats and two float4 of weights and issues 64 FFMAs.
//   Where the tiles number under one block an SM, K is split over
//   blockIdx.z (conv2d_ws.py: simt_plan) and a reduce kernel adds bias and
//   the slices' partials in slice order before the epilogue: no atomics.
//   The epilogue stages the f32 tile through shared memory and runs ReLU
//   -> 2x2 max-pool -> requantize (or the raw f32), as the others do.
// * Direct conv ("dw": C/groups == 1 and K/groups < 8, int8 or f32:
//   depthwise layers, channel multipliers under 8, one-channel maps with
//   under 8 outputs).  Output channel k reads input channel k / (K/g).  A
//   block of 256 threads covers a pool-aligned rectangle of conv-output
//   pixels of one image times a run of kc output channels contiguous in
//   NHWC (4-128 in f32, 4-64 in int8: the power of two times 4 that pads K
//   least, the widest whose window fits twice in shared memory), which
//   spans many groups; where no run's window fits (a wide stride in f32),
//   the rectangle has fewer strips and the threads past them only copy
//   and store.  A thread owns a vector of 4 channels
//   (a float4, or 4 int8 in a word) and a strip of 4 pixels along a
//   rectangle row; the run's kc/4 vectors lie across consecutive threads,
//   so global reads and writes are coalesced along the run, and the
//   window and tile row pitches are padded so that a warp's shared-memory
//   reads and writes hit distinct banks (conv2d_ws.py: dw_plan).  The
//   rectangle's halo'd window lands in shared memory with cp.async (16, 8
//   or 4 bytes of a pixel's run where the run and its offsets allow, one
//   element where a channel multiplier repeats input channels; plain byte
//   loads for int8 runs no word fits), zero-filled at padding, the map's
//   edges and channels past K, then the run's weights [taps][kc].  Each
//   output starts at its bias and adds the taps in (dy, dx) order, FFMA in
//   f32 and a 32-bit integer multiply-add in int8 (channels do not sum, so
//   there is no dot product for dp4a or the tensor cores); at stride 1 and
//   dilation 1 with a 3-wide kernel a thread reads each window vector of
//   its strip's rows once and reuses it from registers across the taps
//   that read it (on the H100, 3-5% less device time than tap by tap on
//   mobilenet_small's 3x3 layers; at the 4-wide conv1d it was 7% more,
//   PERF.md section 6, so 4-wide and all other kernels read tap by tap).
//   The order of sums depends on nothing but the geometry, so the two
//   kernels, a whole-map and a tiled call, and two calls give the same
//   bits.  The epilogue stages the accumulators in a shared tile in place
//   of the window, then consecutive threads take 4 channels of a pixel
//   each: ReLU -> 2x2 max-pool (the rectangle is pool-aligned) ->
//   requantize, one 4-byte int8 or 16-byte store where K comes in fours
//   (else one channel a thread), the ragged edge masked.
//   conv2d_ws runs a block a (rectangle, run); conv2d_ws_pipe runs
//   persistent blocks that prefetch the next one's window into the other
//   slot of a 2-slot ring.
// * Narrow-output direct conv ("nk": C/groups > 1 and K/groups < 8, int8
//   or f32: the segmentation heads, narrow grouped layers).  The dw form
//   with a channel sum.  A block of 256 threads covers a pool-aligned
//   rectangle of conv-output pixels of one image for a run of `gr` groups
//   (1, 2, 4 or 8: the run that pads the groups least); a thread owns one
//   group and a strip of 4 pixels along a rectangle row, and holds all of
//   the group's K/g outputs (padded to an instantiation, 1, 2, 3, 4 or 8)
//   in registers that start at the bias.  The blocks are sized by the
//   geometry alone, not by the TilePlan.  The group's input channels go
//   in chunks of `cs` (the whole group where two slots of its window fit
//   half an SM, else the widest that do): a chunk's halo'd window lands
//   pixel-major in shared memory ([win_h][pitch], `cps` channels a group
//   at a pixel: cs rounded up to fours in f32, to 4, 8 or a multiple of
//   16 in int8, so that a lane reads one 4-, 8- or 16-byte vector at a
//   time; the row pitch padded so that a warp's reads hit distinct banks,
//   which aligns the rows to the vector) with cp.async (16, 8 or 4 bytes
//   where the run and its offsets allow: the vector at the heads; words
//   gathered byte by byte for int8 channels no copy fits), zero-filled at padding, the map's edges,
//   groups past the last and channels past the group (exact for
//   zero-point 0), and beside it the chunk's weights [gr][taps][cps/4][kp]
//   of 4-channel vectors.  int8 sums four channels a __dp4a into int32
//   (exact in any order); f32 runs FFMA in one fixed order: bias, then
//   chunk by chunk, tap by tap in (dy, dx) order, channels ascending (a
//   zero-filled channel adds +0), no TF32.  The order depends on the
//   geometry alone, so the two kernels, a whole-map and a tiled call give
//   the same bits.  The epilogue stages the accumulators in a shared tile
//   in place of the window (the row pitch padded against bank conflicts),
//   then consecutive threads take consecutive outputs of a pixel's run
//   and then the next pixel: ReLU -> 2x2 max-pool -> requantize, the
//   ragged edge masked.  conv2d_ws runs a block a (rectangle, run) and
//   loads each chunk, waits, then computes it; conv2d_ws_pipe runs the
//   same blocks and streams the chunks through a 2-slot cp.async ring (the
//   reference's ping-pong of window and weight bank), one slot where the
//   group takes one chunk or where two slots fit no block.  The run
//   shortens, then threads go without a strip, where a wide window does
//   not fit; a window no block holds once goes to the scalar kernel.
// * Scalar (a geometry no other plan takes, int8 or f32).  The first
//   port's form, one block per (image, TilePlan tile, kout bank) with a
//   loop over cin banks, int32 or f32 multiply-adds from shared memory
//   into a shared accumulator.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "hopper_common.cuh"

using hopper::cp_async_commit;
using hopper::cp_async_wait;
using hopper::cp_async_wait_pending;
using hopper::cp_async_zfill;
using hopper::mma_s8;

// Field order must match repro_torch/kernels/conv2d_ws.py:_GEOM_FIELDS.
struct ConvParams {
  int n, h, w, c, k;        // input map [N,H,W,C], K output channels
  int kh, kw, stride, dil;  // kernel extent, stride, tap dilation
  int pt, pl;               // top / left zero padding
  int cin_banks, cb;        // cin banks of one group, channels per bank
  int kout_banks, kb;       // kout banks, kernels per bank
  int cgrp, bpg;            // channels per group, kout banks per group
  int th, tw, n_th, n_tw;   // conv-output tile (pre-pool) and tile counts
  int in_th, in_tw;         // halo'd input window of one tile
  int pth, ptw, poh, pow_;  // epilogue tile and whole-map output extents
  int relu, pool;           // fused epilogue stages
  int xvec, wvec;           // cp.async chunk bytes (16/8/4), 0 = scalar
};

constexpr int kConvParamsFields = sizeof(ConvParams) / sizeof(int);
constexpr int kConvThreads = 256;

__host__ __device__ inline int align16(int bytes) { return (bytes + 15) & ~15; }

// Shared-memory layout: accumulator | input window slot(s) | weight slot(s).
// repro_torch/kernels/conv2d_ws.py:smem_bytes computes the same total.
template <typename Tin, typename Tacc>
struct SmemLayout {
  int acc_bytes, x_bytes, w_bytes;
  __host__ __device__ SmemLayout(const ConvParams& p)
      : acc_bytes(align16(p.th * p.tw * p.kb * (int)sizeof(Tacc))),
        x_bytes(align16(p.in_th * p.in_tw * p.cb * (int)sizeof(Tin))),
        w_bytes(align16(p.kh * p.kw * p.cb * p.kb * (int)sizeof(Tin))) {}
  __host__ __device__ int total(int slots) const {
    return acc_bytes + slots * (x_bytes + w_bytes);
  }
  __host__ __device__ int x_off(int slot) const { return acc_bytes + slot * x_bytes; }
  __host__ __device__ int w_off(int slots, int slot) const {
    return acc_bytes + slots * x_bytes + slot * w_bytes;
  }
};

// Block coordinates: blockIdx.x = tile * kout_banks + kout bank, blockIdx.y = image.
struct BlockCoord {
  int n, ty, tx, ko;
  __device__ BlockCoord(const ConvParams& p) {
    n = blockIdx.y;
    ko = blockIdx.x % p.kout_banks;
    int t = blockIdx.x / p.kout_banks;
    ty = t / p.n_tw;
    tx = t % p.n_tw;
  }
  // first input channel of cin bank `co`: the group's slice base + bank offset
  __device__ int chan(const ConvParams& p, int co) const {
    return (ko / p.bpg) * p.cgrp + co * p.cb;
  }
  __device__ int iy0(const ConvParams& p) const { return ty * p.th * p.stride - p.pt; }
  __device__ int ix0(const ConvParams& p) const { return tx * p.tw * p.stride - p.pl; }
};

// M5 bias preload: the accumulator starts as the bias of the bank's kernels.
template <typename Tacc>
__device__ void preload_bias(Tacc* acc, const Tacc* bias, const ConvParams& p,
                             int ko) {
  const int total = p.th * p.tw * p.kb;
  for (int i = threadIdx.x; i < total; i += blockDim.x)
    acc[i] = bias[ko * p.kb + i % p.kb];
}

// One cin-bank slab: every accumulator entry (pixel, kernel) adds the KH*KW
// taps of its halo'd window.  Each tap's channel sum is formed first and then
// added to the accumulator — the per-tap (TH*TW x CB)@(CB x KB) product order
// of the TPU kernel.  Neighbouring threads take neighbouring kernels: their
// input read is a broadcast and their weight reads are consecutive.
template <typename Tin, typename Tacc>
__device__ void accumulate_slab(Tacc* acc, const Tin* xs, const Tin* ws,
                                const ConvParams& p) {
  const int total = p.th * p.tw * p.kb;
  for (int o = threadIdx.x; o < total; o += blockDim.x) {
    const int kk = o % p.kb;
    const int pix = o / p.kb;
    const int ly = pix / p.tw, lx = pix % p.tw;
    Tacc a = acc[o];
    for (int dy = 0; dy < p.kh; ++dy) {
      for (int dx = 0; dx < p.kw; ++dx) {
        const Tin* xp = xs + ((ly * p.stride + dy * p.dil) * p.in_tw +
                              lx * p.stride + dx * p.dil) * p.cb;
        const Tin* wp = ws + (dy * p.kw + dx) * p.cb * p.kb + kk;
        Tacc t = 0;
        for (int c = 0; c < p.cb; ++c)
          t += static_cast<Tacc>(xp[c]) * static_cast<Tacc>(wp[c * p.kb]);
        a += t;
      }
    }
    acc[o] = a;
  }
}

template <typename Tacc>
__device__ inline Tacc relu_if(Tacc v, int relu) {
  return (relu && v < Tacc(0)) ? Tacc(0) : v;
}

// Fused epilogue on the finished accumulator: ReLU -> 2x2 max-pool (tiles are
// pool-aligned, so no window straddles a tile edge) -> requantize with
// rint (round half to even) and saturation, or the raw accumulator.
template <typename Tacc, bool REQUANT>
__device__ void epilogue(const Tacc* acc, const float* scale, void* out,
                         const ConvParams& p, const BlockCoord& bc) {
  const int total = p.pth * p.ptw * p.kb;
  for (int e = threadIdx.x; e < total; e += blockDim.x) {
    const int kk = e % p.kb;
    const int pp = e / p.kb;
    const int lpy = pp / p.ptw, lpx = pp % p.ptw;
    const int gy = bc.ty * p.pth + lpy, gx = bc.tx * p.ptw + lpx;
    if (gy >= p.poh || gx >= p.pow_) continue;  // trailing partial tile
    Tacc v;
    if (p.pool) {
      const int r0 = (2 * lpy) * p.tw + 2 * lpx;
      const int r1 = r0 + p.tw;
      v = relu_if(acc[r0 * p.kb + kk], p.relu);
      Tacc v1 = relu_if(acc[(r0 + 1) * p.kb + kk], p.relu);
      Tacc v2 = relu_if(acc[r1 * p.kb + kk], p.relu);
      Tacc v3 = relu_if(acc[(r1 + 1) * p.kb + kk], p.relu);
      v = v1 > v ? v1 : v;
      v = v2 > v ? v2 : v;
      v = v3 > v ? v3 : v;
    } else {
      v = relu_if(acc[(lpy * p.tw + lpx) * p.kb + kk], p.relu);
    }
    const int k = bc.ko * p.kb + kk;
    const long long oidx =
        ((static_cast<long long>(bc.n) * p.poh + gy) * p.pow_ + gx) * p.k + k;
    if (REQUANT) {
      float y = rintf(__fmul_rn(static_cast<float>(v), scale[k]));
      y = fminf(fmaxf(y, -128.0f), 127.0f);
      static_cast<int8_t*>(out)[oidx] = static_cast<int8_t>(y);
    } else {
      static_cast<Tacc*>(out)[oidx] = v;
    }
  }
}

// ---------------------------------------------------------------------------
// cp.async (both kernels on the tensor-core path, conv2d_ws_pipe on both):
// hopper_common.cuh's cp_async_zfill / cp_async_commit / cp_async_wait
// ---------------------------------------------------------------------------

// ---------------------------------------------------------------------------
// The int8 tensor-core path
// ---------------------------------------------------------------------------

// Field order must match repro_torch/kernels/conv2d_ws.py:TC_FIELDS; the
// host computes every field (conv2d_ws.py:tc_plan, tc_params).
struct TcParams {
  int n, h, w, c, k;              // input map [N,H,W,C], K output channels
  int kh, kw, stride, dil;        // kernel extent, stride, tap dilation
  int pt, pl;                     // top / left zero padding
  int cgrp, kgrp;                 // input / output channels per group
  int poh, pow_;                  // epilogue output extents
  int relu, pool;                 // fused epilogue stages
  int rh, rw, n_ry, n_rx;         // block rectangle, rectangles per image
  int bn, n_nt;                   // N-tile width (32 or 64), N-tiles a group
  int cs, n_slices;               // channels per K-chunk, K-chunks
  int taps, ksp, kpad;            // kh*kw, chunk K (x32), packed row (x32)
  int win_h, win_w, ps, ws;       // window extents, bytes a window pixel,
                                  // bytes a weight-slab row
  int wruns, wrun, wsrc_step;     // weight slab: runs a row, bytes a run,
                                  // packed stride between runs
  int wfill;                      // slab columns [wfill, ksp) stay zero
  int word;                       // 1: an A word is one 32-bit load
  int stages, slots;              // ring depth, slots in shared memory
  int win_bytes, slot_bytes;      // one slot: window | weight slab
  int slot0, smem;                // slot 0 (after the K table), total
  int xvec, wvec;                 // copy widths (16/8/4; 1 = byte loads)
};

constexpr int kTcParamsFields = sizeof(TcParams) / sizeof(int);
constexpr int kTcBM = 128;  // rows (pixels) of a block: 4 warps x 32

// blockIdx.x = (image, rectangle row, rectangle column), blockIdx.y =
// (group, N-tile).
struct TcBlock {
  int img, ry, rx, grp, nt;
  __device__ explicit TcBlock(const TcParams& p) {
    const int per = p.n_ry * p.n_rx;
    img = blockIdx.x / per;
    const int r = blockIdx.x - img * per;
    ry = r / p.n_rx;
    rx = r - ry * p.n_rx;
    grp = blockIdx.y / p.n_nt;
    nt = blockIdx.y - grp * p.n_nt;
  }
};

// K table of a chunk: column j = (tap, channel) -> byte offset from a row's
// window origin, -1 for a padded column.  The same for every chunk.
__device__ inline void tc_build_table(int* tbl, const TcParams& p) {
  for (int j = threadIdx.x; j < p.ksp; j += blockDim.x) {
    const int tap = j / p.cs, c = j - tap * p.cs;
    tbl[j] = tap < p.taps
                 ? ((tap / p.kw) * p.dil * p.win_w + (tap % p.kw) * p.dil) *
                           p.ps + c
                 : -1;
  }
}

// Window origin of block row m (pixel (m / rw, m % rw) of the rectangle).
__device__ inline int tc_row_base(const TcParams& p, int m) {
  return ((m / p.rw) * p.stride * p.win_w + (m % p.rw) * p.stride) * p.ps;
}

// This thread's four fragment rows: 32*warp_m + 16*mi + lane/4 (+ 8).
__device__ inline void tc_row_bases(int (&rb)[2][2], const TcParams& p) {
  const int m0 = 32 * ((threadIdx.x >> 5) & 3) + ((threadIdx.x & 31) >> 2);
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
    rb[mi][0] = tc_row_base(p, m0 + 16 * mi);
    rb[mi][1] = tc_row_base(p, m0 + 16 * mi + 8);
  }
}

// Zero the weight slab's padded columns [wfill, ksp), which no copy writes.
__device__ inline void tc_zero_tail(int8_t* wsl, const TcParams& p) {
  const int tail = p.ksp - p.wfill;
  for (int i = threadIdx.x; i < p.bn * tail; i += blockDim.x)
    wsl[(i / tail) * p.ws + p.wfill + i % tail] = 0;
}

// Issue the copies of K-chunk `s` (input channels grp*cgrp + s*cs ...) into
// one slot: the rectangle's halo'd window and the N-tile's weight slab.  Not
// committed or waited here; byte copies (xvec / wvec 1) are plain stores.
__device__ inline void tc_issue_chunk(int8_t* win, int8_t* wsl,
                                      const int8_t* x, const int8_t* wp,
                                      const TcParams& p, const TcBlock& bc,
                                      int s) {
  const int c0 = bc.grp * p.cgrp + s * p.cs;
  const int iy0 = bc.ry * p.rh * p.stride - p.pt;
  const int ix0 = bc.rx * p.rw * p.stride - p.pl;
  const long long img = static_cast<long long>(bc.img) * p.h;
  const int npix = p.win_h * p.win_w;
  const int xch = p.cs / p.xvec;
  for (int i = threadIdx.x; i < npix * xch; i += blockDim.x) {
    const int pix = i / xch, ch = i - pix * xch;
    const int iy = iy0 + pix / p.win_w, ix = ix0 + pix % p.win_w;
    const bool in = iy >= 0 && iy < p.h && ix >= 0 && ix < p.w;
    const long long src =
        in ? ((img + iy) * p.w + ix) * p.c + c0 + ch * p.xvec : 0;
    int8_t* dst = win + pix * p.ps + ch * p.xvec;
    if (p.xvec > 1)
      cp_async_zfill(dst, x + src, p.xvec, in ? p.xvec : 0);
    else
      *dst = in ? x[src] : int8_t(0);
  }
  const int n0 = bc.nt * p.bn;
  const int wch = p.wrun / p.wvec;
  const int per_row = p.wruns * wch;
  for (int i = threadIdx.x; i < p.bn * per_row; i += blockDim.x) {
    const int row = i / per_row, rem = i - row * per_row;
    const int run = rem / wch, ch = rem - run * wch;
    const bool ok = n0 + row < p.kgrp;
    const long long src =
        ok ? static_cast<long long>(bc.grp * p.kgrp + n0 + row) * p.kpad +
                 run * p.wsrc_step + s * p.cs + ch * p.wvec
           : 0;
    int8_t* dst = wsl + row * p.ws + run * p.cs + ch * p.wvec;
    if (p.wvec > 1)
      cp_async_zfill(dst, wp + src, p.wvec, ok ? p.wvec : 0);
    else
      *dst = ok ? wp[src] : int8_t(0);
  }
}

// M5 bias preload: every accumulator fragment starts at its kernel's bias
// (0 for the masked columns past the group's width).
template <int NT>
__device__ inline void tc_init_acc(int (&acc)[2][NT][4], const int32_t* bias,
                                   const TcParams& p, const TcBlock& bc) {
  const int t = threadIdx.x & 3;
  const int col0 = (threadIdx.x >> 7) * 8 * NT + 2 * t;
#pragma unroll
  for (int ni = 0; ni < NT; ++ni) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int n = bc.nt * p.bn + col0 + 8 * ni + e;
      const int v = n < p.kgrp ? bias[bc.grp * p.kgrp + n] : 0;
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        acc[mi][ni][e] = v;
        acc[mi][ni][2 + e] = v;
      }
    }
  }
}

__device__ inline uint32_t lds_u32(const int8_t* ptr) {
  return *reinterpret_cast<const uint32_t*>(ptr);
}

// Four K columns of one row, one byte each (a chunk whose channels do not
// come in fours); a negative offset is a padded column.
__device__ inline uint32_t gather_u32(const int8_t* row, const int (&o)[4]) {
  uint32_t v = 0;
#pragma unroll
  for (int q = 0; q < 4; ++q)
    if (o[q] >= 0)
      v |= static_cast<uint32_t>(static_cast<uint8_t>(row[o[q]])) << (8 * q);
  return v;
}

// One K-chunk from a slot: ksp/32 steps of 2 x NT mma per warp.  Fragment
// layout of m16n8k32 (g = lane/4, t = lane%4): a0 row g, k 4t..4t+3; a1 row
// g+8; a2 / a3 the same rows at k 16+4t; b0 column g, k 4t..4t+3; b1 k 16+4t.
template <int NT>
__device__ inline void tc_mma_chunk(int (&acc)[2][NT][4], const int8_t* win,
                                    const int8_t* wsl, const int* tbl,
                                    const int (&rb)[2][2], const TcParams& p) {
  const int lane = threadIdx.x & 31;
  const int t = lane & 3;
  const int8_t* wrow =
      wsl + ((threadIdx.x >> 7) * 8 * NT + (lane >> 2)) * p.ws + 4 * t;
  for (int ks = 0; ks < p.ksp; ks += 32) {
    uint32_t a[2][4];
    if (p.word) {
      const int o0 = tbl[ks + 4 * t], o1 = tbl[ks + 16 + 4 * t];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          a[mi][h] = o0 < 0 ? 0u : lds_u32(win + rb[mi][h] + o0);
          a[mi][2 + h] = o1 < 0 ? 0u : lds_u32(win + rb[mi][h] + o1);
        }
      }
    } else {
      int o0[4], o1[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        o0[q] = tbl[ks + 4 * t + q];
        o1[q] = tbl[ks + 16 + 4 * t + q];
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          a[mi][h] = gather_u32(win + rb[mi][h], o0);
          a[mi][2 + h] = gather_u32(win + rb[mi][h], o1);
        }
      }
    }
    uint32_t b[NT][2];
#pragma unroll
    for (int ni = 0; ni < NT; ++ni) {
      const int8_t* bp = wrow + ni * 8 * p.ws + ks;
      b[ni][0] = lds_u32(bp);
      b[ni][1] = lds_u32(bp + 16);
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < NT; ++ni) mma_s8(acc[mi][ni], a[mi], b[ni]);
  }
}

// Epilogue: the int32 tile goes through shared memory (a 2x2 pool window's
// four accumulators sit in different threads' fragments), then ReLU -> 2x2
// max-pool -> requantize as the scalar `epilogue` does.  Where K and K/g
// come in fours a thread owns four consecutive channels of a pixel: 16-byte
// reads of the tile, its four scales loaded once, and one 4-byte (int8) or
// 16-byte (int32) store; rectangle extents are powers of two, so a pixel's
// place is a shift and a mask.  Otherwise one channel a thread.  `tile` may
// alias the ring: the caller has waited for every copy and synchronised.
template <int NT, bool REQUANT>
__device__ inline void tc_epilogue(const int (&acc)[2][NT][4], int* tile,
                                   const float* scale, void* out,
                                   const TcParams& p, const TcBlock& bc) {
  constexpr int BN = 16 * NT;
  constexpr int AS = BN + 8;  // row stride: 64-bit stores of a half warp
                              // land on distinct banks
  const int lane = threadIdx.x & 31;
  const int row0 = 32 * ((threadIdx.x >> 5) & 3) + (lane >> 2);
  const int col0 = (threadIdx.x >> 7) * 8 * NT + 2 * (lane & 3);
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int ni = 0; ni < NT; ++ni) {
      int* dst = tile + (row0 + 16 * mi) * AS + col0 + 8 * ni;
      *reinterpret_cast<int2*>(dst) = make_int2(acc[mi][ni][0], acc[mi][ni][1]);
      *reinterpret_cast<int2*>(dst + 8 * AS) =
          make_int2(acc[mi][ni][2], acc[mi][ni][3]);
    }
  }
  __syncthreads();
  const int ph = p.pool ? p.rh / 2 : p.rh, pw = p.pool ? p.rw / 2 : p.rw;
  const int sh = __ffs(pw) - 1;  // pw is a power of two
  const long long img = static_cast<long long>(bc.img) * p.poh;
  if (p.k % 4 == 0 && p.kgrp % 4 == 0) {
    constexpr int QUADS = BN / 4, LANES = kConvThreads / QUADS;
    const int kk = 4 * (threadIdx.x % QUADS);
    const int n = bc.nt * BN + kk;
    if (n >= p.kgrp) return;
    const int k = bc.grp * p.kgrp + n;
    float sc[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) sc[j] = REQUANT ? scale[k + j] : 0.0f;
    for (int pp = threadIdx.x / QUADS; pp < ph * pw; pp += LANES) {
      const int ly = pp >> sh, lx = pp & (pw - 1);
      const int gy = bc.ry * ph + ly, gx = bc.rx * pw + lx;
      if (gy >= p.poh || gx >= p.pow_) continue;
      int v[4];
      if (p.pool) {
        const int r0 = (2 * ly) * p.rw + 2 * lx;
        const int rows[4] = {r0, r0 + 1, r0 + p.rw, r0 + p.rw + 1};
        int m[4][4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int4 t = *reinterpret_cast<const int4*>(tile + rows[r] * AS + kk);
          m[r][0] = relu_if(t.x, p.relu);
          m[r][1] = relu_if(t.y, p.relu);
          m[r][2] = relu_if(t.z, p.relu);
          m[r][3] = relu_if(t.w, p.relu);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          int a = m[0][j];
          a = m[1][j] > a ? m[1][j] : a;
          a = m[2][j] > a ? m[2][j] : a;
          a = m[3][j] > a ? m[3][j] : a;
          v[j] = a;
        }
      } else {
        const int4 t =
            *reinterpret_cast<const int4*>(tile + (ly * p.rw + lx) * AS + kk);
        v[0] = relu_if(t.x, p.relu);
        v[1] = relu_if(t.y, p.relu);
        v[2] = relu_if(t.z, p.relu);
        v[3] = relu_if(t.w, p.relu);
      }
      const long long oidx = ((img + gy) * p.pow_ + gx) * p.k + k;
      if (REQUANT) {
        uint32_t word = 0;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float y = rintf(__fmul_rn(static_cast<float>(v[j]), sc[j]));
          y = fminf(fmaxf(y, -128.0f), 127.0f);
          word |= static_cast<uint32_t>(static_cast<uint8_t>(
                      static_cast<int8_t>(y))) << (8 * j);
        }
        *reinterpret_cast<uint32_t*>(static_cast<int8_t*>(out) + oidx) = word;
      } else {
        *reinterpret_cast<int4*>(static_cast<int32_t*>(out) + oidx) =
            make_int4(v[0], v[1], v[2], v[3]);
      }
    }
    return;
  }
  for (int e = threadIdx.x; e < ph * pw * BN; e += blockDim.x) {
    const int kk = e % BN, pp = e / BN;
    const int ly = pp >> sh, lx = pp & (pw - 1);
    const int gy = bc.ry * ph + ly, gx = bc.rx * pw + lx;
    const int n = bc.nt * BN + kk;
    if (gy >= p.poh || gx >= p.pow_ || n >= p.kgrp) continue;
    int v;
    if (p.pool) {
      const int r0 = (2 * ly) * p.rw + 2 * lx, r1 = r0 + p.rw;
      v = relu_if(tile[r0 * AS + kk], p.relu);
      const int v1 = relu_if(tile[(r0 + 1) * AS + kk], p.relu);
      const int v2 = relu_if(tile[r1 * AS + kk], p.relu);
      const int v3 = relu_if(tile[(r1 + 1) * AS + kk], p.relu);
      v = v1 > v ? v1 : v;
      v = v2 > v ? v2 : v;
      v = v3 > v ? v3 : v;
    } else {
      v = relu_if(tile[(ly * p.rw + lx) * AS + kk], p.relu);
    }
    const int k = bc.grp * p.kgrp + n;
    const long long oidx = ((img + gy) * p.pow_ + gx) * p.k + k;
    if (REQUANT) {
      float y = rintf(__fmul_rn(static_cast<float>(v), scale[k]));
      y = fminf(fmaxf(y, -128.0f), 127.0f);
      static_cast<int8_t*>(out)[oidx] = static_cast<int8_t>(y);
    } else {
      static_cast<int32_t*>(out)[oidx] = v;
    }
  }
}

// ---------------------------------------------------------------------------
// The f32 simt path
// ---------------------------------------------------------------------------

// Field order must match repro_torch/kernels/conv2d_ws.py:SIMT_FIELDS; the
// host computes every field (conv2d_ws.py:simt_plan, simt_params).
struct SimtParams {
  int n, h, w, c, k;              // input map [N,H,W,C], K output channels
  int kh, kw, stride, dil;        // kernel extent, stride, tap dilation
  int pt, pl;                     // top / left zero padding
  int cgrp, kgrp;                 // input / output channels per group
  int oh, ow, poh, pow_;          // conv-output (pool-trimmed) and epilogue
                                  // output extents
  int relu, pool;                 // fused epilogue stages
  int rh, rw, n_ry, n_rx;         // block rectangle, rectangles per image
  int bn, n_nt;                   // N-tile width (32/64/128), N-tiles a group
  int cs, n_chunks;               // channels per K-chunk, K-chunks a group
  int split, kcs;                 // K slices (blockIdx.z), chunks a slice
  int taps, win_h, win_w, ps;     // kh*kw, window extents, floats a pixel
  int win_floats, slot_floats;    // one slot: window | weight slab
  int stages, slots, smem;        // ring depth, slots, shared bytes
  int wvec;                       // weight copy width in floats (4 or 1)
};

constexpr int kSimtParamsFields = sizeof(SimtParams) / sizeof(int);
constexpr int kSimtTM = 8, kSimtTN = 8;  // outputs a thread: pixels x channels
constexpr int kSimtTilePad = 4;          // epilogue tile row: BN + 4 floats

// The thread layout of a BN-wide block: CT = BN/8 threads across the
// N-tile (tx = tid % CT), RT = 256/CT down the pixels (ty = tid / CT).
// Thread (ty, tx) owns pixels ty + RT*i (i < 8) of the rectangle and
// channels tx*4 + u and 4*CT + tx*4 + u (u < 4) of the N-tile, so a warp's
// 32/CT pixels of one load are consecutive in one rectangle row (the plan
// keeps rw >= 32/CT) and its weight reads are one contiguous run.
template <int BN>
struct SimtLayout {
  static constexpr int CT = BN / kSimtTN;
  static constexpr int RT = kConvThreads / CT;
  static constexpr int BM = RT * kSimtTM;
  static constexpr int TS = BN + kSimtTilePad;  // epilogue tile row stride
};

template <int BN>
__device__ __forceinline__ int simt_col(int tx, int j) {
  return (j / 4) * 4 * SimtLayout<BN>::CT + tx * 4 + (j % 4);
}

// blockIdx.x = (image, rectangle row, rectangle column), blockIdx.y =
// (group, N-tile), blockIdx.z = K slice.
struct SimtBlock {
  int img, ry, rx, grp, nt, slice;
  __device__ explicit SimtBlock(const SimtParams& p) {
    const int per = p.n_ry * p.n_rx;
    img = blockIdx.x / per;
    const int r = blockIdx.x - img * per;
    ry = r / p.n_rx;
    rx = r - ry * p.n_rx;
    grp = blockIdx.y / p.n_nt;
    nt = blockIdx.y - grp * p.n_nt;
    slice = blockIdx.z;
  }
};

// Window offsets (floats) of the thread's 8 pixels: pixel m of the
// rectangle is (m / rw, m % rw), and its window origin sits
// ((m / rw) * stride * win_w + (m % rw) * stride) * ps floats into the
// pixel-major window slab (conv2d_ws.py: simt_windows).
template <int BN>
__device__ inline void simt_row_bases(int (&rb)[kSimtTM], const SimtParams& p) {
  using L = SimtLayout<BN>;
  const int ty = threadIdx.x / L::CT;
#pragma unroll
  for (int i = 0; i < kSimtTM; ++i) {
    const int m = ty + L::RT * i;
    rb[i] = ((m / p.rw) * p.stride * p.win_w + (m % p.rw) * p.stride) * p.ps;
  }
}

// M5 bias preload: every accumulator starts at its kernel's bias (0 for the
// columns past the group's width, and for every column of a K slice, whose
// partial sums the reduce adds to the bias).
template <int BN>
__device__ inline void simt_init_acc(float (&acc)[kSimtTM][kSimtTN],
                                     const float* bias, const SimtParams& p,
                                     const SimtBlock& bc) {
  const int tx = threadIdx.x % SimtLayout<BN>::CT;
#pragma unroll
  for (int j = 0; j < kSimtTN; ++j) {
    const int n = bc.nt * BN + simt_col<BN>(tx, j);
    const float b =
        p.split == 1 && n < p.kgrp ? bias[bc.grp * p.kgrp + n] : 0.0f;
#pragma unroll
    for (int i = 0; i < kSimtTM; ++i) acc[i][j] = b;
  }
}

// Issue the copies of K-chunk `s` (input channels grp*cgrp + s*cs ...) into
// one slot, not committed or waited here: the rectangle's halo'd window,
// pixel-major with `ps` floats a pixel (four-byte copies; an odd `ps` puts
// a warp's pixels of one load on distinct banks at stride 1, 2 and 4), and
// the weight slab [taps*cs][BN], row (tap, c) copied from w's row
// tap*cgrp + s*cs + c, which is contiguous in K (16-byte copies where
// wvec is 4).  Padding, map edges and columns past the group's width are
// zero-filled by the copy.
__device__ inline void simt_issue_chunk(float* win, float* wsl, const float* x,
                                        const float* w, const SimtParams& p,
                                        const SimtBlock& bc, int s) {
  const int c0 = bc.grp * p.cgrp + s * p.cs;
  const int iy0 = bc.ry * p.rh * p.stride - p.pt;
  const int ix0 = bc.rx * p.rw * p.stride - p.pl;
  const long long img = static_cast<long long>(bc.img) * p.h;
  const int npix = p.win_h * p.win_w;
  for (int i = threadIdx.x; i < npix * p.cs; i += blockDim.x) {
    const int pix = i / p.cs, ch = i - pix * p.cs;
    const int wy = pix / p.win_w;
    const int iy = iy0 + wy, ix = ix0 + pix - wy * p.win_w;
    const bool in = iy >= 0 && iy < p.h && ix >= 0 && ix < p.w;
    const float* src = in ? x + ((img + iy) * p.w + ix) * p.c + c0 + ch : x;
    cp_async_zfill(win + pix * p.ps + ch, src, 4, in ? 4 : 0);
  }
  const int vecs = p.bn / p.wvec;
  const int rows = p.taps * p.cs;
  for (int i = threadIdx.x; i < rows * vecs; i += blockDim.x) {
    const int r = i / vecs, v = i - r * vecs;
    const int tap = r / p.cs, ch = r - tap * p.cs;
    const int col = bc.nt * p.bn + v * p.wvec;
    const bool ok = col < p.kgrp;
    const float* src =
        ok ? w + (static_cast<long long>(tap) * p.cgrp + s * p.cs + ch) * p.k +
                 bc.grp * p.kgrp + col
           : w;
    cp_async_zfill(wsl + r * p.bn + v * p.wvec, src, 4 * p.wvec,
                   ok ? 4 * p.wvec : 0);
  }
}

// One K-chunk from a slot: taps x cs steps, in (tap, channel) order, of
// 8 window reads (one float per pixel, the warp's distinct pixels on
// distinct banks), two float4 weight reads and 64 FFMAs per thread.
template <int BN>
__device__ inline void simt_chunk(float (&acc)[kSimtTM][kSimtTN],
                                  const float* win, const float* wsl,
                                  const int (&rb)[kSimtTM],
                                  const SimtParams& p) {
  using L = SimtLayout<BN>;
  const float* wcol = wsl + (threadIdx.x % L::CT) * 4;
  for (int dy = 0; dy < p.kh; ++dy) {
    for (int dx = 0; dx < p.kw; ++dx) {
      const float* xt = win + (dy * p.dil * p.win_w + dx * p.dil) * p.ps;
      const float* wt = wcol + (dy * p.kw + dx) * p.cs * BN;
#pragma unroll 2
      for (int c = 0; c < p.cs; ++c) {
        float a[kSimtTM], b[kSimtTN];
#pragma unroll
        for (int i = 0; i < kSimtTM; ++i) a[i] = xt[rb[i] + c];
        const float4 b0 = *reinterpret_cast<const float4*>(wt + c * BN);
        const float4 b1 =
            *reinterpret_cast<const float4*>(wt + c * BN + 4 * L::CT);
        b[0] = b0.x, b[1] = b0.y, b[2] = b0.z, b[3] = b0.w;
        b[4] = b1.x, b[5] = b1.y, b[6] = b1.z, b[7] = b1.w;
#pragma unroll
        for (int i = 0; i < kSimtTM; ++i)
#pragma unroll
          for (int j = 0; j < kSimtTN; ++j)
            acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }
  }
}

// One output value: f32, or rint(v * scale[k]) clipped to int8.
template <bool REQUANT>
__device__ __forceinline__ void simt_store(void* out, long long oidx, float v,
                                           const float* scale, int k) {
  if (REQUANT) {
    float y = rintf(__fmul_rn(v, scale[k]));
    y = fminf(fmaxf(y, -128.0f), 127.0f);
    static_cast<int8_t*>(out)[oidx] = static_cast<int8_t>(y);
  } else {
    static_cast<float*>(out)[oidx] = v;
  }
}

// The block's end: the f32 tile goes through shared memory ([BM][BN + 4],
// aliasing the ring: the caller has waited for every copy and
// synchronised), then either the epilogue (ReLU -> 2x2 max-pool inside the
// rectangle -> requantize, the ragged edge masked) or, where K is split,
// the slice's partial sums of the valid pixels and columns into
// part[slice][n][oh][ow][k] for the reduce.
template <int BN, bool REQUANT>
__device__ inline void simt_finish(const float (&acc)[kSimtTM][kSimtTN],
                                   float* tile, const float* scale, void* out,
                                   float* part, const SimtParams& p,
                                   const SimtBlock& bc) {
  using L = SimtLayout<BN>;
  const int ty = threadIdx.x / L::CT, tx = threadIdx.x % L::CT;
#pragma unroll
  for (int i = 0; i < kSimtTM; ++i) {
    float* row = tile + (ty + L::RT * i) * L::TS + tx * 4;
    *reinterpret_cast<float4*>(row) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    *reinterpret_cast<float4*>(row + 4 * L::CT) =
        make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
  }
  __syncthreads();
  if (p.split > 1) {
    const long long base = static_cast<long long>(bc.slice) * p.n + bc.img;
    for (int e = threadIdx.x; e < L::BM * BN; e += blockDim.x) {
      const int m = e / BN, nn = e % BN;
      const int oy = bc.ry * p.rh + m / p.rw, ox = bc.rx * p.rw + m % p.rw;
      const int col = bc.nt * BN + nn;
      if (oy >= p.oh || ox >= p.ow || col >= p.kgrp) continue;
      part[((base * p.oh + oy) * p.ow + ox) * p.k + bc.grp * p.kgrp + col] =
          tile[m * L::TS + nn];
    }
    return;
  }
  const int ph = p.pool ? p.rh / 2 : p.rh, pw = p.pool ? p.rw / 2 : p.rw;
  const long long img = static_cast<long long>(bc.img) * p.poh;
  for (int e = threadIdx.x; e < ph * pw * BN; e += blockDim.x) {
    const int kk = e % BN, pp = e / BN;
    const int ly = pp / pw, lx = pp - ly * pw;
    const int gy = bc.ry * ph + ly, gx = bc.rx * pw + lx;
    const int n = bc.nt * BN + kk;
    if (gy >= p.poh || gx >= p.pow_ || n >= p.kgrp) continue;
    float v;
    if (p.pool) {
      const int r0 = (2 * ly) * p.rw + 2 * lx, r1 = r0 + p.rw;
      v = relu_if(tile[r0 * L::TS + kk], p.relu);
      const float v1 = relu_if(tile[(r0 + 1) * L::TS + kk], p.relu);
      const float v2 = relu_if(tile[r1 * L::TS + kk], p.relu);
      const float v3 = relu_if(tile[(r1 + 1) * L::TS + kk], p.relu);
      v = v1 > v ? v1 : v;
      v = v2 > v ? v2 : v;
      v = v3 > v ? v3 : v;
    } else {
      v = relu_if(tile[(ly * p.rw + lx) * L::TS + kk], p.relu);
    }
    const int k = bc.grp * p.kgrp + n;
    simt_store<REQUANT>(out, ((img + gy) * p.pow_ + gx) * p.k + k, v, scale,
                        k);
  }
}

// The K split's second kernel: each output (image, y, x, k) of the epilogue
// adds bias and the slices' partial sums in slice order at each conv-output
// pixel of its pool window, then ReLU -> 2x2 max-pool -> requantize as
// simt_finish does.  No atomics, so a call gives the same bits every run.
template <bool REQUANT>
__global__ void __launch_bounds__(256)
conv_simt_reduce_kernel(const float* __restrict__ part,
                        const float* __restrict__ bias,
                        const float* __restrict__ scale,
                        void* __restrict__ out, SimtParams p) {
  const long long total = static_cast<long long>(p.n) * p.poh * p.pow_ * p.k;
  const long long e = static_cast<long long>(blockIdx.x) * 256 + threadIdx.x;
  if (e >= total) return;
  const int k = static_cast<int>(e % p.k);
  long long r = e / p.k;
  const int gx = static_cast<int>(r % p.pow_);
  r /= p.pow_;
  const int gy = static_cast<int>(r % p.poh);
  const long long img = r / p.poh;
  const long long slice = static_cast<long long>(p.n) * p.oh * p.ow * p.k;
  auto acc_at = [&](int oy, int ox) {
    const long long i = ((img * p.oh + oy) * p.ow + ox) * p.k + k;
    float v = bias[k];
    for (int s = 0; s < p.split; ++s) v += part[s * slice + i];
    return relu_if(v, p.relu);
  };
  float v;
  if (p.pool) {
    v = acc_at(2 * gy, 2 * gx);
    const float v1 = acc_at(2 * gy, 2 * gx + 1);
    const float v2 = acc_at(2 * gy + 1, 2 * gx);
    const float v3 = acc_at(2 * gy + 1, 2 * gx + 1);
    v = v1 > v ? v1 : v;
    v = v2 > v ? v2 : v;
    v = v3 > v ? v3 : v;
  } else {
    v = acc_at(gy, gx);
  }
  simt_store<REQUANT>(out, e, v, scale, k);
}

// After a simt launch: the launch's error, then, where K is split, the
// reduce on the same stream.
template <bool REQUANT>
inline int simt_reduce(const void* part, const void* bias, const float* scale,
                       void* out, const SimtParams& p, cudaStream_t stream) {
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || p.split == 1) return static_cast<int>(err);
  const long long total = static_cast<long long>(p.n) * p.poh * p.pow_ * p.k;
  conv_simt_reduce_kernel<REQUANT>
      <<<static_cast<unsigned>((total + 255) / 256), 256, 0, stream>>>(
          static_cast<const float*>(part), static_cast<const float*>(bias),
          scale, out, p);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// The depthwise path ("dw")
// ---------------------------------------------------------------------------

// Field order must match repro_torch/kernels/conv2d_ws.py:DW_FIELDS; the
// host computes every field (conv2d_ws.py:dw_plan, dw_params).
struct DwParams {
  int n, h, w, c, k;              // input map [N,H,W,C], K output channels
  int kh, kw, stride, dil;        // kernel extent, stride, tap dilation
  int pt, pl;                     // top / left zero padding
  int mult;                       // K/groups: channel k reads k / mult
  int oh, ow, poh, pow_;          // conv-output (pool-trimmed) and epilogue
                                  // output extents
  int relu, pool;                 // fused epilogue stages
  int rh, rw, n_ry, n_rx;         // block rectangle, rectangles per image
  int kc, n_kc, cv;               // channels a run, runs, vectors a run
  int win_h, win_w, pitch;        // window extents, elements a window row
  int tpitch;                     // accumulators a tile row
  int win_bytes, slot_bytes;      // one slot: window | weights [taps][kc]
  int slots, smem;                // 1 (conv2d_ws) or 2 slots, shared bytes
  int n_rect;                     // rectangles x runs in all
  int xvec, wvec;                 // copy bytes (16/8/4; 0 = per element)
  int ovec;                       // output channels a store (4 or 1)
};

constexpr int kDwParamsFields = sizeof(DwParams) / sizeof(int);
constexpr int kDwV = 4;   // channels a thread's vector
constexpr int kDwSP = 4;  // conv-output pixels a thread's strip

// A thread's place in its block: channel vector `vec` of the run, strip
// `col` (pixels col*kDwSP ...) of rectangle row `row`.  Vectors are fastest
// and rows next, so a warp's strips lie in consecutive rows of one strip
// column (conv2d_ws.py: dw_thread; the row pitches keep its reads and
// writes of shared memory on distinct banks).  Where the plan's rectangle
// has fewer strips than the block has threads for (a window too wide for
// more), the threads past them own none (`on` false): they copy and store.
struct DwThread {
  int vec, row, col;
  bool on;
  __device__ explicit DwThread(const DwParams& p) {
    vec = threadIdx.x % p.cv;
    const int u = threadIdx.x / p.cv;
    row = u % p.rh;
    col = u / p.rh;
    on = col < p.rw / kDwSP;
  }
};

// Work item r: (image, rectangle row, rectangle column, channel run), the
// run fastest, so the blocks running together read whole pixels of a map.
struct DwRect {
  int img, ry, rx, k0;
  __device__ DwRect(const DwParams& p, int r) {
    k0 = (r % p.n_kc) * p.kc;
    r /= p.n_kc;
    rx = r % p.n_rx;
    r /= p.n_rx;
    ry = r % p.n_ry;
    img = r / p.n_ry;
  }
};

// One channel vector in shared memory: 4 floats, or 4 int8 in a word.
__device__ __forceinline__ void dw_load(const float* src, float (&v)[kDwV]) {
  const float4 t = *reinterpret_cast<const float4*>(src);
  v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
}
__device__ __forceinline__ void dw_load(const int8_t* src, int (&v)[kDwV]) {
  const uint32_t t = *reinterpret_cast<const uint32_t*>(src);
#pragma unroll
  for (int j = 0; j < kDwV; ++j)  // sign-extend byte j
    v[j] = static_cast<int>(t << (24 - 8 * j)) >> 24;
}
// Four int32 accumulators of the tile (the f32 ones load as a window does).
__device__ __forceinline__ void dw_load(const int* src, int (&v)[kDwV]) {
  const int4 t = *reinterpret_cast<const int4*>(src);
  v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
}

__device__ __forceinline__ float dw_mad(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ int dw_mad(int a, int b, int c) { return a * b + c; }

// Issue the copies of work item `rc` into one slot, not committed or
// waited here: the rectangle's halo'd window [win_h][pitch] (pixel wx of
// row wy at wy*pitch + wx*kc, kc channels of the run), then the run's
// weights [taps][kc] from w [KH,KW,1,K].  With xvec / wvec a copy moves
// 16, 8 or 4 bytes of one pixel's run (or one tap's row); with 0 one
// element, channel k of the run reading input channel k / mult (cp.async
// for f32, a plain load and store for int8).  Padding, the map's edges and
// channels past K are zero-filled by the copy (exact for zero-point 0).
template <typename Tin>
__device__ inline void dw_issue(unsigned char* slot, const Tin* x,
                                const Tin* w, const DwParams& p,
                                const DwRect& rc) {
  constexpr int es = sizeof(Tin);
  Tin* win = reinterpret_cast<Tin*>(slot);
  Tin* wsm = reinterpret_cast<Tin*>(slot + p.win_bytes);
  const int iy0 = rc.ry * p.rh * p.stride - p.pt;
  const int ix0 = rc.rx * p.rw * p.stride - p.pl;
  const long long img = static_cast<long long>(rc.img) * p.h;
  const int npix = p.win_h * p.win_w;
  if (p.xvec) {  // chunks a pixel's run: a power of two, as kc is
    const int cpc = p.xvec / es, per = p.kc / cpc, lper = __ffs(per) - 1;
    for (int i = threadIdx.x; i < npix * per; i += blockDim.x) {
      const int pix = i >> lper, q = i & (per - 1);
      const int wy = pix / p.win_w, wx = pix - wy * p.win_w;
      const int iy = iy0 + wy, ix = ix0 + wx, ch = rc.k0 + q * cpc;
      const bool in = iy >= 0 && iy < p.h && ix >= 0 && ix < p.w && ch < p.c;
      const Tin* src = in ? x + ((img + iy) * p.w + ix) * p.c + ch : x;
      cp_async_zfill(win + wy * p.pitch + wx * p.kc + q * cpc, src, p.xvec,
                     in ? p.xvec : 0);
    }
  } else {
    const int lkc = __ffs(p.kc) - 1;
    for (int i = threadIdx.x; i < npix * p.kc; i += blockDim.x) {
      const int pix = i >> lkc, kk = i & (p.kc - 1);
      const int wy = pix / p.win_w, wx = pix - wy * p.win_w;
      const int iy = iy0 + wy, ix = ix0 + wx, k = rc.k0 + kk;
      const bool in = iy >= 0 && iy < p.h && ix >= 0 && ix < p.w && k < p.k;
      const Tin* src =
          in ? x + ((img + iy) * p.w + ix) * p.c + k / p.mult : x;
      Tin* dst = win + wy * p.pitch + wx * p.kc + kk;
      if (es == 4)
        cp_async_zfill(dst, src, 4, in ? 4 : 0);
      else
        *dst = in ? *src : Tin(0);
    }
  }
  const int taps = p.kh * p.kw;
  if (p.wvec) {
    const int cpc = p.wvec / es, per = p.kc / cpc;
    for (int i = threadIdx.x; i < taps * per; i += blockDim.x) {
      const int t = i / per, q = i - t * per, k = rc.k0 + q * cpc;
      const bool ok = k < p.k;
      cp_async_zfill(wsm + t * p.kc + q * cpc,
                     ok ? w + static_cast<long long>(t) * p.k + k : w, p.wvec,
                     ok ? p.wvec : 0);
    }
  } else {
    for (int i = threadIdx.x; i < taps * p.kc; i += blockDim.x) {
      const int t = i / p.kc, kk = i - t * p.kc, k = rc.k0 + kk;
      const bool ok = k < p.k;
      const Tin* src = ok ? w + static_cast<long long>(t) * p.k + k : w;
      if (es == 4)
        cp_async_zfill(wsm + i, src, 4, ok ? 4 : 0);
      else
        wsm[i] = ok ? *src : Tin(0);
    }
  }
}

// The thread's channels of a work item: their bias and requant scales (0
// past K), read before the window lands so that their latency hides behind
// the copy.
template <typename Tacc>
struct DwChannels {
  Tacc bias[kDwV];
  float scale[kDwV];
};

template <typename Tacc, bool REQUANT>
__device__ inline void dw_channels(DwChannels<Tacc>& ch, const Tacc* bias,
                                   const float* scale, const DwParams& p,
                                   const DwThread& th, const DwRect& rc) {
  const int k = rc.k0 + th.vec * kDwV;
#pragma unroll
  for (int j = 0; j < kDwV; ++j) {
    const bool ok = k + j < p.k;
    ch.bias[j] = ok ? bias[k + j] : Tacc(0);
    ch.scale[j] = REQUANT && ok ? scale[k + j] : 0.0f;
  }
}

// The thread's strip from one slot: kDwSP pixels x kDwV channels of
// accumulators that start at the bias (the M5 preload) and add the taps in
// (dy, dx) order, one multiply-add a tap (FFMA in f32, a 32-bit integer
// multiply-add in int8: channels do not sum, so there is no dot product to
// give the tensor cores or dp4a).  KW_T = 3 (stride 1, dilation 1, a
// kernel that wide): each window row of the strip, kDwSP + KW_T - 1
// vectors, is read from shared memory once, each vector reused from
// registers by every tap of the row that reads it; KW_T = 0 (any other
// geometry) reads each tap's vector from shared memory.  Both add the same
// products in the same order, so they give the same bits.  A thread with
// no strip (DwThread::on false) computes nothing.
template <typename Tin, typename Tacc, int KW_T>
__device__ inline void dw_compute(Tacc (&acc)[kDwSP][kDwV],
                                  const unsigned char* slot,
                                  const Tacc (&bias)[kDwV], const DwParams& p,
                                  const DwThread& th) {
  if (!th.on) return;
  const Tin* win = reinterpret_cast<const Tin*>(slot);
  const Tin* wsm = reinterpret_cast<const Tin*>(slot + p.win_bytes) +
                   th.vec * kDwV;
#pragma unroll
  for (int j = 0; j < kDwV; ++j)
#pragma unroll
    for (int i = 0; i < kDwSP; ++i) acc[i][j] = bias[j];
  const Tin* base = win + th.row * p.stride * p.pitch +
                    th.col * kDwSP * p.stride * p.kc + th.vec * kDwV;
  for (int dy = 0; dy < p.kh; ++dy) {
    const Tin* row = base + dy * p.dil * p.pitch;
    if constexpr (KW_T > 0) {
      Tacc wt[KW_T][kDwV];
#pragma unroll
      for (int dx = 0; dx < KW_T; ++dx)
        dw_load(wsm + (dy * KW_T + dx) * p.kc, wt[dx]);
      // window column c feeds tap dx = c - i of strip pixel i: columns in
      // order keep each pixel's taps in dx order, and one column (with the
      // row's KW_T weight vectors) is all a thread holds of the window
#pragma unroll
      for (int c = 0; c < kDwSP + KW_T - 1; ++c) {
        Tacc xv[kDwV];
        dw_load(row + c * p.kc, xv);
#pragma unroll
        for (int i = 0; i < kDwSP; ++i) {
          if (c - i < 0 || c - i >= KW_T) continue;
#pragma unroll
          for (int j = 0; j < kDwV; ++j)
            acc[i][j] = dw_mad(xv[j], wt[c - i][j], acc[i][j]);
        }
      }
    } else {
#pragma unroll 1  // one tap's vectors live at a time: no spill in f32
      for (int dx = 0; dx < p.kw; ++dx) {
        Tacc wt[kDwV];
        dw_load(wsm + (dy * p.kw + dx) * p.kc, wt);
        const Tin* tap = row + dx * p.dil * p.kc;
#pragma unroll
        for (int i = 0; i < kDwSP; ++i) {
          Tacc xv[kDwV];
          dw_load(tap + i * p.stride * p.kc, xv);
#pragma unroll
          for (int j = 0; j < kDwV; ++j)
            acc[i][j] = dw_mad(xv[j], wt[j], acc[i][j]);
        }
      }
    }
  }
}

// The strip's accumulators into the block's tile [rh][tpitch] (pixel x of
// row y at y*tpitch + x*kc), 16-byte stores; a thread with no strip has
// none.  The tile takes the place of
// the slot's window: the caller has synchronised after every thread's
// compute.
__device__ __forceinline__ void dw_st4(float* dst, const float (&v)[kDwV]) {
  *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void dw_st4(int* dst, const int (&v)[kDwV]) {
  *reinterpret_cast<int4*>(dst) = make_int4(v[0], v[1], v[2], v[3]);
}

template <typename Tacc>
__device__ inline void dw_stage(const Tacc (&acc)[kDwSP][kDwV],
                                unsigned char* slot, const DwParams& p,
                                const DwThread& th) {
  if (!th.on) return;
  Tacc* tile = reinterpret_cast<Tacc*>(slot) + th.row * p.tpitch +
               th.col * kDwSP * p.kc + th.vec * kDwV;
#pragma unroll
  for (int i = 0; i < kDwSP; ++i) dw_st4(tile + i * p.kc, acc[i]);
}

// rint(v * s) clipped to [-128, 127], as the other paths' epilogues
// compute it, with one conversion instead of three: the product is clipped
// first (the bounds are integers, so clipping commutes with rounding), and
// adding 1.5 * 2^23 rounds it to an integer, half to even, that sits in
// the float's low mantissa bits.  NaN clips to -128 either way.
template <typename Tacc>
__device__ __forceinline__ int dw_requant(Tacc v, float s) {
  const float y =
      fminf(fmaxf(__fmul_rn(static_cast<float>(v), s), -128.0f), 127.0f);
  return __float_as_int(__fadd_rn(y, 12582912.0f)) - 0x4B400000;
}

// One output value of channel k: the raw accumulator, or rint(v * scale[k])
// clipped to int8.
template <typename Tacc, bool REQUANT>
__device__ __forceinline__ void dw_put(void* out, long long oidx, Tacc v,
                                       const float* scale, int k) {
  if (REQUANT) {
    static_cast<int8_t*>(out)[oidx] =
        static_cast<int8_t>(dw_requant(v, scale[k]));
  } else {
    static_cast<Tacc*>(out)[oidx] = v;
  }
}

// The epilogue from the tile: ReLU -> 2x2 max-pool (the rectangle is
// pool-aligned, so a window's four pixels are in the tile) -> requantize,
// or the raw accumulator.  Consecutive threads take consecutive groups of
// `ovec` channels of a pixel, then the next pixel, so a warp's stores are
// contiguous along the run.  The run's kc / ovec groups (a power of two)
// divide the block's 256 threads, so a thread keeps one group in every
// pass: with 4 channels a group (one 4-byte int8 or 16-byte store) it is
// the thread's own vector, whose scales `dw_channels` read; with one, the
// output reads its scale.  Rectangle widths are powers of two too, so a
// pixel's place is a shift and a mask.  The ragged edge (pixels past the
// map, channels past K) is masked.
template <typename Tacc, bool REQUANT>
__device__ inline void dw_store(const unsigned char* slot,
                                const float (&sc)[kDwV], const float* scale,
                                void* out, const DwParams& p,
                                const DwRect& rc) {
  const Tacc* tile = reinterpret_cast<const Tacc*>(slot);
  const int s = p.pool ? 2 : 1;
  const int ph = p.rh / s, pw = p.rw / s, lpw = __ffs(pw) - 1;
  const int per = p.kc / p.ovec, lper = __ffs(per) - 1;
  const int q = threadIdx.x & (per - 1);
  const int k = rc.k0 + q * p.ovec;
  if (k >= p.k) return;
  const long long img = static_cast<long long>(rc.img) * p.poh;
  for (int pp = threadIdx.x >> lper; pp < ph * pw; pp += blockDim.x >> lper) {
    const int ly = pp >> lpw, lx = pp & (pw - 1);
    const int gy = rc.ry * ph + ly, gx = rc.rx * pw + lx;
    if (gy >= p.poh || gx >= p.pow_) continue;
    const Tacc* t0 = tile + s * ly * p.tpitch + s * lx * p.kc + q * p.ovec;
    const long long oidx = ((img + gy) * p.pow_ + gx) * p.k + k;
    if (p.ovec == 4) {
      Tacc v[kDwV];
      dw_load(t0, v);
#pragma unroll
      for (int j = 0; j < kDwV; ++j) v[j] = relu_if(v[j], p.relu);
      if (p.pool) {  // the window's other three pixels, in the usual order
#pragma unroll
        for (int r = 1; r < 4; ++r) {
          Tacc m[kDwV];
          dw_load(t0 + (r & 1) * p.kc + (r >> 1) * p.tpitch, m);
#pragma unroll
          for (int j = 0; j < kDwV; ++j) {
            m[j] = relu_if(m[j], p.relu);
            v[j] = m[j] > v[j] ? m[j] : v[j];
          }
        }
      }
      if (REQUANT) {
        uint32_t word = 0;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          word |= (static_cast<uint32_t>(dw_requant(v[j], sc[j])) & 0xFFu)
                  << (8 * j);
        *reinterpret_cast<uint32_t*>(static_cast<int8_t*>(out) + oidx) = word;
      } else {
        dw_st4(static_cast<Tacc*>(out) + oidx, v);
      }
    } else {
      Tacc v = relu_if(t0[0], p.relu);
      if (p.pool) {
        const Tacc v1 = relu_if(t0[p.kc], p.relu);
        const Tacc v2 = relu_if(t0[p.tpitch], p.relu);
        const Tacc v3 = relu_if(t0[p.tpitch + p.kc], p.relu);
        v = v1 > v ? v1 : v;
        v = v2 > v ? v2 : v;
        v = v3 > v ? v3 : v;
      }
      dw_put<Tacc, REQUANT>(out, oidx, v, scale, k);
    }
  }
}

// Dispatch the dw kernels on (input type, requantize) — the mode codes of
// conv2d_ws.py: 0 int8 -> int32, 1 int8 -> int8, 2 f32 -> f32, 3 f32 ->
// int8 — and on the strip variant: KW_T 3 where stride and dilation are 1
// and the kernel is 3 wide, else 0.
#define DW_VARIANTS(TIN, TACC, RQ, KWT, LAUNCH, ...)                         \
  return (KWT) == 3 ? LAUNCH<TIN, TACC, RQ, 3>(__VA_ARGS__)                  \
                    : LAUNCH<TIN, TACC, RQ, 0>(__VA_ARGS__);
#define DW_DISPATCH(MODE, P, LAUNCH, ...)                                    \
  {                                                                          \
    const int kwt = (P).stride == 1 && (P).dil == 1 && (P).kw == 3 ? 3 : 0;  \
    switch (MODE) {                                                          \
      case 0: DW_VARIANTS(int8_t, int32_t, false, kwt, LAUNCH, __VA_ARGS__)  \
      case 1: DW_VARIANTS(int8_t, int32_t, true, kwt, LAUNCH, __VA_ARGS__)   \
      case 2: DW_VARIANTS(float, float, false, kwt, LAUNCH, __VA_ARGS__)     \
      case 3: DW_VARIANTS(float, float, true, kwt, LAUNCH, __VA_ARGS__)      \
      default: return static_cast<int>(cudaErrorInvalidValue);              \
    }                                                                        \
  }

// The record the host sent is this build's, and its strips' threads (a
// power of two) are at most the block's 256.
inline bool dw_valid(const DwParams& p) {
  const int active = p.rh * (p.rw / kDwSP) * p.cv;
  return p.cv * kDwV == p.kc && p.rw % kDwSP == 0 && active > 0 &&
         kConvThreads % active == 0 && (p.ovec == 4 || p.ovec == 1);
}

// Dispatch the simt kernels on (N-tile width, requantize): mode 2 f32 ->
// f32, 3 f32 -> int8; bn 32, 64 or 128.
#define SIMT_DISPATCH(MODE, BN, LAUNCH, ...)                                 \
  if ((MODE) != 2 && (MODE) != 3)                                            \
    return static_cast<int>(cudaErrorInvalidValue);                          \
  if ((BN) == 32)                                                            \
    return (MODE) == 3 ? LAUNCH<32, true>(__VA_ARGS__)                       \
                       : LAUNCH<32, false>(__VA_ARGS__);                     \
  if ((BN) == 64)                                                            \
    return (MODE) == 3 ? LAUNCH<64, true>(__VA_ARGS__)                       \
                       : LAUNCH<64, false>(__VA_ARGS__);                     \
  if ((BN) == 128)                                                           \
    return (MODE) == 3 ? LAUNCH<128, true>(__VA_ARGS__)                      \
                       : LAUNCH<128, false>(__VA_ARGS__);                    \
  return static_cast<int>(cudaErrorInvalidValue);

// Dispatch the tensor-core kernels on (N-tile width, requantize): mode 0
// int8 -> int32, 1 int8 -> int8; bn 32 or 64 (NT = bn / 16 n8-tiles a warp).
#define TC_DISPATCH(MODE, BN, LAUNCH, ...)                                   \
  if ((MODE) != 0 && (MODE) != 1)                                            \
    return static_cast<int>(cudaErrorInvalidValue);                          \
  if ((BN) == 32)                                                            \
    return (MODE) ? LAUNCH<2, true>(__VA_ARGS__)                             \
                  : LAUNCH<2, false>(__VA_ARGS__);                           \
  if ((BN) == 64)                                                            \
    return (MODE) ? LAUNCH<4, true>(__VA_ARGS__)                             \
                  : LAUNCH<4, false>(__VA_ARGS__);                           \
  return static_cast<int>(cudaErrorInvalidValue);

// Dispatch on (input type, requantize) — mode codes of conv2d_ws.py:
// 0 int8 -> int32, 1 int8 -> int8 (requant), 2 f32 -> f32, 3 f32 -> int8.
#define CONV_DISPATCH(MODE, LAUNCH, ...)                               \
  switch (MODE) {                                                      \
    case 0: return LAUNCH<int8_t, int32_t, false>(__VA_ARGS__);        \
    case 1: return LAUNCH<int8_t, int32_t, true>(__VA_ARGS__);         \
    case 2: return LAUNCH<float, float, false>(__VA_ARGS__);           \
    case 3: return LAUNCH<float, float, true>(__VA_ARGS__);            \
    default: return static_cast<int>(cudaErrorInvalidValue);           \
  }

// ---------------------------------------------------------------------------
// The narrow-output path ("nk")
// ---------------------------------------------------------------------------

// Field order must match repro_torch/kernels/conv2d_ws.py:NK_FIELDS; the
// host computes every field (conv2d_ws.py:nk_plan, nk_params).
struct NkParams {
  int n, h, w, c, k;              // input map [N,H,W,C], K output channels
  int kh, kw, stride, dil;        // kernel extent, stride, tap dilation
  int pt, pl;                     // top / left zero padding
  int cgrp, kgrp, kp, groups;     // channels and outputs a group, outputs
                                  // padded to the instantiation, groups
  int oh, ow, poh, pow_;          // conv-output (pool-trimmed) and epilogue
                                  // output extents
  int relu, pool;                 // fused epilogue stages
  int rh, rw, n_ry, n_rx;         // block rectangle, rectangles per image
  int gr, n_gr, rk;               // groups a run, runs, outputs a run
  int cs, cps, n_chunks;          // channels a chunk, rounded up to fours,
                                  // chunks a group
  int win_h, win_w, pps, pitch;   // window extents, elements a window pixel
                                  // (gr x cps) and a window row
  int wgs;                        // elements of one group's weight slab
  int tpitch;                     // accumulators a tile row
  int win_bytes, slot_bytes;      // one slot: window | weights [gr][wgs]
  int slots, smem;                // slots in shared memory, shared bytes
  int n_rect;                     // blocks: n * n_ry * n_rx * n_gr
  int xvec;                       // window copy bytes (16/8/4; 0 = int8
                                  // words gathered byte by byte)
};

constexpr int kNkParamsFields = sizeof(NkParams) / sizeof(int);
constexpr int kNkSP = 4;  // conv-output pixels a thread's strip

// A thread's place in its block: group `gi` of the run, strip `col`
// (pixels col*kNkSP ...) of rectangle row `row`.  Groups are fastest and
// rows next, so a warp's strips lie in consecutive rows of one strip
// column (conv2d_ws.py: nk_thread; the row pitches keep its reads and
// writes of shared memory on distinct banks).  Where the plan's rectangle
// has fewer strips than the block has threads for (a window too wide for
// more), the threads past them own none (`on` false): they copy and store.
struct NkThread {
  int gi, row, col;
  bool on;
  __device__ explicit NkThread(const NkParams& p) {
    gi = threadIdx.x % p.gr;
    const int u = threadIdx.x / p.gr;
    row = u % p.rh;
    col = u / p.rh;
    on = col < p.rw / kNkSP;
  }
};

// Block r: (image, rectangle row, rectangle column, run of groups), the
// run fastest; g0 is the run's first group.
struct NkRect {
  int img, ry, rx, g0;
  __device__ NkRect(const NkParams& p, int r) {
    g0 = (r % p.n_gr) * p.gr;
    r /= p.n_gr;
    rx = r % p.n_rx;
    r /= p.n_rx;
    ry = r % p.n_ry;
    img = r / p.n_ry;
  }
};

// Issue the copies of chunk `s` (channels s*cs ... of each group of the
// run) into one slot, not committed or waited here: the rectangle's halo'd
// window [win_h][pitch] (group gi of window pixel (wy, wx) at wy*pitch +
// wx*pps + gi*cps), then the chunk's weights, group gi's slab at gi*wgs:
// vector (tap, q, k) holds w[tap][s*cs + 4q .. 4q+3][gi's output k], four
// channels of one output side by side.  Window copies move xvec bytes of
// one pixel's group through cp.async; with xvec 0 (int8 only) a word of
// four channels is gathered with byte loads and stored.  f32 weights go
// one element a cp.async, int8 weights a gathered word each.  Padding, the
// map's edges, groups past the last, channels past the group and outputs
// past K/g are zero (exact for zero-point 0).
template <typename Tin>
__device__ inline void nk_issue(unsigned char* slot, const Tin* x,
                                const Tin* w, const NkParams& p,
                                const NkRect& rc, int s) {
  constexpr int es = sizeof(Tin);
  Tin* win = reinterpret_cast<Tin*>(slot);
  Tin* wsm = reinterpret_cast<Tin*>(slot + p.win_bytes);
  const int c0 = s * p.cs;
  const int nc = min(p.cs, p.cgrp - c0);  // channels of this chunk
  const int iy0 = rc.ry * p.rh * p.stride - p.pt;
  const int ix0 = rc.rx * p.rw * p.stride - p.pl;
  const long long img = static_cast<long long>(rc.img) * p.h;
  const int cpv = p.xvec ? p.xvec / es : 4;  // channels a copy
  const int per = p.cps / cpv;
  const int units = p.win_h * p.win_w * p.gr;
  for (int i = threadIdx.x; i < units * per; i += blockDim.x) {
    const int u = i / per, q = i - u * per;
    const int pix = u / p.gr, gi = u - pix * p.gr;
    const int wy = pix / p.win_w, wx = pix - wy * p.win_w;
    const int iy = iy0 + wy, ix = ix0 + wx, g = rc.g0 + gi, c = q * cpv;
    const bool in = iy >= 0 && iy < p.h && ix >= 0 && ix < p.w &&
                    g < p.groups;
    const long long src =
        ((img + iy) * p.w + ix) * p.c + static_cast<long long>(g) * p.cgrp +
        c0 + c;
    Tin* dst = win + wy * p.pitch + wx * p.pps + gi * p.cps + c;
    if (p.xvec) {
      const bool ok = in && c < nc;
      cp_async_zfill(dst, ok ? x + src : x, p.xvec, ok ? p.xvec : 0);
    } else {
      if constexpr (es == 1) {
        uint32_t word = 0;
#pragma unroll
        for (int b = 0; b < 4; ++b)
          if (in && c + b < nc)
            word |= static_cast<uint32_t>(static_cast<uint8_t>(x[src + b]))
                    << (8 * b);
        *reinterpret_cast<uint32_t*>(dst) = word;
      }
    }
  }
  const int nq = p.cps / 4;
  const int per_g = p.kh * p.kw * nq * p.kp * 4;  // elements a group's slab
  if constexpr (es == 4) {
    for (int i = threadIdx.x; i < p.gr * per_g; i += blockDim.x) {
      const int gi = i / per_g, e = i - gi * per_g;
      int r = e >> 2;
      const int b = e & 3, kk = r % p.kp;
      r /= p.kp;
      const int q = r % nq, tap = r / nq, c = 4 * q + b, g = rc.g0 + gi;
      const bool ok = g < p.groups && kk < p.kgrp && c < nc;
      const Tin* src =
          ok ? w + (static_cast<long long>(tap) * p.cgrp + c0 + c) * p.k +
                   g * p.kgrp + kk
             : w;
      cp_async_zfill(wsm + gi * p.wgs + e, src, 4, ok ? 4 : 0);
    }
  } else {
    const int words = per_g / 4;
    for (int i = threadIdx.x; i < p.gr * words; i += blockDim.x) {
      const int gi = i / words, e = i - gi * words;
      const int kk = e % p.kp, r = e / p.kp;
      const int q = r % nq, tap = r / nq, g = rc.g0 + gi;
      uint32_t word = 0;
      if (g < p.groups && kk < p.kgrp) {
        const long long base =
            (static_cast<long long>(tap) * p.cgrp + c0 + 4 * q) * p.k +
            g * p.kgrp + kk;
#pragma unroll
        for (int b = 0; b < 4; ++b)
          if (4 * q + b < nc)
            word |= static_cast<uint32_t>(static_cast<uint8_t>(
                        w[base + static_cast<long long>(b) * p.k]))
                    << (8 * b);
      }
      reinterpret_cast<uint32_t*>(wsm + gi * p.wgs)[e] = word;
    }
  }
}

// M5 bias preload: the thread's strip starts at its group's biases (0 for
// the outputs past K/g and for groups past the last), read before the
// first chunk lands so that their latency hides behind the copy.
template <typename Tacc, int KP>
__device__ inline void nk_init(Tacc (&acc)[kNkSP][KP], const Tacc* bias,
                               const NkParams& p, const NkThread& th,
                               const NkRect& rc) {
  const int g = rc.g0 + th.gi;
#pragma unroll
  for (int k = 0; k < KP; ++k) {
    const Tacc b = g < p.groups && k < p.kgrp ? bias[g * p.kgrp + k]
                                               : Tacc(0);
#pragma unroll
    for (int i = 0; i < kNkSP; ++i) acc[i][k] = b;
  }
}

// One window vector of VB bytes (int8: 4, 8 or 16 channels, as many as
// the chunk holds up to 16; f32: 4 channels) of the strip's pixels into
// every output: the outputs' weights of those channels (a word, or a
// float4, of four channels an output: a broadcast within a group), then
// one vector a pixel.  int8: one __dp4a a (pixel, output, four channels),
// exact; f32: four FFMAs, channels ascending.
template <int KP, int VB>
__device__ __forceinline__ void nk_vec(int (&acc)[kNkSP][KP],
                                       const int8_t* xq, const int8_t* wq,
                                       int step) {
  constexpr int NW = VB / 4;  // words (four channels each) a vector
  int wv[NW][KP];
#pragma unroll
  for (int j = 0; j < NW; ++j)
#pragma unroll
    for (int k = 0; k < KP; ++k)
      wv[j][k] = *reinterpret_cast<const int*>(wq + 4 * (j * KP + k));
#pragma unroll
  for (int i = 0; i < kNkSP; ++i) {
    const int8_t* src = xq + i * step;
    int xw[NW];
    if constexpr (NW == 4) {
      const int4 t = *reinterpret_cast<const int4*>(src);
      xw[0] = t.x, xw[1] = t.y, xw[2] = t.z, xw[3] = t.w;
    } else if constexpr (NW == 2) {
      const int2 t = *reinterpret_cast<const int2*>(src);
      xw[0] = t.x, xw[1] = t.y;
    } else {
      xw[0] = *reinterpret_cast<const int*>(src);
    }
#pragma unroll
    for (int j = 0; j < NW; ++j)
#pragma unroll
      for (int k = 0; k < KP; ++k)
        acc[i][k] = __dp4a(xw[j], wv[j][k], acc[i][k]);
  }
}
template <int KP, int VB>
__device__ __forceinline__ void nk_vec(float (&acc)[kNkSP][KP],
                                       const float* xq, const float* wq,
                                       int step) {
  static_assert(VB == 16, "an f32 window vector is four channels");
  float4 wv[KP];
#pragma unroll
  for (int k = 0; k < KP; ++k)
    wv[k] = *reinterpret_cast<const float4*>(wq + 4 * k);
#pragma unroll
  for (int i = 0; i < kNkSP; ++i) {
    const float4 xv = *reinterpret_cast<const float4*>(xq + i * step);
#pragma unroll
    for (int k = 0; k < KP; ++k) {
      float a = acc[i][k];
      a = fmaf(xv.x, wv[k].x, a);
      a = fmaf(xv.y, wv[k].y, a);
      a = fmaf(xv.z, wv[k].z, a);
      a = fmaf(xv.w, wv[k].w, a);
      acc[i][k] = a;
    }
  }
}

// One chunk from a slot: the taps in (dy, dx) order, each the chunk's
// channels in vectors of VB bytes, ascending.  A thread with no strip
// computes nothing.
template <typename Tin, typename Tacc, int KP, int VB>
__device__ inline void nk_compute(Tacc (&acc)[kNkSP][KP],
                                  const unsigned char* slot,
                                  const NkParams& p, const NkThread& th) {
  if (!th.on) return;
  const Tin* wsm =
      reinterpret_cast<const Tin*>(slot + p.win_bytes) + th.gi * p.wgs;
  const Tin* base = reinterpret_cast<const Tin*>(slot) +
                    th.row * p.stride * p.pitch +
                    th.col * kNkSP * p.stride * p.pps + th.gi * p.cps;
  constexpr int EV = VB / static_cast<int>(sizeof(Tin));  // elements a vector
  const int nv = p.cps / EV, step = p.stride * p.pps;
  for (int dy = 0; dy < p.kh; ++dy) {
    for (int dx = 0; dx < p.kw; ++dx) {
      const Tin* tap = base + dy * p.dil * p.pitch + dx * p.dil * p.pps;
      const Tin* wt = wsm + (dy * p.kw + dx) * p.cps * KP;
      for (int v = 0; v < nv; ++v)
        nk_vec<KP, VB>(acc, tap + v * EV, wt + v * EV * KP, step);
    }
  }
}

// The strip's accumulators into the block's tile [rh][tpitch] (output k of
// group gi at pixel x of row y at y*tpitch + x*rk + gi*kgrp + k), in place
// of the slots: the caller has synchronised after every thread's compute.
template <typename Tacc, int KP>
__device__ inline void nk_stage(const Tacc (&acc)[kNkSP][KP],
                                unsigned char* smem, const NkParams& p,
                                const NkThread& th) {
  if (!th.on) return;
  Tacc* tile = reinterpret_cast<Tacc*>(smem) + th.row * p.tpitch +
               th.col * kNkSP * p.rk + th.gi * p.kgrp;
#pragma unroll
  for (int i = 0; i < kNkSP; ++i)
#pragma unroll
    for (int k = 0; k < KP; ++k)
      if (k < p.kgrp) tile[i * p.rk + k] = acc[i][k];
}

// The epilogue from the tile: ReLU -> 2x2 max-pool (the rectangle is
// pool-aligned) -> requantize, or the raw accumulator.  Consecutive
// threads take consecutive outputs of a pixel's run (the run's rk outputs
// are contiguous in NHWC), then the next pixel of the row; a thread steps
// its (pixel, output) by the block's width with one carry, not a
// division, and rectangle widths are powers of two, so a pixel's place is
// a shift and a mask.  The ragged edge (pixels past the map, groups past
// the last) is masked.
template <typename Tacc, bool REQUANT>
__device__ inline void nk_store(const unsigned char* smem, const float* scale,
                                void* out, const NkParams& p,
                                const NkRect& rc) {
  const Tacc* tile = reinterpret_cast<const Tacc*>(smem);
  const int s = p.pool ? 2 : 1;
  const int ph = p.rh / s, pw = p.rw / s, lpw = __ffs(pw) - 1;
  const int k0 = rc.g0 * p.kgrp;
  const long long img = static_cast<long long>(rc.img) * p.poh;
  const int dpp = blockDim.x / p.rk, dkk = blockDim.x - dpp * p.rk;
  int pp = threadIdx.x / p.rk, kk = threadIdx.x - pp * p.rk;
  for (; pp < ph * pw; pp += dpp, kk += dkk) {
    if (kk >= p.rk) {  // the carry of (pixel, output) += blockDim
      kk -= p.rk;
      ++pp;
      if (pp >= ph * pw) break;
    }
    const int ly = pp >> lpw, lx = pp & (pw - 1);
    const int gy = rc.ry * ph + ly, gx = rc.rx * pw + lx, k = k0 + kk;
    if (gy >= p.poh || gx >= p.pow_ || k >= p.k) continue;
    const Tacc* t0 = tile + s * ly * p.tpitch + s * lx * p.rk + kk;
    Tacc v = relu_if(t0[0], p.relu);
    if (p.pool) {  // the window's other three pixels, in the usual order
      const Tacc v1 = relu_if(t0[p.rk], p.relu);
      const Tacc v2 = relu_if(t0[p.tpitch], p.relu);
      const Tacc v3 = relu_if(t0[p.tpitch + p.rk], p.relu);
      v = v1 > v ? v1 : v;
      v = v2 > v ? v2 : v;
      v = v3 > v ? v3 : v;
    }
    dw_put<Tacc, REQUANT>(out, ((img + gy) * p.pow_ + gx) * p.k + k, v,
                          scale, k);
  }
}

// One nk block, the body of both nk kernels.  RING false (conv2d_ws, and
// conv2d_ws_pipe wherever its ring has one slot): each chunk is loaded into
// the one slot, waited for and computed in turn.  RING true (conv2d_ws_pipe
// where the group takes several chunks and two slots fit): chunk s+1's
// window and weights stream into the other slot of a 2-slot ring while
// chunk s computes.  One body, so that where the ring has one slot (every
// zoo head) the two kernels run the same code with the same registers.
template <typename Tin, typename Tacc, bool REQUANT, int KP, int VB,
          bool RING>
__device__ __forceinline__ void nk_block(const Tin* __restrict__ x,
                                         const Tin* __restrict__ w,
                                         const Tacc* __restrict__ bias,
                                         const float* __restrict__ scale,
                                         void* __restrict__ out,
                                         const NkParams& p,
                                         unsigned char* smem) {
  const NkRect rc(p, blockIdx.x);
  const NkThread th(p);
  nk_issue<Tin>(smem, x, w, p, rc, 0);
  cp_async_commit();
  Tacc acc[kNkSP][KP];
  nk_init<Tacc, KP>(acc, bias, p, th, rc);
  for (int s = 0; s < p.n_chunks; ++s) {
    if (s > 0) __syncthreads();  // chunk s-1's compute is done with its slot
    if (RING) {
      if (s + 1 < p.n_chunks)
        nk_issue<Tin>(smem + ((s + 1) & 1) * p.slot_bytes, x, w, p, rc,
                      s + 1);
      cp_async_commit();
      cp_async_wait<1>();  // chunk s has landed; only chunk s+1 may be pending
    } else {
      if (s > 0) {
        nk_issue<Tin>(smem, x, w, p, rc, s);
        cp_async_commit();
      }
      cp_async_wait<0>();
    }
    __syncthreads();
    nk_compute<Tin, Tacc, KP, VB>(
        acc, RING ? smem + (s & 1) * p.slot_bytes : smem, p, th);
  }
  __syncthreads();  // every strip is done with the window: the tile replaces it
  nk_stage<Tacc, KP>(acc, smem, p, th);
  __syncthreads();
  nk_store<Tacc, REQUANT>(smem, scale, out, p, rc);
}

// The record the host sent is this build's: an instantiated output width,
// whole window vectors (int8: 4 or 8 channels, or a multiple of 16; f32: a
// multiple of 4), whole strips, at most the block's 256 threads in a power
// of two, and a window copy for f32 (`es` bytes an element).
inline bool nk_valid(const NkParams& p, int es) {
  const int active = p.gr * p.rh * (p.rw / kNkSP);
  const bool vecs = es == 4 ? p.cps % 4 == 0
                            : p.cps == 4 || p.cps == 8 || p.cps % 16 == 0;
  return (p.kp == 1 || p.kp == 2 || p.kp == 3 || p.kp == 4 || p.kp == 8) &&
         p.kgrp >= 1 && p.kgrp <= p.kp && p.rk == p.gr * p.kgrp && vecs &&
         p.cps >= p.cs && p.pps == p.gr * p.cps &&
         p.n_chunks * p.cs >= p.cgrp && p.rw % kNkSP == 0 && active > 0 &&
         kConvThreads % active == 0 && (p.xvec > 0 || es == 1);
}

// Dispatch the nk kernels on (input type, requantize) — the mode codes of
// conv2d_ws.py: 0 int8 -> int32, 1 int8 -> int8, 2 f32 -> f32, 3 f32 ->
// int8 —, on the padded outputs a group, KP = 1, 2, 3, 4 or 8, and on the
// bytes of a lane's window vector, VB: int8 min(cps, 16), f32 16.
#define NK_VARIANTS(TIN, TACC, RQ, VB, KP, LAUNCH, ...)                      \
  switch (KP) {                                                              \
    case 1: return LAUNCH<TIN, TACC, RQ, 1, VB>(__VA_ARGS__);                \
    case 2: return LAUNCH<TIN, TACC, RQ, 2, VB>(__VA_ARGS__);                \
    case 3: return LAUNCH<TIN, TACC, RQ, 3, VB>(__VA_ARGS__);                \
    case 4: return LAUNCH<TIN, TACC, RQ, 4, VB>(__VA_ARGS__);                \
    case 8: return LAUNCH<TIN, TACC, RQ, 8, VB>(__VA_ARGS__);                \
    default: return static_cast<int>(cudaErrorInvalidValue);                \
  }
#define NK_INT8(RQ, P, LAUNCH, ...)                                          \
  switch ((P).cps < 16 ? (P).cps : 16) {                                     \
    case 4: NK_VARIANTS(int8_t, int32_t, RQ, 4, (P).kp, LAUNCH, __VA_ARGS__) \
    case 8: NK_VARIANTS(int8_t, int32_t, RQ, 8, (P).kp, LAUNCH, __VA_ARGS__) \
    case 16:                                                                 \
      NK_VARIANTS(int8_t, int32_t, RQ, 16, (P).kp, LAUNCH, __VA_ARGS__)      \
    default: return static_cast<int>(cudaErrorInvalidValue);                \
  }
#define NK_DISPATCH(MODE, P, LAUNCH, ...)                                    \
  switch (MODE) {                                                            \
    case 0: NK_INT8(false, P, LAUNCH, __VA_ARGS__)                           \
    case 1: NK_INT8(true, P, LAUNCH, __VA_ARGS__)                            \
    case 2: NK_VARIANTS(float, float, false, 16, (P).kp, LAUNCH, __VA_ARGS__)\
    case 3: NK_VARIANTS(float, float, true, 16, (P).kp, LAUNCH, __VA_ARGS__) \
    default: return static_cast<int>(cudaErrorInvalidValue);                \
  }
