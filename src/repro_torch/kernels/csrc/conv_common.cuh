// Shared pieces of the two weight-stationary conv kernels (conv2d_ws.cu,
// conv2d_ws_pipe.cu): the geometry record, the per-slab compute and the
// fused epilogue.  Both kernels run exactly these device functions on the
// same shared-memory layout, so they agree bit for bit on the int32 AND the
// f32 accumulator paths; they differ only in how a slab reaches shared
// memory.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

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
