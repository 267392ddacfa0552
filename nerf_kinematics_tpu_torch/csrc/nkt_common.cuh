// Shared device code of the port's CUDA kernels: the CP-grid level
// description and the two-tap interpolation of one level and axis.
//
// The sources include only the CUDA runtime headers (no PyTorch headers):
// they are built with nvcc into one shared library with a plain C
// interface and loaded with ctypes (ops/cuda_lib.py). They are compiled
// with -fmad=false so that a*b+c rounds as the plain PyTorch versions do;
// accumulation loops ask for a fused multiply-add explicitly.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#define NKT_MAX_LEVELS 8

// Mirrors ops/cuda_lib.py::CPLevels field for field.
struct CPLevels {
  int n_levels;
  int n_comp;    // C
  int table;     // T, rows of every (level, axis) table
  int use_bf16;  // round weights, table entries and activations to bf16
  int hashed;    // fold mode "hash" (folded levels only)
  int R[NKT_MAX_LEVELS];       // level resolution
  int F[NKT_MAX_LEVELS];       // fold modulus, 0 = un-folded
  float pmax[NKT_MAX_LEVELS];  // f32(R - 1e-4), upper clip of the coordinate
  int salt[NKT_MAX_LEVELS][3];
};

__device__ __forceinline__ float nkt_bf16r(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Integer cell -> hashed row: Knuth multiplicative mix + xor-shift in
// wrapping 32-bit arithmetic (arithmetic right shifts), low 24 bits, mod.
__device__ __forceinline__ int nkt_hash_fold(int i0, int table, int salt) {
  unsigned h = ((unsigned)i0 + (unsigned)salt) * 2654435769u;  // -1640531527
  int hs = (int)h;
  hs = hs ^ (hs >> 15);
  h = (unsigned)hs * 2246822507u;  // -2048144789
  hs = (int)h;
  hs = hs ^ (hs >> 13);
  return (hs & 0xFFFFFF) % table;
}

struct NktTaps {
  int r0, r1;
  float w0, w1;
};

// x: one unit coordinate. Rows and tent weights of its two taps at level l.
__device__ __forceinline__ NktTaps nkt_taps(float x, const CPLevels& cp, int l,
                                            int axis) {
  NktTaps t;
  const int R = cp.R[l];
  const int F = cp.F[l];
  const float xx = fminf(fmaxf(x, 0.0f), 1.0f);
  const float p = fminf(fmaxf(xx * (float)R, 0.0f), cp.pmax[l]);
  if (F > 0 && cp.hashed) {
    const float i0 = floorf(p);
    const float w = p - i0;
    const int salt = cp.salt[l][axis];
    t.r0 = nkt_hash_fold((int)i0, F, salt);
    t.r1 = nkt_hash_fold((int)i0 + 1, F, salt);
    if (t.r0 == t.r1) {  // both cells on one row: weights add before rounding
      t.w0 = (1.0f - w) + w;
      t.w1 = 0.0f;
    } else {
      t.w0 = 1.0f - w;
      t.w1 = w;
    }
  } else {
    const float pm = (F > 0) ? fmodf(p, (float)F) : p;
    const float t0 = floorf(pm);
    t.w0 = 1.0f - (pm - t0);
    t.w1 = 1.0f - ((t0 + 1.0f) - pm);
    t.r0 = (int)t0;
    t.r1 = t.r0 + 1;
    if (F > 0 && t.r1 >= F) t.r1 -= F;
  }
  if (cp.use_bf16) {
    t.w0 = nkt_bf16r(t.w0);
    t.w1 = nkt_bf16r(t.w1);
  }
  return t;
}

// A tap pair as a warp keeps it in shared memory (12 bytes; rows < 32768).
struct NktTapS {
  short r0, r1;
  float w0, w1;
};

__device__ __forceinline__ NktTapS nkt_tap_s(const NktTaps& q) {
  NktTapS s;
  s.r0 = (short)q.r0;
  s.r1 = (short)q.r1;
  s.w0 = q.w0;
  s.w1 = q.w1;
  return s;
}
