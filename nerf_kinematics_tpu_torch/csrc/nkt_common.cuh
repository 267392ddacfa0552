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

// Encoder backward of one point, level l and channel c: the cotangent gl of
// the encoding's channel (l, c) goes to the two tapped rows of each of the
// level's three line tables, dlines += w * bf16(gl * product of the other
// two axes' line features). dlines has the parameter layout (L, 3, T, C) and
// is accumulated with atomicAdd (the order of the sum over points is not
// fixed). A wrap tap of a periodic folded level arrives with r1 = 0, so it
// adds into row 0 and a row F < T receives nothing from its own level; a
// hash fold that sends both cells to one row arrives with w1 = 0.
__device__ __forceinline__ void nkt_enc_bwd_channel(
    const float* __restrict__ lines, float* __restrict__ dlines,
    const CPLevels& cp, int l, int c, const NktTaps& tx, const NktTaps& ty,
    const NktTaps& tz, float gl) {
  const int C = cp.n_comp;
  const long long T = cp.table;
  const long long bx = ((long long)(l * 3 + 0) * T) * C + c;
  const long long by = ((long long)(l * 3 + 1) * T) * C + c;
  const long long bz = ((long long)(l * 3 + 2) * T) * C + c;
  float x0 = __ldg(lines + bx + (long long)tx.r0 * C);
  float x1 = __ldg(lines + bx + (long long)tx.r1 * C);
  float y0 = __ldg(lines + by + (long long)ty.r0 * C);
  float y1 = __ldg(lines + by + (long long)ty.r1 * C);
  float z0 = __ldg(lines + bz + (long long)tz.r0 * C);
  float z1 = __ldg(lines + bz + (long long)tz.r1 * C);
  const bool bf = cp.use_bf16 != 0;
  if (bf) {
    x0 = nkt_bf16r(x0); x1 = nkt_bf16r(x1);
    y0 = nkt_bf16r(y0); y1 = nkt_bf16r(y1);
    z0 = nkt_bf16r(z0); z1 = nkt_bf16r(z1);
  }
  const float ux = tx.w0 * x0 + tx.w1 * x1;
  const float uy = ty.w0 * y0 + ty.w1 * y1;
  const float uz = tz.w0 * z0 + tz.w1 * z1;
  float gx = gl * (uy * uz);
  float gy = gl * (ux * uz);
  float gz = gl * (ux * uy);
  if (bf) {
    gx = nkt_bf16r(gx);
    gy = nkt_bf16r(gy);
    gz = nkt_bf16r(gz);
  }
  if (gx != 0.0f) {
    atomicAdd(dlines + bx + (long long)tx.r0 * C, tx.w0 * gx);
    if (tx.w1 != 0.0f) atomicAdd(dlines + bx + (long long)tx.r1 * C, tx.w1 * gx);
  }
  if (gy != 0.0f) {
    atomicAdd(dlines + by + (long long)ty.r0 * C, ty.w0 * gy);
    if (ty.w1 != 0.0f) atomicAdd(dlines + by + (long long)ty.r1 * C, ty.w1 * gy);
  }
  if (gz != 0.0f) {
    atomicAdd(dlines + bz + (long long)tz.r0 * C, tz.w0 * gz);
    if (tz.w1 != 0.0f) atomicAdd(dlines + bz + (long long)tz.r1 * C, tz.w1 * gz);
  }
}
