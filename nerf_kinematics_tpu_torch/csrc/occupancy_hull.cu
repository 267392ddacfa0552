// Visual-hull occupancy lookup.
//
// Replaces the TPU kernel nerf_kinematics_tpu/ops/occupancy_pallas.py::
// occupancy_at_hull_pallas (_hull_kernel), which builds three (R, B) one-hot
// operands and runs three (R, R) x (R, B) products because its target has no
// gather. Here each point is three indexed loads:
//
//   out[n] = min(Pxy[ix, iy], Pxz[ix, iz], Pyz[iy, iz]),
//   i = floor(clip(u * R, 0, R - 1)),
//
// with each projection value rounded to bf16 (the reference's operands are
// bf16) and returned as f32; NaN and +-inf as nkt_hull_at (nkt_common.cuh)
// gives them, whose lookup row 8's proposal shares.
//
// Bound on this card: bytes, 12 B in and 4 B out a point. One block of 1024
// threads an SM holds the three projections rounded to bf16 in shared
// memory (55 KB at R = 96), staged once (one block an SM: the table crosses
// from L2 once an SM), and walks the points grid-stride in groups of four:
// a 16-byte load from each coordinate row (rows of xt are contiguous) and a
// 16-byte store, the next group's loads issued before the current group's
// lookups. The first group's coordinates are loaded before the table is
// staged, so that the staging overlaps them. A count of points that is not
// a multiple of 4 (or a misaligned row) takes a point a thread instead.
// Projections too large for shared memory (R above 196) are refused.
#include <cstdint>

#include "nkt_common.cuh"

#define NKT_HULL_THREADS 1024
#define NKT_HULL_PPT 4  // points a thread a step

// The projections staged in shared memory, rounded to bf16.
struct NktHullTab {
  const __nv_bfloat16* sp;
  __device__ __forceinline__ float operator[](int e) const {
    return __bfloat162float(sp[e]);
  }
};

__device__ __forceinline__ float4 nkt_hull4(const NktHullTab& sp, int R,
                                            float fR, float hi, float4 x,
                                            float4 y, float4 z) {
  return make_float4(nkt_hull_at(sp, R, fR, hi, x.x, y.x, z.x),
                     nkt_hull_at(sp, R, fR, hi, x.y, y.y, z.y),
                     nkt_hull_at(sp, R, fR, hi, x.z, y.z, z.z),
                     nkt_hull_at(sp, R, fR, hi, x.w, y.w, z.w));
}

// The projections rounded to bf16 into shared memory: 16-byte loads where
// they are aligned and a multiple of 4 long, eight of them in flight a
// thread (one round at R = 96).
#define NKT_HULL_STAGE 8
__device__ __forceinline__ void nkt_hull_stage(__nv_bfloat16* sp,
                                               const float* __restrict__ proj,
                                               int n3, int tid) {
  if (n3 % 4 == 0 && (reinterpret_cast<uintptr_t>(proj) & 15) == 0) {
    const float4* p4 = reinterpret_cast<const float4*>(proj);
    const int n4 = n3 / 4;
    for (int e0 = tid; e0 < n4; e0 += NKT_HULL_STAGE * NKT_HULL_THREADS) {
      float4 v[NKT_HULL_STAGE];
#pragma unroll
      for (int k = 0; k < NKT_HULL_STAGE; ++k) {
        const int e = e0 + k * NKT_HULL_THREADS;
        if (e < n4) v[k] = __ldg(p4 + e);
      }
#pragma unroll
      for (int k = 0; k < NKT_HULL_STAGE; ++k) {
        const int e = e0 + k * NKT_HULL_THREADS;
        if (e < n4) {
          __nv_bfloat162* d = reinterpret_cast<__nv_bfloat162*>(sp + 4 * e);
          d[0] = __floats2bfloat162_rn(v[k].x, v[k].y);
          d[1] = __floats2bfloat162_rn(v[k].z, v[k].w);
        }
      }
    }
  } else {
    for (int e = tid; e < n3; e += NKT_HULL_THREADS)
      sp[e] = __float2bfloat16_rn(__ldg(proj + e));
  }
}

// vec: n % 4 == 0 and 16-byte aligned rows, the walk over groups of four
// points.
__global__ void __launch_bounds__(NKT_HULL_THREADS, 1)
    nkt_hull_kernel(const float* __restrict__ xt,
                    const float* __restrict__ proj, float* __restrict__ out,
                    long long n, int R, int vec) {
  extern __shared__ __align__(16) __nv_bfloat16 sproj[];
  const int tid = threadIdx.x;
  const float hi = (float)(R - 1), fR = (float)R;
  const int n3 = 3 * R * R;
  const NktHullTab tab = {sproj};
  if (vec) {
    const float4* x4 = reinterpret_cast<const float4*>(xt);
    const float4* y4 = reinterpret_cast<const float4*>(xt + n);
    const float4* z4 = reinterpret_cast<const float4*>(xt + 2 * n);
    float4* o4 = reinterpret_cast<float4*>(out);
    const long long g_n = n / 4;  // groups of four points
    const long long stride = (long long)gridDim.x * NKT_HULL_THREADS;
    long long g = (long long)blockIdx.x * NKT_HULL_THREADS + tid;
    // the first group's coordinates in flight while the table is staged,
    // then each next group's while the current one is looked up
    float4 cx, cy, cz;
    if (g < g_n) {
      cx = __ldcs(x4 + g);
      cy = __ldcs(y4 + g);
      cz = __ldcs(z4 + g);
    }
    nkt_hull_stage(sproj, proj, n3, tid);
    __syncthreads();
    for (; g < g_n; g += stride) {
      float4 nx = cx, ny = cy, nz = cz;
      if (g + stride < g_n) {
        nx = __ldcs(x4 + g + stride);
        ny = __ldcs(y4 + g + stride);
        nz = __ldcs(z4 + g + stride);
      }
      __stcs(o4 + g, nkt_hull4(tab, R, fR, hi, cx, cy, cz));
      cx = nx;
      cy = ny;
      cz = nz;
    }
  } else {
    nkt_hull_stage(sproj, proj, n3, tid);
    __syncthreads();
    const long long stride = (long long)gridDim.x * NKT_HULL_THREADS;
    for (long long i = (long long)blockIdx.x * NKT_HULL_THREADS + tid; i < n;
         i += stride)
      out[i] = nkt_hull_at(tab, R, fR, hi, xt[i], xt[n + i], xt[2 * n + i]);
  }
}

// xt: (3, n) f32 unit coordinates; proj: (3, R, R) f32; out: (n,) f32.
// cudaErrorInvalidValue: no points, or projections whose bf16 copy does not
// fit a block's shared memory (R above 196).
#define NKT_HULL_SMEM_MAX 232448
extern "C" int nkt_occupancy_at_hull(const void* xt, const void* proj,
                                     void* out, long long n, int R,
                                     int n_sm, void* stream) {
  const size_t bytes = (size_t)3 * R * R * sizeof(__nv_bfloat16);
  if (n <= 0 || R < 1 || bytes > NKT_HULL_SMEM_MAX) return (int)cudaErrorInvalidValue;
  const bool vec = n % 4 == 0 && (reinterpret_cast<uintptr_t>(xt) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  const long long per_block = (long long)NKT_HULL_THREADS * (vec ? NKT_HULL_PPT : 1);
  long long blocks = (n + per_block - 1) / per_block;
  const long long cap = n_sm;
  if (blocks > cap) blocks = cap;
  cudaError_t err = cudaFuncSetAttribute(
      nkt_hull_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  nkt_hull_kernel<<<(unsigned)blocks, NKT_HULL_THREADS, bytes,
                    (cudaStream_t)stream>>>((const float*)xt, (const float*)proj,
                                            (float*)out, n, R, vec ? 1 : 0);
  return (int)cudaGetLastError();
}
