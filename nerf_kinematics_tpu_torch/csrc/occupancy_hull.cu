// Visual-hull occupancy lookup.
//
// Replaces the TPU kernel nerf_kinematics_tpu/ops/occupancy_pallas.py::
// occupancy_at_hull_pallas (_hull_kernel), which builds three (R, B) one-hot
// operands and runs three (R, R) x (R, B) products because its target has no
// gather. Here it is one thread per point and three indexed loads:
//
//   out[n] = min(Pxy[ix, iy], Pxz[ix, iz], Pyz[iy, iz]),
//   i = floor(clip(u * R, 0, R - 1)),
//
// with each projection value rounded to bf16 (the reference's operands are
// bf16) and returned as f32. A NaN coordinate matches no cell of the
// reference's one-hot rows (|NaN - iota| < 0.5 is false), so every pair
// projection that reads that axis contributes 0 to the minimum; here the
// pair is set to 0 after a lookup at the clamped cell (fmaxf maps NaN to 0).
// +-inf clamp to the end cells, as in the reference.
//
// Bound on this card: bytes. 12 B in and 4 B out per point; the (3, R, R)
// table (110 KB at R = 96) stays in L1/L2 and is read through the read-only
// path. Loads and stores of neighbouring threads are neighbouring addresses.
#include "nkt_common.cuh"

__global__ void nkt_hull_kernel(const float* __restrict__ xt,
                                const float* __restrict__ proj,
                                float* __restrict__ out, long long n, int R) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  const float hi = (float)(R - 1);
  const float fR = (float)R;
  const int RR = R * R;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const float ux = xt[i] * fR, uy = xt[n + i] * fR, uz = xt[2 * n + i] * fR;
    const bool nx = isnan(ux), ny = isnan(uy), nz = isnan(uz);
    const int ix = (int)floorf(fminf(fmaxf(ux, 0.0f), hi));
    const int iy = (int)floorf(fminf(fmaxf(uy, 0.0f), hi));
    const int iz = (int)floorf(fminf(fmaxf(uz, 0.0f), hi));
    const float a = nx || ny ? 0.0f : nkt_bf16r(__ldg(proj + ix * R + iy));
    const float b = nx || nz ? 0.0f : nkt_bf16r(__ldg(proj + RR + ix * R + iz));
    const float c = ny || nz ? 0.0f : nkt_bf16r(__ldg(proj + 2 * RR + iy * R + iz));
    out[i] = fminf(a, fminf(b, c));
  }
}

// xt: (3, n) f32 unit coordinates; proj: (3, R, R) f32; out: (n,) f32.
extern "C" int nkt_occupancy_at_hull(const void* xt, const void* proj,
                                     void* out, long long n, int R,
                                     int n_sm, void* stream) {
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  const long long cap = (long long)n_sm * 16;
  if (blocks > cap) blocks = cap;
  nkt_hull_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)xt, (const float*)proj, (float*)out, n, R);
  return (int)cudaGetLastError();
}
