// Stand-alone CP-grid encoder forward.
//
// Replaces the TPU kernel nerf_kinematics_tpu/ops/cp_grid_pallas.py::
// cp_encode_pallas forward (_fwd_kernel), which builds (T, B) tent operands
// and contracts them with the line tables on the matrix unit. Here every
// output element is two indexed loads per axis (nkt_common.cuh::nkt_taps),
// summed in f32, and the product of the three axes.
//
// Bound on this card: bytes. 12 B in and 4 * L * C B out per point (1 024 B
// at L = 4, C = 64); the line tables (590 KB in f32) stay in L2. One thread
// per output element, consecutive threads on consecutive channels of one
// point, so the table reads and the output writes are contiguous within a
// warp. Each thread recomputes its point's taps: the arithmetic is small
// beside the 4 B it writes.
#include "nkt_common.cuh"

__global__ void nkt_cp_encode_kernel(const float* __restrict__ x,
                                     const float* __restrict__ lines,
                                     float* __restrict__ out, long long n,
                                     CPLevels cp) {
  const int C = cp.n_comp;
  const int LC = cp.n_levels * C;
  const long long total = n * LC;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       e < total; e += stride) {
    const long long i = e / LC;
    const int j = (int)(e - i * LC);
    const int l = j / C;
    const int c = j - l * C;
    float u[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const NktTaps t = nkt_taps(x[i * 3 + a], cp, l, a);
      const float* tab = lines + ((long long)(l * 3 + a) * cp.table) * C + c;
      float v0 = __ldg(tab + (long long)t.r0 * C);
      float v1 = __ldg(tab + (long long)t.r1 * C);
      if (cp.use_bf16) {
        v0 = nkt_bf16r(v0);
        v1 = nkt_bf16r(v1);
      }
      u[a] = t.w0 * v0 + t.w1 * v1;
    }
    out[e] = (u[0] * u[1]) * u[2];
  }
}

// x: (n, 3) f32; lines: (L, 3, T, C) f32; out: (n, L*C) f32.
extern "C" int nkt_cp_encode(const void* x, const void* lines, void* out,
                             long long n, const CPLevels* cp, int n_sm,
                             void* stream) {
  const int threads = 256;
  const long long total = n * cp->n_levels * cp->n_comp;
  long long blocks = (total + threads - 1) / threads;
  const long long cap = (long long)n_sm * 32;
  if (blocks > cap) blocks = cap;
  nkt_cp_encode_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)lines, (float*)out, n, *cp);
  return (int)cudaGetLastError();
}

// Stand-alone CP-grid encoder backward.
//
// Replaces the TPU kernel cp_grid_pallas.py::cp_encode_pallas VJP
// (_bwd_kernel, _forward_bwd), which contracts (T, B) tent operands with the
// (B, C) cotangent on the matrix unit and adds every block's result into one
// resident (L, 3, T, C) accumulator. Here a warp takes one point at a time,
// its lanes on the channels: the cotangent row, the table rows and the
// atomicAdds into dlines are contiguous (nkt_common.cuh::
// nkt_enc_bwd_channel). The sum over points is by atomicAdd, so its last
// bits vary from run to run. Positions get no gradient.
//
// Bound on this card: bytes. 12 B + 4 * L * C B of cotangent read per point.
__global__ void nkt_cp_encode_bwd_kernel(const float* __restrict__ x,
                                         const float* __restrict__ lines,
                                         const float* __restrict__ g,
                                         float* __restrict__ dlines,
                                         long long n, CPLevels cp) {
  const int C = cp.n_comp;
  const int LC = cp.n_levels * C;
  const int lane = threadIdx.x & 31;
  const long long warp =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const long long n_warps = ((long long)gridDim.x * blockDim.x) >> 5;
  for (long long i = warp; i < n; i += n_warps) {
    const float px = x[i * 3], py = x[i * 3 + 1], pz = x[i * 3 + 2];
    for (int l = 0; l < cp.n_levels; ++l) {
      const NktTaps tx = nkt_taps(px, cp, l, 0);
      const NktTaps ty = nkt_taps(py, cp, l, 1);
      const NktTaps tz = nkt_taps(pz, cp, l, 2);
      for (int c = lane; c < C; c += 32)
        nkt_enc_bwd_channel(lines, dlines, cp, l, c, tx, ty, tz,
                            g[i * LC + l * C + c]);
    }
  }
}

// x: (n, 3) f32; lines: (L, 3, T, C) f32; g: (n, L*C) f32 cotangent of the
// encoding; dlines: (L, 3, T, C) f32, zeroed by the caller.
extern "C" int nkt_cp_encode_bwd(const void* x, const void* lines,
                                 const void* g, void* dlines, long long n,
                                 const CPLevels* cp, int n_sm, void* stream) {
  const int threads = 256;
  long long blocks = (n * 32 + threads - 1) / threads;
  const long long cap = (long long)n_sm * 16;
  if (blocks > cap) blocks = cap;
  nkt_cp_encode_bwd_kernel<<<(unsigned)blocks, threads, 0,
                             (cudaStream_t)stream>>>(
      (const float*)x, (const float*)lines, (const float*)g, (float*)dlines, n,
      *cp);
  return (int)cudaGetLastError();
}
