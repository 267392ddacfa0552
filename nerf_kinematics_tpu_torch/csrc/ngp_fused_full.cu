// The fast engine's whole train step in one call.
//
// Replaces the TPU kernel of nerf_kinematics_tpu/ops/ngp_fused_pallas.py:
//   ngp_fused_train_full_cf (_train_full_kernel) -> nkt_fused_train_full
//
// The TPU kernel runs every stage of a 128-ray block in one grid step: the
// hull proposal on NB uniform bins, the inverse CDF to Sc coarse depths, the
// density-only coarse pass, the coarse compositing weights and error, the
// inverse CDF to S fine depths, then the fine stage of ngp_fused_train_cf.
// Here one call is a sequence on the caller's stream, the per-ray results
// in device scratch:
//
//   (a) nkf_propose_kernel, one thread per ray: stages A-B. Bin centres
//       o + (near + (b + 0.5) step) d, the unit-cube map x * inv_bound2 + 0.5
//       clipped to [0, 1], the hull cell floor(clip(u * Rg, 0, Rg - 1)) on
//       bf16-rounded pair projections, weights occ / (max + 1e-9) + floor,
//       the reference's CDF (+1e-5, then w / tot added bin by bin) and its
//       inverse (cnt = #(cdf <= u) clipped to [1, M], a bin mass under 1e-5
//       divides by 1) at the edges near + b step. Writes z_c and the coarse
//       points in unit-cube coordinates.
//   (b) the density-only fused forward of ngp_fused.cu (row 2's code, its
//       C entry nkt_fused_forward) on the R * Sc coarse points: in bf16
//       mode the tensor-core body of nkt_mma.cuh.
//   (c) nkf_fine_inputs_kernel, one thread per ray: stages C-D. Coarse
//       compositing with the 1e10 * |d| sentinel and T * (1 - a + 1e-10),
//       err_c of the grey composite 0.5 acc (+ 1 - acc on white), then the
//       inverse CDF over the coarse midpoints weighted by the interior
//       coarse weights. Writes the fine points, their intervals and the
//       view directions, ray-major (sample s of ray r at r * S + s).
//   (d) nkt_fused_train of ngp_fused_bwd.cu, as it stands: the fine
//       forward, compositing, squared error and the whole backward (in bf16
//       mode on the tensor cores: the forward with saves, the per-point
//       backward and the weight gradients in one launch).
//
// The proposal arithmetic is built with -fmad=false (as every source here),
// so each product and sum rounds as in the plain version: one contracted
// multiply-add moves a hull cell or a CDF count, and the inverse CDF
// amplifies such bits. Constants the reference takes as Python floats
// (bin centres and edges) are computed in double and rounded once.
//
// Bound on this card: operations, those of (b) and (d) (row 2's 43.0 kFLOP
// per coarse point and three times row 3's per fine point) at the bf16
// tensor-core rate; what holds (b) and (d) once their products run there is
// in ngp_fused.cu and ngp_fused_bwd.cu (the encoder's gathers and scatter,
// the saved activations). (a) and (c) are a few thousand scalar operations
// per ray, one thread per ray: simple and right first.
#include "ngp_fused.cuh"

#define NKF_MAX_BINS 256
#define NKF_MAX_SAMPLES 256
#define NKF_RAY_THREADS 128

// Mirrors ops/cuda_lib.py::FullArgs field for field.
struct FullArgs {
  BwdArgs b;           // the fine stage; b.f.xt, b.f.vdt and b.dists are
                       // (3, R*S) / (3, R*S) / (1, R*S) scratch this call fills
  const float* o;      // (3, R) ray origins
  const float* d;      // (3, R) ray directions
  const float* vd;     // (3, R) unit view directions
  const float* uc;     // (Sc, R) coarse inverse-CDF positions
  const float* uf;     // (S, R) fine inverse-CDF positions
  const float* proj2;  // (3, Rg, Rg) occupancy pair projections
  float* zc;           // (R, Sc) coarse depths (scratch)
  float* xtc;          // (3, R*Sc) coarse points, unit cube (scratch)
  float* sigc;         // (4, R*Sc) density-only forward output (scratch)
  float* errc;         // (1, R) coarse composite's squared error
  long long R;
  int Sc, NB, Rg;
  double near, step;   // bins: near + b * step, b = 0..NB
  float inv_bound2;    // 1 / (2 * bound)
  float occ_floor;
};

__device__ __forceinline__ float nkf_unit(float p, float ib2) {
  return nkt_clamp(p * ib2 + 0.5f, 0.0f, 1.0f);
}

// CDF of m weights as the reference's _cdf_rows: w + 1e-5, the total summed
// in bin order, cdf[0] = 0, cdf[k + 1] = cdf[k] + w[k] / tot. w is
// overwritten.
__device__ __forceinline__ void nkf_cdf(float* w, int m, float* cdf) {
  float tot = 0.0f;
  for (int k = 0; k < m; ++k) {
    w[k] = w[k] + 1e-5f;
    tot = k == 0 ? w[0] : tot + w[k];
  }
  cdf[0] = 0.0f;
  for (int k = 0; k < m; ++k) cdf[k + 1] = cdf[k] + w[k] / tot;
}

// The reference's _inv_cdf_rows for one position u over m1 = m + 1 CDF
// entries; edge(k) gives the depth of entry k.
template <typename Edge>
__device__ __forceinline__ float nkf_inv_cdf(const float* cdf, int m1, float u,
                                             Edge edge) {
  int cnt = 0;
  for (int k = 0; k < m1; ++k) cnt += cdf[k] <= u ? 1 : 0;
  const int hi = cnt < 1 ? 1 : (cnt > m1 - 1 ? m1 - 1 : cnt);
  const int lo = hi - 1;
  float den = cdf[hi] - cdf[lo];
  if (den < 1e-5f) den = 1.0f;
  const float frac = (u - cdf[lo]) / den;
  const float e_lo = edge(lo);
  return e_lo + frac * (edge(hi) - e_lo);
}

// The pair projections in global memory, rounded to bf16 at each lookup.
struct NkfHullTab {
  const float* p;
  __device__ __forceinline__ float operator[](int e) const {
    return nkt_bf16r(__ldg(p + e));
  }
};

// (a): stages A-B, one thread per ray.
__global__ void __launch_bounds__(NKF_RAY_THREADS)
    nkf_propose_kernel(FullArgs a) {
  const long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= a.R) return;
  const long long R = a.R;
  const float ox = a.o[r], oy = a.o[R + r], oz = a.o[2 * R + r];
  const float dx = a.d[r], dy = a.d[R + r], dz = a.d[2 * R + r];
  const int NB = a.NB, Rg = a.Rg;
  const float fRg = (float)Rg, hi = (float)(Rg - 1);
  const NkfHullTab tab = {a.proj2};
  const float ib2 = a.inv_bound2;

  // ---- stage A: hull occupancy at the bin centres ------------------------
  float w[NKF_MAX_BINS];
  float wmax = 0.0f;
  for (int b = 0; b < NB; ++b) {
    const float t = (float)(a.near + ((double)b + 0.5) * a.step);
    const float ux = nkf_unit(ox + t * dx, ib2);
    const float uy = nkf_unit(oy + t * dy, ib2);
    const float uz = nkf_unit(oz + t * dz, ib2);
    const float occ = nkt_hull_at(tab, Rg, fRg, hi, ux, uy, uz);
    w[b] = occ;
    wmax = b == 0 ? occ : fmaxf(wmax, occ);
  }
  const float den = wmax + 1e-9f;
  for (int b = 0; b < NB; ++b) w[b] = w[b] / den + a.occ_floor;

  // ---- stage B: inverse CDF -> coarse depths -----------------------------
  float cdf[NKF_MAX_BINS + 1];
  nkf_cdf(w, NB, cdf);
  const double near = a.near, step = a.step;
  auto edge = [near, step](int k) { return (float)(near + (double)k * step); };
  const int Sc = a.Sc;
  const long long nc = R * Sc;
  for (int s = 0; s < Sc; ++s) {
    const float z = nkf_inv_cdf(cdf, NB + 1, a.uc[s * R + r], edge);
    const long long i = r * Sc + s;
    a.zc[i] = z;
    a.xtc[i] = nkf_unit(ox + z * dx, ib2);
    a.xtc[nc + i] = nkf_unit(oy + z * dy, ib2);
    a.xtc[2 * nc + i] = nkf_unit(oz + z * dz, ib2);
  }
}

// (c): stages C-D, one thread per ray, after the density-only forward.
__global__ void __launch_bounds__(NKF_RAY_THREADS)
    nkf_fine_inputs_kernel(FullArgs a) {
  const long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= a.R) return;
  const long long R = a.R;
  const int Sc = a.Sc, S = a.b.S;
  const long long nc = R * Sc, nf = R * S;
  const float ox = a.o[r], oy = a.o[R + r], oz = a.o[2 * R + r];
  const float dx = a.d[r], dy = a.d[R + r], dz = a.d[2 * R + r];
  const float dnorm = sqrtf((dx * dx + dy * dy) + dz * dz);
  const float* zc = a.zc + r * Sc;
  const float* sig = a.sigc + 3 * nc + r * Sc;

  // ---- stage C: coarse compositing weights and err_c ---------------------
  float cw[NKF_MAX_SAMPLES];
  float trans = 1.0f, acc = 0.0f;
  for (int s = 0; s < Sc; ++s) {
    const float dist = s < Sc - 1 ? (zc[s + 1] - zc[s]) * dnorm : 1e10f * dnorm;
    const float alpha = 1.0f - expf(-sig[s] * dist);
    const float w = alpha * trans;
    acc = acc + w;
    cw[s] = w;
    trans = trans * ((1.0f - alpha) + 1e-10f);
  }
  const float v = 0.5f * acc + (a.b.white_bg ? 1.0f - acc : 0.0f);
  const float e0 = v - a.b.tgt[r];
  const float e1 = v - a.b.tgt[R + r];
  const float e2 = v - a.b.tgt[2 * R + r];
  a.errc[r] = (e0 * e0 + e1 * e1) + e2 * e2;

  // ---- stage D: inverse CDF over the coarse midpoints -> fine depths -----
  float cdf[NKF_MAX_SAMPLES];
  nkf_cdf(cw + 1, Sc - 2, cdf);
  auto mid = [zc](int k) { return 0.5f * (zc[k] + zc[k + 1]); };
  float* xt = const_cast<float*>(a.b.f.xt);
  float* vdt = const_cast<float*>(a.b.f.vdt);
  float* dists = const_cast<float*>(a.b.dists);
  const float vx = a.vd[r], vy = a.vd[R + r], vz = a.vd[2 * R + r];
  const float ib2 = a.inv_bound2;
  float z = nkf_inv_cdf(cdf, Sc - 1, a.uf[r], mid);
  for (int s = 0; s < S; ++s) {
    const float z_next =
        s < S - 1 ? nkf_inv_cdf(cdf, Sc - 1, a.uf[(s + 1) * R + r], mid) : 0.0f;
    const long long i = r * S + s;
    xt[i] = nkf_unit(ox + z * dx, ib2);
    xt[nf + i] = nkf_unit(oy + z * dy, ib2);
    xt[2 * nf + i] = nkf_unit(oz + z * dz, ib2);
    dists[i] = s < S - 1 ? (z_next - z) * dnorm : 1e10f * dnorm;
    vdt[i] = vx;
    vdt[nf + i] = vy;
    vdt[2 * nf + i] = vz;
    z = z_next;
  }
}

// The density-only forward (ngp_fused.cu) and the fine train objective
// (ngp_fused_bwd.cu), called through their C entry points.
extern "C" int nkt_fused_forward(const FusedArgs* args, int color, int n_sm,
                                 void* stream);
extern "C" int nkt_fused_train(const BwdArgs* b, int n_sm, void* stream);

// The whole train step. Returns the cudaError_t of the first launch that
// failed, 0 = success.
extern "C" int nkt_fused_train_full(const FullArgs* args, int n_sm,
                                    void* stream) {
  const FullArgs& a = *args;
  if (a.R < 1 || a.NB < 1 || a.NB > NKF_MAX_BINS || a.Sc < 3 ||
      a.Sc > NKF_MAX_SAMPLES || a.b.S < 1 || a.b.S > NKF_MAX_SAMPLES ||
      a.b.f.n != a.R * a.b.S || a.Rg < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const unsigned blocks = (unsigned)((a.R + NKF_RAY_THREADS - 1) / NKF_RAY_THREADS);

  // (a) proposal and coarse depths
  nkf_propose_kernel<<<blocks, NKF_RAY_THREADS, 0, st>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  // (b) density-only forward on the coarse points
  FusedArgs fa = a.b.f;
  fa.xt = a.xtc;
  fa.out = a.sigc;
  fa.n = a.R * a.Sc;
  const int rc = nkt_fused_forward(&fa, 0, n_sm, stream);
  if (rc) return rc;

  // (c) coarse weights, err_c, fine depths and the fine stage's operands
  nkf_fine_inputs_kernel<<<blocks, NKF_RAY_THREADS, 0, st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  // (d) the fine stage
  return nkt_fused_train(&a.b, n_sm, stream);
}
