// Fused NGP point pipeline, the gradient kernels.
//
// Replaces the TPU kernels of nerf_kinematics_tpu/ops/ngp_fused_pallas.py:
//   ngp_fused_apply_cf VJP (_bwd_kernel, _fused_bwd_cf) -> nkt_fused_backward
//   ngp_fused_train_cf (_train_kernel, _fine_stage)     -> nkt_fused_train
//
// The TPU kernels keep a block's activations in VMEM and add every block's
// parameter gradients into one resident accumulator, relying on grid steps
// running in order. Here blocks run at once and a block has 227 KB, which
// the layers' weights nearly fill. So one call is a sequence of kernels on
// the caller's stream, with the per-point intermediates in device scratch:
//
//   1. nkt_fused_apply_save_kernel: the forward of ngp_fused.cuh, which also
//      writes every layer's rounded input and the f32 feature 0 to `act`.
//   2. (train only) nkt_train_rays_kernel: one thread per ray composites its
//      S samples (transmittance T * (1 - alpha + 1e-10), optional white
//      background), takes the squared error against the target and runs the
//      division-free reverse recurrence
//          d alpha_s = (dw_s - dT) * T_s
//          dT       <- dw_s * alpha_s + dT * (1 - alpha_s + 1e-10)
//      to the (4, N) cotangent of (rgb logits, sigma).
//   3. nkt_fused_point_bwd_kernel: one thread per point walks the layers
//      backwards. The masked cotangent g of each layer goes to `gs` in f32
//      (db sums that), is rounded to bf16 once and meets the bf16 weights in
//      d_inp = W g. sigma's cotangent enters feature row 0 where
//      -15 < z0 < 15. For the encoder the point's 256 d_enc values pass
//      through shared memory one level at a time, and the warp then handles
//      its 32 points one after the other with its lanes on the channels, so
//      the table loads and the atomicAdds into dlines are contiguous.
//   4. nkt_wgrad_kernel, once per layer: dW = inp g^T over the points as a
//      tiled product (32 points per tile in shared memory, each thread owns
//      up to 16 groups of four (in, out) entries in registers across its
//      tiles), db = sum of the f32 g. Per-block partial sums.
//   5. nkt_reduce_partials_kernel: adds the partial sums in block order.
//
// The MLP gradients are therefore deterministic; dlines is summed by
// atomicAdd and differs in the last bits from run to run.
//
// Bound on this card: operations (three times the forward's products).
// All products run on the f32 FMA pipe: simple and right first.
#include "ngp_fused.cuh"

#define NKT_HS 257     // column stride of the backward's per-thread buffer
#define NKT_TP 32      // points per tile of the weight-gradient kernel
#define NKT_AS 33      // row stride of its input tile (no bank conflicts)
#define NKT_MAX_Q 16   // groups of four entries one thread may own there

// Mirrors ops/cuda_lib.py::BwdArgs field for field.
struct BwdArgs {
  FusedArgs f;         // the forward's arguments; f.out is (4, n) scratch
  const float* g;      // (4, n) cotangent of f.out (the VJP)
  float* act;          // (act_rows, n) saved layer inputs and feature 0
  float* gs;           // (gs_rows, n) masked f32 cotangent of every layer
  float* partial;      // (n_part, total) per-block sums of the MLP leaves
  float* flat;         // (total,) the MLP leaves' gradients
  float* dlines;       // (L, 3, T, C), zeroed by the caller
  const float* dists;  // (1, n) compositing intervals, ray-major (train)
  const float* tgt;    // (3, R) target pixels (train)
  float* err;          // (1, R) squared error per ray (train)
  float* maps;         // (4, R) rgb map and acc (train)
  float* gbuf;         // (4, n) cotangent written by the ray kernel (train)
  int S;               // samples per ray (train)
  int white_bg;
  float inv_denom;     // dL/d(rgb_map) = 2 * inv_denom * diff
  int n_part;          // rows of `partial`
};

__global__ void __launch_bounds__(NKT_THREADS, 1)
    nkt_fused_apply_save_kernel(FusedArgs a, FusedLayout lay, SaveRows rows,
                                float* act) {
  nkt_fused_body<true, true>(a, lay, rows, act);
}

// One thread per ray. Points are ray-major: sample s of ray r is r * S + s.
__global__ void nkt_train_rays_kernel(BwdArgs b, long long n_rays) {
  const long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n_rays) return;
  const long long n = b.f.n;
  const int S = b.S;
  const float* out = b.f.out;
  float* gb = b.gbuf;
  float T = 1.0f, m0 = 0.0f, m1 = 0.0f, m2 = 0.0f, acc = 0.0f;
  for (int s = 0; s < S; ++s) {
    const long long i = r * S + s;
    const float alpha = 1.0f - expf(-out[3 * n + i] * b.dists[i]);
    const float w = alpha * T;
    m0 = m0 + w * (1.0f / (1.0f + expf(-out[i])));
    m1 = m1 + w * (1.0f / (1.0f + expf(-out[n + i])));
    m2 = m2 + w * (1.0f / (1.0f + expf(-out[2 * n + i])));
    acc = acc + w;
    gb[3 * n + i] = T;  // read back by the reverse pass, then overwritten
    T = T * (1.0f - alpha + 1e-10f);
  }
  if (b.white_bg) {
    m0 = m0 + (1.0f - acc);
    m1 = m1 + (1.0f - acc);
    m2 = m2 + (1.0f - acc);
  }
  const float d0 = m0 - b.tgt[r];
  const float d1 = m1 - b.tgt[n_rays + r];
  const float d2 = m2 - b.tgt[2 * n_rays + r];
  b.err[r] = (d0 * d0 + d1 * d1) + d2 * d2;
  b.maps[r] = m0;
  b.maps[n_rays + r] = m1;
  b.maps[2 * n_rays + r] = m2;
  b.maps[3 * n_rays + r] = acc;
  const float k = 2.0f * b.inv_denom;
  const float g0 = k * d0, g1 = k * d1, g2 = k * d2;
  const float gsum = (g0 + g1) + g2;
  float dT = 0.0f;
  for (int s = S - 1; s >= 0; --s) {
    const long long i = r * S + s;
    const float dist = b.dists[i];
    const float alpha = 1.0f - expf(-out[3 * n + i] * dist);
    const float Ts = gb[3 * n + i];
    const float w = alpha * Ts;
    const float s0 = 1.0f / (1.0f + expf(-out[i]));
    const float s1 = 1.0f / (1.0f + expf(-out[n + i]));
    const float s2 = 1.0f / (1.0f + expf(-out[2 * n + i]));
    float dw = (g0 * s0 + g1 * s1) + g2 * s2;
    if (b.white_bg) dw = dw - gsum;
    gb[i] = (g0 * w) * s0 * (1.0f - s0);
    gb[n + i] = (g1 * w) * s1 * (1.0f - s1);
    gb[2 * n + i] = (g2 * w) * s2 * (1.0f - s2);
    const float da = (dw - dT) * Ts;
    dT = dw * alpha + dT * (1.0f - alpha + 1e-10f);
    gb[3 * n + i] = da * (1.0f - alpha) * dist;
  }
}

// hs[k] = sum_j W[k][j] * g[j] for k < in: d_inp = W g, the thread's g in
// registers, the weights broadcast 16-byte loads, the result in the
// thread's column.
template <int NOUT>
__device__ __forceinline__ void nkt_dense_t(const float* __restrict__ sw,
                                            const float* g, int in,
                                            float* hs) {
  for (int k = 0; k < in; ++k) {
    const float4* w = reinterpret_cast<const float4*>(sw + k * NKT_W);
    float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f, s3 = 0.0f;
#pragma unroll
    for (int j4 = 0; j4 < NOUT / 4; ++j4) {
      const float4 wv = w[j4];
      s0 = __fmaf_rn(wv.x, g[4 * j4 + 0], s0);
      s1 = __fmaf_rn(wv.y, g[4 * j4 + 1], s1);
      s2 = __fmaf_rn(wv.z, g[4 * j4 + 2], s2);
      s3 = __fmaf_rn(wv.w, g[4 * j4 + 3], s3);
    }
    hs[k * NKT_HS] = (s0 + s1) + (s2 + s3);
  }
}

__device__ __forceinline__ void nkt_dense_t_any(const float* sw, const float* g,
                                                int in, int out, float* hs) {
  if (out <= 4) {
    nkt_dense_t<4>(sw, g, in, hs);
  } else if (out <= 16) {
    nkt_dense_t<16>(sw, g, in, hs);
  } else if (out <= 32) {
    nkt_dense_t<32>(sw, g, in, hs);
  } else {
    nkt_dense_t<NKT_W>(sw, g, in, hs);
  }
}

// Mask the layer's output cotangent by its ReLU (mask_row: the act rows of
// the next layer's input, relu(z) > 0 where z > 0; negative = no ReLU),
// store it in f32 for the weight-gradient kernel and round it for d_inp.
__device__ __forceinline__ void nkt_mask_store(float* g, int out, int mask_row,
                                               int gs_row, const BwdArgs& b,
                                               long long i, bool valid,
                                               bool bf) {
  const long long n = b.f.n;
#pragma unroll
  for (int j = 0; j < NKT_W; ++j) {
    float v = 0.0f;
    if (j < out && valid) {
      v = g[j];
      if (mask_row >= 0 && !(b.act[(long long)(mask_row + j) * n + i] > 0.0f))
        v = 0.0f;
      b.gs[(long long)(gs_row + j) * n + i] = v;
      if (bf) v = nkt_bf16r(v);
    }
    g[j] = v;
  }
}

__global__ void __launch_bounds__(NKT_THREADS, 1)
    nkt_fused_point_bwd_kernel(BwdArgs b, FusedLayout lay, SaveRows rows) {
  extern __shared__ float smem[];
  const FusedArgs& a = b.f;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp0 = tid & ~31;
  const bool bf = a.cp.use_bf16 != 0;

  nkt_stage_weights(a, lay, a.nd + a.nc, bf, smem);
  __syncthreads();

  // The thread's column, stride NKT_HS: a warp only ever touches its own 32
  // columns, so the loop below needs no block-wide synchronisation.
  float* hs = smem + lay.hs_off + tid;
  const int C = a.cp.n_comp;
  const long long n = a.n;

  for (long long base = (long long)blockIdx.x * NKT_THREADS; base < n;
       base += (long long)gridDim.x * NKT_THREADS) {
    const long long i = base + tid;
    const bool valid = i < n;
    const long long ii = valid ? i : 0;

    float g[NKT_W];
#pragma unroll
    for (int j = 0; j < NKT_W; ++j) g[j] = 0.0f;
    g[0] = b.g[ii];
    g[1] = b.g[n + ii];
    g[2] = b.g[2 * n + ii];
    const float g_sigma = b.g[3 * n + ii];

    // ---- color MLP, last layer first -----------------------------------
    for (int li = a.nc - 1; li >= 0; --li) {
      nkt_mask_store(g, a.c_out[li], li < a.nc - 1 ? rows.c_row[li + 1] : -1,
                     rows.cg_row[li], b, ii, valid, bf);
      nkt_dense_t_any(smem + lay.w_off[a.nd + li], g, a.c_in[li], a.c_out[li],
                      hs);
#pragma unroll
      for (int j = 0; j < NKT_W; ++j)
        g[j] = j < a.c_in[li] ? hs[j * NKT_HS] : 0.0f;
    }
    // g[0, dout) is the features' cotangent; the SH part is dropped.
    // sigma = exp(clip(z0)): its cotangent enters feature 0 where unclipped.
    const float z0 = b.act[(long long)rows.z0_row * n + ii];
    if (z0 > -15.0f && z0 < 15.0f)
      g[0] = g[0] + g_sigma * expf(fminf(fmaxf(z0, -15.0f), 15.0f));

    // ---- density MLP down to layer 0's output --------------------------
    for (int li = a.nd - 1; li >= 0; --li) {
      nkt_mask_store(g, a.d_out[li], li < a.nd - 1 ? rows.d_row[li + 1] : -1,
                     rows.dg_row[li], b, ii, valid, bf);
      if (li == 0) break;
      nkt_dense_t_any(smem + lay.w_off[li], g, a.d_in[li], a.d_out[li], hs);
#pragma unroll
      for (int j = 0; j < NKT_W; ++j)
        g[j] = j < a.d_in[li] ? hs[j * NKT_HS] : 0.0f;
    }

    // ---- encoder: d_enc = W0 g one level at a time, then the tables -----
    const float px = a.xt[ii], py = a.xt[n + ii], pz = a.xt[2 * n + ii];
    for (int l = 0; l < a.cp.n_levels; ++l) {
      nkt_dense_t_any(smem + lay.w_off[0] + (l * C) * NKT_W, g, C, a.d_out[0],
                      hs);
      __syncwarp();
      for (int pp = 0; pp < 32; ++pp) {
        if (base + warp0 + pp >= n) break;  // the same for the whole warp
        const float qx = __shfl_sync(0xffffffffu, px, pp);
        const float qy = __shfl_sync(0xffffffffu, py, pp);
        const float qz = __shfl_sync(0xffffffffu, pz, pp);
        const NktTaps tx = nkt_taps(qx, a.cp, l, 0);
        const NktTaps ty = nkt_taps(qy, a.cp, l, 1);
        const NktTaps tz = nkt_taps(qz, a.cp, l, 2);
        const float* col = smem + lay.hs_off + warp0 + pp;
        for (int c = lane; c < C; c += 32)
          nkt_enc_bwd_channel(a.lines, b.dlines, a.cp, l, c, tx, ty, tz,
                              col[c * NKT_HS]);
      }
      __syncwarp();
    }
  }
}

// partial[w_off + k * J + j] = sum over the block's tiles of A[k][p] *
// bf16(G[j][p]); partial[b_off + j] = sum of G[j][p]. A: (K, n) layer input
// (already rounded), G: (J, n) masked f32 cotangent. The thread owns groups
// of four consecutive j: group q = tid + 256 * i is k = q / J4, j4 = q % J4.
// UNIFORM: J4 divides 256, so j4 is the same for all of a thread's groups.
template <bool UNIFORM>
__global__ void __launch_bounds__(NKT_THREADS)
    nkt_wgrad_kernel(const float* __restrict__ A, const float* __restrict__ G,
                     long long n, int K, int J, int bf, float* partial,
                     int total, int w_off, int b_off) {
  extern __shared__ float smem[];
  const int tid = threadIdx.x;
  const int J4 = (J + 3) / 4;
  const int JP = 4 * J4 + 4;
  float* As = smem;                  // [K][NKT_AS]
  float* Gr = As + K * NKT_AS;       // [NKT_TP][JP], rounded
  float* Gf = Gr + NKT_TP * JP;      // [NKT_TP][JP], f32
  for (int e = tid; e < 2 * NKT_TP * JP; e += NKT_THREADS) Gr[e] = 0.0f;

  int koff[NKT_MAX_Q], joff[NKT_MAX_Q];
  float acc[NKT_MAX_Q][4];
  int nq = 0;
#pragma unroll
  for (int i = 0; i < NKT_MAX_Q; ++i) {
    const int q = tid + NKT_THREADS * i;
    const bool own = q < K * J4;
    koff[i] = own ? (q / J4) * NKT_AS : 0;
    joff[i] = own ? (q % J4) * 4 : 0;
    if (own) nq = i + 1;
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.0f;
  }
  float dbacc = 0.0f;
  __syncthreads();

  const long long tiles = (n + NKT_TP - 1) / NKT_TP;
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const long long n0 = t * NKT_TP;
    for (int e = tid; e < K * NKT_TP; e += NKT_THREADS) {
      const int k = e / NKT_TP, p = e % NKT_TP;
      As[k * NKT_AS + p] = n0 + p < n ? A[(long long)k * n + n0 + p] : 0.0f;
    }
    for (int e = tid; e < J * NKT_TP; e += NKT_THREADS) {
      const int j = e / NKT_TP, p = e % NKT_TP;
      const float v = n0 + p < n ? G[(long long)j * n + n0 + p] : 0.0f;
      Gf[p * JP + j] = v;
      Gr[p * JP + j] = bf ? nkt_bf16r(v) : v;
    }
    __syncthreads();
    for (int p = 0; p < NKT_TP; ++p) {
      float4 gv;
      if (UNIFORM) gv = *reinterpret_cast<const float4*>(Gr + p * JP + joff[0]);
#pragma unroll
      for (int i = 0; i < NKT_MAX_Q; ++i) {
        if (i < nq) {
          if (!UNIFORM)
            gv = *reinterpret_cast<const float4*>(Gr + p * JP + joff[i]);
          const float av = As[koff[i] + p];
          acc[i][0] = __fmaf_rn(av, gv.x, acc[i][0]);
          acc[i][1] = __fmaf_rn(av, gv.y, acc[i][1]);
          acc[i][2] = __fmaf_rn(av, gv.z, acc[i][2]);
          acc[i][3] = __fmaf_rn(av, gv.w, acc[i][3]);
        }
      }
    }
    if (tid < J) {
      for (int p = 0; p < NKT_TP; ++p) dbacc += Gf[p * JP + tid];
    }
    __syncthreads();
  }

  float* mine = partial + (long long)blockIdx.x * total;
#pragma unroll
  for (int i = 0; i < NKT_MAX_Q; ++i) {
    const int q = tid + NKT_THREADS * i;
    if (q < K * J4) {
      const int k = q / J4, j = (q % J4) * 4;
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (j + c < J) mine[w_off + k * J + j + c] = acc[i][c];
    }
  }
  if (tid < J) mine[b_off + tid] = dbacc;
}

__global__ void nkt_reduce_partials_kernel(const float* __restrict__ partial,
                                           float* __restrict__ flat, int total,
                                           int nb) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= total) return;
  float s = 0.0f;
  for (int b = 0; b < nb; ++b) s += partial[(long long)b * total + e];
  flat[e] = s;
}

static size_t wgrad_smem(int K, int J) {
  const int JP = 4 * ((J + 3) / 4) + 4;
  return (size_t)(K * NKT_AS + 2 * NKT_TP * JP) * sizeof(float);
}

static bool dims_ok(const FusedArgs& a) {
  if (a.cp.n_comp > NKT_W || a.cp.n_comp % 4) return false;
  for (int li = 0; li < a.nd; ++li)
    if (a.d_in[li] * ((a.d_out[li] + 3) / 4) > NKT_MAX_Q * NKT_THREADS)
      return false;
  for (int li = 0; li < a.nc; ++li)
    if (a.c_in[li] * ((a.c_out[li] + 3) / 4) > NKT_MAX_Q * NKT_THREADS)
      return false;
  return true;
}

#define NKT_CHECK(expr)                        \
  do {                                         \
    cudaError_t e_ = (expr);                   \
    if (e_ != cudaSuccess) return (int)e_;     \
  } while (0)

static int launch_wgrad(const float* A, const float* G, int K, int J,
                        const BwdArgs& b, const SaveRows& rows, int w_off,
                        int b_off, int blocks, cudaStream_t st) {
  const size_t bytes = wgrad_smem(K, J);
  const int J4 = (J + 3) / 4;
  if (NKT_THREADS % J4 == 0) {
    NKT_CHECK(cudaFuncSetAttribute(nkt_wgrad_kernel<true>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)bytes));
    nkt_wgrad_kernel<true><<<blocks, NKT_THREADS, bytes, st>>>(
        A, G, b.f.n, K, J, b.f.cp.use_bf16, b.partial, rows.total, w_off,
        b_off);
  } else {
    NKT_CHECK(cudaFuncSetAttribute(nkt_wgrad_kernel<false>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)bytes));
    nkt_wgrad_kernel<false><<<blocks, NKT_THREADS, bytes, st>>>(
        A, G, b.f.n, K, J, b.f.cp.use_bf16, b.partial, rows.total, w_off,
        b_off);
  }
  return (int)cudaGetLastError();
}

static int run_backward(const BwdArgs& b, bool train, int n_sm,
                        cudaStream_t st) {
  const FusedArgs& a = b.f;
  if (!dims_ok(a) || b.n_part < 1) return (int)cudaErrorInvalidValue;
  if (train && (b.S < 1 || a.n % b.S)) return (int)cudaErrorInvalidValue;
  const SaveRows rows = make_rows(a);
  long long blocks = (a.n + NKT_THREADS - 1) / NKT_THREADS;
  if (blocks > n_sm) blocks = n_sm;

  // 1. forward, saving the layers' inputs
  const FusedLayout lay_f = make_layout(a, true);
  const size_t bytes_f = (size_t)lay_f.total * sizeof(float);
  NKT_CHECK(cudaFuncSetAttribute(nkt_fused_apply_save_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)bytes_f));
  nkt_fused_apply_save_kernel<<<(unsigned)blocks, NKT_THREADS, bytes_f, st>>>(
      a, lay_f, rows, b.act);
  NKT_CHECK(cudaGetLastError());

  // 2. per-ray compositing, loss and the cotangent of (rgb logits, sigma)
  BwdArgs bb = b;
  if (train) {
    const long long n_rays = a.n / b.S;
    nkt_train_rays_kernel<<<(unsigned)((n_rays + 127) / 128), 128, 0, st>>>(
        b, n_rays);
    NKT_CHECK(cudaGetLastError());
    bb.g = b.gbuf;
  }

  // 3. per-point backward through the MLPs and the encoder
  const FusedLayout lay_b = make_layout(a, true, NKT_W * NKT_HS);
  const size_t bytes_b = (size_t)lay_b.total * sizeof(float);
  NKT_CHECK(cudaFuncSetAttribute(nkt_fused_point_bwd_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)bytes_b));
  nkt_fused_point_bwd_kernel<<<(unsigned)blocks, NKT_THREADS, bytes_b, st>>>(
      bb, lay_b, rows);
  NKT_CHECK(cudaGetLastError());

  // 4. weight gradients, per-block partial sums
  const long long tiles = (a.n + NKT_TP - 1) / NKT_TP;
  const int wblocks = (int)(tiles < b.n_part ? tiles : b.n_part);
  for (int li = 0; li < a.nd; ++li) {
    const int rc = launch_wgrad(b.act + (long long)rows.d_row[li] * a.n,
                                b.gs + (long long)rows.dg_row[li] * a.n,
                                a.d_in[li], a.d_out[li], b, rows,
                                rows.dw_off[li], rows.db_off[li], wblocks, st);
    if (rc) return rc;
  }
  for (int li = 0; li < a.nc; ++li) {
    const int rc = launch_wgrad(b.act + (long long)rows.c_row[li] * a.n,
                                b.gs + (long long)rows.cg_row[li] * a.n,
                                a.c_in[li], a.c_out[li], b, rows,
                                rows.cw_off[li], rows.cb_off[li], wblocks, st);
    if (rc) return rc;
  }

  // 5. the sum over blocks
  nkt_reduce_partials_kernel<<<(rows.total + 255) / 256, 256, 0, st>>>(
      b.partial, b.flat, rows.total, wblocks);
  return (int)cudaGetLastError();
}

// out[0] = rows of act, out[1] = rows of gs, out[2] = floats of the flat MLP
// gradient, out[3] = bytes of shared memory of the largest kernel.
extern "C" void nkt_fused_bwd_sizes(const FusedArgs* args, long long* out) {
  const SaveRows rows = make_rows(*args);
  out[0] = rows.act_rows;
  out[1] = rows.gs_rows;
  out[2] = rows.total;
  const long long f = make_layout(*args, true).total;
  const long long bw = make_layout(*args, true, NKT_W * NKT_HS).total;
  out[3] = (f > bw ? f : bw) * (long long)sizeof(float);
}

// The VJP of the fused forward: b->g is the (4, n) cotangent.
extern "C" int nkt_fused_backward(const BwdArgs* b, int n_sm, void* stream) {
  return run_backward(*b, false, n_sm, (cudaStream_t)stream);
}

// The fused fine train objective: forward, compositing, loss and backward.
extern "C" int nkt_fused_train(const BwdArgs* b, int n_sm, void* stream) {
  return run_backward(*b, true, n_sm, (cudaStream_t)stream);
}
