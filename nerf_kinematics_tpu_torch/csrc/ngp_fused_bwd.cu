// Fused NGP point pipeline, the gradient kernels.
//
// Replaces the TPU kernels of nerf_kinematics_tpu/ops/ngp_fused_pallas.py:
//   ngp_fused_apply_cf VJP (_bwd_kernel, _fused_bwd_cf) -> nkt_fused_backward
//   ngp_fused_train_cf (_train_kernel, _fine_stage)     -> nkt_fused_train
//
// The TPU kernels keep a block's activations in VMEM and add every block's
// parameter gradients into one resident accumulator, relying on grid steps
// running in order. Here blocks run at once and a block has 227 KB. So one
// call is a sequence of kernels on the caller's stream, with the per-point
// intermediates in device scratch (rows ld points apart):
//
//   1. forward with saves: the forward body, which also writes every layer's
//      rounded input to `act` and the f32 feature 0 to `z0`.
//   2. (train only) nkt_train_rays_kernel: one thread per ray composites its
//      S samples (transmittance T * (1 - alpha + 1e-10), optional white
//      background), takes the squared error against the target and runs the
//      division-free reverse recurrence
//          d alpha_s = (dw_s - dT) * T_s
//          dT       <- dw_s * alpha_s + dT * (1 - alpha_s + 1e-10)
//      to the (4, N) cotangent of (rgb logits, sigma).
//   3. per-point backward: the layers backwards. The masked cotangent g of
//      each layer goes to `gs` in f32 (db sums that), is rounded to bf16
//      once and meets the bf16 weights in d_inp = W g. sigma's cotangent
//      enters feature row 0 where -15 < z0 < 15. The encoding's f32
//      cotangent d_enc = W0 g goes to `denc` (n, L*C).
//   3b. nkt_dlines_launch (csrc/cp_encode.cu, row 5's kernel): d_enc into
//      the line tables' gradient, chunk by chunk, the chunks added in order.
//   4. weight gradients dW = inp g^T over the points, db = sum of the f32 g,
//      as per-block partial sums.
//   5. nkt_reduce_partials_kernel: adds the partial sums in block order.
//
// Every sum runs in a fixed order, so the gradients are deterministic.
//
// Two sets of kernels, picked by the mode (nothing falls back):
//
//  * bf16 mode, on the tensor cores (mma.sync.m16n8k16, nkt_mma.cuh):
//    1. nkt_mma_apply_save_kernel (the forward body of nkt_mma.cuh), act in
//       bf16: every saved value is bf16-rounded already, so this is exact.
//    3. nkt_mma_point_bwd_kernel: a warp per 16 points, the C fragments of
//       one layer's d_inp are the A fragments of the next product. The
//       encoder's d_enc goes through a per-warp f32 tile to `denc`, a
//       point's 64 channels of a level in one 256-byte row.
//    4. nkt_wgrad_mma_kernel: all layers in one launch, a grid over (point
//       chunk, layer job); each block accumulates its job's whole K x J in
//       registers over 64-point tiles of bf16(act) and bf16(gs) that
//       cp.async double-buffers into shared memory.
//    Bound on this card: bytes, the saved activations (act in bf16, gs in
//    f32: about 0.86 GB read by step 4 at 8192 x 48 points); the products
//    (about 75 GFLOP a call) take a fraction of that at the bf16 rate.
//  * f32 mode, on the FMA pipe (simple and right first):
//    1. nkt_fused_apply_save_kernel, 3. nkt_fused_point_bwd_kernel (one
//    thread per point; for the encoder the point's 256 d_enc values pass
//    through shared memory one level at a time, and the warp then writes
//    its 32 points' rows to `denc` with its lanes on the channels),
//    4. nkt_wgrad_kernel once per layer (32 points per tile in shared
//    memory, each thread owns up to 16 groups of four (in, out) entries in
//    registers across its tiles).
#include "nkt_mma.cuh"

#define NKT_HS 257     // column stride of the backward's per-thread buffer
#define NKT_TP 32      // points per tile of the weight-gradient kernel
#define NKT_AS 33      // row stride of its input tile (no bank conflicts)
#define NKT_MAX_Q 16   // groups of four entries one thread may own there

__global__ void __launch_bounds__(NKT_THREADS, 1)
    nkt_fused_apply_save_kernel(FusedArgs a, FusedLayout lay, SaveRows rows,
                                float* act, float* z0s) {
  nkt_fused_body<true, true>(a, lay, rows, act, z0s);
}

__global__ void __launch_bounds__(NKT_MMA_MAX_WARPS * 32, 1)
    nkt_mma_apply_save_kernel(FusedArgs a, MmaLayout lay, SaveRows rows,
                              __nv_bfloat16* act, float* z0s, long long ld) {
  nkt_mma_body<true, true>(a, lay, rows, act, z0s, ld);
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
      if (mask_row >= 0 &&
          !(static_cast<const float*>(b.act)[(long long)(mask_row + j) * n + i] > 0.0f))
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
    const float z0 = b.z0[ii];
    if (z0 > -15.0f && z0 < 15.0f)
      g[0] = g[0] + g_sigma * expf(nkt_clamp(z0, -15.0f, 15.0f));

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

    // ---- encoder: d_enc = W0 g one level at a time, to denc -------------
    const long long LC = (long long)a.cp.n_levels * C;
    for (int l = 0; l < a.cp.n_levels; ++l) {
      nkt_dense_t_any(smem + lay.w_off[0] + (l * C) * NKT_W, g, C, a.d_out[0],
                      hs);
      __syncwarp();
      for (int pp = 0; pp < 32; ++pp) {
        const long long ip = base + warp0 + pp;
        if (ip >= n) break;  // the same for the whole warp
        const float* col = smem + lay.hs_off + warp0 + pp;
        for (int c = lane; c < C; c += 32)
          b.denc[ip * LC + l * C + c] = col[c * NKT_HS];
      }
      __syncwarp();
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 mode: the per-point backward on the tensor cores.

#define NKT_LDF 72  // words per row of the backward's f32 tile (64 + 8)

// Shared memory of nkt_mma_point_bwd_kernel: the backward blocks of the
// packed weights (rows = a layer's inputs), then one f32 tile per warp.
static MmaLayout make_mma_layout_bwd(const FusedArgs& a) {
  MmaLayout lay;
  lay.w_start = a.pk_fwd;
  lay.w_elems = a.pk_all - a.pk_fwd;
  lay.b_off = lay.w_elems * 2;
  lay.n_bias = 0;
  lay.tile_off = lay.b_off;
  lay.lde = NKT_LDF;
  lay.ldh = 0;
  lay.tile_bytes = NKT_MT * NKT_LDF * (int)sizeof(float);
  const int warps = (NKT_SMEM_MAX - lay.tile_off) / lay.tile_bytes;
  lay.warps = warps > NKT_MMA_MAX_WARPS ? NKT_MMA_MAX_WARPS : (warps < 1 ? 1 : warps);
  lay.total = lay.tile_off + lay.warps * lay.tile_bytes;
  return lay;
}

// The C-fragment cotangent of a layer's J outputs: masked by the ReLU of
// the next layer's saved input (mask_row < 0: none), stored in f32 to gs
// for the weight gradients; columns at or past J become 0.
__device__ __forceinline__ void nkt_mma_mask_store(float (*gc)[4], int J,
                                                   int mask_row, int gs_row,
                                                   const BwdArgs& b,
                                                   long long p0, int g,
                                                   int t) {
  const __nv_bfloat16* act = static_cast<const __nv_bfloat16*>(b.act);
  const long long ld = b.ld;
#pragma unroll
  for (int nt = 0; nt < NKT_MAX_NT; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = nt * 8 + 2 * t + (e & 1);
      const long long p = p0 + g + (e >> 1) * 8;
      float v = 0.0f;
      if (col < J) {
        v = gc[nt][e];
        if (mask_row >= 0 &&
            !(__bfloat162float(act[(long long)(mask_row + col) * ld + p]) > 0.0f))
          v = 0.0f;
        b.gs[(long long)(gs_row + col) * ld + p] = v;
      }
      gc[nt][e] = v;
    }
  }
}

__global__ void __launch_bounds__(NKT_MMA_MAX_WARPS * 32, 1)
    nkt_mma_point_bwd_kernel(BwdArgs b, MmaLayout lay, SaveRows rows) {
  extern __shared__ __align__(16) unsigned char smem_mma[];
  const FusedArgs& a = b.f;
  nkt_mma_stage(a, lay, smem_mma);
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const uint32_t* sw = reinterpret_cast<const uint32_t*>(smem_mma);
  float* ft = reinterpret_cast<float*>(smem_mma + lay.tile_off +
                                       warp * lay.tile_bytes);
  const int C = a.cp.n_comp;
  const long long n = a.n;
  const long long n_tiles = (n + NKT_MT - 1) / NKT_MT;
  const int Jlast = a.c_out[a.nc - 1];

  const int warps = blockDim.x >> 5;
  for (long long tt = (long long)blockIdx.x * warps + warp; tt < n_tiles;
       tt += (long long)gridDim.x * warps) {
    const long long p0 = tt * NKT_MT;
    const long long pg = p0 + g, pg8 = p0 + g + 8;

    // ---- the cotangent of the rgb logits, C fragments ------------------
    float gc[NKT_MAX_NT][4];
#pragma unroll
    for (int nt = 0; nt < NKT_MAX_NT; ++nt)
      gc[nt][0] = gc[nt][1] = gc[nt][2] = gc[nt][3] = 0.0f;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = 2 * t + (e & 1);
      const long long p = e < 2 ? pg : pg8;
      if (col < Jlast && p < n) gc[0][e] = b.g[col * n + p];
    }

    // ---- color MLP, last layer first ------------------------------------
    uint32_t af[NKT_MAX_NT / 2][4];
    for (int li = a.nc - 1; li >= 0; --li) {
      const int L = a.nd + li;
      const int J = a.c_out[li];
      nkt_mma_mask_store(gc, J, li < a.nc - 1 ? rows.c_row[li + 1] : -1,
                         rows.cg_row[li], b, p0, g, t);
      nkt_c_to_a(gc, (J + 7) / 8, af);
      // color layer 0: only the features' columns, the SH part is dropped
      const int NK = li > 0 ? a.c_in[li] / 8 : a.d_out[a.nd - 1] / 8;
      nkt_mma_dense(af, (J + 15) / 16, sw + (a.pk_boff[L] - a.pk_fwd) / 2,
                    a.pk_bld[L] / 2, NK, gc, g, t);
    }
    // sigma = exp(clip(z0)): its cotangent enters feature 0 where unclipped
    if (t == 0) {
      if (pg < n) {
        const float z0 = b.z0[pg];
        if (z0 > -15.0f && z0 < 15.0f)
          gc[0][0] = gc[0][0] + b.g[3 * n + pg] * expf(nkt_clamp(z0, -15.0f, 15.0f));
      }
      if (pg8 < n) {
        const float z0 = b.z0[pg8];
        if (z0 > -15.0f && z0 < 15.0f)
          gc[0][2] = gc[0][2] + b.g[3 * n + pg8] * expf(nkt_clamp(z0, -15.0f, 15.0f));
      }
    }

    // ---- density MLP down to layer 0's output ----------------------------
    for (int li = a.nd - 1; li >= 0; --li) {
      const int J = a.d_out[li];
      nkt_mma_mask_store(gc, J, li < a.nd - 1 ? rows.d_row[li + 1] : -1,
                         rows.dg_row[li], b, p0, g, t);
      nkt_c_to_a(gc, (J + 7) / 8, af);
      if (li == 0) break;
      nkt_mma_dense(af, (J + 15) / 16, sw + (a.pk_boff[li] - a.pk_fwd) / 2,
                    a.pk_bld[li] / 2, a.d_in[li] / 8, gc, g, t);
    }

    // ---- encoder: d_enc = W0 g a level (64 channels) at a time, through
    // the warp's f32 tile to denc, one point's channels a row ---------------
    const int KT0 = (a.d_out[0] + 15) / 16;
    const uint32_t* W0 = sw + (a.pk_boff[0] - a.pk_fwd) / 2;
    const int ld0 = a.pk_bld[0] / 2;
    const int np = n - p0 < NKT_MT ? (int)(n - p0) : NKT_MT;
    const long long LC = (long long)a.cp.n_levels * C;
    for (int l = 0; l < a.cp.n_levels; ++l) {
      for (int cb = 0; cb < C; cb += 64) {
        const int NTc = (C - cb < 64 ? C - cb : 64) / 8;
        nkt_mma_dense(af, KT0, W0 + (l * C + cb) * ld0, ld0, NTc, gc, g, t);
#pragma unroll
        for (int nt = 0; nt < NKT_MAX_NT; ++nt) {
          if (nt < NTc) {
            *reinterpret_cast<float2*>(ft + g * NKT_LDF + nt * 8 + 2 * t) =
                make_float2(gc[nt][0], gc[nt][1]);
            *reinterpret_cast<float2*>(ft + (g + 8) * NKT_LDF + nt * 8 + 2 * t) =
                make_float2(gc[nt][2], gc[nt][3]);
          }
        }
        __syncwarp();
        if (lane < NTc * 4) {
          for (int pp = 0; pp < np; ++pp)
            *reinterpret_cast<float2*>(b.denc + (p0 + pp) * LC + l * C + cb + 2 * lane) =
                *reinterpret_cast<const float2*>(ft + pp * NKT_LDF + 2 * lane);
        }
        __syncwarp();
      }
    }
  }
}

// partial[w_off + k * J + j] = sum over the block's tiles of bf16(A[k][p]) *
// bf16(G[j][p]) (no rounding when bf is 0); partial[b_off + j] = sum of
// G[j][p]. A: (K, n) layer input (the NGP kernels save it rounded already,
// the classic kernels in f32), G: (J, n) masked f32 cotangent. The thread owns groups
// of four consecutive j: group q = tid + 256 * i is k = q / J4, j4 = q % J4.
// UNIFORM: J4 divides 256, so j4 is the same for all of a thread's groups.
// Floats of the input tile, rounded up so that the tile after it starts on
// a 16-byte boundary (its rows are read as float4).
__host__ __device__ __forceinline__ int nkt_as_floats(int K) {
  return (K * NKT_AS + 3) & ~3;
}

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
  float* Gr = As + nkt_as_floats(K); // [NKT_TP][JP], rounded (16-byte aligned)
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
      const float v = n0 + p < n ? A[(long long)k * n + n0 + p] : 0.0f;
      As[k * NKT_AS + p] = bf ? nkt_bf16r(v) : v;
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

// ---------------------------------------------------------------------------
// bf16 mode: the weight gradients on the tensor cores.
//
// dW (K x J) = bf16(A) (K x n) . bf16(G)^T (n x J), db = sum of the f32 G,
// for every layer of a call in one launch. A job is one layer's block of at
// most 256 input rows and 64 output columns; the grid runs over (point
// chunk, job). A block owns its job's whole K x J in registers (a warp up to
// 32 x 64, 64 accumulators a thread), walks its chunk in 64-point tiles and
// writes its sums to its row of `partial`, which nkt_reduce_partials_kernel
// adds in block order. With ASYNC the tiles (A in bf16, G in f32, rows ld
// points apart, ld and the chunks multiples of 64 points) are copied by
// cp.async into a double buffer; otherwise (the classic engine: f32 A, rows
// n points apart) they are loaded, rounded and stored by the threads.
#define NKT_WG_TP 64        // points per tile
#define NKT_WG_LDA 36       // words per row of the bf16 A tile (64 + 8 pad)
#define NKT_WG_LDG 72       // words per row of the f32 G tile (64 + 8 pad)
#define NKT_WG_KC 256       // input rows of one job
#define NKT_WG_JC 64        // output columns of one job
#define NKT_WG_MAX_JOBS 32

struct WgJob {
  const void* A;   // the job's first input row: bf16 (ASYNC) or f32
  const float* G;  // the job's first cotangent row
  int Kc, Jc;      // rows of A and of G in the job
  int w_off;       // flat index of the job's dW[k0][j0]
  int J;           // the layer's output width, the row stride of its dW
  int b_off;       // flat index of db[j0]; -1: another job of these columns
};

struct WgPlan {
  WgJob job[NKT_WG_MAX_JOBS];
  int n_jobs;
  int total;        // floats in a row of partial
  int a_words;      // 32-bit words of one stage's A tile
  int g_words;      // 32-bit words of one stage's G tile
  long long n, ld;  // points; row stride of A and G
  long long chunk;  // points per block, a multiple of NKT_WG_TP
};

static bool wg_add_layer(WgPlan& p, const void* A, size_t a_bytes,
                         const float* G, int K, int J, int w_off, int b_off) {
  for (int k0 = 0; k0 < K; k0 += NKT_WG_KC) {
    for (int j0 = 0; j0 < J; j0 += NKT_WG_JC) {
      if (p.n_jobs >= NKT_WG_MAX_JOBS) return false;
      WgJob& jb = p.job[p.n_jobs++];
      jb.A = static_cast<const char*>(A) + (size_t)k0 * p.ld * a_bytes;
      jb.G = G + (long long)j0 * p.ld;
      jb.Kc = K - k0 < NKT_WG_KC ? K - k0 : NKT_WG_KC;
      jb.Jc = J - j0 < NKT_WG_JC ? J - j0 : NKT_WG_JC;
      jb.w_off = w_off + k0 * J + j0;
      jb.J = J;
      jb.b_off = k0 == 0 ? b_off + j0 : -1;
      const int aw = ((jb.Kc + 15) & ~15) * NKT_WG_LDA;
      const int gw = ((jb.Jc + 7) & ~7) * NKT_WG_LDG;
      if (aw > p.a_words) p.a_words = aw;
      if (gw > p.g_words) p.g_words = gw;
    }
  }
  return true;
}

template <bool ASYNC>
__global__ void __launch_bounds__(NKT_THREADS, 2)
    nkt_wgrad_mma_kernel(WgPlan plan, float* __restrict__ partial) {
  extern __shared__ __align__(16) unsigned char smem_mma[];
  const WgJob& jb = plan.job[blockIdx.y];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  uint32_t* As[2];
  float* Gs[2];
  As[0] = reinterpret_cast<uint32_t*>(smem_mma);
  Gs[0] = reinterpret_cast<float*>(As[0] + plan.a_words);
  As[1] = reinterpret_cast<uint32_t*>(Gs[0] + plan.g_words);
  Gs[1] = reinterpret_cast<float*>(As[1] + plan.a_words);
  for (int e = tid; e < 2 * (plan.a_words + plan.g_words); e += NKT_THREADS)
    reinterpret_cast<uint32_t*>(smem_mma)[e] = 0u;  // padding rows stay 0
  __syncthreads();

  // The warp's share of the job: mc m-tiles of 16 rows from m0, ncn
  // n-tiles of 8 columns from n0.
  const int Kc = jb.Kc, Jc = jb.Jc;
  const int mt = (Kc + 15) / 16, ntt = (Jc + 7) / 8;
  const int mc = mt > NKT_WARPS ? 2 : 1;
  const int gm = (mt + mc - 1) / mc;
  const int gn = NKT_WARPS / gm;
  const int ncn = (ntt + gn - 1) / gn;
  const int m0 = (warp % gm) * mc, n0 = (warp / gm) * ncn;
  const bool active = warp / gm < gn;
  const bool do_db = jb.b_off >= 0 && tid < Jc;

  float acc[2][NKT_MAX_NT][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int nt = 0; nt < NKT_MAX_NT; ++nt)
      acc[mi][nt][0] = acc[mi][nt][1] = acc[mi][nt][2] = acc[mi][nt][3] = 0.0f;
  float dbacc = 0.0f;

  const long long ld = plan.ld;
  const long long pb = (long long)blockIdx.x * plan.chunk;
  const long long pe = pb + plan.chunk < plan.n ? pb + plan.chunk : plan.n;

  auto load = [&](int s, long long p) {
    if (ASYNC) {
      const __nv_bfloat16* A = static_cast<const __nv_bfloat16*>(jb.A);
      for (int e = tid; e < Kc * 8; e += NKT_THREADS) {
        const int k = e >> 3, c = e & 7;
        const long long pp = p + c * 8, rem = pe - pp;
        const int bytes = rem >= 8 ? 16 : (rem > 0 ? (int)rem * 2 : 0);
        nkt_cp_async16(As[s] + k * NKT_WG_LDA + c * 4,
                       A + (long long)k * ld + (bytes ? pp : p), bytes);
      }
      for (int e = tid; e < Jc * 16; e += NKT_THREADS) {
        const int j = e >> 4, c = e & 15;
        const long long pp = p + c * 4, rem = pe - pp;
        const int bytes = rem >= 4 ? 16 : (rem > 0 ? (int)rem * 4 : 0);
        nkt_cp_async16(Gs[s] + j * NKT_WG_LDG + c * 4,
                       jb.G + (long long)j * ld + (bytes ? pp : p), bytes);
      }
      nkt_cp_commit();
    } else {
      const float* A = static_cast<const float*>(jb.A);
      __nv_bfloat16* Ab = reinterpret_cast<__nv_bfloat16*>(As[s]);
      for (int e = tid; e < Kc * NKT_WG_TP; e += NKT_THREADS) {
        const int k = e / NKT_WG_TP, q = e % NKT_WG_TP;
        const long long pp = p + q;
        Ab[k * 2 * NKT_WG_LDA + q] =
            __float2bfloat16_rn(pp < pe ? A[(long long)k * ld + pp] : 0.0f);
      }
      for (int e = tid; e < Jc * NKT_WG_TP; e += NKT_THREADS) {
        const int j = e / NKT_WG_TP, q = e % NKT_WG_TP;
        const long long pp = p + q;
        Gs[s][j * NKT_WG_LDG + q] = pp < pe ? jb.G[(long long)j * ld + pp] : 0.0f;
      }
    }
  };

  int s = 0;
  if (ASYNC && pb < pe) load(0, pb);
  for (long long p = pb; p < pe; p += NKT_WG_TP) {
    if (ASYNC) {
      if (p + NKT_WG_TP < pe) {
        load(s ^ 1, p + NKT_WG_TP);
        nkt_cp_wait<1>();
      } else {
        nkt_cp_wait<0>();
      }
    } else {
      load(s, p);
    }
    __syncthreads();
    if (active) {
#pragma unroll
      for (int ks = 0; ks < NKT_WG_TP / 16; ++ks) {
        uint32_t bfr[NKT_MAX_NT][2];
#pragma unroll
        for (int nt = 0; nt < NKT_MAX_NT; ++nt) {
          bfr[nt][0] = bfr[nt][1] = 0u;
          if (nt < ncn && n0 + nt < ntt) {
            const float* gr =
                Gs[s] + ((n0 + nt) * 8 + g) * NKT_WG_LDG + ks * 16 + 2 * t;
            const float2 f0 = *reinterpret_cast<const float2*>(gr);
            const float2 f1 = *reinterpret_cast<const float2*>(gr + 8);
            bfr[nt][0] = nkt_pack2(f0.x, f0.y);
            bfr[nt][1] = nkt_pack2(f1.x, f1.y);
          }
        }
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          if (mi < mc && m0 + mi < mt) {
            const uint32_t* ar =
                As[s] + ((m0 + mi) * 16 + g) * NKT_WG_LDA + ks * 8 + t;
            uint32_t af[4];
            af[0] = ar[0];
            af[1] = ar[8 * NKT_WG_LDA];
            af[2] = ar[4];
            af[3] = ar[8 * NKT_WG_LDA + 4];
#pragma unroll
            for (int nt = 0; nt < NKT_MAX_NT; ++nt)
              if (nt < ncn && n0 + nt < ntt)
                nkt_mma(acc[mi][nt], af, bfr[nt][0], bfr[nt][1]);
          }
        }
      }
    }
    if (do_db) {
      const float* gr = Gs[s] + tid * NKT_WG_LDG;
      for (int q = 0; q < NKT_WG_TP; ++q) dbacc += gr[q];
    }
    __syncthreads();
    if (ASYNC) s ^= 1;
  }

  float* mine = partial + (long long)blockIdx.x * plan.total;
  if (active) {
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
      for (int nt = 0; nt < NKT_MAX_NT; ++nt) {
        if (mi < mc && m0 + mi < mt && nt < ncn && n0 + nt < ntt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int k = (m0 + mi) * 16 + g + (e >> 1) * 8;
            const int j = (n0 + nt) * 8 + 2 * t + (e & 1);
            if (k < Kc && j < Jc) mine[jb.w_off + k * jb.J + j] = acc[mi][nt][e];
          }
        }
      }
    }
  }
  if (do_db) mine[jb.b_off + tid] = dbacc;
}

static size_t wg_smem(const WgPlan& p) {
  return (size_t)2 * (p.a_words + p.g_words) * sizeof(uint32_t);
}

// One launch over every job of the plan, `chunks` rows of partial sums.
template <bool ASYNC>
static int wg_launch(WgPlan& p, float* partial, int chunks, cudaStream_t st) {
  const long long tiles = (p.n + NKT_WG_TP - 1) / NKT_WG_TP;
  p.chunk = ((tiles + chunks - 1) / chunks) * NKT_WG_TP;
  const size_t bytes = wg_smem(p);
  cudaError_t err = cudaFuncSetAttribute(
      nkt_wgrad_mma_kernel<ASYNC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  nkt_wgrad_mma_kernel<ASYNC><<<dim3((unsigned)chunks, (unsigned)p.n_jobs),
                                NKT_THREADS, bytes, st>>>(p, partial);
  return (int)cudaGetLastError();
}

static WgPlan wg_plan(long long n, long long ld, int total) {
  WgPlan p;
  p.n_jobs = 0;
  p.total = total;
  p.a_words = p.g_words = 0;
  p.n = n;
  p.ld = ld;
  p.chunk = 0;
  return p;
}

static size_t wgrad_smem(int K, int J) {
  const int JP = 4 * ((J + 3) / 4) + 4;
  return (size_t)(nkt_as_floats(K) + 2 * NKT_TP * JP) * sizeof(float);
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

// One layer's weight gradient, dW = A G^T and db = sum of G over n points,
// as per-block partial sums into partial (blocks rows of `total` floats).
// Also called by the classic engine's gradient (csrc/classic_fused.cu).
extern "C" int nkt_wgrad_launch(const float* A, const float* G, long long n,
                                int K, int J, int bf, float* partial,
                                int total, int w_off, int b_off, int blocks,
                                void* stream) {
  if (bf) {  // the tensor cores, one job per 256 x 64 block of the layer
    WgPlan p = wg_plan(n, n, total);
    if (blocks < 1 || !wg_add_layer(p, A, sizeof(float), G, K, J, w_off, b_off))
      return (int)cudaErrorInvalidValue;
    return wg_launch<false>(p, partial, blocks, (cudaStream_t)stream);
  }
  if (K * ((J + 3) / 4) > NKT_MAX_Q * NKT_THREADS)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const size_t bytes = wgrad_smem(K, J);
  const int J4 = (J + 3) / 4;
  if (NKT_THREADS % J4 == 0) {
    NKT_CHECK(cudaFuncSetAttribute(nkt_wgrad_kernel<true>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)bytes));
    nkt_wgrad_kernel<true><<<blocks, NKT_THREADS, bytes, st>>>(
        A, G, n, K, J, bf, partial, total, w_off, b_off);
  } else {
    NKT_CHECK(cudaFuncSetAttribute(nkt_wgrad_kernel<false>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)bytes));
    nkt_wgrad_kernel<false><<<blocks, NKT_THREADS, bytes, st>>>(
        A, G, n, K, J, bf, partial, total, w_off, b_off);
  }
  return (int)cudaGetLastError();
}

// flat = the sum of the first `blocks` rows of partial, in row order.
extern "C" int nkt_reduce_partials_launch(const float* partial, float* flat,
                                          int total, int blocks,
                                          void* stream) {
  nkt_reduce_partials_kernel<<<(total + 255) / 256, 256, 0,
                               (cudaStream_t)stream>>>(partial, flat, total,
                                                       blocks);
  return (int)cudaGetLastError();
}

extern "C" int nkt_dlines_launch(const float* x, long long xs_i, long long xs_a,
                                 const float* lines, const float* g,
                                 long long gs_i, float* partial, float* dlines,
                                 long long n, const CPLevels* cp, int dup,
                                 int chunks, void* stream);

// 3b. the line tables' gradient from denc, in a fixed order (row 5's kernel),
// with the fused kernels' operand rows for non-finite values
static int launch_dlines(const BwdArgs& b, cudaStream_t st) {
  const FusedArgs& a = b.f;
  return nkt_dlines_launch(a.xt, 1, a.n, a.lines, b.denc,
                           (long long)a.cp.n_levels * a.cp.n_comp, b.lpart,
                           b.dlines, a.n, &a.cp, 1, b.l_chunks, st);
}

static int launch_wgrad(const float* A, const float* G, int K, int J,
                        const BwdArgs& b, const SaveRows& rows, int w_off,
                        int b_off, int blocks, cudaStream_t st) {
  return nkt_wgrad_launch(A, G, b.f.n, K, J, b.f.cp.use_bf16, b.partial,
                          rows.total, w_off, b_off, blocks, st);
}

// Steps 1-5 in bf16 mode.
static int run_backward_mma(const BwdArgs& b, bool train, int n_sm,
                            cudaStream_t st) {
  const FusedArgs& a = b.f;
  if (!mma_dims_ok(a, true) || b.ld % NKT_WG_TP || b.ld < a.n)
    return (int)cudaErrorInvalidValue;
  const SaveRows rows = make_rows(a);
  const long long tiles = (a.n + NKT_MT - 1) / NKT_MT;

  // 1. forward, saving the layers' inputs in bf16
  const MmaLayout lf = make_mma_layout_fwd(a, true);
  NKT_CHECK(cudaFuncSetAttribute(nkt_mma_apply_save_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 lf.total));
  long long want = (tiles + lf.warps - 1) / lf.warps;
  if (want > a.enc_slots / lf.warps) want = a.enc_slots / lf.warps;
  if (want < 1) return (int)cudaErrorInvalidValue;
  long long blocks = persistent_blocks(nkt_mma_apply_save_kernel, lf.warps * 32,
                                       lf.total, want, n_sm);
  nkt_mma_apply_save_kernel<<<(unsigned)blocks, lf.warps * 32, lf.total, st>>>(
      a, lf, rows, static_cast<__nv_bfloat16*>(b.act), b.z0, b.ld);
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
  const MmaLayout lb = make_mma_layout_bwd(a);
  NKT_CHECK(cudaFuncSetAttribute(nkt_mma_point_bwd_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 lb.total));
  blocks = persistent_blocks(nkt_mma_point_bwd_kernel, lb.warps * 32, lb.total,
                             (tiles + lb.warps - 1) / lb.warps, n_sm);
  nkt_mma_point_bwd_kernel<<<(unsigned)blocks, lb.warps * 32, lb.total, st>>>(
      bb, lb, rows);
  NKT_CHECK(cudaGetLastError());
  int rc = launch_dlines(b, st);
  if (rc) return rc;

  // 4. weight gradients of every layer in one launch
  WgPlan p = wg_plan(a.n, b.ld, rows.total);
  const __nv_bfloat16* act = static_cast<const __nv_bfloat16*>(b.act);
  for (int li = 0; li < a.nd; ++li)
    if (!wg_add_layer(p, act + (long long)rows.d_row[li] * b.ld, 2,
                      b.gs + (long long)rows.dg_row[li] * b.ld, a.d_in[li],
                      a.d_out[li], rows.dw_off[li], rows.db_off[li]))
      return (int)cudaErrorInvalidValue;
  for (int li = 0; li < a.nc; ++li)
    if (!wg_add_layer(p, act + (long long)rows.c_row[li] * b.ld, 2,
                      b.gs + (long long)rows.cg_row[li] * b.ld, a.c_in[li],
                      a.c_out[li], rows.cw_off[li], rows.cb_off[li]))
      return (int)cudaErrorInvalidValue;
  const long long wt = (a.n + NKT_WG_TP - 1) / NKT_WG_TP;
  const int chunks = (int)(wt < b.n_part ? wt : b.n_part);
  rc = wg_launch<true>(p, b.partial, chunks, st);
  if (rc) return rc;

  // 5. the sum over blocks
  return nkt_reduce_partials_launch(b.partial, b.flat, rows.total, chunks, st);
}

static int run_backward(const BwdArgs& b, bool train, int n_sm,
                        cudaStream_t st) {
  const FusedArgs& a = b.f;
  if (b.n_part < 1) return (int)cudaErrorInvalidValue;
  if (train && (b.S < 1 || a.n % b.S)) return (int)cudaErrorInvalidValue;
  // also the scan of the row-5 launch below (launch_dlines), which reads
  // its flags and writes its record in the same a.cp.nonfinite
  const cudaError_t scan = nkt_table_scan(a.lines, a.cp, true, st);
  if (scan != cudaSuccess) return (int)scan;
  if (a.cp.use_bf16) return run_backward_mma(b, train, n_sm, st);
  if (!dims_ok(a) || b.ld != a.n) return (int)cudaErrorInvalidValue;
  const SaveRows rows = make_rows(a);
  long long blocks = (a.n + NKT_THREADS - 1) / NKT_THREADS;
  if (blocks > n_sm) blocks = n_sm;
  float* act = static_cast<float*>(b.act);

  // 1. forward, saving the layers' inputs
  const FusedLayout lay_f = make_layout(a, true);
  const size_t bytes_f = (size_t)lay_f.total * sizeof(float);
  NKT_CHECK(cudaFuncSetAttribute(nkt_fused_apply_save_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)bytes_f));
  nkt_fused_apply_save_kernel<<<(unsigned)blocks, NKT_THREADS, bytes_f, st>>>(
      a, lay_f, rows, act, b.z0);
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
  const int rcl = launch_dlines(b, st);
  if (rcl) return rcl;

  // 4. weight gradients, per-block partial sums
  const long long tiles = (a.n + NKT_TP - 1) / NKT_TP;
  const int wblocks = (int)(tiles < b.n_part ? tiles : b.n_part);
  for (int li = 0; li < a.nd; ++li) {
    const int rc = launch_wgrad(act + (long long)rows.d_row[li] * a.n,
                                b.gs + (long long)rows.dg_row[li] * a.n,
                                a.d_in[li], a.d_out[li], b, rows,
                                rows.dw_off[li], rows.db_off[li], wblocks, st);
    if (rc) return rc;
  }
  for (int li = 0; li < a.nc; ++li) {
    const int rc = launch_wgrad(act + (long long)rows.c_row[li] * a.n,
                                b.gs + (long long)rows.cg_row[li] * a.n,
                                a.c_in[li], a.c_out[li], b, rows,
                                rows.cw_off[li], rows.cb_off[li], wblocks, st);
    if (rc) return rc;
  }

  // 5. the sum over blocks
  return nkt_reduce_partials_launch(b.partial, b.flat, rows.total, wblocks, st);
}

// The scratch of a call over args->n points: out[0] = rows of act, out[1] =
// rows of gs, out[2] = floats of the flat MLP gradient, out[3] = bytes of
// shared memory of the largest kernel, out[4] = ld, the row stride of act
// and gs in points (n in f32 mode; n rounded up to a multiple of 64 in bf16
// mode, so that every 64-point tile of a row starts 128-byte aligned),
// out[5] = bytes of an act entry (2: bf16 mode, 4: f32 mode). z0 has ld
// floats.
extern "C" void nkt_fused_bwd_sizes(const FusedArgs* args, long long* out) {
  const SaveRows rows = make_rows(*args);
  out[0] = rows.act_rows;
  out[1] = rows.gs_rows;
  out[2] = rows.total;
  const bool bf = args->cp.use_bf16 != 0;
  if (bf) {
    const long long f = make_mma_layout_fwd(*args, true).total;
    const long long bw = make_mma_layout_bwd(*args).total;
    const long long wg = (long long)2 * (NKT_WG_KC * NKT_WG_LDA + NKT_WG_JC * NKT_WG_LDG) *
                         (long long)sizeof(uint32_t);
    long long m = f > bw ? f : bw;
    out[3] = m > wg ? m : wg;
    out[4] = (args->n + NKT_WG_TP - 1) / NKT_WG_TP * NKT_WG_TP;
    out[5] = 2;
  } else {
    const long long f = make_layout(*args, true).total;
    const long long bw = make_layout(*args, true, NKT_W * NKT_HS).total;
    out[3] = (f > bw ? f : bw) * (long long)sizeof(float);
    out[4] = args->n;
    out[5] = 4;
  }
}

// The VJP of the fused forward: b->g is the (4, n) cotangent.
extern "C" int nkt_fused_backward(const BwdArgs* b, int n_sm, void* stream) {
  return run_backward(*b, false, n_sm, (cudaStream_t)stream);
}

// The fused fine train objective: forward, compositing, loss and backward.
extern "C" int nkt_fused_train(const BwdArgs* b, int n_sm, void* stream) {
  return run_backward(*b, true, n_sm, (cudaStream_t)stream);
}
