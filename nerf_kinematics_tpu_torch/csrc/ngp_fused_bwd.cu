// Fused NGP point pipeline, the gradient kernels.
//
// Replaces the TPU kernels of nerf_kinematics_tpu/ops/ngp_fused_pallas.py:
//   ngp_fused_apply_cf VJP (_bwd_kernel, _fused_bwd_cf) -> nkt_fused_backward
//   ngp_fused_train_cf (_train_kernel, _fine_stage)     -> nkt_fused_train
//
// The TPU kernels recompute the forward, keep a block's activations and
// cotangents in VMEM and add every block's parameter gradients into one
// resident accumulator across sequential grid steps.
//
// bf16 mode (the shipped configs): one persistent kernel a call,
// nkt_fused_tile_kernel, that keeps a tile's work on chip as the TPU kernel
// keeps it in VMEM. A block (8 warps, one an SM) walks a static schedule of
// tiles (block b takes tiles b, b + grid, ...), so every sum runs in a fixed
// order and two launches give the same bits; no atomics. A tile is P points
// (the VJP) or whole rays of S samples (the train objective: the compositing
// needs every sample of a ray), P a multiple of 16 that the plan (make_plan,
// ops/ngp_fused_cuda.py::bwd_plan) fits into shared memory beside the
// weights. Per tile, every product on the tensor cores (mma.sync.m16n8k16,
// bf16 operands, f32 sums; a warp takes one 8-column n-tile of a layer over
// all the tile's points):
//   1. forward with nkt_mma.cuh's arithmetic: the encoder gathers a level's
//      bf16 features into a level tile (and the block's slot of FusedArgs.enc,
//      from which layer 0's finish sums a value near a bf16 midpoint again),
//      each layer's rounded input stays in shared memory (bf16-rounded
//      already, so this is exact), feature 0 of the last density layer is
//      summed in the plain version's order for every point.
//   2. (train) compositing of each ray inside the block, in
//      nkt_train_rays_kernel's order of operations: the sigmoids and alphas
//      point by point over the block's threads, then one lane a ray (the rays
//      spread over the warps) for the forward sums, the squared error and the
//      division-free reverse recurrence. (VJP) the (4, n) cotangent.
//   3. backward, layer by layer with the cotangent in shared memory: the
//      masked f32 g feeds db, is rounded to bf16 once for d_inp = W g (W read
//      transposed from the forward blocks); sigma's cotangent enters feature
//      row 0 where -15 < z0 < 15; d_enc goes to BwdArgs.denc in f32.
//   4. weight gradients on chip across the block's tiles: layer 0's dW (the
//      widest, K0 x 64) in registers, a warp an 8-column n-tile, summed on
//      the tensor cores over the points with the level's inputs read back
//      from the slot (by cp.async, a level ahead of the products); every
//      other layer's dW as f32 fragment sums in shared memory (each tile's
//      fragment from zero, then an IEEE add); db in shared memory. One
//      partial row a block at the end. Layer 0's dW on wgmma (the points as
//      K, G^T from registers, the level tile from shared memory, the sums in
//      the warpgroups' registers) was slower on the card in every form
//      tried: scripts/torch_ablate_tile.py keeps them as variants.
// Then row 5's kernel (csrc/cp_encode.cu) takes denc to the line tables'
// gradient and nkt_reduce_partials_kernel adds the partial rows in block
// order.
// A fine ray longer than a tile (S > P) cannot be composited inside a block:
// the train objective then runs as three launches on the caller's stream,
// (i) the tile kernel's forward alone (tiles of P points) to the (4, n)
// rgb logits and sigma, (ii) nkt_train_rays_kernel (one thread a ray, the
// same arithmetic as step 2 below) to err, maps and the (4, n) cotangent,
// (iii) the tile kernel as the VJP of that cotangent; then row 5 and the
// partial sums as above. (i) and (iii) run the same forward code on the
// same tiles, so the cotangent belongs to the forward the VJP recomputes,
// bit for bit.
//
// Bound on this card: operations, about 190 kFLOP of products a point
// (three times the forward's), 75 GFLOP at 8192 x 48 points, 0.08 ms at the
// bf16 tensor-core rate. The sequence of kernels this replaces moved about
// 3 GB a call through device memory (every layer's activations and masked
// cotangents written and read twice); what is left there is the inputs,
// denc (written once in f32 and read by row 5's kernel), the slots of the
// encoding (written and read once a tile, L2-resident), the partial rows.
//
// f32 mode keeps the FMA kernels (simple and right first), a sequence on the
// caller's stream with the per-point intermediates in device scratch (rows
// ld = n points apart):
//   1. nkt_fused_apply_save_kernel: the forward body of ngp_fused.cuh, which
//      also writes every layer's input to `act` and the f32 feature 0 to `z0`.
//   2. (train only) nkt_train_rays_kernel: one thread per ray composites its
//      S samples (transmittance T * (1 - alpha + 1e-10), optional white
//      background), takes the squared error against the target and runs the
//      division-free reverse recurrence
//          d alpha_s = (dw_s - dT) * T_s
//          dT       <- dw_s * alpha_s + dT * (1 - alpha_s + 1e-10)
//      to the (4, N) cotangent of (rgb logits, sigma).
//   3. nkt_fused_point_bwd_kernel: one thread per point, the layers
//      backwards; the masked cotangent of each layer to `gs`; for the
//      encoder the point's d_enc values pass through shared memory one level
//      at a time to `denc`.
//   3b. row 5's kernel, as in bf16 mode.
//   4. nkt_wgrad_kernel once per layer (32 points per tile in shared memory,
//      each thread owns up to 16 groups of four (in, out) entries in
//      registers across its tiles), per-block partial sums.
//   5. nkt_reduce_partials_kernel: adds the partial sums in block order.
#include "nkt_mma.cuh"

#define NKT_TP 32      // points per tile of the weight-gradient kernel
#define NKT_AS 33      // row stride of its input tile (no bank conflicts)
#define NKT_MAX_Q 16   // groups of four entries one thread may own there

__global__ void __launch_bounds__(NKT_THREADS, 1)
    nkt_fused_apply_save_kernel(FusedArgs a, FusedLayout lay, SaveRows rows,
                                float* act, float* z0s) {
  nkt_fused_body<true, true>(a, lay, rows, act, z0s);
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

  nkt_stage_slice(a, lay, 0, smem + lay.w_off[0]);
  nkt_stage_weights(a, lay, a.nd + a.nc, bf, smem);
  nkt_slice_ready(lay, bf, smem + lay.w_off[0]);

  // The thread's column, stride NKT_HS: a warp only ever touches its own 32
  // columns, so only W0's slices (nkt_level_weights) need block-wide
  // barriers, and every thread runs every batch.
  float* hs = smem + lay.hs_off + tid;
  const int C = a.cp.n_comp;
  const long long n = a.n;
  long long gsl = 0;  // W0's slices this block has used

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

    // ---- encoder: d_enc = W0 g one level at a time (at most NKT_W
    // channels at once through the columns), to denc ---------------------
    const long long LC = (long long)a.cp.n_levels * C;
    for (int l = 0; l < a.cp.n_levels; ++l, ++gsl) {
      const float* sw0 = nkt_level_weights(a, lay, l, gsl, bf, smem);
      for (int c0 = 0; c0 < C; c0 += NKT_W) {
        const int cw = C - c0 < NKT_W ? C - c0 : NKT_W;
        nkt_dense_t_any(sw0 + c0 * NKT_W, g, cw, a.d_out[0], hs);
        __syncwarp();
        for (int pp = 0; pp < 32; ++pp) {
          const long long ip = base + warp0 + pp;
          if (ip >= n) break;  // the same for the whole warp
          const float* col = smem + lay.hs_off + warp0 + pp;
          for (int c = lane; c < cw; c += 32)
            b.denc[ip * LC + l * C + c0 + c] = col[c * NKT_HS];
        }
        __syncwarp();
      }
    }
  }
  nkt_cp_wait<0>();  // the last prefetch
}

// partial[w_off + k * J + j] = sum over the block's tiles of bf16(A[k][p]) *
// bf16(G[j][p]) (no rounding when bf is 0); partial[b_off + j] = sum of
// G[j][p] (b_off < 0: no bias). A: (K, n) layer input (the NGP kernels save it rounded already,
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
  if (tid < J && b_off >= 0) mine[b_off + tid] = dbacc;
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
// The weight gradients of one f32 layer on the tensor cores, for the classic
// engine's bf16 mode (nkt_wgrad_launch with bf = 1).
//
// dW (K x J) = bf16(A) (K x n) . bf16(G)^T (n x J), db = sum of the f32 G.
// A job is one layer's block of at most 256 input rows and 64 output
// columns; the grid runs over (point chunk, job). A block owns its job's
// whole K x J in registers (a warp up to 32 x 64, 64 accumulators a thread),
// walks its chunk in 64-point tiles (A rounded to bf16 and G in f32, loaded
// by the threads, rows n points apart) and writes its sums to its row of
// `partial`, which nkt_reduce_partials_kernel adds in block order.
#define NKT_WG_TP 64        // points per tile
#define NKT_WG_LDA 36       // words per row of the bf16 A tile (64 + 8 pad)
#define NKT_WG_LDG 72       // words per row of the f32 G tile (64 + 8 pad)
#define NKT_WG_KC 256       // input rows of one job
#define NKT_WG_JC 64        // output columns of one job
#define NKT_WG_MAX_JOBS 32

struct WgJob {
  const float* A;  // the job's first input row
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
  int a_words;      // 32-bit words of the A tile
  int g_words;      // 32-bit words of the G tile
  long long n;      // points, the row stride of A and G
  long long chunk;  // points per block, a multiple of NKT_WG_TP
};

static bool wg_add_layer(WgPlan& p, const float* A, const float* G, int K,
                         int J, int w_off, int b_off) {
  for (int k0 = 0; k0 < K; k0 += NKT_WG_KC) {
    for (int j0 = 0; j0 < J; j0 += NKT_WG_JC) {
      if (p.n_jobs >= NKT_WG_MAX_JOBS) return false;
      WgJob& jb = p.job[p.n_jobs++];
      jb.A = A + (long long)k0 * p.n;
      jb.G = G + (long long)j0 * p.n;
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

__global__ void __launch_bounds__(NKT_THREADS, 2)
    nkt_wgrad_mma_kernel(WgPlan plan, float* __restrict__ partial) {
  extern __shared__ __align__(16) unsigned char smem_mma[];
  const WgJob& jb = plan.job[blockIdx.y];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  uint32_t* As = reinterpret_cast<uint32_t*>(smem_mma);
  float* Gs = reinterpret_cast<float*>(As + plan.a_words);
  for (int e = tid; e < plan.a_words + plan.g_words; e += NKT_THREADS)
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

  const long long ld = plan.n;
  const long long pb = (long long)blockIdx.x * plan.chunk;
  const long long pe = pb + plan.chunk < plan.n ? pb + plan.chunk : plan.n;

  for (long long p = pb; p < pe; p += NKT_WG_TP) {
    __nv_bfloat16* Ab = reinterpret_cast<__nv_bfloat16*>(As);
    for (int e = tid; e < Kc * NKT_WG_TP; e += NKT_THREADS) {
      const int k = e / NKT_WG_TP, q = e % NKT_WG_TP;
      const long long pp = p + q;
      Ab[k * 2 * NKT_WG_LDA + q] =
          __float2bfloat16_rn(pp < pe ? jb.A[(long long)k * ld + pp] : 0.0f);
    }
    for (int e = tid; e < Jc * NKT_WG_TP; e += NKT_THREADS) {
      const int j = e / NKT_WG_TP, q = e % NKT_WG_TP;
      const long long pp = p + q;
      Gs[j * NKT_WG_LDG + q] = pp < pe ? jb.G[(long long)j * ld + pp] : 0.0f;
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
                Gs + ((n0 + nt) * 8 + g) * NKT_WG_LDG + ks * 16 + 2 * t;
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
                As + ((m0 + mi) * 16 + g) * NKT_WG_LDA + ks * 8 + t;
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
      const float* gr = Gs + tid * NKT_WG_LDG;
      for (int q = 0; q < NKT_WG_TP; ++q) dbacc += gr[q];
    }
    __syncthreads();
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

// ---------------------------------------------------------------------------
// bf16 mode: the persistent tile kernel (see the note at the top).

#define NKB_WARPS 8
#define NKB_THREADS (NKB_WARPS * 32)
#define NKB_MAX_MT 8   // m-tiles of 16 points a tile holds at most (128 points)
#define NKB_WIDE_MT 4  // the same where layer 0's dW takes more than 16 m-tiles
#define NKB_GLD 72     // bf16 elements a row of the cotangent tile (64 + 8)
#define NKB_F32 10     // f32 values a point: 4 outputs, 4 cotangents, z0, T

// The block's plan; ops/ngp_fused_cuda.py::bwd_plan computes the same
// numbers, and the wrapper compares them with nkt_fused_bwd_plan's at every
// call. Shared memory: the forward blocks of every layer's packed weights
// (read as they are by the forward and transposed by the backward), the f32
// biases, the f32 sums, then the tile: a point's rows of every layer's input
// (layer 1's last; the two level tiles of the encoder overlay the others),
// of the bf16 cotangent (the forward's taps overlay it), and of f32 values.
// Each part of the tile is P rows of its own width, so it starts at P times
// the bytes a point before it.
struct BwdPlan {
  int P;           // points a tile holds, a multiple of 16
  int rays;        // train: whole rays a tile (P / S); VJP and rays
                   // longer than a tile: 0
  int tile_pts;    // points of a full tile: rays * S, or P
  int mt0;         // m-tiles of layer 0's dW a warp holds in registers,
                   // K0 / 16 rounded up
  int bias_off;    // bytes: f32 biases, NKT_W a layer
  int acc_off;     // bytes: f32 sums of dW (layers 1..) and of every db
  int tile_off;    // bytes: the tile
  int total;       // bytes of shared memory
  int acc_floats;  // floats of the sums
  int db_off;      // floats from acc_off: layer L's db at db_off + L * NKT_W
  int frag_off[2 * NKT_MAX_LAYERS];  // floats from acc_off: layer L's dW
  int x_at[2 * NKT_MAX_LAYERS];  // bytes a point before layer L's input (L >= 1)
  int x_ld[2 * NKT_MAX_LAYERS];  // bf16 elements a row of it
  int e_ld;        // bf16 elements a row of a level tile (at byte 0)
  int g_at;        // bytes a point before the cotangent tile
  int f_at;        // bytes a point before the f32 values
  int per_point;   // bytes of the tile a point
};

__host__ __device__ __forceinline__ int nkb_K(const FusedArgs& a, int L) {
  return L < a.nd ? a.d_in[L] : a.c_in[L - a.nd];
}
__host__ __device__ __forceinline__ int nkb_J(const FusedArgs& a, int L) {
  return L < a.nd ? a.d_out[L] : a.c_out[L - a.nd];
}

// S = 0: the VJP; S > P: the VJP's tiles (a ray longer than a tile). False
// where the layers do not fit.
static bool make_plan(const FusedArgs& a, int S, BwdPlan& p) {
  const int nl = a.nd + a.nc;
  const int C = a.cp.n_comp, K0 = a.cp.n_levels * C;
  if (a.nd < 1 || a.nc < 1 || nl > 2 * NKT_MAX_LAYERS || a.d_in[0] != K0 ||
      a.d_out[0] % 8 || a.c_out[a.nc - 1] != 3)
    return false;
  for (int L = 1; L < nl; ++L)
    if (nkb_K(a, L) % 16) return false;
  p.mt0 = (K0 + 15) / 16;
  if (p.mt0 > 32) return false;
  p.bias_off = a.pk_fwd * 2;
  p.acc_off = p.bias_off + nl * NKT_W * 4;
  int f = 0;
  p.frag_off[0] = 0;
  for (int L = 1; L < nl; ++L) {
    p.frag_off[L] = f;
    f += nkb_K(a, L) / 16 * ((nkb_J(a, L) + 7) / 8) * 128;
  }
  p.db_off = f;
  f += nl * NKT_W;
  p.acc_floats = f;
  p.tile_off = p.acc_off + f * 4;
  int x = 0;
  p.x_at[0] = p.x_ld[0] = 0;
  for (int L = 2; L < nl; ++L) {
    p.x_at[L] = x;
    p.x_ld[L] = nkb_K(a, L) + 8;
    x += 2 * p.x_ld[L];
  }
  p.e_ld = C + 8;
  if (x < 4 * p.e_ld) x = 4 * p.e_ld;
  p.x_at[1] = x;
  p.x_ld[1] = nkb_K(a, 1) + 8;
  x += 2 * p.x_ld[1];
  p.g_at = x;
  x += 2 * NKB_GLD;
  p.f_at = x;
  x += NKB_F32 * 4;
  p.per_point = x;
  int P = (NKT_SMEM_MAX - p.tile_off) / x / 16 * 16;
  const int max_mt = p.mt0 > 16 ? NKB_WIDE_MT : NKB_MAX_MT;
  if (P > max_mt * 16) P = max_mt * 16;
  if (P < 16) return false;
  p.P = P;
  p.total = p.tile_off + P * x;
  // a ray longer than a tile: the VJP's tiles (run_backward_tile)
  p.rays = S > 0 ? P / S : 0;
  p.tile_pts = p.rays > 0 ? p.rays * S : P;
  return true;
}

// MPM (template): m-tiles of 16 points the arrays below hold, at least the
// tile's MP. acc[mt] += X (rows of 16 points, ldx words a row) times the
// n-tile nt of the forward block W (a row per output column, ldw words), KT
// k-steps: each k-step's 16 products from zero, added with IEEE adds
// (nkt_mma_add).
template <int MPM>
__device__ __forceinline__ void nkb_fwd_product(float (*acc)[4], int MP,
                                                const uint32_t* X, int ldx,
                                                const uint32_t* W, int ldw,
                                                int nt, int KT, int lane) {
  const uint32_t* xr = X + (lane & 15) * ldx + (lane >> 4) * 4;
  const uint32_t* wr = W + (nt * 8 + (lane & 7)) * ldw + ((lane >> 3) & 1) * 4;
  for (int ks = 0; ks < KT; ++ks) {
    uint32_t bq[2];
    nkt_ldm2(bq, wr + ks * 8);
#pragma unroll
    for (int mt = 0; mt < MPM; ++mt) {
      if (mt < MP) {
        uint32_t af[4];
        nkt_ldm4(af, xr + mt * 16 * ldx + ks * 8);
        nkt_mma_add(acc[mt], af, bq[0], bq[1]);
      }
    }
  }
}

// acc[mt] = G (the cotangent tile) times W^T on the n-tile nt of the
// layer's inputs (MPM: as nkb_fwd_product): the forward block W (a row per output, ldw elements) read
// transposed, k-steps over the J outputs. A block of at most 8 rows (the
// last layer) has no second half: lanes 8-15 read past it, and that half
// of the operand is set to zero.
template <int MPM>
__device__ __forceinline__ void nkb_bwd_product(float (*acc)[4], int MP,
                                                const __nv_bfloat16* G,
                                                const __nv_bfloat16* W,
                                                int ldw, int nt, int J,
                                                int lane) {
#pragma unroll
  for (int mt = 0; mt < MPM; ++mt)
    acc[mt][0] = acc[mt][1] = acc[mt][2] = acc[mt][3] = 0.0f;
  const __nv_bfloat16* gr = G + (lane & 15) * NKB_GLD + (lane >> 4) * 8;
  const __nv_bfloat16* wr = W + (lane & 15) * ldw + nt * 8;
  const int KT = (J + 15) / 16;
  for (int ks = 0; ks < KT; ++ks) {
    uint32_t bq[2];
    nkt_ldm2t(bq, wr + ks * 16 * ldw);
    if (J - ks * 16 <= 8) bq[1] = 0u;
#pragma unroll
    for (int mt = 0; mt < MPM; ++mt) {
      if (mt < MP) {
        uint32_t af[4];
        nkt_ldm4(af, reinterpret_cast<const uint32_t*>(gr + mt * 16 * NKB_GLD + ks * 16));
        nkt_mma_add(acc[mt], af, bq[0], bq[1]);
      }
    }
  }
}

// c = X^T G on one fragment of a layer's dW: input rows [16 mi, +16) (X:
// the tile's inputs, ldx elements a row), output columns [8 ni, +8) (G: the
// cotangent tile), summed on the tensor cores over the MP m-tiles of points.
template <int MPM>
__device__ __forceinline__ void nkb_wgrad_frag(float* c, int MP,
                                               const __nv_bfloat16* X, int ldx,
                                               int mi, const __nv_bfloat16* G,
                                               int ni, int lane) {
  c[0] = c[1] = c[2] = c[3] = 0.0f;
  const __nv_bfloat16* xr = X + ((lane & 7) + ((lane >> 4) << 3)) * ldx +
                            mi * 16 + ((lane >> 3) & 1) * 8;
  const __nv_bfloat16* gr = G + (lane & 15) * NKB_GLD + ni * 8;
#pragma unroll
  for (int mt = 0; mt < MPM; ++mt) {
    if (mt < MP) {
      uint32_t af[4], bq[2];
      nkt_ldm4t(af, xr + mt * 16 * ldx);
      nkt_ldm2t(bq, gr + mt * 16 * NKB_GLD);
      nkt_mma(c, af, bq[0], bq[1]);
    }
  }
}

// A forward layer's finish on the warp's n-tile nt: z = acc + bias (f32,
// after the sum), ReLU when relu, rounded to bf16 into the same columns of
// Y (ldy elements a row); rows past np become 0. A value within NKT_NEAR
// ulps of a bf16 rounding midpoint is summed again in the plain version's
// order (nkt_chain over row p of the layer's input X, ldx elements a row, K
// wide, and row j of Wt, ldw elements a row), so that it rounds as there:
// the lanes gather their flagged (row, column) pairs into the warp's list
// (cap entries; past it a lane sums its own) and take one each, as
// nkt_mma_finish does. Ends with the warp synchronised.
template <int MPM>
__device__ __forceinline__ void nkb_finish(float (*acc)[4], int MP, int np,
                                           int nt, const float* bias, bool relu,
                                           __nv_bfloat16* Y, int ldy,
                                           const __nv_bfloat16* X, int ldx,
                                           int K, const __nv_bfloat16* Wt,
                                           int ldw, unsigned short* list,
                                           int cap, int lane, int g, int t) {
  const int j = nt * 8 + 2 * t;
  const float b0 = bias[j], b1 = bias[j + 1];
  unsigned redo = 0u;  // bit mt * 4 + h * 2 + q: row mt * 16 + g + 8 h, column j + q
#pragma unroll
  for (int mt = 0; mt < MPM; ++mt) {
    if (mt < MP) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = mt * 16 + g + h * 8;
        float z0 = acc[mt][2 * h] + b0, z1 = acc[mt][2 * h + 1] + b1;
        if (relu) {
          z0 = nkt_relu(z0);
          z1 = nkt_relu(z1);
        }
        if (p < np) {
          if (nkt_near_midpoint(z0)) redo |= 1u << (mt * 4 + h * 2);
          if (nkt_near_midpoint(z1)) redo |= 1u << (mt * 4 + h * 2 + 1);
        } else {
          z0 = z1 = 0.0f;
        }
        *reinterpret_cast<uint32_t*>(Y + p * ldy + j) = nkt_pack2(z0, z1);
      }
    }
  }
  // exclusive prefix sum of the lanes' counts: each lane's place in the list
  const int cnt = __popc(redo);
  int incl = cnt;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += v;
  }
  const int total = __shfl_sync(0xffffffffu, incl, 31);
  int at = incl - cnt;
  while (redo) {
    const int i = __ffs(redo) - 1;
    redo &= redo - 1u;
    const int p = (i >> 2) * 16 + g + ((i >> 1) & 1) * 8, col = j + (i & 1);
    if (at < cap) {
      list[at] = (unsigned short)(p * NKT_W + col);
    } else {  // more than the list holds: the lane sums its own
      float z = nkt_chain<4>(X + p * ldx, Wt + col * ldw, K) + bias[col];
      if (relu) z = nkt_relu(z);
      Y[p * ldy + col] = __float2bfloat16_rn(z);
    }
    ++at;
  }
  __syncwarp();
  for (int it = lane; it < min(total, cap); it += 32) {
    const int p = list[it] / NKT_W, col = list[it] % NKT_W;
    float z = nkt_chain<4>(X + p * ldx, Wt + col * ldw, K) + bias[col];
    if (relu) z = nkt_relu(z);
    Y[p * ldy + col] = __float2bfloat16_rn(z);
  }
  __syncwarp();
}

// One ray's compositing, squared error and reverse recurrence, in
// nkt_train_rays_kernel's order of operations. o: the ray's first point's
// (sigmoid of the three logits, alpha); G4: its (_, _, _, interval), which
// the reverse pass overwrites with the cotangent of (rgb logits, sigma); TS:
// T a point; rg: the ray's index in the launch.
__device__ __forceinline__ void nkb_ray(const BwdArgs& b, const float* o,
                                        float* G4, float* TS, long long rg,
                                        long long n_rays) {
  const int S = b.S;
  float T = 1.0f, m0 = 0.0f, m1 = 0.0f, m2 = 0.0f, acc = 0.0f;
#pragma unroll 4
  for (int s = 0; s < S; ++s) {
    const float* q = o + 4 * s;
    const float alpha = q[3];
    const float w = alpha * T;
    m0 = m0 + w * q[0];
    m1 = m1 + w * q[1];
    m2 = m2 + w * q[2];
    acc = acc + w;
    TS[s] = T;
    T = T * (1.0f - alpha + 1e-10f);
  }
  if (b.white_bg) {
    m0 = m0 + (1.0f - acc);
    m1 = m1 + (1.0f - acc);
    m2 = m2 + (1.0f - acc);
  }
  const float d0 = m0 - b.tgt[rg];
  const float d1 = m1 - b.tgt[n_rays + rg];
  const float d2 = m2 - b.tgt[2 * n_rays + rg];
  b.err[rg] = (d0 * d0 + d1 * d1) + d2 * d2;
  b.maps[rg] = m0;
  b.maps[n_rays + rg] = m1;
  b.maps[2 * n_rays + rg] = m2;
  b.maps[3 * n_rays + rg] = acc;
  const float k = 2.0f * b.inv_denom;
  const float g0 = k * d0, g1 = k * d1, g2 = k * d2;
  const float gsum = (g0 + g1) + g2;
  float dT = 0.0f;
#pragma unroll 4
  for (int s = S - 1; s >= 0; --s) {
    const float* q = o + 4 * s;
    float* gp = G4 + 4 * s;
    const float dist = gp[3];
    const float alpha = q[3];
    const float Ts = TS[s];
    const float w = alpha * Ts;
    const float s0 = q[0], s1 = q[1], s2 = q[2];
    float dw = (g0 * s0 + g1 * s1) + g2 * s2;
    if (b.white_bg) dw = dw - gsum;
    gp[0] = (g0 * w) * s0 * (1.0f - s0);
    gp[1] = (g1 * w) * s1 * (1.0f - s1);
    gp[2] = (g2 * w) * s2 * (1.0f - s2);
    const float da = (dw - dT) * Ts;
    dT = dw * alpha + dT * (1.0f - alpha + 1e-10f);
    gp[3] = da * (1.0f - alpha) * dist;
  }
}

// What a launch of the tile kernel does.
enum NkbMode {
  NKB_VJP = 0,      // the (4, n) cotangent b.g to the gradients
  NKB_TRAIN = 1,    // whole rays a tile: compositing, loss and gradients
  NKB_FORWARD = 2,  // the forward alone: (rgb logits, sigma) to b.f.out
};

// MT0: m-tiles of 16 rows of layer 0's dW a warp holds (its n-tile of
// every input row of the encoding), at least the plan's mt0; MPM: m-tiles
// of 16 points of a tile, at least P / 16.
// FWD: the forward alone (an instance of its own: a mode read at run time
// cost the gradient instances 8-14 % on the card); train: whole rays a
// tile, else the VJP.
template <int MT0, int MPM, bool FWD>
__global__ void __launch_bounds__(NKB_THREADS, 1)
    nkt_fused_tile_kernel(BwdArgs b, BwdPlan pl, SaveRows rows, int train) {
  extern __shared__ __align__(16) unsigned char sm[];
  const FusedArgs& a = b.f;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int nd = a.nd, nl = a.nd + a.nc;

  // ---- the forward blocks, the biases; the sums from zero ----------------
  {
    const uint4* src = reinterpret_cast<const uint4*>(a.wpk);
    uint4* dst = reinterpret_cast<uint4*>(sm);
    for (int e = tid; e < a.pk_fwd / 8; e += NKB_THREADS) dst[e] = __ldg(src + e);
    float* sb = reinterpret_cast<float*>(sm + pl.bias_off);
    for (int e = tid; e < nl * NKT_W; e += NKB_THREADS) {
      const int L = e / NKT_W, j = e - L * NKT_W;
      const float* B = L < nd ? a.db[L] : a.cb[L - nd];
      sb[e] = j < nkb_J(a, L) ? B[j] : 0.0f;
    }
    float* s = reinterpret_cast<float*>(sm + pl.acc_off);
    for (int e = tid; e < pl.acc_floats; e += NKB_THREADS) s[e] = 0.0f;
  }
  __syncthreads();

  const __nv_bfloat16* W = reinterpret_cast<const __nv_bfloat16*>(sm);
  const float* sbias = reinterpret_cast<const float*>(sm + pl.bias_off);
  float* sacc = reinterpret_cast<float*>(sm + pl.acc_off);
  unsigned char* tl = sm + pl.tile_off;
  const int P = pl.P;
  __nv_bfloat16* G16 = reinterpret_cast<__nv_bfloat16*>(tl + P * pl.g_at);
  NktTapS* taps = reinterpret_cast<NktTapS*>(G16);  // the forward's, per point
  float* OUT = reinterpret_cast<float*>(tl + P * pl.f_at);  // [P][4]
  float* G4 = OUT + 4 * P;                                 // [P][4]
  float* Z0 = G4 + 4 * P;                                  // [P]
  float* TS = Z0 + P;                                      // [P]
  // a warp's list of values to sum again, in the forward (G4 is not used
  // until the forward ends): P entries a warp
  unsigned short* list = reinterpret_cast<unsigned short*>(G4) + warp * P;

  const int C = a.cp.n_comp, C2 = C / 2, T = a.cp.table, Lv = a.cp.n_levels;
  const int LC = Lv * C, CT = C / 16;
  const int K0 = a.d_in[0], J0 = a.d_out[0], NT0 = J0 / 8;
  const long long n = a.n;
  const long long n_rays = train ? n / b.S : 0;
  const long long n_tiles =
      train ? (n_rays + pl.rays - 1) / pl.rays : (n + P - 1) / P;
  // the block's slot of the encoding: P rows of L*C
  __nv_bfloat16* slot =
      static_cast<__nv_bfloat16*>(a.enc) + (long long)blockIdx.x * P * LC;
  const unsigned pois_levels = nkt_poison_levels(a.cp);
  const __nv_bfloat162* lines16 = reinterpret_cast<const __nv_bfloat162*>(a.lines16);

  float acc0[MT0][4];
#pragma unroll
  for (int m = 0; m < MT0; ++m) acc0[m][0] = acc0[m][1] = acc0[m][2] = acc0[m][3] = 0.0f;
  float acc[MPM][4];

  for (long long tt = blockIdx.x; tt < n_tiles; tt += gridDim.x) {
    const long long p0 = tt * pl.tile_pts;
    const int np = n - p0 < pl.tile_pts ? (int)(n - p0) : pl.tile_pts;
    const int MP = (np + 15) / 16;
    const int npad = MP * 16;
    const int ppw = 2 * MP;        // points a warp gathers
    const int pw0 = warp * ppw;    // the first of them

    // ======== forward: layer 0, fed by the encoder a level at a time ========
#pragma unroll
    for (int mt = 0; mt < MPM; ++mt)
      acc[mt][0] = acc[mt][1] = acc[mt][2] = acc[mt][3] = 0.0f;
    float px = 0.0f, py = 0.0f, pz = 0.0f;
    if (lane < ppw && pw0 + lane < np) {
      const long long i = p0 + pw0 + lane;
      px = a.xt[i];
      py = a.xt[n + i];
      pz = a.xt[2 * n + i];
    }
    for (int l = 0; l < Lv; ++l) {
      __nv_bfloat16* E = reinterpret_cast<__nv_bfloat16*>(tl) + (l & 1) * P * pl.e_ld;
      uint32_t* Ew = reinterpret_cast<uint32_t*>(E);
      const int elw = pl.e_ld / 2;
      if (lane < ppw) {
        NktTapS* q = taps + (pw0 + lane) * 3;
        q[0] = nkt_tap_s(nkt_taps(px, a.cp, l, 0));
        q[1] = nkt_tap_s(nkt_taps(py, a.cp, l, 1));
        q[2] = nkt_tap_s(nkt_taps(pz, a.cp, l, 2));
      }
      __syncwarp();
      const __nv_bfloat162* tx = lines16 + (long long)(l * 3 + 0) * T * C2;
      const __nv_bfloat162* ty = lines16 + (long long)(l * 3 + 1) * T * C2;
      const __nv_bfloat162* tz = lines16 + (long long)(l * 3 + 2) * T * C2;
      // the gathers of two points first, then their products
      for (int q0 = 0; q0 < ppw; q0 += 2) {
        for (int c2 = lane; c2 < C2; c2 += 32) {
          __nv_bfloat162 v[2][6];
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const NktTapS* q = taps + (pw0 + q0 + u) * 3;
            v[u][0] = __ldg(tx + q[0].r0 * C2 + c2);
            v[u][1] = __ldg(tx + q[0].r1 * C2 + c2);
            v[u][2] = __ldg(ty + q[1].r0 * C2 + c2);
            v[u][3] = __ldg(ty + q[1].r1 * C2 + c2);
            v[u][4] = __ldg(tz + q[2].r0 * C2 + c2);
            v[u][5] = __ldg(tz + q[2].r1 * C2 + c2);
          }
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const int p = pw0 + q0 + u;
            const NktTapS* q = taps + p * 3;
            const float2 x0 = __bfloat1622float2(v[u][0]);
            const float2 x1 = __bfloat1622float2(v[u][1]);
            const float2 y0 = __bfloat1622float2(v[u][2]);
            const float2 y1 = __bfloat1622float2(v[u][3]);
            const float2 z0 = __bfloat1622float2(v[u][4]);
            const float2 z1 = __bfloat1622float2(v[u][5]);
            const float ux0 = q[0].w0 * x0.x + q[0].w1 * x1.x;
            const float ux1 = q[0].w0 * x0.y + q[0].w1 * x1.y;
            const float uy0 = q[1].w0 * y0.x + q[1].w1 * y1.x;
            const float uy1 = q[1].w0 * y0.y + q[1].w1 * y1.y;
            const float uz0 = q[2].w0 * z0.x + q[2].w1 * z1.x;
            const float uz1 = q[2].w0 * z0.y + q[2].w1 * z1.y;
            Ew[p * elw + c2] =
                p < np ? nkt_pack2((ux0 * uy0) * uz0, (ux1 * uy1) * uz1) : 0u;
          }
        }
      }
      __syncwarp();
      // a non-finite table entry (nkt_poison), rarely
      if ((pois_levels >> l) & 1u) {
        nkt_poison_tile(E + pw0 * pl.e_ld, pl.e_ld, taps + pw0 * 3,
                        nkt_poison_descs(a.cp, l), C, nkt_dup_row(a.cp, l, true),
                        np - pw0 < ppw ? np - pw0 : ppw, lane);
        __syncwarp();
      }
      // the level's columns of the slot, read back by layer 0's finish and
      // by its weight gradient
      for (int e = lane; e < ppw * (C / 8); e += 32) {
        const int p = pw0 + e / (C / 8), c8 = e % (C / 8);
        if (p < np)
          *reinterpret_cast<uint4*>(slot + p * LC + l * C + c8 * 8) =
              *reinterpret_cast<const uint4*>(E + p * pl.e_ld + c8 * 8);
      }
      __syncthreads();
      if (warp < NT0)
        nkb_fwd_product<MPM>(acc, MP, Ew, elw,
                        reinterpret_cast<const uint32_t*>(W + a.pk_off[0] + l * C),
                        a.pk_ld[0] / 2, warp, CT, lane);
    }

    // ======== forward: every layer's finish, then the next product ========
    for (int L = 0; L < nl; ++L) {
      const int K = nkb_K(a, L), J = nkb_J(a, L), NT = (J + 7) / 8;
      if (L > 0) {
        __syncthreads();  // the layer's input is whole
        if (warp < NT) {
#pragma unroll
          for (int mt = 0; mt < MPM; ++mt)
            acc[mt][0] = acc[mt][1] = acc[mt][2] = acc[mt][3] = 0.0f;
          nkb_fwd_product<MPM>(acc, MP,
                          reinterpret_cast<const uint32_t*>(tl + P * pl.x_at[L]),
                          pl.x_ld[L] / 2,
                          reinterpret_cast<const uint32_t*>(W + a.pk_off[L]),
                          a.pk_ld[L] / 2, warp, K / 16, lane);
        }
      }
      if (L == nl - 1) {
        // the rgb logits, f32: columns 0-1 at t = 0, column 2 at t = 1
        if (warp == 0 && t < 2) {
#pragma unroll
          for (int mt = 0; mt < MPM; ++mt) {
            if (mt < MP) {
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const int p = mt * 16 + g + 8 * h;
                OUT[p * 4 + 2 * t] = acc[mt][2 * h] + sbias[L * NKT_W + 2 * t];
                if (t == 0) OUT[p * 4 + 1] = acc[mt][2 * h + 1] + sbias[L * NKT_W + 1];
              }
            }
          }
        }
        break;
      }
      const bool last_d = L == nd - 1;
      const __nv_bfloat16* X =
          L == 0 ? slot : reinterpret_cast<const __nv_bfloat16*>(tl + P * pl.x_at[L]);
      const int ldx = L == 0 ? LC : pl.x_ld[L];
      const __nv_bfloat16* Wt = W + a.pk_off[L];
      if (last_d && warp == 0) {
        // sigma comes from the f32 feature 0, and the whole step's inverse
        // CDFs turn its last bits into moved samples: feature 0 is summed in
        // the plain version's order for every point and replaces the tensor
        // cores' sum
        for (int p = lane; p < np; p += 32) Z0[p] = nkt_chain<4>(X + p * ldx, Wt, K);
        __syncwarp();
        if (t == 0) {
#pragma unroll
          for (int mt = 0; mt < MPM; ++mt) {
            if (mt < MP) {
              const int p = mt * 16 + g;
              acc[mt][0] = p < np ? Z0[p] : 0.0f;
              acc[mt][2] = p + 8 < np ? Z0[p + 8] : 0.0f;
            }
          }
        }
        __syncwarp();
        for (int p = lane; p < np; p += 32) {
          const float z = Z0[p] + sbias[L * NKT_W];
          Z0[p] = z;
          OUT[p * 4 + 3] = expf(nkt_clamp(z, -15.0f, 15.0f));
        }
      }
      if (warp < NT)
        nkb_finish<MPM>(acc, MP, np, warp, sbias + L * NKT_W, !last_d,
                   reinterpret_cast<__nv_bfloat16*>(tl + P * pl.x_at[L + 1]),
                   pl.x_ld[L + 1], X, ldx, K, Wt, a.pk_ld[L], list, P, lane, g, t);
      if (last_d) {
        // the color MLP's input: the features, then SH4 of the view
        // directions, rounded
        __nv_bfloat16* Y = reinterpret_cast<__nv_bfloat16*>(tl + P * pl.x_at[L + 1]);
        const int ly = pl.x_ld[L + 1];
        for (int p = tid; p < npad; p += NKB_THREADS) {
          float sh[16];
          const long long i = p0 + (p < np ? p : 0);
          nkt_sh4(a.vdt[i], a.vdt[n + i], a.vdt[2 * n + i], sh);
#pragma unroll
          for (int s = 0; s < 16; ++s)
            Y[p * ly + J + s] = __float2bfloat16_rn(p < np ? sh[s] : 0.0f);
        }
      }
    }
    __syncthreads();

    if (FWD) {  // (rgb logits, sigma), as row 3 writes them
      for (int e = tid; e < np * 4; e += NKB_THREADS) {
        const int c = e / np, p = e - c * np;
        a.out[c * n + p0 + p] = OUT[p * 4 + c];
      }
      __syncthreads();  // OUT serves the next tile
      continue;
    }

    // ======== the cotangent of (rgb logits, sigma) ========
    if (train) {
      for (int p = tid; p < npad; p += NKB_THREADS) {
        float* o = OUT + 4 * p;
        if (p < np) {
          const float dist = b.dists[p0 + p];
          const float alpha = 1.0f - expf(-o[3] * dist);
          o[0] = 1.0f / (1.0f + expf(-o[0]));
          o[1] = 1.0f / (1.0f + expf(-o[1]));
          o[2] = 1.0f / (1.0f + expf(-o[2]));
          o[3] = alpha;
          G4[4 * p + 3] = dist;  // read by the reverse pass, then overwritten
        } else {
          G4[4 * p] = G4[4 * p + 1] = G4[4 * p + 2] = G4[4 * p + 3] = 0.0f;
        }
      }
      __syncthreads();
      const int S = b.S;
      const int r = warp + NKB_WARPS * lane;  // the rays over the warps
      if (r < np / S)
        nkb_ray(b, OUT + 4 * r * S, G4 + 4 * r * S, TS + r * S, p0 / S + r, n_rays);
    } else {
      for (int e = tid; e < npad * 4; e += NKB_THREADS) {
        const int p = e >> 2, c = e & 3;
        G4[e] = p < np ? b.g[c * n + p0 + p] : 0.0f;
      }
    }
    __syncthreads();

    // ======== backward ========
    {
      // the last layer's cotangent (columns past it 0, to 16) and its db
      const int Ll = nl - 1, Jl = nkb_J(a, Ll);
      for (int e = tid; e < npad * 16; e += NKB_THREADS) {
        const int p = e >> 4, j = e & 15;
        G16[p * NKB_GLD + j] = __float2bfloat16_rn(j < Jl && p < np ? G4[p * 4 + j] : 0.0f);
      }
      if (tid < Jl) {
        float s = 0.0f;
        for (int p = 0; p < np; ++p) s = s + G4[p * 4 + tid];
        sacc[pl.db_off + Ll * NKT_W + tid] += s;
      }
    }
    __syncthreads();
    for (int L = nl - 1; L >= 1; --L) {
      const int K = nkb_K(a, L), J = nkb_J(a, L);
      const __nv_bfloat16* XL = reinterpret_cast<const __nv_bfloat16*>(tl + P * pl.x_at[L]);
      const int ldx = pl.x_ld[L];
      // (a) dW_L += X_L^T G, the fragments over the warps
      {
        const int FN = (J + 7) / 8, F = K / 16 * FN;
        float* fr = sacc + pl.frag_off[L];
        for (int f = warp; f < F; f += NKB_WARPS) {
          float c[4];
          nkb_wgrad_frag<MPM>(c, MP, XL, ldx, f / FN, G16, f % FN, lane);
#pragma unroll
          for (int e = 0; e < 4; ++e) fr[f * 128 + e * 32 + lane] += c[e];
        }
      }
      // (b) the cotangent of the layer's input, the warp's n-tile of its
      // columns (at the color MLP's first layer only the features')
      const int NTo = (L == nd ? a.d_out[nd - 1] : K) / 8;
      if (warp < NTo)
        nkb_bwd_product<MPM>(acc, MP, G16, W + a.pk_off[L], a.pk_ld[L], warp, J, lane);
      __syncthreads();  // every read of G is done
      // (c) layer L-1's output cotangent: sigma's share at feature 0, masked
      // by its ReLU (the layer's input > 0), summed into db, rounded into G
      if (warp < NTo) {
        const bool relu = L - 1 != nd - 1;
        const int j0 = warp * 8 + 2 * t;
        float s0 = 0.0f, s1 = 0.0f;
#pragma unroll
        for (int mt = 0; mt < MPM; ++mt) {
          if (mt < MP) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int p = mt * 16 + g + 8 * h;
              float v0 = acc[mt][2 * h], v1 = acc[mt][2 * h + 1];
              if (L == nd && j0 == 0 && p < np) {
                const float z0 = Z0[p];
                if (z0 > -15.0f && z0 < 15.0f)
                  v0 = v0 + G4[p * 4 + 3] * expf(nkt_clamp(z0, -15.0f, 15.0f));
              }
              if (relu) {
                const __nv_bfloat162 m =
                    *reinterpret_cast<const __nv_bfloat162*>(XL + p * ldx + j0);
                if (!(__low2float(m) > 0.0f)) v0 = 0.0f;
                if (!(__high2float(m) > 0.0f)) v1 = 0.0f;
              }
              if (p >= np) v0 = v1 = 0.0f;
              s0 = s0 + v0;
              s1 = s1 + v1;
              *reinterpret_cast<uint32_t*>(G16 + p * NKB_GLD + j0) = nkt_pack2(v0, v1);
            }
          }
        }
        // the column sums over the eight lanes of each t
#pragma unroll
        for (int d = 4; d < 32; d <<= 1) {
          s0 = s0 + __shfl_xor_sync(0xffffffffu, s0, d);
          s1 = s1 + __shfl_xor_sync(0xffffffffu, s1, d);
        }
        if (g == 0) {
          sacc[pl.db_off + (L - 1) * NKT_W + j0] += s0;
          sacc[pl.db_off + (L - 1) * NKT_W + j0 + 1] += s1;
        }
      }
      __syncthreads();
    }

    // ======== layer 0: dW (registers) and d_enc (to denc), a level at a time
    uint32_t gb[MPM][2];  // g's B fragments on the warp's n-tile
    if (warp < NT0) {
#pragma unroll
      for (int mt = 0; mt < MPM; ++mt)
        if (mt < MP) nkt_ldm2t(gb[mt], G16 + (mt * 16 + (lane & 15)) * NKB_GLD + warp * 8);
    }
    // a level's rows of the slot into its level tile (a warp its points;
    // rows past np zero-filled), by cp.async: level l + 1's copies are in
    // flight while the block computes level l
    auto fetch_level = [&](int l) {
      __nv_bfloat16* E = reinterpret_cast<__nv_bfloat16*>(tl) + (l & 1) * P * pl.e_ld;
      for (int e = lane; e < ppw * (C / 8); e += 32) {
        const int p = pw0 + e / (C / 8), c8 = e % (C / 8);
        nkt_cp_async16(E + p * pl.e_ld + c8 * 8,
                       p < np ? slot + p * LC + l * C + c8 * 8 : slot, p < np ? 16 : 0);
      }
      nkt_cp_commit();
    };
    fetch_level(0);
    for (int l = 0; l < Lv; ++l) {
      __nv_bfloat16* E = reinterpret_cast<__nv_bfloat16*>(tl) + (l & 1) * P * pl.e_ld;
      nkt_cp_wait<0>();
      __syncthreads();
      // the other level tile was last read at level l - 1, before this barrier
      if (l + 1 < Lv) fetch_level(l + 1);
      if (warp < NT0) {
#pragma unroll
        for (int m = 0; m < MT0; ++m) {
          const int mi = m - l * CT;
          if (mi >= 0 && mi < CT) {
            const __nv_bfloat16* xr = E + ((lane & 7) + ((lane >> 4) << 3)) * pl.e_ld +
                                      mi * 16 + ((lane >> 3) & 1) * 8;
#pragma unroll
            for (int mt = 0; mt < MPM; ++mt) {
              if (mt < MP) {
                uint32_t af[4];
                nkt_ldm4t(af, xr + mt * 16 * pl.e_ld);
                nkt_mma(acc0[m], af, gb[mt][0], gb[mt][1]);
              }
            }
          }
        }
      }
      for (int nt = warp; nt < C / 8; nt += NKB_WARPS) {
        nkb_bwd_product<MPM>(acc, MP, G16, W + a.pk_off[0] + l * C, a.pk_ld[0], nt, J0, lane);
#pragma unroll
        for (int mt = 0; mt < MPM; ++mt) {
          if (mt < MP) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int p = mt * 16 + g + 8 * h;
              if (p < np)
                *reinterpret_cast<float2*>(b.denc + (p0 + p) * LC + l * C + nt * 8 + 2 * t) =
                    make_float2(acc[mt][2 * h], acc[mt][2 * h + 1]);
            }
          }
        }
      }
    }
    __syncthreads();  // the tile's buffers and the slot serve the next tile
  }

  if (FWD) return;

  // ---- the block's partial sums: its row of `partial` --------------------
  float* mine = b.partial + (long long)blockIdx.x * rows.total;
  if (warp < NT0) {
#pragma unroll
    for (int m = 0; m < MT0; ++m) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int k = m * 16 + g + (e >> 1) * 8, j = warp * 8 + 2 * t + (e & 1);
        if (k < K0) mine[rows.dw_off[0] + k * J0 + j] = acc0[m][e];
      }
    }
  }
  for (int L = 1; L < nl; ++L) {
    const int K = nkb_K(a, L), J = nkb_J(a, L), FN = (J + 7) / 8;
    const float* fr = sacc + pl.frag_off[L];
    const int wo = L < nd ? rows.dw_off[L] : rows.cw_off[L - nd];
    for (int e = tid; e < K / 16 * FN * 128; e += NKB_THREADS) {
      const int f = e >> 7, ee = (e >> 5) & 3, ln = e & 31;
      const int k = (f / FN) * 16 + (ln >> 2) + (ee >> 1) * 8;
      const int j = (f % FN) * 8 + 2 * (ln & 3) + (ee & 1);
      if (j < J) mine[wo + k * J + j] = fr[e];
    }
  }
  for (int e = tid; e < nl * NKT_W; e += NKB_THREADS) {
    const int L = e / NKT_W, j = e - L * NKT_W;
    if (j < nkb_J(a, L))
      mine[(L < nd ? rows.db_off[L] : rows.cb_off[L - nd]) + j] = sacc[pl.db_off + e];
  }
}

// ---------------------------------------------------------------------------
// Host side.

static size_t wg_smem(const WgPlan& p) {
  return (size_t)(p.a_words + p.g_words) * sizeof(uint32_t);
}

static size_t wgrad_smem(int K, int J) {
  const int JP = 4 * ((J + 3) / 4) + 4;
  return (size_t)(nkt_as_floats(K) + 2 * NKT_TP * JP) * sizeof(float);
}

static bool dims_ok(const FusedArgs& a) { return a.cp.n_comp % 4 == 0; }

#define NKT_CHECK(expr)                        \
  do {                                         \
    cudaError_t e_ = (expr);                   \
    if (e_ != cudaSuccess) return (int)e_;     \
  } while (0)

// One layer's weight gradient, dW = A G^T and db = sum of G over n points,
// as per-block partial sums into partial (blocks rows of `total` floats).
// Called by the classic engine's gradient (csrc/classic_fused.cu).
extern "C" int nkt_wgrad_launch(const float* A, const float* G, long long n,
                                int K, int J, int bf, float* partial,
                                int total, int w_off, int b_off, int blocks,
                                void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (bf) {  // the tensor cores, one job per 256 x 64 block of the layer
    WgPlan p;
    p.n_jobs = 0;
    p.total = total;
    p.a_words = p.g_words = 0;
    p.n = n;
    if (blocks < 1 || !wg_add_layer(p, A, G, K, J, w_off, b_off))
      return (int)cudaErrorInvalidValue;
    const long long tiles = (n + NKT_WG_TP - 1) / NKT_WG_TP;
    p.chunk = ((tiles + blocks - 1) / blocks) * NKT_WG_TP;
    const size_t bytes = wg_smem(p);
    NKT_CHECK(cudaFuncSetAttribute(nkt_wgrad_mma_kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)bytes));
    nkt_wgrad_mma_kernel<<<dim3((unsigned)blocks, (unsigned)p.n_jobs),
                           NKT_THREADS, bytes, st>>>(p, partial);
    return (int)cudaGetLastError();
  }
  // A thread owns at most NKT_MAX_Q groups: a wider layer (fox_ngp.yml's
  // first, 480 x 64) goes in launches of at most kc input rows, the bias
  // with the first.
  const int J4 = (J + 3) / 4;
  const int kc = NKT_MAX_Q * NKT_THREADS / J4;
  if (kc < 1) return (int)cudaErrorInvalidValue;
  const bool uniform = NKT_THREADS % J4 == 0;
  for (int k0 = 0; k0 < K; k0 += kc) {
    const int Kc = K - k0 < kc ? K - k0 : kc;
    const size_t bytes = wgrad_smem(Kc, J);
    const float* Ak = A + (long long)k0 * n;
    const int wo = w_off + k0 * J, bo = k0 == 0 ? b_off : -1;
    if (uniform) {
      NKT_CHECK(cudaFuncSetAttribute(nkt_wgrad_kernel<true>,
                                     cudaFuncAttributeMaxDynamicSharedMemorySize,
                                     (int)bytes));
      nkt_wgrad_kernel<true><<<blocks, NKT_THREADS, bytes, st>>>(
          Ak, G, n, Kc, J, bf, partial, total, wo, bo);
    } else {
      NKT_CHECK(cudaFuncSetAttribute(nkt_wgrad_kernel<false>,
                                     cudaFuncAttributeMaxDynamicSharedMemorySize,
                                     (int)bytes));
      nkt_wgrad_kernel<false><<<blocks, NKT_THREADS, bytes, st>>>(
          Ak, G, n, Kc, J, bf, partial, total, wo, bo);
    }
    NKT_CHECK(cudaGetLastError());
  }
  return (int)cudaSuccess;
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

template <int MT0, int MPM>
static int launch_tile(const BwdArgs& b, const BwdPlan& pl,
                       const SaveRows& rows, int mode, long long grid,
                       cudaStream_t st) {
  void (*kernel)(BwdArgs, BwdPlan, SaveRows, int) = nkt_fused_tile_kernel<MT0, MPM, false>;
  if (mode == NKB_FORWARD) kernel = nkt_fused_tile_kernel<MT0, MPM, true>;
  NKT_CHECK(cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 pl.total));
  kernel<<<(unsigned)grid, NKB_THREADS, pl.total, st>>>(b, pl, rows,
                                                        mode == NKB_TRAIN ? 1 : 0);
  return (int)cudaGetLastError();
}

// The instance for the plan: one for an encoding of up to 256 (16 m-tiles
// of layer 0's dW a warp, tiles of up to 128 points), one for up to 512 (32
// m-tiles; make_plan keeps its tiles to 64 points, so that the registers of
// layer 0's dW leave room for the rest); and, with arrays of just their
// size, machina_ngp.yml's tile (16 m-tiles, 96 points) and fox_ngp.yml's
// (30, 64), which are 8 % and 5 % faster so on the card (PERF.md section 6).
static int launch_tile_for(const BwdArgs& b, const BwdPlan& pl,
                           const SaveRows& rows, int mode, long long grid,
                           cudaStream_t st) {
  const int mp = pl.P / 16;
  if (pl.mt0 == 16 && mp == 6) return launch_tile<16, 6>(b, pl, rows, mode, grid, st);
  if (pl.mt0 == 30 && mp == 4) return launch_tile<30, 4>(b, pl, rows, mode, grid, st);
  if (pl.mt0 <= 16) return launch_tile<16, NKB_MAX_MT>(b, pl, rows, mode, grid, st);
  return launch_tile<32, NKB_WIDE_MT>(b, pl, rows, mode, grid, st);
}

// bf16 mode: the tile kernel, row 5's kernel on denc, the sum of the
// blocks' partial rows. A train objective whose rays are longer than a tile
// (the plan's rays 0) first runs the forward alone and the rays' kernel,
// then the tile kernel as the VJP of their cotangent (b.gbuf, 4 x n).
static int run_backward_tile(const BwdArgs& b, bool train, int n_sm,
                             cudaStream_t st) {
  const FusedArgs& a = b.f;
  BwdPlan pl;
  if (!mma_dims_ok(a, true) || !make_plan(a, train ? b.S : 0, pl))
    return (int)cudaErrorInvalidValue;
  const SaveRows rows = make_rows(a);
  const bool rays_in_tile = train && pl.rays > 0;
  const long long tiles =
      rays_in_tile ? (a.n / b.S + pl.rays - 1) / pl.rays : (a.n + pl.P - 1) / pl.P;
  long long grid = tiles < n_sm ? tiles : n_sm;
  if (grid > b.n_part) grid = b.n_part;
  if (grid < 1 || grid * (pl.P / 16) > a.enc_slots) return (int)cudaErrorInvalidValue;
  int rc;
  if (train && !rays_in_tile) {
    if (!b.gbuf) return (int)cudaErrorInvalidValue;
    rc = launch_tile_for(b, pl, rows, NKB_FORWARD, grid, st);
    if (rc) return rc;
    const long long n_rays = a.n / b.S;
    nkt_train_rays_kernel<<<(unsigned)((n_rays + 127) / 128), 128, 0, st>>>(b, n_rays);
    NKT_CHECK(cudaGetLastError());
    BwdArgs bb = b;
    bb.g = b.gbuf;
    rc = launch_tile_for(bb, pl, rows, NKB_VJP, grid, st);
  } else {
    rc = launch_tile_for(b, pl, rows, train ? NKB_TRAIN : NKB_VJP, grid, st);
  }
  if (rc) return rc;
  rc = launch_dlines(b, st);
  if (rc) return rc;
  return nkt_reduce_partials_launch(b.partial, b.flat, rows.total, (int)grid, st);
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
  if (a.cp.use_bf16) return run_backward_tile(b, train, n_sm, st);
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
// and gs in points, out[5] = bytes of an act entry; z0 has ld floats. f32
// mode: ld = n, 4-byte entries. bf16 mode keeps every layer's input and
// cotangent on chip: no act, gs or z0 (ld 0); out[3] is the tile kernel's
// (1 << 30 where its plan does not fit).
extern "C" void nkt_fused_bwd_sizes(const FusedArgs* args, long long* out) {
  const SaveRows rows = make_rows(*args);
  out[2] = rows.total;
  if (args->cp.use_bf16) {
    BwdPlan pl;
    out[0] = out[1] = 0;
    out[3] = make_plan(*args, 0, pl) ? pl.total : (1LL << 30);
    out[4] = 0;
    out[5] = 2;
  } else {
    out[0] = rows.act_rows;
    out[1] = rows.gs_rows;
    const long long f = make_layout(*args, true).total;
    const long long bw = make_layout(*args, true, NKT_W * NKT_HS).total;
    out[3] = (f > bw ? f : bw) * (long long)sizeof(float);
    out[4] = args->n;
    out[5] = 4;
  }
}

// The tile kernel's plan for S samples a ray (0: the VJP): out[0] = points
// a tile, out[1] = rays a tile (0: the VJP's tiles, also for a ray longer
// than a tile), out[2] = points of a full tile, out[3] =
// bytes of shared memory, out[4] = of them the weights' and biases', out[5]
// = the sums', out[6] = the tile's bytes a point, out[7] = of them the
// layers' inputs', out[8] = accumulator registers a thread (layer 0's dW).
// Returns 0, or 1 where the layers do not fit.
extern "C" int nkt_fused_bwd_plan(const FusedArgs* args, int S, long long* out) {
  BwdPlan pl;
  if (!mma_dims_ok(*args, true) || !make_plan(*args, S, pl)) return 1;
  out[0] = pl.P;
  out[1] = pl.rays;
  out[2] = pl.tile_pts;
  out[3] = pl.total;
  out[4] = pl.acc_off;
  out[5] = (long long)pl.acc_floats * 4;
  out[6] = pl.per_point;
  out[7] = pl.g_at;
  out[8] = pl.mt0 * 4;
  return 0;
}

// The VJP of the fused forward: b->g is the (4, n) cotangent.
extern "C" int nkt_fused_backward(const BwdArgs* b, int n_sm, void* stream) {
  return run_backward(*b, false, n_sm, (cudaStream_t)stream);
}

// The fused fine train objective: forward, compositing, loss and backward.
extern "C" int nkt_fused_train(const BwdArgs* b, int n_sm, void* stream) {
  return run_backward(*b, true, n_sm, (cudaStream_t)stream);
}
