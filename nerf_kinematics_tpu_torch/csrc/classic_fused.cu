// Fused classic-NeRF point pipeline: the forward and its gradient.
//
// Replaces the TPU kernels of nerf_kinematics_tpu/ops/classic_fused_pallas.py:
//   classic_fused_apply_cf forward (_fwd_kernel)  -> nkt_classic_forward
//   classic_fused_apply_cf VJP     (_bwd_kernel)  -> nkt_classic_backward
//
// What one point costs: gamma(xyz) (63 rows at L = 10) -> a trunk of
// num_layers // 2 dense layers of `hidden` with ReLU -> a raw sigma head, and
// a feature layer whose output, with gamma(dir), feeds a half-width direction
// layer and the rgb head. At hidden 128 that is 83 840 multiply-adds a point,
// so both kernels are bound by operations, not bytes (40 B of IO a point,
// 330 KB of f32 weights that stay resident in L2).
//
// Design. The TPU kernel holds a block of 4096 points in VMEM. Here the
// weights alone (330 KB) exceed the 227 KB a block may use, and a thread that
// held a 128-wide activation plus its accumulators would spill. So a block of
// 256 threads owns a tile of NKC_P = 64 points, whose activations live in
// shared memory as (features, points) in two ping-pong buffers, and each
// layer is a small product: thread (jg = tid / 16, pg = tid % 16) computes
// outputs jg*JT .. jg*JT+JT-1 for points pg*4 .. pg*4+3 (JT = 8 for 128
// outputs, 4 for up to 64), reading its weights as 16-byte loads through L1
// from a packed copy and the activations as 16-byte shared-memory loads.
// Sums run over the input in ascending order with fused multiply-adds
// (-fmad=false elsewhere), and the sin / cos of the encoding are the
// full-precision sinf / cosf: with L = 10 their arguments reach thousands
// of radians, where the fast intrinsics lose every digit.
//
// bf16 mode (compute_dtype bfloat16) takes the TPU kernel's cast points: a
// layer with 16 or more outputs rounds its weights and its input to bf16 and
// accumulates in f32; the heads (sigma: 1 output, rgb: 3) stay f32, and so
// do their backward products. Biases are f32. The packing kernel rounds the
// weights once per call; an activation is rounded where it is written for a
// layer that rounds (the trunk's last output is kept in f32 for sigma and
// rounded in place for the feature layer).
//
// The gradient keeps the route of the NGP gradient kernels: the TPU kernel
// adds every block's parameter gradients into one resident accumulator,
// relying on grid steps that run in order, while CUDA blocks run at once.
//   1. nkc_pack_kernel: weights into the packed layouts, biases.
//   2. nkc_bwd_tile_kernel: per tile, the forward again, saving every layer's
//      f32 input to `act`; then the cotangent back through the layers in
//      shared memory (d_inp = W g, masked by the ReLU read back from `act`),
//      saving each layer's masked f32 cotangent to `gs`.
//   3. nkt_wgrad_launch (csrc/ngp_fused_bwd.cu) once per layer: dW = A G^T
//      and db = sum of G with per-block partial sums; then
//      nkt_reduce_partials_launch adds the partial sums in block order, so
//      the gradients are deterministic.
// Positions and directions get no cotangent, as in the reference.
#include "nkt_common.cuh"

#define NKC_MAX_LAYERS 16
#define NKC_MAX_FREQS 16
#define NKC_THREADS 256
#define NKC_P 64  // points per tile

// Mirrors ops/cuda_lib.py::ClassicArgs field for field. Layer L is, in
// order: layer1, layers_xyz.*, fc_alpha, fc_feat, layers_dir.0, fc_rgb.
struct ClassicArgs {
  const float* xt;   // (3, n) points
  const float* vdt;  // (3, n) unit view directions
  float* out;        // (4, n) rgb logits, raw sigma
  const float* W[NKC_MAX_LAYERS];  // (in, out) entry (k, j) at k*w_sk + j*w_sj
  const float* b[NKC_MAX_LAYERS];  // entry j at j*b_s
  long long w_sk[NKC_MAX_LAYERS];
  long long w_sj[NKC_MAX_LAYERS];
  long long b_s[NKC_MAX_LAYERS];
  float* wf;    // packed (in, wf_ld) weights of every layer, zero padded
  float* wb;    // packed (out, wb_ld) transposes, the first wb_cols inputs
  float* bias;  // packed biases
  long long n;
  int nw;      // layers: trunk + 4
  int trunk;   // trunk depth t
  int hidden;
  int buf_rows;  // rows of each of the two shared-memory buffers
  int in_dim[NKC_MAX_LAYERS];
  int out_dim[NKC_MAX_LAYERS];
  int rnd[NKC_MAX_LAYERS];  // layer rounds its operands to bf16
  int wf_off[NKC_MAX_LAYERS];
  int wf_ld[NKC_MAX_LAYERS];
  int wb_off[NKC_MAX_LAYERS];
  int wb_ld[NKC_MAX_LAYERS];
  int wb_cols[NKC_MAX_LAYERS];
  int b_off[NKC_MAX_LAYERS];
  int n_freq_x, n_freq_d, inc_x, inc_d;
  float freq_x[NKC_MAX_FREQS];
  float freq_d[NKC_MAX_FREQS];
  // the gradient
  const float* g;  // (4, n) cotangent of out
  float* act;      // (act_rows, n) every layer's f32 input
  float* gs;       // (gs_rows, n) masked f32 output cotangents
  float* partial;  // (n_part, grad_total) per-block sums
  float* flat;     // (grad_total,) dW (in, out) then db, layer by layer
  int act_row[NKC_MAX_LAYERS];  // first act row of layer L's input
  int gs_row[NKC_MAX_LAYERS];   // first gs row of layer L's cotangent
  int dw_off[NKC_MAX_LAYERS];
  int db_off[NKC_MAX_LAYERS];
  int grad_total;
  int n_part;
};

extern "C" int nkt_wgrad_launch(const float* A, const float* G, long long n,
                                int K, int J, int bf, float* partial,
                                int total, int w_off, int b_off, int blocks,
                                void* stream);
extern "C" int nkt_reduce_partials_launch(const float* partial, float* flat,
                                          int total, int blocks, void* stream);

// Row r of gamma at point i: the raw input first (when included), then for
// each frequency [sin x, sin y, sin z, cos x, cos y, cos z].
__device__ __forceinline__ float nkc_enc(const float* __restrict__ x3,
                                         long long n, long long i, int r,
                                         int inc, const float* freqs) {
  if (inc) {
    if (r < 3) return x3[r * n + i];
    r -= 3;
  }
  const int k = r / 6, w = r % 6;
  const float xb = x3[(w % 3) * n + i] * freqs[k];
  return w < 3 ? sinf(xb) : cosf(xb);
}

// acc[q][e] = sum over c < C of A[c][jg*JT + q] * in_s[c][pg*4 + e].
template <int JT>
__device__ __forceinline__ void nkc_gemm(const float* __restrict__ A, int lda,
                                         int C, const float* in_s,
                                         float (&acc)[JT][4]) {
  const int jg = threadIdx.x >> 4, pg = threadIdx.x & 15;
#pragma unroll
  for (int q = 0; q < JT; ++q)
    acc[q][0] = acc[q][1] = acc[q][2] = acc[q][3] = 0.0f;
  const float* a = A + jg * JT;
  const float* h = in_s + pg * 4;
  for (int c = 0; c < C; ++c) {
    const float4 hv = *reinterpret_cast<const float4*>(h + c * NKC_P);
    const float4* ac = reinterpret_cast<const float4*>(a + (long long)c * lda);
#pragma unroll
    for (int q4 = 0; q4 < JT / 4; ++q4) {
      const float4 av = __ldg(ac + q4);
      const float w[4] = {av.x, av.y, av.z, av.w};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float* r = acc[4 * q4 + u];
        r[0] = __fmaf_rn(w[u], hv.x, r[0]);
        r[1] = __fmaf_rn(w[u], hv.y, r[1]);
        r[2] = __fmaf_rn(w[u], hv.z, r[2]);
        r[3] = __fmaf_rn(w[u], hv.w, r[3]);
      }
    }
  }
}

// One layer of the tile: the product of nkc_gemm for O <= 128 outputs, then
// f(j, p, sum) for every output j < O and point p of the tile.
template <typename F>
__device__ __forceinline__ void nkc_layer(const float* A, int lda, int C,
                                          const float* in_s, int O, F f) {
  const int jg = threadIdx.x >> 4, pg = threadIdx.x & 15;
  if (O <= 64) {
    float acc[4][4];
    nkc_gemm<4>(A, lda, C, in_s, acc);
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (jg * 4 + q < O)
#pragma unroll
        for (int e = 0; e < 4; ++e) f(jg * 4 + q, pg * 4 + e, acc[q][e]);
  } else {
    float acc[8][4];
    nkc_gemm<8>(A, lda, C, in_s, acc);
#pragma unroll
    for (int q = 0; q < 8; ++q)
      if (jg * 8 + q < O)
#pragma unroll
        for (int e = 0; e < 4; ++e) f(jg * 8 + q, pg * 4 + e, acc[q][e]);
  }
}

__device__ __forceinline__ float nkc_round(bool r, float v) {
  return r ? nkt_bf16r(v) : v;
}

// Forward of the tile at `base`. SAVE: write every layer's f32 input to
// a.act and stop before the heads; else write the heads to a.out.
template <bool SAVE>
__device__ void nkc_forward_tile(const ClassicArgs& a, long long base,
                                 float* bufA, float* bufB) {
  const int tid = threadIdx.x;
  const long long n = a.n;
  const int t = a.trunk, H = a.hidden;
  const int LA = t, LF = t + 1, LD = t + 2, LR = t + 3;

  // gamma(xyz) into bufA
  const int dx = a.in_dim[0];
  for (int e = tid; e < dx * NKC_P; e += NKC_THREADS) {
    const int r = e / NKC_P, p = e % NKC_P;
    const long long i = base + p;
    float v = 0.0f;
    if (i < n) {
      v = nkc_enc(a.xt, n, i, r, a.inc_x, a.freq_x);
      if (SAVE) a.act[(long long)(a.act_row[0] + r) * n + i] = v;
    }
    bufA[r * NKC_P + p] = nkc_round(a.rnd[0], v);
  }
  __syncthreads();

  // the trunk; its last output stays f32 (sigma reads it unrounded)
  float* cur = bufA;
  float* nxt = bufB;
  for (int L = 0; L < t; ++L) {
    const bool last = L == t - 1;
    const int save_row = last ? a.act_row[LF] : a.act_row[L + 1];
    const bool rn = !last && a.rnd[L + 1];
    const float* bias = a.bias + a.b_off[L];
    float* dst = nxt;
    nkc_layer(a.wf + a.wf_off[L], a.wf_ld[L], a.in_dim[L], cur, a.out_dim[L],
              [&](int j, int p, float s) {
                const float v = fmaxf(s + bias[j], 0.0f);
                const long long i = base + p;
                if (SAVE && i < n) a.act[(long long)(save_row + j) * n + i] = v;
                dst[j * NKC_P + p] = nkc_round(rn, v);
              });
    __syncthreads();
    nxt = cur;
    cur = dst;
  }

  // raw sigma = fc_alpha(h), f32
  if (!SAVE && tid < NKC_P) {
    const long long i = base + tid;
    const float* wa = a.wf + a.wf_off[LA];
    const int lda = a.wf_ld[LA];
    float s = 0.0f;
    for (int k = 0; k < H; ++k)
      s = __fmaf_rn(wa[k * lda], cur[k * NKC_P + tid], s);
    if (i < n) a.out[3 * n + i] = s + a.bias[a.b_off[LA]];
  }
  if (a.rnd[LF]) {
    __syncthreads();
    for (int e = tid; e < H * NKC_P; e += NKC_THREADS) cur[e] = nkt_bf16r(cur[e]);
    __syncthreads();
  }

  // feat = relu(fc_feat(h)) and gamma(dir): the direction layer's input
  {
    const bool rn = a.rnd[LD];
    const int row = a.act_row[LD];
    const float* bias = a.bias + a.b_off[LF];
    float* dst = nxt;
    nkc_layer(a.wf + a.wf_off[LF], a.wf_ld[LF], H, cur, a.out_dim[LF],
              [&](int j, int p, float s) {
                const float v = fmaxf(s + bias[j], 0.0f);
                const long long i = base + p;
                if (SAVE && i < n) a.act[(long long)(row + j) * n + i] = v;
                dst[j * NKC_P + p] = nkc_round(rn, v);
              });
    const int dd = a.in_dim[LD] - H;
    for (int e = tid; e < dd * NKC_P; e += NKC_THREADS) {
      const int r = e / NKC_P, p = e % NKC_P;
      const long long i = base + p;
      float v = 0.0f;
      if (i < n) {
        v = nkc_enc(a.vdt, n, i, r, a.inc_d, a.freq_d);
        if (SAVE) a.act[(long long)(row + H + r) * n + i] = v;
      }
      dst[(H + r) * NKC_P + p] = nkc_round(rn, v);
    }
    __syncthreads();
    nxt = cur;
    cur = dst;
  }

  // y = relu(layers_dir.0(feat ; gamma(dir))); the rgb head reads it in f32
  {
    const int row = a.act_row[LR];
    const float* bias = a.bias + a.b_off[LD];
    float* dst = nxt;
    nkc_layer(a.wf + a.wf_off[LD], a.wf_ld[LD], a.in_dim[LD], cur,
              a.out_dim[LD], [&](int j, int p, float s) {
                const float v = fmaxf(s + bias[j], 0.0f);
                const long long i = base + p;
                if (SAVE && i < n) a.act[(long long)(row + j) * n + i] = v;
                dst[j * NKC_P + p] = v;
              });
    __syncthreads();
    cur = dst;
  }

  // rgb logits = fc_rgb(y), f32
  if (!SAVE && tid < 3 * NKC_P) {
    const int o = tid / NKC_P, p = tid % NKC_P;
    const long long i = base + p;
    const float* wr = a.wf + a.wf_off[LR] + o;
    const int lda = a.wf_ld[LR];
    float s = 0.0f;
    for (int k = 0; k < a.in_dim[LR]; ++k)
      s = __fmaf_rn(wr[k * lda], cur[k * NKC_P + p], s);
    if (i < n) a.out[o * n + i] = s + a.bias[a.b_off[LR] + o];
  }
}

// Layer L (blockIdx.x) into the packed layouts; blockIdx.y strides.
__global__ void nkc_pack_kernel(ClassicArgs a) {
  const int L = blockIdx.x;
  const int in = a.in_dim[L], out = a.out_dim[L];
  const bool rn = a.rnd[L] != 0;
  const float* W = a.W[L];
  const long long sk = a.w_sk[L], sj = a.w_sj[L];
  const int step = blockDim.x * gridDim.y;
  const int first = blockIdx.y * blockDim.x + threadIdx.x;
  const int ldf = a.wf_ld[L];
  float* wf = a.wf + a.wf_off[L];
  for (int e = first; e < in * ldf; e += step) {
    const int k = e / ldf, j = e % ldf;
    wf[e] = j < out ? nkc_round(rn, W[k * sk + j * sj]) : 0.0f;
  }
  const int ldb = a.wb_ld[L], cols = a.wb_cols[L];
  float* wb = a.wb + a.wb_off[L];
  for (int e = first; e < out * ldb && cols > 0; e += step) {
    const int j = e / ldb, k = e % ldb;
    wb[e] = k < cols ? nkc_round(rn, W[k * sk + j * sj]) : 0.0f;
  }
  for (int j = first; j < out; j += step)
    a.bias[a.b_off[L] + j] = a.b[L][j * a.b_s[L]];
}

__global__ void __launch_bounds__(NKC_THREADS, 2)
    nkc_forward_kernel(ClassicArgs a) {
  extern __shared__ float4 nkc_smem4[];
  float* smem = reinterpret_cast<float*>(nkc_smem4);
  nkc_forward_tile<false>(a, (long long)blockIdx.x * NKC_P, smem,
                          smem + a.buf_rows * NKC_P);
}

// The forward of the tile with its saves, then the cotangent back to the
// output of layer1: every layer's masked f32 cotangent goes to a.gs.
__global__ void __launch_bounds__(NKC_THREADS, 2)
    nkc_bwd_tile_kernel(ClassicArgs a) {
  extern __shared__ float4 nkc_smem4[];
  float* bufA = reinterpret_cast<float*>(nkc_smem4);
  float* bufB = bufA + a.buf_rows * NKC_P;
  const long long base = (long long)blockIdx.x * NKC_P;
  nkc_forward_tile<true>(a, base, bufA, bufB);
  __syncthreads();  // the saves are read back below as ReLU masks

  const int tid = threadIdx.x;
  const long long n = a.n;
  const int t = a.trunk;
  const int LA = t, LF = t + 1, LD = t + 2, LR = t + 3;
  const float* act = a.act;
  float* gs = a.gs;

  // One backward product: cotangent rows `in` of layer L -> its input's
  // cotangent (the first wb_cols[L] rows), plus (sigma) the fc_alpha term,
  // masked by the ReLU that made that input, saved for layer Lg's weight
  // gradient and rounded for its product.
  auto step = [&](int L, const float* in, float* dst, int Lg, bool add_sigma) {
    const int mrow = a.act_row[L];
    const int grow = a.gs_row[Lg];
    const bool rn = a.rnd[Lg] != 0;
    const float* wa = a.wf + a.wf_off[LA];
    const int lda = a.wf_ld[LA];
    nkc_layer(a.wb + a.wb_off[L], a.wb_ld[L], a.out_dim[L], in, a.wb_cols[L],
              [&](int j, int p, float s) {
                const long long i = base + p;
                float m = 0.0f;
                if (i < n) {
                  if (add_sigma) s = s + wa[j * lda] * a.g[3 * n + i];
                  if (act[(long long)(mrow + j) * n + i] > 0.0f) m = s;
                  gs[(long long)(grow + j) * n + i] = m;
                }
                dst[j * NKC_P + p] = nkc_round(rn, m);
              });
    __syncthreads();
  };

  // g_rgb (f32: the rgb head never rounds)
  if (tid < 3 * NKC_P) {
    const int o = tid / NKC_P, p = tid % NKC_P;
    const long long i = base + p;
    bufA[o * NKC_P + p] = i < n ? a.g[o * n + i] : 0.0f;
  }
  __syncthreads();
  step(LR, bufA, bufB, LD, false);   // -> direction layer's output
  step(LD, bufB, bufA, LF, false);   // -> feature layer's output (feat rows)
  step(LF, bufA, bufB, t - 1, true); // -> trunk output, + fc_alpha term
  float* cur = bufB;
  float* nxt = bufA;
  for (int L = t - 1; L >= 1; --L) {
    step(L, cur, nxt, L - 1, false);
    float* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }
}

#define NKC_CHECK(expr)                    \
  do {                                     \
    cudaError_t e_ = (expr);               \
    if (e_ != cudaSuccess) return (int)e_; \
  } while (0)

static int classic_pack(const ClassicArgs& a, cudaStream_t st) {
  if (a.nw != a.trunk + 4 || a.nw > NKC_MAX_LAYERS || a.hidden > 128)
    return (int)cudaErrorInvalidValue;
  nkc_pack_kernel<<<dim3(a.nw, 16), 256, 0, st>>>(a);
  return (int)cudaGetLastError();
}

static size_t tile_smem(const ClassicArgs& a) {
  return (size_t)2 * a.buf_rows * NKC_P * sizeof(float);
}

extern "C" int nkt_classic_forward(const ClassicArgs* args, void* stream) {
  const ClassicArgs& a = *args;
  cudaStream_t st = (cudaStream_t)stream;
  if (a.n <= 0) return 0;
  const int rc = classic_pack(a, st);
  if (rc) return rc;
  const size_t bytes = tile_smem(a);
  NKC_CHECK(cudaFuncSetAttribute(nkc_forward_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)bytes));
  const long long tiles = (a.n + NKC_P - 1) / NKC_P;
  nkc_forward_kernel<<<(unsigned)tiles, NKC_THREADS, bytes, st>>>(a);
  return (int)cudaGetLastError();
}

extern "C" int nkt_classic_backward(const ClassicArgs* args, void* stream) {
  const ClassicArgs& a = *args;
  cudaStream_t st = (cudaStream_t)stream;
  if (a.n <= 0 || a.n_part < 1) return (int)cudaErrorInvalidValue;
  int rc = classic_pack(a, st);
  if (rc) return rc;
  const size_t bytes = tile_smem(a);
  NKC_CHECK(cudaFuncSetAttribute(nkc_bwd_tile_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)bytes));
  const long long tiles = (a.n + NKC_P - 1) / NKC_P;
  nkc_bwd_tile_kernel<<<(unsigned)tiles, NKC_THREADS, bytes, st>>>(a);
  NKC_CHECK(cudaGetLastError());

  // weight gradients: 32-point tiles, per-block partial sums
  const int t = a.trunk;
  const long long wt = (a.n + 31) / 32;
  const int blocks = (int)(wt < a.n_part ? wt : a.n_part);
  for (int L = 0; L < a.nw; ++L) {
    const float* G = L == t        ? a.g + 3 * a.n  // fc_alpha: g row 3
                     : L == t + 3  ? a.g            // fc_rgb: g rows 0-2
                                   : a.gs + (long long)a.gs_row[L] * a.n;
    rc = nkt_wgrad_launch(a.act + (long long)a.act_row[L] * a.n, G, a.n,
                          a.in_dim[L], a.out_dim[L], a.rnd[L], a.partial,
                          a.grad_total, a.dw_off[L], a.db_off[L], blocks, st);
    if (rc) return rc;
  }
  return nkt_reduce_partials_launch(a.partial, a.flat, a.grad_total, blocks,
                                    st);
}
