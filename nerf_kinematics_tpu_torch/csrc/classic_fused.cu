// Fused classic-NeRF point pipeline: the forward and its gradient.
//
// Replaces the TPU kernels of nerf_kinematics_tpu/ops/classic_fused_pallas.py:
//   classic_fused_apply_cf forward (_fwd_kernel)  -> nkt_classic_forward
//   classic_fused_apply_cf VJP     (_bwd_kernel)  -> nkt_classic_backward
//
// What one point costs: gamma(xyz) (63 rows at L = 10) -> a trunk of
// num_layers // 2 dense layers of `hidden` with ReLU -> a raw sigma head, and
// a feature layer whose output, with gamma(dir), feeds a half-width direction
// layer and the rgb head. At hidden 128 that is 83 840 multiply-adds a point
// (167.7 kFLOP; three times that for the gradient), against 40 B of IO a
// point and 330 KB of f32 weights that stay resident in L2.
//
// f32 mode (the shipped configs) runs the products on the tensor cores in
// 3xTF32 (the forward with tc = 1, the gradient's cotangents and weight
// products): an f32 operand a is split into a_hi = cvt.rna.tf32(a) and a_lo =
// cvt.rna.tf32(a - a_hi) (exact with -fmad=false), and a * b is taken as
// a_lo * b_hi + a_hi * b_lo + a_hi * b_hi by mma.sync.m16n8k8 (TF32 operands,
// f32 accumulation), the small terms first. One TF32 product keeps about
// three decimal digits, which the f32 tolerances (1e-4 of a row's largest
// output, 2e-4 of a gradient leaf's largest entry) would not pass; the split
// keeps about 22 bits of each operand, near f32, at a third of the TF32 rate
// (495 / 3 = 165 TFLOP/s against the FMA pipe's 67). So both kernels are
// bound by operations at that rate; the gradient's weight products also read
// the saved inputs and cotangents (act, gs: about 1 500 f32 rows a point,
// written once and read once), which at 131 072 points take longer than its
// products at 165 TFLOP/s. The gradient's forward with saves stays on the
// FMA pipe (nkc_bwd_tile below says why): a third of its operations. So
// does a forward whose gradient is taken (the host passes tc = 0): its
// outputs and the gradient's masks then come from one forward.
//
// Design. The TPU kernel holds a block of 4096 points in VMEM. Here the
// weights alone (330 KB) exceed the 227 KB a block may use, and a thread that
// held a 128-wide activation plus its accumulators would spill. So a block of
// 256 threads owns a tile of NKC_P = 64 points, whose activations live in
// shared memory as (features, points) in two ping-pong buffers. A layer is
// the product (outputs x inputs) . (inputs x 64 points): warp w takes the
// 16 outputs of m-tile w and all 64 points (m-tile w % 4 and 32 points when
// there are at most 64 outputs). The weights are split and packed once per
// call by nkc_pack_kernel into the A fragments of mma.m16n8k8, hi and lo
// (a lane's 8 words of a 16 x 8 tile contiguous), so a lane reads a tile's
// fragments as two 16-byte loads through L1, the next k-tile's ahead of the
// products; the activations are split as they are read from shared memory.
// The bias is added in f32 after the sum, then the ReLU. The two heads
// (sigma: 1 output, rgb: 3) are f32 fused multiply-add chains.
//
// The sin / cos of the encoding are the full-precision sinf / cosf: with
// L = 10 their arguments reach thousands of radians, where the fast
// intrinsics lose every digit.
//
// bf16 mode (compute_dtype bfloat16, which no shipped classic config uses)
// keeps the FMA kernels unchanged (nkc_forward_kernel, nkc_bwd_tile_kernel,
// then per layer nkt_wgrad_launch of csrc/ngp_fused_bwd.cu) and the TPU
// kernel's cast points: a layer with 16 or more outputs rounds its weights
// and its input to bf16 and accumulates in f32; the heads stay f32, and so
// do their backward products. Biases are f32. There a thread (jg = tid / 16,
// pg = tid % 16) computes outputs jg*JT .. jg*JT+JT-1 for points pg*4 ..
// pg*4+3 (JT = 8 for 128 outputs, 4 for up to 64) with f32 fused
// multiply-adds over the input in ascending order.
//
// The gradient keeps the route of the NGP gradient kernels: the TPU kernel
// adds every block's parameter gradients into one resident accumulator,
// relying on grid steps that run in order, while CUDA blocks run at once.
//   1. nkc_pack_kernel: weights into the packed layouts, biases.
//   2. nkc_tc_bwd_tile_kernel: per tile, the forward again on the FMA body
//      (the plain version's order of sums, so the same ReLU masks), saving
//      every layer's f32 input to `act`; then the cotangent back through the
//      layers in shared memory (d_inp = W g on the 3xTF32 products, masked
//      by the ReLU read back from `act`), saving each layer's masked f32
//      cotangent to `gs`.
//   3. nkc_tc_wgrad_kernel, one launch for every layer: the grid runs over
//      (point chunk, job), a job being at most 128 inputs x 128 outputs of a
//      layer. A block walks its chunk in 32-point stages that cp.async
//      double-buffers into shared memory from act and the cotangent (gs, or
//      g for the heads) and takes dW = A G^T on the 3xTF32 products; db is
//      the f32 sum of G in point order. Each block writes its sums to its
//      row of `partial`.
//   4. nkt_reduce_partials_launch adds the rows of `partial` in row order,
//      so the gradients are deterministic.
// Positions and directions get no cotangent, as in the reference.
#include <stdint.h>

#include "nkt_mma.cuh"

#define NKC_MAX_LAYERS 16
#define NKC_PACK_Y 16  // pack blocks a layer
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
  float* tf;    // f32 mode: A fragments of W^T (outputs x inputs), hi and lo
  float* tb;    // f32 mode: A fragments of W (the first wb_cols inputs x
                // outputs), hi and lo
  unsigned* nonfinite;  // f32 mode: one word a pack block (nw * NKC_PACK_Y),
                        // the launch's own: "a non-finite input"
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
  int tf_off[NKC_MAX_LAYERS];  // first float of layer L's forward fragments
  int tb_off[NKC_MAX_LAYERS];  // first float of its backward fragments
  int tc;                      // 1: f32 mode, 3xTF32 on the tensor cores
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

// ---------------------------------------------------------------------------
// f32 mode: 3xTF32 on the tensor cores.
//
// The split, the TF32 product and the fragments of mma.m16n8k8 are in
// nkt_mma.cuh (nkt_tf32_split, nkt_mma_tf32), shared with the line tables'
// gradient (csrc/cp_encode.cu). A packed A tile is 256 floats: lane l's hi
// a0..a3, then its lo a0..a3.
#define NKC_LDP 72      // words per row of the activation buffers (64 + 8)
#define NKC_FRAG 256    // floats of one packed 16 x 8 A tile, hi and lo
#define NKC_WARPS (NKC_THREADS / 32)

// acc[j] = the packed A tiles `frag` (KT k-tiles of one m-tile) times rows
// [0, 8 KT) of the (rows, NKC_LDP) buffer in_s at the points of n-tile
// nt0 + j, for j < NT. The fragments of the next two k-tiles are in flight
// while a k-tile's products run. A k-tile's three products go into a
// partial started from zero (small terms first), which is added to the f32
// sum with a rounded add: the tensor cores' own adds truncate, and a sum
// chained through 3 KT of them drifts from the plain version's (enough to
// flip the density noise's ReLU for a few samples of a train step).
template <int NT, bool SAFE>
__device__ __forceinline__ void nkc_tc_product(const float* __restrict__ frag,
                                               int KT, const float* in_s,
                                               int nt0, float (*acc)[4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < NT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;
  const float4* fp = reinterpret_cast<const float4*>(frag) + lane * 2;
  constexpr int FS = NKC_FRAG / 4;  // float4 of one packed tile
  float4 h0 = __ldg(fp), l0 = __ldg(fp + 1);
  float4 h1 = h0, l1 = l0;
  if (KT > 1) {
    h1 = __ldg(fp + FS);
    l1 = __ldg(fp + FS + 1);
  }
  for (int kt = 0; kt < KT; ++kt) {
    const uint32_t ah[4] = {__float_as_uint(h0.x), __float_as_uint(h0.y),
                            __float_as_uint(h0.z), __float_as_uint(h0.w)};
    const uint32_t al[4] = {__float_as_uint(l0.x), __float_as_uint(l0.y),
                            __float_as_uint(l0.z), __float_as_uint(l0.w)};
    h0 = h1;
    l0 = l1;
    if (kt + 2 < KT) {
      h1 = __ldg(fp + (kt + 2) * FS);
      l1 = __ldg(fp + (kt + 2) * FS + 1);
    }
    const float* r0 = in_s + (kt * 8 + t) * NKC_LDP + nt0 * 8 + g;
    const float* r1 = r0 + 4 * NKC_LDP;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      uint32_t bh0, bl0, bh1, bl1;
      nkt_tf32_split_t<SAFE>(r0[j * 8], bh0, bl0);
      nkt_tf32_split_t<SAFE>(r1[j * 8], bh1, bl1);
      float p[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      nkt_mma_tf32(p, al, bh0, bh1);
      nkt_mma_tf32(p, ah, bl0, bl1);
      nkt_mma_tf32(p, ah, bh0, bh1);
      acc[j][0] = acc[j][0] + p[0];
      acc[j][1] = acc[j][1] + p[1];
      acc[j][2] = acc[j][2] + p[2];
      acc[j][3] = acc[j][3] + p[3];
    }
  }
}

// One layer of the tile on the tensor cores: the product of the packed A
// tiles `frag` (O rows, KT k-tiles) with the (rows, NKC_LDP) buffer in_s,
// then f(j, p, sum) for every output j < O and point p of the tile. Up to
// 64 outputs: warp w takes m-tile w % 4 and the 32 points of half w / 4.
template <bool SAFE, typename F>
__device__ __forceinline__ void nkc_tc_layer(const float* frag, int KT, int O,
                                             const float* in_s, F f) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int MT = (O + 15) / 16;
  if (MT > 4) {
    for (int mt = warp; mt < MT; mt += NKC_WARPS) {
      float acc[8][4];
      nkc_tc_product<8, SAFE>(frag + mt * KT * NKC_FRAG, KT, in_s, 0, acc);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int o = mt * 16 + g + (e >> 1) * 8;
          if (o < O) f(o, j * 8 + 2 * t + (e & 1), acc[j][e]);
        }
    }
  } else {
    const int mt = warp & 3, nt0 = (warp >> 2) * 4;
    if (mt < MT) {
      float acc[4][4];
      nkc_tc_product<4, SAFE>(frag + mt * KT * NKC_FRAG, KT, in_s, nt0, acc);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int o = mt * 16 + g + (e >> 1) * 8;
          if (o < O) f(o, (nt0 + j) * 8 + 2 * t + (e & 1), acc[j][e]);
        }
    }
  }
}

// Layer L's forward product: 3xTF32 in f32 mode (TC), else the FMA body.
template <bool TC, bool SAFE, typename F>
__device__ __forceinline__ void nkc_fwd_layer(const ClassicArgs& a, int L,
                                              int K, const float* in_s, F f) {
  if constexpr (TC)
    nkc_tc_layer<SAFE>(a.tf + a.tf_off[L], (K + 7) / 8, a.out_dim[L], in_s, f);
  else
    nkc_layer(a.wf + a.wf_off[L], a.wf_ld[L], K, in_s, a.out_dim[L], f);
}

__device__ __forceinline__ float nkc_round(bool r, float v) {
  return r ? nkt_bf16r(v) : v;
}

// Forward of the tile at `base`. SAVE: write every layer's f32 input to
// a.act and stop before the heads; else write the heads to a.out. TC: the
// products in 3xTF32 on the tensor cores (f32 mode), buffer rows NKC_LDP
// words apart; else the FMA body (bf16 mode), rows NKC_P words apart.
template <bool SAVE, bool TC, bool SAFE = false>
__device__ void nkc_forward_tile(const ClassicArgs& a, long long base,
                                 float* bufA, float* bufB) {
  constexpr int LDB = TC ? NKC_LDP : NKC_P;
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
    bufA[r * LDB + p] = nkc_round(a.rnd[0], v);
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
    nkc_fwd_layer<TC, SAFE>(a, L, a.in_dim[L], cur, [&](int j, int p, float s) {
                const float v = nkt_relu(s + bias[j]);
                const long long i = base + p;
                if (SAVE && i < n) a.act[(long long)(save_row + j) * n + i] = v;
                dst[j * LDB + p] = nkc_round(rn, v);
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
      s = __fmaf_rn(wa[k * lda], cur[k * LDB + tid], s);
    if (i < n) a.out[3 * n + i] = s + a.bias[a.b_off[LA]];
  }
  if (!TC && a.rnd[LF]) {
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
    nkc_fwd_layer<TC, SAFE>(a, LF, H, cur, [&](int j, int p, float s) {
                const float v = nkt_relu(s + bias[j]);
                const long long i = base + p;
                if (SAVE && i < n) a.act[(long long)(row + j) * n + i] = v;
                dst[j * LDB + p] = nkc_round(rn, v);
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
      dst[(H + r) * LDB + p] = nkc_round(rn, v);
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
    nkc_fwd_layer<TC, SAFE>(a, LD, a.in_dim[LD], cur, [&](int j, int p, float s) {
                const float v = nkt_relu(s + bias[j]);
                const long long i = base + p;
                if (SAVE && i < n) a.act[(long long)(row + j) * n + i] = v;
                dst[j * LDB + p] = v;
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
      s = __fmaf_rn(wr[k * lda], cur[k * LDB + p], s);
    if (i < n) a.out[o * n + i] = s + a.bias[a.b_off[LR] + o];
  }
}

// Layer L (blockIdx.x) into the packed layouts; blockIdx.y strides. In f32
// mode also the 3xTF32 A fragments: forward W^T (outputs x inputs) and
// backward W (the first wb_cols inputs x outputs), zero padded to whole
// 16 x 8 tiles.
// A non-finite value among a launch's inputs (points, directions, the
// cotangent, the weights and biases): the pack kernel, which reads the
// weights anyway, also reads the point-wise inputs, and each of its blocks
// writes whether it found one to the launch's a.nonfinite. The 3xTF32
// kernels read those words and take either the finite split
// (nkt_tf32_split_finite) or the one that carries NaN and inf through their
// products as the plain version's f32 products do; the finite split is two
// integer operations fewer a value, and taking the other everywhere made
// row 9 a third slower (PERF.md).
__device__ __forceinline__ bool nkc_safe(const unsigned* nonfinite, int words) {
  int bad = 0;
  for (int e = threadIdx.x; e < words; e += blockDim.x) bad |= nonfinite[e] != 0u;
  return __syncthreads_or(bad) != 0;
}

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
  bool bad = false;  // a non-finite input (read unrounded)
  for (int e = first; e < in * ldf; e += step) {
    const int k = e / ldf, j = e % ldf;
    const float w = j < out ? W[k * sk + j * sj] : 0.0f;
    bad |= !isfinite(w);
    wf[e] = nkc_round(rn, w);
  }
  const int ldb = a.wb_ld[L], cols = a.wb_cols[L];
  float* wb = a.wb + a.wb_off[L];
  for (int e = first; e < out * ldb && cols > 0; e += step) {
    const int j = e / ldb, k = e % ldb;
    wb[e] = k < cols ? nkc_round(rn, W[k * sk + j * sj]) : 0.0f;
  }
  for (int j = first; j < out; j += step) {
    const float v = a.b[L][j * a.b_s[L]];
    bad |= !isfinite(v);
    a.bias[a.b_off[L] + j] = v;
  }
  if (!a.tc) return;
  // the point-wise inputs, over all the blocks
  const long long pt = ((long long)L * gridDim.y + blockIdx.y) * blockDim.x + threadIdx.x;
  const long long ps = (long long)gridDim.x * gridDim.y * blockDim.x;
  for (long long i = pt; i < 3 * a.n; i += ps)
    bad |= !isfinite(a.xt[i]) || !isfinite(a.vdt[i]);
  if (a.g)
    for (long long i = pt; i < 4 * a.n; i += ps) bad |= !isfinite(a.g[i]);
  bad = __syncthreads_or(bad);
  if (threadIdx.x == 0) a.nonfinite[L * gridDim.y + blockIdx.y] = bad ? 1u : 0u;
  // fragment e: tile f = e / NKC_FRAG (m-tile f / KT, k-tile f % KT), lane
  // w / 8, slot w % 8 (hi a0..a3, lo a0..a3)
  for (int pass = 0; pass < 2; ++pass) {
    const int rows = pass == 0 ? out : cols, ks = pass == 0 ? in : out;
    const int KT = (ks + 7) / 8, MT = (rows + 15) / 16;
    float* dst = pass == 0 ? a.tf + a.tf_off[L] : a.tb + a.tb_off[L];
    for (int e = first; e < MT * KT * NKC_FRAG && rows > 0; e += step) {
      const int f = e / NKC_FRAG, w = e % NKC_FRAG;
      const int ln = w >> 3, sl = w & 7, q = sl & 3;
      const int r = (f / KT) * 16 + (ln >> 2) + (q & 1) * 8;
      const int c = (f % KT) * 8 + (ln & 3) + (q >> 1) * 4;
      float v = 0.0f;
      if (r < rows && c < ks)  // forward: W^T[r][c]; backward: W[r][c]
        v = pass == 0 ? W[c * sk + r * sj] : W[r * sk + c * sj];
      uint32_t hi, lo;
      nkt_tf32_split(v, hi, lo);
      dst[e] = __uint_as_float(sl < 4 ? hi : lo);
    }
  }
}

// Rows of each activation buffer of the tensor-core kernels: buf_rows
// rounded up to a whole k-tile, the padding zero.
__host__ __device__ __forceinline__ int nkc_tc_rows(const ClassicArgs& a) {
  return (a.buf_rows + 7) & ~7;
}

__global__ void __launch_bounds__(NKC_THREADS, 2)
    nkc_forward_kernel(ClassicArgs a) {
  extern __shared__ float4 nkc_smem4[];
  float* smem = reinterpret_cast<float*>(nkc_smem4);
  nkc_forward_tile<false, false>(a, (long long)blockIdx.x * NKC_P, smem,
                                 smem + a.buf_rows * NKC_P);
}

__global__ void __launch_bounds__(NKC_THREADS, 2)
    nkc_tc_forward_kernel(ClassicArgs a) {
  extern __shared__ float4 nkc_smem4[];
  float* smem = reinterpret_cast<float*>(nkc_smem4);
  const int rows = nkc_tc_rows(a);
  for (int e = threadIdx.x; e < 2 * rows * NKC_LDP; e += NKC_THREADS)
    smem[e] = 0.0f;
  __syncthreads();
  const long long base = (long long)blockIdx.x * NKC_P;
  if (nkc_safe(a.nonfinite, a.nw * NKC_PACK_Y))
    nkc_forward_tile<false, true, true>(a, base, smem, smem + rows * NKC_LDP);
  else
    nkc_forward_tile<false, true, false>(a, base, smem, smem + rows * NKC_LDP);
}

// The forward of the tile with its saves, then the cotangent back to the
// output of layer1: every layer's masked f32 cotangent goes to a.gs. The
// forward is the FMA body in both modes: its sums run in the plain
// version's order, so the ReLU masks read back from `act` are the plain
// version's. A forward in 3xTF32 differs from it by about 1e-6 of a value,
// which flips the mask of the few pre-activations that close to 0, and a
// flipped mask moves that point's whole contribution (about 1e-3 of a
// gradient leaf at 8192 points). TC: the cotangent products in 3xTF32
// (f32 mode), buffer rows NKC_LDP words apart; the forward's buffers are
// laid out for the FMA body over the same shared memory.
template <bool TC, bool SAFE = false>
__device__ void nkc_bwd_tile(const ClassicArgs& a, float* smem) {
  constexpr int LDB = TC ? NKC_LDP : NKC_P;
  const long long base = (long long)blockIdx.x * NKC_P;
  nkc_forward_tile<true, false>(a, base, smem, smem + a.buf_rows * NKC_P);
  __syncthreads();  // the saves are read back below as ReLU masks
  float* bufA = smem;
  float* bufB = smem + (TC ? nkc_tc_rows(a) * NKC_LDP : a.buf_rows * NKC_P);

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
    auto f = [&](int j, int p, float s) {
      const long long i = base + p;
      float m = 0.0f;
      if (i < n) {
        if (add_sigma) s = s + wa[j * lda] * a.g[3 * n + i];
        if (act[(long long)(mrow + j) * n + i] > 0.0f) m = s;
        gs[(long long)(grow + j) * n + i] = m;
      }
      dst[j * LDB + p] = nkc_round(rn, m);
    };
    if constexpr (TC)
      nkc_tc_layer<SAFE>(a.tb + a.tb_off[L], (a.out_dim[L] + 7) / 8, a.wb_cols[L],
                   in, f);
    else
      nkc_layer(a.wb + a.wb_off[L], a.wb_ld[L], a.out_dim[L], in,
                a.wb_cols[L], f);
    __syncthreads();
  };

  // g_rgb (f32: the rgb head never rounds); on the tensor cores its k-tile
  // of 8 rows, rows 3-7 zero
  for (int e = tid; e < (TC ? 8 : 3) * NKC_P; e += NKC_THREADS) {
    const int o = e / NKC_P, p = e % NKC_P;
    const long long i = base + p;
    bufA[o * LDB + p] = o < 3 && i < n ? a.g[o * n + i] : 0.0f;
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

__global__ void __launch_bounds__(NKC_THREADS, 2)
    nkc_bwd_tile_kernel(ClassicArgs a) {
  extern __shared__ float4 nkc_smem4[];
  nkc_bwd_tile<false>(a, reinterpret_cast<float*>(nkc_smem4));
}

// Every buffer row the cotangent products read is written first (rows 3-7
// of g_rgb's k-tile by the loop above them), so nothing is zeroed here.
// The non-finite instance apart (not inlined): its registers do not weigh
// on the finite one's, which runs as it did alone.
static __device__ __noinline__ void nkc_tc_bwd_tile_safe(const ClassicArgs a,
                                                          float* smem) {
  nkc_bwd_tile<true, true>(a, smem);
}

__global__ void __launch_bounds__(NKC_THREADS, 2)
    nkc_tc_bwd_tile_kernel(ClassicArgs a) {
  extern __shared__ float4 nkc_smem4[];
  float* smem = reinterpret_cast<float*>(nkc_smem4);
  if (nkc_safe(a.nonfinite, a.nw * NKC_PACK_Y))
    nkc_tc_bwd_tile_safe(a, smem);
  else
    nkc_bwd_tile<true, false>(a, smem);
}

// ---------------------------------------------------------------------------
// f32 mode: the weight gradients of every layer in one launch.
//
// dW (K x J) = A (K x n) . G^T (n x J) in 3xTF32 and db = sum of G in f32, A
// a layer's saved input (act) and G its masked output cotangent (gs; g for
// the heads), rows n points apart. A job is at most NKC_WG_RC inputs x
// NKC_WG_RC outputs of one layer; the grid runs over (point chunk, job). A
// block's warps tile its job (up to 32 inputs x 64 outputs each, 64
// accumulators a thread) and walk the chunk in 32-point stages that
// cp.async (4-byte copies: rows start anywhere) double-buffers into shared
// memory; each block writes its sums to its row of `partial`.
#define NKC_WG_TP 32        // points per stage
#define NKC_WG_LD 36        // words per row of a stage's tiles (32 + 4)
#define NKC_WG_RC 128       // inputs (outputs) of a job
#define NKC_WG_MAX_JOBS 32
#define NKC_WG_STAGE (2 * NKC_WG_RC * NKC_WG_LD)  // floats: A rows, G rows

struct NkcWgJob {
  const float* A;  // the job's first input row
  const float* G;  // the job's first cotangent row
  int Kc, Jc;      // rows of A and of G in the job
  int w_off;       // flat index of the job's dW[k0][j0]
  int J;           // the layer's output width, the row stride of its dW
  int b_off;       // flat index of db[j0]; -1: another job of these columns
};

struct NkcWgPlan {
  NkcWgJob job[NKC_WG_MAX_JOBS];
  int n_jobs;
  int total;        // floats in a row of partial
  long long n;      // points, the row stride of A and G
  long long chunk;  // points per block, a multiple of NKC_WG_TP
};

__device__ __forceinline__ void nkc_cp_async4(float* dst, const float* src,
                                              int bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void nkc_cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void nkc_cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <bool SAFE>
__device__ __forceinline__ void nkc_tc_wgrad_body(const NkcWgPlan& plan,
                                                  float* __restrict__ partial) {
  extern __shared__ float4 nkc_smem4[];
  float* sm = reinterpret_cast<float*>(nkc_smem4);
  const NkcWgJob jb = plan.job[blockIdx.y];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  for (int e = tid; e < 2 * NKC_WG_STAGE; e += NKC_THREADS) sm[e] = 0.0f;
  __syncthreads();  // rows past Kc / Jc stay zero

  // The warp's share: mc m-tiles of 16 inputs from m0, ncn n-tiles of 8
  // outputs from n0.
  const int Kc = jb.Kc, Jc = jb.Jc;
  const int mt = (Kc + 15) / 16, ntt = (Jc + 7) / 8;
  const int mc = mt > 1 ? 2 : 1;
  const int gm = (mt + mc - 1) / mc;
  const int gn = NKC_WARPS / gm;
  const int ncn = (ntt + gn - 1) / gn;
  const int m0 = (warp % gm) * mc, n0 = (warp / gm) * ncn;
  const bool active = warp / gm < gn;
  const bool do_db = jb.b_off >= 0 && tid < Jc;

  float acc[2][8][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
      acc[mi][nt][0] = acc[mi][nt][1] = acc[mi][nt][2] = acc[mi][nt][3] = 0.0f;
  float dbacc = 0.0f;

  const long long n = plan.n;
  const long long pb = (long long)blockIdx.x * plan.chunk;
  const long long pe = pb + plan.chunk < n ? pb + plan.chunk : n;

  auto load = [&](int s, long long p) {
    float* As = sm + s * NKC_WG_STAGE;
    float* Gs = As + NKC_WG_RC * NKC_WG_LD;
    for (int e = tid; e < Kc * NKC_WG_TP; e += NKC_THREADS) {
      const int k = e >> 5, q = e & 31;
      const bool in = p + q < pe;
      nkc_cp_async4(As + k * NKC_WG_LD + q, jb.A + (long long)k * n + (in ? p + q : p),
                    in ? 4 : 0);
    }
    for (int e = tid; e < Jc * NKC_WG_TP; e += NKC_THREADS) {
      const int j = e >> 5, q = e & 31;
      const bool in = p + q < pe;
      nkc_cp_async4(Gs + j * NKC_WG_LD + q, jb.G + (long long)j * n + (in ? p + q : p),
                    in ? 4 : 0);
    }
    nkc_cp_commit();
  };

  int s = 0;
  if (pb < pe) load(0, pb);
  for (long long p = pb; p < pe; p += NKC_WG_TP) {
    if (p + NKC_WG_TP < pe) {
      load(s ^ 1, p + NKC_WG_TP);
      nkc_cp_wait<1>();
    } else {
      nkc_cp_wait<0>();
    }
    __syncthreads();
    const float* As = sm + s * NKC_WG_STAGE;
    const float* Gs = As + NKC_WG_RC * NKC_WG_LD;
    if (active) {
#pragma unroll
      for (int ks = 0; ks < NKC_WG_TP / 8; ++ks) {
        uint32_t ah[2][4], al[2][4];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          const float* ar = As + ((m0 + mi) * 16 + g) * NKC_WG_LD + ks * 8 + t;
          const bool ok = mi < mc && m0 + mi < mt;
          nkt_tf32_split_t<SAFE>(ok ? ar[0] : 0.0f, ah[mi][0], al[mi][0]);
          nkt_tf32_split_t<SAFE>(ok ? ar[8 * NKC_WG_LD] : 0.0f, ah[mi][1], al[mi][1]);
          nkt_tf32_split_t<SAFE>(ok ? ar[4] : 0.0f, ah[mi][2], al[mi][2]);
          nkt_tf32_split_t<SAFE>(ok ? ar[8 * NKC_WG_LD + 4] : 0.0f, ah[mi][3], al[mi][3]);
        }
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          if (nt < ncn && n0 + nt < ntt) {
            const float* gr = Gs + ((n0 + nt) * 8 + g) * NKC_WG_LD + ks * 8 + t;
            uint32_t bh0, bl0, bh1, bl1;
            nkt_tf32_split_t<SAFE>(gr[0], bh0, bl0);
            nkt_tf32_split_t<SAFE>(gr[4], bh1, bl1);
#pragma unroll
            for (int mi = 0; mi < 2; ++mi) {
              if (mi < mc && m0 + mi < mt) {
                nkt_mma_tf32(acc[mi][nt], al[mi], bh0, bh1);
                nkt_mma_tf32(acc[mi][nt], ah[mi], bl0, bl1);
                nkt_mma_tf32(acc[mi][nt], ah[mi], bh0, bh1);
              }
            }
          }
        }
      }
    }
    if (do_db) {
      const float* gr = Gs + tid * NKC_WG_LD;
      for (int q = 0; q < NKC_WG_TP; ++q) dbacc += gr[q];
    }
    __syncthreads();
    s ^= 1;
  }

  float* mine = partial + (long long)blockIdx.x * plan.total;
  if (active) {
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
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

__global__ void __launch_bounds__(NKC_THREADS, 2)
    nkc_tc_wgrad_kernel(NkcWgPlan plan, float* __restrict__ partial,
                        const unsigned* __restrict__ nonfinite, int words) {
  if (nkc_safe(nonfinite, words))
    nkc_tc_wgrad_body<true>(plan, partial);
  else
    nkc_tc_wgrad_body<false>(plan, partial);
}

#define NKC_CHECK(expr)                    \
  do {                                     \
    cudaError_t e_ = (expr);               \
    if (e_ != cudaSuccess) return (int)e_; \
  } while (0)

static int classic_pack(const ClassicArgs& a, cudaStream_t st) {
  if (a.nw != a.trunk + 4 || a.nw > NKC_MAX_LAYERS || a.hidden > 128 ||
      (a.tc && !a.nonfinite))
    return (int)cudaErrorInvalidValue;
  nkc_pack_kernel<<<dim3(a.nw, NKC_PACK_Y), 256, 0, st>>>(a);
  return (int)cudaGetLastError();
}

// Bytes of shared memory of the tile kernels.
static size_t tile_smem(const ClassicArgs& a) {
  if (a.tc) return (size_t)2 * nkc_tc_rows(a) * NKC_LDP * sizeof(float);
  return (size_t)2 * a.buf_rows * NKC_P * sizeof(float);
}

extern "C" int nkt_classic_forward(const ClassicArgs* args, void* stream) {
  const ClassicArgs& a = *args;
  cudaStream_t st = (cudaStream_t)stream;
  if (a.n <= 0) return 0;
  const int rc = classic_pack(a, st);
  if (rc) return rc;
  const size_t bytes = tile_smem(a);
  const long long tiles = (a.n + NKC_P - 1) / NKC_P;
  if (a.tc) {
    NKC_CHECK(cudaFuncSetAttribute(nkc_tc_forward_kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)bytes));
    nkc_tc_forward_kernel<<<(unsigned)tiles, NKC_THREADS, bytes, st>>>(a);
  } else {
    NKC_CHECK(cudaFuncSetAttribute(nkc_forward_kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)bytes));
    nkc_forward_kernel<<<(unsigned)tiles, NKC_THREADS, bytes, st>>>(a);
  }
  return (int)cudaGetLastError();
}

// The f32 weight gradients: every layer's jobs in one launch, then the sum
// of the chunks' rows of partial in order.
static int classic_wgrad_tc(const ClassicArgs& a, cudaStream_t st) {
  const int t = a.trunk;
  NkcWgPlan p;
  p.n_jobs = 0;
  p.total = a.grad_total;
  p.n = a.n;
  for (int L = 0; L < a.nw; ++L) {
    const float* A = a.act + (long long)a.act_row[L] * a.n;
    const float* G = L == t        ? a.g + 3 * a.n  // fc_alpha: g row 3
                     : L == t + 3  ? a.g            // fc_rgb: g rows 0-2
                                   : a.gs + (long long)a.gs_row[L] * a.n;
    const int K = a.in_dim[L], J = a.out_dim[L];
    for (int k0 = 0; k0 < K; k0 += NKC_WG_RC) {
      for (int j0 = 0; j0 < J; j0 += NKC_WG_RC) {
        if (p.n_jobs >= NKC_WG_MAX_JOBS) return (int)cudaErrorInvalidValue;
        NkcWgJob& jb = p.job[p.n_jobs++];
        jb.A = A + (long long)k0 * a.n;
        jb.G = G + (long long)j0 * a.n;
        jb.Kc = K - k0 < NKC_WG_RC ? K - k0 : NKC_WG_RC;
        jb.Jc = J - j0 < NKC_WG_RC ? J - j0 : NKC_WG_RC;
        jb.w_off = a.dw_off[L] + k0 * J + j0;
        jb.J = J;
        jb.b_off = k0 == 0 ? a.db_off[L] + j0 : -1;
      }
    }
  }
  const long long stages = (a.n + NKC_WG_TP - 1) / NKC_WG_TP;
  const long long want = stages < a.n_part ? stages : a.n_part;
  p.chunk = (stages + want - 1) / want * NKC_WG_TP;
  const int chunks = (int)((a.n + p.chunk - 1) / p.chunk);
  const size_t bytes = (size_t)2 * NKC_WG_STAGE * sizeof(float);
  NKC_CHECK(cudaFuncSetAttribute(nkc_tc_wgrad_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)bytes));
  nkc_tc_wgrad_kernel<<<dim3((unsigned)chunks, (unsigned)p.n_jobs), NKC_THREADS,
                        bytes, st>>>(p, a.partial, a.nonfinite,
                                     a.nw * NKC_PACK_Y);
  NKC_CHECK(cudaGetLastError());
  return nkt_reduce_partials_launch(a.partial, a.flat, a.grad_total, chunks,
                                    st);
}

extern "C" int nkt_classic_backward(const ClassicArgs* args, void* stream) {
  const ClassicArgs& a = *args;
  cudaStream_t st = (cudaStream_t)stream;
  if (a.n <= 0 || a.n_part < 1) return (int)cudaErrorInvalidValue;
  int rc = classic_pack(a, st);
  if (rc) return rc;
  const size_t bytes = tile_smem(a);
  const long long tiles = (a.n + NKC_P - 1) / NKC_P;
  if (a.tc) {
    NKC_CHECK(cudaFuncSetAttribute(nkc_tc_bwd_tile_kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)bytes));
    nkc_tc_bwd_tile_kernel<<<(unsigned)tiles, NKC_THREADS, bytes, st>>>(a);
    NKC_CHECK(cudaGetLastError());
    return classic_wgrad_tc(a, st);
  }
  NKC_CHECK(cudaFuncSetAttribute(nkc_bwd_tile_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)bytes));
  nkc_bwd_tile_kernel<<<(unsigned)tiles, NKC_THREADS, bytes, st>>>(a);
  NKC_CHECK(cudaGetLastError());

  // bf16 mode: weight gradients per layer, 32-point tiles, per-block
  // partial sums
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
