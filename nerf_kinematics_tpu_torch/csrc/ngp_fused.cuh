// Fused NGP point pipeline, device code shared by the forward kernels
// (ngp_fused.cu) and the gradient kernels (ngp_fused_bwd.cu): CP encode ->
// density MLP -> sigma = exp(clip(z0, +-15)) [-> SH degree 4 of the view
// direction -> color MLP -> rgb logits].
//
// Channels-first IO as in the reference's ops/ngp_fused_pallas.py: (3, N)
// points [, (3, N) unit directions] -> (4, N): rows 0-2 rgb logits (zeros for
// the sigma kernel), row 3 sigma.
//
// Arithmetic contract (same as the reference): weights and every layer's
// input are rounded to bf16 when use_bf16, products are accumulated in f32,
// the f32 bias is added after the sum, ReLU between layers and none after
// the last. sigma comes from the f32 feature 0; the color MLP's input is
// [features (rounded), SH4 (rounded)] in that order.
//
// Two bodies compute this, and the mode picks one (nothing falls back):
//
//  * bf16 mode (use_bf16 = 1): nkt_mma_body of nkt_mma.cuh (density only)
//    and nkt_apply_tile_kernel of ngp_apply.cu (with color). Every product
//    runs on the tensor cores (mma.sync.m16n8k16, bf16 in, f32 accumulate);
//    a warp owns a tile of 16 points and chains the layers in shared
//    memory (row 2 keeps the tile's whole encoding there, row 3 one level
//    and the whole in a slot of device memory). The weights come packed in
//    bf16 from the host (about 45 KB density only, 70 KB with color), and
//    the encoders gather a bf16 copy of the line tables.
//    On this card the old f32 body ran at about 14 TFLOP/s, 1.4 % of the
//    bf16 tensor-core peak; the products no longer bound the kernels, the
//    table gathers and (with SAVE) the saved activations do.
//  * f32 mode: nkt_fused_body below, one thread per point with the layer's
//    accumulators in registers, the products on the f32 FMA pipe, every
//    weight read a broadcast 16-byte load from shared memory (one persistent
//    block per SM). Layers 1.. are staged once per block. The first layer
//    is fed by the encoder level by level (level l's C features meet rows
//    [l C, (l + 1) C) of W0). W0 is staged whole, once, where the config's
//    largest f32 launch fits with it (the flagship's 256 x 64); otherwise
//    one level's slice at a time: cp.async copies the next level's slice
//    into the second of two buffers while the block works on the current
//    one (a barrier a level). Whole, fox_ngp.yml's encoder (L 5, C 96: 480
//    x 64 floats) asked for 280 320 B, above the 232 448 B a block may use;
//    sliced, its largest launch (the per-point backward) asks for 206 848 B.
//    Slicing the flagship too made rows 2 and 3 5-7 % slower (PERF.md).
//
// With SAVE the f32 body also writes every layer's input into a (rows, n)
// scratch array in device memory and the f32 feature 0 into an (n,) array:
// what f32 mode's gradient kernels read back. bf16 mode's gradient kernel
// (ngp_fused_bwd.cu) keeps them on chip.
#pragma once

#include "nkt_common.cuh"

#define NKT_THREADS 256
#define NKT_W 64          // widest layer the kernels take; smem row stride
#define NKT_MAX_LAYERS 8  // per MLP
#define NKT_HS 257        // column stride of the f32 backward's per-thread buffer
#define NKT_SMEM_MAX 232448  // bytes of shared memory a block may use

// Mirrors ops/cuda_lib.py::FusedArgs field for field.
struct FusedArgs {
  const float* xt;     // (3, n)
  const float* vdt;    // (3, n), unused by the sigma kernel
  const float* lines;  // (L, 3, T, C)
  const void* lines16; // (L, 3, T, C) bf16 copy of lines (bf16 mode)
  float* out;          // (4, n)
  const float* dW[NKT_MAX_LAYERS];  // (in, out) row-major each
  const float* db[NKT_MAX_LAYERS];  // (out,)
  const float* cW[NKT_MAX_LAYERS];
  const float* cb[NKT_MAX_LAYERS];
  long long n;
  int nd, nc;
  int d_in[NKT_MAX_LAYERS], d_out[NKT_MAX_LAYERS];
  int c_in[NKT_MAX_LAYERS], c_out[NKT_MAX_LAYERS];
  CPLevels cp;
  // bf16 mode: the layers' weights packed for the tensor cores by the host
  // (ops/ngp_fused_cuda.py::mma_pack), offsets and row strides in bf16
  // elements, layer li = density layers then color layers: a block a layer
  // (rows = output columns, the inputs contiguous), density then color. The
  // gradient's products by W^T read the same blocks transposed.
  const void* wpk;
  int pk_off[2 * NKT_MAX_LAYERS], pk_ld[2 * NKT_MAX_LAYERS];
  int pk_dens;  // elements of the density layers' blocks
  int pk_fwd;   // elements of all blocks
  // bf16 mode: slots of device scratch, each the encoding of 16 points (16
  // x L*C bf16), read back to sum a layer-0 output again (row 3's kernel: a
  // warp a slot) and for layer 0's weight gradient (the gradient's tile
  // kernel: P / 16 slots a block). A launch uses at most enc_slots.
  void* enc;
  long long enc_slots;
};

// The gradient kernels' arguments (ngp_fused_bwd.cu; the whole-step call of
// ngp_fused_full.cu wraps them).
// Mirrors ops/cuda_lib.py::BwdArgs field for field.
struct BwdArgs {
  FusedArgs f;         // the forward's arguments; f.out is (4, n) scratch
  const float* g;      // (4, n) cotangent of f.out (the VJP)
  void* act;           // f32 mode: (act_rows, ld) saved layer inputs
  float* z0;           // f32 mode: (ld,) the f32 feature 0
  float* gs;           // f32 mode: (gs_rows, ld) masked cotangent of every layer
  float* partial;      // (n_part, total) per-block sums of the MLP leaves
  float* flat;         // (total,) the MLP leaves' gradients
  float* dlines;       // (L, 3, T, C), written whole by nkt_dlines_launch
  float* denc;         // (n, L*C) f32 cotangent of the encoding (scratch)
  float* lpart;        // (l_chunks, L, 3, T, C) chunk sums of dlines (scratch)
  int l_chunks;        // point chunks of the line-table gradient
  const float* dists;  // (1, n) compositing intervals, ray-major (train)
  const float* tgt;    // (3, R) target pixels (train)
  float* err;          // (1, R) squared error per ray (train)
  float* maps;         // (4, R) rgb map and acc (train)
  float* gbuf;         // (4, n) cotangent of the ray kernel (train: f32 mode,
                       // and bf16 mode where a ray is longer than a tile)
  int S;               // samples per ray (train)
  int white_bg;
  float inv_denom;     // dL/d(rgb_map) = 2 * inv_denom * diff
  int n_part;          // rows of `partial`
  long long ld;        // row stride of act and gs: n (f32 mode; bf16 mode
                       // has neither, and the kernel reads no ld)
};

// Offsets (in floats) into dynamic shared memory.
struct FusedLayout {
  int w_off[2 * NKT_MAX_LAYERS];  // layer weights, [in][NKT_W], zero padded;
                                  // layer 0: the first of its slice buffers
  int b_off[2 * NKT_MAX_LAYERS];  // layer bias, [NKT_W]
  int slice;                      // floats of one slice of W0, [rows][NKT_W]
  int n_slices;                   // 1: W0 whole, staged once; else the levels
  int hs_off;                     // per-thread columns, [NKT_W][stride]
  int total;
};

// True when the config's largest f32 launch (the per-point backward: every
// layer, columns of stride NKT_HS) fits with W0 whole; then every f32 launch
// of the config stages W0 whole, else every one stages it by level.
static bool w0_whole(const FusedArgs& a) {
  long long f = (long long)a.cp.n_levels * a.cp.n_comp * NKT_W + NKT_W * NKT_HS;
  for (int li = 0; li < a.nd + a.nc; ++li)
    f += (li ? (li < a.nd ? a.d_in[li] : a.c_in[li - a.nd]) * NKT_W : 0) + NKT_W;
  return f * (long long)sizeof(float) <= NKT_SMEM_MAX;
}

// hs_floats: size of the per-thread column buffer behind the weights. W0
// takes one buffer when staged whole, two otherwise (level l's slice in
// buffer g & 1, g counting the slices a block has used).
static FusedLayout make_layout(const FusedArgs& a, bool color,
                               int hs_floats = NKT_W * NKT_THREADS) {
  FusedLayout lay;
  int off = 0;
  const int nl = color ? a.nd + a.nc : a.nd;
  for (int li = 0; li < 2 * NKT_MAX_LAYERS; ++li) {
    lay.w_off[li] = 0;
    lay.b_off[li] = 0;
  }
  const bool whole = w0_whole(a);
  lay.n_slices = whole ? 1 : a.cp.n_levels;
  lay.slice = (whole ? a.cp.n_levels : 1) * a.cp.n_comp * NKT_W;
  for (int li = 0; li < nl; ++li) {
    const int in = li < a.nd ? a.d_in[li] : a.c_in[li - a.nd];
    lay.w_off[li] = off;
    off += li == 0 ? (lay.n_slices > 1 ? 2 : 1) * lay.slice : in * NKT_W;
    lay.b_off[li] = off;
    off += NKT_W;
  }
  lay.hs_off = off;
  off += hs_floats;
  lay.total = off;
  return lay;
}

// Rows of the gradient kernels' scratch arrays and offsets into the flat
// gradient of the MLP leaves. ops/ngp_fused_cuda.py::_grad_layout computes
// the same numbers on the host side.
struct SaveRows {
  int d_row[NKT_MAX_LAYERS];   // act: first row of density layer li's input
  int c_row[NKT_MAX_LAYERS];   // act: first row of color layer li's input
  int act_rows;
  int dg_row[NKT_MAX_LAYERS];  // gs: first row of density layer li's masked
  int cg_row[NKT_MAX_LAYERS];  //     output cotangent (color likewise)
  int gs_rows;
  int dw_off[NKT_MAX_LAYERS], db_off[NKT_MAX_LAYERS];  // flat gradient:
  int cw_off[NKT_MAX_LAYERS], cb_off[NKT_MAX_LAYERS];  // W then b per layer
  int total;
};

static SaveRows make_rows(const FusedArgs& a) {
  SaveRows r;
  int act = 0, gs = 0, flat = 0;
  for (int li = 0; li < NKT_MAX_LAYERS; ++li) {
    r.d_row[li] = r.c_row[li] = r.dg_row[li] = r.cg_row[li] = 0;
    r.dw_off[li] = r.db_off[li] = r.cw_off[li] = r.cb_off[li] = 0;
  }
  for (int li = 0; li < a.nd; ++li) {
    r.d_row[li] = act;
    act += a.d_in[li];
    r.dg_row[li] = gs;
    gs += a.d_out[li];
    r.dw_off[li] = flat;
    flat += a.d_in[li] * a.d_out[li];
    r.db_off[li] = flat;
    flat += a.d_out[li];
  }
  for (int li = 0; li < a.nc; ++li) {
    r.c_row[li] = act;
    act += a.c_in[li];
    r.cg_row[li] = gs;
    gs += a.c_out[li];
    r.cw_off[li] = flat;
    flat += a.c_in[li] * a.c_out[li];
    r.cb_off[li] = flat;
    flat += a.c_out[li];
  }
  r.act_rows = act;
  r.gs_rows = gs;
  r.total = flat;
  return r;
}

// Stage layers [1, nl)'s weights (rounded when bf) and every layer's bias
// into shared memory; W0 comes in slices (nkt_stage_slice). The caller
// synchronises the block afterwards.
__device__ __forceinline__ void nkt_stage_weights(const FusedArgs& a,
                                                  const FusedLayout& lay,
                                                  int nl, bool bf,
                                                  float* smem) {
  const int tid = threadIdx.x;
  for (int li = 0; li < nl; ++li) {
    const bool dens = li < a.nd;
    const float* W = dens ? a.dW[li] : a.cW[li - a.nd];
    const float* B = dens ? a.db[li] : a.cb[li - a.nd];
    const int in = dens ? a.d_in[li] : a.c_in[li - a.nd];
    const int out = dens ? a.d_out[li] : a.c_out[li - a.nd];
    float* sw = smem + lay.w_off[li];
    float* sb = smem + lay.b_off[li];
    for (int e = tid; li > 0 && e < in * NKT_W; e += NKT_THREADS) {
      const int k = e / NKT_W;
      const int j = e - k * NKT_W;
      float v = 0.0f;
      if (j < out) {
        v = W[k * out + j];
        if (bf) v = nkt_bf16r(v);
      }
      sw[e] = v;
    }
    for (int j = tid; j < NKT_W; j += NKT_THREADS) sb[j] = j < out ? B[j] : 0.0f;
  }
}

// 4-byte asynchronous copy global -> shared; bytes 0 writes a zero (nothing
// is read, src only has to be a valid address).
__device__ __forceinline__ void nkt_cp_async4(float* dst, const float* src,
                                              int bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void nkt_cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void nkt_cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Start copying a slice of W0 from level l's rows on (one level's C rows,
// or all of W0 when staged whole) into buf ([rows][NKT_W], zero padded) as
// one cp.async group.
__device__ __forceinline__ void nkt_stage_slice(const FusedArgs& a,
                                                const FusedLayout& lay, int l,
                                                float* buf) {
  const int out = a.d_out[0];
  const float* W = a.dW[0] + (long long)l * a.cp.n_comp * out;
  for (int e = threadIdx.x; e < lay.slice; e += NKT_THREADS) {
    const int k = e / NKT_W;
    const int j = e - k * NKT_W;
    nkt_cp_async4(buf + e, j < out ? W + k * out + j : W, j < out ? 4 : 0);
  }
  nkt_cp_commit();
}

// Wait for this thread's copies, round them when bf, and make the block's
// copies visible to every thread.
__device__ __forceinline__ void nkt_slice_ready(const FusedLayout& lay,
                                                bool bf, float* buf) {
  nkt_cp_wait<0>();
  if (bf)
    for (int e = threadIdx.x; e < lay.slice; e += NKT_THREADS)
      buf[e] = nkt_bf16r(buf[e]);
  __syncthreads();
}

// W0's rows of level l, the g-th level a block uses. Staged by level: before
// reading them the block waits for their copy and starts the copy of the
// next level's slice into the other buffer, which every thread is done with
// after this barrier. Slice 0 (of g = 0, or W0 whole) was staged and made
// ready before the loop.
__device__ __forceinline__ const float* nkt_level_weights(
    const FusedArgs& a, const FusedLayout& lay, int l, long long g, bool bf,
    float* smem) {
  float* buf0 = smem + lay.w_off[0];
  if (lay.n_slices == 1) return buf0 + l * a.cp.n_comp * NKT_W;
  float* cur = buf0 + (g & 1) * lay.slice;
  if (g > 0) nkt_slice_ready(lay, bf, cur);
  nkt_stage_slice(a, lay, l + 1 < lay.n_slices ? l + 1 : 0,
                  buf0 + ((g + 1) & 1) * lay.slice);
  return cur;
}

// acc[0..NOUT) = sum_k hs[k] * W[k][0..NOUT): the thread's activations come
// from its own column of hs, the weights are broadcast 16-byte loads.
template <int NOUT>
__device__ __forceinline__ void nkt_dense(const float* __restrict__ sw,
                                          const float* __restrict__ hs,
                                          int in, float* acc) {
#pragma unroll
  for (int j = 0; j < NOUT; ++j) acc[j] = 0.0f;
  for (int k = 0; k < in; ++k) {
    const float hk = hs[k * NKT_THREADS];
    const float4* w = reinterpret_cast<const float4*>(sw + k * NKT_W);
#pragma unroll
    for (int j4 = 0; j4 < NOUT / 4; ++j4) {
      const float4 wv = w[j4];
      acc[4 * j4 + 0] = __fmaf_rn(hk, wv.x, acc[4 * j4 + 0]);
      acc[4 * j4 + 1] = __fmaf_rn(hk, wv.y, acc[4 * j4 + 1]);
      acc[4 * j4 + 2] = __fmaf_rn(hk, wv.z, acc[4 * j4 + 2]);
      acc[4 * j4 + 3] = __fmaf_rn(hk, wv.w, acc[4 * j4 + 3]);
    }
  }
}

__device__ __forceinline__ void nkt_dense_any(const float* sw, const float* hs,
                                              int in, int out, float* acc) {
  if (out <= 4) {
    nkt_dense<4>(sw, hs, in, acc);
  } else if (out <= 16) {
    nkt_dense<16>(sw, hs, in, acc);
  } else if (out <= 32) {
    nkt_dense<32>(sw, hs, in, acc);
  } else {
    nkt_dense<NKT_W>(sw, hs, in, acc);
  }
}

// acc += bias; optionally ReLU; write the next layer's input (rounded to
// bf16 when asked) into the thread's column of hs at rows [row0, row0+out)
// and, when save is not null, into save[j * n] too.
__device__ __forceinline__ void nkt_finish_layer(float* acc, const float* sb,
                                                 int out, bool relu,
                                                 bool round_bf16, float* hs,
                                                 int row0, float* save,
                                                 long long n) {
#pragma unroll
  for (int j = 0; j < NKT_W; ++j) {
    if (j < out) {
      float z = acc[j] + sb[j];
      if (relu) z = nkt_relu(z);
      acc[j] = z;
      const float v = round_bf16 ? nkt_bf16r(z) : z;
      hs[(row0 + j) * NKT_THREADS] = v;
      if (save) save[j * n] = v;
    }
  }
}

// Real SH basis of degree 4 (16 values), same constants and order as the
// reference's ops/sh.py::sh_encode.
__device__ __forceinline__ void nkt_sh4(float x, float y, float z, float* s) {
  const float xx = x * x, yy = y * y, zz = z * z;
  const float xy = x * y, yz = y * z, xz = x * z;
  s[0] = 0.28209479177387814f;
  s[1] = -0.48860251190291987f * y;
  s[2] = 0.48860251190291987f * z;
  s[3] = -0.48860251190291987f * x;
  s[4] = 1.0925484305920792f * xy;
  s[5] = -1.0925484305920792f * yz;
  s[6] = 0.94617469575755997f * zz - 0.31539156525251999f;
  s[7] = -1.0925484305920792f * xz;
  s[8] = 0.54627421529603959f * (xx - yy);
  s[9] = 0.59004358992664352f * y * (-3.0f * xx + yy);
  s[10] = 2.8906114426405538f * xy * z;
  s[11] = 0.45704579946446572f * y * (1.0f - 5.0f * zz);
  s[12] = 0.3731763325901154f * z * (5.0f * zz - 3.0f);
  s[13] = 0.45704579946446572f * x * (1.0f - 5.0f * zz);
  s[14] = 1.4453057213202769f * z * (xx - yy);
  s[15] = 0.59004358992664352f * x * (-xx + 3.0f * yy);
}

// act: (rows.act_rows, n) scratch and z0s: (n,), written only when SAVE.
template <bool COLOR, bool SAVE>
__device__ __forceinline__ void nkt_fused_body(const FusedArgs& a,
                                               const FusedLayout& lay,
                                               const SaveRows& rows,
                                               float* act, float* z0s) {
  extern __shared__ float smem[];
  const int tid = threadIdx.x;
  const bool bf = a.cp.use_bf16 != 0;

  // ---- stage layers 1.. (rounded) and the biases once per block, W0's
  // first slice ----
  nkt_stage_slice(a, lay, 0, smem + lay.w_off[0]);
  nkt_stage_weights(a, lay, COLOR ? a.nd + a.nc : a.nd, bf, smem);
  nkt_slice_ready(lay, bf, smem + lay.w_off[0]);

  float* hs = smem + lay.hs_off + tid;  // this thread's column
  const int C = a.cp.n_comp;
  const int T = a.cp.table;
  const long long n = a.n;
  const unsigned pois_levels = nkt_poison_levels(a.cp);
  long long g = 0;  // W0's slices this block has used

  // Every thread of the block runs every batch (the slices' barriers); a
  // thread past the end computes point 0 again and writes nothing.
  for (long long base = (long long)blockIdx.x * NKT_THREADS; base < n;
       base += (long long)gridDim.x * NKT_THREADS) {
    const bool valid = base + tid < n;
    const long long i = valid ? base + tid : 0;

    float acc[NKT_W];
#pragma unroll
    for (int j = 0; j < NKT_W; ++j) acc[j] = 0.0f;

    // ---- density layer 0, fed by the encoder four channels at a time ----
    const float px = a.xt[i], py = a.xt[n + i], pz = a.xt[2 * n + i];
    for (int l = 0; l < a.cp.n_levels; ++l, ++g) {
      const float* sw0 = nkt_level_weights(a, lay, l, g, bf, smem);
      const NktTaps tx = nkt_taps(px, a.cp, l, 0);
      const NktTaps ty = nkt_taps(py, a.cp, l, 1);
      const NktTaps tz = nkt_taps(pz, a.cp, l, 2);
      const float* tabx = a.lines + ((long long)(l * 3 + 0) * T) * C;
      const float* taby = a.lines + ((long long)(l * 3 + 1) * T) * C;
      const float* tabz = a.lines + ((long long)(l * 3 + 2) * T) * C;
      const float4* x0 = reinterpret_cast<const float4*>(tabx + tx.r0 * C);
      const float4* x1 = reinterpret_cast<const float4*>(tabx + tx.r1 * C);
      const float4* y0 = reinterpret_cast<const float4*>(taby + ty.r0 * C);
      const float4* y1 = reinterpret_cast<const float4*>(taby + ty.r1 * C);
      const float4* z0 = reinterpret_cast<const float4*>(tabz + tz.r0 * C);
      const float4* z1 = reinterpret_cast<const float4*>(tabz + tz.r1 * C);
      // a non-finite table entry (nkt_poison): the fused operand's rows
      const bool pois = (pois_levels >> l) & 1u;
      const int Fd = nkt_dup_row(a.cp, l, true);
      for (int c4 = 0; c4 < C / 4; ++c4) {
        const float4 ax0 = __ldg(x0 + c4), ax1 = __ldg(x1 + c4);
        const float4 ay0 = __ldg(y0 + c4), ay1 = __ldg(y1 + c4);
        const float4 az0 = __ldg(z0 + c4), az1 = __ldg(z1 + c4);
        const float vx0[4] = {ax0.x, ax0.y, ax0.z, ax0.w};
        const float vx1[4] = {ax1.x, ax1.y, ax1.z, ax1.w};
        const float vy0[4] = {ay0.x, ay0.y, ay0.z, ay0.w};
        const float vy1[4] = {ay1.x, ay1.y, ay1.z, ay1.w};
        const float vz0[4] = {az0.x, az0.y, az0.z, az0.w};
        const float vz1[4] = {az1.x, az1.y, az1.z, az1.w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          float ux, uy, uz;
          if (bf) {
            ux = tx.w0 * nkt_bf16r(vx0[q]) + tx.w1 * nkt_bf16r(vx1[q]);
            uy = ty.w0 * nkt_bf16r(vy0[q]) + ty.w1 * nkt_bf16r(vy1[q]);
            uz = tz.w0 * nkt_bf16r(vz0[q]) + tz.w1 * nkt_bf16r(vz1[q]);
          } else {
            ux = tx.w0 * vx0[q] + tx.w1 * vx1[q];
            uy = ty.w0 * vy0[q] + ty.w1 * vy1[q];
            uz = tz.w0 * vz0[q] + tz.w1 * vz1[q];
          }
          if (pois) {
            const int c = c4 * 4 + q;
            ux = nkt_poison(ux, nkt_poison_desc(a.cp, l, 0, c), tx.r0, nkt_operand_r1(tx.r0, tx.r1, Fd));
            uy = nkt_poison(uy, nkt_poison_desc(a.cp, l, 1, c), ty.r0, nkt_operand_r1(ty.r0, ty.r1, Fd));
            uz = nkt_poison(uz, nkt_poison_desc(a.cp, l, 2, c), tz.r0, nkt_operand_r1(tz.r0, tz.r1, Fd));
          }
          float ev = (ux * uy) * uz;
          if (bf) ev = nkt_bf16r(ev);
          const int ch = c4 * 4 + q;
          if (SAVE && valid)
            act[(long long)(rows.d_row[0] + l * C + ch) * n + i] = ev;
          const float4* w = reinterpret_cast<const float4*>(sw0 + ch * NKT_W);
#pragma unroll
          for (int j4 = 0; j4 < NKT_W / 4; ++j4) {
            const float4 wv = w[j4];
            acc[4 * j4 + 0] = __fmaf_rn(ev, wv.x, acc[4 * j4 + 0]);
            acc[4 * j4 + 1] = __fmaf_rn(ev, wv.y, acc[4 * j4 + 1]);
            acc[4 * j4 + 2] = __fmaf_rn(ev, wv.z, acc[4 * j4 + 2]);
            acc[4 * j4 + 3] = __fmaf_rn(ev, wv.w, acc[4 * j4 + 3]);
          }
        }
      }
    }
    if (!valid) continue;  // no barrier below
    // A layer's output is the next layer's input; the last density layer's
    // is the first part of the color MLP's input.
    for (int li = 0; li < a.nd; ++li) {
      if (li > 0)
        nkt_dense_any(smem + lay.w_off[li], hs, a.d_in[li], a.d_out[li], acc);
      const int dst = li < a.nd - 1 ? rows.d_row[li + 1] : rows.c_row[0];
      nkt_finish_layer(acc, smem + lay.b_off[li], a.d_out[li], li < a.nd - 1,
                       bf, hs, 0,
                       SAVE ? act + (long long)dst * n + i : nullptr, n);
    }
    // acc[0] is the f32 feature 0; hs rows [0, dout) hold the rounded
    // features, the first part of the color MLP's input.
    const float sigma = expf(nkt_clamp(acc[0], -15.0f, 15.0f));
    if (SAVE) z0s[i] = acc[0];

    if (COLOR) {
      const int dout = a.d_out[a.nd - 1];
      float sh[16];
      nkt_sh4(a.vdt[i], a.vdt[n + i], a.vdt[2 * n + i], sh);
#pragma unroll
      for (int s = 0; s < 16; ++s) {
        const float v = bf ? nkt_bf16r(sh[s]) : sh[s];
        hs[(dout + s) * NKT_THREADS] = v;
        if (SAVE) act[(long long)(rows.c_row[0] + dout + s) * n + i] = v;
      }
      for (int li = 0; li < a.nc; ++li) {
        nkt_dense_any(smem + lay.w_off[a.nd + li], hs, a.c_in[li], a.c_out[li],
                      acc);
        nkt_finish_layer(acc, smem + lay.b_off[a.nd + li], a.c_out[li],
                         li < a.nc - 1, bf, hs, 0,
                         SAVE && li < a.nc - 1
                             ? act + (long long)rows.c_row[li + 1] * n + i
                             : nullptr,
                         n);
      }
      a.out[i] = acc[0];
      a.out[n + i] = acc[1];
      a.out[2 * n + i] = acc[2];
    } else {
      a.out[i] = 0.0f;
      a.out[n + i] = 0.0f;
      a.out[2 * n + i] = 0.0f;
    }
    a.out[3 * n + i] = sigma;
  }
  nkt_cp_wait<0>();  // the last prefetch
}
