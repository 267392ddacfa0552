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
// The forward is deliberately simple: one thread per point with the layer's
// accumulators in registers, all layers' weights staged once per block in
// shared memory (blocks are persistent and walk over point tiles), every
// weight read a broadcast 16-byte load, the 256-wide encoding produced four
// channels at a time and consumed straight into the first layer's
// accumulators. The products run on the f32 FMA pipe, not on the tensor
// cores; moving them there (mma / wgmma) is the next step for these kernels.
//
// With SAVE the body also writes every layer's (rounded) input and the f32
// feature 0 into a (rows, N) scratch array in device memory: what the
// gradient kernels read back instead of holding 1.4 KB per point on chip.
#pragma once

#include "nkt_common.cuh"

#define NKT_THREADS 256
#define NKT_W 64          // widest layer the kernels take; smem row stride
#define NKT_MAX_LAYERS 8  // per MLP

// Mirrors ops/cuda_lib.py::FusedArgs field for field.
struct FusedArgs {
  const float* xt;     // (3, n)
  const float* vdt;    // (3, n), unused by the sigma kernel
  const float* lines;  // (L, 3, T, C)
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
};

// Offsets (in floats) into dynamic shared memory.
struct FusedLayout {
  int w_off[2 * NKT_MAX_LAYERS];  // layer weights, [in][NKT_W], zero padded
  int b_off[2 * NKT_MAX_LAYERS];  // layer bias, [NKT_W]
  int hs_off;                     // per-thread columns, [NKT_W][stride]
  int total;
};

// hs_floats: size of the per-thread column buffer behind the weights.
static FusedLayout make_layout(const FusedArgs& a, bool color,
                               int hs_floats = NKT_W * NKT_THREADS) {
  FusedLayout lay;
  int off = 0;
  const int nl = color ? a.nd + a.nc : a.nd;
  for (int li = 0; li < 2 * NKT_MAX_LAYERS; ++li) {
    lay.w_off[li] = 0;
    lay.b_off[li] = 0;
  }
  for (int li = 0; li < nl; ++li) {
    const int in = li < a.nd ? a.d_in[li] : a.c_in[li - a.nd];
    lay.w_off[li] = off;
    off += in * NKT_W;
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
  int z0_row;                  // act: the f32 feature 0
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
  r.z0_row = act;
  r.act_rows = act + 1;
  r.gs_rows = gs;
  r.total = flat;
  return r;
}

// Stage the first nl layers' weights (rounded when bf) and biases into
// shared memory; the caller synchronises the block afterwards.
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
    for (int e = tid; e < in * NKT_W; e += NKT_THREADS) {
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
      if (relu) z = fmaxf(z, 0.0f);
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

// act: (rows.act_rows, n) scratch, read only when SAVE.
template <bool COLOR, bool SAVE>
__device__ __forceinline__ void nkt_fused_body(const FusedArgs& a,
                                               const FusedLayout& lay,
                                               const SaveRows& rows,
                                               float* act) {
  extern __shared__ float smem[];
  const int tid = threadIdx.x;
  const bool bf = a.cp.use_bf16 != 0;

  // ---- stage every layer's weights (rounded) and bias once per block ----
  nkt_stage_weights(a, lay, COLOR ? a.nd + a.nc : a.nd, bf, smem);
  __syncthreads();

  float* hs = smem + lay.hs_off + tid;  // this thread's column
  const int C = a.cp.n_comp;
  const int T = a.cp.table;
  const long long n = a.n;

  for (long long base = (long long)blockIdx.x * NKT_THREADS; base < n;
       base += (long long)gridDim.x * NKT_THREADS) {
    const long long i = base + tid;
    if (i >= n) continue;

    float acc[NKT_W];
#pragma unroll
    for (int j = 0; j < NKT_W; ++j) acc[j] = 0.0f;

    // ---- density layer 0, fed by the encoder four channels at a time ----
    const float px = a.xt[i], py = a.xt[n + i], pz = a.xt[2 * n + i];
    const float* sw0 = smem + lay.w_off[0];
    for (int l = 0; l < a.cp.n_levels; ++l) {
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
          float ev = (ux * uy) * uz;
          if (bf) ev = nkt_bf16r(ev);
          const int ch = l * C + c4 * 4 + q;
          if (SAVE) act[(long long)(rows.d_row[0] + ch) * n + i] = ev;
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
    const float sigma = expf(fminf(fmaxf(acc[0], -15.0f), 15.0f));
    if (SAVE) act[(long long)rows.z0_row * n + i] = acc[0];

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
}
