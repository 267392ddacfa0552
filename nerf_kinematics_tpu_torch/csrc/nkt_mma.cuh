// Tensor-core building blocks of the fused NGP kernels in bf16 mode
// (use_bf16 = 1): the warp-level product mma.sync.m16n8k16 (bf16 operands,
// f32 accumulation), its fragment layouts, and the forward body that runs
// every MLP layer on it.
//
// Fragments of mma.m16n8k16 (g = lane / 4, t = lane % 4; two bf16 per
// 32-bit register, the lower index in the low half):
//   A (16 x 16, row major): a[0] = (g, 2t..2t+1), a[1] = (g+8, 2t..),
//       a[2] = (g, 2t+8..2t+9), a[3] = (g+8, 2t+8..)
//   B (16 x 8): b0 = (k 2t..2t+1, n g), b1 = (k 2t+8..2t+9, n g)
//   C (16 x 8, f32): c[0..1] = (g, 2t..2t+1), c[2..3] = (g+8, 2t..2t+1)
// A layer's C fragments of n-tiles 2i and 2i+1 are exactly the A fragment of
// k-tile i of the next layer, so a warp chains the layers in registers: bias
// in f32 after the sum, ReLU, bf16 rounding, pack.
//
// B operands live in shared memory as rows of the packed weight buffer the
// host builds (ops/ngp_fused_cuda.py::mma_pack): one row per output column
// n, the reduction index contiguous, rows ld words apart with ld = 4 (mod 8),
// so the eight 16-byte rows of an ldmatrix fall in distinct banks. One
// ldmatrix.x4 loads the B fragments of two n-tiles (or a whole A fragment
// from a warp's buffer, padded the same way): a quarter of the shared-memory
// instructions of 32-bit loads, the same bytes.
#pragma once

#include <stdint.h>

#include "ngp_fused.cuh"

#define NKT_MT 16                     // points per warp tile
#define NKT_WARPS (NKT_THREADS / 32)
#define NKT_MAX_NT 8                  // n-tiles of 8 a warp holds (64 columns)
#define NKT_MMA_MAX_WARPS 16          // warps per block of the forward kernels
#define NKT_ENC_BATCH 4               // points whose gathers a lane issues at once
#define NKT_TAP_BYTES (NKT_MT * 3 * 12)  // a warp's taps of a level (NktTapS)
#define NKT_LIST_CAP 64               // values a warp sums again together
#define NKT_LIST_BYTES (NKT_LIST_CAP * 2)

__device__ __forceinline__ uint32_t nkt_pack2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// c += A (16 x 16) * B (16 x 8), bf16 operands, f32 accumulation.
__device__ __forceinline__ void nkt_mma(float* c, const uint32_t* a,
                                        uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += (A * B), the 16-product partial taken from zero and added with IEEE
// round-to-nearest adds. The tensor cores' own adds truncate (their
// accumulator is not an IEEE one), so chaining a long sum through them drifts
// from the plain version's f32 sum further than another order of the same
// sum would; only the partials go through them here.
__device__ __forceinline__ void nkt_mma_add(float* c, const uint32_t* a,
                                            uint32_t b0, uint32_t b1) {
  float p[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  nkt_mma(p, a, b0, b1);
  c[0] = c[0] + p[0];
  c[1] = c[1] + p[1];
  c[2] = c[2] + p[2];
  c[3] = c[3] + p[3];
}

// Four 8x8 bf16 matrices from shared memory, rows addressed by the lanes.
__device__ __forceinline__ void nkt_ldm4(uint32_t* r, const uint32_t* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(s));
}

// The same, each matrix transposed: a B operand stored (k rows, n columns)
// with n contiguous gives lane (g, t) the pair (k 2t..2t+1, n g).
__device__ __forceinline__ void nkt_ldm4t(uint32_t* r, const void* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(s));
}

// f32 products in 3xTF32 on mma.sync.m16n8k8 (TF32 operands, f32
// accumulation). Fragments (g = lane / 4, t = lane % 4):
//   A (16 x 8, row major): a0 = (g, t), a1 = (g + 8, t), a2 = (g, t + 4),
//       a3 = (g + 8, t + 4)
//   B (8 x 8): b0 = (k t, n g), b1 = (k t + 4, n g)
//   C (16 x 8, f32): as for m16n8k16.
// An f32 operand a is split into a_hi = cvt.rna.tf32(a) and a_lo =
// cvt.rna.tf32(a - a_hi) (exact with -fmad=false), and a * b is taken as
// a_lo * b_hi + a_hi * b_lo + a_hi * b_hi, the small terms first: about 22
// bits of each operand, near f32, at a third of the TF32 rate.
//
// cvt.rna.tf32.f32 for a finite x: the magnitude rounded to nearest at bit
// 13, ties away from zero, the low 13 bits cleared. Two integer operations
// at the ALU's rate, where the conversion instruction runs on a slower pipe.
__device__ __forceinline__ uint32_t nkt_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// x = hi + lo to about 22 bits; x - hi is exact. Finite x only: a canonical
// NaN rounds to -0 and an inf leaves lo = NaN.
__device__ __forceinline__ void nkt_tf32_split_finite(float x, uint32_t& hi,
                                                      uint32_t& lo) {
  hi = nkt_tf32(x);
  lo = nkt_tf32(x - __uint_as_float(hi));
}

// Any x. A non-finite x goes whole
// into lo, with hi = 0: a * b = a_lo b_hi + a_hi b_lo + a_hi b_hi then meets
// x once, as a_hi x (the IEEE class of a x, a_hi being 0 only where a is),
// where hi = x would make a_lo x, 0 * inf = NaN for an a exact in TF32.
__device__ __forceinline__ void nkt_tf32_split(float x, uint32_t& hi,
                                               uint32_t& lo) {
  if (isfinite(x)) {
    nkt_tf32_split_finite(x, hi, lo);
  } else {  // a NaN as the canonical one: its top 19 bits are a NaN
    hi = 0u;
    lo = x != x ? 0x7FFFFFFFu : __float_as_uint(x);
  }
}

// The split a kernel instance takes: SAFE where its operands may be
// non-finite, the finite one (two integer operations fewer) where the
// launch's inputs were found finite.
template <bool SAFE>
__device__ __forceinline__ void nkt_tf32_split_t(float x, uint32_t& hi,
                                                 uint32_t& lo) {
  if constexpr (SAFE)
    nkt_tf32_split(x, hi, lo);
  else
    nkt_tf32_split_finite(x, hi, lo);
}

// c += A B on the tensor cores, TF32 operands (one of the three products).
__device__ __forceinline__ void nkt_mma_tf32(float* c, const uint32_t* a,
                                             uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += A B in 3xTF32 (ah / al: the split A fragment, b*: the split B
// fragment), the three products summed from zero and added with IEEE adds,
// as nkt_mma_add does for bf16.
__device__ __forceinline__ void nkt_mma3_add(float* c, const uint32_t* ah,
                                             const uint32_t* al, uint32_t bh0,
                                             uint32_t bh1, uint32_t bl0,
                                             uint32_t bl1) {
  float p[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  nkt_mma_tf32(p, al, bh0, bh1);
  nkt_mma_tf32(p, ah, bl0, bl1);
  nkt_mma_tf32(p, ah, bh0, bh1);
  c[0] = c[0] + p[0];
  c[1] = c[1] + p[1];
  c[2] = c[2] + p[2];
  c[3] = c[3] + p[3];
}

// acc[nt] = sum over k-tiles kt < KT of af[kt] times rows [8 nt, 8 nt + 8)
// of the packed matrix W (ld words a row), for nt < NT. Loops run to their
// compile-time bounds so that the fragments stay in registers.
__device__ __forceinline__ void nkt_mma_dense(uint32_t (*af)[4], int KT,
                                              const uint32_t* W, int ld, int NT,
                                              float (*acc)[4], int g, int t) {
#pragma unroll
  for (int nt = 0; nt < NKT_MAX_NT; ++nt)
    acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.0f;
  const int lane = g * 4 + t;
  const int br = ((lane & 7) + ((lane >> 4) << 3)) * ld + ((lane >> 3) & 1) * 4;
#pragma unroll
  for (int kt = 0; kt < NKT_MAX_NT / 2; ++kt) {
    if (kt < KT) {
#pragma unroll
      for (int np = 0; np < NKT_MAX_NT / 2; ++np) {
        if (2 * np < NT) {
          uint32_t b[4];
          nkt_ldm4(b, W + br + np * 16 * ld + kt * 8);
          nkt_mma_add(acc[2 * np], af[kt], b[0], b[1]);
          if (2 * np + 1 < NT) nkt_mma_add(acc[2 * np + 1], af[kt], b[2], b[3]);
        }
      }
    }
  }
}

// C fragments -> A fragments of the next product: n-tiles 2i, 2i+1 make
// k-tile i; n-tiles at or past NT are zero.
__device__ __forceinline__ void nkt_c_to_a(float (*v)[4], int NT,
                                           uint32_t (*af)[4]) {
#pragma unroll
  for (int nt = 0; nt < NKT_MAX_NT; ++nt) {
    uint32_t lo = 0, hi = 0;
    if (nt < NT) {
      lo = nkt_pack2(v[nt][0], v[nt][1]);
      hi = nkt_pack2(v[nt][2], v[nt][3]);
    }
    af[nt >> 1][(nt & 1) * 2 + 0] = lo;
    af[nt >> 1][(nt & 1) * 2 + 1] = hi;
  }
}

// The plain version's own sum of one output: an f32 fused multiply-add
// chain over k in order, from 0 (what a sequential matmul computes). x and
// w are 16-byte aligned rows of bf16, K a multiple of 8.
static __device__ __noinline__ float nkt_chain(const __nv_bfloat16* x,
                                               const __nv_bfloat16* w, int K) {
  float acc = 0.0f;
  for (int k = 0; k < K; k += 8) {
    const uint4 xv = *reinterpret_cast<const uint4*>(x + k);
    const uint4 wv = *reinterpret_cast<const uint4*>(w + k);
    const uint32_t xs[4] = {xv.x, xv.y, xv.z, xv.w};
    const uint32_t ws[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      acc = __fmaf_rn(__uint_as_float(xs[i] << 16), __uint_as_float(ws[i] << 16), acc);
      acc = __fmaf_rn(__uint_as_float(xs[i] & 0xFFFF0000u),
                      __uint_as_float(ws[i] & 0xFFFF0000u), acc);
    }
  }
  return acc;
}

// Within NKT_NEAR f32 ulps of a bf16 rounding midpoint: a sum taken in
// another order may round to the other neighbour. The tensor cores' sums
// and the chain differ by a few ulps; NKT_NEAR leaves a wide margin.
#define NKT_NEAR 256
__device__ __forceinline__ bool nkt_near_midpoint(float z) {
  const int low = (int)(__float_as_uint(z) & 0xFFFFu);
  return z != 0.0f && abs(low - 0x8000) < NKT_NEAR;
}

// acc[nt] = sum over k-tiles kt < KT of X (the warp's bf16 [16][*] buffer,
// ldx words a row) times rows [8 nt, 8 nt + 8) of the packed matrix W.
__device__ __forceinline__ void nkt_mma_dense_s(const uint32_t* X, int ldx,
                                                int KT, const uint32_t* W,
                                                int ld, int NT,
                                                float (*acc)[4], int g,
                                                int t) {
#pragma unroll
  for (int nt = 0; nt < NKT_MAX_NT; ++nt)
    acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.0f;
  const int lane = g * 4 + t;
  const int ar = (lane & 15) * ldx + (lane >> 4) * 4;
  const int br = ((lane & 7) + ((lane >> 4) << 3)) * ld + ((lane >> 3) & 1) * 4;
  for (int kt = 0; kt < KT; ++kt) {
    uint32_t af[4];
    nkt_ldm4(af, X + ar + kt * 8);
#pragma unroll
    for (int np = 0; np < NKT_MAX_NT / 2; ++np) {
      if (2 * np < NT) {
        uint32_t b[4];
        nkt_ldm4(b, W + br + np * 16 * ld + kt * 8);
        nkt_mma_add(acc[2 * np], af, b[0], b[1]);
        if (2 * np + 1 < NT) nkt_mma_add(acc[2 * np + 1], af, b[2], b[3]);
      }
    }
  }
}

// z = acc + bias (f32, after the sum), ReLU when relu; acc keeps z. The
// values rounded to bf16 go to columns [0, 8 NT) of the warp's buffer Y
// (ldy words a row), except that a value near a rounding midpoint is taken
// again as the plain version sums it (nkt_chain over the layer's input X,
// K wide, and the row of Wt, ldw elements apart), so that it rounds as
// there. The lanes gather their flagged (row, column) pairs into the warp's
// list and take one each. Ends with the warp synchronised.
__device__ __forceinline__ void nkt_mma_finish(float (*acc)[4], int NT,
                                               const float* bias, bool relu,
                                               uint32_t* Y, int ldy,
                                               const uint32_t* X, int ldx,
                                               int K, const __nv_bfloat16* Wt,
                                               int ldw, unsigned short* list,
                                               int lane, int g, int t) {
  unsigned redo = 0u;
#pragma unroll
  for (int nt = 0; nt < NKT_MAX_NT; ++nt) {
    if (nt < NT) {
      const float b0 = bias[nt * 8 + 2 * t], b1 = bias[nt * 8 + 2 * t + 1];
      float z[4] = {acc[nt][0] + b0, acc[nt][1] + b1, acc[nt][2] + b0,
                    acc[nt][3] + b1};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (relu) z[e] = nkt_relu(z[e]);
        acc[nt][e] = z[e];
        if (nkt_near_midpoint(z[e])) redo |= 1u << (nt * 4 + e);
      }
      Y[g * ldy + nt * 4 + t] = nkt_pack2(z[0], z[1]);
      Y[(g + 8) * ldy + nt * 4 + t] = nkt_pack2(z[2], z[3]);
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
  const __nv_bfloat16* xb = reinterpret_cast<const __nv_bfloat16*>(X);
  __nv_bfloat16* yb = reinterpret_cast<__nv_bfloat16*>(Y);
  while (redo) {
    const int i = __ffs(redo) - 1;
    redo &= redo - 1u;
    const int row = g + ((i & 3) >> 1) * 8;
    const int col = (i >> 2) * 8 + 2 * t + (i & 1);
    if (at < NKT_LIST_CAP) {
      list[at] = (unsigned short)(row * NKT_W + col);
    } else {  // more than the list holds: the lane sums its own
      float z = nkt_chain(xb + row * 2 * ldx, Wt + col * ldw, K) + bias[col];
      if (relu) z = nkt_relu(z);
      yb[row * 2 * ldy + col] = __float2bfloat16_rn(z);
    }
    ++at;
  }
  __syncwarp();
  for (int it = lane; it < min(total, NKT_LIST_CAP); it += 32) {
    const int row = list[it] / NKT_W, col = list[it] % NKT_W;
    float z = nkt_chain(xb + row * 2 * ldx, Wt + col * ldw, K) + bias[col];
    if (relu) z = nkt_relu(z);
    yb[row * 2 * ldy + col] = __float2bfloat16_rn(z);
  }
  __syncwarp();
}

// act rows [row0, row0 + W) of the warp's 16 points at p0 (rows ld points
// apart) from columns [col0, col0 + W) of its bf16 buffer: 32-bit stores of
// two points, eight lanes to a row, so each store fills whole 32-byte
// sectors.
__device__ __forceinline__ void nkt_save_tile(const uint32_t* tile, int lde,
                                              int col0, int W,
                                              __nv_bfloat16* act, long long ld,
                                              int row0, long long p0,
                                              int lane) {
  const __nv_bfloat16* tb = reinterpret_cast<const __nv_bfloat16*>(tile) + col0;
  for (int e = lane; e < W * 8; e += 32) {
    const int ch = e >> 3, q = e & 7;
    __nv_bfloat162 v;
    v.x = tb[(2 * q) * (2 * lde) + ch];
    v.y = tb[(2 * q + 1) * (2 * lde) + ch];
    *reinterpret_cast<__nv_bfloat162*>(act + (long long)(row0 + ch) * ld + p0 +
                                       2 * q) = v;
  }
}

// 16-byte asynchronous copy global -> shared; bytes < 16 zero-fills the
// rest (0: nothing is read, src only has to be a valid address). Commit
// and wait: nkt_cp_commit / nkt_cp_wait of ngp_fused.cuh.
__device__ __forceinline__ void nkt_cp_async16(void* dst, const void* src,
                                               int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes)
               : "memory");
}

// Grid of a persistent kernel: enough blocks for the work, at most as many
// as fit on the card at once.
template <typename K>
static long long persistent_blocks(K kernel, int threads, size_t smem,
                                   long long work_blocks, int n_sm) {
  int per_sm = 1;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (per_sm < 1) per_sm = 1;
  const long long cap = (long long)per_sm * n_sm;
  return work_blocks < cap ? work_blocks : cap;
}

// Shared memory of the tensor-core kernels (bytes). Each warp's region ends
// with its 16 points' taps of the current level (NKT_TAP_BYTES), which the
// lanes read back as broadcasts.
struct MmaLayout {
  int w_start;     // first packed element staged
  int w_elems;     // packed bf16 elements staged, at offset 0
  int b_off;       // f32 biases, NKT_W a layer
  int n_bias;      // layers whose biases are staged
  int tile_off;    // per-warp tiles
  int tile_bytes;  // bytes of one warp's tiles
  int lde;         // 32-bit words per row of the first tile
  int ldh;         // 32-bit words per row of the second tile (forward)
  int warps;       // warps per block
  int total;
};


// The weights (packed bf16, copied as they are) and biases one block uses.
__device__ __forceinline__ void nkt_mma_stage(const FusedArgs& a,
                                              const MmaLayout& lay,
                                              unsigned char* smem) {
  const uint4* src =
      reinterpret_cast<const uint4*>(
          reinterpret_cast<const __nv_bfloat16*>(a.wpk) + lay.w_start);
  uint4* dst = reinterpret_cast<uint4*>(smem);
  for (int e = threadIdx.x; e < lay.w_elems / 8; e += blockDim.x)
    dst[e] = __ldg(src + e);
  float* sb = reinterpret_cast<float*>(smem + lay.b_off);
  for (int e = threadIdx.x; e < lay.n_bias * NKT_W; e += blockDim.x) {
    const int li = e / NKT_W, j = e - li * NKT_W;
    const bool dens = li < a.nd;
    const float* B = dens ? a.db[li] : a.cb[li - a.nd];
    const int out = dens ? a.d_out[li] : a.c_out[li - a.nd];
    sb[e] = j < out ? B[j] : 0.0f;
  }
}

// The warp's 16 points of a level in E (bf16, lde elements a row; their tap
// pairs in taps, three a point): NaN in each channel that nkt_poison makes
// NaN for one of its axes, with the fused kernels' operand rows. desc: the
// level's descriptors (nkt_poison_descs). Scalar arguments only: a
// reference to the kernel's argument struct would copy it to the stack.
static __device__ __noinline__ void nkt_poison_tile(__nv_bfloat16* E, int lde,
                                                    const NktTapS* taps,
                                                    const unsigned* desc, int C,
                                                    int Fd, int lane) {
  for (int e = lane; e < NKT_MT * C; e += 32) {
    const int pp = e / C, c = e - pp * C;
    bool nan = false;
    for (int a = 0; a < 3; ++a) {
      const NktTapS q = taps[pp * 3 + a];
      nan |= nkt_poison(0.0f, desc[a * C + c], q.r0,
                        nkt_operand_r1(q.r0, q.r1, Fd)) != 0.0f;
    }
    if (nan) E[pp * lde + c] = __float2bfloat16_rn(__int_as_float(0x7FFFFFFF));
  }
}

// The forward body of bf16 mode: one warp per tile of 16 points, every
// product on the tensor cores. Each warp has two bf16 buffers of 16 rows, E
// and H. Per level the lanes gather the line tables' bf16 copy with the
// lanes on channel pairs (coalesced 128-byte rows) into E (with color: and
// copy it to the level's columns of the warp's slot of a.enc), and layer 0
// takes that level's k-tiles from E. Each later layer reads its input from the buffer
// the previous layer wrote (H, E, H, ...); nkt_mma_finish keeps every
// rounding as the plain version's, reading layer 0's whole input from E or
// the slot. With SAVE it also writes every layer's (rounded) input to
// act (bf16, rows ld points apart) and the f32 feature 0 to z0s.
template <bool COLOR, bool SAVE>
__device__ __forceinline__ void nkt_mma_body(const FusedArgs& a,
                                             const MmaLayout& lay,
                                             const SaveRows& rows,
                                             __nv_bfloat16* act, float* z0s,
                                             long long ld) {
  extern __shared__ __align__(16) unsigned char smem_mma[];
  nkt_mma_stage(a, lay, smem_mma);
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const uint32_t* sw = reinterpret_cast<const uint32_t*>(smem_mma);
  const __nv_bfloat16* swb = reinterpret_cast<const __nv_bfloat16*>(smem_mma);
  const float* sbias = reinterpret_cast<const float*>(smem_mma + lay.b_off);
  uint32_t* buf[2];
  buf[0] = reinterpret_cast<uint32_t*>(smem_mma + lay.tile_off +
                                       warp * lay.tile_bytes);
  buf[1] = buf[0] + NKT_MT * lay.lde;
  const int ldb[2] = {lay.lde, lay.ldh};
  // WIDE (the density-only kernel, whose weights leave room): E holds the
  // whole encoding. Otherwise E holds the current level and the warp's slot
  // of a.enc the whole encoding. E then serves as a hidden buffer.
  constexpr bool WIDE = !COLOR;
  uint32_t* E = buf[0];
  const int LC = a.cp.n_levels * a.cp.n_comp;
  __nv_bfloat16* slot = WIDE ? nullptr
                             : static_cast<__nv_bfloat16*>(a.enc) +
                                   ((long long)blockIdx.x * warps + warp) * NKT_MT * LC;
  NktTapS* taps = reinterpret_cast<NktTapS*>(buf[1] + NKT_MT * lay.ldh);
  unsigned short* list = reinterpret_cast<unsigned short*>(taps + NKT_MT * 3);
  const int lde = lay.lde;
  const __nv_bfloat162* lines16 =
      reinterpret_cast<const __nv_bfloat162*>(a.lines16);
  const int C = a.cp.n_comp, C2 = C / 2, T = a.cp.table;
  const long long n = a.n;
  const long long n_tiles = (n + NKT_MT - 1) / NKT_MT;
  const unsigned pois_levels = nkt_poison_levels(a.cp);

  for (long long tt = (long long)blockIdx.x * warps + warp; tt < n_tiles;
       tt += (long long)gridDim.x * warps) {
    const long long p0 = tt * NKT_MT;
    const long long pl = p0 + (lane & 15);  // the point whose taps lane holds
    float px = 0.0f, py = 0.0f, pz = 0.0f;
    if (pl < n) {
      px = a.xt[pl];
      py = a.xt[n + pl];
      pz = a.xt[2 * n + pl];
    }

    // ---- density layer 0, fed by the encoder one level at a time --------
    float acc[NKT_MAX_NT][4];
    const int NT0 = (a.d_out[0] + 7) / 8;
#pragma unroll
    for (int nt = 0; nt < NKT_MAX_NT; ++nt)
      acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.0f;
    const uint32_t* W0 = sw + a.pk_off[0] / 2;
    const int ld0 = a.pk_ld[0] / 2;
    for (int l = 0; l < a.cp.n_levels; ++l) {
      if (lane < NKT_MT) {
        taps[lane * 3 + 0] = nkt_tap_s(nkt_taps(px, a.cp, l, 0));
        taps[lane * 3 + 1] = nkt_tap_s(nkt_taps(py, a.cp, l, 1));
        taps[lane * 3 + 2] = nkt_tap_s(nkt_taps(pz, a.cp, l, 2));
      }
      __syncwarp();
      const __nv_bfloat162* tx = lines16 + (long long)(l * 3 + 0) * T * C2;
      const __nv_bfloat162* ty = lines16 + (long long)(l * 3 + 1) * T * C2;
      const __nv_bfloat162* tz = lines16 + (long long)(l * 3 + 2) * T * C2;
      uint32_t* El = WIDE ? E + l * C2 : E;
      // the gathers of NKT_ENC_BATCH points first, then their products
      for (int pp0 = 0; pp0 < NKT_MT; pp0 += NKT_ENC_BATCH) {
        for (int c2 = lane; c2 < C2; c2 += 32) {
          __nv_bfloat162 v[NKT_ENC_BATCH][6];
#pragma unroll
          for (int u = 0; u < NKT_ENC_BATCH; ++u) {
            const NktTapS* q = taps + (pp0 + u) * 3;
            v[u][0] = __ldg(tx + q[0].r0 * C2 + c2);
            v[u][1] = __ldg(tx + q[0].r1 * C2 + c2);
            v[u][2] = __ldg(ty + q[1].r0 * C2 + c2);
            v[u][3] = __ldg(ty + q[1].r1 * C2 + c2);
            v[u][4] = __ldg(tz + q[2].r0 * C2 + c2);
            v[u][5] = __ldg(tz + q[2].r1 * C2 + c2);
          }
#pragma unroll
          for (int u = 0; u < NKT_ENC_BATCH; ++u) {
            const NktTapS* q = taps + (pp0 + u) * 3;
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
            El[(pp0 + u) * lde + c2] =
                nkt_pack2((ux0 * uy0) * uz0, (ux1 * uy1) * uz1);
          }
        }
      }
      __syncwarp();
      // a non-finite table entry (nkt_poison), rarely: the product of a
      // channel whose line feature is NaN is NaN
      if ((pois_levels >> l) & 1u) {
        nkt_poison_tile(reinterpret_cast<__nv_bfloat16*>(El), 2 * lde, taps,
                        nkt_poison_descs(a.cp, l), C, nkt_dup_row(a.cp, l, true),
                        lane);
        __syncwarp();
      }
      // the level's columns of the warp's slot: 16-byte copies
      if (!WIDE) {
        for (int e = lane; e < NKT_MT * C / 8; e += 32) {
          const int p = e / (C / 8), c8 = e % (C / 8);
          *reinterpret_cast<uint4*>(slot + p * LC + l * C + c8 * 8) =
              *reinterpret_cast<const uint4*>(E + p * lde + c8 * 4);
        }
      }
      if (SAVE) nkt_save_tile(El, lde, 0, C, act, ld, rows.d_row[0] + l * C, p0, lane);
      const int ar = (lane & 15) * lde + (lane >> 4) * 4;
      const int br = ((lane & 7) + ((lane >> 4) << 3)) * ld0 + ((lane >> 3) & 1) * 4 + (l * C) / 2;
      for (int ks = 0; ks < C / 16; ++ks) {
        uint32_t af[4];
        nkt_ldm4(af, El + ar + ks * 8);
#pragma unroll
        for (int np = 0; np < NKT_MAX_NT / 2; ++np) {
          if (2 * np < NT0) {
            uint32_t b[4];
            nkt_ldm4(b, W0 + br + np * 16 * ld0 + ks * 8);
            nkt_mma_add(acc[2 * np], af, b[0], b[1]);
            if (2 * np + 1 < NT0) nkt_mma_add(acc[2 * np + 1], af, b[2], b[3]);
          }
        }
      }
      __syncwarp();
    }

    // ---- every layer: finish (bias, ReLU, rounding into the other buffer),
    // then the next product from there -------------------------------------
    int cur = 0;  // the buffer that holds the current layer's input
    const int nl = COLOR ? a.nd + a.nc : a.nd;
    const long long pg = p0 + g, pg8 = p0 + g + 8;
    for (int L = 0; L < nl; ++L) {
      const bool dens = L < a.nd;
      const int li = dens ? L : L - a.nd;
      const int K = dens ? a.d_in[li] : a.c_in[li];
      const int J = dens ? a.d_out[li] : a.c_out[li];
      const int NT = (J + 7) / 8;
      if (L > 0)
        nkt_mma_dense_s(buf[cur], ldb[cur], (K + 15) / 16, sw + a.pk_off[L] / 2,
                        a.pk_ld[L] / 2, NT, acc, g, t);
      // the layer's input, whole: layer 0's is in the warp's slot
      const uint32_t* X =
          L > 0 || WIDE ? buf[cur] : reinterpret_cast<const uint32_t*>(slot);
      const int ldx = L > 0 || WIDE ? ldb[cur] : LC / 2;
      const bool last = L == nl - 1;
      const bool relu = dens ? li < a.nd - 1 : li < a.nc - 1;
      if (dens && li == a.nd - 1) {
        // sigma comes from the f32 feature 0, and the whole step's inverse
        // CDFs turn its last bits into moved samples: feature 0 is summed in
        // the plain version's order for every point (lanes 0-15, one point
        // each) and replaces the tensor cores' sum.
        float zc = 0.0f;
        if (lane < NKT_MT)
          zc = nkt_chain(reinterpret_cast<const __nv_bfloat16*>(X) + lane * 2 * ldx,
                         swb + a.pk_off[L], K);
        const float zg = __shfl_sync(0xffffffffu, zc, g);
        const float zg8 = __shfl_sync(0xffffffffu, zc, g + 8);
        // acc of t = 0: the f32 feature 0 of points g, g+8 (bias added here)
        if (t == 0) {
          acc[0][0] = zg;
          acc[0][2] = zg8;
          const float z0g = acc[0][0] + sbias[L * NKT_W];
          const float z0g8 = acc[0][2] + sbias[L * NKT_W];
          if (SAVE) {
            z0s[pg] = z0g;
            z0s[pg8] = z0g8;
          }
          if (pg < n) a.out[3 * n + pg] = expf(nkt_clamp(z0g, -15.0f, 15.0f));
          if (pg8 < n) a.out[3 * n + pg8] = expf(nkt_clamp(z0g8, -15.0f, 15.0f));
        }
      }
      if (last) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc[0][e] = acc[0][e] + sbias[L * NKT_W + 2 * t + (e & 1)];
          acc[1][e] = acc[1][e] + sbias[L * NKT_W + 8 + 2 * t + (e & 1)];
        }
        break;
      }
      const int o = cur ^ 1;
      nkt_mma_finish(acc, NT, sbias + L * NKT_W, relu, buf[o], ldb[o], X, ldx,
                     K, swb + a.pk_off[L], a.pk_ld[L], list, lane, g, t);
      if (dens && li == a.nd - 1) {
        // color layer 0's input: the features, then SH4 of the view
        // directions of points g and g+8, rounded
        float sh[16];
        float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f, s3 = 0.0f;
        float s4 = 0.0f, s5 = 0.0f, s6 = 0.0f, s7 = 0.0f;
        const long long qg = pg < n ? pg : 0, qg8 = pg8 < n ? pg8 : 0;
        nkt_sh4(a.vdt[qg], a.vdt[n + qg], a.vdt[2 * n + qg], sh);
#pragma unroll
        for (int s = 0; s < 16; ++s) {
          if (s == 2 * t) s0 = sh[s];
          if (s == 2 * t + 1) s1 = sh[s];
          if (s == 2 * t + 8) s4 = sh[s];
          if (s == 2 * t + 9) s5 = sh[s];
        }
        nkt_sh4(a.vdt[qg8], a.vdt[n + qg8], a.vdt[2 * n + qg8], sh);
#pragma unroll
        for (int s = 0; s < 16; ++s) {
          if (s == 2 * t) s2 = sh[s];
          if (s == 2 * t + 1) s3 = sh[s];
          if (s == 2 * t + 8) s6 = sh[s];
          if (s == 2 * t + 9) s7 = sh[s];
        }
        uint32_t* Y = buf[o];
        const int ly = ldb[o], c0 = J / 2;
        Y[g * ly + c0 + t] = nkt_pack2(s0, s1);
        Y[(g + 8) * ly + c0 + t] = nkt_pack2(s2, s3);
        Y[g * ly + c0 + 4 + t] = nkt_pack2(s4, s5);
        Y[(g + 8) * ly + c0 + 4 + t] = nkt_pack2(s6, s7);
        __syncwarp();
        if (SAVE) nkt_save_tile(Y, ly, 0, J + 16, act, ld, rows.c_row[0], p0, lane);
      } else if (SAVE) {
        nkt_save_tile(buf[o], ldb[o], 0, J, act, ld,
                      dens ? rows.d_row[li + 1] : rows.c_row[li + 1], p0, lane);
      }
      __syncwarp();
      cur = o;
    }

    if (COLOR) {
      // rgb logits: columns 0-1 at t = 0, column 2 at t = 1
      if (t < 2) {
        const int j = 2 * t;
        if (pg < n) {
          a.out[j * n + pg] = acc[0][0];
          if (j + 1 < 3) a.out[(j + 1) * n + pg] = acc[0][1];
        }
        if (pg8 < n) {
          a.out[j * n + pg8] = acc[0][2];
          if (j + 1 < 3) a.out[(j + 1) * n + pg8] = acc[0][3];
        }
      }
    } else if (t < 2) {
      const int j = 2 * t;
      if (pg < n) {
        a.out[j * n + pg] = 0.0f;
        if (j + 1 < 3) a.out[(j + 1) * n + pg] = 0.0f;
      }
      if (pg8 < n) {
        a.out[j * n + pg8] = 0.0f;
        if (j + 1 < 3) a.out[(j + 1) * n + pg8] = 0.0f;
      }
    }
    __syncwarp();
  }
}

// What the tensor-core kernels take: C a multiple of 16; every layer at most
// NKT_W wide and a multiple of 16 where it feeds another product; with
// color, features and SH4 fill whole k-tiles and the last layer one n-tile.
static bool mma_dims_ok(const FusedArgs& a, bool color) {
  if (a.cp.n_comp % 16 || a.nd < 1) return false;
  for (int li = 0; li < a.nd; ++li)
    if (a.d_out[li] > NKT_W || ((li < a.nd - 1 || color) && a.d_out[li] % 16))
      return false;
  if (!color) return true;
  const int dout = a.d_out[a.nd - 1];
  if (a.nc < 1 || dout + 16 > NKT_W || a.c_in[0] != dout + 16) return false;
  for (int li = 0; li < a.nc; ++li)
    if (a.c_out[li] > NKT_W || (li < a.nc - 1 && a.c_out[li] % 16) ||
        (li == a.nc - 1 && a.c_out[li] > 8))
      return false;
  return true;
}

// Shared memory of the forward kernels in bf16 mode: the staged weights
// and biases, then per warp E (16 x L*C) and H (16 x the widest layer) in
// bf16; as many warps (at most 16) as fit one block.
static MmaLayout make_mma_layout_fwd(const FusedArgs& a, bool color) {
  MmaLayout lay;
  const int nl = color ? a.nd + a.nc : a.nd;
  lay.w_start = 0;
  lay.w_elems = color ? a.pk_fwd : a.pk_dens;
  lay.b_off = lay.w_elems * 2;
  lay.n_bias = nl;
  lay.tile_off = lay.b_off + nl * NKT_W * (int)sizeof(float);
  int w = 16;
  for (int li = 0; li < a.nd; ++li) w = a.d_out[li] > w ? a.d_out[li] : w;
  for (int li = 0; li < a.nc; ++li) w = a.c_out[li] > w ? a.c_out[li] : w;
  if (color && a.d_out[a.nd - 1] + 16 > w) w = a.d_out[a.nd - 1] + 16;
  w = (w + 15) & ~15;
  // E: one level (color kernels) or the whole encoding (density only)
  const int ew = color ? a.cp.n_comp : a.cp.n_levels * a.cp.n_comp;
  const int e = ((ew > w ? ew : w) + 15) & ~15;
  lay.lde = e / 2 + 4;  // = 4 (mod 8): conflict-free fragment loads
  lay.ldh = w / 2 + 4;
  lay.tile_bytes = NKT_MT * (lay.lde + lay.ldh) * 4 + NKT_TAP_BYTES + NKT_LIST_BYTES;
  int warps = (NKT_SMEM_MAX - lay.tile_off) / lay.tile_bytes;
  lay.warps = warps > NKT_MMA_MAX_WARPS ? NKT_MMA_MAX_WARPS : (warps < 1 ? 1 : warps);
  lay.total = lay.tile_off + lay.warps * lay.tile_bytes;
  return lay;
}
