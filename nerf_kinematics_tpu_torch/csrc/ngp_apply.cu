// Row 3 in bf16 mode: the forward of ngp_fused_apply_cf on the tensor cores.
//
// Replaces nerf_kinematics_tpu/ops/ngp_fused_pallas.py:441 (the forward of
// ngp_fused_apply_cf, _fwd_kernel) where use_bf16 = 1: (3, N) points and
// (3, N) unit directions -> (4, N), rows 0-2 rgb logits, row 3 sigma. f32
// mode keeps nkt_fused_apply_kernel (ngp_fused.cu), the FMA body. The
// arithmetic contract is ngp_fused.cuh's: bf16 operands, f32 sums (each
// 16-product partial of the tensor cores added with IEEE adds), every hidden
// value within NKT_NEAR of a bf16 rounding midpoint summed again in the plain
// version's order, the f32 feature 0 of sigma summed in that order for every
// point, and nkt_poison's NaN channels for non-finite line tables.
//
// What bounds it on this card: by operations 63.9 kFLOP a point at
// machina_ngp.yml's widths (20.48 M points: 1.39 ms at 989 TFLOP/s), by
// bytes 40 B a point; neither binds. The time goes to latency and issue:
// the sums taken again (a chain of K dependent adds a flagged value, one
// chain's length a layer a warp), the encoder's gathers (6 table rows a
// point and level from L2: 3 KB a point at machina's widths, 5.6 KB at
// fox's; the tables do not fit the L1 that the staged weights leave), the
// tap arithmetic, and the products' IEEE adds. This kernel, a warp a tile
// of 16 points and 16 warps a block:
//  * keeps one level of the encoding on chip (E) and the whole in the
//    warp's slot of device memory (FusedArgs::enc), written as it is made:
//    so 16 warps fit at every width (the whole encoding on chip leaves 14 at
//    machina's widths, 7 at fox's, and measured slower at both);
//  * sums again inline, the next 16-byte step of both rows loaded while the
//    current one is added (layer 0's rows from the slot, L2-resident);
//  * makes the taps of every level at once, on all lanes, with an exact
//    remainder in place of fmodf (nkt_taps<true>);
//  * gathers with a lane on 8 channels of a point (one 16-byte load a table
//    row) and issues the first rows of level l + 1 before level l's layer-0
//    products, so that they arrive while the tensor cores work.
// Measured alternatives, each slower (PERF.md section 6): two m16
// fragments a warp (32 points), the next pair's rows in flight during a
// pair's products, the encoding whole on chip.
#include "nkt_mma.cuh"

#define NKT_APPLY_WARPS 16  // warps a block at most

// Shared memory of the kernel (bytes): the staged weights and biases, then
// a region a warp: E (one level of the tile's encoding, later a hidden
// buffer), H (a hidden buffer; the taps of every level overlay it while the
// encoder runs) and the warp's list of re-sums.
// Mirrors ops/ngp_fused_cuda.py::apply_layout.
struct ApplyLayout {
  int w_elems;     // packed bf16 elements staged, at offset 0
  int b_off;       // f32 biases, NKT_W a layer
  int n_bias;      // layers whose biases are staged
  int tile_off;    // per-warp regions
  int tile_bytes;  // bytes of one warp's region
  int lde;         // 32-bit words a row of E
  int ldh;         // 32-bit words a row of H
  int h_bytes;     // bytes of H's region: H, or the taps, the larger
  int warps;       // warps a block
  int total;
};

static ApplyLayout make_apply_layout(const FusedArgs& a) {
  ApplyLayout lay;
  const int nl = a.nd + a.nc;
  lay.w_elems = a.pk_fwd;
  lay.b_off = lay.w_elems * 2;
  lay.n_bias = nl;
  lay.tile_off = lay.b_off + nl * NKT_W * (int)sizeof(float);
  int w = 16;
  for (int li = 0; li < a.nd; ++li) w = a.d_out[li] > w ? a.d_out[li] : w;
  for (int li = 0; li < a.nc; ++li) w = a.c_out[li] > w ? a.c_out[li] : w;
  if (a.d_out[a.nd - 1] + 16 > w) w = a.d_out[a.nd - 1] + 16;
  w = (w + 15) & ~15;
  const int C = a.cp.n_comp;
  const int e = ((C > w ? C : w) + 15) & ~15;
  lay.lde = e / 2 + 4;  // = 4 (mod 8): conflict-free fragment loads
  lay.ldh = w / 2 + 4;
  const int h = NKT_MT * lay.ldh * 4;
  const int taps = a.cp.n_levels * 3 * NKT_MT * (int)sizeof(NktTapS);
  lay.h_bytes = ((h > taps ? h : taps) + 15) & ~15;
  lay.tile_bytes = NKT_MT * lay.lde * 4 + lay.h_bytes + NKT_LIST_BYTES;
  const int warps = (NKT_SMEM_MAX - lay.tile_off) / lay.tile_bytes;
  lay.warps = warps > NKT_APPLY_WARPS ? NKT_APPLY_WARPS : (warps < 1 ? 1 : warps);
  lay.total = lay.tile_off + lay.warps * lay.tile_bytes;
  return lay;
}

// The packed weights (copied as they are) and every layer's bias.
__device__ __forceinline__ void apply_stage(const FusedArgs& a,
                                            const ApplyLayout& lay,
                                            unsigned char* smem) {
  const uint4* src = reinterpret_cast<const uint4*>(a.wpk);
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

// The taps of every level of the tile's points: taps[(l * 3 + axis) *
// NKT_MT + p]. A point past n takes the coordinate 0 (it writes nothing).
__device__ __forceinline__ void apply_taps(const FusedArgs& a, long long p0,
                                           NktTapS* taps, int lane) {
  const long long n = a.n;
  const int m = a.cp.n_levels * 3 * NKT_MT;
  for (int e = lane; e < m; e += 32) {
    const int la = e / NKT_MT, p = e - la * NKT_MT;
    const int l = la / 3, ax = la - l * 3;
    const long long pt = p0 + p;
    const float x = pt < n ? a.xt[ax * n + pt] : 0.0f;
    taps[e] = nkt_tap_s(nkt_taps<true>(x, a.cp, l, ax));
  }
}

// Issue the loads of a lane's (point, 8 channels) pair e of a level: the
// six table rows' 16 bytes. t4: the level's first table as 16-byte words
// (rows C8 apart, tables T rows apart); tl: the level's taps.
__device__ __forceinline__ void apply_load(const uint4* t4, int C8, int T,
                                           const NktTapS* tl, int e, uint4* v) {
  if (e < NKT_MT * C8) {
    const int p = e / C8, c8 = e - p * C8;
#pragma unroll
    for (int ax = 0; ax < 3; ++ax) {
      const NktTapS q = tl[ax * NKT_MT + p];
      v[2 * ax] = __ldg(t4 + (long long)ax * T * C8 + q.r0 * C8 + c8);
      v[2 * ax + 1] = __ldg(t4 + (long long)ax * T * C8 + q.r1 * C8 + c8);
    }
  }
}

// The two taps of one axis: w0 x0 + w1 x1 with one rounding (both products
// are exact: bf16 times bf16), as the plain version's sum of the two.
__device__ __forceinline__ float apply_tap(float w0, uint32_t x0, float w1,
                                           uint32_t x1) {
  return __fmaf_rn(w0, __uint_as_float(x0), w1 * __uint_as_float(x1));
}

// Word i of a 16-byte value (i known at compile time).
__device__ __forceinline__ uint32_t apply_word(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// The pair's products (ux uy) uz, rounded to bf16, into E (lde words a
// row) and into the level's columns of the warp's slot (LC elements a row,
// scol: the level's first).
__device__ __forceinline__ void apply_store(const uint4* v, int C8,
                                            const NktTapS* tl, int e,
                                            uint32_t* E, int lde,
                                            __nv_bfloat16* slot, int LC,
                                            int scol) {
  if (e < NKT_MT * C8) {
    const int p = e / C8, c8 = e - p * C8;
    const NktTapS qx = tl[p], qy = tl[NKT_MT + p], qz = tl[2 * NKT_MT + p];
    const float w[6] = {qx.w0, qx.w1, qy.w0, qy.w1, qz.w0, qz.w1};
    uint32_t o[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t M = 0xFFFF0000u;
      const uint32_t x0 = apply_word(v[0], i), x1 = apply_word(v[1], i);
      const uint32_t y0 = apply_word(v[2], i), y1 = apply_word(v[3], i);
      const uint32_t z0 = apply_word(v[4], i), z1 = apply_word(v[5], i);
      const float uxl = apply_tap(w[0], x0 << 16, w[1], x1 << 16);
      const float uxh = apply_tap(w[0], x0 & M, w[1], x1 & M);
      const float uyl = apply_tap(w[2], y0 << 16, w[3], y1 << 16);
      const float uyh = apply_tap(w[2], y0 & M, w[3], y1 & M);
      const float uzl = apply_tap(w[4], z0 << 16, w[5], z1 << 16);
      const float uzh = apply_tap(w[4], z0 & M, w[5], z1 & M);
      o[i] = nkt_pack2((uxl * uyl) * uzl, (uxh * uyh) * uzh);
    }
    const uint4 r = make_uint4(o[0], o[1], o[2], o[3]);
    *reinterpret_cast<uint4*>(E + p * lde + c8 * 4) = r;
    *reinterpret_cast<uint4*>(slot + p * LC + scol + c8 * 8) = r;
  }
}

// A non-finite table entry (nkt_poison), rarely: NaN in each channel of
// level l that nkt_poison makes NaN for one of its axes. Scalar arguments
// only: a reference to the kernel's argument struct would copy it to the
// stack.
static __device__ __noinline__ void apply_poison(__nv_bfloat16* E, int lde2,
                                                 const NktTapS* tl,
                                                 const unsigned* desc, int C,
                                                 int Fd, int lane) {
  for (int e = lane; e < NKT_MT * C; e += 32) {
    const int p = e / C, c = e - p * C;
    bool nan = false;
    for (int ax = 0; ax < 3; ++ax) {
      const NktTapS q = tl[ax * NKT_MT + p];
      nan |= nkt_poison(0.0f, desc[ax * C + c], q.r0,
                        nkt_operand_r1(q.r0, q.r1, Fd)) != 0.0f;
    }
    if (nan) E[p * lde2 + c] = __float2bfloat16_rn(__int_as_float(0x7FFFFFFF));
  }
}

// Within NKT_NEAR ulps of a bf16 rounding midpoint, on the bits of z: low 16
// bits in [0x8000 - 256, 0x8000 + 256), a superset of nkt_near_midpoint's
// (which leaves out 0x7F00): two integer operations.
__device__ __forceinline__ bool apply_near(float z) {
  return (((__float_as_uint(z) + 0x100u) ^ 0x8000u) & 0xFE00u) == 0u;
}

// Eight products of bf16 pairs added to acc in order, as nkt_chain does.
__device__ __forceinline__ float apply_fma8(const uint4& x, const uint4& w, float acc) {
  const uint32_t xs[4] = {x.x, x.y, x.z, x.w};
  const uint32_t ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    acc = __fmaf_rn(__uint_as_float(xs[j] << 16), __uint_as_float(ws[j] << 16), acc);
    acc = __fmaf_rn(__uint_as_float(xs[j] & 0xFFFF0000u),
                    __uint_as_float(ws[j] & 0xFFFF0000u), acc);
  }
  return acc;
}

// The plain version's sum of one output, as nkt_chain: an f32 fused
// multiply-add chain over k in order, from 0; x and w 16-byte aligned rows
// of bf16, K a multiple of 16. Inline, with the next 16-byte step of both
// rows loaded while the current one is added, so that the chain waits on
// its adds and not on its loads.
__device__ __forceinline__ float apply_chain(const __nv_bfloat16* x,
                                             const __nv_bfloat16* w, int K) {
  const uint4* x4 = reinterpret_cast<const uint4*>(x);
  const uint4* w4 = reinterpret_cast<const uint4*>(w);
  const int K8 = K / 8;
  uint4 xa = x4[0], wa = w4[0], xb, wb;
  float acc = 0.0f;
  for (int i = 0; i < K8; i += 2) {
    xb = x4[i + 1];
    wb = w4[i + 1];
    acc = apply_fma8(xa, wa, acc);
    if (i + 2 < K8) {
      xa = x4[i + 2];
      wa = w4[i + 2];
    }
    acc = apply_fma8(xb, wb, acc);
  }
  return acc;
}

// nkt_mma_finish with one list a tile and inline sums: z = acc + bias,
// ReLU when relu, the bf16 values into Y (ldy words a row); a value near a
// rounding midpoint is summed again in the plain version's order
// (apply_chain over the layer's input X, ldx words a row, K wide, and the
// row of Wt, ldw elements apart). Ends with the warp synchronised.
__device__ __forceinline__ void apply_finish(float (*acc)[4], int NT,
                                             const float* bias, bool relu,
                                             uint32_t* Y, int ldy,
                                             const uint32_t* X, int ldx, int K,
                                             const __nv_bfloat16* Wt, int ldw,
                                             unsigned short* list, int lane,
                                             int g, int t) {
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
        if (apply_near(z[e])) redo |= 1u << (nt * 4 + e);
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
  if (total == 0) {
    __syncwarp();
    return;
  }
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
      float z = apply_chain(xb + row * 2 * ldx, Wt + col * ldw, K) + bias[col];
      if (relu) z = nkt_relu(z);
      yb[row * 2 * ldy + col] = __float2bfloat16_rn(z);
    }
    ++at;
  }
  __syncwarp();
  for (int it = lane; it < min(total, NKT_LIST_CAP); it += 32) {
    const int row = list[it] / NKT_W, col = list[it] % NKT_W;
    float z = apply_chain(xb + row * 2 * ldx, Wt + col * ldw, K) + bias[col];
    if (relu) z = nkt_relu(z);
    yb[row * 2 * ldy + col] = __float2bfloat16_rn(z);
  }
  __syncwarp();
}

// One k-tile of a product: acc[nt] += rows of X (ldx words a row; ar: the
// lane's A address) times rows [8 nt, 8 nt + 8) of the packed matrix W (ld
// words a row; br: the lane's B address), kt the k-tile.
__device__ __forceinline__ void apply_ktile(const uint32_t* X, int ar,
                                            const uint32_t* W, int br, int ld,
                                            int NT, int kt, float (*acc)[4]) {
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

__device__ __forceinline__ int apply_a_row(int lane, int ldx) {
  return (lane & 15) * ldx + (lane >> 4) * 4;
}

__device__ __forceinline__ int apply_b_row(int lane, int ld) {
  return ((lane & 7) + ((lane >> 4) << 3)) * ld + ((lane >> 3) & 1) * 4;
}

// acc[nt] = X (KT k-tiles, KT <= NKT_W / 16) times rows [8 nt, 8 nt + 8)
// of W: a layer after the first, unrolled.
__device__ __forceinline__ void apply_dense(const uint32_t* X, int ldx, int KT,
                                            const uint32_t* W, int ld, int NT,
                                            float (*acc)[4], int lane) {
#pragma unroll
  for (int nt = 0; nt < NKT_MAX_NT; ++nt)
    acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.0f;
  const int ar = apply_a_row(lane, ldx), br = apply_b_row(lane, ld);
#pragma unroll
  for (int kt = 0; kt < NKT_W / 16; ++kt) {
    if (kt >= KT) break;
    apply_ktile(X, ar, W, br, ld, NT, kt, acc);
  }
}

// SH4 of the unit direction of point q (q < n), the values of columns
// 2t, 2t+1, 2t+8, 2t+9 rounded and packed.
__device__ __forceinline__ void apply_sh_pairs(const FusedArgs& a, long long q,
                                               int t, uint32_t& lo,
                                               uint32_t& hi) {
  const long long n = a.n;
  float sh[16];
  nkt_sh4(a.vdt[q], a.vdt[n + q], a.vdt[2 * n + q], sh);
  float s0 = 0.0f, s1 = 0.0f, s4 = 0.0f, s5 = 0.0f;
#pragma unroll
  for (int s = 0; s < 16; ++s) {
    if (s == 2 * t) s0 = sh[s];
    if (s == 2 * t + 1) s1 = sh[s];
    if (s == 2 * t + 8) s4 = sh[s];
    if (s == 2 * t + 9) s5 = sh[s];
  }
  lo = nkt_pack2(s0, s1);
  hi = nkt_pack2(s4, s5);
}

// One warp per tile of NKT_MT points, persistent over the tiles. Per tile:
// the taps of every level (all lanes), then per level its gathers into E
// and the warp's slot and its layer-0 k-tiles (the next level's first rows
// in flight during them), then every layer from the on-chip buffers (E, H,
// E, ...). Layer 0's re-sums read the slot.
__global__ void __launch_bounds__(NKT_APPLY_WARPS * 32, 1)
    nkt_apply_tile_kernel(FusedArgs a, ApplyLayout lay) {
  extern __shared__ __align__(16) unsigned char smem_apply[];
  apply_stage(a, lay, smem_apply);
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const uint32_t* sw = reinterpret_cast<const uint32_t*>(smem_apply);
  const __nv_bfloat16* swb = reinterpret_cast<const __nv_bfloat16*>(smem_apply);
  const float* sbias = reinterpret_cast<const float*>(smem_apply + lay.b_off);
  uint32_t* buf[2];
  buf[0] = reinterpret_cast<uint32_t*>(smem_apply + lay.tile_off + warp * lay.tile_bytes);
  buf[1] = buf[0] + NKT_MT * lay.lde;
  const int ldb[2] = {lay.lde, lay.ldh};
  uint32_t* E = buf[0];
  const int lde = lay.lde;
  NktTapS* taps = reinterpret_cast<NktTapS*>(buf[1]);
  unsigned short* list = reinterpret_cast<unsigned short*>(
      reinterpret_cast<unsigned char*>(buf[1]) + lay.h_bytes);
  const uint4* lines4 = reinterpret_cast<const uint4*>(a.lines16);
  const int C = a.cp.n_comp, C8 = C / 8, T = a.cp.table, L = a.cp.n_levels;
  const int LC = L * C;
  __nv_bfloat16* slot = static_cast<__nv_bfloat16*>(a.enc) +
                        ((long long)blockIdx.x * warps + warp) * NKT_MT * LC;
  const long long n = a.n;
  const long long n_tiles = (n + NKT_MT - 1) / NKT_MT;
  const unsigned pois_levels = nkt_poison_levels(a.cp);
  const uint32_t* W0 = sw + a.pk_off[0] / 2;
  const int ld0 = a.pk_ld[0] / 2;
  const int NT0 = (a.d_out[0] + 7) / 8;
  const int KL = C / 16;  // layer 0's k-tiles a level
  const int ar0 = apply_a_row(lane, lde), br0 = apply_b_row(lane, ld0);

  for (long long tt = (long long)blockIdx.x * warps + warp; tt < n_tiles;
       tt += (long long)gridDim.x * warps) {
    const long long p0 = tt * NKT_MT;
    apply_taps(a, p0, taps, lane);
    __syncwarp();

    // ---- the encoder, level by level, and layer 0's products ------------
    float acc[NKT_MAX_NT][4];
#pragma unroll
    for (int nt = 0; nt < NKT_MAX_NT; ++nt)
      acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.0f;
    uint4 v[6];
    apply_load(lines4, C8, T, taps, lane, v);
    for (int l = 0; l < L; ++l) {
      const NktTapS* tl = taps + l * 3 * NKT_MT;
      const uint4* t4 = lines4 + (long long)l * 3 * T * C8;
      for (int e = lane; e < NKT_MT * C8; e += 32) {
        apply_store(v, C8, tl, e, E, lde, slot, LC, l * C);
        if (e + 32 < NKT_MT * C8) apply_load(t4, C8, T, tl, e + 32, v);
      }
      __syncwarp();
      if ((pois_levels >> l) & 1u) {
        apply_poison(reinterpret_cast<__nv_bfloat16*>(E), 2 * lde, tl,
                     nkt_poison_descs(a.cp, l), C, nkt_dup_row(a.cp, l, true), lane);
        __syncwarp();
        for (int e = lane; e < NKT_MT * C8; e += 32) {  // the slot takes E's level
          const int p = e / C8, c8 = e - p * C8;
          *reinterpret_cast<uint4*>(slot + p * LC + l * C + c8 * 8) =
              *reinterpret_cast<const uint4*>(E + p * lde + c8 * 4);
        }
      }
      // the next level's first rows, in flight during this level's products
      if (l + 1 < L) apply_load(t4 + 3LL * T * C8, C8, T, tl + 3 * NKT_MT, lane, v);
      for (int kt = 0; kt < KL; ++kt)
        apply_ktile(E, ar0, W0 + l * KL * 8, br0, ld0, NT0, kt, acc);
      __syncwarp();
    }

    // ---- every layer: finish (bias, ReLU, rounding into the other buffer),
    // then the next product from there -------------------------------------
    int cur = 0;
    const int nl = a.nd + a.nc;
    const long long pg = p0 + g, pg8 = p0 + g + 8;
    for (int Ly = 0; Ly < nl; ++Ly) {
      const bool dens = Ly < a.nd;
      const int li = dens ? Ly : Ly - a.nd;
      const int K = dens ? a.d_in[li] : a.c_in[li];
      const int J = dens ? a.d_out[li] : a.c_out[li];
      const int NT = (J + 7) / 8;
      if (Ly > 0)
        apply_dense(buf[cur], ldb[cur], (K + 15) / 16, sw + a.pk_off[Ly] / 2,
                    a.pk_ld[Ly] / 2, NT, acc, lane);
      // the layer's input, whole: layer 0's is in the slot
      const uint32_t* X = Ly == 0 ? reinterpret_cast<const uint32_t*>(slot) : buf[cur];
      const int ldx = Ly == 0 ? LC / 2 : ldb[cur];
      if (dens && li == a.nd - 1) {
        // sigma comes from the f32 feature 0, summed in the plain version's
        // order for every point (lanes 0-15, one point each) in place of the
        // tensor cores' sum
        float zc = 0.0f;
        if (lane < NKT_MT)
          zc = apply_chain(reinterpret_cast<const __nv_bfloat16*>(X) + lane * 2 * ldx,
                           swb + a.pk_off[Ly], K);
        const float zg = __shfl_sync(0xffffffffu, zc, g);
        const float zg8 = __shfl_sync(0xffffffffu, zc, g + 8);
        if (t == 0) {
          acc[0][0] = zg;
          acc[0][2] = zg8;
          const float b0 = sbias[Ly * NKT_W];
          if (pg < n) a.out[3 * n + pg] = expf(nkt_clamp(zg + b0, -15.0f, 15.0f));
          if (pg8 < n) a.out[3 * n + pg8] = expf(nkt_clamp(zg8 + b0, -15.0f, 15.0f));
        }
      }
      if (Ly == nl - 1) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[0][e] = acc[0][e] + sbias[Ly * NKT_W + 2 * t + (e & 1)];
        break;
      }
      const int o = cur ^ 1;
      const bool relu = dens ? li < a.nd - 1 : li < a.nc - 1;
      apply_finish(acc, NT, sbias + Ly * NKT_W, relu, buf[o], ldb[o], X, ldx, K,
                   swb + a.pk_off[Ly], a.pk_ld[Ly], list, lane, g, t);
      if (dens && li == a.nd - 1) {
        // color layer 0's input: the features, then SH4 of the view
        // directions of points g and g + 8, rounded
        uint32_t* Y = buf[o];
        const int ly = ldb[o], c0 = J / 2;
        uint32_t lo, hi, lo8, hi8;
        apply_sh_pairs(a, pg < n ? pg : 0, t, lo, hi);
        apply_sh_pairs(a, pg8 < n ? pg8 : 0, t, lo8, hi8);
        Y[g * ly + c0 + t] = lo;
        Y[(g + 8) * ly + c0 + t] = lo8;
        Y[g * ly + c0 + 4 + t] = hi;
        Y[(g + 8) * ly + c0 + 4 + t] = hi8;
      }
      __syncwarp();
      cur = o;
    }

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
    __syncwarp();
  }
}

// Bytes of shared memory a launch with these arguments asks for.
long long nkt_apply_smem_bytes(const FusedArgs& a) {
  return make_apply_layout(a).total;
}

// The layout's numbers, for the host's mirror (ops/ngp_fused_cuda.py::
// apply_layout): warps, lde, ldh, h_bytes, tile_bytes, total.
extern "C" void nkt_apply_layout(const FusedArgs* args, long long* out) {
  const ApplyLayout lay = make_apply_layout(*args);
  out[0] = lay.warps;
  out[1] = lay.lde;
  out[2] = lay.ldh;
  out[3] = lay.h_bytes;
  out[4] = lay.tile_bytes;
  out[5] = lay.total;
}

// The bf16 forward with color (the table scan already queued), on the
// wrapper's slots (FusedArgs::enc, enc_slots): a grid of at most
// enc_slots / warps blocks.
int nkt_apply_forward(const FusedArgs& a, int n_sm, cudaStream_t st) {
  if (!mma_dims_ok(a, true) || a.n < 1 || !a.enc) return (int)cudaErrorInvalidValue;
  const ApplyLayout lay = make_apply_layout(a);
  if (lay.total > NKT_SMEM_MAX) return (int)cudaErrorInvalidValue;
  const size_t bytes = (size_t)lay.total;
  const long long tiles = (a.n + NKT_MT - 1) / NKT_MT;
  const int threads = lay.warps * 32;
  long long want = (tiles + lay.warps - 1) / lay.warps;
  if (want > a.enc_slots / lay.warps) want = a.enc_slots / lay.warps;
  if (want < 1) return (int)cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      nkt_apply_tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const long long blocks =
      persistent_blocks(nkt_apply_tile_kernel, threads, bytes, want, n_sm);
  nkt_apply_tile_kernel<<<(unsigned)blocks, threads, bytes, st>>>(a, lay);
  return (int)cudaGetLastError();
}
