// The stand-alone CP-grid encoder: its forward (nkt_cp_encode) and the line
// tables' gradient (nkt_dlines_launch), which the fused gradient kernels of
// csrc/ngp_fused_bwd.cu and csrc/ngp_fused_full.cu call too.
#include <climits>
#include <stdint.h>

#include "nkt_mma.cuh"

// Rows of level l's tables that its taps reach: the fold width of a folded
// level, R + 1 of an un-folded one (p < R, so r1 <= R).
__host__ __device__ inline int nkt_level_rows(const CPLevels& cp, int l) {
  if (cp.F[l] > 0) return cp.F[l];
  return cp.R[l] + 1 < cp.table ? cp.R[l] + 1 : cp.table;
}

static int nkt_max_rows(const CPLevels& cp) {
  int m = 1;
  for (int l = 0; l < cp.n_levels; ++l)
    m = nkt_level_rows(cp, l) > m ? nkt_level_rows(cp, l) : m;
  return m;
}

// bf16 pair -> the f32 values of its low and high half.
__device__ __forceinline__ float nkt_bf_lo(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float nkt_bf_hi(uint32_t v) { return __uint_as_float(v & 0xFFFF0000u); }

// ---------------------------------------------------------------------------
// Forward.
//
// Replaces the TPU kernel nerf_kinematics_tpu/ops/cp_grid_pallas.py::
// cp_encode_pallas forward (_fwd_kernel), which builds (T, B) tent operands
// and contracts them with the line tables on the matrix unit. Here a point's
// feature at a level is two indexed loads per axis and channel, summed in
// f32, and the product of the three axes: w0 v0 + w1 v1 per axis, then
// (u0 u1) u2, the plain version's order, so both give the same bits.
//
// Bound on this card: bytes, the 4 * L * C B of f32 output each point writes
// (1 024 B at L = 4, C = 64; 12 B of coordinates in). A block takes one level,
// one slice of the channels and a strided run of 128-point batches. It holds
// the slice of the level's three tables in shared memory (the rows the taps
// reach; bf16 values in bf16 mode, 74 KB at T = 192, C = 64, else f32),
// computes each point's taps once per axis into shared memory, and writes
// each (point, level) row of the slice with 16-byte stores from consecutive
// lanes. The slice is all C channels where the three tables fit (every
// shipped configuration), else the fewest equal parts that fit.
#define NKT_FW_THREADS 256
#define NKT_FW_BATCH 128  // points whose taps are staged at once

static size_t nkt_fw_smem(const CPLevels& cp, int W) {
  const size_t es = cp.use_bf16 ? 2 : 4;
  return (size_t)NKT_FW_BATCH * 3 * sizeof(NktTapS) +
         (size_t)3 * nkt_max_rows(cp) * W * es;
}

// Channels c..c+3 of row r of table slot a: 4 values from shared memory.
template <bool BF>
__device__ __forceinline__ float4 nkt_row4(const unsigned char* tabs, int e) {
  if constexpr (BF) {
    const uint2 v = *reinterpret_cast<const uint2*>(
        reinterpret_cast<const __nv_bfloat16*>(tabs) + e);
    return make_float4(nkt_bf_lo(v.x), nkt_bf_hi(v.x), nkt_bf_lo(v.y), nkt_bf_hi(v.y));
  } else {
    return *reinterpret_cast<const float4*>(reinterpret_cast<const float*>(tabs) + e);
  }
}

template <bool BF>
__device__ __forceinline__ float nkt_row1(const unsigned char* tabs, int e) {
  if constexpr (BF)
    return __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(tabs)[e]);
  else
    return reinterpret_cast<const float*>(tabs)[e];
}

// Stages channels c0 .. c0 + cw of level l's three tables (rows 0 .. TE / cw)
// into tabs, axis by axis, rows cw apart: bf16 values in bf16 mode.
template <bool BF>
__device__ __forceinline__ void nkt_stage_tables(unsigned char* tabs,
                                                 const float* __restrict__ lines,
                                                 int l, int T, int C, int c0,
                                                 int cw, int TE, int tid,
                                                 int nthr) {
  for (int e = tid; e < 3 * TE; e += nthr) {
    const int a = e / TE, rc = e - a * TE, r = rc / cw;
    const float v = lines[((long long)(l * 3 + a) * T + r) * C + c0 + (rc - r * cw)];
    if constexpr (BF)
      reinterpret_cast<__nv_bfloat16*>(tabs)[e] = __float2bfloat16_rn(v);
    else
      reinterpret_cast<float*>(tabs)[e] = v;
  }
}

template <bool BF>
__global__ void __launch_bounds__(NKT_FW_THREADS)
    nkt_cp_encode_kernel(const float* __restrict__ x,
                         const float* __restrict__ lines,
                         float* __restrict__ out, long long n, CPLevels cp,
                         int W) {
  extern __shared__ __align__(16) unsigned char smem_fw[];
  const int C = cp.n_comp, T = cp.table, L = cp.n_levels, LC = L * C;
  const int P = (C + W - 1) / W;  // channel slices
  const int l = blockIdx.x % L;
  const int c0 = (blockIdx.x / L) % P * W;
  const int cw = C - c0 < W ? C - c0 : W;
  const int TE = nkt_level_rows(cp, l) * cw;  // entries of one axis' slice
  const int tid = threadIdx.x;
  NktTapS* taps = reinterpret_cast<NktTapS*>(smem_fw);
  unsigned char* tabs = smem_fw + NKT_FW_BATCH * 3 * sizeof(NktTapS);
  nkt_stage_tables<BF>(tabs, lines, l, T, C, c0, cw, TE, tid, NKT_FW_THREADS);
  // a non-finite table entry (nkt_poison): the stand-alone encoder's rows
  const bool pois = nkt_poisoned(cp, l, 0) || nkt_poisoned(cp, l, 1) || nkt_poisoned(cp, l, 2);
  const long long nb = (n + NKT_FW_BATCH - 1) / NKT_FW_BATCH;
  const long long per = gridDim.x / (L * P);
  for (long long b = blockIdx.x / (L * P); b < nb; b += per) {
    const long long p0 = b * NKT_FW_BATCH;
    const int np = n - p0 < NKT_FW_BATCH ? (int)(n - p0) : NKT_FW_BATCH;
    __syncthreads();  // the tables staged; the last batch's taps read
    for (int e = tid; e < np * 3; e += NKT_FW_THREADS)
      taps[e] = nkt_tap_s(nkt_taps(x[p0 * 3 + e], cp, l, e % 3));
    __syncthreads();
    float* dst = out + p0 * LC + l * C + c0;
    if (C % 4 == 0) {  // then W and cw are multiples of 4 too
      const int C4 = cw / 4;
      for (int e = tid; e < np * C4; e += NKT_FW_THREADS) {
        const int pp = e / C4, c = (e - pp * C4) * 4;
        float4 u[3];
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          const NktTapS q = taps[pp * 3 + a];
          const float4 v0 = nkt_row4<BF>(tabs, a * TE + q.r0 * cw + c);
          const float4 v1 = nkt_row4<BF>(tabs, a * TE + q.r1 * cw + c);
          u[a] = make_float4(q.w0 * v0.x + q.w1 * v1.x, q.w0 * v0.y + q.w1 * v1.y,
                             q.w0 * v0.z + q.w1 * v1.z, q.w0 * v0.w + q.w1 * v1.w);
        }
        *reinterpret_cast<float4*>(dst + (long long)pp * LC + c) = make_float4(
            (u[0].x * u[1].x) * u[2].x, (u[0].y * u[1].y) * u[2].y,
            (u[0].z * u[1].z) * u[2].z, (u[0].w * u[1].w) * u[2].w);
      }
    } else {
      for (int e = tid; e < np * cw; e += NKT_FW_THREADS) {
        const int pp = e / cw, c = e - pp * cw;
        float u[3];
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          const NktTapS q = taps[pp * 3 + a];
          u[a] = q.w0 * nkt_row1<BF>(tabs, a * TE + q.r0 * cw + c) +
                 q.w1 * nkt_row1<BF>(tabs, a * TE + q.r1 * cw + c);
        }
        dst[(long long)pp * LC + c] = (u[0] * u[1]) * u[2];
      }
    }
    if (pois) {  // rarely: NaN where a line feature is (after the writes)
      __syncthreads();
      for (int e = tid; e < np * cw; e += NKT_FW_THREADS) {
        const int pp = e / cw, c = e - pp * cw;
        bool nan = false;
        for (int a = 0; a < 3; ++a) {
          const NktTapS q = taps[pp * 3 + a];
          nan |= nkt_poison(0.0f, nkt_poison_desc(cp, l, a, c0 + c), q.r0, q.r1) != 0.0f;
        }
        if (nan) dst[(long long)pp * LC + c] = __int_as_float(0x7FFFFFFF);
      }
    }
  }
}

// x: (n, 3) f32; lines: (L, 3, T, C) f32; out: (n, L*C) f32.
extern "C" int nkt_cp_encode(const void* x, const void* lines, void* out,
                             long long n, const CPLevels* cp, int n_sm,
                             void* stream) {
  // the channel slice: all C, else the widest part of equal parts that fits
  const int C = cp->n_comp, q = C % 4 == 0 ? 4 : 1;
  int W = C, P = 1;
  while (nkt_fw_smem(*cp, W) > NKT_SMEM_MAX && W > q) {
    ++P;
    W = ((C + P - 1) / P + q - 1) / q * q;
  }
  const size_t bytes = nkt_fw_smem(*cp, W);
  if (n <= 0 || bytes > NKT_SMEM_MAX) return (int)cudaErrorInvalidValue;
  const int L = cp->n_levels;
  P = (C + W - 1) / W;
  const long long nb = (n + NKT_FW_BATCH - 1) / NKT_FW_BATCH;
  // two blocks an SM in all, a run of batches each
  long long per = (2LL * n_sm + L * P - 1) / (L * P);
  if (per > nb) per = nb;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = nkt_table_scan((const float*)lines, *cp, false, st);
  if (err != cudaSuccess) return (int)err;
  if (cp->use_bf16) {
    err = cudaFuncSetAttribute(nkt_cp_encode_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
    nkt_cp_encode_kernel<true><<<(unsigned)(per * L * P), NKT_FW_THREADS, bytes, st>>>(
        (const float*)x, (const float*)lines, (float*)out, n, *cp, W);
  } else {
    err = cudaFuncSetAttribute(nkt_cp_encode_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
    nkt_cp_encode_kernel<false><<<(unsigned)(per * L * P), NKT_FW_THREADS, bytes, st>>>(
        (const float*)x, (const float*)lines, (float*)out, n, *cp, W);
  }
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The line tables' gradient, on the tensor cores, in a fixed order.
//
// Replaces the TPU kernel cp_grid_pallas.py::cp_encode_pallas VJP
// (_bwd_kernel, _forward_bwd), which contracts per level and axis
// dlines[l, a] += W (T_l x B) . grad_u (B x C) on the matrix unit, W the
// two-hot tent of B points and grad_u = g u_b u_c cast to the weights' type,
// and adds every block's result into one resident accumulator. It is also
// the encoder half of the fused gradients (csrc/ngp_fused_bwd.cu), whose
// per-point backward writes the encoding's f32 cotangent to scratch and
// calls nkt_dlines_launch on the same stream. Positions get no gradient.
//
// The same contraction, done with mma.sync. The grid runs over (point chunk,
// level, channel slice, row group): one block takes the three axes of its
// level, so that the cotangent and the taps are read once. A block holds its
// slice of the level's tables in shared memory (bf16 in bf16 mode, where
// they are bf16-rounded already; f32 otherwise) and takes its chunk 64
// points at a time (32 in f32 mode). Its warps have two jobs. Eight
// producer warps stage each batch's cotangent rows and coordinates by
// cp.async, compute its taps, and make its B operand, grad_u = round(g (u_b
// u_c)) for every (point, channel) and axis, once, as (points, channels) in
// shared memory; up to twelve product warps run the products. The two sides
// hand the batches over through two stages and named barriers ("stage s is
// full", "stage s is free"), so a batch's products run while the next
// batch's B operand is made. The product warps' f32 sums stay in registers
// for the whole chunk, so setmaxnreg moves registers from the producers (32
// a thread) to them (136).
//
// Each product warp owns a 16-row tile of the tables times the block's
// channels (at most 64: eight 16 x 8 output tiles an axis) of each axis. A
// point adds nothing to a tile that neither of its taps falls in, so per
// axis the warp lists the batch's points that tap its tile (a ballot, in
// point order) and takes them 16 at a time: the k-tiles, the last padded
// with a zero point (zero taps, zero B row). Over all points, about one tent
// weight in a hundred of a tile would be nonzero at T = 192. The A operand,
// the tent, is built in registers from the staged taps: the element (row r,
// entry k) is w0 if r == r0, else w1 if r == r1, else 0, of entry k's point.
// A wrap tap of a periodic folded level arrives with r1 = 0 (and r0 = F -
// 1); a hash fold that sends both cells to one row arrives with both weights
// in w0 and w1 = 0: each weight lands once. No (T_l x B) operand is written.
// The B fragments are the entries' rows of the B operand, gathered by
// ldmatrix.
//
// The flagship's tables (192 rows x 64 channels) take one block a (chunk,
// level): twelve row tiles, all channels. Larger tables split: the channels
// into the fewest slices of at most 64 whose block fits shared memory, the
// row tiles into the fewest groups of at most twelve, each group's block
// making the B operand of its slice again.
//
// bf16 mode: mma.m16n8k16, bf16 tent (the weights are bf16 values) and
// grad_u, so every product is exact in f32; B fragments by ldmatrix.trans.
// f32 mode: two mma.m16n8k8 per k-tile in 3xTF32, both operands split as
// they are read. Either way a k-tile's products are summed from zero and
// added to the accumulator with IEEE adds (nkt_mma_add, nkt_mma3_add): the
// tensor cores' own adds truncate. Each accumulator has one owner and the
// k-tiles run in order, so two launches give the same bits. At the end each
// block writes its tiles of the (level, axis) tables to partial[chunk], and
// nkt_reduce_partials_launch (csrc/ngp_fused_bwd.cu) adds the chunks in
// chunk order.
//
// A non-finite grad_u (or a NaN coordinate, whose tent weights are NaN): the
// Pallas kernel's dense product meets it with every row it contracts over,
// so in its column a NaN, or an inf times a tent weight of 0, is NaN on
// every such row, and an inf keeps its sign only on the rows that every such
// point taps with a weight above 0. A NaN coordinate on a hash-folded level
// taps one row (nkt_taps), where alone its tent is NaN: with a finite grad_u
// it makes that row NaN in every column and leaves the others alone. In
// bf16 mode the product warps flag a launch whose sums they find
// non-finite; in f32 mode the producers test the grad_u they make (a fused
// multiply-add for every two values) and flag it. Nothing more runs in the producers' 32 registers: two launches follow
// that end at once on finite inputs. nkt_dl_record_kernel makes the record (per
// (level, axis, channel) a NaN flag, the signs and the count of inf entries,
// the rows one of them taps and how many of them tap each; in the launch's
// scratch, see nkt_dl_col), and
// nkt_dl_nonfinite_kernel writes those columns' classes, as the plain
// version does (ops/cp_grid.py::nonfinite_dlines). Finite columns keep the
// products' sums. Integer atomics only: the counts, and so the result, do
// not depend on the order.
//
// Bound on this card: bytes, the cotangent read once (4 * L * C B a point)
// and the tables written once. What it runs: per k-tile of 16 entries and
// axis a product warp builds 8 tent weights a lane and runs 8 products and
// 32 adds (C = 64); the accumulators (147 KB at T = 192, C = 64) hold one
// block an SM, whose warps wait on latency more than on any unit
// (scripts/torch_ablate_cp.py takes it apart).
#define NKT_DL_BATCH 64  // points staged at once: four k-tiles of 16
#define NKT_DL_MAX_WARPS 12  // product warps a block
#define NKT_DL_PWARPS 8      // warps that make the taps and the B operand
#define NKT_DL_PREGS 32      // their registers a thread (setmaxnreg), and the
#define NKT_DL_QREGS 136     // product warps': 32 x 256 + 136 x 384 <= the
                             // block's 96 x 640 at launch
#define NKT_DL_THREADS ((NKT_DL_PWARPS + NKT_DL_MAX_WARPS) * 32)
// f32 mode: half the batch, to fit shared memory
#define NKT_DL_B(bf) ((bf) ? NKT_DL_BATCH : NKT_DL_BATCH / 2)

// One block's shape and shared memory, in bytes from its start: the tables,
// two batches of cotangent rows, of coordinates, of taps and of the B
// operand of each axis (each with the zero point B), and each product warp's
// list of points.
struct DlLayout {
  int W;      // channels a block takes (its slice; the last may be narrower)
  int ncs;    // channel slices
  int tpg;    // row tiles of 16 a block takes
  int nrg;    // row groups: tpg * nrg tiles cover the most rows a level reaches
  int warps;  // product warps: tpg rounded up to whole warpgroups
  int ldu;    // elements per point of the B operand (W rounded up to 16, + 8)
  int tab, gbuf, xbuf, tbuf, gu, list, total;
};

static DlLayout dl_layout(const CPLevels& cp, int W) {
  const bool bf = cp.use_bf16 != 0;
  const int B = NKT_DL_B(bf);
  const int es = bf ? 2 : 4;
  const int rows = nkt_max_rows(cp), rt = (rows + 15) / 16;
  DlLayout d;
  d.W = W;
  d.ncs = (cp.n_comp + W - 1) / W;
  d.nrg = (rt + NKT_DL_MAX_WARPS - 1) / NKT_DL_MAX_WARPS;
  d.tpg = (rt + d.nrg - 1) / d.nrg;
  d.warps = (d.tpg + 3) / 4 * 4;
  d.ldu = (W + 15) / 16 * 16 + 8;
  d.tab = 0;
  d.gbuf = (3 * rows * W * es + 15) / 16 * 16;
  d.xbuf = d.gbuf + 2 * B * W * 4;
  d.tbuf = d.xbuf + 2 * B * 3 * 4;
  d.gu = d.tbuf + 2 * (B + 1) * 3 * 16;
  d.list = (d.gu + 2 * 3 * (B + 1) * d.ldu * es + 15) / 16 * 16;
  d.total = d.list + d.warps * B;
  return d;
}

__device__ __forceinline__ void nkt_dl_cp4(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src)
               : "memory");
}

// A tap pair as the block keeps it: (r0, r1, w0 bits, w1 bits), one
// 16-byte load.
__device__ __forceinline__ int4 nkt_tap4(const NktTaps& t) {
  return make_int4(t.r0, t.r1, __float_as_int(t.w0), __float_as_int(t.w1));
}

// The tent weight of tap pair q at row r.
__device__ __forceinline__ float nkt_tent(const int4& q, int r) {
  return q.x == r ? __int_as_float(q.z) : (q.y == r ? __int_as_float(q.w) : 0.0f);
}

// Channels c, c + 1 of entry e of the tables (C even).
template <bool BF>
__device__ __forceinline__ float2 nkt_row2(const unsigned char* tabs, int e) {
  if constexpr (BF) {
    const uint32_t v = *reinterpret_cast<const uint32_t*>(
        reinterpret_cast<const __nv_bfloat16*>(tabs) + e);
    return make_float2(nkt_bf_lo(v), nkt_bf_hi(v));
  } else {
    return *reinterpret_cast<const float2*>(reinterpret_cast<const float*>(tabs) + e);
  }
}

// The two channels' line features of one tap pair: w0 v0 + w1 v1 (rows cw
// apart).
template <bool BF>
__device__ __forceinline__ float2 nkt_feat2(const unsigned char* tabs, int base,
                                            const int4& q, int cw, int c) {
  const float w0 = __int_as_float(q.z), w1 = __int_as_float(q.w);
  const float2 v0 = nkt_row2<BF>(tabs, base + q.x * cw + c);
  const float2 v1 = nkt_row2<BF>(tabs, base + q.y * cw + c);
  return make_float2(w0 * v0.x + w1 * v1.x, w0 * v0.y + w1 * v1.y);
}

__device__ __forceinline__ void nkt_bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}
__device__ __forceinline__ void nkt_bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// The record of non-finite grad_u (see above), at nf = cp.nonfinite +
// nkt_nf_rec(cp) (nkt_common.cuh), zeroed by the launch's table scan: nf[0]
// "a producer met one, or something is to be recorded"; then NKT_REC words
// per (level, axis, channel): [0] bit 31 "a NaN", bit 30 "a -inf", bit 29
// "a +inf", bit 28 "a NaN coordinate taps one row" (nkt_dl_nan_row) and the
// count of inf entries; [1] the operand rows that one inf entry of the
// column taps with a weight above 0, (row a + 1) << 16 | (row
// b + 1) (0: none), the only rows every inf entry can tap; [2], [3] the
// counts of inf entries that tap row a, row b.
__device__ __forceinline__ unsigned* nkt_dl_col(unsigned* nf, const CPLevels& cp,
                                                int la, int c) {
  return nf + 1 + ((long long)la * cp.n_comp + c) * NKT_REC;
}

// Channel c of one point's grad_u of the three axes, v (as the B operand
// holds it), with the point's tap pairs q.
__device__ __forceinline__ void nkt_dl_record(unsigned* nf, const CPLevels& cp,
                                              int l, int c, const float* v,
                                              const int4* q, int Fd) {
  nf[0] = 1u;
  for (int j = 0; j < 3; ++j) {
    const float w0 = __int_as_float(q[j].z), w1 = __int_as_float(q[j].w);
    const int t0 = q[j].x, t1 = nkt_operand_r1(q[j].x, q[j].y, Fd);
    unsigned* col = nkt_dl_col(nf, cp, l * 3 + j, c);
    const bool one_row = w0 != w0 && q[j].x == q[j].y;
    if (v[j] != v[j] || (w0 != w0 && (!one_row || isinf(v[j])))) {
      atomicOr(col, 0x80000000u);
    } else if (one_row) {
      atomicOr(col, 0x10000000u);
    } else if (isinf(v[j])) {
      atomicAdd(col, 1u);
      atomicOr(col, v[j] > 0.0f ? 0x20000000u : 0x40000000u);
      const int ra = w0 > 0.0f ? t0 : -1;
      const int rb = w1 > 0.0f && t1 != ra ? t1 : -1;
      const unsigned mine = (unsigned)(ra + 1) << 16 | (unsigned)(rb + 1);
      const unsigned old = atomicCAS(col + 1, 0u, mine);
      const unsigned claim = old ? old : mine;
      const int ca = (int)(claim >> 16) - 1, cb = (int)(claim & 0xFFFFu) - 1;
      if (ca >= 0 && (ca == ra || ca == rb)) atomicAdd(col + 2, 1u);
      if (cb >= 0 && (cb == ra || cb == rb)) atomicAdd(col + 3, 1u);
    }
  }
}

// The record of a launch whose producers met a non-finite grad_u (nf[0]) or
// whose tables hold a non-finite entry (the scan's flags); returns at once
// otherwise. grad_u of every (point, level, axis, channel) again, in the
// producers' arithmetic, with a poisoned line feature NaN (nkt_poison), and
// each non-finite entry recorded (nkt_dl_record).
template <bool BF>
__global__ void __launch_bounds__(256)
    nkt_dl_record_kernel(const float* __restrict__ x, long long xs_i,
                         long long xs_a, const float* __restrict__ lines,
                         const float* __restrict__ g, long long gs_i,
                         long long n, CPLevels cp, int dup,
                         unsigned* __restrict__ nf) {
  const int L = cp.n_levels, C = cp.n_comp, T = cp.table;
  bool pois = false;
  for (int la = 0; la < 3 * L; ++la) pois |= cp.nonfinite[la] != 0u;
  if (*(volatile unsigned*)nf == 0u && !pois) return;
  const long long total = n * L * C;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += (long long)gridDim.x * blockDim.x) {
    const int c = (int)(e % C), l = (int)(e / C % L);
    const long long i = e / C / L;
    const int Fd = nkt_dup_row(cp, l, dup != 0);
    int4 q[3];
    float u[3];
    for (int a = 0; a < 3; ++a) {
      const NktTaps t = nkt_taps(x[i * xs_i + a * xs_a], cp, l, a);
      q[a] = nkt_tap4(t);
      const float* tab = lines + (long long)(l * 3 + a) * T * C + c;
      float v0 = tab[(long long)t.r0 * C], v1 = tab[(long long)t.r1 * C];
      if (BF) {
        v0 = nkt_bf16r(v0);
        v1 = nkt_bf16r(v1);
      }
      u[a] = t.w0 * v0 + t.w1 * v1;
      if (nkt_poisoned(cp, l, a))
        u[a] = nkt_poison(u[a], nkt_poison_desc(cp, l, a, c), t.r0,
                          nkt_operand_r1(t.r0, t.r1, Fd));
    }
    const float gc = g[i * gs_i + l * C + c];
    float v[3] = {gc * (u[1] * u[2]), gc * (u[0] * u[2]), gc * (u[0] * u[1])};
    bool bad = false;
    for (int j = 0; j < 3; ++j) {
      if (BF) v[j] = nkt_bf16r(v[j]);
      bad |= !isfinite(v[j]) || __int_as_float(q[j].z) != __int_as_float(q[j].z);
    }
    if (bad) nkt_dl_record(nf, cp, l, c, v, q, Fd);
  }
}

// The row that a NaN coordinate taps at level l, axis a (nkt_taps).
__device__ __forceinline__ int nkt_dl_nan_row(const CPLevels& cp, int l, int a) {
  return nkt_taps(__int_as_float(0x7FC00000), cp, l, a).r0;
}

// The classes of the recorded columns, into dlines (L, 3, T, C): NaN on
// every operand row, except where every inf entry of the column taps the row
// with a weight above 0 and all have one sign (that inf); operand row F of a
// dup level is row 0 (the classes add), rows past T are padding. A column
// whose only record is bit 28 is NaN on its NaN coordinates' row alone, and
// that row is NaN whatever the column's class. One block; it returns at once
// when nothing was recorded.
__global__ void __launch_bounds__(1024)
    nkt_dl_nonfinite_kernel(float* __restrict__ dlines,
                            const unsigned* __restrict__ nf, CPLevels cp,
                            int dup) {
  if (nf[0] == 0u) return;
  const int C = cp.n_comp, T = cp.table;
  for (int e = threadIdx.x; e < cp.n_levels * 3 * C; e += blockDim.x) {
    const unsigned* col = nf + 1 + (long long)e * NKT_REC;
    const unsigned k = col[0];
    if (k == 0u) continue;
    const int la = e / C, c = e - la * C, l = la / 3;
    float* dst = dlines + (long long)la * T * C + c;
    const int nan_row = k & 0x10000000u ? nkt_dl_nan_row(cp, l, la - l * 3) : -1;
    if (k == 0x10000000u) {
      dst[(long long)nan_row * C] = __int_as_float(0x7FFFFFFF);
      continue;
    }
    const int rows = nkt_operand_rows(cp, l, dup != 0);
    const int F = nkt_dup_row(cp, l, dup != 0);
    const unsigned n_inf = k & 0x0FFFFFFFu, sg = (k >> 29) & 3u;
    const int ra = (int)(col[1] >> 16) - 1, rb = (int)(col[1] & 0xFFFFu) - 1;
    const bool one = !(k >> 31) && (sg == 1u || sg == 2u);
    const float inf = __int_as_float(sg == 1u ? 0x7F800000 : 0xFF800000);
    for (int j = 0; j < rows; ++j) {
      const bool all = (j == ra && col[2] == n_inf) || (j == rb && col[3] == n_inf);
      const float d = one && all && j != nan_row ? inf : __int_as_float(0x7FFFFFFF);
      if (F > 0 && j == F)
        dst[0] = dst[0] + d;
      else if (j < T)
        dst[(long long)j * C] = d;
    }
  }
}

template <bool BF>
__global__ void __launch_bounds__(NKT_DL_THREADS, 1)
    nkt_cp_encode_bwd_kernel(const float* __restrict__ x, long long xs_i,
                             long long xs_a, const float* __restrict__ lines,
                             const float* __restrict__ g, long long gs_i,
                             float* __restrict__ out, long long n,
                             long long chunk, CPLevels cp, DlLayout lay,
                             unsigned* __restrict__ nf) {
  constexpr int B = NKT_DL_B(BF);
  constexpr int B1 = B + 1;  // a batch's points and the zero point B
  constexpr int PT = NKT_DL_PWARPS * 32;  // producer threads
  extern __shared__ __align__(16) unsigned char smem_dl[];
  const int C = cp.n_comp, T = cp.table, L = cp.n_levels;
  // the block: (chunk ck, level l, channel slice from c0, row group rg)
  const int rg = blockIdx.x % lay.nrg;
  const int c0 = (blockIdx.x / lay.nrg) % lay.ncs * lay.W;
  const int l = (blockIdx.x / (lay.nrg * lay.ncs)) % L;
  const long long ck = blockIdx.x / (lay.nrg * lay.ncs * L);
  const int cw = C - c0 < lay.W ? C - c0 : lay.W;  // the slice's channels
  const int Cp = (cw + 15) / 16 * 16;
  const int TE = nkt_level_rows(cp, l) * cw;
  const int RT = (nkt_level_rows(cp, l) + 15) / 16;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nthr = blockDim.x;
  const int g8 = lane >> 2, t4 = lane & 3;
  unsigned char* tabs = smem_dl + lay.tab;
  float* gbuf = reinterpret_cast<float*>(smem_dl + lay.gbuf);  // 2 x B x cw
  float* xbuf = reinterpret_cast<float*>(smem_dl + lay.xbuf);  // 2 x B x 3
  int4* tbuf = reinterpret_cast<int4*>(smem_dl + lay.tbuf);    // 2 x B1 x 3
  unsigned char* gu = smem_dl + lay.gu;                        // 2 x 3 x B1 x ldu
  const int gu_slot = 3 * B1 * lay.ldu;                        // elements

  nkt_stage_tables<BF>(tabs, lines, l, T, C, c0, cw, TE, tid, nthr);
  // the zero point B: zero taps and a zero B operand row, never overwritten
  for (int e = tid; e < 2 * 3; e += nthr) tbuf[(e / 3) * B1 * 3 + B * 3 + e % 3] = make_int4(0, 0, 0, 0);
  for (int e = tid; e < 2 * 3 * lay.ldu; e += nthr) {
    const int r = e / lay.ldu;  // (gu slot, axis)
    const int o = (r * B1 + B) * lay.ldu + (e - r * lay.ldu);
    if constexpr (BF)
      reinterpret_cast<__nv_bfloat16*>(gu)[o] = __float2bfloat16_rn(0.0f);
    else
      reinterpret_cast<float*>(gu)[o] = 0.0f;
  }
  __syncthreads();

  const long long p_begin = ck * chunk;
  const long long p_end = p_begin + chunk < n ? p_begin + chunk : n;
  const int nbat = (int)((p_end - p_begin + B - 1) / B);
  auto points = [&](int i) {
    const long long rest = p_end - p_begin - (long long)i * B;
    return rest < B ? (int)rest : B;
  };
  // the pipeline: the first NKT_DL_PWARPS warps make batch i's taps and B
  // operand into stage i % 2 while the product warps run batch i - 1's
  // products on the other stage. Named barriers: 1 among the producers,
  // 2 + s "stage s is full", 4 + s "stage s is free again" (a stage's last
  // use is not announced: nobody waits for it).
  if (warp < NKT_DL_PWARPS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(NKT_DL_PREGS));
    const bool v4 = cw % 4 == 0 && c0 % 4 == 0 && C % 4 == 0 && gs_i % 4 == 0 &&
                    (reinterpret_cast<uintptr_t>(g) & 15) == 0;
    // batch i's cotangent rows of level l (the slice) and coordinates, by
    // cp.async
    auto stage = [&](int i) {
      const int np = points(i);
      const long long p0 = p_begin + (long long)i * B;
      float* gb = gbuf + (i & 1) * B * cw;
      const float* gl = g + l * C + c0;
      if (v4) {
        const int C4 = cw / 4;
        for (int e = tid; e < np * C4; e += PT) {
          const int pp = e / C4, c = (e - pp * C4) * 4;
          nkt_cp_async16(gb + pp * cw + c, gl + (p0 + pp) * gs_i + c, 16);
        }
      } else {
        for (int e = tid; e < np * cw; e += PT) {
          const int pp = e / cw;
          nkt_dl_cp4(gb + e, gl + (p0 + pp) * gs_i + (e - pp * cw));
        }
      }
      for (int e = tid; e < np * 3; e += PT) {
        const int q = e / np, pp = e - q * np;
        nkt_dl_cp4(xbuf + (i & 1) * B * 3 + pp * 3 + q, x + (p0 + pp) * xs_i + q * xs_a);
      }
      nkt_cp_commit();
    };
    const int Cp2 = Cp / 2;
    stage(0);
    for (int i = 0; i < nbat; ++i) {
      const int s = i & 1, np = points(i);
      nkt_bar_sync(1, PT);  // batch i - 1's cotangent rows and coordinates are read
      if (i + 1 < nbat) {
        stage(i + 1);
        nkt_cp_wait<1>();
      } else {
        nkt_cp_wait<0>();
      }
      nkt_bar_sync(1, PT);  // batch i's have arrived
      if (i >= 2) nkt_bar_sync(4 + s, nthr);  // stage s is free
      const float* xb = xbuf + s * B * 3;
      int4* tb = tbuf + s * B1 * 3;
      for (int e = tid; e < np * 3; e += PT) {
        const int pp = e / 3;
        tb[e] = nkt_tap4(nkt_taps(xb[e], cp, l, e - pp * 3));
      }
      nkt_bar_sync(1, PT);  // the taps are made
      // the B operand: grad_u of each axis, (points, channels), zero past
      // the slice's channels
      const float* gb = gbuf + s * B * cw;
      // f32 mode: a running a * b + acc over the thread's values in pairs
      // stays finite unless one of them is not (or, harmlessly, a product
      // overflows); in bf16 mode the product warps see it in their sums
      float nf1 = 0.0f;
      for (int e = tid; e < np * Cp2; e += PT) {
        const int pp = e / Cp2, c = (e - pp * Cp2) * 2;
        float2 v[3];
#pragma unroll
        for (int j = 0; j < 3; ++j) v[j] = make_float2(0.0f, 0.0f);
        if (c < cw) {
          const float2 gc = *reinterpret_cast<const float2*>(gb + pp * cw + c);
          const float2 u0 = nkt_feat2<BF>(tabs, 0, tb[pp * 3], cw, c);
          const float2 u1 = nkt_feat2<BF>(tabs, TE, tb[pp * 3 + 1], cw, c);
          const float2 u2 = nkt_feat2<BF>(tabs, 2 * TE, tb[pp * 3 + 2], cw, c);
          v[0] = make_float2(gc.x * (u1.x * u2.x), gc.y * (u1.y * u2.y));
          v[1] = make_float2(gc.x * (u0.x * u2.x), gc.y * (u0.y * u2.y));
          v[2] = make_float2(gc.x * (u0.x * u1.x), gc.y * (u0.y * u1.y));
        }
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          const int o = s * gu_slot + (j * B1 + pp) * lay.ldu + c;
          if constexpr (BF) {
            *reinterpret_cast<uint32_t*>(reinterpret_cast<__nv_bfloat16*>(gu) + o) =
                nkt_pack2(v[j].x, v[j].y);
          } else {
            *reinterpret_cast<float2*>(reinterpret_cast<float*>(gu) + o) = v[j];
            nf1 = __fmaf_rn(v[j].x, v[j].y, nf1);
          }
        }
      }
      // rarely: the launch's record is made again by nkt_dl_record_kernel
      if (!BF && !isfinite(nf1)) nf[0] = 1u;
      nkt_bar_arrive(2 + s, nthr);  // stage s is full
    }
    // rows no tile covers (from 16 RT up to T) are zero: the first row
    // group's block writes them for its slice
    if (rg == 0) {
      float* dst = out + (ck * L + l) * 3LL * T * C + c0;
      const int rz = RT * 16 < T ? RT * 16 : T;
      const int rest = (T - rz) * cw;
      for (int e = tid; e < 3 * rest; e += PT) {
        const int j = e / rest, rc = e - j * rest, r = rc / cw;
        dst[(long long)j * T * C + (rz + r) * C + (rc - r * cw)] = 0.0f;
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(NKT_DL_QREGS));
  // the product warp's unit: row tile rt, the slice's channels, for each
  // axis
  const int pw = warp - NKT_DL_PWARPS;
  unsigned char* list = smem_dl + lay.list + pw * B;  // the warp's points
  const int rt = rg * lay.tpg + pw;
  const bool active = pw < lay.tpg && rt < RT;
  const int ntu = Cp / 8;
  const int r_lo = rt * 16 + g8, r_hi = r_lo + 8;
  float acc[3][8][4];
#pragma unroll
  for (int j = 0; j < 3; ++j)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
      acc[j][nt][0] = acc[j][nt][1] = acc[j][nt][2] = acc[j][nt][3] = 0.0f;
  for (int i = 0; i < nbat; ++i) {
    const int s = i & 1;
    nkt_bar_sync(2 + s, nthr);  // stage s holds batch i
    // batch i's products. Per axis, the warp lists the batch's points that
    // tap its row tile, in point order, and takes them 16 at a time (the
    // k-tiles); the list's tail is the zero point.
    if (active) {
      const int np = points(i);
      const int4* taps = tbuf + s * B1 * 3;
      const int o0 = s * gu_slot;
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const int4* tq = taps + j;
        int cnt = 0;
#pragma unroll
        for (int h = 0; h < B / 32; ++h) {
          const int p = h * 32 + lane;
          const int4 q = tq[p * 3];
          const bool hit = p < np && ((unsigned)(q.x - rt * 16) < 16u ||
                                      (unsigned)(q.y - rt * 16) < 16u);
          const unsigned m = __ballot_sync(0xffffffffu, hit);
          if (hit) list[cnt + __popc(m & ((1u << lane) - 1u))] = (unsigned char)p;
          cnt += __popc(m);
        }
        __syncwarp();
        auto point = [&](int e) { return e < cnt ? (int)list[e] : B; };
        for (int kt = 0; kt * 16 < cnt; ++kt) {
          if constexpr (BF) {
            // A: rows r_lo, r_hi at entries 2t, 2t+1, 2t+8, 2t+9 of the k-tile
            int4 q[4];
#pragma unroll
            for (int i4 = 0; i4 < 4; ++i4)
              q[i4] = tq[point(kt * 16 + 2 * t4 + (i4 & 1) + (i4 >> 1) * 8) * 3];
            const uint32_t af[4] = {
                nkt_pack2(nkt_tent(q[0], r_lo), nkt_tent(q[1], r_lo)),
                nkt_pack2(nkt_tent(q[0], r_hi), nkt_tent(q[1], r_hi)),
                nkt_pack2(nkt_tent(q[2], r_lo), nkt_tent(q[3], r_lo)),
                nkt_pack2(nkt_tent(q[2], r_hi), nkt_tent(q[3], r_hi))};
            // B: lane l addresses the B operand row of entry (l >> 3 & 1) * 8
            // + (l & 7) of the k-tile at channel (l >> 4) * 8 of an n-tile pair
            const __nv_bfloat16* bp =
                reinterpret_cast<const __nv_bfloat16*>(gu) + o0 +
                (j * B1 + point(kt * 16 + ((lane >> 3) & 1) * 8 + (lane & 7))) * lay.ldu +
                (lane >> 4) * 8;
#pragma unroll
            for (int np2 = 0; np2 < 4; ++np2) {
              if (2 * np2 < ntu) {
                uint32_t b[4];
                nkt_ldm4t(b, bp + np2 * 16);
                nkt_mma_add(acc[j][2 * np2], af, b[0], b[1]);
                nkt_mma_add(acc[j][2 * np2 + 1], af, b[2], b[3]);
              }
            }
          } else {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              // A of the k8 half h: rows r_lo, r_hi at entries t, t + 4
              const int pa = point(kt * 16 + h * 8 + t4);
              const int pb = point(kt * 16 + h * 8 + t4 + 4);
              const int4 qa = tq[pa * 3], qb = tq[pb * 3];
              uint32_t ah[4], al[4];
              nkt_tf32_split_finite(nkt_tent(qa, r_lo), ah[0], al[0]);
              nkt_tf32_split_finite(nkt_tent(qa, r_hi), ah[1], al[1]);
              nkt_tf32_split_finite(nkt_tent(qb, r_lo), ah[2], al[2]);
              nkt_tf32_split_finite(nkt_tent(qb, r_hi), ah[3], al[3]);
              const float* base = reinterpret_cast<const float*>(gu) + o0 +
                                  j * B1 * lay.ldu + g8;
              const float* r0 = base + pa * lay.ldu;
              const float* r1 = base + pb * lay.ldu;
#pragma unroll
              for (int nt = 0; nt < 8; ++nt) {
                if (nt < ntu) {
                  uint32_t bh0, bl0, bh1, bl1;
                  nkt_tf32_split_finite(r0[nt * 8], bh0, bl0);
                  nkt_tf32_split_finite(r1[nt * 8], bh1, bl1);
                  nkt_mma3_add(acc[j][nt], ah, al, bh0, bh1, bl0, bl1);
                }
              }
            }
          }
        }
        __syncwarp();  // the list is read: the next axis may overwrite it
      }
    }
    if (i + 2 < nbat) nkt_bar_arrive(4 + s, nthr);  // stage s is free
  }

  // the warp's tiles: (chunk, level, axis) of out, the slice's channels.
  // bf16 mode: a non-finite grad_u or tent weight of a point the tile lists
  // leaves its sums non-finite (NaN * 0 and inf * 0 are NaN), so a
  // non-finite sum flags the launch (in f32 mode the finite 3xTF32 split
  // loses a NaN: the producers flag it)
  float* dst = out + (ck * L + l) * 3LL * T * C + c0;
  if (active) {
    bool bad = false;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      float* tab = dst + (long long)j * T * C;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int c = nt * 8 + 2 * t4;
        if (nt < ntu && c < cw) {
          if (r_lo < T)
            *reinterpret_cast<float2*>(tab + r_lo * C + c) =
                make_float2(acc[j][nt][0], acc[j][nt][1]);
          if (r_hi < T)
            *reinterpret_cast<float2*>(tab + r_hi * C + c) =
                make_float2(acc[j][nt][2], acc[j][nt][3]);
          if (BF)
            bad |= !(isfinite(acc[j][nt][0]) && isfinite(acc[j][nt][1]) &&
                     isfinite(acc[j][nt][2]) && isfinite(acc[j][nt][3]));
        }
      }
    }
    if (__any_sync(0xffffffffu, bad) && lane == 0) nf[0] = 1u;
  }
}

// csrc/ngp_fused_bwd.cu: flat[e] = the sum of the rows of partial, in row
// order.
extern "C" int nkt_reduce_partials_launch(const float* partial, float* flat,
                                          int total, int blocks, void* stream);

// dlines (L, 3, T, C) of n points. x: coordinate q of point i at
// x[i * xs_i + q * xs_a]; g: the encoding's cotangent, row i at g + i * gs_i
// (L * C f32). chunks > 1: partial holds chunks * L * 3 * T * C floats and
// the chunks are added in order; chunks == 1: the block writes dlines.
// Every entry of dlines is written. Non-finite values take the classes of
// the stand-alone Pallas kernel's contraction, or with dup those of the
// fused kernels' (their operand rows, see nkt_common.cuh). The launch's
// table scan (nkt_table_scan with the same dup and cp->nonfinite) comes
// before it on the stream. cudaErrorInvalidValue: an odd C, no scratch, or
// no channel slice whose block fits shared memory.
extern "C" int nkt_dlines_launch(const float* x, long long xs_i, long long xs_a,
                                 const float* lines, const float* g,
                                 long long gs_i, float* partial, float* dlines,
                                 long long n, const CPLevels* cp, int dup,
                                 int chunks, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  // the widest channel slice (all C up to 64, then 32 or 16) whose block
  // fits; slices start at multiples of 16, so each has an even width
  DlLayout lay = dl_layout(*cp, cp->n_comp < 64 ? cp->n_comp : 64);
  while (lay.total > NKT_SMEM_MAX && lay.W > 16)
    lay = dl_layout(*cp, (lay.W / 2 + 15) / 16 * 16);
  const int threads = (NKT_DL_PWARPS + lay.warps) * 32, bytes = lay.total;
  if (n <= 0 || chunks < 1 || cp->n_comp < 2 || cp->n_comp % 2 ||
      bytes > NKT_SMEM_MAX)
    return (int)cudaErrorInvalidValue;
  // a chunk takes ncs * nrg blocks a level: fewer chunks keep about one
  // block an SM
  chunks = (chunks + lay.ncs * lay.nrg - 1) / (lay.ncs * lay.nrg);
  const long long chunk = (n + chunks - 1) / chunks;
  const long long used = (n + chunk - 1) / chunk;  // chunks that hold points
  float* out = used == 1 ? dlines : partial;
  const long long total = (long long)cp->n_levels * 3 * cp->table * cp->n_comp;
  if (total > INT_MAX) return (int)cudaErrorInvalidValue;
  const unsigned grid = (unsigned)(used * cp->n_levels * lay.ncs * lay.nrg);
  // the record of non-finite grad_u, zeroed by the launch's table scan
  if (!cp->nonfinite) return (int)cudaErrorInvalidValue;
  unsigned* nf = cp->nonfinite + nkt_nf_rec(*cp);
  cudaError_t err;
  // the registers setmaxnreg hands the warps come out of the block's own
  cudaFuncAttributes fa;
  err = cudaFuncGetAttributes(
      &fa, cp->use_bf16 ? (const void*)nkt_cp_encode_bwd_kernel<true>
                        : (const void*)nkt_cp_encode_bwd_kernel<false>);
  if (err != cudaSuccess) return (int)err;
  if ((long long)fa.numRegs * threads <
      (long long)NKT_DL_PWARPS * 32 * NKT_DL_PREGS + lay.warps * 32LL * NKT_DL_QREGS)
    return (int)cudaErrorInvalidConfiguration;
  if (cp->use_bf16) {
    err = cudaFuncSetAttribute(nkt_cp_encode_bwd_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
    nkt_cp_encode_bwd_kernel<true><<<grid, threads, bytes, st>>>(
        x, xs_i, xs_a, lines, g, gs_i, out, n, chunk, *cp, lay, nf);
  } else {
    err = cudaFuncSetAttribute(nkt_cp_encode_bwd_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
    nkt_cp_encode_bwd_kernel<false><<<grid, threads, bytes, st>>>(
        x, xs_i, xs_a, lines, g, gs_i, out, n, chunk, *cp, lay, nf);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (used > 1) {
    const int rc = nkt_reduce_partials_launch(partial, dlines, (int)total, (int)used, st);
    if (rc) return rc;
  }
  if (cp->use_bf16)
    nkt_dl_record_kernel<true><<<256, 256, 0, st>>>(x, xs_i, xs_a, lines, g, gs_i, n,
                                                    *cp, dup, nf);
  else
    nkt_dl_record_kernel<false><<<256, 256, 0, st>>>(x, xs_i, xs_a, lines, g, gs_i, n,
                                                     *cp, dup, nf);
  nkt_dl_nonfinite_kernel<<<1, 1024, 0, st>>>(dlines, nf, *cp, dup);
  return (int)cudaGetLastError();
}

// x: (n, 3) f32; lines: (L, 3, T, C) f32; g: (n, L*C) f32 cotangent of the
// encoding; partial: (chunks, L, 3, T, C) f32 scratch (unused for one
// chunk); dlines: (L, 3, T, C) f32, written whole.
extern "C" int nkt_cp_encode_bwd(const void* x, const void* lines,
                                 const void* g, void* partial, void* dlines,
                                 long long n, const CPLevels* cp, int chunks,
                                 void* stream) {
  const cudaError_t scan =
      nkt_table_scan((const float*)lines, *cp, false, (cudaStream_t)stream);
  if (scan != cudaSuccess) return (int)scan;
  return nkt_dlines_launch((const float*)x, 3, 1, (const float*)lines,
                           (const float*)g, (long long)cp->n_levels * cp->n_comp,
                           (float*)partial, (float*)dlines, n, cp, 0, chunks,
                           stream);
}

// u32 words of the non-finite scratch of a launch (CPLevels::nonfinite).
extern "C" long long nkt_nonfinite_words(const CPLevels* cp) {
  return nkt_nonfinite_words_of(*cp);
}
