// Stand-alone CP-grid encoder forward.
//
// Replaces the TPU kernel nerf_kinematics_tpu/ops/cp_grid_pallas.py::
// cp_encode_pallas forward (_fwd_kernel), which builds (T, B) tent operands
// and contracts them with the line tables on the matrix unit. Here every
// output element is two indexed loads per axis (nkt_common.cuh::nkt_taps),
// summed in f32, and the product of the three axes.
//
// Bound on this card: bytes. 12 B in and 4 * L * C B out per point (1 024 B
// at L = 4, C = 64); the line tables (590 KB in f32) stay in L2. One thread
// per output element, consecutive threads on consecutive channels of one
// point, so the table reads and the output writes are contiguous within a
// warp. Each thread recomputes its point's taps: the arithmetic is small
// beside the 4 B it writes.
#include <climits>

#include "nkt_common.cuh"

__global__ void nkt_cp_encode_kernel(const float* __restrict__ x,
                                     const float* __restrict__ lines,
                                     float* __restrict__ out, long long n,
                                     CPLevels cp) {
  const int C = cp.n_comp;
  const int LC = cp.n_levels * C;
  const long long total = n * LC;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       e < total; e += stride) {
    const long long i = e / LC;
    const int j = (int)(e - i * LC);
    const int l = j / C;
    const int c = j - l * C;
    float u[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const NktTaps t = nkt_taps(x[i * 3 + a], cp, l, a);
      const float* tab = lines + ((long long)(l * 3 + a) * cp.table) * C + c;
      float v0 = __ldg(tab + (long long)t.r0 * C);
      float v1 = __ldg(tab + (long long)t.r1 * C);
      if (cp.use_bf16) {
        v0 = nkt_bf16r(v0);
        v1 = nkt_bf16r(v1);
      }
      u[a] = t.w0 * v0 + t.w1 * v1;
    }
    out[e] = (u[0] * u[1]) * u[2];
  }
}

// x: (n, 3) f32; lines: (L, 3, T, C) f32; out: (n, L*C) f32.
extern "C" int nkt_cp_encode(const void* x, const void* lines, void* out,
                             long long n, const CPLevels* cp, int n_sm,
                             void* stream) {
  const int threads = 256;
  const long long total = n * cp->n_levels * cp->n_comp;
  long long blocks = (total + threads - 1) / threads;
  const long long cap = (long long)n_sm * 32;
  if (blocks > cap) blocks = cap;
  nkt_cp_encode_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)lines, (float*)out, n, *cp);
  return (int)cudaGetLastError();
}

// CP-grid encoder backward: the line tables' gradient, in a fixed order.
//
// Replaces the TPU kernel cp_grid_pallas.py::cp_encode_pallas VJP
// (_bwd_kernel, _forward_bwd), which contracts (T, B) tent operands with the
// (B, C) cotangent on the matrix unit and adds every block's result into one
// resident (L, 3, T, C) accumulator, grid step after grid step. It is also
// the encoder half of the fused gradients (csrc/ngp_fused_bwd.cu), whose
// per-point backward writes the encoding's f32 cotangent to scratch and
// calls nkt_dlines_launch on the same stream. Positions get no gradient.
//
// Design: deterministic, so two runs give the same bits. The grid runs over
// (point chunk, level, axis), the axis fastest, so that the three blocks of
// one chunk and level read the same cotangent rows at about the same time.
// A block keeps its (level, axis) gradient table (T x C f32) and the other
// two axes' line tables (f32, bf16-rounded when use_bf16) in shared memory.
// Its warps split the table: warp w owns the channels [64 (w % CW), +64),
// two a lane, of the rows r with r % NG = w / CW (interleaved, so that the
// 17 rows of a coarse level keep the warps busy). So every (row, channel)
// has exactly one writer lane. The block stages the chunk's points 128 at a time: their
// cotangent rows of level l by cp.async into a double buffer, their taps
// computed by the threads. Each warp walks the staged points in ascending
// order (a ballot picks the points with a tap in its rows) and adds a tap's
// product into a register while the point's row stays the same, as
// consecutive samples of a ray do; a new row adds the pending sum into the
// table. Each block writes its table to
// partial[chunk]; nkt_reduce_partials_launch (csrc/ngp_fused_bwd.cu) adds the
// chunks in chunk order.
// Integer (fixed-point) atomics would also be deterministic but would
// quantise small contributions to zero.
//
// Per tap: dlines[row][c] += w * round(g_c * product of the other two axes'
// line features), the rounding to bf16 when use_bf16 (the line features
// from bf16-rounded tables then, as in the forward). A wrap tap of a periodic
// folded level arrives with r1 = 0; a hash fold that sends both cells to one
// row arrives with w1 = 0 and adds nothing through r1.
//
// Bound on this card: bytes, the cotangent read once (4 * L * C B a point,
// 12 B of coordinates) and the table written once; the three blocks of a
// chunk and level each read the level's cotangent (from L2 when they run
// together), and each warp's walk is a chain of shared-memory operations.
#define NKT_DL_THREADS 1024
#define NKT_DL_BATCH 128  // points whose taps and cotangent are staged at once
#define NKT_DL_PAR 4      // a warp's points whose reads go ahead of its sums

__device__ __forceinline__ void nkt_dl_cp4(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src)
               : "memory");
}

// The lane's two channels of a table row += v.
__device__ __forceinline__ void nkt_dl_add2(float* t, float2 v) {
  float2 u = *reinterpret_cast<float2*>(t);
  u.x += v.x;
  u.y += v.y;
  *reinterpret_cast<float2*>(t) = u;
}

__global__ void __launch_bounds__(NKT_DL_THREADS, 1)
    nkt_cp_encode_bwd_kernel(const float* __restrict__ x, long long xs_i,
                             long long xs_a, const float* __restrict__ lines,
                             const float* __restrict__ g, long long gs_i,
                             float* __restrict__ out, long long n,
                             long long chunk, CPLevels cp) {
  extern __shared__ __align__(16) unsigned char smem_dl[];
  const int C = cp.n_comp, T = cp.table, L = cp.n_levels;
  const int TC = T * C;
  const int a = blockIdx.x % 3;
  const int l = (blockIdx.x / 3) % L;
  const long long ck = blockIdx.x / (3 * L);
  const int ab = a == 0 ? 1 : 0, ac = a == 2 ? 1 : 2;  // the other two axes
  float* tab = reinterpret_cast<float*>(smem_dl);
  float* src_b = tab + TC;
  float* src_c = src_b + TC;
  float* gbuf[2] = {src_c + TC, src_c + TC + NKT_DL_BATCH * C};
  NktTapS* tbuf[2];
  tbuf[0] = reinterpret_cast<NktTapS*>(gbuf[1] + NKT_DL_BATCH * C);
  tbuf[1] = tbuf[0] + NKT_DL_BATCH * 3;
  unsigned* obuf[2];  // per point: row group of its r0 tap | of its r1 << 8
  obuf[0] = reinterpret_cast<unsigned*>(tbuf[1] + NKT_DL_BATCH * 3);
  obuf[1] = obuf[0] + NKT_DL_BATCH;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bool bf = cp.use_bf16 != 0;

  const float* lb = lines + (long long)(l * 3 + ab) * TC;
  const float* lc = lines + (long long)(l * 3 + ac) * TC;
  for (int e = tid; e < TC; e += NKT_DL_THREADS) {
    tab[e] = 0.0f;
    src_b[e] = bf ? nkt_bf16r(lb[e]) : lb[e];
    src_c[e] = bf ? nkt_bf16r(lc[e]) : lc[e];
  }

  // the warp's channels and rows: lane l takes the channel pair c, c + 1
  // with c = 64 (warp % CW) + 2 l; row r belongs to group r % NG, so that a
  // level with few rows (a coarse un-folded one) still spreads over them all
  const int CW = (C + 63) / 64;
  const int NG = (NKT_DL_THREADS / 32) / CW;
  const int c = (warp % CW) * 64 + 2 * lane;
  const bool cl = c < C;
  const unsigned grp = (unsigned)(warp / CW);
  const bool wact = grp < (unsigned)NG;

  const long long p_begin = ck * chunk;
  const long long p_end = p_begin + chunk < n ? p_begin + chunk : n;
  // batch b: its points' cotangent of level l (C floats each) by cp.async;
  // their taps of the three axes and the row groups of the block's axis
  auto stage = [&](int buf, long long p0) {
    const int np = p_end - p0 < NKT_DL_BATCH ? (int)(p_end - p0) : NKT_DL_BATCH;
    for (int e = tid; e < np * C; e += NKT_DL_THREADS) {
      const int pp = e / C, ch = e - pp * C;
      nkt_dl_cp4(gbuf[buf] + e, g + (p0 + pp) * gs_i + l * C + ch);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    for (int e = tid; e < np * 3; e += NKT_DL_THREADS) {
      const int pp = e / 3, q = e - pp * 3;
      const NktTapS tp = nkt_tap_s(nkt_taps(x[(p0 + pp) * xs_i + q * xs_a], cp, l, q));
      tbuf[buf][e] = tp;
      if (q == a)
        obuf[buf][pp] = (unsigned)(tp.r0 % NG) |
                        ((tp.w1 != 0.0f ? (unsigned)(tp.r1 % NG) : 255u) << 8);
    }
  };

  int ra = -1, rb = -1;      // pending rows of the r0 and the r1 taps
  float2 sa = make_float2(0.0f, 0.0f), sb = sa;
  int buf = 0;
  stage(0, p_begin);
  for (long long p0 = p_begin; p0 < p_end; p0 += NKT_DL_BATCH) {
    const int np = p_end - p0 < NKT_DL_BATCH ? (int)(p_end - p0) : NKT_DL_BATCH;
    if (p0 + NKT_DL_BATCH < p_end) {
      stage(buf ^ 1, p0 + NKT_DL_BATCH);
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    __syncthreads();  // batch `buf` staged (and, the first time, the tables)
    const NktTapS* taps = tbuf[buf];
    float* gb = gbuf[buf];
    // every (point, channel) of the batch: the cotangent times the product
    // of the other two axes' line features, rounded as the forward rounds
    for (int e = tid; e < np * C; e += NKT_DL_THREADS) {
      const int pp = e / C, ch = e - pp * C;
      const NktTapS qb = taps[pp * 3 + ab], qc = taps[pp * 3 + ac];
      const float ub = qb.w0 * src_b[qb.r0 * C + ch] + qb.w1 * src_b[qb.r1 * C + ch];
      const float uc = qc.w0 * src_c[qc.r0 * C + ch] + qc.w1 * src_c[qc.r1 * C + ch];
      const float v = gb[e] * (ub * uc);
      gb[e] = bf ? nkt_bf16r(v) : v;
    }
    __syncthreads();
    const unsigned* own = obuf[buf];
    for (int pb = 0; wact && pb < np; pb += 32) {
      unsigned m = 0u;
      {
        const unsigned o = pb + lane < np ? own[pb + lane] : 0xFFFFu;
        m = __ballot_sync(0xffffffffu, (o & 255u) == grp || (o >> 8) == grp);
      }
      while (m) {
        // up to NKT_DL_PAR of the warp's points of these 32, in ascending
        // order: their taps, row groups and products first (no load waits
        // on the table's updates), then the sums in order
        int r0[NKT_DL_PAR], r1[NKT_DL_PAR];
        float2 w0[NKT_DL_PAR], w1[NKT_DL_PAR];
#pragma unroll
        for (int k = 0; k < NKT_DL_PAR; ++k) {
          r0[k] = r1[k] = -1;
          w0[k] = w1[k] = make_float2(0.0f, 0.0f);
          if (m) {
            const int pp = pb + __ffs(m) - 1;
            m &= m - 1;
            const NktTapS q = taps[pp * 3 + a];
            const unsigned o = own[pp];
            const float2 gx = cl ? *reinterpret_cast<const float2*>(gb + pp * C + c)
                                 : make_float2(0.0f, 0.0f);
            if ((o & 255u) == grp) {
              r0[k] = q.r0;
              w0[k] = make_float2(q.w0 * gx.x, q.w0 * gx.y);
            }
            if ((o >> 8) == grp) {  // 255 when w1 = 0
              r1[k] = q.r1;
              w1[k] = make_float2(q.w1 * gx.x, q.w1 * gx.y);
            }
          }
        }
#pragma unroll
        for (int k = 0; k < NKT_DL_PAR; ++k) {
          if (r0[k] >= 0) {
            if (r0[k] != ra) {
              if (ra >= 0 && cl) nkt_dl_add2(tab + ra * C + c, sa);
              ra = r0[k];
              sa = make_float2(0.0f, 0.0f);
            }
            sa.x += w0[k].x;
            sa.y += w0[k].y;
          }
          if (r1[k] >= 0) {
            if (r1[k] != rb) {
              if (rb >= 0 && cl) nkt_dl_add2(tab + rb * C + c, sb);
              rb = r1[k];
              sb = make_float2(0.0f, 0.0f);
            }
            sb.x += w1[k].x;
            sb.y += w1[k].y;
          }
        }
      }
    }
    __syncthreads();  // batch `buf` is read: the next stage may overwrite it
    buf ^= 1;
  }
  // the pending sums; an r0 and an r1 run may end on one row: in this order
  if (ra >= 0 && cl) nkt_dl_add2(tab + ra * C + c, sa);
  if (rb >= 0 && cl) nkt_dl_add2(tab + rb * C + c, sb);
  __syncthreads();
  float* dst = out + (ck * L * 3 + l * 3 + a) * (long long)TC;
  for (int e = tid; e < TC; e += NKT_DL_THREADS) dst[e] = tab[e];
}

// csrc/ngp_fused_bwd.cu: flat[e] = the sum of the rows of partial, in row
// order.
extern "C" int nkt_reduce_partials_launch(const float* partial, float* flat,
                                          int total, int blocks, void* stream);

// The gradient table, the two source tables, and two batches of cotangent
// rows, taps and row groups.
static size_t dlines_smem(const CPLevels& cp) {
  return (size_t)(3 * cp.table + 2 * NKT_DL_BATCH) * cp.n_comp * sizeof(float) +
         (size_t)2 * NKT_DL_BATCH * (3 * sizeof(NktTapS) + sizeof(unsigned));
}

// dlines (L, 3, T, C) of n points. x: coordinate q of point i at
// x[i * xs_i + q * xs_a]; g: the encoding's cotangent, row i at g + i * gs_i
// (L * C f32). chunks > 1: partial holds chunks * L * 3 * T * C floats and
// the chunks are added in order; chunks == 1: the block writes dlines.
// Every entry of dlines is written.
extern "C" int nkt_dlines_launch(const float* x, long long xs_i, long long xs_a,
                                 const float* lines, const float* g,
                                 long long gs_i, float* partial, float* dlines,
                                 long long n, const CPLevels* cp, int chunks,
                                 void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int C = cp->n_comp;
  if (n <= 0 || chunks < 1 || C < 2 || C % 2 || (C + 63) / 64 > NKT_DL_THREADS / 32)
    return (int)cudaErrorInvalidValue;
  const size_t bytes = dlines_smem(*cp);
  cudaError_t err = cudaFuncSetAttribute(
      nkt_cp_encode_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const long long chunk = (n + chunks - 1) / chunks;
  const long long used = (n + chunk - 1) / chunk;  // chunks that hold points
  float* out = used == 1 ? dlines : partial;
  const long long total = (long long)cp->n_levels * 3 * cp->table * C;
  if (total > INT_MAX) return (int)cudaErrorInvalidValue;
  nkt_cp_encode_bwd_kernel<<<(unsigned)(used * 3 * cp->n_levels), NKT_DL_THREADS,
                             bytes, st>>>(x, xs_i, xs_a, lines, g, gs_i, out, n,
                                          chunk, *cp);
  err = cudaGetLastError();
  if (err != cudaSuccess || used == 1) return (int)err;
  return nkt_reduce_partials_launch(partial, dlines, (int)total, (int)used, st);
}

// x: (n, 3) f32; lines: (L, 3, T, C) f32; g: (n, L*C) f32 cotangent of the
// encoding; partial: (chunks, L, 3, T, C) f32 scratch (unused for one
// chunk); dlines: (L, 3, T, C) f32, written whole.
extern "C" int nkt_cp_encode_bwd(const void* x, const void* lines,
                                 const void* g, void* partial, void* dlines,
                                 long long n, const CPLevels* cp, int chunks,
                                 void* stream) {
  return nkt_dlines_launch((const float*)x, 3, 1, (const float*)lines,
                           (const float*)g, (long long)cp->n_levels * cp->n_comp,
                           (float*)partial, (float*)dlines, n, cp, chunks,
                           stream);
}
