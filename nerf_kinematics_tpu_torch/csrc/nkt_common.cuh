// Shared device code of the port's CUDA kernels: the CP-grid level
// description and the two-tap interpolation of one level and axis.
//
// The sources include only the CUDA runtime headers (no PyTorch headers):
// they are built with nvcc into one shared library with a plain C
// interface and loaded with ctypes (ops/cuda_lib.py). They are compiled
// with -fmad=false so that a*b+c rounds as the plain PyTorch versions do;
// accumulation loops ask for a fused multiply-add explicitly.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#define NKT_MAX_LEVELS 8

// Mirrors ops/cuda_lib.py::CPLevels field for field.
struct CPLevels {
  int n_levels;
  int n_comp;    // C
  int table;     // T, rows of every (level, axis) table
  int use_bf16;  // round weights, table entries and activations to bf16
  int hashed;    // fold mode "hash" (folded levels only)
  int R[NKT_MAX_LEVELS];       // level resolution
  int F[NKT_MAX_LEVELS];       // fold modulus, 0 = un-folded
  float pmax[NKT_MAX_LEVELS];  // f32(R - 1e-4), upper clip of the coordinate
  int salt[NKT_MAX_LEVELS][3];
  // the launch's non-finite scratch (nkt_nonfinite_words u32 words, made by
  // the caller for each launch): written by nkt_table_scan, read by the
  // kernels queued after it on the same stream
  unsigned* nonfinite;
};

__device__ __forceinline__ float nkt_bf16r(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Integer cell -> hashed row: Knuth multiplicative mix + xor-shift in
// wrapping 32-bit arithmetic (arithmetic right shifts), low 24 bits, mod.
__device__ __forceinline__ int nkt_hash_fold(int i0, int table, int salt) {
  unsigned h = ((unsigned)i0 + (unsigned)salt) * 2654435769u;  // -1640531527
  int hs = (int)h;
  hs = hs ^ (hs >> 15);
  h = (unsigned)hs * 2246822507u;  // -2048144789
  hs = (int)h;
  hs = hs ^ (hs >> 13);
  return (hs & 0xFFFFFF) % table;
}

struct NktTaps {
  int r0, r1;
  float w0, w1;
};

// The ReLU and the sigma clamp of the plain versions (torch.relu,
// torch.clamp) and of the reference (jnp.maximum, jnp.clip): a NaN stays NaN,
// where fmaxf would return the other operand. max.NaN / min.NaN (sm_80 and
// later): one instruction each, as fmaxf / fminf, the same on every other
// value up to the sign of a zero.
__device__ __forceinline__ float nkt_max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
__device__ __forceinline__ float nkt_min_nan(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
__device__ __forceinline__ float nkt_relu(float z) { return nkt_max_nan(z, 0.0f); }
__device__ __forceinline__ float nkt_clamp(float z, float lo, float hi) {
  return nkt_min_nan(nkt_max_nan(z, lo), hi);
}

// fmodf(p, F) for 0 <= p < 2^24 and an integer F > 0, exactly as fmodf
// gives it, in a few instructions: q = floor(p / F) from an approximate
// quotient is at most one off, p - q F is exact (q F is an integer at most
// p + F), and one add or subtract of F (exact too) puts the remainder in
// [0, F).
__device__ __forceinline__ float nkt_fmod_exact(float p, float F) {
  const float q = floorf(__fdividef(p, F));
  float r = __fmaf_rn(-q, F, p);
  if (r < 0.0f) r += F;
  if (r >= F) r -= F;
  return r;
}

// x: one unit coordinate. Rows and tent weights of its two taps at level l.
// A NaN coordinate taps the rows of cell 0 with NaN weights: the reference's
// tent of a NaN is NaN on every row, and no index is made from a NaN. On a
// hash-folded level the reference makes an integer of the NaN (0) for both
// cells instead: both taps are that cell's hashed row, the only row where
// its tent is NaN. EXACT_MOD: the periodic fold by nkt_fmod_exact (the same
// rows and weights) in place of fmodf; row 3's kernel takes it, the other
// kernels keep fmodf.
template <bool EXACT_MOD = false>
__device__ __forceinline__ NktTaps nkt_taps(float x, const CPLevels& cp, int l,
                                            int axis) {
  NktTaps t;
  const int R = cp.R[l];
  const int F = cp.F[l];
  const float xx = fminf(fmaxf(x, 0.0f), 1.0f);  // a NaN: 0
  const float p = fminf(fmaxf(xx * (float)R, 0.0f), cp.pmax[l]);
  if (F > 0 && cp.hashed) {
    const float i0 = floorf(p);
    const float w = p - i0;
    const int salt = cp.salt[l][axis];
    t.r0 = nkt_hash_fold((int)i0, F, salt);
    t.r1 = nkt_hash_fold((int)i0 + 1, F, salt);
    if (t.r0 == t.r1) {  // both cells on one row: weights add before rounding
      t.w0 = (1.0f - w) + w;
      t.w1 = 0.0f;
    } else {
      t.w0 = 1.0f - w;
      t.w1 = w;
    }
  } else {
    const float pm = F <= 0 ? p : EXACT_MOD ? nkt_fmod_exact(p, (float)F)
                                            : fmodf(p, (float)F);
    const float t0 = floorf(pm);
    t.w0 = 1.0f - (pm - t0);
    t.w1 = 1.0f - ((t0 + 1.0f) - pm);
    t.r0 = (int)t0;
    t.r1 = t.r0 + 1;
    if (F > 0 && t.r1 >= F) t.r1 -= F;
  }
  if (cp.use_bf16) {
    t.w0 = nkt_bf16r(t.w0);
    t.w1 = nkt_bf16r(t.w1);
  }
  if (x != x) {
    t.w0 = t.w1 = x;
    if (F > 0 && cp.hashed) t.r1 = t.r0;
  }
  return t;
}

// The hull occupancy of one point (row 1, and row 8's proposal):
// min(Pxy[ix, iy], Pxz[ix, iz], Pyz[iy, iz]) at i = floor(clip(u R, 0, R-1)),
// with tab[e] entry e of the (3, R, R) projections as the reference's bf16
// operand; fR = R, hi = R - 1. A NaN coordinate matches no cell of the
// reference's one-hot rows (|NaN - iota| < 0.5 is false), so every pair that
// reads that axis gives 0; its cell is taken at 0 (fmaxf maps NaN to 0), so
// that no index is made from it. +-inf clamp to the end cells.
template <typename Tab>
__device__ __forceinline__ float nkt_hull_at(const Tab& tab, int R, float fR,
                                             float hi, float x, float y,
                                             float z) {
  const float ux = x * fR, uy = y * fR, uz = z * fR;
  const bool nx = ux != ux, ny = uy != uy, nz = uz != uz;
  const int ix = (int)floorf(fminf(fmaxf(ux, 0.0f), hi));
  const int iy = (int)floorf(fminf(fmaxf(uy, 0.0f), hi));
  const int iz = (int)floorf(fminf(fmaxf(uz, 0.0f), hi));
  const int RR = R * R;
  const float a = nx || ny ? 0.0f : tab[ix * R + iy];
  const float b = nx || nz ? 0.0f : tab[RR + ix * R + iz];
  const float c = ny || nz ? 0.0f : tab[2 * RR + iy * R + iz];
  return fminf(a, fminf(b, c));
}

// ---------------------------------------------------------------------------
// A non-finite line-table entry. The reference contracts each point's tent
// with all the rows of a level it slices (a weight of 0 where the point does
// not tap), so a NaN or inf entry reaches every point: a point that does not
// tap it meets 0 * NaN or 0 * inf, NaN. The kernels read only the tapped
// rows; a scan of the tables before each launch (nkt_table_scan) records, per
// (level, axis, channel), the non-finite rows among those the reference
// contracts over, and an encoder gives NaN in that channel to a point that
// does not tap them all (nkt_poison). On finite tables the scan is one read
// of the tables, and the kernels read one flag per (level, axis).
//
// Where the scan writes: CPLevels::nonfinite, a scratch of each launch
// (nothing of it outlives the launch, and no two launches share one): per
// (level, axis) a flag "some channel non-finite", per (level, axis, channel)
// a descriptor (0, or count | row a | row b), then row 5's record of
// non-finite cotangents (cp_encode.cu; NKT_REC words per (level, axis,
// channel) after one "something to record" word), which the scan zeroes.
//
// The rows contracted ("operand rows"): the stand-alone encoder slices
// level_rows(R) rows; the fused kernels level_rows_dup(R) rows of an operand
// whose row F is a copy of row 0 (periodic folded levels: their wrap tap is
// row F there) and whose rows past T are zero.
#define NKT_REC 4  // words of row 5's record per (level, axis, channel)

__host__ __device__ inline long long nkt_nf_desc(const CPLevels& cp) {
  return 3LL * cp.n_levels;
}
__host__ __device__ inline long long nkt_nf_rec(const CPLevels& cp) {
  return 3LL * cp.n_levels * (1 + cp.n_comp);
}
__host__ __device__ inline long long nkt_nonfinite_words_of(const CPLevels& cp) {
  return nkt_nf_rec(cp) + 1 + NKT_REC * 3LL * cp.n_levels * cp.n_comp;
}

__host__ __device__ inline int nkt_round16(int v) { return (v + 15) / 16 * 16; }

// The reference's rows of level l: level_rows(R), or with dup the fused
// kernels' level_rows_dup(R).
__host__ __device__ inline int nkt_operand_rows(const CPLevels& cp, int l,
                                                bool dup) {
  if (cp.F[l] > 0)
    return dup && !cp.hashed ? nkt_round16(cp.F[l] + 1) : cp.F[l];
  const int r = nkt_round16(cp.R[l] + 1);
  return r < cp.table ? r : cp.table;
}

// Row F of the fused kernels' operand is row 0 (0: no such row).
__host__ __device__ inline int nkt_dup_row(const CPLevels& cp, int l, bool dup) {
  return dup && !cp.hashed ? cp.F[l] : 0;
}

// The second tap as an operand row: the wrap tap of a dup level is row F.
__device__ __forceinline__ int nkt_operand_r1(int r0, int r1, int F) {
  return F > 0 ? r0 + 1 : r1;
}

// A table entry as the kernels use it: rounded to bf16 in bf16 mode.
__device__ __forceinline__ bool nkt_scan_finite(float v, bool bf) {
  return isfinite(bf ? nkt_bf16r(v) : v);
}

// One block per (level, axis). It zeroes its part of row 5's record, then
// makes one pass over the rows [0, min(rows, T)) that the operand reads (a
// dup row F is row 0), 16-byte loads, eight in flight a thread: on finite
// tables the block clears its flag and its descriptors and ends. Rarely, a
// thread per channel then records the non-finite operand rows of its column.
#define NKT_SCAN_THREADS 512
static __global__ void __launch_bounds__(NKT_SCAN_THREADS)
    nkt_table_scan_kernel(const float* __restrict__ lines, CPLevels cp, int dup) {
  const int la = blockIdx.x, l = la / 3, tid = threadIdx.x;
  const int C = cp.n_comp, T = cp.table;
  const bool bf = cp.use_bf16 != 0;
  const int rows = nkt_operand_rows(cp, l, dup != 0);
  const int F = nkt_dup_row(cp, l, dup != 0);
  const float* tab = lines + (long long)la * T * C;
  unsigned* flag = cp.nonfinite;
  unsigned* desc = cp.nonfinite + nkt_nf_desc(cp) + (long long)la * C;
  unsigned* rec = cp.nonfinite + nkt_nf_rec(cp);
  for (int e = tid; e < NKT_REC * C; e += NKT_SCAN_THREADS)
    rec[1 + (long long)la * NKT_REC * C + e] = 0u;
  if (la == 0 && tid == 0) rec[0] = 0u;
  const int m = (rows < T ? rows : T) * C;
  bool bad = false;
  if (m % 4 == 0 && (reinterpret_cast<unsigned long long>(tab) & 15) == 0) {
    const float4* t4 = reinterpret_cast<const float4*>(tab);
    for (int e0 = tid; e0 < m / 4; e0 += 8 * NKT_SCAN_THREADS) {
      float4 v[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int e = e0 + k * NKT_SCAN_THREADS;
        v[k] = e < m / 4 ? __ldg(t4 + e) : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int k = 0; k < 8; ++k)
        bad |= !(nkt_scan_finite(v[k].x, bf) && nkt_scan_finite(v[k].y, bf) &&
                 nkt_scan_finite(v[k].z, bf) && nkt_scan_finite(v[k].w, bf));
    }
  } else {
    for (int e = tid; e < m; e += NKT_SCAN_THREADS)
      bad |= !nkt_scan_finite(__ldg(tab + e), bf);
  }
  if (!__syncthreads_or(bad)) {  // a kernel reads the level's three axes
    for (int c = tid; c < C; c += NKT_SCAN_THREADS) desc[c] = 0u;
    if (tid == 0) flag[la] = 0u;
    return;
  }
  int any = 0;
  for (int c = tid; c < C; c += NKT_SCAN_THREADS) {
    unsigned cnt = 0, ra = 0, rb = 0;
    for (int j = 0; j < rows; ++j) {
      const int src = (F > 0 && j == F) ? 0 : j;
      if (src >= T) continue;  // zero padding
      if (!nkt_scan_finite(tab[(long long)src * C + c], bf)) {
        if (cnt == 0) ra = j;
        else if (cnt == 1) rb = j;
        ++cnt;
      }
    }
    desc[c] = cnt ? ((cnt > 2 ? 3u : cnt) << 30) | (ra << 15) | rb : 0u;
    any |= cnt > 0;
  }
  any = __syncthreads_or(any);
  if (tid == 0) flag[la] = any;
}

// Launch the scan on the stream; cudaErrorInvalidValue without a scratch or
// where the tables have more rows than a descriptor holds.
static inline cudaError_t nkt_table_scan(const float* lines, const CPLevels& cp,
                                         bool dup, cudaStream_t st) {
  if (!cp.nonfinite || cp.table > 0x7FFF + 1) return cudaErrorInvalidValue;
  nkt_table_scan_kernel<<<cp.n_levels * 3, NKT_SCAN_THREADS, 0, st>>>(
      lines, cp, dup ? 1 : 0);
  return cudaGetLastError();
}

// u: a tap sum of channel c of table (l, a); t0, t1: the taps as operand
// rows. NaN where the column has a non-finite row that the point does not
// tap; else u (whose own arithmetic gives a tapped entry's class).
__device__ __forceinline__ float nkt_poison(float u, unsigned d, int t0, int t1) {
  if (d == 0u) return u;
  const unsigned cnt = d >> 30;
  const int ra = (int)((d >> 15) & 0x7FFFu), rb = (int)(d & 0x7FFFu);
  const bool ka = ra == t0 || ra == t1;
  const bool kb = cnt < 2u || rb == t0 || rb == t1;
  return cnt <= 2u && ka && kb ? u : __int_as_float(0x7FFFFFFF);
}

__device__ __forceinline__ bool nkt_poisoned(const CPLevels& cp, int l, int a) {
  return cp.nonfinite[l * 3 + a] != 0u;
}

// Bit l of the result: level l has a table with a non-finite entry. Read
// once by a kernel, before its loops (the flags are global memory).
__device__ __forceinline__ unsigned nkt_poison_levels(const CPLevels& cp) {
  unsigned m = 0u;
  for (int l = 0; l < cp.n_levels; ++l)
    m |= (nkt_poisoned(cp, l, 0) || nkt_poisoned(cp, l, 1) || nkt_poisoned(cp, l, 2))
             ? 1u << l : 0u;
  return m;
}

// The descriptors of level l: axis a, channel c at [a * C + c].
__device__ __forceinline__ const unsigned* nkt_poison_descs(const CPLevels& cp,
                                                            int l) {
  return cp.nonfinite + nkt_nf_desc(cp) + 3LL * l * cp.n_comp;
}

__device__ __forceinline__ unsigned nkt_poison_desc(const CPLevels& cp, int l,
                                                    int a, int c) {
  return nkt_poison_descs(cp, l)[a * cp.n_comp + c];
}

// A tap pair as a warp keeps it in shared memory (12 bytes; rows < 32768).
struct NktTapS {
  short r0, r1;
  float w0, w1;
};

__device__ __forceinline__ NktTapS nkt_tap_s(const NktTaps& q) {
  NktTapS s;
  s.r0 = (short)q.r0;
  s.r1 = (short)q.r1;
  s.w0 = q.w0;
  s.w1 = q.w1;
  return s;
}
