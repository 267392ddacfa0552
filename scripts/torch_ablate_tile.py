#!/usr/bin/env python3
"""Where bf16 mode's gradient tile kernel spends its time, by ablation:
build variants of the kernel library with one part of
``csrc/ngp_fused_bwd.cu::nkt_fused_tile_kernel`` switched off and time rows
6 and 7 (the fused VJP and the fused fine objective, which is that kernel,
row 5's kernel and the sum of the partial rows) at the flagship step's
393 216 points with the fixture's trained weights, row 6 at fox_ngp.yml's
encoding (16384 x 64 points, seeded weights), and the tile kernel
alone from a ``torch.profiler`` trace of the same calls. The variants
that switch parts off compute wrong values on purpose; only their times are
read; the candidates compute the same values in another schedule. A stand-in for
a profile by stall reason, which ``ncu`` cannot take on these cards.

    python3 scripts/torch_ablate_tile.py [--variants "as built,..."] [--clocks]
        [--baseline DIR] [--verbose-build]

``--baseline DIR`` times another checkout's ``ngp_fused_bwd.cu`` (say the
parent commit's, unpacked by ``git archive`` into a directory that
``.gitignore`` lists) with this tree's wrappers, in turns with the variants.

Every variant's library is built and loaded first; then the variants are
timed in turns for ``--rounds`` rounds (medians printed), so that the card's
clocks drifting over the call (the same source read 2.45 and 1.94 ms at the
start and the end of one call) fall on all of them alike.

Prints one JSON object per variant. ``--clocks`` instead builds one copy
with a ``clock64()`` mark after each of the kernel's barriers and prints, for
each barrier, the cycles from the barrier before it (thread 0 of each block,
summed over the launch's tiles, averaged over the blocks), split into thread
0's own work and its wait at the barrier for the block's slowest warp:
which phase of a tile takes the time. The sources are copied and edited under
the build directory (``cuda_lib.build_dir()``); the package's own sources
are left as they are. Exits 1 when an edit no longer matches the source.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
import statistics
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from nerf_kinematics_tpu_torch.io.fixture import read_fixture  # noqa: E402
from nerf_kinematics_tpu_torch.ops import cuda_lib  # noqa: E402
from nerf_kinematics_tpu_torch.ops.ngp_fused_cuda import (  # noqa: E402
    ngp_fused_apply_cf_bwd, ngp_fused_train_cf)
from nerf_kinematics_tpu_torch.train.ngp_engine import NGPEngine  # noqa: E402

SRC = "ngp_fused_bwd.cu"
# (what is switched off, the edits of ngp_fused_bwd.cu that do it)
GATHERS = [(f"__ldg(t{a} + q[{i}].r{r} * C2 + c2)", f"__ldg(t{a} + c2)")
           for i, a in enumerate("xyz") for r in (0, 1)]  # every gather hits row 0
RESUM = [("          if (nkt_near_midpoint(z0)) redo |= 1u << (mt * 4 + h * 2);\n"
          "          if (nkt_near_midpoint(z1)) redo |= 1u << (mt * 4 + h * 2 + 1);\n",
          "")]
CHAIN0 = [("Z0[p] = nkt_chain<4>(X + p * ldx, Wt, K);", "Z0[p] = 0.0f;")]
WGRAD = [("        for (int f = warp; f < F; f += NKB_WARPS) {",
          "        for (int f = warp; f < 0; f += NKB_WARPS) {")]
WGRAD0 = [("          if (mi >= 0 && mi < CT) {", "          if (mi >= 0 && mi < 0) {")]
DENC = [("      for (int nt = warp; nt < C / 8; nt += NKB_WARPS) {\n"
         "        nkb_bwd_product<MPM>(",
         "      for (int nt = warp; nt < 0; nt += NKB_WARPS) {\n"
         "        nkb_bwd_product<MPM>(")]
RAYS = [("      if (r < np / S)\n", "      if (r < 0)\n")]
SLOT = [("        if (p < np)\n          *reinterpret_cast<uint4*>(slot + p * LC",
         "        if (p < 0)\n          *reinterpret_cast<uint4*>(slot + p * LC"),
        ("                       p < np ? slot + p * LC + l * C + c8 * 8 : slot, p < np ? 16 : 0);",
         "                       slot, 0);")]
# machina_ngp.yml's and fox_ngp.yml's tiles in the generic instances
# (<16, 8> and <32, 4>), not in instances of their own size
GENERIC = [("  if (pl.mt0 == 16 && mp == 6) return launch_tile<16, 6>(b, pl, rows, mode, grid, st);\n"
            "  if (pl.mt0 == 30 && mp == 4) return launch_tile<30, 4>(b, pl, rows, mode, grid, st);\n", "")]
# Candidate changes (not switched-off parts): more independent work in
# flight for a warp.
UNROLL_KS = [("  for (int ks = 0; ks < KT; ++ks) {\n    uint32_t bq[2];",
              "#pragma unroll 2\n  for (int ks = 0; ks < KT; ++ks) {\n    uint32_t bq[2];")]
GATHER4 = [("      for (int q0 = 0; q0 < ppw; q0 += 2) {\n        for (int c2 = lane; c2 < C2; c2 += 32) {\n"
            "          __nv_bfloat162 v[2][6];\n#pragma unroll\n          for (int u = 0; u < 2; ++u) {\n"
            "            const NktTapS* q = taps + (pw0 + q0 + u) * 3;",
            "      for (int q0 = 0; q0 < ppw; q0 += 4) {\n        const int nb = ppw - q0 < 4 ? ppw - q0 : 4;\n"
            "        for (int c2 = lane; c2 < C2; c2 += 32) {\n"
            "          __nv_bfloat162 v[4][6];\n#pragma unroll\n          for (int u = 0; u < 4; ++u) {\n"
            "            const NktTapS* q = taps + (pw0 + q0 + (u < nb ? u : 0)) * 3;"),
           ("#pragma unroll\n          for (int u = 0; u < 2; ++u) {\n            const int p = pw0 + q0 + u;",
            "#pragma unroll\n          for (int u = 0; u < 4; ++u) {\n            if (u >= nb) break;\n"
            "            const int p = pw0 + q0 + u;")]
FRAG2 = [("        for (int f = warp; f < F; f += NKB_WARPS) {\n          float c[4];\n"
          "          nkb_wgrad_frag<MPM>(c, MP, XL, ldx, f / FN, G16, f % FN, lane);\n"
          "#pragma unroll\n          for (int e = 0; e < 4; ++e) fr[f * 128 + e * 32 + lane] += c[e];\n        }",
          "        for (int f = warp; f < F; f += 2 * NKB_WARPS) {\n"
          "          const int f2 = f + NKB_WARPS < F ? f + NKB_WARPS : f;\n"
          "          float c[4], c2[4];\n"
          "          c[0] = c[1] = c[2] = c[3] = c2[0] = c2[1] = c2[2] = c2[3] = 0.0f;\n"
          "          const __nv_bfloat16* xa = XL + ((lane & 7) + ((lane >> 4) << 3)) * ldx + (f / FN) * 16 + ((lane >> 3) & 1) * 8;\n"
          "          const __nv_bfloat16* xb = XL + ((lane & 7) + ((lane >> 4) << 3)) * ldx + (f2 / FN) * 16 + ((lane >> 3) & 1) * 8;\n"
          "          const __nv_bfloat16* ga = G16 + (lane & 15) * NKB_GLD + (f % FN) * 8;\n"
          "          const __nv_bfloat16* gb2 = G16 + (lane & 15) * NKB_GLD + (f2 % FN) * 8;\n"
          "#pragma unroll\n          for (int mt = 0; mt < MPM; ++mt) {\n            if (mt < MP) {\n"
          "              uint32_t a1[4], a2[4], b1[2], b2[2];\n"
          "              nkt_ldm4t(a1, xa + mt * 16 * ldx); nkt_ldm2t(b1, ga + mt * 16 * NKB_GLD);\n"
          "              nkt_ldm4t(a2, xb + mt * 16 * ldx); nkt_ldm2t(b2, gb2 + mt * 16 * NKB_GLD);\n"
          "              nkt_mma(c, a1, b1[0], b1[1]); nkt_mma(c2, a2, b2[0], b2[1]);\n            }\n          }\n"
          "#pragma unroll\n          for (int e = 0; e < 4; ++e) fr[f * 128 + e * 32 + lane] += c[e];\n"
          "          if (f2 != f) {\n#pragma unroll\n            for (int e = 0; e < 4; ++e) fr[f2 * 128 + e * 32 + lane] += c2[e];\n          }\n        }")]
# Layer 0's dW on wgmma (m64n8k16: dW^T += G^T X, the points as K, G^T from
# registers, the level tile from shared memory in wgmma's core-matrix layout,
# the sums in the warpgroups' registers), a block of 8 columns a wgmma chosen
# by a predicate (ptxas then serializes the wgmma: --verbose-build shows
# C7520); the variants below build on it.
TO_WGMMA = [
    ("// MT0: m-tiles of 16 rows of layer 0's dW a warp holds (its n-tile of\n// every input row of the encoding), at least the plan's mt0; MPM: m-tiles\n// of 16 points of a tile, at least P / 16.\n",
     '// wgmma (sm_90a) for layer 0\'s dW: d (a 64 x 8 f32 block of dW^T, the\n// warpgroup\'s: a warp its 16 rows, laid out as mma.sync\'s C fragment) +=\n// a (64 x 16 bf16: 16 rows a warp, as mma.sync\'s A fragment) times the\n// 16 x 8 bf16 block of shared memory that desc points at: N-major (a row\n// of 8 columns a point, 16 B), two 8 x 8 core matrices of 128 B one after\n// the other along the 16 points. One block of 8 columns a call, so only the\n// K stride of the descriptor is read: both are 128 B. Issued where on (the\n// same in the whole warpgroup), by a predicate: a branch around a wgmma\n// makes ptxas serialize every wgmma of the kernel.\n__device__ __forceinline__ uint64_t nkb_desc(const void* p) {\n  const uint64_t a = (unsigned)__cvta_generic_to_shared(p);\n  return ((a & 0x3FFFF) >> 4) | ((uint64_t)(128 >> 4) << 16) |\n         ((uint64_t)(128 >> 4) << 32);\n}\n__device__ __forceinline__ void nkb_wgmma_n8(float* d, const uint32_t* a,\n                                             uint64_t b, bool on) {\n  asm volatile(\n      "{\\n.reg .pred p, q;\\nsetp.ne.b32 p, 1, 0;\\nsetp.ne.b32 q, %9, 0;\\n"\n      "@q wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "\n      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p, 1, 1, 1;\\n}\\n"\n      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])\n      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"((int)on));\n}\n__device__ __forceinline__ void nkb_wgmma_fence() {\n  asm volatile("wgmma.fence.sync.aligned;\\n" ::: "memory");\n}\n__device__ __forceinline__ void nkb_wgmma_commit() {\n  asm volatile("wgmma.commit_group.sync.aligned;\\n" ::: "memory");\n}\n__device__ __forceinline__ void nkb_wgmma_wait() {\n  asm volatile("wgmma.wait_group.sync.aligned 0;\\n" ::: "memory");\n}\n// the thread\'s writes to shared memory, seen by wgmma\'s reads (the async\n// proxy) after the next barrier\n__device__ __forceinline__ void nkb_fence_async() {\n  asm volatile("fence.proxy.async.shared::cta;\\n" ::: "memory");\n}\n\n// MT0: blocks of 8 columns of layer 0\'s dW^T a thread holds (4 registers\n// each; warpgroup w takes columns [w C / 2, (w + 1) C / 2) of every level),\n// at least the plan\'s mt0 = K0 / 16; MPM: m-tiles of 16 points of a tile, at\n// least P / 16.\n'),
    ("    // ======== layer 0: dW (registers) and d_enc (to denc), a level at a time\n    uint32_t gb[MPM][2];  // g's B fragments on the warp's n-tile\n    if (warp < NT0) {\n#pragma unroll\n      for (int mt = 0; mt < MPM; ++mt)\n        if (mt < MP) nkt_ldm2t(gb[mt], G16 + (mt * 16 + (lane & 15)) * NKB_GLD + warp * 8);\n    }\n    // a level's rows of the slot into its level tile (a warp its points;\n    // rows past np zero-filled), by cp.async: level l + 1's copies are in\n    // flight while the block computes level l\n    auto fetch_level = [&](int l) {\n      __nv_bfloat16* E = reinterpret_cast<__nv_bfloat16*>(tl) + (l & 1) * P * pl.e_ld;\n      for (int e = lane; e < ppw * (C / 8); e += 32) {\n        const int p = pw0 + e / (C / 8), c8 = e % (C / 8);\n        nkt_cp_async16(E + p * pl.e_ld + c8 * 8,\n                       p < np ? slot + p * LC + l * C + c8 * 8 : slot, p < np ? 16 : 0);\n      }\n      nkt_cp_commit();\n    };\n    fetch_level(0);\n    for (int l = 0; l < Lv; ++l) {\n      __nv_bfloat16* E = reinterpret_cast<__nv_bfloat16*>(tl) + (l & 1) * P * pl.e_ld;\n      nkt_cp_wait<0>();\n      __syncthreads();\n      // the other level tile was last read at level l - 1, before this barrier\n      if (l + 1 < Lv) fetch_level(l + 1);\n      if (warp < NT0) {\n#pragma unroll\n        for (int m = 0; m < MT0; ++m) {\n          const int mi = m - l * CT;\n          if (mi >= 0 && mi < CT) {\n            const __nv_bfloat16* xr = E + ((lane & 7) + ((lane >> 4) << 3)) * pl.e_ld +\n                                      mi * 16 + ((lane >> 3) & 1) * 8;\n#pragma unroll\n            for (int mt = 0; mt < MPM; ++mt) {\n              if (mt < MP) {\n                uint32_t af[4];\n                nkt_ldm4t(af, xr + mt * 16 * pl.e_ld);\n                nkt_mma(acc0[m], af, gb[mt][0], gb[mt][1]);\n              }\n            }\n          }\n        }\n      }\n      for (int nt = warp; nt < C / 8; nt += NKB_WARPS) {\n        nkb_bwd_product<MPM>(acc, MP, G16, W + a.pk_off[0] + l * C, a.pk_ld[0], nt, J0, lane);\n#pragma unroll\n        for (int mt = 0; mt < MPM; ++mt) {\n          if (mt < MP) {\n#pragma unroll\n            for (int h = 0; h < 2; ++h) {\n              const int p = mt * 16 + g + 8 * h;\n              if (p < np)\n                *reinterpret_cast<float2*>(b.denc + (p0 + p) * LC + l * C + nt * 8 + 2 * t) =\n                    make_float2(acc[mt][2 * h], acc[mt][2 * h + 1]);\n            }\n          }\n        }\n      }\n    }\n",
     "    // ======== layer 0: dW (wgmma) and d_enc (to denc), a level at a time\n    // dW^T += G^T X: G^T (rows: layer 0's outputs, 16 a warp of its\n    // warpgroup) from registers, a fragment a k-step of 16 points; X (the\n    // level's columns) from the level tile\n    const int wg = warp >> 2, jw = (warp & 3) * 16, CH = C / 16;\n    // (loaded by every warp, m-tiles past MP from m-tile 0, and zeroed by a\n    // select: a fragment written under a branch on the warp also makes\n    // ptxas serialize the wgmma)\n    uint32_t ga[MPM][4];\n    const bool live = jw < J0;\n#pragma unroll\n    for (int mt = 0; mt < MPM; ++mt) {\n      const int m = mt < MP ? mt : 0;\n      nkt_ldm4t(ga[mt], G16 + ((lane & 7) + ((lane >> 4) << 3) + m * 16) * NKB_GLD +\n                            (live ? jw : 0) + ((lane >> 3) & 1) * 8);\n#pragma unroll\n      for (int r = 0; r < 4; ++r) ga[mt][r] = live && mt < MP ? ga[mt][r] : 0u;\n    }\n    // a level's rows of the slot into its level tile (a warp its points;\n    // rows past np zero-filled), by cp.async, as wgmma reads them: 8 x 8\n    // core matrices of 128 B (a row of 8 columns a point), the P / 8 of\n    // columns [8 c8, +8) one after the other. Level l + 1's copies are in\n    // flight while the block computes level l.\n    const int KB = P / 8;\n    auto fetch_level = [&](int l) {\n      __nv_bfloat16* E = reinterpret_cast<__nv_bfloat16*>(tl) + (l & 1) * P * pl.e_ld;\n      for (int e = lane; e < ppw * (C / 8); e += 32) {\n        const int p = pw0 + e % ppw, c8 = e / ppw;\n        nkt_cp_async16(E + ((c8 * KB + (p >> 3)) * 8 + (p & 7)) * 8,\n                       p < np ? slot + p * LC + l * C + c8 * 8 : slot, p < np ? 16 : 0);\n      }\n      nkt_cp_commit();\n    };\n    fetch_level(0);\n    for (int l = 0; l < Lv; ++l) {\n      __nv_bfloat16* E = reinterpret_cast<__nv_bfloat16*>(tl) + (l & 1) * P * pl.e_ld;\n      nkt_cp_wait<0>();\n      nkb_fence_async();\n      __syncthreads();\n      // the other level tile was last read at level l - 1, before this barrier\n      if (l + 1 < Lv) fetch_level(l + 1);\n      // the warpgroup's blocks of 8 columns of the level: issued here, waited\n      // for after d_enc's products\n      nkb_wgmma_fence();\n#pragma unroll\n      for (int q = 0; q < MT0; ++q) {\n        const int i = q - l * CH;\n        const bool ours = i >= 0 && i < CH;\n        const __nv_bfloat16* xb = E + (wg * CH + (ours ? i : 0)) * KB * 64;\n#pragma unroll\n        for (int mt = 0; mt < MPM; ++mt)\n          nkb_wgmma_n8(acc0[q], ga[mt], nkb_desc(xb + mt * 128), ours && mt < MP);\n      }\n      nkb_wgmma_commit();\n      for (int nt = warp; nt < C / 8; nt += NKB_WARPS) {\n        nkb_bwd_product<MPM>(acc, MP, G16, W + a.pk_off[0] + l * C, a.pk_ld[0], nt, J0, lane);\n#pragma unroll\n        for (int mt = 0; mt < MPM; ++mt) {\n          if (mt < MP) {\n#pragma unroll\n            for (int h = 0; h < 2; ++h) {\n              const int p = mt * 16 + g + 8 * h;\n              if (p < np)\n                *reinterpret_cast<float2*>(b.denc + (p0 + p) * LC + l * C + nt * 8 + 2 * t) =\n                    make_float2(acc[mt][2 * h], acc[mt][2 * h + 1]);\n            }\n          }\n        }\n      }\n      nkb_wgmma_wait();  // the level tile is read before the barrier above\n    }\n"),
    ('  float* mine = b.partial + (long long)blockIdx.x * rows.total;\n  if (warp < NT0) {\n#pragma unroll\n    for (int m = 0; m < MT0; ++m) {\n#pragma unroll\n      for (int e = 0; e < 4; ++e) {\n        const int k = m * 16 + g + (e >> 1) * 8, j = warp * 8 + 2 * t + (e & 1);\n        if (k < K0) mine[rows.dw_off[0] + k * J0 + j] = acc0[m][e];\n      }\n    }\n  }\n',
     '  float* mine = b.partial + (long long)blockIdx.x * rows.total;\n  {\n    // block q of the warpgroup: level q / CH, columns [8 (wg CH + q % CH), +8)\n    const int wg = warp >> 2, jw = (warp & 3) * 16, CH = C / 16;\n#pragma unroll\n    for (int q = 0; q < MT0; ++q) {\n#pragma unroll\n      for (int e = 0; e < 4; ++e) {\n        const int k = (q / CH) * C + (wg * CH + q % CH) * 8 + 2 * t + (e & 1);\n        const int j = jw + g + (e >> 1) * 8;\n        if (q < pl.mt0 && j < J0) mine[rows.dw_off[0] + k * J0 + j] = acc0[q][e];\n      }\n    }\n  }\n'),
    ("  const int K0 = a.d_in[0], J0 = a.d_out[0], NT0 = J0 / 8;", "  const int J0 = a.d_out[0], NT0 = J0 / 8;")]
# machina_ngp.yml's shapes only (4 blocks a level, 6 k-steps a tile): the
# warpgroup's blocks of a level always in acc0[0..4), no predicate, the
# sums rotated by 4 after each level (4 levels: back in place at the end)
FIXED_MACHINA = [
    ("#pragma unroll\n      for (int q = 0; q < MT0; ++q) {\n        const int i = q - l * CH;\n"
     "        const bool ours = i >= 0 && i < CH;\n"
     "        const __nv_bfloat16* xb = E + (wg * CH + (ours ? i : 0)) * KB * 64;\n"
     "#pragma unroll\n        for (int mt = 0; mt < MPM; ++mt)\n"
     "          nkb_wgmma_n8(acc0[q], ga[mt], nkb_desc(xb + mt * 128), ours && mt < MP);\n      }\n",
     "#pragma unroll\n      for (int i = 0; i < 4; ++i)\n#pragma unroll\n"
     "        for (int mt = 0; mt < (MPM < 6 ? MPM : 6); ++mt)\n"
     "          nkb_wgmma_n8(acc0[i], ga[mt], nkb_desc(E + (wg * 4 + i) * KB * 64 + mt * 128), true);\n"),
    ("      nkb_wgmma_wait();  // the level tile is read before the barrier above\n",
     "      nkb_wgmma_wait();  // the level tile is read before the barrier above\n"
     "      {\n        float r4[4][4];\n#pragma unroll\n        for (int i = 0; i < 4; ++i)\n#pragma unroll\n"
     "          for (int e = 0; e < 4; ++e) r4[i][e] = acc0[i][e];\n#pragma unroll\n"
     "        for (int q = 0; q + 4 < MT0; ++q)\n#pragma unroll\n"
     "          for (int e = 0; e < 4; ++e) acc0[q][e] = acc0[q + 4][e];\n#pragma unroll\n"
     "        for (int i = 0; i < 4; ++i)\n#pragma unroll\n"
     "          for (int e = 0; e < 4; ++e) acc0[MT0 - 4 + i][e] = r4[i][e];\n      }\n")]
# machina_ngp.yml's shapes only: the levels' loop unrolled (4 levels), so
# that each wgmma's block of sums is known at compile time, unpredicated
UNROLLED_MACHINA = [
    ("    for (int l = 0; l < Lv; ++l) {\n      __nv_bfloat16* E = reinterpret_cast<__nv_bfloat16*>(tl) + (l & 1) * P * pl.e_ld;\n      nkt_cp_wait<0>();",
     "#pragma unroll\n    for (int l = 0; l < 4; ++l) {\n      __nv_bfloat16* E = reinterpret_cast<__nv_bfloat16*>(tl) + (l & 1) * P * pl.e_ld;\n      nkt_cp_wait<0>();"),
    ("#pragma unroll\n      for (int q = 0; q < MT0; ++q) {\n        const int i = q - l * CH;\n"
     "        const bool ours = i >= 0 && i < CH;\n"
     "        const __nv_bfloat16* xb = E + (wg * CH + (ours ? i : 0)) * KB * 64;\n"
     "#pragma unroll\n        for (int mt = 0; mt < MPM; ++mt)\n"
     "          nkb_wgmma_n8(acc0[q], ga[mt], nkb_desc(xb + mt * 128), ours && mt < MP);\n      }\n",
     "#pragma unroll\n      for (int i = 0; i < 4; ++i)\n#pragma unroll\n"
     "        for (int mt = 0; mt < (MPM < 6 ? MPM : 6); ++mt)\n"
     "          nkb_wgmma_n8(acc0[l * 4 + i], ga[mt], nkb_desc(E + (wg * 4 + i) * KB * 64 + mt * 128), true);\n")]
# the same with one m64n32k16 a level and k-step (the warpgroup's 32
# columns of the level at once) in place of four m64n8k16
N32_HELPERS = (
    "__device__ __forceinline__ void nkb_wgmma_n32(float (*d)[4], const uint32_t* a, uint64_t b) {\n"
    "  asm volatile(\"{\\n.reg .pred p;\\nsetp.ne.b32 p, 1, 0;\\n\"\n"
    "      \"wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, \"\n"
    "      \"%8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\\n}\\n\"\n"
    "      : \"+f\"(d[0][0]), \"+f\"(d[0][1]), \"+f\"(d[0][2]), \"+f\"(d[0][3]), \"+f\"(d[1][0]), \"+f\"(d[1][1]),\n"
    "        \"+f\"(d[1][2]), \"+f\"(d[1][3]), \"+f\"(d[2][0]), \"+f\"(d[2][1]), \"+f\"(d[2][2]), \"+f\"(d[2][3]),\n"
    "        \"+f\"(d[3][0]), \"+f\"(d[3][1]), \"+f\"(d[3][2]), \"+f\"(d[3][3])\n"
    "      : \"r\"(a[0]), \"r\"(a[1]), \"r\"(a[2]), \"r\"(a[3]), \"l\"(b));\n"
    "}\n"
    "__device__ __forceinline__ uint64_t nkb_desc32(const void* p, int sbo) {\n"
    "  const uint64_t a = (unsigned)__cvta_generic_to_shared(p);\n"
    "  return ((a & 0x3FFFF) >> 4) | ((uint64_t)(128 >> 4) << 16) | ((uint64_t)((sbo >> 4) & 0x3FFF) << 32);\n"
    "}\n\n")
UNROLLED_N32 = UNROLLED_MACHINA + [
    ("// MT0: blocks of 8 columns of layer 0's dW^T", N32_HELPERS + "// MT0: blocks of 8 columns of layer 0's dW^T"),
    ("#pragma unroll\n      for (int i = 0; i < 4; ++i)\n#pragma unroll\n"
     "        for (int mt = 0; mt < (MPM < 6 ? MPM : 6); ++mt)\n"
     "          nkb_wgmma_n8(acc0[l * 4 + i], ga[mt], nkb_desc(E + (wg * 4 + i) * KB * 64 + mt * 128), true);\n",
     "#pragma unroll\n      for (int mt = 0; mt < (MPM < 6 ? MPM : 6); ++mt)\n"
     "        nkb_wgmma_n32(acc0 + l * 4, ga[mt], nkb_desc32(E + wg * 4 * KB * 64 + mt * 128, KB * 128));\n")]
VARIANTS = {
    "as built": [],
    "k-steps unrolled by two (candidate)": UNROLL_KS,
    "gathers of four points (candidate)": GATHER4,
    "weight-gradient fragments in pairs (candidate)": FRAG2,
    "all three candidates": UNROLL_KS + GATHER4 + FRAG2,
    "the generic instances for machina's and fox's tiles": GENERIC,
    "layer 0's dW on wgmma (candidate)": TO_WGMMA,
    "layer 0's wgmma blocks rotated (machina's widths only)": TO_WGMMA + FIXED_MACHINA,
    "layer 0's wgmma levels unrolled (machina's widths only)": TO_WGMMA + UNROLLED_MACHINA,
    "layer 0's wgmma levels unrolled on m64n32k16 (machina's widths only)": TO_WGMMA + UNROLLED_N32,
    "gathers hit L1 (row 0)": GATHERS,
    "no re-summing near rounding midpoints": RESUM,
    "no exact feature-0 chain": CHAIN0,
    "no weight gradients of layers 1..": WGRAD,
    "no weight gradient of layer 0": WGRAD0,
    "no d_enc": DENC,
    "no compositing (row 7)": RAYS,
    "no slot traffic": SLOT,
}


def tile_ms(fn, reps: int = 5) -> float:
    """The tile kernel's device ms a call, from a profiler trace."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = 0.0
    for e in prof.key_averages():
        if "nkt_fused_tile_kernel" in e.key:
            total += getattr(e, "device_time_total", 0.0) or getattr(e, "cuda_time_total", 0.0)
    return total / reps / 1e3


CLOCK_DEFS = """
__device__ unsigned long long nkb_clocks[1024 * 64];
extern "C" int nkt_tile_clocks(unsigned long long* host, int n) {
  return (int)cudaMemcpyFromSymbol(host, nkb_clocks, n * sizeof(unsigned long long));
}
extern "C" int nkt_tile_clocks_zero() {
  void* p = nullptr;
  const cudaError_t e = cudaGetSymbolAddress(&p, nkb_clocks);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaMemset(p, 0, sizeof(nkb_clocks));
}
"""


def with_clocks(text: str):
    """The source with a clock mark after each barrier of the tile kernel;
    returns (text, each barrier's line in the source and the nearest
    comment above it)."""
    head = text.index("nkt_fused_tile_kernel(BwdArgs b, BwdPlan pl")
    body = text.index("unsigned char sm[];", head) + len("unsigned char sm[];")
    end = text.index("// ---- the block's partial sums", body)
    part = text[body:end]
    first = text[:body].count("\n") + 1
    labels, out, k = [], [], 0
    for n_line, line in enumerate(part.split("\n")):
        if "__syncthreads();" in line:
            note = next((x.strip() for x in reversed(out) if x.strip().startswith("//")), "")
            # the barriers of the layer loops take a site a layer: the
            # forward's before layer L at 16 + L, the backward's between a
            # layer's products and its cotangent's epilogue at 24 + L
            if "the layer's input is whole" in line:
                site = "16 + L"
            elif "every read of G is done" in line:
                site = "24 + L"
            else:
                site = str(k)
                labels.append(f"line {first + n_line}: {note[:60]}")
                k += 1
            # thread 0's work up to the barrier (site), then its wait there
            # for the block's slowest warp (32 + site)
            line = line.replace(
                "__syncthreads();",
                "if (threadIdx.x == 0) { const long long c_ = clock64(); "
                f"nkb_clocks[blockIdx.x * 64 + {site}] += c_ - t_mark_; t_mark_ = c_; }} "
                "__syncthreads(); if (threadIdx.x == 0) { const long long c_ = clock64(); "
                f"nkb_clocks[blockIdx.x * 64 + 32 + {site}] += c_ - t_mark_; t_mark_ = c_; }}")
        out.append(line)
    marked = ("\n  long long t_mark_ = clock64();" + "\n".join(out)
              + "  if (threadIdx.x == 0) { const long long c_ = clock64(); "
              f"nkb_clocks[blockIdx.x * 64 + {k}] += c_ - t_mark_; t_mark_ = c_; }}\n")
    labels.append("(after the last tile)")
    inc = text.index('#include "nkt_mma.cuh"') + len('#include "nkt_mma.cuh"')
    text = text[:inc] + "\n" + CLOCK_DEFS + text[inc:body] + marked + text[end:]
    return text, labels


def clocks(rows, root) -> int:
    """Build the marked copy, run each row once, print the cycles by barrier."""
    import ctypes

    here = os.path.join(root, "clocks")
    shutil.rmtree(here, ignore_errors=True)
    shutil.copytree(cuda_lib.CSRC_DIR, os.path.join(here, "csrc"))
    path = os.path.join(here, "csrc", SRC)
    with open(path) as f:
        text, labels = with_clocks(f.read())
    with open(path, "w") as f:
        f.write(text)
    cuda_lib.CSRC_DIR = os.path.join(here, "csrc")
    cuda_lib._LIB = None
    os.environ["NKT_TORCH_BUILD_DIR"] = os.path.join(here, "lib")
    lib = cuda_lib.load_library()
    lib.nkt_tile_clocks.argtypes = [ctypes.c_void_p, ctypes.c_int]
    blocks = cuda_lib.sm_count(torch.device("cuda"))
    for row, fn in rows.items():
        with torch.no_grad():
            fn()
            torch.cuda.synchronize()
            lib.nkt_tile_clocks_zero()
            fn()
            torch.cuda.synchronize()
        buf = (ctypes.c_ulonglong * (1024 * 64))()
        if lib.nkt_tile_clocks(ctypes.addressof(buf), 1024 * 64):
            return 1
        sites = [(k, labels[k]) for k in range(len(labels))]
        sites += [(16 + L, f"forward: before layer {L} (layer {L - 1}'s product, finish)")
                  for L in range(1, 8)]
        sites += [(24 + L, f"backward: layer {L}'s weight gradient and cotangent products")
                  for L in range(1, 8)]
        rec = []
        for k, label in sites:
            work = sum(buf[b * 64 + k] for b in range(blocks)) / blocks
            wait = sum(buf[b * 64 + 32 + k] for b in range(blocks)) / blocks
            if work or wait:
                rec.append({"site": k, "before": label, "work": work, "wait": wait})
        total = sum(r["work"] + r["wait"] for r in rec)
        for r in rec:
            r["share"] = (r["work"] + r["wait"]) / total
        print(json.dumps({"row": row, "cycles_per_block": total, "by_barrier": rec,
                          "device": chip_smoke.nvidia_smi_line()}), flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--clocks", action="store_true")
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--baseline", default="",
                    help="a checkout whose csrc/ngp_fused_bwd.cu is timed too, in turns "
                         "with the variants, as the variant 'baseline'")
    ap.add_argument("--verbose-build", action="store_true",
                    help="print each variant's registers, spills and ptxas notes")
    args = ap.parse_args(argv)
    dev = torch.device("cuda")
    fx = read_fixture()
    eng = NGPEngine(fx.config, 1.0, device=dev)
    eng.load_flax_params(fx.params)
    params, cfg = eng._fused_params(detach=True), eng.ngp_config.cp
    S = fx.config.nerf.train.num_fine
    R = fx.config.nerf.num_random_rays
    gen = torch.Generator(device=dev).manual_seed(4321)
    xt, vd = chip_smoke.random_points(R * S, gen, dev)
    g4 = torch.randn((4, R * S), generator=gen, device=dev)
    g4[3] *= 1e-3
    z = 2.0 + 4.0 * torch.sort(torch.rand((R, S), generator=gen, device=dev), -1).values
    dists = torch.cat([z[:, 1:] - z[:, :-1], torch.full((R, 1), 1e10, device=dev)], -1)
    dists = dists.reshape(1, R * S).contiguous()
    tgt = torch.rand((3, R), generator=gen, device=dev)
    inv = 1.0 / (3.0 * R)
    # row 6 at fox_ngp.yml's encoding (5 x 96, seeded weights), 16384 x 64
    cfox = dataclasses.replace(cfg, n_levels=5, n_components=96, table_size=256)
    pfox = chip_smoke.seeded_fused_params(cfox, gen, dev)
    xfox, vfox = chip_smoke.random_points(16384 * 64, gen, dev)
    gfox = torch.randn((4, 16384 * 64), generator=gen, device=dev)
    gfox[3] *= 1e-3
    rows = {"row 6": lambda: ngp_fused_apply_cf_bwd(params, xt, vd, g4, cfg),
            "row 7": lambda: ngp_fused_train_cf(params, xt, vd, dists, tgt, cfg, S, True, inv),
            "row 6 fox": lambda: ngp_fused_apply_cf_bwd(pfox, xfox, vfox, gfox, cfox)}
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device=dev)
    root = os.path.join(cuda_lib.build_dir(), "ablation_tile")
    if args.clocks:
        return clocks(rows, root)
    # build and load every variant's library first (each its own copy of
    # the kernels in one process), then time them in turns, round by round,
    # so that drift of the card's clocks over the call falls on all alike
    src = cuda_lib.CSRC_DIR
    names = [v for v in args.variants.split(",") if v]
    if args.baseline:
        names.insert(0, "baseline")
    libs = {}
    for i, name in enumerate(names):
        here = os.path.join(root, str(i))
        shutil.rmtree(here, ignore_errors=True)
        shutil.copytree(src, os.path.join(here, "csrc"))
        path = os.path.join(here, "csrc", SRC)
        if name == "baseline":
            path_b = os.path.join(args.baseline, "nerf_kinematics_tpu_torch", "csrc", SRC)
            shutil.copyfile(path_b, path)
        with open(path) as f:
            text = f.read()
        for old, new in VARIANTS.get(name, []):
            if old not in text:
                print(f"torch_ablate_tile: the edit for {name!r} no longer matches {SRC}",
                      file=sys.stderr)
                return 1
            text = text.replace(old, new)
        with open(path, "w") as f:
            f.write(text)
        cuda_lib.CSRC_DIR = os.path.join(here, "csrc")
        cuda_lib._LIB = None
        os.environ["NKT_TORCH_BUILD_DIR"] = os.path.join(here, "lib")
        libs[name] = cuda_lib.load_library(verbose=args.verbose_build)
    times = {name: {row: {"ms": [], "tile": []} for row in rows} for name in names}
    with torch.no_grad():
        for _ in range(args.rounds):
            for name in names:
                cuda_lib._LIB = libs[name]
                for row, fn in rows.items():
                    times[name][row]["ms"].append(chip_smoke.time_ms(fn, 5, 2, flush))
                    times[name][row]["tile"].append(tile_ms(fn))
    for name in names:
        rec = {"variant": name, "n_points": R * S, "rounds": args.rounds}
        for row in rows:
            rec[f"{row} ms"] = statistics.median(times[name][row]["ms"])
            rec[f"{row} tile kernel ms"] = statistics.median(times[name][row]["tile"])
            rec[f"{row} tile kernel ms by round"] = times[name][row]["tile"]
        rec["device"] = chip_smoke.nvidia_smi_line()
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
