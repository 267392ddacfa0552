#!/usr/bin/env python3
"""Where a bf16 forward kernel's time goes, by ablation: build variants of
the kernel library with one part of the forward switched off and time the
density-only kernel (row 2, ``csrc/nkt_mma.cuh``'s body) or, with
``--color``, the full forward (row 3) on uniform random points. The
variants compute wrong values on purpose; only their times are read. A
stand-in for a profile by stall reason, which ``ncu`` cannot take on these
cards.

    python3 scripts/torch_ablate_forward.py [--points 10240000]
    python3 scripts/torch_ablate_forward.py --color [--points 20480000]
    python3 scripts/torch_ablate_forward.py --color --tree build/ab_parent

Row 3 is also timed at fox_ngp.yml's encoder (seeded weights, 1.05 M
points). ``--tree``: a directory holding another tree's
``nerf_kinematics_tpu_torch`` (its wrappers and its kernel sources are the
ones ablated); the edits are picked by the row 3 kernel that tree's
``csrc/ngp_fused.cu`` launches.
Prints one JSON object per variant. The sources are copied and edited under
the build directory (``cuda_lib.build_dir()``); the package's own sources
are left as they are. Exits 1 when an edit no longer matches the source.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# ---- row 2 (and row 3 up to PR 14): nkt_mma_body of nkt_mma.cuh -----------
# (file, what is switched off, the edits that do it)
GATHERS = [(f"__ldg(t{a} + q[{i}].r{r} * C2 + c2)", f"__ldg(t{a} + c2)")
           for i, a in enumerate("xyz") for r in (0, 1)]  # every gather hits row 0
RESUM = [("return z != 0.0f && abs(low - 0x8000) < NKT_NEAR;", "return false && low;")]
CHAIN0 = [("        if (lane < NKT_MT)\n          zc = nkt_chain<1>(",
           "        if (lane < 0)\n          zc = nkt_chain<1>(")]
SLOT = [("      if (!WIDE) {\n        for (int e = lane; e < NKT_MT * C / 8; e += 32) {",
         "      if (false) {\n        for (int e = lane; e < NKT_MT * C / 8; e += 32) {")]
TAPS = [("        taps[lane * 3 + 0] = nkt_tap_s(nkt_taps(px, a.cp, l, 0));\n"
         "        taps[lane * 3 + 1] = nkt_tap_s(nkt_taps(py, a.cp, l, 1));\n"
         "        taps[lane * 3 + 2] = nkt_tap_s(nkt_taps(pz, a.cp, l, 2));\n",
         "        NktTapS q0;\n        q0.r0 = lane;\n        q0.r1 = lane + 1;\n"
         "        q0.w0 = px;\n        q0.w1 = py;\n"
         "        taps[lane * 3 + 0] = q0;\n        taps[lane * 3 + 1] = q0;\n"
         "        taps[lane * 3 + 2] = q0;\n")]
MMA_BODY = "nkt_mma.cuh"
SIGMA_VARIANTS = {
    "as built": [],
    "gathers hit L1 (row 0)": [(MMA_BODY, GATHERS)],
    "no re-summing near rounding midpoints": [(MMA_BODY, RESUM)],
    "no exact feature-0 chain": [(MMA_BODY, CHAIN0)],
    "no tap arithmetic": [(MMA_BODY, TAPS)],
    "none of the four": [(MMA_BODY, GATHERS + RESUM + CHAIN0 + TAPS)],
}
# row 3 through nkt_mma_body<true> (the kernel nkt_mma_apply_kernel): the
# same parts, and the copy of each level into the warp's slot of device
# memory that layer 0's re-sums read back
MMA_APPLY_VARIANTS = {
    "as built": [],
    "gathers hit L1 (row 0)": [(MMA_BODY, GATHERS)],
    "no re-summing near rounding midpoints": [(MMA_BODY, RESUM)],
    "no slot copy": [(MMA_BODY, SLOT)],
    "no exact feature-0 chain": [(MMA_BODY, CHAIN0)],
    "no tap arithmetic": [(MMA_BODY, TAPS)],
    "none of the five": [(MMA_BODY, GATHERS + RESUM + SLOT + CHAIN0 + TAPS)],
}
# row 3 through nkt_apply_tile_kernel (ngp_apply.cu): the same parts (the
# slot written as the encoding is made), the next level's first rows issued
# after this level's layer-0 products in place of before them, and a lane's
# next pair of rows issued before its current pair's products (two pairs'
# registers)
APPLY = "ngp_apply.cu"
A_GATHERS = [(f"__ldg(t4 + (long long)ax * T * C8 + q.r{r} * C8 + c8)",
              "__ldg(t4 + (long long)ax * T * C8 + c8)") for r in (0, 1)]
A_RESUM = [("return (((__float_as_uint(z) + 0x100u) ^ 0x8000u) & 0xFE00u) == 0u;",
            "return false && z;")]
A_CHAIN0 = [("        if (lane < NKT_MT)\n          zc = apply_chain(",
             "        if (lane < 0)\n          zc = apply_chain(")]
A_TAPS = [("    taps[e] = nkt_tap_s(nkt_taps<true>(x, a.cp, l, ax));\n",
           "    NktTapS q0;\n    q0.r0 = p;\n    q0.r1 = p + 1;\n    q0.w0 = x;\n"
           "    q0.w1 = x;\n    taps[e] = q0;\n")]
_PREFETCH = ("      if (l + 1 < L) apply_load(t4 + 3LL * T * C8, C8, T, tl + 3 * NKT_MT, "
             "lane, v);\n")
_LAYER0 = ("      for (int kt = 0; kt < KL; ++kt)\n"
           "        apply_ktile(E, ar0, W0 + l * KL * 8, br0, ld0, NT0, kt, acc);\n")
A_NO_OVERLAP = [(_PREFETCH + _LAYER0, _LAYER0 + _PREFETCH)]
_PAIRS = ("      for (int e = lane; e < NKT_MT * C8; e += 32) {\n"
          "        apply_store(v, C8, tl, e, E, lde, slot, LC, l * C);\n"
          "        if (e + 32 < NKT_MT * C8) apply_load(t4, C8, T, tl, e + 32, v);\n"
          "      }\n")
_PAIRS2 = ("      for (int e = lane; e < NKT_MT * C8; e += 32) {\n"
           "        uint4 vn[6];\n"
           "        if (e + 32 < NKT_MT * C8) apply_load(t4, C8, T, tl, e + 32, vn);\n"
           "        apply_store(v, C8, tl, e, E, lde, slot, LC, l * C);\n"
           "#pragma unroll\n"
           "        for (int i = 0; i < 6; ++i) v[i] = vn[i];\n"
           "      }\n")
A_DOUBLE = [(_PAIRS, _PAIRS2)]
APPLY_VARIANTS = {
    "as built": [],
    "gathers hit L1 (row 0)": [(APPLY, A_GATHERS)],
    "no re-summing near rounding midpoints": [(APPLY, A_RESUM)],
    "no exact feature-0 chain": [(APPLY, A_CHAIN0)],
    "no tap arithmetic": [(APPLY, A_TAPS)],
    "none of the four": [(APPLY, A_GATHERS + A_RESUM + A_CHAIN0 + A_TAPS)],
    "next level's rows after the products": [(APPLY, A_NO_OVERLAP)],
    "the next pair's rows in flight during a pair's products": [(APPLY, A_DOUBLE)],
}
# the row 3 kernels by name: the variants of the kernel a tree launches
COLOR_VARIANTS = {"nkt_mma_apply_kernel": MMA_APPLY_VARIANTS,
                  "nkt_apply_forward": APPLY_VARIANTS}


def _row3_kernel(csrc: str) -> str:
    """What ngp_fused.cu's bf16 forward with color calls: PR 5's kernel or
    ngp_apply.cu's launcher."""
    with open(os.path.join(csrc, "ngp_fused.cu")) as f:
        text = f.read()
    for name in COLOR_VARIANTS:
        if name + "<<<" in text or name + "(a, n_sm, st)" in text:
            return name
    raise SystemExit("torch_ablate_forward: no known row 3 kernel in ngp_fused.cu")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--color", action="store_true",
                    help="row 3 (the full forward) in place of row 2")
    ap.add_argument("--points", type=int, default=None,
                    help="points a launch (10 240 000 for row 2, 20 480 000 for row 3)")
    ap.add_argument("--tree", default=ROOT,
                    help="directory holding the nerf_kinematics_tpu_torch to ablate")
    ap.add_argument("--only", default="",
                    help="the variants to build, comma-separated (default: all)")
    args = ap.parse_args(argv)
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    sys.path.append(ROOT)  # chip_smoke's helpers (no package import of its own)
    import torch

    import chip_smoke
    from nerf_kinematics_tpu_torch.io.fixture import read_fixture
    from nerf_kinematics_tpu_torch.ops import cuda_lib
    from nerf_kinematics_tpu_torch.ops.ngp_fused_cuda import (
        ngp_fused_apply_cf, ngp_fused_sigma_cf)
    from nerf_kinematics_tpu_torch.train.ngp_engine import NGPEngine

    pkg = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(cuda_lib.__file__))))
    if pkg != tree:
        raise RuntimeError(f"imported {pkg}, expected the tree {tree}")
    src = cuda_lib.CSRC_DIR
    if args.color:
        kernel = _row3_kernel(src)
        variants, row = COLOR_VARIANTS[kernel], "ngp_fused_apply_cf"
        n = args.points or 160000 * 128
    else:
        kernel, variants, row = "nkt_mma_sigma_kernel", SIGMA_VARIANTS, "ngp_fused_sigma_cf"
        n = args.points or 160000 * 64
    keep = [v for v in args.only.split(",") if v]
    dev = torch.device("cuda")
    fx = read_fixture()
    eng = NGPEngine(fx.config, 1.0, device=dev)
    eng.load_flax_params(fx.params)
    params, cfg = eng._fused_params(detach=True), eng.ngp_config.cp
    gen = torch.Generator(device=dev).manual_seed(1)
    xt, vd = chip_smoke.random_points(n, gen, dev)
    run = (lambda: ngp_fused_apply_cf(params, xt, vd, cfg)) if args.color else \
        (lambda: ngp_fused_sigma_cf(params, xt, cfg))
    run_fox = None
    if args.color:  # row 3 also at fox_ngp.yml's encoder, seeded weights
        import dataclasses

        cfox = dataclasses.replace(cfg, n_levels=5, n_components=96, table_size=256,
                                   base_resolution=16, max_resolution=2048)
        pfox = chip_smoke.seeded_fused_params(
            cfox, torch.Generator(device=dev).manual_seed(61), dev)
        xf, vf = chip_smoke.random_points(16384 * 64, gen, dev)
        run_fox = lambda: ngp_fused_apply_cf(pfox, xf, vf, cfox)
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device=dev)
    root = os.path.join(cuda_lib.build_dir(), "ablation")
    for i, (name, edits) in enumerate(variants.items()):
        if keep and name not in keep:
            continue
        here = os.path.join(root, str(i))
        shutil.rmtree(here, ignore_errors=True)
        shutil.copytree(src, os.path.join(here, "csrc"))
        for fname, subs in edits:
            path = os.path.join(here, "csrc", fname)
            with open(path) as f:
                text = f.read()
            for old, new in subs:
                if old not in text:
                    print(f"torch_ablate_forward: the edit for {name!r} no longer "
                          f"matches {fname}", file=sys.stderr)
                    return 1
                text = text.replace(old, new)
            with open(path, "w") as f:
                f.write(text)
        cuda_lib.CSRC_DIR = os.path.join(here, "csrc")
        cuda_lib._LIB = None
        os.environ["NKT_TORCH_BUILD_DIR"] = os.path.join(here, "lib")
        cuda_lib.load_library()
        rec = {"variant": name, "row": row, "kernel": kernel, "n_points": n,
               "ms": chip_smoke.time_ms(run, 5, 2, flush)}
        if run_fox is not None:
            rec["fox_n_points"] = 16384 * 64
            rec["fox_ms"] = chip_smoke.time_ms(run_fox, 5, 2, flush)
        rec.update(tree=tree, device=chip_smoke.nvidia_smi_line())
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
