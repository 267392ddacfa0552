#!/usr/bin/env python3
"""Where the time of the classic engine's f32 kernels (rows 9, 10: 3xTF32 on
the tensor cores) and of the line-table gradient kernel (row 5) goes, by
ablation: build variants of the kernel library with one part switched off
and time the kernels at the main paths' shapes (rows 9 and 10 at 131 072
points, row 5 at the flagship step's 393 216 points). The variants compute
wrong values on purpose; only their times are read. A stand-in for a
profile by stall reason, which ``ncu`` cannot take on these cards.

    python3 scripts/torch_ablate_classic.py

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

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from nerf_kinematics_tpu_torch.io.fixture import read_fixture  # noqa: E402
from nerf_kinematics_tpu_torch.ops import classic_fused_cuda as cfc  # noqa: E402
from nerf_kinematics_tpu_torch.ops import cp_grid_cuda, cuda_lib  # noqa: E402
from nerf_kinematics_tpu_torch.ops.cp_grid_cuda import cp_encode_cuda_bwd  # noqa: E402
from nerf_kinematics_tpu_torch.train.ngp_engine import NGPEngine  # noqa: E402

C = "classic_fused.cu"
# (file, old, new) edits; what each set switches off is its name
WEIGHTS_L1 = [(C, "      h1 = __ldg(fp + (kt + 2) * FS);\n      l1 = __ldg(fp + (kt + 2) * FS + 1);",
               "      h1 = __ldg(fp);\n      l1 = __ldg(fp + 1);")]
ONE_PRODUCT = [(C, "      nkc_mma(p, al, bh0, bh1);\n      nkc_mma(p, ah, bl0, bl1);\n", "")]
NO_SPLIT = [(C, "  hi = nkc_tf32(x);\n  lo = nkc_tf32(x - __uint_as_float(hi));",
             "  hi = __float_as_uint(x);\n  lo = hi;")]
WG_NO_MMA = [(C, "              if (mi < mc && m0 + mi < mt) {\n                nkc_mma(acc[mi][nt], al[mi]",
              "              if (mi < 0) {\n                nkc_mma(acc[mi][nt], al[mi]")]
DL_NO_WALK = [("cp_encode.cu", "        m = __ballot_sync(0xffffffffu, (o & 255u) == grp || (o >> 8) == grp);",
               "        m = __ballot_sync(0xffffffffu, (o & 255u) == grp || (o >> 8) == grp) & 0u;")]
DL_NO_PRODUCTS = [("cp_encode.cu", "      gb[e] = bf ? nkt_bf16r(v) : v;", "      gb[e] = v * 0.0f + gb[e];")]
DL_NO_STAGE = [("cp_encode.cu", "      nkt_dl_cp4(gbuf[buf] + e, g + (p0 + pp) * gs_i + l * C + ch);",
                "      gbuf[buf][e] = 1.0f;")]
CHUNK_FACTORS = (0.5, 3.0, 6.0)
VARIANTS = {
    "as built": [],
    "weight fragments all from one tile (L1)": WEIGHTS_L1,
    "one TF32 product instead of three": ONE_PRODUCT,
    "no split of the operands": NO_SPLIT,
    "weight gradients without products": WG_NO_MMA,
    "line-table gradient without the walk": DL_NO_WALK,
    "line-table gradient without the cotangent loads": DL_NO_STAGE,
    "line-table gradient without the product pass": DL_NO_PRODUCTS,
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--classic-points", type=int, default=1024 * 128)
    ap.add_argument("--line-points", type=int, default=8192 * 48)
    args = ap.parse_args(argv)
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device=dev)
    eng = chip_smoke.classic_engines(dev, modes=("f32",))["f32"]
    mcfg = eng.cfg.model_coarse
    prm = {k: [t.detach() for t in v] for k, v in eng._fused_params(eng.model_coarse).items()}
    gen = torch.Generator(device=dev).manual_seed(99)
    xt, vd = chip_smoke.classic_points(args.classic_points, gen, dev)
    g4 = torch.randn((4, args.classic_points), generator=gen, device=dev)
    fx = read_fixture()
    ngp = NGPEngine(fx.config, 1.0, device=dev)
    ngp.load_flax_params(fx.params)
    lines, cp = ngp.model.cp_lines.detach(), ngp.ngp_config.cp
    x_enc = chip_smoke.random_points(args.line_points, gen, dev)[0].T.contiguous()
    g_enc = torch.randn((args.line_points, cp.out_dim), generator=gen, device=dev)
    root = os.path.join(cuda_lib.build_dir(), "ablation_classic")
    src = cuda_lib.CSRC_DIR
    smi = chip_smoke.nvidia_smi_line()
    for i, (name, edits) in enumerate(VARIANTS.items()):
        here = os.path.join(root, str(i))
        shutil.rmtree(here, ignore_errors=True)
        shutil.copytree(src, os.path.join(here, "csrc"))
        for fname, old, new in edits:
            path = os.path.join(here, "csrc", fname)
            with open(path) as f:
                text = f.read()
            if old not in text:
                print(f"torch_ablate_classic: the edit for {name!r} no longer "
                      f"matches {fname}", file=sys.stderr)
                return 1
            with open(path, "w") as f:
                f.write(text.replace(old, new))
        cuda_lib.CSRC_DIR = os.path.join(here, "csrc")
        cuda_lib._LIB = None
        os.environ["NKT_TORCH_BUILD_DIR"] = os.path.join(here, "lib")
        cuda_lib.load_library()
        with torch.no_grad():
            ms = {
                "row9_ms": chip_smoke.time_ms(
                    lambda: cfc.classic_fused_apply_cf(prm, xt, vd, mcfg), 5, 2, flush),
                "row10_ms": chip_smoke.time_ms(
                    lambda: cfc.classic_fused_apply_cf_bwd(prm, xt, vd, g4, mcfg), 5, 2, flush),
                "row10_parts_ms": chip_smoke.profile_parts(
                    lambda: cfc.classic_fused_apply_cf_bwd(prm, xt, vd, g4, mcfg),
                    chip_smoke.ROW10_PARTS),
                "row5_ms": chip_smoke.time_ms(
                    lambda: cp_encode_cuda_bwd(lines, x_enc, g_enc, cp), 5, 2, flush),
            }
        print(json.dumps({"variant": name, "classic_points": args.classic_points,
                          "line_points": args.line_points, **ms, "device": smi}), flush=True)
        if i == 0:  # the line-table kernel as built, with other chunk counts
            base = cp_grid_cuda.dlines_chunks
            for factor in CHUNK_FACTORS:
                cp_grid_cuda.dlines_chunks = lambda n, c, s, f=factor: max(
                    1, int(round(base(n, c, s) * f)))
                ms5 = chip_smoke.time_ms(
                    lambda: cp_encode_cuda_bwd(lines, x_enc, g_enc, cp), 5, 2, flush)
                cp_grid_cuda.dlines_chunks = base
                print(json.dumps({"variant": f"as built, {factor}x the chunks of row 5",
                                  "chunks": max(1, int(round(base(args.line_points, cp, 132)
                                                              * factor))),
                                  "row5_ms": ms5, "device": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
