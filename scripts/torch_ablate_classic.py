#!/usr/bin/env python3
"""Where the time of the classic engine's f32 kernels (rows 9, 10: 3xTF32 on
the tensor cores) goes, by ablation: build variants of the kernel library
with one part switched off and time the kernels at the main path's shape
(131 072 points). The variants compute wrong values on purpose; only their
times are read. (``scripts/torch_ablate_cp.py`` does the same for rows 4
and 5.) A stand-in for a
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
from nerf_kinematics_tpu_torch.ops import classic_fused_cuda as cfc  # noqa: E402
from nerf_kinematics_tpu_torch.ops import cuda_lib  # noqa: E402

C = "classic_fused.cu"
# (file, old, new) edits; what each set switches off is its name
WEIGHTS_L1 = [(C, "      h1 = __ldg(fp + (kt + 2) * FS);\n      l1 = __ldg(fp + (kt + 2) * FS + 1);",
               "      h1 = __ldg(fp);\n      l1 = __ldg(fp + 1);")]
ONE_PRODUCT = [(C, "      nkt_mma_tf32(p, al, bh0, bh1);\n      nkt_mma_tf32(p, ah, bl0, bl1);\n", "")]
NO_SPLIT = [("nkt_mma.cuh", "  hi = nkt_tf32(x);\n  lo = nkt_tf32(x - __uint_as_float(hi));",
             "  hi = __float_as_uint(x);\n  lo = hi;")]
WG_NO_MMA = [(C, "              if (mi < mc && m0 + mi < mt) {\n                nkt_mma_tf32(acc[mi][nt], al[mi]",
              "              if (mi < 0) {\n                nkt_mma_tf32(acc[mi][nt], al[mi]")]
VARIANTS = {
    "as built": [],
    "weight fragments all from one tile (L1)": WEIGHTS_L1,
    "one TF32 product instead of three": ONE_PRODUCT,
    "no split of the operands": NO_SPLIT,
    "weight gradients without products": WG_NO_MMA,
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--classic-points", type=int, default=1024 * 128)
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
            }
        print(json.dumps({"variant": name, "classic_points": args.classic_points,
                          **ms, "device": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
