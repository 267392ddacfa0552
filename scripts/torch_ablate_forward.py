#!/usr/bin/env python3
"""Where the bf16 forward body's time goes, by ablation: build variants of
the kernel library with one part of ``csrc/nkt_mma.cuh``'s forward switched
off and time the density-only kernel (row 2) on uniform random points.
The variants compute wrong values on purpose; only their times are read.
A stand-in for a profile by stall reason, which ``ncu`` cannot take on
these cards.

    python3 scripts/torch_ablate_forward.py [--points 10240000]

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
from nerf_kinematics_tpu_torch.ops import cuda_lib  # noqa: E402
from nerf_kinematics_tpu_torch.ops.ngp_fused_cuda import ngp_fused_sigma_cf  # noqa: E402
from nerf_kinematics_tpu_torch.train.ngp_engine import NGPEngine  # noqa: E402

# (what is switched off, the edits of nkt_mma.cuh that do it)
GATHERS = [(f"__ldg(t{a} + q[{i}].r{r} * C2 + c2)", f"__ldg(t{a} + c2)")
           for i, a in enumerate("xyz") for r in (0, 1)]  # every gather hits row 0
RESUM = [("return z != 0.0f && abs(low - 0x8000) < NKT_NEAR;", "return false && low;")]
CHAIN0 = [("        if (lane < NKT_MT)\n          zc = nkt_chain(",
           "        if (lane < 0)\n          zc = nkt_chain(")]
TAPS = [("        taps[lane * 3 + 0] = nkt_tap_s(nkt_taps(px, a.cp, l, 0));\n"
         "        taps[lane * 3 + 1] = nkt_tap_s(nkt_taps(py, a.cp, l, 1));\n"
         "        taps[lane * 3 + 2] = nkt_tap_s(nkt_taps(pz, a.cp, l, 2));\n",
         "        NktTapS q0;\n        q0.r0 = lane;\n        q0.r1 = lane + 1;\n"
         "        q0.w0 = px;\n        q0.w1 = py;\n"
         "        taps[lane * 3 + 0] = q0;\n        taps[lane * 3 + 1] = q0;\n"
         "        taps[lane * 3 + 2] = q0;\n")]
VARIANTS = {
    "as built": [],
    "gathers hit L1 (row 0)": GATHERS,
    "no re-summing near rounding midpoints": RESUM,
    "no exact feature-0 chain": CHAIN0,
    "no tap arithmetic": TAPS,
    "none of the four": GATHERS + RESUM + CHAIN0 + TAPS,
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--points", type=int, default=10240000)
    args = ap.parse_args(argv)
    dev = torch.device("cuda")
    fx = read_fixture()
    eng = NGPEngine(fx.config, 1.0, device=dev)
    eng.load_flax_params(fx.params)
    params, cfg = eng._fused_params(detach=True), eng.ngp_config.cp
    gen = torch.Generator(device=dev).manual_seed(1)
    xt, _ = chip_smoke.random_points(args.points, gen, dev)
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device=dev)
    root = os.path.join(cuda_lib.build_dir(), "ablation")
    src = cuda_lib.CSRC_DIR
    for i, (name, edits) in enumerate(VARIANTS.items()):
        here = os.path.join(root, str(i))
        shutil.rmtree(here, ignore_errors=True)
        shutil.copytree(src, os.path.join(here, "csrc"))
        path = os.path.join(here, "csrc", "nkt_mma.cuh")
        with open(path) as f:
            text = f.read()
        for old, new in edits:
            if old not in text:
                print(f"torch_ablate_forward: the edit for {name!r} no longer "
                      f"matches nkt_mma.cuh", file=sys.stderr)
                return 1
            text = text.replace(old, new)
        with open(path, "w") as f:
            f.write(text)
        cuda_lib.CSRC_DIR = os.path.join(here, "csrc")
        cuda_lib._LIB = None
        os.environ["NKT_TORCH_BUILD_DIR"] = os.path.join(here, "lib")
        cuda_lib.load_library()
        ms = chip_smoke.time_ms(lambda: ngp_fused_sigma_cf(params, xt, cfg), 5, 2, flush)
        print(json.dumps({"variant": name, "row": "ngp_fused_sigma_cf",
                          "n_points": args.points, "ms": ms,
                          "device": chip_smoke.nvidia_smi_line()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
