#!/usr/bin/env python3
"""Where the time of the CP encoder's kernels goes (row 5, the line tables'
gradient on the tensor cores; row 4, the forward), by ablation: build
variants of the kernel library with one part switched off or changed, and
time the kernels at the main paths' shapes (bf16 mode: row 5 at the flagship
step's 8192 x 48 points, row 4 at the occupancy sweep's 96^3). Row 5 is
timed on uniform random points and on ray-ordered samples (consecutive
points of a ray, as the fused gradients hand it the fine samples), and at
other chunk counts. The ablated variants compute wrong values on purpose;
only their times are read. A stand-in for a profile by stall reason, which
``ncu`` cannot take on these cards.

    python3 scripts/torch_ablate_cp.py
    python3 scripts/torch_ablate_cp.py --variants "as built;batch of 32"

Prints one JSON object per variant (with the registers and spills ptxas
reports for its kernels). The sources are copied and edited under the build
directory (``cuda_lib.build_dir()``); the package's own sources are left as
they are. Exits 1 when an edit no longer matches the source.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import re
import shutil
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from nerf_kinematics_tpu_torch.io.fixture import read_fixture  # noqa: E402
from nerf_kinematics_tpu_torch.ops import cp_grid_cuda, cuda_lib  # noqa: E402
from nerf_kinematics_tpu_torch.ops.cp_grid_cuda import (  # noqa: E402
    cp_encode_cuda, cp_encode_cuda_bwd)
from nerf_kinematics_tpu_torch.train.ngp_engine import NGPEngine  # noqa: E402

D = "cp_encode.cu"
# (file, old, new) edits; what each set changes is its name
BATCH_32 = [(D, "#define NKT_DL_BATCH 64 ", "#define NKT_DL_BATCH 32 ")]
PRODUCERS = "#define NKT_DL_PWARPS 8      // warps that make the taps and the B operand\n" \
    "#define NKT_DL_PREGS 32      // their registers a thread (setmaxnreg), and the\n" \
    "#define NKT_DL_QREGS 136 "
FOUR_PRODUCERS = [(D, PRODUCERS, PRODUCERS.replace("PWARPS 8 ", "PWARPS 4 ")
                   .replace("PREGS 32 ", "PREGS 40 ").replace("QREGS 136 ", "QREGS 152 "))]
TWELVE_PRODUCERS = [(D, PRODUCERS, PRODUCERS.replace("PWARPS 8 ", "PWARPS 12")
                     .replace("QREGS 136 ", "QREGS 128 "))]
NO_PRODUCTS = [(D, "    if (active) {\n      const int np = points(i);",
                "    if (active && nbat < 0) {\n      const int np = points(i);")]
NO_GU = [(D, "      for (int e = tid; e < np * Cp2; e += PT) {",
          "      for (int e = tid; e < 0; e += PT) {")]
NO_TAPS = [(D, "      for (int e = tid; e < np * 3; e += PT) {\n        const int pp = e / 3;\n        tb[e]",
            "      for (int e = tid; e < 0; e += PT) {\n        const int pp = e / 3;\n        tb[e]")]
NO_OPERAND = [(D, "        if (c < cw) {\n          const float2 gc",
               "        if (c < 0) {\n          const float2 gc")]
NO_LOADS = [(D, "          nkt_cp_async16(gb + pp * cw + c, gl + (p0 + pp) * gs_i + c, 16);",
             "          nkt_cp_async16(gb + pp * cw + c, gl + c, 0);")]
VARIANTS = {
    "as built": [],
    "four producer warps (40 registers, product warps 152)": FOUR_PRODUCERS,
    "twelve producer warps (product warps 128 registers)": TWELVE_PRODUCERS,
    "batch of 32": BATCH_32,
    "without the products": NO_PRODUCTS,
    "without the B operand's arithmetic": NO_OPERAND,
    "without the cotangent loads": NO_LOADS,
    "without the products and the B operand": NO_PRODUCTS + NO_GU,
    "without the products, the B operand and the taps": NO_PRODUCTS + NO_GU + NO_TAPS,
    "without the products, the B operand, the taps and the cotangent loads":
        NO_PRODUCTS + NO_GU + NO_TAPS + NO_LOADS,
}
CHUNK_FACTORS = (1.0, 2.0, 3.0)


def ray_points(n_rays: int, per_ray: int, gen, dev):
    """(n_rays * per_ray, 3) unit-cube samples, ray by ray in depth order:
    origins on a sphere of radius 0.9 about the cube's centre, directions
    towards it with a spread, depths sorted over the chord."""
    o = torch.randn((n_rays, 3), generator=gen, device=dev)
    o = 0.5 + 0.9 * o / torch.linalg.norm(o, dim=1, keepdim=True)
    d = 0.5 - o + 0.1 * torch.randn((n_rays, 3), generator=gen, device=dev)
    t = torch.sort(torch.rand((n_rays, per_ray), generator=gen, device=dev), dim=1).values
    x = o[:, None, :] + (0.2 + 1.6 * t)[..., None] * d[:, None, :]
    return torch.clamp(x, 0.0, 1.0).reshape(-1, 3).contiguous()


def ptxas_report(log: str) -> dict:
    """Registers and spill bytes per kernel of csrc/cp_encode.cu (ptxas -v)."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
        elif name and "cp_encode" in name:
            m = re.search(r"(\d+) bytes spill stores", line)
            if m:
                out.setdefault(name, {})["spill_stores"] = int(m.group(1))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                out.setdefault(name, {})["registers"] = int(m.group(1))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", default=";".join(VARIANTS),
                    help="names separated by ';'")
    ap.add_argument("--rays", type=int, default=8192)
    ap.add_argument("--samples", type=int, default=48)
    args = ap.parse_args(argv)
    dev = torch.device("cuda")
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device=dev)
    fx = read_fixture()
    ngp = NGPEngine(fx.config, 1.0, device=dev)
    ngp.load_flax_params(fx.params)
    lines, cp = ngp.model.cp_lines.detach(), ngp.ngp_config.cp
    gen = torch.Generator(device=dev).manual_seed(4321)
    n = args.rays * args.samples
    x_rand = chip_smoke.random_points(n, gen, dev)[0].T.contiguous()
    x_rays = ray_points(args.rays, args.samples, gen, dev)
    g_enc = torch.randn((n, cp.out_dim), generator=gen, device=dev)
    x_sweep = chip_smoke.random_points(fx.config.ngp.occ_resolution ** 3, gen, dev)[0]
    x_sweep = x_sweep.T.contiguous()
    root = os.path.join(cuda_lib.build_dir(), "ablation_cp")
    src = cuda_lib.CSRC_DIR
    smi = chip_smoke.nvidia_smi_line()
    base_chunks = cp_grid_cuda.dlines_chunks
    for i, name in enumerate(args.variants.split(";")):
        here = os.path.join(root, str(i))
        shutil.rmtree(here, ignore_errors=True)
        shutil.copytree(src, os.path.join(here, "csrc"))
        for fname, old, new in VARIANTS[name]:
            path = os.path.join(here, "csrc", fname)
            with open(path) as f:
                text = f.read()
            if old not in text:
                print(f"torch_ablate_cp: the edit for {name!r} no longer "
                      f"matches {fname}", file=sys.stderr)
                return 1
            with open(path, "w") as f:
                f.write(text.replace(old, new))
        cuda_lib.CSRC_DIR = os.path.join(here, "csrc")
        cuda_lib._LIB = None
        os.environ["NKT_TORCH_BUILD_DIR"] = os.path.join(here, "lib")
        with contextlib.redirect_stdout(io.StringIO()) as log:
            cuda_lib.load_library(verbose=True)
        rec = {"variant": name, "points": n, "ptxas": ptxas_report(log.getvalue())}
        with torch.no_grad():
            rec["row4_ms"] = chip_smoke.time_ms(
                lambda: cp_encode_cuda(lines, x_sweep, cp), 5, 2, flush)
            for factor in CHUNK_FACTORS:
                cp_grid_cuda.dlines_chunks = lambda n_, c, s, f=factor: max(
                    1, int(round(base_chunks(n_, c, s) * f)))
                for label, x in (("random", x_rand), ("rays", x_rays)):
                    rec[f"row5_ms_{label}_x{factor}"] = chip_smoke.time_ms(
                        lambda: cp_encode_cuda_bwd(lines, x, g_enc, cp), 5, 2, flush)
            cp_grid_cuda.dlines_chunks = base_chunks
        rec["chunks_x1"] = base_chunks(n, cp, torch.cuda.get_device_properties(0)
                                       .multi_processor_count)
        rec["device"] = smi
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
