#!/usr/bin/env python3
"""Count the tensor-core instructions of each kernel in the port's built CUDA
library: ``cuobjdump -sass`` of the library, HMMA / HGMMA per kernel.

    python3 scripts/torch_sass_check.py          # builds the library first if needed

Prints one JSON object: per kernel the number of HMMA (``mma.sync``) and
HGMMA (``wgmma``) instructions, and of the HMMA those with TF32 operands.
Exits 1 when a bf16-mode kernel of the fast engine (the line tables'
gradient's bf16 instance too) has none, when a 3xTF32 kernel (the classic
engine's f32 mode, the line tables' gradient's f32 instance) has no TF32
HMMA, or when an FMA kernel (the fast engine's f32 mode, the classic
engine's bf16 mode, the encoder's forward) has any. Needs the CUDA
toolkit's ``cuobjdump`` (the machine with the card).
"""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from nerf_kinematics_tpu_torch.ops import cuda_lib  # noqa: E402

# The line tables' gradient (row 5) has one template instance per mode:
# bf16 (mma.m16n8k16) and f32 (3xTF32), named here as cuobjdump prints them,
# mangled (ILb1E: <true>) or not.
DL_BF16 = ("nkt_cp_encode_bwd_kernelILb1E", "nkt_cp_encode_bwd_kernel<true>")
DL_F32 = ("nkt_cp_encode_bwd_kernelILb0E", "nkt_cp_encode_bwd_kernel<false>")
# The gradient's tile kernel has instances by register share of layer 0's
# weight gradient (16, 30 and 32 m-tiles: machina's, fox's and encodings up
# to 256 and 512) and tile (machina's, fox's and the largest).
TILE16 = ("nkt_fused_tile_kernelILi16E", "nkt_fused_tile_kernel<16,")
TILE30 = ("nkt_fused_tile_kernelILi30E", "nkt_fused_tile_kernel<30,")
TILE32 = ("nkt_fused_tile_kernelILi32E", "nkt_fused_tile_kernel<32,")
TENSOR_CORE = ("nkt_mma_sigma_kernel", "nkt_apply_tile_kernel", TILE16, TILE30,
               TILE32, "nkt_wgrad_mma_kernel", DL_BF16)
TF32 = ("nkc_tc_forward_kernel", "nkc_tc_bwd_tile_kernel", "nkc_tc_wgrad_kernel",
        DL_F32)
FMA_ONLY = ("nkt_fused_sigma_kernel", "nkt_fused_apply_kernel",
            "nkt_fused_apply_save_kernel", "nkt_fused_point_bwd_kernel",
            "nkt_wgrad_kernel", "nkc_forward_kernel", "nkc_bwd_tile_kernel",
            "nkt_cp_encode_kernel")


def main() -> int:
    lib = cuda_lib.build_library()
    exe = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    sass = subprocess.run([exe, "-sass", lib], stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True, check=True).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            counts.setdefault(name, {"HMMA": 0, "HGMMA": 0, "TF32": 0})
        elif name is not None:
            if "HGMMA" in line:
                counts[name]["HGMMA"] += 1
            elif "HMMA" in line:
                counts[name]["HMMA"] += 1
                if "TF32" in line:
                    counts[name]["TF32"] += 1

    def of(kernel):
        names = (kernel,) if isinstance(kernel, str) else kernel
        hits = {k: v for k, v in counts.items() if any(m in k for m in names)}
        return {"HMMA": sum(v["HMMA"] for v in hits.values()),
                "HGMMA": sum(v["HGMMA"] for v in hits.values()),
                "TF32": sum(v["TF32"] for v in hits.values()),
                "functions": len(hits)}

    label = {k: k if isinstance(k, str) else k[1] for k in TENSOR_CORE + TF32 + FMA_ONLY}
    report = {label[k]: of(k) for k in TENSOR_CORE + TF32 + FMA_ONLY}
    print(json.dumps({"library": os.path.basename(lib), "kernels": report}))
    tc = [report[label[k]] for k in TENSOR_CORE]
    bad = [label[k] for k, r in zip(TENSOR_CORE, tc)
           if r["functions"] == 0 or r["HMMA"] + r["HGMMA"] == 0]
    bad += [label[k] for k in TF32
            if report[label[k]]["functions"] == 0 or report[label[k]]["TF32"] == 0]
    bad += [label[k] for k in FMA_ONLY if report[label[k]]["functions"] == 0
            or report[label[k]]["HMMA"] + report[label[k]]["HGMMA"] > 0]
    if bad:
        print(f"torch_sass_check: unexpected tensor-core use in {bad}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
