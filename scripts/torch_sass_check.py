#!/usr/bin/env python3
"""Count the tensor-core instructions of each kernel in the port's built CUDA
library: ``cuobjdump -sass`` of the library, HMMA / HGMMA per kernel.

    python3 scripts/torch_sass_check.py          # builds the library first if needed

Prints one JSON object: per kernel the number of HMMA (``mma.sync``) and
HGMMA (``wgmma``) instructions, and of the HMMA those with TF32 operands.
Exits 1 when a bf16-mode kernel of the fast engine has none, when a classic
f32-mode kernel (3xTF32) has no TF32 HMMA, or when an FMA kernel (the fast
engine's f32 mode, the classic engine's bf16 mode) has any. Needs the CUDA
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

TENSOR_CORE = ("nkt_mma_sigma_kernel", "nkt_mma_apply_kernel",
               "nkt_mma_apply_save_kernel", "nkt_mma_point_bwd_kernel",
               "nkt_wgrad_mma_kernel")
TF32 = ("nkc_tc_forward_kernel", "nkc_tc_bwd_tile_kernel", "nkc_tc_wgrad_kernel")
FMA_ONLY = ("nkt_fused_sigma_kernel", "nkt_fused_apply_kernel",
            "nkt_fused_apply_save_kernel", "nkt_fused_point_bwd_kernel",
            "nkt_wgrad_kernel", "nkc_forward_kernel", "nkc_bwd_tile_kernel",
            "nkt_cp_encode_bwd_kernel")


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
        hits = {k: v for k, v in counts.items() if kernel in k}
        return {"HMMA": sum(v["HMMA"] for v in hits.values()),
                "HGMMA": sum(v["HGMMA"] for v in hits.values()),
                "TF32": sum(v["TF32"] for v in hits.values()),
                "functions": len(hits)}

    report = {k: of(k) for k in TENSOR_CORE + TF32 + FMA_ONLY}
    print(json.dumps({"library": os.path.basename(lib), "kernels": report}))
    bad = [k for k in TENSOR_CORE
           if report[k]["functions"] == 0 or report[k]["HMMA"] + report[k]["HGMMA"] == 0]
    bad += [k for k in TF32 if report[k]["functions"] == 0 or report[k]["TF32"] == 0]
    bad += [k for k in FMA_ONLY
            if report[k]["functions"] == 0 or report[k]["HMMA"] + report[k]["HGMMA"] > 0]
    if bad:
        print(f"torch_sass_check: unexpected tensor-core use in {bad}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
