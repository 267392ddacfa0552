"""Build and load the port's CUDA kernels.

The sources under ``csrc/`` have a plain C interface and include no PyTorch
header, so ``nvcc`` builds them in seconds. They are compiled at first use
(one ``nvcc -c`` per source, all started together, then one link) into a
shared library under ``build/`` beside the package and loaded with ``ctypes``.
Nothing here runs at import time: CPU-only machines import every module.

Each kernel's wrapper counts its launch through :func:`launched` and nowhere
else: one to ``LAUNCHES[name]``, so a run can show which kernels it went
through, and the launch's points to ``POINTS[name, body]``. The same call
closes the wrapper's span ``launch.<name>`` (``utils/profiling.py``), which
runs from the wrapper's entry to the return of its ``ctypes`` call; inside
it ``launch.operands`` (bf16 mode's line copy and weight pack),
``launch.plan`` (layouts, block plans and the library's size and plan
queries), ``launch.scratch`` (the launch's ``torch.empty`` scratch) and
``launch.call`` (the ``ctypes`` call).
"""

from __future__ import annotations

import collections
import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import time

import torch

from ..utils import profiling
from .cp_grid import CPGridConfig, fold_salt, level_clip_max

MAX_LEVELS = 8
MAX_LAYERS = 8
MAX_WIDTH = 64  # NKT_W of csrc/ngp_fused.cuh
SMEM_LIMIT = 232448  # bytes of shared memory one block may use on sm_90
CLASSIC_MAX_LAYERS = 16  # NKC_MAX_LAYERS of csrc/classic_fused.cu
CLASSIC_PACK_Y = 16      # NKC_PACK_Y: pack blocks a layer
CLASSIC_MAX_FREQS = 16   # NKC_MAX_FREQS
MAX_BINS = 256     # NKF_MAX_BINS of csrc/ngp_fused_full.cu
MAX_SAMPLES = 256  # NKF_MAX_SAMPLES

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-Xcompiler", "-fPIC",
]

# Launch counts by the name of the function each kernel computes.
LAUNCHES = {
    "occupancy_at_hull": 0,
    "ngp_fused_sigma_cf": 0,
    "ngp_fused_apply_cf": 0,
    "cp_encode": 0,
    "cp_encode_bwd": 0,
    "ngp_fused_apply_cf_bwd": 0,
    "ngp_fused_train_cf": 0,
    "ngp_fused_train_full_cf": 0,
    "classic_fused_apply_cf": 0,
    "classic_fused_apply_cf_bwd": 0,
}


# Points each kernel's launches took (row 8: coarse and fine points), by the
# same names and by the body that ran: "bf16" / "f32" where the mode picks the
# fast engine's kernels, "3xtf32" / "fma" / "bf16" for the classic ones,
# "kernel" where one kernel serves every call. ("cp_encode_bwd_in_fused",
# "bf16" / "f32"): the points row 5's kernel walks inside the fused gradient
# kernels' launches. A kernel's time on a path is its points times its body's
# time a point.
POINTS: collections.Counter = collections.Counter()

# The wrappers' spans, by the same names.
LAUNCH_SPAN = {name: "launch." + name for name in LAUNCHES}


def launched(span: int, name: str, body: str, points: int, in_fused: int = 0) -> None:
    """Count one launch of ``name``'s kernel over ``points`` points on
    ``body`` (``in_fused``: the points row 5's kernel walks inside it), and
    close the wrapper's span ``span`` (``launch.<name>``)."""
    LAUNCHES[name] += 1
    POINTS[name, body] += points
    if in_fused:
        POINTS["cp_encode_bwd_in_fused", body] += in_fused
    profiling.end(span)


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    POINTS.clear()


class CPLevels(ctypes.Structure):
    """Mirrors ``struct CPLevels`` of csrc/nkt_common.cuh."""

    _fields_ = [
        ("n_levels", ctypes.c_int),
        ("n_comp", ctypes.c_int),
        ("table", ctypes.c_int),
        ("use_bf16", ctypes.c_int),
        ("hashed", ctypes.c_int),
        ("R", ctypes.c_int * MAX_LEVELS),
        ("F", ctypes.c_int * MAX_LEVELS),
        ("pmax", ctypes.c_float * MAX_LEVELS),
        ("salt", (ctypes.c_int * 3) * MAX_LEVELS),
        ("nonfinite", ctypes.c_void_p),
    ]


class FusedArgs(ctypes.Structure):
    """Mirrors ``struct FusedArgs`` of csrc/ngp_fused.cuh."""

    _fields_ = [
        ("xt", ctypes.c_void_p),
        ("vdt", ctypes.c_void_p),
        ("lines", ctypes.c_void_p),
        ("lines16", ctypes.c_void_p),
        ("out", ctypes.c_void_p),
        ("dW", ctypes.c_void_p * MAX_LAYERS),
        ("db", ctypes.c_void_p * MAX_LAYERS),
        ("cW", ctypes.c_void_p * MAX_LAYERS),
        ("cb", ctypes.c_void_p * MAX_LAYERS),
        ("n", ctypes.c_longlong),
        ("nd", ctypes.c_int),
        ("nc", ctypes.c_int),
        ("d_in", ctypes.c_int * MAX_LAYERS),
        ("d_out", ctypes.c_int * MAX_LAYERS),
        ("c_in", ctypes.c_int * MAX_LAYERS),
        ("c_out", ctypes.c_int * MAX_LAYERS),
        ("cp", CPLevels),
        ("wpk", ctypes.c_void_p),
        ("pk_off", ctypes.c_int * (2 * MAX_LAYERS)),
        ("pk_ld", ctypes.c_int * (2 * MAX_LAYERS)),
        ("pk_dens", ctypes.c_int),
        ("pk_fwd", ctypes.c_int),
        ("enc", ctypes.c_void_p),
        ("enc_slots", ctypes.c_longlong),
    ]


class BwdArgs(ctypes.Structure):
    """Mirrors ``struct BwdArgs`` of csrc/ngp_fused.cuh."""

    _fields_ = [
        ("f", FusedArgs),
        ("g", ctypes.c_void_p),
        ("act", ctypes.c_void_p),
        ("z0", ctypes.c_void_p),
        ("gs", ctypes.c_void_p),
        ("partial", ctypes.c_void_p),
        ("flat", ctypes.c_void_p),
        ("dlines", ctypes.c_void_p),
        ("denc", ctypes.c_void_p),
        ("lpart", ctypes.c_void_p),
        ("l_chunks", ctypes.c_int),
        ("dists", ctypes.c_void_p),
        ("tgt", ctypes.c_void_p),
        ("err", ctypes.c_void_p),
        ("maps", ctypes.c_void_p),
        ("gbuf", ctypes.c_void_p),
        ("S", ctypes.c_int),
        ("white_bg", ctypes.c_int),
        ("inv_denom", ctypes.c_float),
        ("n_part", ctypes.c_int),
        ("ld", ctypes.c_longlong),
    ]


class FullArgs(ctypes.Structure):
    """Mirrors ``struct FullArgs`` of csrc/ngp_fused_full.cu."""

    _fields_ = [
        ("b", BwdArgs),
        ("o", ctypes.c_void_p),
        ("d", ctypes.c_void_p),
        ("vd", ctypes.c_void_p),
        ("uc", ctypes.c_void_p),
        ("uf", ctypes.c_void_p),
        ("proj2", ctypes.c_void_p),
        ("zc", ctypes.c_void_p),
        ("xtc", ctypes.c_void_p),
        ("sigc", ctypes.c_void_p),
        ("errc", ctypes.c_void_p),
        ("R", ctypes.c_longlong),
        ("Sc", ctypes.c_int),
        ("NB", ctypes.c_int),
        ("Rg", ctypes.c_int),
        ("near", ctypes.c_double),
        ("step", ctypes.c_double),
        ("inv_bound2", ctypes.c_float),
        ("occ_floor", ctypes.c_float),
    ]


_CL = CLASSIC_MAX_LAYERS


class ClassicArgs(ctypes.Structure):
    """Mirrors ``struct ClassicArgs`` of csrc/classic_fused.cu."""

    _fields_ = [
        ("xt", ctypes.c_void_p),
        ("vdt", ctypes.c_void_p),
        ("out", ctypes.c_void_p),
        ("W", ctypes.c_void_p * _CL),
        ("b", ctypes.c_void_p * _CL),
        ("w_sk", ctypes.c_longlong * _CL),
        ("w_sj", ctypes.c_longlong * _CL),
        ("b_s", ctypes.c_longlong * _CL),
        ("wf", ctypes.c_void_p),
        ("wb", ctypes.c_void_p),
        ("bias", ctypes.c_void_p),
        ("tf", ctypes.c_void_p),
        ("tb", ctypes.c_void_p),
        ("nonfinite", ctypes.c_void_p),
        ("n", ctypes.c_longlong),
        ("nw", ctypes.c_int),
        ("trunk", ctypes.c_int),
        ("hidden", ctypes.c_int),
        ("buf_rows", ctypes.c_int),
        ("in_dim", ctypes.c_int * _CL),
        ("out_dim", ctypes.c_int * _CL),
        ("rnd", ctypes.c_int * _CL),
        ("wf_off", ctypes.c_int * _CL),
        ("wf_ld", ctypes.c_int * _CL),
        ("wb_off", ctypes.c_int * _CL),
        ("wb_ld", ctypes.c_int * _CL),
        ("wb_cols", ctypes.c_int * _CL),
        ("b_off", ctypes.c_int * _CL),
        ("tf_off", ctypes.c_int * _CL),
        ("tb_off", ctypes.c_int * _CL),
        ("tc", ctypes.c_int),
        ("n_freq_x", ctypes.c_int),
        ("n_freq_d", ctypes.c_int),
        ("inc_x", ctypes.c_int),
        ("inc_d", ctypes.c_int),
        ("freq_x", ctypes.c_float * CLASSIC_MAX_FREQS),
        ("freq_d", ctypes.c_float * CLASSIC_MAX_FREQS),
        ("g", ctypes.c_void_p),
        ("act", ctypes.c_void_p),
        ("gs", ctypes.c_void_p),
        ("partial", ctypes.c_void_p),
        ("flat", ctypes.c_void_p),
        ("act_row", ctypes.c_int * _CL),
        ("gs_row", ctypes.c_int * _CL),
        ("dw_off", ctypes.c_int * _CL),
        ("db_off", ctypes.c_int * _CL),
        ("grad_total", ctypes.c_int),
        ("n_part", ctypes.c_int),
    ]


def cp_levels(cfg: CPGridConfig) -> CPLevels:
    """The kernels' description of a :class:`CPGridConfig`."""
    if cfg.n_levels > MAX_LEVELS:
        raise ValueError(f"the kernels take at most {MAX_LEVELS} levels")
    if cfg.fold not in ("periodic", "hash"):
        raise ValueError(f"unknown fold mode {cfg.fold!r}")
    cp = CPLevels()
    cp.n_levels = cfg.n_levels
    cp.n_comp = cfg.n_components
    cp.table = cfg.table_size
    cp.use_bf16 = int(cfg.use_bf16)
    cp.hashed = int(cfg.fold == "hash")
    for l, R in enumerate(cfg.resolutions):
        cp.R[l] = R
        cp.F[l] = cfg.level_fold(R)
        cp.pmax[l] = level_clip_max(R)
        for a in range(3):
            cp.salt[l][a] = fold_salt(l, a)
    return cp


# ---------------------------------------------------------------- building

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")

_LIB = None
BUILD_INFO = {"seconds": None, "library": None, "cached": None}


def build_dir() -> str:
    """Where the library is built: ``$NKT_TORCH_BUILD_DIR`` or
    ``build/nerf_kinematics_tpu_torch`` beside the package."""
    return os.environ.get("NKT_TORCH_BUILD_DIR") or os.path.join(
        os.path.dirname(_PKG_DIR), "build", "nerf_kinematics_tpu_torch"
    )


def _nvcc() -> str:
    exe = shutil.which("nvcc")
    if exe:
        return exe
    exe = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if not os.path.isfile(exe):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return exe


def _sources():
    names = sorted(os.listdir(CSRC_DIR))
    cu = [os.path.join(CSRC_DIR, n) for n in names if n.endswith(".cu")]
    hdr = [os.path.join(CSRC_DIR, n) for n in names if n.endswith(".cuh")]
    return cu, hdr


def build_library(verbose: bool = False) -> str:
    """Compile ``csrc/*.cu`` into one shared library; returns its path. The
    file name carries a hash of the sources and flags, so an unchanged tree
    reuses the library it built before. Processes that build at once (the
    ranks of one job) take turns on a lock of the build directory: the first
    compiles and links, the others find its library."""
    cu, hdr = _sources()
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in cu + hdr:
        with open(path, "rb") as f:
            digest.update(f.read())
    out_dir = build_dir()
    os.makedirs(out_dir, exist_ok=True)
    lib = os.path.join(out_dir, f"libnkt_kernels_{digest.hexdigest()[:16]}.so")
    t0 = time.perf_counter()
    if os.path.isfile(lib):
        BUILD_INFO.update(seconds=0.0, library=lib, cached=True)
        return lib
    # the lock is held until the file closes, however the block ends
    with open(os.path.join(out_dir, ".build.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.isfile(lib):
            BUILD_INFO.update(seconds=time.perf_counter() - t0, library=lib,
                              cached=True)
            return lib
        _compile_and_link(cu, out_dir, lib, verbose)
    BUILD_INFO.update(seconds=time.perf_counter() - t0, library=lib, cached=False)
    return lib


def _compile_and_link(cu, out_dir: str, lib: str, verbose: bool) -> None:
    """One ``nvcc -c`` a source, all started together, then one link into
    ``lib``; the caller holds the build directory's lock."""
    nvcc = _nvcc()
    extra = ["-Xptxas", "-v"] if verbose else []
    procs = []
    for src in cu:
        obj = os.path.join(
            out_dir, os.path.splitext(os.path.basename(src))[0] + ".o"
        )
        cmd = [nvcc, *NVCC_FLAGS, *extra, "-c", src, "-o", obj]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs, failed = [], []
    for src, obj, p in procs:
        text, _ = p.communicate()
        logs.append(f"== {os.path.basename(src)}\n{text}")
        if p.returncode != 0:
            failed.append(os.path.basename(src))
    with open(os.path.join(out_dir, "build.log"), "w") as f:
        f.write("\n".join(logs))
    if failed:
        raise RuntimeError(
            "nvcc failed for " + ", ".join(failed) + ":\n" + "\n".join(logs)
        )
    tmp = lib + f".tmp{os.getpid()}"
    link = subprocess.run(
        [nvcc, "-shared", "-o", tmp, *[obj for _, obj, _ in procs]],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    if link.returncode != 0:
        raise RuntimeError("linking the CUDA kernels failed:\n" + link.stdout)
    os.replace(tmp, lib)
    if verbose:
        print("\n".join(logs))


def load_library(verbose: bool = False):
    """The loaded library (built at first use), with ``argtypes`` set."""
    global _LIB
    if _LIB is not None:
        return _LIB
    lib = ctypes.CDLL(build_library(verbose=verbose))
    vp, ll, ci = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.nkt_occupancy_at_hull.argtypes = [vp, vp, vp, ll, ci, ci, vp]
    lib.nkt_occupancy_at_hull.restype = ci
    lib.nkt_cp_encode.argtypes = [vp, vp, vp, ll, ctypes.POINTER(CPLevels), ci, vp]
    lib.nkt_cp_encode.restype = ci
    lib.nkt_fused_forward.argtypes = [ctypes.POINTER(FusedArgs), ci, ci, vp]
    lib.nkt_fused_forward.restype = ci
    lib.nkt_fused_smem_bytes.argtypes = [ctypes.POINTER(FusedArgs), ci]
    lib.nkt_fused_smem_bytes.restype = ll
    lib.nkt_apply_layout.argtypes = [ctypes.POINTER(FusedArgs), ctypes.POINTER(ll)]
    lib.nkt_apply_layout.restype = None
    lib.nkt_cp_encode_bwd.argtypes = [
        vp, vp, vp, vp, vp, ll, ctypes.POINTER(CPLevels), ci, vp]
    lib.nkt_cp_encode_bwd.restype = ci
    lib.nkt_nonfinite_words.argtypes = [ctypes.POINTER(CPLevels)]
    lib.nkt_nonfinite_words.restype = ll
    lib.nkt_fused_bwd_sizes.argtypes = [
        ctypes.POINTER(FusedArgs), ctypes.POINTER(ll)]
    lib.nkt_fused_bwd_sizes.restype = None
    lib.nkt_fused_bwd_plan.argtypes = [ctypes.POINTER(FusedArgs), ci, ctypes.POINTER(ll)]
    lib.nkt_fused_bwd_plan.restype = ci
    for fn in (lib.nkt_fused_backward, lib.nkt_fused_train):
        fn.argtypes = [ctypes.POINTER(BwdArgs), ci, vp]
        fn.restype = ci
    lib.nkt_fused_train_full.argtypes = [ctypes.POINTER(FullArgs), ci, vp]
    lib.nkt_fused_train_full.restype = ci
    for fn in (lib.nkt_classic_forward, lib.nkt_classic_backward):
        fn.argtypes = [ctypes.POINTER(ClassicArgs), vp]
        fn.restype = ci
    _LIB = lib
    return lib


# ------------------------------------------------------ launch-side helpers

def check_tensor(t: torch.Tensor, name: str, shape, device=None) -> None:
    """Raise unless ``t`` is a contiguous f32 CUDA tensor of ``shape``
    (``None`` entries are free) on ``device``."""
    if not isinstance(t, torch.Tensor) or not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor")
    if device is not None and t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise ValueError(f"{name}: dtype {t.dtype}, expected float32")
    if t.dim() != len(shape) or any(
        s is not None and s != d for s, d in zip(shape, t.shape)
    ):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def nonfinite_scratch(cp: CPLevels, device) -> torch.Tensor:
    """The non-finite scratch of one launch (the tables' scan and row 5's
    record, ``CPLevels.nonfinite`` in csrc/nkt_common.cuh), made for each
    launch on the current stream and pointed to from ``cp``; the caller holds
    it until the launch is queued. Each launch has its own, so launches on
    other streams or threads cannot mix their records."""
    words = load_library().nkt_nonfinite_words(ctypes.byref(cp))
    t = torch.empty((words,), dtype=torch.int32, device=device)
    cp.nonfinite = t.data_ptr()
    return t


def sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def current_stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def raise_on_error(code: int, what: str, refused: str | None = None) -> None:
    """Raise on a launcher's nonzero CUDA error code. ``refused``: what a
    launcher's cudaErrorInvalidValue (1) means, a configuration it does not
    take; raised as a ValueError."""
    if code == 1 and refused:
        raise ValueError(f"{what}: {refused}")
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code} at launch")
