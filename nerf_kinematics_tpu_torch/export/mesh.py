"""Density grid -> triangle mesh -> PLY: the ``--save_mesh`` path
(instant-ngp's ``src/marching_cubes.cu``: a 256^3 grid, density threshold
2.5). The engine queries the density on the device
(``NGPEngine.density_grid``); the isosurface is extracted on the host by
the native core ``native/mesh_extract.cpp`` (marching tetrahedra, six
tetrahedra a cube, vertices welded by lattice edge, OpenMP over x slabs),
loaded with ctypes.

Counterpart of ``nerf_kinematics_tpu/export/mesh.py``. The native core is
the JAX package's source, built at first use with ``g++`` into the port's
build directory (``ops/cuda_lib.py::build_dir``). There is no fallback:
:func:`extract_mesh` uses the native core or raises. :func:`extract_mesh_ref`
is its plain version in numpy: the same vertices in the same order and the
same triangles, which the tests and ``chip_smoke.py`` hold the core to.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
from typing import Optional, Tuple

import numpy as np
import torch

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..",
                    "native", "mesh_extract.cpp")
# No -march=native (a build directory may move between hosts) and no fused
# multiply-adds, so that the core's vertices are the plain f32 arithmetic of
# extract_mesh_ref.
CXX_FLAGS = ["-O3", "-ffp-contract=off", "-fPIC", "-shared", "-fopenmp", "-std=c++17"]
_LIB = None

# The core's tables (native/mesh_extract.cpp): the six tetrahedra of a cube
# as corner ids, the corner offsets, a tetrahedron's six edges and, for each
# inside/outside code of a tetrahedron's corners, its triangles as edge ids.
_TETS = np.array([[0, 5, 1, 6], [0, 1, 2, 6], [0, 2, 3, 6],
                  [0, 3, 7, 6], [0, 7, 4, 6], [0, 4, 5, 6]])
_CORNER_OFF = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
                        [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1]])
_TET_EDGES = np.array([[0, 1], [0, 2], [0, 3], [1, 2], [1, 3], [2, 3]])
_TRI_TABLE = {
    1: [(0, 2, 1)], 2: [(0, 3, 4)], 3: [(1, 2, 3), (3, 2, 4)],
    4: [(1, 3, 5)], 5: [(0, 2, 3), (3, 2, 5)], 6: [(0, 1, 5), (0, 5, 4)],
    7: [(2, 4, 5)], 8: [(2, 5, 4)], 9: [(0, 5, 1), (0, 4, 5)],
    10: [(0, 3, 2), (3, 5, 2)], 11: [(1, 5, 3)],
    12: [(1, 3, 2), (3, 4, 2)], 13: [(0, 4, 3)], 14: [(0, 1, 2)],
}


def _build_native() -> str:
    """The core's shared library, built at first use into the build
    directory; its name carries a hash of the source and the flags."""
    from ..ops.cuda_lib import build_dir

    with open(_SRC, "rb") as f:
        src = f.read()
    tag = hashlib.sha256(src + " ".join(CXX_FLAGS + [platform.machine()]).encode()
                         ).hexdigest()[:12]
    out_dir = build_dir()
    path = os.path.join(out_dir, f"libnkt_mesh_{tag}.so")
    if os.path.isfile(path):
        return path
    os.makedirs(out_dir, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    res = subprocess.run(["g++", *CXX_FLAGS, "-o", tmp, os.path.abspath(_SRC)],
                         capture_output=True, text=True, timeout=300)
    if res.returncode != 0:
        raise RuntimeError(f"building the mesh core failed:\n{res.stderr}")
    os.replace(tmp, path)
    return path


def load_native():
    """The native core (built at first use), with ``argtypes`` set; raises
    when it cannot be built or loaded."""
    global _LIB
    if _LIB is not None:
        return _LIB
    lib = ctypes.CDLL(_build_native())
    fp = ctypes.POINTER(ctypes.c_float)
    lib.mesh_extract.restype = ctypes.c_int
    lib.mesh_extract.argtypes = [
        fp, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float, fp,
        ctypes.POINTER(fp), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.POINTER(ctypes.c_int32)),
        ctypes.POINTER(ctypes.c_int64),
    ]
    lib.mesh_free.argtypes = [ctypes.c_void_p]
    _LIB = lib
    return lib


def _grid_and_bounds(grid, bounds):
    if isinstance(grid, torch.Tensor):
        grid = grid.detach().cpu().numpy()
    grid = np.ascontiguousarray(grid, dtype=np.float32)
    if grid.ndim != 3 or min(grid.shape) < 2:
        raise ValueError(f"a density grid needs three axes of 2 or more, got {grid.shape}")
    if bounds is None:
        bounds = (0.0, 0.0, 0.0, 1.0, 1.0, 1.0)
    return grid, np.asarray(bounds, np.float32)


def extract_mesh(grid, iso: float = 2.5,
                 bounds: Optional[Tuple[float, ...]] = None) -> Tuple[np.ndarray, np.ndarray]:
    """The iso-surface of a density grid (nx, ny, nz), indexed
    ``grid[x, y, z]``, by the native core. Returns (verts (V, 3) f32,
    tris (T, 3) int32); ``bounds`` = (xmin, ymin, zmin, xmax, ymax, zmax),
    the unit cube by default."""
    grid, b = _grid_and_bounds(grid, bounds)
    nx, ny, nz = grid.shape
    lib = load_native()
    verts_p = ctypes.POINTER(ctypes.c_float)()
    tris_p = ctypes.POINTER(ctypes.c_int32)()
    nv, nt = ctypes.c_int64(), ctypes.c_int64()
    rc = lib.mesh_extract(
        grid.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), nx, ny, nz,
        ctypes.c_float(iso), b.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.byref(verts_p), ctypes.byref(nv), ctypes.byref(tris_p), ctypes.byref(nt))
    if rc != 0:
        raise RuntimeError(f"mesh_extract returned {rc}")
    try:
        verts = np.ctypeslib.as_array(verts_p, shape=(nv.value, 3)).copy() \
            if nv.value else np.zeros((0, 3), np.float32)
        tris = np.ctypeslib.as_array(tris_p, shape=(nt.value, 3)).copy() \
            if nt.value else np.zeros((0, 3), np.int32)
    finally:
        lib.mesh_free(verts_p)
        lib.mesh_free(tris_p)
    return verts, tris


def extract_mesh_ref(grid, iso: float = 2.5,
                     bounds: Optional[Tuple[float, ...]] = None
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Plain version of :func:`extract_mesh`, in numpy, vectorized over the
    cells: the core's vertices in the core's order and its triangles."""
    verts, tris, _ = _extract_mesh_keyed(grid, iso, bounds)
    return verts, tris


def _extract_mesh_keyed(grid, iso, bounds):
    """:func:`extract_mesh_ref` and each vertex's key.

    A vertex is the cut of one lattice edge (a pair of global corner ids,
    lower first: the key), placed from the key alone as the core places it
    (``t = (iso - va) / (vb - va + 1e-30)`` clamped, in f32). The core
    numbers the vertices as its x slabs first emit them (cells in
    x, y, z order, then tetrahedron, then position in the triangle list),
    so a vertex's number is the order of its earliest emission; triangles
    come in cell, tetrahedron, triangle order. A corner counts as inside
    when its value is above ``iso`` (a NaN is outside)."""
    grid, b = _grid_and_bounds(grid, bounds)
    nx, ny, nz = grid.shape
    iso32 = np.float32(iso)
    lo, hi = b[:3], b[3:]
    scale = (hi - lo) / np.array([nx - 1, ny - 1, nz - 1], np.float32)

    # the cells with a corner inside and a corner outside, in x, y, z order
    inside = grid > iso32
    views = [inside[o[0]:nx - 1 + o[0], o[1]:ny - 1 + o[1], o[2]:nz - 1 + o[2]]
             for o in _CORNER_OFF]
    any_in = np.logical_or.reduce(views)
    all_in = np.logical_and.reduce(views)
    cx, cy, cz = np.nonzero(any_in & ~all_in)
    cell = (cx.astype(np.int64) * (ny - 1) + cy) * (nz - 1) + cz
    cg = np.stack([((cx + o[0]).astype(np.int64) * ny + (cy + o[1])) * nz + (cz + o[2])
                   for o in _CORNER_OFF], axis=1)  # (M, 8) global corner ids
    cin = np.stack([inside.reshape(-1)[cg[:, c]] for c in range(8)], axis=1)

    keys, ranks, tri_keys, tri_ranks = [], [], [], []
    for k, tet in enumerate(_TETS):
        code = (cin[:, tet] * np.array([1, 2, 4, 8])).sum(axis=1)
        tg = cg[:, tet]  # (M, 4)
        for c, tris in _TRI_TABLE.items():
            m = np.nonzero(code == c)[0]
            if m.size == 0:
                continue
            seq = [e for tri in tris for e in tri]
            edge_key = {}
            for e in dict.fromkeys(seq):  # each edge at its first position
                ga, gb = tg[m, _TET_EDGES[e, 0]], tg[m, _TET_EDGES[e, 1]]
                key = (np.minimum(ga, gb).astype(np.uint64) << np.uint64(32)) \
                    | np.maximum(ga, gb).astype(np.uint64)
                edge_key[e] = key
                keys.append(key)
                ranks.append((cell[m] * 6 + k) * 6 + seq.index(e))
            for i, tri in enumerate(tris):
                tri_keys.append(np.stack([edge_key[e] for e in tri], axis=1))
                tri_ranks.append((cell[m] * 6 + k) * 2 + i)
    if not keys:
        return (np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32),
                np.zeros(0, np.uint64))
    keys, ranks = np.concatenate(keys), np.concatenate(ranks)
    by_rank = keys[np.argsort(ranks, kind="stable")]
    uniq, first = np.unique(by_rank, return_index=True)  # earliest emission
    order = np.argsort(first, kind="stable")
    vkeys = uniq[order]  # vertex i's key
    number = np.empty(len(uniq), np.int64)
    number[order] = np.arange(len(uniq))

    tri_keys = np.concatenate(tri_keys)[np.argsort(np.concatenate(tri_ranks), kind="stable")]
    tris = number[np.searchsorted(uniq, tri_keys)].astype(np.int32)

    ga = (vkeys >> np.uint64(32)).astype(np.int64)
    gb = (vkeys & np.uint64(0xFFFFFFFF)).astype(np.int64)
    flat = grid.reshape(-1)
    va, vb = flat[ga], flat[gb]
    t = np.clip((iso32 - va) / (vb - va + np.float32(1e-30)), np.float32(0), np.float32(1))
    ends = []
    for g in (ga, gb):
        ends.append(np.stack([g // (ny * nz), (g // nz) % ny, g % nz], axis=1).astype(np.float32))
    verts = lo + (ends[0] + t[:, None] * (ends[1] - ends[0])) * scale
    return verts.astype(np.float32), tris, vkeys


def save_ply(path: str, verts: np.ndarray, tris: np.ndarray) -> None:
    """Binary little-endian PLY."""
    verts = np.asarray(verts, np.float32)
    tris = np.asarray(tris, np.int32)
    with open(path, "wb") as f:
        header = (
            "ply\nformat binary_little_endian 1.0\n"
            f"element vertex {len(verts)}\n"
            "property float x\nproperty float y\nproperty float z\n"
            f"element face {len(tris)}\n"
            "property list uchar int vertex_indices\nend_header\n"
        )
        f.write(header.encode())
        f.write(verts.astype("<f4").tobytes())
        face = np.empty(len(tris), dtype=[("n", "u1"), ("idx", "<i4", 3)])
        face["n"] = 3
        face["idx"] = tris
        f.write(face.tobytes())


def load_ply(path: str):
    """Reader of the files :func:`save_ply` writes: (verts, tris)."""
    with open(path, "rb") as f:
        header = b""
        while not header.endswith(b"end_header\n"):
            line = f.readline()
            if not line:
                raise ValueError(f"{path}: no end_header")
            header += line
        lines = header.decode().splitlines()
        nv = int(next(l.split()[-1] for l in lines if l.startswith("element vertex")))
        nt = int(next(l.split()[-1] for l in lines if l.startswith("element face")))
        verts = np.frombuffer(f.read(nv * 12), dtype="<f4").reshape(nv, 3)
        face = np.frombuffer(f.read(nt * 13), dtype=[("n", "u1"), ("idx", "<i4", 3)])
        return verts.copy(), face["idx"].copy()


def extract_mesh_from_engine(engine, params: Optional[torch.Tensor] = None,
                             resolution: int = 256, iso: float = 2.5,
                             path: Optional[str] = None):
    """The whole ``--save_mesh`` path: the density grid over the scene box
    on the engine's device (with the flat parameter buffer ``params`` bound,
    e.g. ``train/loop.py::eval_params(state)``; by default what the model
    shows), the native core on the host, and a PLY at ``path`` when given.
    Returns (verts, tris)."""
    if params is None:
        grid = engine.density_grid(resolution=resolution)
    else:
        with engine.bound(params):
            grid = engine.density_grid(resolution=resolution)
    b = engine.scene_bound
    verts, tris = extract_mesh(grid.cpu().numpy(), iso=iso, bounds=(-b, -b, -b, b, b, b))
    if path is not None:
        save_ply(path, verts, tris)
    return verts, tris
