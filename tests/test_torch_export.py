"""Mesh export on the CPU, mirroring tests/test_export.py: the native core
(``native/mesh_extract.cpp``, built by the port into its build directory)
against the port's plain version in numpy and against the JAX package's
numpy extractor, bounds, the PLY round trip, the engine to a mesh, and the
density grid's axis order.

Tolerances. The native core against the port's numpy version: the same
vertex and triangle counts, the triangles equal, the vertices within 1e-5
(both place a vertex from its lattice edge in f32, the core built without
fused multiply-adds). Against the JAX package's extractor (vertices sorted by
lattice edge there): the same vertex set within 1e-6 of a unit box, the
same triangles. Geometry: the analytic sphere's radius within 3 % of a cell
pitch, its area within 5 %, as the reference's test.
"""

import os

import numpy as np
import pytest
import torch

from nerf_kinematics_tpu.export import mesh as jm
from nerf_kinematics_tpu_torch.export import mesh as tm


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _sphere_grid(n=32, r=0.3):
    lin = np.linspace(0, 1, n)
    x, y, z = np.meshgrid(lin, lin, lin, indexing="ij")
    return (r - np.sqrt((x - 0.5) ** 2 + (y - 0.5) ** 2 + (z - 0.5) ** 2)).astype(np.float32)


def _blob_grid(n=32):
    lin = np.linspace(-1, 1, n)
    x, y, z = np.meshgrid(lin, lin, lin, indexing="ij")
    return (0.25 - np.sqrt((x - 0.6) ** 2 + y**2 + (z + 0.2) ** 2)).astype(np.float32)


def _area(verts, tris):
    a, b, c = verts[tris[:, 0]], verts[tris[:, 1]], verts[tris[:, 2]]
    return 0.5 * np.linalg.norm(np.cross(b - a, c - a), axis=1).sum()


def test_native_library_builds_into_the_build_directory():
    from nerf_kinematics_tpu_torch.ops.cuda_lib import build_dir

    lib = tm.load_native()
    assert lib is tm.load_native()
    built = [f for f in os.listdir(build_dir()) if f.startswith("libnkt_mesh_")]
    assert built and all(f.endswith(".so") for f in built)
    # nothing is built into the JAX package's native/ directory by the port
    assert os.path.abspath(build_dir()) != os.path.abspath(os.path.dirname(tm._SRC))


GRIDS = {
    "sphere": (lambda: _sphere_grid(), 0.0, None),
    "blob_bounds": (lambda: _blob_grid(), 0.0, (-1, -1, -1, 1, 1, 1)),
    "noise": (lambda: np.random.default_rng(0).standard_normal((12, 9, 10)).astype(np.float32),
              0.0, (-2, -1, 0, 2, 1, 3)),
    "density": (lambda: np.random.default_rng(1).gamma(0.6, 4.0, (17, 17, 17)).astype(np.float32),
                2.5, (-16, -16, -16, 16, 16, 16)),
}


@pytest.mark.parametrize("name", sorted(GRIDS))
def test_native_core_equals_the_plain_version(name):
    make, iso, bounds = GRIDS[name]
    grid = make()
    v, t = tm.extract_mesh(grid, iso=iso, bounds=bounds)
    vr, tr = tm.extract_mesh_ref(grid, iso=iso, bounds=bounds)
    assert len(v) > 100 and v.shape == vr.shape and t.shape == tr.shape
    assert v.dtype == np.float32 and t.dtype == np.int32
    np.testing.assert_array_equal(t, tr)
    np.testing.assert_allclose(v, vr, rtol=0, atol=1e-5)


@pytest.mark.parametrize("name", sorted(GRIDS))
def test_plain_version_is_the_jax_extractor(name):
    """The JAX package's numpy extractor numbers the vertices by lattice
    edge; the port's in the native core's order. Put in the same order,
    the vertices and the triangles are the same."""
    make, iso, bounds = GRIDS[name]
    grid = make()
    b = np.asarray(bounds if bounds is not None else (0, 0, 0, 1, 1, 1), np.float32)
    vr, tr, keys = tm._extract_mesh_keyed(grid, iso, bounds)
    jv, jt = jm._extract_mesh_numpy(grid, iso, b)
    order = np.argsort(keys)
    rank = np.empty_like(order)
    rank[order] = np.arange(len(order))
    span = float(np.max(b[3:] - b[:3]))
    np.testing.assert_allclose(vr[order], jv, rtol=0, atol=1e-6 * span)
    mine = rank[tr]
    np.testing.assert_array_equal(mine[np.lexsort(mine.T[::-1])], jt[np.lexsort(jt.T[::-1])])


def test_sphere_surface():
    verts, tris = tm.extract_mesh(_sphere_grid(), iso=0.0)
    assert len(verts) > 1000 and len(tris) > 1000
    np.testing.assert_allclose(np.linalg.norm(verts - 0.5, axis=1), 0.3, atol=0.03)
    assert tris.min() >= 0 and tris.max() < len(verts)
    np.testing.assert_allclose(_area(verts, tris), 4 * np.pi * 0.3**2, rtol=0.05)


def test_bounds_mapping():
    verts, _ = tm.extract_mesh(_sphere_grid(16), iso=0.0, bounds=(-2, -2, -2, 2, 2, 2))
    np.testing.assert_allclose(np.linalg.norm(verts, axis=1), 0.3 * 4, atol=0.2)


def test_asymmetric_blob_mesh_position():
    verts, _ = tm.extract_mesh(_blob_grid(), iso=0.0, bounds=(-1, -1, -1, 1, 1, 1))
    assert len(verts) > 100
    np.testing.assert_allclose(verts.mean(0), [0.6, 0.0, -0.2], atol=0.02)


@pytest.mark.parametrize("extract", ["native", "plain"])
def test_welded_indexed_mesh_no_duplicates(extract):
    fn = tm.extract_mesh if extract == "native" else tm.extract_mesh_ref
    verts, tris = fn(_blob_grid(), iso=0.0, bounds=(-1, -1, -1, 1, 1, 1))
    assert len(np.unique(verts.round(5), axis=0)) == len(verts)
    assert 0.45 < len(verts) / len(tris) < 0.55
    e = np.sort(np.concatenate([tris[:, [0, 1]], tris[:, [1, 2]], tris[:, [2, 0]]]), axis=1)
    _, counts = np.unique(e, axis=0, return_counts=True)
    assert (counts == 2).all()


def test_empty_and_refused_grids():
    flat = np.zeros((4, 4, 4), np.float32)
    for fn in (tm.extract_mesh, tm.extract_mesh_ref):
        v, t = fn(flat, iso=1.0)
        assert v.shape == (0, 3) and t.shape == (0, 3)
    with pytest.raises(ValueError, match="three axes"):
        tm.extract_mesh(np.zeros((1, 4, 4), np.float32))
    # a torch grid is taken as it is
    v, _ = tm.extract_mesh(torch.tensor(_sphere_grid(12)), iso=0.0)
    assert len(v) > 10


def test_ply_round_trip_and_jax_reader(tmp_path):
    verts, tris = tm.extract_mesh(_sphere_grid(16), iso=0.0)
    p = str(tmp_path / "m.ply")
    tm.save_ply(p, verts, tris)
    for load in (tm.load_ply, jm.load_ply):
        v2, t2 = load(p)
        np.testing.assert_array_equal(v2, verts)
        np.testing.assert_array_equal(t2, tris)
    # the JAX package's writer gives the same bytes
    q = str(tmp_path / "j.ply")
    jm.save_ply(q, verts, tris)
    assert open(p, "rb").read() == open(q, "rb").read()
    with open(tmp_path / "bad.ply", "wb") as f:
        f.write(b"ply\nformat binary_little_endian 1.0\n")
    with pytest.raises(ValueError, match="end_header"):
        tm.load_ply(str(tmp_path / "bad.ply"))


def _engine(bound=1.0, encoder="cp"):
    from nerf_kinematics_tpu_torch.models.ngp import NGPConfig
    from nerf_kinematics_tpu_torch.ops.cp_grid import CPGridConfig
    from nerf_kinematics_tpu_torch.ops.hashgrid import HashGridConfig
    from nerf_kinematics_tpu_torch.train.config import Config
    from nerf_kinematics_tpu_torch.train.ngp_engine import NGPEngine

    cfg = Config(engine="ngp", ngp=NGPConfig(
        encoder=encoder,
        cp=CPGridConfig(n_levels=2, n_components=4, base_resolution=8, max_resolution=16,
                        table_size=16, use_bf16=False),
        grid=HashGridConfig(n_levels=2, n_features=2, log2_table_size=10,
                            base_resolution=4, max_resolution=16),
        density_width=16, density_layers=2, color_width=16, color_layers=2))
    return NGPEngine(cfg, scene_bound=bound, device="cpu",
                     generator=torch.Generator().manual_seed(0))


@pytest.mark.parametrize("bound,encoder", [(1.0, "cp"), (8.0, "cp"), (8.0, "hash")])
def test_engine_to_mesh(tmp_path, bound, encoder):
    """The density grid over the scene box (contracted at bound 8) through
    the core, written as a PLY; the state's parameters bound for it."""
    engine = _engine(bound, encoder)
    state = engine.init_state(0)
    grid = engine.density_grid(resolution=16).numpy()
    iso = float(np.median(grid))
    path = str(tmp_path / "scene.ply")
    verts, tris = tm.extract_mesh_from_engine(engine, state.params, resolution=16,
                                              iso=iso, path=path)
    assert len(verts) > 10 and os.path.getsize(path) > 100
    assert np.abs(verts).max() <= bound + 1e-6
    v2, t2 = tm.load_ply(path)
    np.testing.assert_array_equal(v2, verts)
    want = tm.extract_mesh(grid, iso=iso, bounds=(-bound,) * 3 + (bound,) * 3)
    np.testing.assert_array_equal(tris, want[1])
    # other parameters bound: another grid, another mesh
    other = state.params.clone().mul_(1.5)
    v3, _ = tm.extract_mesh_from_engine(engine, other, resolution=16, iso=iso)
    assert v3.shape != verts.shape or not np.array_equal(v3, verts)


def test_density_grid_axis_order(monkeypatch):
    """grid[ix, iy, iz] = sigma(x, y, z): a density that varies along world
    x only varies along axis 0, the layout both extractors take."""
    from nerf_kinematics_tpu_torch.models.ngp import NGPModel

    engine = _engine()
    monkeypatch.setattr(NGPModel, "density", lambda self, xyz: (xyz[..., 0], None))
    grid = engine.density_grid(resolution=8).numpy()
    lin01 = np.linspace(0.0, 1.0, 8)
    np.testing.assert_allclose(grid, lin01[:, None, None] * np.ones((8, 8, 8)), atol=1e-6)
