"""Host-side pieces of the tensor-core (bf16 mode) kernels, on the CPU: the
packed weights and the fragment addressing the kernels use on them, the
bf16 copy of the line tables, the gradient kernels' scratch layout, and the
dispatch between the tensor-core body (bf16 mode) and the FMA body (f32
mode). The kernels themselves run only on the card (``chip_smoke.py``)."""

import dataclasses
import pathlib
import re

import numpy as np
import pytest
import torch

from nerf_kinematics_tpu_torch.ops import ngp_fused_cuda as nf
from nerf_kinematics_tpu_torch.ops.cp_grid import CPGridConfig

ROOT = pathlib.Path(__file__).resolve().parents[1]
CSRC = ROOT / "nerf_kinematics_tpu_torch" / "csrc"

# (density layers, color layers) as (in, out): the flagship's, and smaller
# ones with widths that need padding (a last layer of 3, inputs of 63).
SHAPES = {
    "machina": ([(256, 64), (64, 64), (64, 16)],
               [(32, 64), (64, 64), (64, 64), (64, 3)]),
    "small": ([(32, 16), (16, 16)], [(32, 16), (16, 3)]),
    "odd": ([(63, 48), (48, 20)], [(36, 5)]),
}


def _weights(name, seed=0):
    rng = np.random.default_rng(seed)
    dens, col = SHAPES[name]
    return [torch.from_numpy(rng.normal(size=s).astype(np.float32))
            for s in dens + col], len(dens)


def _unpack(buf, lay, shape, i):
    """Layer ``i``'s (in, out) weights read back from a packed buffer."""
    k, j = shape
    return nf._block(buf, lay.f_off[i], nf._ceil(j, 8), lay.f_ld[i])[:j, :k].T


def _words(buf):
    """The packed bf16 buffer as the kernels read it: 32-bit words, the
    lower-index element in the low half."""
    half = buf.view(torch.int16).numpy().view(np.uint16).astype(np.uint32)
    return half[0::2] | (half[1::2] << 16)


def _bf16_of(bits):
    return torch.from_numpy(
        (np.asarray(bits, dtype=np.uint32) << 16).view(np.float32).copy())


def _b_from_fragments(buf, off, ld, K, N):
    """B (K x N) of mma.m16n8k16 as the lanes load it from a packed block
    (``off``, ``ld`` in bf16 elements): lane (g, t) of n-tile nt and k-tile
    kt takes words ``(nt*8 + g) * ld/2 + kt*8 + t`` (k = 2t, 2t+1) and
    ``+ 4`` (k = 2t+8, 2t+9) for column n = nt*8 + g."""
    w = _words(buf)
    out = np.zeros((K, N), dtype=np.uint32)
    ldw, base = ld // 2, off // 2
    for nt in range((N + 7) // 8):
        for kt in range((K + 15) // 16):
            for g in range(8):
                for t in range(4):
                    n = nt * 8 + g
                    for half, kk in ((0, 2 * t), (4, 2 * t + 8)):
                        word = w[base + n * ldw + kt * 8 + t + half]
                        for e, val in enumerate((word & 0xFFFF, word >> 16)):
                            k = kt * 16 + kk + e
                            if k < K and n < N:
                                out[k, n] = val
    return _bf16_of(out)


def _bt_from_fragments(buf, off, ld, J, K):
    """B' = W^T (J x K: k' the J outputs, n' the K inputs) of mma.m16n8k16
    as ``ldmatrix.x2.trans`` gives it from a packed block (a row per output
    j, the inputs contiguous): lane l addresses row ``kt*16 + (l & 15)`` at
    column ``nt*8``; lane (g, t) gets rows 2t, 2t+1 of column g of matrix 0
    (b0, k' = 2t..2t+1) and of matrix 1 (b1, k' = 2t+8..2t+9). A block of at
    most 8 rows (J <= 8) has no second matrix: the kernel zeroes b1."""
    h = buf.view(torch.int16).numpy().view(np.uint16)
    out = np.zeros((J, K), dtype=np.uint32)
    for nt in range((K + 7) // 8):
        for kt in range((J + 15) // 16):
            rows = [off + (kt * 16 + (l & 15)) * ld + nt * 8 for l in range(16)]
            for g in range(8):
                for t in range(4):
                    for m in ((0, 1) if J - kt * 16 > 8 else (0,)):
                        for e in range(2):
                            jj, kk = kt * 16 + m * 8 + 2 * t + e, nt * 8 + g
                            if jj < J and kk < K:
                                out[jj, kk] = h[rows[8 * m + 2 * t + e] + g]
    return _bf16_of(out)


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_packed_weights_round_trip(name):
    Ws, nd = _weights(name)
    buf, lay = nf.mma_pack(Ws, nd)
    assert buf.dtype == torch.bfloat16 and buf.numel() == lay.total
    for i, w in enumerate(Ws):
        want = w.to(torch.bfloat16)
        assert torch.equal(_unpack(buf, lay, w.shape, i), want)
    # everything outside the weights is zero padding
    mask = torch.zeros(lay.total, dtype=torch.bool)
    for i, (k, j) in enumerate(tuple(w.shape) for w in Ws):
        nf._block(mask, lay.f_off[i], nf._ceil(j, 8), lay.f_ld[i])[:j, :k] = True
    assert (buf[~mask] == 0).all()


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_fragment_addressing_reads_the_weights(name):
    """The forward products take B = W (k: the layer's inputs), the
    gradient's d_inp = g W^T takes B = W^T (k: the outputs) from the same
    packed block, read transposed."""
    Ws, nd = _weights(name, seed=1)
    buf, lay = nf.mma_pack(Ws, nd)
    for i, w in enumerate(Ws):
        k, j = w.shape
        want = w.to(torch.bfloat16).to(torch.float32)
        assert torch.equal(_b_from_fragments(buf, lay.f_off[i], lay.f_ld[i], k, j), want)
        assert torch.equal(_bt_from_fragments(buf, lay.f_off[i], lay.f_ld[i], j, k), want.T)


@pytest.mark.parametrize("name", sorted(SHAPES))
@pytest.mark.parametrize("color", [False, True])
def test_packed_layout_rows_and_order(name, color):
    """The density layers alone (row 2's kernel) or with the color layers."""
    Ws, nd = _weights(name)
    Ws = Ws if color else Ws[:nd]
    lay = nf.mma_layout([tuple(w.shape) for w in Ws], nd)
    # 4 (mod 8) words a row: the eight rows of a fragment load hit distinct
    # banks; offsets on 16 bytes: the kernels stage the buffer in uint4
    assert all(ld % 16 == 8 for ld in lay.f_ld)
    assert all(o % 8 == 0 for o in lay.f_off) and lay.total % 8 == 0
    assert lay.f_off[0] == 0 and list(lay.f_off) == sorted(lay.f_off)
    assert len(lay.f_off) == len(Ws)
    assert lay.dens == (lay.f_off[nd] if color else lay.total)


def _cfg(use_bf16, n_components=16):
    return CPGridConfig(n_levels=2, n_components=n_components, base_resolution=8,
                        max_resolution=16, table_size=16, use_bf16=use_bf16)


def _params(nc=16, seed=2):
    rng = np.random.default_rng(seed)
    f = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))
    dens, col = [(2 * nc, 16), (16, 16)], [(32, 16), (16, 3)]
    return {"lines": f(2, 3, 16, nc), "dW": [f(*s) for s in dens],
            "db": [f(s[1], 1) for s in dens], "cW": [f(*s) for s in col],
            "cb": [f(s[1], 1) for s in col]}


@pytest.mark.parametrize("mode", ["f32", "bf16"])
@pytest.mark.parametrize("color", [False, True])
def test_mode_picks_the_body(mode, color):
    """f32 mode hands the kernels nothing packed (the FMA body reads the f32
    parameters); bf16 mode hands them the exact bf16 line tables and the
    packed weights of the layers the kernel runs."""
    params = _params()
    got = nf.mma_operands(params, _cfg(mode == "bf16"), color)
    if mode == "f32":
        assert got is None
        return
    lines16, wpk, lay = got
    assert lines16.dtype == torch.bfloat16
    assert torch.equal(lines16, params["lines"].to(torch.bfloat16))
    Ws = params["dW"] + (params["cW"] if color else [])
    assert len(lay.f_off) == len(Ws)
    for i, w in enumerate(Ws):
        assert torch.equal(_unpack(wpk, lay, w.shape, i), w.to(torch.bfloat16))


def test_body_dispatch_in_the_sources():
    """The CUDA side picks the body by the mode: bf16 mode the tensor-core
    kernels, f32 mode the FMA kernels; the f32 weight-gradient path is the
    one the classic engine calls."""
    fwd = (CSRC / "ngp_fused.cu").read_text()
    entry = fwd[fwd.index('extern "C" int nkt_fused_forward('):]
    assert re.search(r"if \(args->cp\.use_bf16\)\s+return mma_forward\(", entry)
    f32 = entry[entry.index("mma_forward("):]
    assert "nkt_fused_apply_kernel<<<" in f32 and "nkt_fused_sigma_kernel<<<" in f32
    for k, body in (("nkt_fused_sigma_kernel", "nkt_fused_body<false, false>"),
                    ("nkt_fused_apply_kernel", "nkt_fused_body<true, false>")):
        assert re.search(k + r"\([^)]*\) \{\s+const SaveRows none = SaveRows\(\);\s+"
                         + re.escape(body), fwd), k
    assert re.search(r"nkt_mma_sigma_kernel\([^)]*\) \{\s+nkt_mma_body\(a, lay\)", fwd)
    # bf16 mode with color: row 3's tile kernel (ngp_apply.cu), on the
    # tensor cores, its re-sums of layer 0 from the wrapper's slots
    bf = fwd[fwd.index("static int mma_forward("):fwd.index('extern "C" int nkt_fused_forward(')]
    assert re.search(r"if \(color\) return nkt_apply_forward\(a, n_sm, st\);", bf)
    assert "nkt_mma_sigma_kernel<<<" in bf and "nkt_mma_apply_kernel" not in fwd
    app = (CSRC / "ngp_apply.cu").read_text()
    launch = app[app.index("int nkt_apply_forward("):]
    assert "nkt_apply_tile_kernel<<<" in launch and "nkt_mma_add(" in app
    assert "!a.enc" in launch
    bwd = (CSRC / "ngp_fused_bwd.cu").read_text()
    run = bwd[bwd.index("static int run_backward(const BwdArgs& b"):]
    # bf16 mode: the tile kernel, and nothing of f32 mode's sequence
    assert re.search(r"if \(a\.cp\.use_bf16\) return run_backward_tile\(", run)
    tile = bwd[bwd.index("static int run_backward_tile("):bwd.index("static int run_backward(")]
    assert "launch_tile_for(" in tile and "apply_save" not in tile and "wgrad" not in tile
    launch = bwd[bwd.index('extern "C" int nkt_wgrad_launch('):]
    launch = launch[:launch.index("\n}\n")]
    assert launch.index("if (bf) {") < launch.index("nkt_wgrad_kernel<true><<<")
    assert launch.index("nkt_wgrad_mma_kernel<<<") < launch.index("nkt_wgrad_kernel<true><<<")
    mma = (CSRC / "nkt_mma.cuh").read_text()
    assert "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32" in mma


@pytest.mark.parametrize("case,ok", [
    ("machina", True), ("n_components 24", False), ("hidden 40", False),
    ("wide color input", False), ("color out 9", False), ("sigma only, out 20", True),
])
def test_widths_the_tensor_cores_take(case, ok):
    dens = [(256, 64), (64, 64), (64, 16)]
    col = [(32, 64), (64, 64), (64, 64), (64, 3)]
    nc, color = 64, True
    if case == "n_components 24":
        nc = 24
    elif case == "hidden 40":
        dens = [(256, 40), (40, 64), (64, 16)]
    elif case == "wide color input":
        dens, col = [(256, 64), (64, 64)], [(80, 64), (64, 3)]
    elif case == "color out 9":
        col = [(32, 64), (64, 9)]
    elif case == "sigma only, out 20":
        dens, col, color = [(256, 64), (64, 20)], [], False
    assert nf.mma_dims_ok(dens + col, len(dens), nc, color) == ok
    if not ok and case != "wide color input":
        params = _params()
        params["dW"] = [torch.zeros(s) for s in dens]
        params["cW"] = [torch.zeros(s) for s in col]
        with pytest.raises(ValueError, match="tensor-core"):
            nf.mma_operands(params, dataclasses.replace(_cfg(True), n_components=nc),
                            color)


@pytest.mark.parametrize("mode", ["f32", "bf16"])
@pytest.mark.parametrize("n", [1, 999, 1024, 393216])
def test_gradient_scratch_layout(mode, n):
    """``grad_scratch`` (host) and ``nkt_fused_bwd_sizes`` (device side) agree
    on the scratch: f32 mode saves every layer's input (``act``) and masked
    cotangent (``gs``) in f32, rows ``ld`` = n points apart; bf16 mode keeps
    them on chip in the tile kernel and allocates no act, gs or z0. The
    wrapper checks the two against each other at every call on the card."""
    params = _params()
    s = nf.grad_scratch(params, _cfg(mode == "bf16"), n)
    shapes = [tuple(w.shape) for w in params["dW"] + params["cW"]]
    assert s.total == sum(int(np.prod(sh)) for _, _, sh in nf._grad_layout(params))
    if mode == "bf16":
        assert (s.act_rows, s.gs_rows, s.ld) == (0, 0, 0) and s.act_dtype == torch.bfloat16
    else:
        assert s.act_rows == sum(k for k, _ in shapes)
        assert s.gs_rows == sum(j for _, j in shapes)
        assert s.act_dtype == torch.float32 and s.ld == n
    text = (CSRC / "ngp_fused_bwd.cu").read_text()
    sizes = text[text.index('extern "C" void nkt_fused_bwd_sizes('):]
    sizes = sizes[:sizes.index("\n}\n")]
    assert "out[0] = out[1] = 0;" in sizes and "out[4] = 0;" in sizes
    assert "out[5] = 2;" in sizes and "out[4] = args->n;" in sizes and "out[5] = 4;" in sizes
    # the saved feature 0 left act for its own f32 array
    assert "z0_row" not in (CSRC / "ngp_fused.cuh").read_text()


def _defines(text):
    return {m.group(1): int(m.group(2))
            for m in re.finditer(r"#define (\w+) (\d+)", text)}


def test_apply_layout_mirrors_the_source():
    """Row 3's kernel and its host mirror (``apply_layout``) share their
    constants; at the shipped widths 16 warps of 16 points fit a block
    (PERF.md). ``chip_smoke.py`` holds the mirror to the library's own
    numbers on the card."""
    d = _defines((CSRC / "ngp_apply.cu").read_text())
    m = _defines((CSRC / "nkt_mma.cuh").read_text())
    assert d["NKT_APPLY_WARPS"] == nf.APPLY_WARPS
    assert m["NKT_LIST_CAP"] * 2 == nf._LIST_BYTES and m["NKT_MT"] == nf._TILE
    dens, col = SHAPES["machina"]
    lay = nf.apply_layout(dens + col, len(dens), 4, 64)
    assert (lay.warps, lay.lde, lay.tile_bytes, lay.total) == (16, 36, 4736, 147584)
    fox = [(480, 64)] + dens[1:]
    lay = nf.apply_layout(fox + col, len(dens), 5, 96)
    assert (lay.warps, lay.lde, lay.total) == (16, 52, 201856)


def _cp_bf16_configs():
    out = []
    for path in sorted((ROOT / "configs").glob("*.yml")):
        text = path.read_text()
        if re.search(r"^engine: ngp", text, re.M) and "encoder: cp" in text \
                and "compute_dtype: bfloat16" in text:
            out.append(path.name)
    return out


@pytest.mark.parametrize("name", _cp_bf16_configs())
def test_shipped_cp_configs_fit_row_3(name):
    """Every shipped config with the CP encoder in bf16 fits row 3's kernel:
    its layers in the widths the tensor cores take, its layout in the
    232 448 B of shared memory a block may use at 16 warps."""
    from nerf_kinematics_tpu_torch.train import config as tcfg
    from nerf_kinematics_tpu_torch.train.ngp_engine import NGPEngine

    cfg = tcfg.load_config(ROOT / "configs" / name)
    eng = NGPEngine(cfg, 1.0, device="cpu")
    params, cp = eng._fused_params(detach=True), eng.ngp_config.cp
    assert cp.use_bf16
    shapes = [tuple(w.shape) for w in params["dW"] + params["cW"]]
    assert nf.mma_dims_ok(shapes, len(params["dW"]), cp.n_components, True)
    lay = nf.apply_layout_of(params, cp)
    assert lay.total <= 232448 and lay.warps == nf.APPLY_WARPS
