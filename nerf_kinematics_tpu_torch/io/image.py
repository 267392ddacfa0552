"""Image I/O without Pillow: an 8-bit PNG codec on ``zlib`` and Pillow's
LANCZOS downscale in numpy.

The machine the port trains on need not have Pillow, so the loaders and the
scene generator read and write PNGs here:

  * :func:`write_png` / :func:`read_png`: 8-bit, non-interlaced PNG of gray,
    gray + alpha, RGB, RGBA (and palette of 1 to 8 bits, read only). The
    writer filters no row; the reader undoes all five row filters, since
    Pillow's writer picks a filter per row.
  * :func:`resize_lanczos`: Pillow's ``Image.resize(size, LANCZOS)`` of an
    8-bit image (``half_res`` and ``downsample_factor`` of the loaders):
    the same separable filter (a = 3), the same fixed-point coefficients
    (22 fraction bits), horizontal pass first, rounding to 8 bits between
    the passes.
  * :func:`save_image` / :func:`load_image`: float or uint8 images, by file
    extension; JPEG goes through Pillow, imported when needed.
  * :func:`write_video`: an mp4 through ffmpeg when it is on ``PATH`` (its
    frames written by :func:`encode_png`), otherwise an animated GIF from
    :func:`encode_gif`.

Replaces ``nerf_kinematics_tpu/io/image.py::save_image`` / ``load_image`` /
``write_video`` and the Pillow calls of the reference's loaders and scene
writer.
"""

from __future__ import annotations

import math
import os
import shutil
import struct
import subprocess
import tempfile
import zlib
from typing import Sequence

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# PNG color type -> channels (8-bit samples)
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_COLOR_TYPE = {1: 0, 2: 4, 3: 2, 4: 6}


def _chunk(tag: bytes, data: bytes) -> bytes:
    crc = zlib.crc32(tag + data) & 0xFFFFFFFF
    return struct.pack(">I", len(data)) + tag + data + struct.pack(">I", crc)


def encode_png(img: np.ndarray) -> bytes:
    """(H, W) or (H, W, C) uint8, C in 1..4 (gray, gray + alpha, RGB, RGBA)
    -> PNG bytes. Every row is stored with filter 0, deflated at zlib's
    level 6 (Pillow's default)."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"encode_png takes uint8, got {img.dtype}")
    if img.ndim == 2:
        img = img[:, :, None]
    if img.ndim != 3 or img.shape[2] not in _COLOR_TYPE:
        raise ValueError(f"encode_png takes (H, W[, 1..4]), got {img.shape}")
    H, W, C = img.shape
    raw = np.zeros((H, 1 + W * C), np.uint8)
    raw[:, 1:] = img.reshape(H, W * C)
    ihdr = struct.pack(">IIBBBBB", W, H, 8, _COLOR_TYPE[C], 0, 0, 0)
    return (_SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + _chunk(b"IEND", b""))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter(raw: np.ndarray, H: int, W: int, C: int) -> np.ndarray:
    """(H, 1 + W*C) filtered scanlines -> (H, W, C) uint8. Filters 0-2 (none,
    sub, up) are undone row by row; with any average (3) or Paeth (4) row the
    image is reconstructed along anti-diagonals: pixel (y, x) depends on its
    left, upper and upper-left neighbours only, which lie on earlier ones."""
    ftype = raw[:, 0].astype(np.int64)
    if ftype.max(initial=0) > 4:
        raise ValueError("unknown PNG row filter")
    filt = raw[:, 1:].reshape(H, W, C)
    if np.all(ftype <= 2):
        out = np.empty((H, W, C), np.uint8)
        prev = np.zeros((W, C), np.uint8)
        for y in range(H):
            line = filt[y]
            if ftype[y] == 1:
                line = np.cumsum(line, axis=0, dtype=np.uint8)
            elif ftype[y] == 2:
                line = line + prev
            out[y] = prev = line
        return out
    f = filt.astype(np.int64)
    pad = np.zeros((H + 1, W + 1, C), np.int64)  # row 0 and column 0 are zero
    for k in range(H + W - 1):
        ys = np.arange(max(0, k - W + 1), min(H - 1, k) + 1)
        xs = k - ys
        a, b, c = pad[ys + 1, xs], pad[ys, xs + 1], pad[ys, xs]
        t = ftype[ys][:, None]
        pred = np.select([t == 0, t == 1, t == 2, t == 3],
                         [np.zeros_like(a), a, b, (a + b) >> 1], _paeth(a, b, c))
        pad[ys + 1, xs + 1] = (f[ys, xs] + pred) & 255
    return pad[1:, 1:].astype(np.uint8)


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> (H, W, C) uint8 with C the file's channels (palette
    images come back RGB, or RGBA with a transparency chunk). Takes 8-bit,
    non-interlaced files."""
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG file")
    pos, idat, plte, trns, hdr = 8, [], None, None, None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if tag == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"PLTE":
            plte = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif tag == b"tRNS":
            trns = np.frombuffer(body, np.uint8)
        elif tag == b"IEND":
            break
    if hdr is None:
        raise ValueError("PNG without a header")
    W, H, depth, ctype, _, _, interlace = hdr
    packed = ctype == 3 and depth in (1, 2, 4)  # palette indices below 8 bits
    if (depth != 8 and not packed) or interlace != 0 or ctype not in _CHANNELS:
        raise ValueError(f"PNG of bit depth {depth}, color type {ctype}, "
                         f"interlace {interlace}: only 8-bit non-interlaced files "
                         "(and palettes of 1, 2 or 4 bits)")
    C = _CHANNELS[ctype]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if packed:
        # rows of ceil(W * depth / 8) bytes, filtered byte by byte; the
        # samples are packed from the high bits down
        nb = -(-W * depth // 8)
        rows = _unfilter(raw.reshape(H, 1 + nb), H, nb, 1)[..., 0]
        shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
        img = ((rows[:, :, None] >> shifts) & ((1 << depth) - 1)).reshape(H, -1)
        img = img[:, :W, None]
    else:
        img = _unfilter(raw.reshape(H, 1 + W * C), H, W, C)
    if ctype == 3:
        idx = img[..., 0]
        if plte is None:
            raise ValueError("palette PNG without a palette")
        rgb = plte[idx]
        if trns is None:
            return rgb
        alpha = np.full(len(plte), 255, np.uint8)
        alpha[: len(trns)] = trns
        return np.concatenate([rgb, alpha[idx][..., None]], axis=-1)
    return img


def write_png(path: str, img: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(img))


def read_png(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_png(f.read())


def _pillow():
    """Pillow's ``Image``, for the formats this module does not decode."""
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(
            "reading or writing anything but PNG needs Pillow, which is not "
            "installed; convert the images to PNG") from e
    return Image


def _is_png(path: str) -> bool:
    return os.path.splitext(path)[1].lower() == ".png"


def read_image_u8(path: str) -> np.ndarray:
    """(H, W, C) uint8 as stored: PNGs through :func:`read_png`, anything
    else through Pillow."""
    if _is_png(path):
        return read_png(path)
    with _pillow().open(path) as im:
        arr = np.asarray(im)
    return arr[:, :, None] if arr.ndim == 2 else arr


def image_size(path: str) -> tuple:
    """(width, height) of an image file: a PNG's from its IHDR chunk,
    anything else's through Pillow."""
    if _is_png(path):
        with open(path, "rb") as f:
            head = f.read(24)
        if head[:8] != _SIGNATURE or head[12:16] != b"IHDR":
            raise ValueError(f"{path}: not a PNG")
        w, h = struct.unpack(">II", head[16:24])
        return int(w), int(h)
    with _pillow().open(path) as im:
        return im.size


def to_rgb(img: np.ndarray) -> np.ndarray:
    """Gray / gray + alpha / RGB / RGBA uint8 -> RGB (alpha dropped), as
    Pillow's ``convert("RGB")``."""
    if img.ndim == 2:
        img = img[:, :, None]
    if img.shape[2] in (1, 2):
        return np.repeat(img[:, :, :1], 3, axis=2)
    return img[:, :, :3]


def load_image(path: str) -> np.ndarray:
    """(H, W, 3) float32 in [0, 1]."""
    return to_rgb(read_image_u8(path)).astype(np.float32) / 255.0


def save_image(path: str, img: np.ndarray) -> None:
    """Save a float [0, 1] or uint8 (H, W, 3) image (RGBA and gray too)."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        img = np.clip(img * 255.0, 0, 255).astype(np.uint8)
    if _is_png(path):
        write_png(path, img)
    else:
        _pillow().fromarray(img).save(path)


# ---------------------------------------------------------------- video

_GIF_LEVELS = 6  # the palette: a 6 x 6 x 6 cube of RGB, 51 apart per channel
_GIF_STEP = 255 // (_GIF_LEVELS - 1)
# Literals between clear codes: after a clear and k literals the decoder's
# next table entry is 258 + k - 1, so the codes stay 9 bits wide while it is
# below 512.
_GIF_RUN = 254


def _gif_palette() -> bytes:
    levels = np.arange(_GIF_LEVELS) * _GIF_STEP
    cube = np.stack(np.meshgrid(levels, levels, levels, indexing="ij"), -1)
    table = np.zeros((256, 3), np.uint8)
    table[: _GIF_LEVELS ** 3] = cube.reshape(-1, 3)
    return table.tobytes()


def _gif_indices(img: np.ndarray) -> np.ndarray:
    """(H, W, 3) uint8 -> (H * W,) palette indices, each channel to the
    nearest level of the cube."""
    q = np.rint(img.astype(np.float32) / _GIF_STEP).astype(np.int64)
    return (q[..., 0] * _GIF_LEVELS * _GIF_LEVELS + q[..., 1] * _GIF_LEVELS
            + q[..., 2]).reshape(-1)


def _gif_lzw(indices: np.ndarray) -> bytes:
    """An LZW code stream (minimum code size 8) of literal codes only: a
    clear code before every ``_GIF_RUN`` literals keeps every code 9 bits
    wide, so no dictionary is built and the stream packs in numpy. Returns
    the image data as GIF sub-blocks of at most 255 bytes, terminated."""
    clear, end = 256, 257
    n = len(indices)
    runs = -(-n // _GIF_RUN)
    codes = np.empty(n + runs + 1, np.int64)
    at = np.arange(runs) * (_GIF_RUN + 1)
    codes[at] = clear
    mask = np.ones(len(codes), bool)
    mask[at] = False
    mask[-1] = False
    codes[mask] = indices
    codes[-1] = end
    bits = ((codes[:, None] >> np.arange(9)) & 1).astype(np.uint8).reshape(-1)
    data = np.packbits(bits, bitorder="little").tobytes()
    blocks = b"".join(bytes([len(data[i : i + 255])]) + data[i : i + 255]
                      for i in range(0, len(data), 255))
    return bytes([8]) + blocks + b"\x00"


def encode_gif(frames: Sequence[np.ndarray], fps: float = 24) -> bytes:
    """(H, W, 3) uint8 frames -> an animated GIF89a that loops: each frame
    in the global 6 x 6 x 6 palette (an error of at most half a step, 25.5,
    per channel), shown for 100 / fps hundredths of a second."""
    frames = [np.asarray(f) for f in frames]
    if not frames:
        raise ValueError("encode_gif needs at least one frame")
    H, W = frames[0].shape[:2]
    out = [b"GIF89a", struct.pack("<HHBBB", W, H, 0xF7, 0, 0), _gif_palette(),
           b"\x21\xff\x0bNETSCAPE2.0\x03\x01\x00\x00\x00"]
    delay = max(int(round(100.0 / fps)), 1)
    for f in frames:
        if f.shape[:2] != (H, W) or f.dtype != np.uint8 or f.shape[2:] != (3,):
            raise ValueError(f"encode_gif takes (H, W, 3) uint8 frames of one size, "
                             f"got {f.shape} {f.dtype}")
        out.append(b"\x21\xf9\x04\x00" + struct.pack("<H", delay) + b"\x00\x00")
        out.append(b"\x2c" + struct.pack("<HHHHB", 0, 0, W, H, 0))
        out.append(_gif_lzw(_gif_indices(f)))
    out.append(b"\x3b")
    return b"".join(out)


def write_video(path: str, frames: Sequence[np.ndarray], fps: int = 30) -> str:
    """Write frames (float in [0, 1] or uint8, (H, W, 3)) to an mp4 through
    ffmpeg when it is on ``PATH`` and ``path`` ends in ``.mp4``, else to an
    animated GIF beside it (``.gif``). Returns the path written."""
    frames8 = [np.clip(np.asarray(f) * 255, 0, 255).astype(np.uint8)
               if np.asarray(f).dtype != np.uint8 else np.asarray(f) for f in frames]
    if shutil.which("ffmpeg") and path.endswith(".mp4"):
        with tempfile.TemporaryDirectory() as td:
            for i, f in enumerate(frames8):
                write_png(os.path.join(td, f"f_{i:05d}.png"), f)
            subprocess.run(
                ["ffmpeg", "-y", "-loglevel", "error", "-framerate", str(fps),
                 "-i", os.path.join(td, "f_%05d.png"), "-pix_fmt", "yuv420p", path],
                check=True)
        return path
    gif = path if path.endswith(".gif") else os.path.splitext(path)[0] + ".gif"
    with open(gif, "wb") as f:
        f.write(encode_gif(frames8, fps))
    return gif


# ---------------------------------------------------------------- LANCZOS

_PRECISION_BITS = 32 - 8 - 2


def _sinc(x: float) -> float:
    if x == 0.0:
        return 1.0
    x = x * math.pi
    return math.sin(x) / x


def _lanczos(x: float) -> float:
    return _sinc(x) * _sinc(x / 3.0) if -3.0 <= x < 3.0 else 0.0


def _lanczos_matrix(in_size: int, out_size: int) -> np.ndarray:
    """(out, in) int64 fixed-point weights of one pass: Pillow's
    ``precompute_coeffs`` (support 3 x scale, taps at (x + 0.5 - center) /
    scale, normalised to sum 1) and ``normalize_coeffs_8bpc`` (rounded half
    away from zero to 22 fraction bits)."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 3.0 * filterscale
    ss = 1.0 / filterscale
    m = np.zeros((out_size, in_size), np.int64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        w = [_lanczos((x + xmin - center + 0.5) * ss) for x in range(xmax)]
        ww = 0.0
        for v in w:
            ww += v
        for x, v in enumerate(w):
            k = v / ww if ww != 0.0 else v
            k *= 1 << _PRECISION_BITS
            m[xx, xmin + x] = int(k - 0.5) if k < 0 else int(k + 0.5)
    return m


def _pass(img: np.ndarray, m: np.ndarray, axis: int) -> np.ndarray:
    # In float64 every product and partial sum is an integer below 2^53
    # (255 x 2^23 a tap, under 2^16 taps), so a BLAS product gives the
    # integer sum exactly, in any order, and several times faster than an
    # int64 tensordot.
    x = np.ascontiguousarray(np.moveaxis(img, axis, -1), dtype=np.float64)
    acc = x @ np.ascontiguousarray(m.T, dtype=np.float64)
    acc = np.moveaxis(acc, -1, axis).astype(np.int64) + (1 << (_PRECISION_BITS - 1))
    return np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)


def resize_lanczos(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """(H, W[, C]) uint8 -> (height, width[, C]) uint8 as Pillow's
    ``Image.fromarray(img).resize((width, height), Image.LANCZOS)`` for
    gray and RGB images (channels are filtered independently)."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"resize_lanczos takes uint8, got {img.dtype}")
    out = img
    if width != img.shape[1]:
        out = _pass(out, _lanczos_matrix(img.shape[1], width), 1)
    if height != img.shape[0]:
        out = _pass(out, _lanczos_matrix(img.shape[0], height), 0)
    return out
