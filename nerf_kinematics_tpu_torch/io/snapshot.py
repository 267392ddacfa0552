"""Single-file compressed snapshots, the ``.ingp``-style export and import
of ``--save_snapshot`` / ``--load_snapshot``.

The file is the JAX package's (``nerf_kinematics_tpu/io/snapshot.py``): the
magic ``NKTSNAP1``, the metadata JSON's length (8 bytes, little endian), the
metadata JSON, then the zlib-compressed msgpack of the tree in flax's
encoding (``flax.serialization.msgpack_serialize``). Files go both ways
between the two packages. The msgpack reader and writer are the port's own
and cover what flax emits for such trees: maps with str keys (written in
sorted order, as flax's tree map gives them), ints, floats, str, bytes,
bool, None, lists, and arrays as flax's extension type 1 (the msgpack of
``(shape, dtype name, C-order bytes)``; type 3, a numpy scalar, is read
too), arrays over 1 GiB in flax's chunked form.

Arrays come back as numpy arrays (a ``bfloat16`` one as a torch tensor:
numpy has no such type); torch tensors are written as their numpy arrays.
"""

from __future__ import annotations

import json
import struct
import zlib
from typing import Any, Optional, Tuple

import numpy as np
import torch

MAGIC = b"NKTSNAP1"

_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3
_CHUNKED = "__msgpack_chunked_array__"
_MAX_CHUNK_BYTES = 2**30  # flax's MAX_CHUNK_SIZE


# ------------------------------------------------------------------ writer

def _pack_int(v: int) -> bytes:
    if 0 <= v < 0x80:
        return bytes([v])
    if -32 <= v < 0:
        return struct.pack("b", v)
    if v >= 0:
        for code, fmt, top in ((0xCC, ">B", 0xFF), (0xCD, ">H", 0xFFFF),
                               (0xCE, ">I", 0xFFFFFFFF), (0xCF, ">Q", 2**64 - 1)):
            if v <= top:
                return bytes([code]) + struct.pack(fmt, v)
    else:
        for code, fmt, lo in ((0xD0, ">b", -2**7), (0xD1, ">h", -2**15),
                              (0xD2, ">i", -2**31), (0xD3, ">q", -2**63)):
            if v >= lo:
                return bytes([code]) + struct.pack(fmt, v)
    raise OverflowError(f"msgpack: integer {v} out of range")


def _pack_len(n: int, fix: Optional[int], fix_max: int, codes) -> bytes:
    """Header of a str / bin / array / map of ``n`` entries."""
    if fix is not None and n <= fix_max:
        return bytes([fix | n])
    for code, fmt, top in codes:
        if code is not None and n <= top:
            return bytes([code]) + struct.pack(fmt, n)
    raise OverflowError(f"msgpack: length {n} out of range")


_STR = (0xA0, 31, ((0xD9, ">B", 0xFF), (0xDA, ">H", 0xFFFF), (0xDB, ">I", 2**32 - 1)))
_BIN = (None, 0, ((0xC4, ">B", 0xFF), (0xC5, ">H", 0xFFFF), (0xC6, ">I", 2**32 - 1)))
_ARR = (0x90, 15, ((None, "", 0), (0xDC, ">H", 0xFFFF), (0xDD, ">I", 2**32 - 1)))
_MAP = (0x80, 15, ((None, "", 0), (0xDE, ">H", 0xFFFF), (0xDF, ">I", 2**32 - 1)))


def _pack_ext(code: int, data: bytes) -> bytes:
    n = len(data)
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        head = bytes([fixed[n]])
    elif n <= 0xFF:
        head = bytes([0xC7]) + struct.pack(">B", n)
    elif n <= 0xFFFF:
        head = bytes([0xC8]) + struct.pack(">H", n)
    else:
        head = bytes([0xC9]) + struct.pack(">I", n)
    return head + struct.pack("b", code) + data


def _array_bytes(arr) -> bytes:
    """flax's ``_ndarray_to_bytes``: the msgpack of (shape, dtype name,
    C-order bytes)."""
    if isinstance(arr, torch.Tensor):
        t = arr.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            name, raw = "bfloat16", t.view(torch.int16).numpy().tobytes()
        else:
            a = t.numpy()
            name, raw = a.dtype.name, a.tobytes("C")
        shape = list(t.shape)
    else:
        if arr.dtype.hasobject or arr.dtype.isalignedstruct:
            raise ValueError("object and structured dtypes cannot be written")
        name, raw, shape = arr.dtype.name, arr.tobytes("C"), list(arr.shape)
    return packb([shape, name, raw])


def _chunked(arr):
    """flax's ``_chunk``: an array over 1 GiB as a map of flat chunks."""
    flat = arr.reshape(-1)
    size = max(1, _MAX_CHUNK_BYTES // flat.dtype.itemsize)
    return {_CHUNKED: True,
            "shape": {str(i): d for i, d in enumerate(arr.shape)},
            "chunks": {str(i): flat[j : j + size]
                       for i, j in enumerate(range(0, flat.size, size))}}


def _pack(obj, out: list) -> None:
    if obj is None:
        out.append(b"\xc0")
    elif obj is True or obj is False:
        out.append(b"\xc3" if obj else b"\xc2")
    elif type(obj) is int:
        out.append(_pack_int(obj))
    elif type(obj) is float:
        out.append(b"\xcb" + struct.pack(">d", obj))
    elif type(obj) is str:
        b = obj.encode("utf-8")
        out.append(_pack_len(len(b), *_STR) + b)
    elif type(obj) in (bytes, bytearray):
        out.append(_pack_len(len(obj), *_BIN) + bytes(obj))
    elif type(obj) is list:
        out.append(_pack_len(len(obj), *_ARR))
        for v in obj:
            _pack(v, out)
    elif type(obj) is dict:
        if not all(isinstance(k, str) for k in obj):
            raise TypeError("msgpack: only str keys")
        out.append(_pack_len(len(obj), *_MAP))
        for k in sorted(obj):
            _pack(k, out)
            _pack(obj[k], out)
    elif isinstance(obj, (np.ndarray, torch.Tensor)):
        nbytes = obj.numel() * obj.element_size() if isinstance(obj, torch.Tensor) \
            else obj.nbytes
        if nbytes > _MAX_CHUNK_BYTES:
            a = obj.detach().cpu() if isinstance(obj, torch.Tensor) else obj
            _pack(_chunked(a), out)
        else:
            out.append(_pack_ext(_EXT_NDARRAY, _array_bytes(obj)))
    elif isinstance(obj, np.generic):
        out.append(_pack_ext(_EXT_NPSCALAR, _array_bytes(np.asarray(obj))))
    else:
        raise TypeError(f"msgpack: cannot write {type(obj).__name__}")


def packb(obj) -> bytes:
    """msgpack bytes of ``obj`` as flax's ``msgpack_serialize`` writes a
    tree of these types."""
    out: list = []
    _pack(obj, out)
    return b"".join(out)


# ------------------------------------------------------------------ reader

class _Reader:
    def __init__(self, data: bytes, raw: bool = False):
        self.data, self.pos, self.raw = memoryview(data), 0, raw

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("msgpack: truncated data")
        b = self.data[self.pos : self.pos + n]
        self.pos += n
        return bytes(b)

    def num(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def str_(self, n: int):
        b = self.take(n)
        return b if self.raw else b.decode("utf-8")

    def ext(self, n: int):
        code = self.num(">b")
        return _ext_value(code, self.take(n))

    def value(self):
        c = self.num(">B")
        if c <= 0x7F:
            return c
        if c >= 0xE0:
            return c - 0x100
        if 0x80 <= c <= 0x8F:
            return self.map_(c & 0x0F)
        if 0x90 <= c <= 0x9F:
            return [self.value() for _ in range(c & 0x0F)]
        if 0xA0 <= c <= 0xBF:
            return self.str_(c & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if c in simple:
            return simple[c]
        nums = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
                0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if c in nums:
            return self.num(nums[c])
        sizes = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I", 0xD9: ">B", 0xDA: ">H",
                 0xDB: ">I", 0xDC: ">H", 0xDD: ">I", 0xDE: ">H", 0xDF: ">I",
                 0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}
        if c in (0xC4, 0xC5, 0xC6):
            return self.take(self.num(sizes[c]))
        if c in (0xD9, 0xDA, 0xDB):
            return self.str_(self.num(sizes[c]))
        if c in (0xDC, 0xDD):
            return [self.value() for _ in range(self.num(sizes[c]))]
        if c in (0xDE, 0xDF):
            return self.map_(self.num(sizes[c]))
        if c in (0xC7, 0xC8, 0xC9):
            return self.ext(self.num(sizes[c]))
        if 0xD4 <= c <= 0xD8:
            return self.ext(1 << (c - 0xD4))
        raise ValueError(f"msgpack: unknown type byte 0x{c:02x}")

    def map_(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        return out


def _array_from_bytes(data: bytes):
    """flax's ``_ndarray_from_bytes``."""
    shape, name, buf = _Reader(data, raw=True).value()
    name = name.decode() if isinstance(name, bytes) else name
    if name == "bfloat16":
        t = torch.frombuffer(bytearray(buf), dtype=torch.int16)
        return t.view(torch.bfloat16).reshape(shape)
    return np.frombuffer(buf, dtype=np.dtype(name)).reshape(shape, order="C")


def _ext_value(code: int, data: bytes):
    if code == _EXT_NDARRAY:
        return _array_from_bytes(data)
    if code == _EXT_NPSCALAR:
        return _array_from_bytes(data)[()]
    if code == _EXT_COMPLEX:
        re_, im = _Reader(data).value()
        return complex(re_, im)
    raise ValueError(f"msgpack: unknown extension type {code}")


def _unchunk(tree):
    if isinstance(tree, dict):
        if _CHUNKED in tree:
            shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
            chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
            return np.concatenate(chunks).reshape(shape)
        return {k: _unchunk(v) for k, v in tree.items()}
    return tree


def unpackb(data: bytes):
    """The tree of msgpack bytes, as flax's ``msgpack_restore`` gives it."""
    r = _Reader(data)
    out = r.value()
    if r.pos != len(r.data):
        raise ValueError("msgpack: trailing bytes")
    return _unchunk(out)


# --------------------------------------------------------------- snapshots

def save_snapshot(path: str, state: Any, metadata: Optional[dict] = None) -> None:
    """Write a compressed single-file snapshot of a tree (dicts with str
    keys, lists, arrays or tensors, scalars) and its JSON metadata."""
    payload = packb(state)
    meta = json.dumps(metadata or {}).encode()
    blob = zlib.compress(payload, level=6)
    with open(path, "wb") as f:
        f.write(MAGIC)
        f.write(len(meta).to_bytes(8, "little"))
        f.write(meta)
        f.write(blob)


def load_snapshot(path: str) -> Tuple[Any, dict]:
    """Read a snapshot -> (tree, metadata)."""
    with open(path, "rb") as f:
        magic = f.read(len(MAGIC))
        if magic != MAGIC:
            raise ValueError(f"{path} is not a snapshot (bad magic {magic!r})")
        n = int.from_bytes(f.read(8), "little")
        meta = json.loads(f.read(n).decode())
        blob = f.read()
    return unpackb(zlib.decompress(blob)), meta
