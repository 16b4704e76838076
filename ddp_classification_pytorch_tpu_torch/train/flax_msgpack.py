"""The subset of msgpack that `flax.serialization.to_bytes` writes, read and
written in plain Python and numpy: the port serves the JAX package's
checkpoints (`ckpt_eN.msgpack`) on a machine that has neither flax nor the
`msgpack` package.

What flax writes (flax `serialization.py`, `msgpack.packb(state_dict,
default=_msgpack_ext_pack, strict_types=True)`):

- maps with str keys, str, bin, ints, floats (float64), nil, bools and
  arrays, each in the smallest msgpack form that holds it;
- ext 1, an ndarray: a nested msgpack array of (shape, dtype name, the
  C-order bytes);
- ext 2, a native complex: a nested msgpack array (real, imag);
- ext 3, a numpy scalar: an ext-1 payload of a 0-d array;
- arrays above `MAX_CHUNK_SIZE` bytes as `{"__msgpack_chunked_array__":
  True, "shape": {"0": ...}, "chunks": {"0": flat chunk, ...}}`.

`unpackb` gives the tree `flax.serialization.msgpack_restore` gives, leaf
for leaf: numpy arrays and numpy scalars, except that a bfloat16 leaf
(which numpy has no type for) comes back as a `torch.bfloat16` tensor of
the same bits. Anything outside this subset (another ext type, a byte no
msgpack form starts with, a truncated buffer, an unknown dtype) raises
ValueError. `packb` writes the same bytes `to_bytes` writes for a tree of
dicts with str keys and numpy leaves.
"""

from __future__ import annotations

import struct
from typing import Any, Dict, List, Tuple

import numpy as np

MAX_CHUNK_SIZE = 2 ** 30  # flax's: arrays above this many bytes are chunked
_CHUNKED = "__msgpack_chunked_array__"
_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3


# ----------------------------------------------------------------- reader --

class _Reader:
    def __init__(self, data: bytes, raw: bool = False):
        self.data = memoryview(data)
        self.pos = 0
        self.raw = raw  # str as bytes (flax reads its ndarray payloads so)

    def take(self, n: int) -> memoryview:
        if n < 0 or self.pos + n > len(self.data):
            raise ValueError(f"msgpack: truncated at byte {self.pos} "
                             f"(wanted {n} more of {len(self.data)})")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str) -> Any:
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def str_(self, n: int) -> Any:
        b = bytes(self.take(n))
        if self.raw:
            return b
        try:
            return b.decode("utf-8")
        except UnicodeDecodeError as e:
            raise ValueError(f"msgpack: invalid utf-8 str: {e}") from None

    def obj(self) -> Any:
        t = self.unpack(">B")
        if t <= 0x7F:
            return t
        if t >= 0xE0:
            return t - 0x100
        if 0x80 <= t <= 0x8F:
            return self.map_(t & 0x0F)
        if 0x90 <= t <= 0x9F:
            return self.array_(t & 0x0F)
        if 0xA0 <= t <= 0xBF:
            return self.str_(t & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if t in simple:
            return simple[t]
        sized = {0xC4: ("bin", ">B"), 0xC5: ("bin", ">H"), 0xC6: ("bin", ">I"),
                 0xD9: ("str", ">B"), 0xDA: ("str", ">H"), 0xDB: ("str", ">I"),
                 0xDC: ("array", ">H"), 0xDD: ("array", ">I"),
                 0xDE: ("map", ">H"), 0xDF: ("map", ">I"),
                 0xC7: ("ext", ">B"), 0xC8: ("ext", ">H"), 0xC9: ("ext", ">I")}
        if t in sized:
            kind, fmt = sized[t]
            n = self.unpack(fmt)
            if kind == "bin":
                return bytes(self.take(n))
            if kind == "str":
                return self.str_(n)
            if kind == "array":
                return self.array_(n)
            if kind == "map":
                return self.map_(n)
            return self.ext(n)
        numbers = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
                   0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if t in numbers:
            return self.unpack(numbers[t])
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if t in fixext:
            return self.ext(fixext[t])
        raise ValueError(f"msgpack: byte 0x{t:02x} at {self.pos - 1} starts "
                         "no msgpack form")

    def array_(self, n: int) -> List[Any]:
        return [self.obj() for _ in range(n)]

    def map_(self, n: int) -> Dict[Any, Any]:
        out = {}
        for _ in range(n):
            k = self.obj()
            if isinstance(k, (dict, list)):
                raise ValueError("msgpack: an unhashable map key")
            out[k] = self.obj()
        return out

    def ext(self, n: int) -> Any:
        code = self.unpack(">b")
        payload = bytes(self.take(n))
        if code == _EXT_NDARRAY:
            return _ndarray(payload)
        if code == _EXT_NPSCALAR:
            arr = _ndarray(payload)
            return arr[()] if isinstance(arr, np.ndarray) else arr.reshape(())
        if code == _EXT_COMPLEX:
            parts = _whole(payload)
            if (not isinstance(parts, list) or len(parts) != 2
                    or not all(isinstance(p, (int, float)) for p in parts)):
                raise ValueError("msgpack: a malformed complex ext")
            return complex(parts[0], parts[1])
        raise ValueError(f"msgpack: ext type {code} is not one flax writes")


def _whole(data: bytes, raw: bool = False) -> Any:
    r = _Reader(data, raw)
    out = r.obj()
    if r.pos != len(r.data):
        raise ValueError(f"msgpack: {len(r.data) - r.pos} trailing bytes")
    return out


def _ndarray(payload: bytes) -> Any:
    """flax's `_ndarray_from_bytes`: (shape, dtype name, C-order bytes)."""
    parts = _whole(payload, raw=True)
    if (not isinstance(parts, list) or len(parts) != 3
            or not isinstance(parts[0], list)
            or not all(isinstance(d, int) and d >= 0 for d in parts[0])
            or not isinstance(parts[1], bytes)
            or not isinstance(parts[2], bytes)):
        raise ValueError("msgpack: a malformed ndarray ext")
    shape, name, buf = tuple(parts[0]), parts[1].decode("ascii", "replace"), parts[2]
    if name == "bfloat16":
        import torch

        bits = np.frombuffer(buf, dtype=np.uint16).reshape(shape)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    try:
        dtype = np.dtype(name)
    except TypeError:
        raise ValueError(f"msgpack: unknown ndarray dtype {name!r}") from None
    if dtype.hasobject:
        raise ValueError(f"msgpack: object dtype {name!r}")
    try:
        return np.frombuffer(buf, dtype=dtype).reshape(shape)
    except ValueError as e:
        raise ValueError(f"msgpack: ndarray {name} {shape}: {e}") from None


def _unchunk(tree: Any) -> Any:
    """Chunked-array dicts back into arrays, at any depth."""
    if not isinstance(tree, dict):
        return tree
    if tree.get(_CHUNKED) is True:
        try:
            shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
            chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
            return np.concatenate(chunks).reshape(shape)
        except (KeyError, TypeError, ValueError) as e:
            raise ValueError(f"msgpack: a malformed chunked array: {e}") from None
    return {k: _unchunk(v) for k, v in tree.items()}


def unpackb(data: bytes) -> Any:
    """The tree `flax.serialization.msgpack_restore(data)` gives."""
    return _unchunk(_whole(data))


# ----------------------------------------------------------------- writer --

def _int(x: int) -> bytes:
    if 0 <= x <= 0x7F:
        return struct.pack(">B", x)
    if -32 <= x < 0:
        return struct.pack(">b", x)
    if x >= 0:
        for t, fmt, top in ((0xCC, ">B", 1 << 8), (0xCD, ">H", 1 << 16),
                            (0xCE, ">I", 1 << 32), (0xCF, ">Q", 1 << 64)):
            if x < top:
                return struct.pack(">B", t) + struct.pack(fmt, x)
    else:
        for t, fmt, low in ((0xD0, ">b", -(1 << 7)), (0xD1, ">h", -(1 << 15)),
                            (0xD2, ">i", -(1 << 31)), (0xD3, ">q", -(1 << 63))):
            if x >= low:
                return struct.pack(">B", t) + struct.pack(fmt, x)
    raise ValueError(f"msgpack: int {x} out of range")


def _sized(n: int, forms: Tuple[Tuple[int, str, int], ...]) -> bytes:
    for t, fmt, top in forms:
        if n < top:
            return struct.pack(">B", t) + (struct.pack(fmt, n) if fmt else b"")
    raise ValueError(f"msgpack: length {n} too large")


def _str(s: str) -> bytes:
    b = s.encode("utf-8")
    n = len(b)
    head = (struct.pack(">B", 0xA0 | n) if n < 32 else
            _sized(n, ((0xD9, ">B", 1 << 8), (0xDA, ">H", 1 << 16),
                       (0xDB, ">I", 1 << 32))))
    return head + b


def _bin(b: bytes) -> bytes:
    return _sized(len(b), ((0xC4, ">B", 1 << 8), (0xC5, ">H", 1 << 16),
                           (0xC6, ">I", 1 << 32))) + b


def _ext(code: int, payload: bytes) -> bytes:
    n = len(payload)
    fix = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    head = (struct.pack(">B", fix[n]) if n in fix else
            _sized(n, ((0xC7, ">B", 1 << 8), (0xC8, ">H", 1 << 16),
                       (0xC9, ">I", 1 << 32))))
    return head + struct.pack(">b", code) + payload


def _ndarray_payload(arr: Any) -> bytes:
    """flax's `_ndarray_to_bytes`: packb((shape, dtype name, bytes))."""
    if hasattr(arr, "numpy") and not isinstance(arr, np.ndarray):  # torch
        import torch

        if arr.dtype == torch.bfloat16:
            shape, name = tuple(arr.shape), "bfloat16"
            buf = arr.detach().cpu().contiguous().view(torch.int16).numpy().tobytes()
        else:
            return _ndarray_payload(arr.detach().cpu().numpy())
    else:
        if arr.dtype.hasobject or arr.dtype.isalignedstruct:
            raise ValueError("msgpack: object and structured dtypes are not "
                             "serialized")
        shape, name, buf = arr.shape, arr.dtype.name, arr.tobytes("C")
    head = (struct.pack(">B", 0x90 | len(shape)) if len(shape) < 16 else
            _sized(len(shape), ((0xDC, ">H", 1 << 16), (0xDD, ">I", 1 << 32))))
    return (struct.pack(">B", 0x93) + head + b"".join(_int(int(d)) for d in shape)
            + _str(name) + _bin(buf))


def _chunk(arr: np.ndarray) -> Dict[str, Any]:
    """flax's `_chunk`: a canonical dict of flat chunks."""
    size = max(1, int(MAX_CHUNK_SIZE / arr.dtype.itemsize))
    flat = arr.reshape(-1)
    chunks = [flat[i:i + size] for i in range(0, flat.size, size)]
    return {_CHUNKED: True,
            "shape": {str(i): d for i, d in enumerate(arr.shape)},
            "chunks": {str(i): c for i, c in enumerate(chunks)}}


def _pack(x: Any, out: List[bytes]) -> None:
    if x is None:
        out.append(b"\xc0")
    elif x is True or x is False:
        out.append(b"\xc3" if x else b"\xc2")
    elif type(x) is int:
        out.append(_int(x))
    elif type(x) is float:
        out.append(b"\xcb" + struct.pack(">d", x))
    elif type(x) is str:
        out.append(_str(x))
    elif type(x) is bytes:
        out.append(_bin(x))
    elif type(x) is dict:
        n = len(x)
        out.append(struct.pack(">B", 0x80 | n) if n < 16 else
                   _sized(n, ((0xDE, ">H", 1 << 16), (0xDF, ">I", 1 << 32))))
        for k, v in x.items():
            _pack(k, out)
            _pack(v, out)
    elif type(x) is list:
        n = len(x)
        out.append(struct.pack(">B", 0x90 | n) if n < 16 else
                   _sized(n, ((0xDC, ">H", 1 << 16), (0xDD, ">I", 1 << 32))))
        for v in x:
            _pack(v, out)
    elif isinstance(x, np.ndarray):
        if x.size * x.dtype.itemsize > MAX_CHUNK_SIZE:
            _pack(_chunk(x), out)
        else:
            out.append(_ext(_EXT_NDARRAY, _ndarray_payload(x)))
    elif isinstance(x, np.generic):
        out.append(_ext(_EXT_NPSCALAR, _ndarray_payload(np.asarray(x))))
    elif type(x) is complex:
        out.append(_ext(_EXT_COMPLEX, b"\x92" + b"\xcb" + struct.pack(">d", x.real)
                        + b"\xcb" + struct.pack(">d", x.imag)))
    elif hasattr(x, "dtype") and hasattr(x, "numpy"):  # a torch tensor
        out.append(_ext(_EXT_NDARRAY, _ndarray_payload(x)))
    else:
        raise ValueError(f"msgpack: cannot serialize {type(x).__name__}")


def packb(tree: Any) -> bytes:
    """The bytes `flax.serialization.to_bytes(tree)` writes for a tree of
    dicts with str keys and numpy (or torch bfloat16) leaves."""
    out: List[bytes] = []
    _pack(tree, out)
    return b"".join(out)
