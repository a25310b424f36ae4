"""A msgpack decoder and encoder for the checkpoints the JAX package reads
and writes with flax.serialization (msgpack_restore, msgpack_serialize),
written out here because the card's installation has neither the msgpack
package nor flax.

unpackb decodes nil, bool, ints, floats, str, bin, arrays and maps, and
flax's ext type 1: an ndarray packed as a nested msgpack (shape, dtype
name, row-major bytes). Any other ext code raises: the reader never
guesses. Arrays come back as lists, str as str, bin as bytes, as
msgpack_restore gives them; ndarrays are read-only numpy views of the
file's bytes, like flax's.

packb writes what msgpack_serialize writes for such a tree: ints in their
smallest form (non-negative ones unsigned), Python floats as float64, str
and bytes as str and bin, lists and tuples as arrays, maps with their keys
in sorted order (msgpack_serialize copies the tree with jax.tree_util,
which sorts every dict's keys), and every numpy array or torch tensor, 0-d
ones too, as ext type 1. So packb(unpackb(b)) == b for a flax checkpoint.
"""

import struct

import numpy as np
import torch

#: flax.serialization._MsgpackExtType.ndarray
EXT_NDARRAY = 1


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.at = 0

    def take(self, n: int) -> memoryview:
        if self.at + n > len(self.data):
            raise ValueError(f"msgpack: truncated input at byte {self.at}")
        out = self.data[self.at:self.at + n]
        self.at += n
        return out

    def unpack(self, fmt: str):
        (value,) = struct.unpack_from(fmt, self.take(struct.calcsize(fmt)))
        return value


# Fixed-width formats by type byte: (struct format of the value).
_SCALARS = {
    0xca: ">f", 0xcb: ">d",
    0xcc: ">B", 0xcd: ">H", 0xce: ">I", 0xcf: ">Q",
    0xd0: ">b", 0xd1: ">h", 0xd2: ">i", 0xd3: ">q",
}
# Length-prefixed bodies by type byte: (kind, struct format of the length).
_SIZED = {
    0xc4: ("bin", ">B"), 0xc5: ("bin", ">H"), 0xc6: ("bin", ">I"),
    0xd9: ("str", ">B"), 0xda: ("str", ">H"), 0xdb: ("str", ">I"),
    0xdc: ("array", ">H"), 0xdd: ("array", ">I"),
    0xde: ("map", ">H"), 0xdf: ("map", ">I"),
    0xc7: ("ext", ">B"), 0xc8: ("ext", ">H"), 0xc9: ("ext", ">I"),
}
_FIXEXT = {0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8, 0xd8: 16}
_CONSTANTS = {0xc0: None, 0xc2: False, 0xc3: True}


def _ndarray(body: bytes) -> np.ndarray:
    shape, dtype_name, buffer = unpackb(body)
    return np.frombuffer(buffer, dtype=np.dtype(dtype_name)).reshape(
        tuple(shape), order="C")


def _ext(code: int, body: bytes):
    if code != EXT_NDARRAY:
        raise ValueError(f"msgpack: ext type {code} is not a flax ndarray "
                         f"(ext type {EXT_NDARRAY}); refusing to guess")
    return _ndarray(body)


def _body(r: _Reader, kind: str, n: int):
    if kind == "str":
        return str(r.take(n), "utf-8")
    if kind == "bin":
        return bytes(r.take(n))
    if kind == "array":
        return [_value(r) for _ in range(n)]
    if kind == "map":
        out = {}
        for _ in range(n):
            key = _value(r)
            out[key] = _value(r)
        return out
    code = r.unpack(">b")
    return _ext(code, bytes(r.take(n)))


def _value(r: _Reader):
    b = r.unpack(">B")
    if b <= 0x7f:
        return b
    if b >= 0xe0:
        return b - 0x100
    if 0x80 <= b <= 0x8f:
        return _body(r, "map", b & 0x0f)
    if 0x90 <= b <= 0x9f:
        return _body(r, "array", b & 0x0f)
    if 0xa0 <= b <= 0xbf:
        return _body(r, "str", b & 0x1f)
    if b in _CONSTANTS:
        return _CONSTANTS[b]
    if b in _SCALARS:
        return r.unpack(_SCALARS[b])
    if b in _SIZED:
        kind, fmt = _SIZED[b]
        return _body(r, kind, r.unpack(fmt))
    if b in _FIXEXT:
        return _body(r, "ext", _FIXEXT[b])
    raise ValueError(f"msgpack: type byte 0x{b:02x} is not valid")


def unpackb(data: bytes):
    """Decode one msgpack object that spans all of `data`."""
    r = _Reader(data)
    out = _value(r)
    if r.at != len(r.data):
        raise ValueError(f"msgpack: {len(r.data) - r.at} trailing bytes")
    return out


def _pack_uint(n: int, tags) -> bytes:
    """The smallest of the (limit, type byte, struct format) forms that
    holds the length or value n."""
    for limit, tag, fmt in tags:
        if n <= limit:
            return bytes([tag]) + struct.pack(fmt, n)
    raise ValueError(f"msgpack: {n} is too large to encode")


_LENGTHS = {
    "str": ((0xff, 0xd9, ">B"), (0xffff, 0xda, ">H"),
            (0xffffffff, 0xdb, ">I")),
    "bin": ((0xff, 0xc4, ">B"), (0xffff, 0xc5, ">H"),
            (0xffffffff, 0xc6, ">I")),
    "array": ((0xffff, 0xdc, ">H"), (0xffffffff, 0xdd, ">I")),
    "map": ((0xffff, 0xde, ">H"), (0xffffffff, 0xdf, ">I")),
    "ext": ((0xff, 0xc7, ">B"), (0xffff, 0xc8, ">H"),
            (0xffffffff, 0xc9, ">I")),
}
_UINTS = ((0xff, 0xcc, ">B"), (0xffff, 0xcd, ">H"), (0xffffffff, 0xce, ">I"),
          (0xffffffffffffffff, 0xcf, ">Q"))
_FIXEXT_TAGS = {n: tag for tag, n in _FIXEXT.items()}


def _pack_int(n: int) -> bytes:
    if 0 <= n <= 0x7f:
        return bytes([n])
    if -32 <= n < 0:
        return bytes([n + 0x100])
    if n > 0:
        return _pack_uint(n, _UINTS)
    for fmt, tag in ((">b", 0xd0), (">h", 0xd1), (">i", 0xd2), (">q", 0xd3)):
        bits = 8 * struct.calcsize(fmt)
        if n >= -(1 << (bits - 1)):
            return bytes([tag]) + struct.pack(fmt, n)
    raise ValueError(f"msgpack: {n} is too small to encode")


def _ndarray_body(arr: np.ndarray) -> bytes:
    """flax's _ndarray_to_bytes: packb((shape, dtype name, C bytes))."""
    if arr.dtype.hasobject or arr.dtype.fields is not None:
        raise TypeError(f"msgpack: an array of dtype {arr.dtype} has no "
                        "flax encoding")
    return packb([list(arr.shape), arr.dtype.name, arr.tobytes("C")])


def _pack(x, out: list):
    if x is None or isinstance(x, bool):
        out.append(bytes([{None: 0xc0, False: 0xc2, True: 0xc3}[x]]))
    elif isinstance(x, int):
        out.append(_pack_int(x))
    elif isinstance(x, float):
        out.append(b"\xcb" + struct.pack(">d", x))
    elif isinstance(x, str):
        raw = x.encode("utf-8")
        out.append(bytes([0xa0 | len(raw)]) if len(raw) <= 31
                   else _pack_uint(len(raw), _LENGTHS["str"]))
        out.append(raw)
    elif isinstance(x, (bytes, bytearray, memoryview)):
        raw = bytes(x)
        out.append(_pack_uint(len(raw), _LENGTHS["bin"]))
        out.append(raw)
    elif isinstance(x, (list, tuple)):
        out.append(bytes([0x90 | len(x)]) if len(x) <= 15
                   else _pack_uint(len(x), _LENGTHS["array"]))
        for item in x:
            _pack(item, out)
    elif isinstance(x, dict):
        out.append(bytes([0x80 | len(x)]) if len(x) <= 15
                   else _pack_uint(len(x), _LENGTHS["map"]))
        for key in sorted(x):
            _pack(key, out)
            _pack(x[key], out)
    elif isinstance(x, (np.ndarray, torch.Tensor)):
        if isinstance(x, torch.Tensor):
            x = x.detach().cpu().numpy()
        body = _ndarray_body(x)
        if len(body) in _FIXEXT_TAGS:
            out.append(bytes([_FIXEXT_TAGS[len(body)]]))
        else:
            out.append(_pack_uint(len(body), _LENGTHS["ext"]))
        out.append(struct.pack(">b", EXT_NDARRAY))
        out.append(body)
    else:
        # numpy scalars included: flax writes them as another ext type,
        # which unpackb refuses; pass a 0-d array instead.
        raise TypeError(f"msgpack: cannot encode {type(x).__name__}")


def packb(tree) -> bytes:
    """Encode `tree` (None, bool, int, float, str, bytes, lists, tuples,
    dicts with sortable keys, numpy arrays and torch tensors) as
    flax.serialization.msgpack_serialize does."""
    out = []
    _pack(tree, out)
    return b"".join(out)
