"""A msgpack decoder for the checkpoints the JAX package writes with
flax.serialization.msgpack_serialize, written out here because the card's
installation has neither the msgpack package nor flax.

It decodes nil, bool, ints, floats, str, bin, arrays and maps, and flax's
ext type 1: an ndarray packed as a nested msgpack (shape, dtype name,
row-major bytes). Any other ext code raises: the reader never guesses.
Arrays come back as lists, str as str, bin as bytes, as
msgpack_restore gives them; ndarrays are read-only numpy views of the
file's bytes, like flax's.
"""

import struct

import numpy as np

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
