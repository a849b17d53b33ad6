"""A small MessagePack codec for checkpoint metadata.

The checkpoint format stores its metadata (``meta.msgpack``) as
MessagePack, and the port does not depend on the ``msgpack`` package.
This module encodes and decodes the subset the metadata holds: maps,
arrays (lists and tuples), str, bytes, int (64-bit), float, bool and None.
The encoder picks the smallest form of each value, as ``msgpack.packb``
does with its defaults, so the bytes are the package's own; the decoder
also reads float32 and every fixed-width integer form.  Strings are UTF-8
(the package's ``use_bin_type=True`` / ``raw=False`` defaults); arrays
decode as lists.
"""

from __future__ import annotations

import struct

__all__ = ["packb", "unpackb"]


def _pack_len(out: bytearray, n: int, fix_base: int | None, fix_max: int,
              codes: tuple) -> None:
    """The length header of a str / bin / array / map: a fix form below
    ``fix_max`` where there is one, else the 8-, 16- or 32-bit form
    (``codes``, ``None`` where the type has no such form)."""
    if fix_base is not None and n < fix_max:
        out.append(fix_base | n)
    elif codes[0] is not None and n < 1 << 8:
        out += struct.pack(">BB", codes[0], n)
    elif n < 1 << 16:
        out += struct.pack(">BH", codes[1], n)
    elif n < 1 << 32:
        out += struct.pack(">BI", codes[2], n)
    else:
        raise ValueError(f"msgpack: length {n} too large")


def _pack_int(out: bytearray, v: int) -> None:
    if 0 <= v < 128:
        out.append(v)
    elif -32 <= v < 0:
        out.append(v & 0xFF)
    elif v >= 0:
        for code, fmt, hi in ((0xCC, ">BB", 1 << 8), (0xCD, ">BH", 1 << 16),
                              (0xCE, ">BI", 1 << 32),
                              (0xCF, ">BQ", 1 << 64)):
            if v < hi:
                out += struct.pack(fmt, code, v)
                return
        raise OverflowError(f"msgpack: int {v} does not fit 64 bits")
    else:
        for code, fmt, lo in ((0xD0, ">Bb", -(1 << 7)),
                              (0xD1, ">Bh", -(1 << 15)),
                              (0xD2, ">Bi", -(1 << 31)),
                              (0xD3, ">Bq", -(1 << 63))):
            if v >= lo:
                out += struct.pack(fmt, code, v)
                return
        raise OverflowError(f"msgpack: int {v} does not fit 64 bits")


def _pack(out: bytearray, obj) -> None:
    if obj is None:
        out.append(0xC0)
    elif obj is True:
        out.append(0xC3)
    elif obj is False:
        out.append(0xC2)
    elif isinstance(obj, int):
        _pack_int(out, obj)
    elif isinstance(obj, float):
        out += struct.pack(">Bd", 0xCB, obj)
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        _pack_len(out, len(data), 0xA0, 32, (0xD9, 0xDA, 0xDB))
        out += data
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        data = bytes(obj)
        _pack_len(out, len(data), None, 0, (0xC4, 0xC5, 0xC6))
        out += data
    elif isinstance(obj, (list, tuple)):
        _pack_len(out, len(obj), 0x90, 16, (None, 0xDC, 0xDD))
        for item in obj:
            _pack(out, item)
    elif isinstance(obj, dict):
        _pack_len(out, len(obj), 0x80, 16, (None, 0xDE, 0xDF))
        for key, value in obj.items():
            _pack(out, key)
            _pack(out, value)
    else:
        raise TypeError(f"msgpack: cannot serialize {type(obj).__name__}")


def packb(obj) -> bytes:
    """``obj`` as MessagePack bytes (the bytes ``msgpack.packb`` gives)."""
    out = bytearray()
    _pack(out, obj)
    return bytes(out)


class _Reader:
    __slots__ = ("data", "pos")

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("msgpack: truncated data")
        chunk = self.data[self.pos:self.pos + n]
        self.pos += n
        return chunk

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]


# fixed-size forms: code -> struct format of the value that follows
_SCALARS = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
            0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
# variable-size forms: code -> (kind, struct format of the length)
_SIZED = {0xD9: ("str", ">B"), 0xDA: ("str", ">H"), 0xDB: ("str", ">I"),
          0xC4: ("bin", ">B"), 0xC5: ("bin", ">H"), 0xC6: ("bin", ">I"),
          0xDC: ("array", ">H"), 0xDD: ("array", ">I"),
          0xDE: ("map", ">H"), 0xDF: ("map", ">I")}


def _unpack(r: _Reader):
    code = r.take(1)[0]
    if code < 0x80:
        return code
    if code >= 0xE0:
        return code - 0x100
    if code < 0x90:
        kind, n = "map", code & 0x0F
    elif code < 0xA0:
        kind, n = "array", code & 0x0F
    elif code < 0xC0:
        kind, n = "str", code & 0x1F
    elif code == 0xC0:
        return None
    elif code in (0xC2, 0xC3):
        return code == 0xC3
    elif code in _SCALARS:
        return r.unpack(_SCALARS[code])
    elif code in _SIZED:
        kind, fmt = _SIZED[code]
        n = r.unpack(fmt)
    else:
        raise ValueError(f"msgpack: unsupported type code 0x{code:02x}")
    if kind == "str":
        return r.take(n).decode("utf-8")
    if kind == "bin":
        return r.take(n)
    if kind == "array":
        return [_unpack(r) for _ in range(n)]
    out = {}
    for _ in range(n):
        key = _unpack(r)
        out[key] = _unpack(r)
    return out


def unpackb(data: bytes):
    """The object MessagePack ``data`` encodes (``msgpack.unpackb``'s
    defaults: str keys and values, lists for arrays)."""
    r = _Reader(bytes(data))
    obj = _unpack(r)
    if r.pos != len(r.data):
        raise ValueError("msgpack: extra data after the object")
    return obj
