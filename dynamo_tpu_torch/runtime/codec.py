"""Length-prefixed msgpack framing for the runtime's TCP planes, the port's
copy of ``dynamo_tpu/runtime/codec.py`` over its own msgpack.

Every frame is a 4-byte big-endian length followed by one msgpack object.
``packb`` and ``unpackb`` are a pure-Python msgpack for the types the fleet
sends (nil, bool, int, float, str, bin, array, map), so a torch worker
speaks the JAX package's wire where the ``msgpack`` package is absent.
For those types the bytes equal ``msgpack.packb(obj, use_bin_type=True)``:
ints take the smallest encoding (unsigned for values >= 0), floats are
float64, tuples become arrays. ``unpackb`` follows ``msgpack.unpackb(data,
raw=False)``: str as str, bin as bytes, arrays as lists, and map keys
limited to str and bytes (msgpack's ``strict_map_key``).
"""

from __future__ import annotations

import asyncio
import struct
from typing import Any

MAX_FRAME = 256 * 1024 * 1024  # 256 MiB hard cap (KV block transfers can be large)

_LEN = struct.Struct(">I")
_U8, _U16, _U32, _U64 = (struct.Struct(f) for f in (">B", ">H", ">I", ">Q"))
_I8, _I16, _I32, _I64 = (struct.Struct(f) for f in (">b", ">h", ">i", ">q"))
_F32, _F64 = struct.Struct(">f"), struct.Struct(">d")


# ------------------------------------------------------------------ encode


def _pack_int(x: int, out: list) -> None:
    if x >= 0:
        if x < 0x80:
            out.append(_U8.pack(x))
        elif x < 0x100:
            out.append(b"\xcc" + _U8.pack(x))
        elif x < 0x10000:
            out.append(b"\xcd" + _U16.pack(x))
        elif x < 0x100000000:
            out.append(b"\xce" + _U32.pack(x))
        elif x < 1 << 64:
            out.append(b"\xcf" + _U64.pack(x))
        else:
            raise OverflowError("Integer value out of range")
    elif x >= -32:
        out.append(_I8.pack(x))
    elif x >= -0x80:
        out.append(b"\xd0" + _I8.pack(x))
    elif x >= -0x8000:
        out.append(b"\xd1" + _I16.pack(x))
    elif x >= -0x80000000:
        out.append(b"\xd2" + _I32.pack(x))
    elif x >= -(1 << 63):
        out.append(b"\xd3" + _I64.pack(x))
    else:
        raise OverflowError("Integer value out of range")


def _pack_len(n: int, fix: int, fix_max: int, tags: tuple, out: list,
              what: str) -> None:
    """Header of a str/bin/array/map of ``n`` items: the fix form when
    ``fix`` is set and n < fix_max, else the 8-, 16- or 32-bit length tag
    (``tags``; None where the type has no such form)."""
    if fix is not None and n < fix_max:
        out.append(_U8.pack(fix | n))
    elif tags[0] is not None and n < 0x100:
        out.append(tags[0] + _U8.pack(n))
    elif n < 0x10000:
        out.append(tags[1] + _U16.pack(n))
    elif n < 0x100000000:
        out.append(tags[2] + _U32.pack(n))
    else:
        raise ValueError(f"{what} is too large")


def _pack(obj: Any, out: list) -> None:
    if obj is None:
        out.append(b"\xc0")
    elif obj is True:
        out.append(b"\xc3")
    elif obj is False:
        out.append(b"\xc2")
    elif isinstance(obj, int):
        _pack_int(obj, out)
    elif isinstance(obj, float):
        out.append(b"\xcb" + _F64.pack(obj))
    elif isinstance(obj, str):
        data = obj.encode("utf-8", "surrogatepass")
        _pack_len(len(data), 0xA0, 32, (b"\xd9", b"\xda", b"\xdb"), out,
                  "str")
        out.append(data)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        data = bytes(obj)
        _pack_len(len(data), None, 0, (b"\xc4", b"\xc5", b"\xc6"), out, "bin")
        out.append(data)
    elif isinstance(obj, (list, tuple)):
        _pack_len(len(obj), 0x90, 16, (None, b"\xdc", b"\xdd"), out, "array")
        for item in obj:
            _pack(item, out)
    elif isinstance(obj, dict):
        _pack_len(len(obj), 0x80, 16, (None, b"\xde", b"\xdf"), out, "map")
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"can not serialize {type(obj).__name__!r} object")


def packb(obj: Any) -> bytes:
    """``msgpack.packb(obj, use_bin_type=True)`` for the fleet's types."""
    out: list = []
    _pack(obj, out)
    return b"".join(out)


# ------------------------------------------------------------------ decode


class _Reader:
    __slots__ = ("data", "pos")

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def take(self, n: int) -> bytes:
        end = self.pos + n
        if end > len(self.data):
            raise ValueError("Unpack failed: incomplete input")
        chunk = self.data[self.pos:end]
        self.pos = end
        return chunk

    def unpack(self, st: struct.Struct):
        return st.unpack(self.take(st.size))[0]


def _str(r: _Reader, n: int) -> str:
    return r.take(n).decode("utf-8", "surrogatepass")


def _array(r: _Reader, n: int) -> list:
    return [_unpack(r) for _ in range(n)]


def _map(r: _Reader, n: int) -> dict:
    out = {}
    for _ in range(n):
        k = _unpack(r)
        if type(k) not in (str, bytes):
            raise ValueError(f"{type(k).__name__} is not allowed for map key "
                             "when strict_map_key=True")
        out[k] = _unpack(r)
    return out


#: tag byte -> (length struct, reader of n) for the sized forms
_SIZED = {
    0xC4: (_U8, lambda r, n: r.take(n)), 0xC5: (_U16, lambda r, n: r.take(n)),
    0xC6: (_U32, lambda r, n: r.take(n)),
    0xD9: (_U8, _str), 0xDA: (_U16, _str), 0xDB: (_U32, _str),
    0xDC: (_U16, _array), 0xDD: (_U32, _array),
    0xDE: (_U16, _map), 0xDF: (_U32, _map),
}
#: tag byte -> struct of a scalar
_SCALAR = {0xCA: _F32, 0xCB: _F64, 0xCC: _U8, 0xCD: _U16, 0xCE: _U32,
           0xCF: _U64, 0xD0: _I8, 0xD1: _I16, 0xD2: _I32, 0xD3: _I64}


def _unpack(r: _Reader) -> Any:
    b = r.unpack(_U8)
    if b < 0x80:
        return b
    if b >= 0xE0:
        return b - 0x100
    if b < 0x90:
        return _map(r, b & 0x0F)
    if b < 0xA0:
        return _array(r, b & 0x0F)
    if b < 0xC0:
        return _str(r, b & 0x1F)
    if b == 0xC0:
        return None
    if b == 0xC2:
        return False
    if b == 0xC3:
        return True
    st = _SCALAR.get(b)
    if st is not None:
        return r.unpack(st)
    sized = _SIZED.get(b)
    if sized is not None:
        return sized[1](r, r.unpack(sized[0]))
    raise ValueError(f"msgpack type 0x{b:02x} is not used on this wire "
                     "(ext types are not supported)")


def unpackb(data: bytes) -> Any:
    """``msgpack.unpackb(data, raw=False)`` for the fleet's types."""
    r = _Reader(bytes(data))
    obj = _unpack(r)
    if r.pos != len(r.data):
        raise ValueError("Unpack failed: extra data after the object")
    return obj


# ------------------------------------------------------------------ frames


def pack_frame(obj: Any) -> bytes:
    body = packb(obj)
    return _LEN.pack(len(body)) + body


async def read_frame(reader: asyncio.StreamReader) -> Any:
    """Read one frame; raises IncompleteReadError/ConnectionError on EOF."""
    hdr = await reader.readexactly(4)
    (n,) = _LEN.unpack(hdr)
    if n > MAX_FRAME:
        raise ValueError(f"frame too large: {n}")
    body = await reader.readexactly(n)
    return unpackb(body)


async def write_frame(writer: asyncio.StreamWriter, obj: Any) -> None:
    writer.write(pack_frame(obj))
    await writer.drain()
