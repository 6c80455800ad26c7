"""A pure-Python msgpack encoder and decoder for the checkpoint and patch
formats.

The machine with the card has no ``msgpack`` package, so the port carries
the part of the format that ``training/checkpoint.py`` and
``training/online.py`` write: maps, arrays (lists and tuples), str, bin
(bytes), int, float, bool and nil. ``packb`` gives the bytes that
``msgpack.packb(obj, use_bin_type=True)`` gives: the smallest encoding of
each int and length, str8 for strings of 32 to 255 bytes, and every float
as float64 (``0xcb``). ``unpackb`` reads what ``msgpack.unpackb(data,
raw=False, strict_map_key=False)`` reads, arrays as lists; extension types,
trailing bytes and truncated input raise ``ValueError``.
"""
from __future__ import annotations

import struct
from typing import Any, List, Tuple


def packb(obj: Any) -> bytes:
    """``obj`` in msgpack, as ``msgpack.packb(obj, use_bin_type=True)``."""
    out: List[bytes] = []
    _pack(obj, out)
    return b"".join(out)


def _pack(obj: Any, out: List[bytes]) -> None:
    if obj is None:
        out.append(b"\xc0")
    elif obj is True:
        out.append(b"\xc3")
    elif obj is False:
        out.append(b"\xc2")
    elif isinstance(obj, int):
        out.append(_pack_int(obj))
    elif isinstance(obj, float):
        out.append(b"\xcb" + struct.pack(">d", obj))
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        out.append(_header(len(data), 0xa0, 32, b"\xd9", b"\xda", b"\xdb"))
        out.append(data)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        data = bytes(obj)
        out.append(_header(len(data), None, 0, b"\xc4", b"\xc5", b"\xc6"))
        out.append(data)
    elif isinstance(obj, (list, tuple)):
        out.append(_header(len(obj), 0x90, 16, None, b"\xdc", b"\xdd"))
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, dict):
        out.append(_header(len(obj), 0x80, 16, None, b"\xde", b"\xdf"))
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"can not serialize {type(obj).__name__!r} object")


def _pack_int(n: int) -> bytes:
    if 0 <= n < 0x80:
        return struct.pack("B", n)
    if -0x20 <= n < 0:
        return struct.pack("b", n)
    if n > 0:
        for code, fmt, hi in ((b"\xcc", ">B", 0xff), (b"\xcd", ">H", 0xffff),
                              (b"\xce", ">I", 0xffffffff),
                              (b"\xcf", ">Q", 0xffffffffffffffff)):
            if n <= hi:
                return code + struct.pack(fmt, n)
    else:
        for code, fmt, lo in ((b"\xd0", ">b", -0x80), (b"\xd1", ">h", -0x8000),
                              (b"\xd2", ">i", -0x80000000),
                              (b"\xd3", ">q", -0x8000000000000000)):
            if n >= lo:
                return code + struct.pack(fmt, n)
    raise OverflowError("Integer value out of range")


def _header(n: int, fix, fix_limit: int, c8, c16, c32) -> bytes:
    """The type and length prefix: a fix form below ``fix_limit``, else the
    8-, 16- or 32-bit length form (``None`` where the type has none)."""
    if fix is not None and n < fix_limit:
        return struct.pack("B", fix | n)
    if c8 is not None and n <= 0xff:
        return c8 + struct.pack(">B", n)
    if n <= 0xffff:
        return c16 + struct.pack(">H", n)
    if n <= 0xffffffff:
        return c32 + struct.pack(">I", n)
    raise ValueError(f"length {n} is too large for msgpack")


def unpackb(data: bytes) -> Any:
    """The object ``data`` encodes, as ``msgpack.unpackb(data, raw=False,
    strict_map_key=False)`` reads it."""
    data = bytes(data)
    obj, end = _unpack(data, 0)
    if end != len(data):
        raise ValueError(f"extra data: {len(data) - end} bytes after the "
                         f"object")
    return obj


def _take(data: bytes, i: int, n: int) -> Tuple[bytes, int]:
    if i + n > len(data):
        raise ValueError("Unpack failed: incomplete input")
    return data[i:i + n], i + n


def _unpack(data: bytes, i: int) -> Tuple[Any, int]:
    b, i = _take(data, i, 1)
    c = b[0]
    if c < 0x80:
        return c, i
    if c >= 0xe0:
        return c - 0x100, i
    if 0x80 <= c <= 0x8f:
        return _unpack_map(data, i, c & 0x0f)
    if 0x90 <= c <= 0x9f:
        return _unpack_array(data, i, c & 0x0f)
    if 0xa0 <= c <= 0xbf:
        return _unpack_str(data, i, c & 0x1f)
    if c == 0xc0:
        return None, i
    if c == 0xc2:
        return False, i
    if c == 0xc3:
        return True, i
    if c in _SCALARS:
        fmt = _SCALARS[c]
        raw, i = _take(data, i, struct.calcsize(fmt))
        return struct.unpack(fmt, raw)[0], i
    if c in _SIZED:
        kind, fmt = _SIZED[c]
        raw, i = _take(data, i, struct.calcsize(fmt))
        n = struct.unpack(fmt, raw)[0]
        if kind == "bin":
            raw, i = _take(data, i, n)
            return raw, i
        if kind == "str":
            return _unpack_str(data, i, n)
        if kind == "array":
            return _unpack_array(data, i, n)
        return _unpack_map(data, i, n)
    raise ValueError(f"unsupported msgpack type byte 0x{c:02x}")


_SCALARS = {0xca: ">f", 0xcb: ">d", 0xcc: ">B", 0xcd: ">H", 0xce: ">I",
            0xcf: ">Q", 0xd0: ">b", 0xd1: ">h", 0xd2: ">i", 0xd3: ">q"}
_SIZED = {0xc4: ("bin", ">B"), 0xc5: ("bin", ">H"), 0xc6: ("bin", ">I"),
          0xd9: ("str", ">B"), 0xda: ("str", ">H"), 0xdb: ("str", ">I"),
          0xdc: ("array", ">H"), 0xdd: ("array", ">I"),
          0xde: ("map", ">H"), 0xdf: ("map", ">I")}


def _unpack_str(data: bytes, i: int, n: int) -> Tuple[str, int]:
    raw, i = _take(data, i, n)
    return raw.decode("utf-8"), i


def _unpack_array(data: bytes, i: int, n: int) -> Tuple[list, int]:
    out = []
    for _ in range(n):
        v, i = _unpack(data, i)
        out.append(v)
    return out, i


def _unpack_map(data: bytes, i: int, n: int) -> Tuple[dict, int]:
    out = {}
    for _ in range(n):
        k, i = _unpack(data, i)
        v, i = _unpack(data, i)
        out[k] = v
    return out, i
