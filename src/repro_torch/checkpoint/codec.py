"""The subset of MessagePack that checkpoints use, written and read here
so the port needs no `msgpack` package.

`pack` writes int, str, bin (bytes, bytearray, memoryview), arrays
(list, tuple) and maps (dict, in its order) with the shortest header for
each, as `msgpack.packb(obj, use_bin_type=True)` does, so both write the
same bytes for the same object.  `unpackb` reads those, returning str for
str and memoryviews for bin, as `msgpack.unpackb(data, raw=False)`
returns str and bytes; any other MessagePack type raises.
"""
from __future__ import annotations

import struct
from typing import Any, Callable

_U8, _U16, _U32, _U64 = (struct.Struct(f) for f in (">B", ">H", ">I", ">Q"))
_I8, _I16, _I32, _I64 = (struct.Struct(f) for f in (">b", ">h", ">i", ">q"))


def _int(x: int) -> bytes:
    if 0 <= x < 0x80:
        return bytes((x,))
    if -32 <= x < 0:
        return _I8.pack(x)  # negative fixint: the byte itself
    if x > 0:
        forms = ((0xFF, b"\xcc", _U8), (0xFFFF, b"\xcd", _U16),
                 (0xFFFFFFFF, b"\xce", _U32),
                 (0xFFFFFFFFFFFFFFFF, b"\xcf", _U64))
        for limit, code, fmt in forms:
            if x <= limit:
                return code + fmt.pack(x)
    else:
        forms = ((-0x80, b"\xd0", _I8), (-0x8000, b"\xd1", _I16),
                 (-0x80000000, b"\xd2", _I32),
                 (-0x8000000000000000, b"\xd3", _I64))
        for limit, code, fmt in forms:
            if x >= limit:
                return code + fmt.pack(x)
    raise OverflowError(f"integer {x} does not fit MessagePack's 64 bits")


def _header(n: int, small_base: int, small_max: int, codes: tuple) -> bytes:
    """The length header of a str, bin, array or map of n items: a fixed
    form below small_max (small_base | n) where the kind has one, else
    the first of the 8-, 16- and 32-bit forms that holds n."""
    if small_base is not None and n < small_max:
        return bytes((small_base | n,))
    for code, fmt, limit in zip(codes, (_U8, _U16, _U32),
                                (0xFF, 0xFFFF, 0xFFFFFFFF)):
        if code is not None and n <= limit:
            return bytes((code,)) + fmt.pack(n)
    raise ValueError(f"length {n} exceeds MessagePack's 32 bits")


def pack(obj: Any, write: Callable[[bytes], Any]) -> None:
    """Write `obj` through `write` (a file's `write`), piece by piece: a
    bin's bytes go to `write` as they are, uncopied."""
    if isinstance(obj, int) and not isinstance(obj, bool):
        write(_int(obj))
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        write(_header(len(data), 0xA0, 32, (0xD9, 0xDA, 0xDB)))
        write(data)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        n = memoryview(obj).nbytes
        write(_header(n, None, 0, (0xC4, 0xC5, 0xC6)))
        write(obj)
    elif isinstance(obj, (list, tuple)):
        write(_header(len(obj), 0x90, 16, (None, 0xDC, 0xDD)))
        for item in obj:
            pack(item, write)
    elif isinstance(obj, dict):
        write(_header(len(obj), 0x80, 16, (None, 0xDE, 0xDF)))
        for k, v in obj.items():
            pack(k, write)
            pack(v, write)
    else:
        raise TypeError(f"cannot pack {type(obj).__name__}")


def packb(obj: Any) -> bytes:
    parts: list[bytes] = []
    pack(obj, parts.append)
    return b"".join(bytes(p) for p in parts)


# fixed-width codes: (struct, kind) with kind "int", "str", "bin",
# "array" or "map" (the last four read a length)
_FIXED = {
    0xCC: (_U8, "int"), 0xCD: (_U16, "int"), 0xCE: (_U32, "int"),
    0xCF: (_U64, "int"), 0xD0: (_I8, "int"), 0xD1: (_I16, "int"),
    0xD2: (_I32, "int"), 0xD3: (_I64, "int"),
    0xD9: (_U8, "str"), 0xDA: (_U16, "str"), 0xDB: (_U32, "str"),
    0xC4: (_U8, "bin"), 0xC5: (_U16, "bin"), 0xC6: (_U32, "bin"),
    0xDC: (_U16, "array"), 0xDD: (_U32, "array"),
    0xDE: (_U16, "map"), 0xDF: (_U32, "map"),
}


def unpackb(data) -> Any:
    """The one object `data` holds; bin values are memoryviews of it."""
    buf = memoryview(data)
    obj, end = _read(buf, 0)
    if end != len(buf):
        raise ValueError(f"{len(buf) - end} bytes after the object")
    return obj


def _read(buf: memoryview, i: int) -> tuple[Any, int]:
    code = buf[i]
    i += 1
    if code < 0x80:
        return code, i
    if code >= 0xE0:
        return code - 0x100, i
    if code <= 0x8F:
        return _read_map(buf, i, code & 0x0F)
    if code <= 0x9F:
        return _read_array(buf, i, code & 0x0F)
    if code <= 0xBF:
        return _read_str(buf, i, code & 0x1F)
    if code not in _FIXED:
        raise ValueError(f"unsupported MessagePack code 0x{code:02x}")
    fmt, kind = _FIXED[code]
    (value,) = fmt.unpack_from(buf, i)
    i += fmt.size
    if kind == "int":
        return value, i
    if kind == "str":
        return _read_str(buf, i, value)
    if kind == "bin":
        if i + value > len(buf):
            raise ValueError("truncated bin")
        return buf[i:i + value], i + value
    if kind == "array":
        return _read_array(buf, i, value)
    return _read_map(buf, i, value)


def _read_str(buf: memoryview, i: int, n: int) -> tuple[str, int]:
    if i + n > len(buf):
        raise ValueError("truncated str")
    return str(buf[i:i + n], "utf-8"), i + n


def _read_array(buf: memoryview, i: int, n: int) -> tuple[list, int]:
    out = []
    for _ in range(n):
        item, i = _read(buf, i)
        out.append(item)
    return out, i


def _read_map(buf: memoryview, i: int, n: int) -> tuple[dict, int]:
    out = {}
    for _ in range(n):
        k, i = _read(buf, i)
        v, i = _read(buf, i)
        out[k] = v
    return out, i
