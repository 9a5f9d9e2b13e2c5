"""The subset of MessagePack that checkpoint bundles use: maps, str, bin
and non-negative ints.

``packb`` writes what ``msgpack.packb(obj, use_bin_type=True)`` writes
for such values, byte for byte (each with the smallest header that fits,
map entries in insertion order); ``unpackb`` reads them back as
``msgpack.unpackb(data, raw=False)`` does. The port carries this instead
of importing ``msgpack``, which the GPU machine does not have.
"""

from __future__ import annotations

from typing import Any, Tuple

# type byte -> (kind, bytes of the big-endian length or value after it)
_SIZED = {0xC4: ("bin", 1), 0xC5: ("bin", 2), 0xC6: ("bin", 4),
          0xD9: ("str", 1), 0xDA: ("str", 2), 0xDB: ("str", 4),
          0xDE: ("map", 2), 0xDF: ("map", 4),
          0xCC: ("int", 1), 0xCD: ("int", 2), 0xCE: ("int", 4), 0xCF: ("int", 8)}
# kind -> (fixed-form type byte or None, the largest n it holds)
_FIXED = {"map": (0x80, 0x0F), "str": (0xA0, 0x1F), "bin": (None, -1), "int": (0x00, 0x7F)}


def _header(out: bytearray, kind: str, n: int) -> None:
    """The smallest header of ``kind`` for a length (an int's value) ``n``."""
    fix, fix_max = _FIXED[kind]
    if n <= fix_max:
        out.append(fix | n)
        return
    for code, (k, width) in _SIZED.items():
        if k == kind and n < 1 << (8 * width):
            out.append(code)
            out += n.to_bytes(width, "big")
            return
    raise ValueError(f"msgpack: {kind} of {n} does not fit")


def _pack(obj: Any, out: bytearray) -> None:
    if isinstance(obj, dict):
        _header(out, "map", len(obj))
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    elif isinstance(obj, str):
        b = obj.encode("utf-8")
        _header(out, "str", len(b))
        out += b
    elif isinstance(obj, (bytes, bytearray)):
        _header(out, "bin", len(obj))
        out += obj
    elif isinstance(obj, int) and not isinstance(obj, bool) and obj >= 0:
        _header(out, "int", obj)
    else:
        raise TypeError(f"msgpack subset: cannot pack {type(obj).__name__}")


def packb(obj: Any) -> bytes:
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


def _unpack(buf: memoryview, pos: int) -> Tuple[Any, int]:
    code = buf[pos]
    pos += 1
    if code <= 0x7F:
        return code, pos
    if 0x80 <= code <= 0x8F:
        kind, n = "map", code & 0x0F
    elif 0xA0 <= code <= 0xBF:
        kind, n = "str", code & 0x1F
    elif code in _SIZED:
        kind, width = _SIZED[code]
        n = int.from_bytes(buf[pos:pos + width], "big")
        pos += width
    else:
        raise ValueError(f"msgpack subset: unsupported type byte 0x{code:02x} "
                         f"at offset {pos - 1}")
    if kind == "int":
        return n, pos
    if kind == "map":
        out = {}
        for _ in range(n):
            k, pos = _unpack(buf, pos)
            out[k], pos = _unpack(buf, pos)
        return out, pos
    if pos + n > len(buf):
        raise ValueError("msgpack: truncated data")
    raw = bytes(buf[pos:pos + n])
    return (raw if kind == "bin" else raw.decode("utf-8")), pos + n


def unpackb(data: bytes) -> Any:
    obj, pos = _unpack(memoryview(data), 0)
    if pos != len(data):
        raise ValueError(f"msgpack: {len(data) - pos} trailing bytes")
    return obj
