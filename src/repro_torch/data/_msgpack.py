"""The port's own msgpack codec, for the records of the live corpus.

`data.wal` frames its records and `data.live_corpus` writes its snapshots
as msgpack, the reference's on-disk format. The port does not depend on
the `msgpack` package: this module encodes and decodes the subset of the
format those records use, and nothing else:

  None, bool, int (positive / negative fixint, uint8-64, int8-64),
  float (float64, ``0xcb``), str (fixstr, str8/16/32), bytes (bin8/16/32),
  list and tuple (fixarray, array16/32) and dict (fixmap, map16/32).

`packb` writes the same bytes as ``msgpack.packb(obj, use_bin_type=True)``
(the smallest encoding of each value, floats as float64, dicts in
iteration order), and `unpackb` returns what ``msgpack.unpackb(buf,
raw=False)`` returns (arrays as lists, str map keys), so a corpus
directory written by either package opens in the other. Both raise on
anything outside the subset: `packb` a `TypeError` (or `OverflowError`
for an int outside 64 bits), `unpackb` a `ValueError` for a malformed,
truncated or over-long buffer or an unsupported type byte -- which is
what lets WAL replay treat an undecodable payload as a torn record.
"""
from __future__ import annotations

import struct

_U16, _U32, _U64 = struct.Struct(">H"), struct.Struct(">I"), struct.Struct(">Q")
_I8, _I16 = struct.Struct(">b"), struct.Struct(">h")
_I32, _I64 = struct.Struct(">i"), struct.Struct(">q")
_F64 = struct.Struct(">d")


def packb(obj) -> bytes:
    """Encode ``obj`` as msgpack (``use_bin_type=True`` layout)."""
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


def _pack_len(out: bytearray, n: int, fix_base: int, fix_max: int,
              codes: tuple) -> None:
    """Header of a str / bin / array / map of length ``n``: the fix form
    when ``n`` < ``fix_max`` (``fix_base`` | n), else the 8- (where the
    type has one), 16- or 32-bit length form."""
    c8, c16, c32 = codes
    if n < fix_max:
        out.append(fix_base | n)
    elif c8 is not None and n < 0x100:
        out += bytes((c8, n))
    elif n < 0x10000:
        out.append(c16)
        out += _U16.pack(n)
    elif n < 0x100000000:
        out.append(c32)
        out += _U32.pack(n)
    else:
        raise ValueError(f"msgpack length {n} exceeds 32 bits")


def _pack(obj, out: bytearray) -> None:
    if obj is None:
        out.append(0xC0)
    elif obj is True:
        out.append(0xC3)
    elif obj is False:
        out.append(0xC2)
    elif isinstance(obj, int):
        _pack_int(int(obj), out)
    elif isinstance(obj, float):
        out.append(0xCB)
        out += _F64.pack(obj)
    elif isinstance(obj, str):
        b = obj.encode("utf-8")
        _pack_len(out, len(b), 0xA0, 32, (0xD9, 0xDA, 0xDB))
        out += b
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        b = bytes(obj)
        _pack_len(out, len(b), 0, 0, (0xC4, 0xC5, 0xC6))
        out += b
    elif isinstance(obj, (list, tuple)):
        _pack_len(out, len(obj), 0x90, 16, (None, 0xDC, 0xDD))
        for x in obj:
            _pack(x, out)
    elif isinstance(obj, dict):
        _pack_len(out, len(obj), 0x80, 16, (None, 0xDE, 0xDF))
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"cannot msgpack-encode {type(obj).__name__}")


def _pack_int(x: int, out: bytearray) -> None:
    if 0 <= x < 0x80:
        out.append(x)
    elif -0x20 <= x < 0:
        out.append(x & 0xFF)
    elif 0 <= x <= 0xFF:
        out += bytes((0xCC, x))
    elif -0x80 <= x < 0:
        out.append(0xD0)
        out += _I8.pack(x)
    elif 0 <= x <= 0xFFFF:
        out.append(0xCD)
        out += _U16.pack(x)
    elif -0x8000 <= x < 0:
        out.append(0xD1)
        out += _I16.pack(x)
    elif 0 <= x <= 0xFFFFFFFF:
        out.append(0xCE)
        out += _U32.pack(x)
    elif -0x80000000 <= x < 0:
        out.append(0xD2)
        out += _I32.pack(x)
    elif 0 <= x <= 0xFFFFFFFFFFFFFFFF:
        out.append(0xCF)
        out += _U64.pack(x)
    elif -0x8000000000000000 <= x < 0:
        out.append(0xD3)
        out += _I64.pack(x)
    else:
        raise OverflowError(f"int {x} does not fit msgpack's 64 bits")


def unpackb(buf) -> object:
    """Decode one msgpack object that fills ``buf`` exactly."""
    buf = bytes(buf)
    try:
        obj, off = _unpack(buf, 0)
    except (IndexError, struct.error, RecursionError) as e:
        raise ValueError(f"malformed msgpack: {e}") from None
    if off != len(buf):
        raise ValueError(f"malformed msgpack: {len(buf) - off} bytes of "
                         f"extra data")
    return obj


# fixed-width scalars: type byte -> (struct, size)
_SCALARS = {0xCC: (struct.Struct(">B"), 1), 0xCD: (_U16, 2),
            0xCE: (_U32, 4), 0xCF: (_U64, 8), 0xD0: (_I8, 1),
            0xD1: (_I16, 2), 0xD2: (_I32, 4), 0xD3: (_I64, 8),
            0xCB: (_F64, 8)}
# variable-length headers: type byte -> (kind, length struct, size)
_SIZED = {0xD9: ("str", struct.Struct(">B"), 1), 0xDA: ("str", _U16, 2),
          0xDB: ("str", _U32, 4), 0xC4: ("bin", struct.Struct(">B"), 1),
          0xC5: ("bin", _U16, 2), 0xC6: ("bin", _U32, 4),
          0xDC: ("array", _U16, 2), 0xDD: ("array", _U32, 4),
          0xDE: ("map", _U16, 2), 0xDF: ("map", _U32, 4)}


def _take(buf: bytes, off: int, n: int) -> bytes:
    if off + n > len(buf):
        raise ValueError("malformed msgpack: truncated buffer")
    return buf[off:off + n]


def _unpack(buf: bytes, off: int):
    b = buf[off]
    off += 1
    if b < 0x80:
        return b, off
    if b >= 0xE0:
        return b - 0x100, off
    if b == 0xC0:
        return None, off
    if b == 0xC2:
        return False, off
    if b == 0xC3:
        return True, off
    if b in _SCALARS:
        st, n = _SCALARS[b]
        return st.unpack(_take(buf, off, n))[0], off + n
    if 0xA0 <= b < 0xC0:
        kind, n = "str", b & 0x1F
    elif 0x90 <= b < 0xA0:
        kind, n = "array", b & 0x0F
    elif 0x80 <= b < 0x90:
        kind, n = "map", b & 0x0F
    elif b in _SIZED:
        kind, st, size = _SIZED[b]
        n = st.unpack(_take(buf, off, size))[0]
        off += size
    else:
        raise ValueError(f"malformed msgpack: unsupported type byte "
                         f"0x{b:02x} at offset {off - 1}")
    if kind == "str":
        return _take(buf, off, n).decode("utf-8"), off + n
    if kind == "bin":
        return _take(buf, off, n), off + n
    if kind == "array":
        out = []
        for _ in range(n):
            x, off = _unpack(buf, off)
            out.append(x)
        return out, off
    d = {}
    for _ in range(n):
        k, off = _unpack(buf, off)
        if not isinstance(k, (str, bytes)):
            raise ValueError(f"malformed msgpack: {type(k).__name__} map "
                             f"key (str and bytes keys only)")
        d[k], off = _unpack(buf, off)
    return d, off
