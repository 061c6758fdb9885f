"""The msgpack subset that checkpoint payloads use, encoded and decoded
without the ``msgpack`` package.

A payload is a map of str keys whose values are arrays of maps, strs,
bins and non-negative ints (:mod:`repro_torch.checkpoint.checkpoint`).
:func:`packb` writes exactly the bytes that ``msgpack.packb(obj,
use_bin_type=True)`` writes for such an object: each value in the
smallest format that holds it (fix formats, then 8, 16 and 32 bit
lengths; ints as positive fixint or uint 8-64), and map entries in the
dict's order; it refuses any other value. :func:`unpackb` reads those
formats back (strs as ``str``, bins as ``bytes``, maps as ``dict``,
arrays as ``list``) and raises ``ValueError`` on any other type byte.
"""
from __future__ import annotations

import struct

_U8, _U16, _U32, _U64 = (struct.Struct(f">{c}") for c in "BHIQ")
# uint formats by type byte, smallest first
_UINTS = ((0xCC, _U8), (0xCD, _U16), (0xCE, _U32), (0xCF, _U64))


def _pack_len(out: bytearray, n: int, fix_base: int, fix_max: int,
              codes: tuple) -> None:
    """A length header: fix form up to ``fix_max``, then the 8 (when
    ``codes`` has three entries), 16 and 32 bit forms."""
    if n <= fix_max:
        out.append(fix_base | n)
        return
    for code, (_, fmt) in zip(codes, _UINTS[-1 - len(codes):-1]):
        if n < 1 << (8 * fmt.size):
            out.append(code)
            out += fmt.pack(n)
            return
    raise ValueError(f"length {n} does not fit msgpack's 32 bits")


def _pack_int(out: bytearray, v: int) -> None:
    if v < 0:
        raise ValueError(f"the checkpoint codec packs no negative int: {v}")
    if v <= 0x7F:
        out.append(v)
        return
    for code, fmt in _UINTS:
        if v < 1 << (8 * fmt.size):
            out.append(code)
            out += fmt.pack(v)
            return
    raise ValueError(f"int {v} does not fit msgpack's 64 bits")


def _pack(out: bytearray, obj) -> None:
    if isinstance(obj, int) and not isinstance(obj, bool):
        _pack_int(out, obj)
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        _pack_len(out, len(raw), 0xA0, 31, (0xD9, 0xDA, 0xDB))
        out += raw
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        raw = memoryview(obj).cast("B")
        _pack_len(out, raw.nbytes, 0, -1, (0xC4, 0xC5, 0xC6))
        out += raw
    elif isinstance(obj, dict):
        _pack_len(out, len(obj), 0x80, 15, (0xDE, 0xDF))
        for k, v in obj.items():
            _pack(out, k)
            _pack(out, v)
    elif isinstance(obj, (list, tuple)):
        _pack_len(out, len(obj), 0x90, 15, (0xDC, 0xDD))
        for v in obj:
            _pack(out, v)
    else:
        raise TypeError(f"cannot pack {type(obj).__name__}: the checkpoint "
                        "codec takes maps, arrays, str, bytes and "
                        "non-negative ints")


def packb(obj) -> bytes:
    """``msgpack.packb(obj, use_bin_type=True)`` for the subset above."""
    out = bytearray()
    _pack(out, obj)
    return bytes(out)


class _Reader:
    def __init__(self, data):
        self.buf = memoryview(data).cast("B")
        self.pos = 0

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.buf):
            raise ValueError("truncated msgpack payload")
        view = self.buf[self.pos:end]
        self.pos = end
        return view

    def num(self, fmt: struct.Struct) -> int:
        return fmt.unpack(self.take(fmt.size))[0]

    def read(self):
        b = self.num(_U8)
        if b <= 0x7F:
            return b
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.read() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return str(self.take(b & 0x1F), "utf-8")
        kind, fmt = _CODES.get(b, (None, None))
        if kind is None:
            raise ValueError(f"msgpack type byte 0x{b:02x} is not in the "
                             "checkpoint codec's subset")
        n = self.num(fmt)
        if kind == "int":
            return n
        if kind == "str":
            return str(self.take(n), "utf-8")
        if kind == "bin":
            return bytes(self.take(n))
        if kind == "map":
            return self.map(n)
        return [self.read() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.read()
            out[k] = self.read()
        return out


_CODES = {**{code: ("int", fmt) for code, fmt in _UINTS},
          0xD9: ("str", _U8), 0xDA: ("str", _U16), 0xDB: ("str", _U32),
          0xC4: ("bin", _U8), 0xC5: ("bin", _U16), 0xC6: ("bin", _U32),
          0xDC: ("array", _U16), 0xDD: ("array", _U32),
          0xDE: ("map", _U16), 0xDF: ("map", _U32)}


def unpackb(data):
    """``msgpack.unpackb(data, raw=False)`` for the subset above; the
    whole buffer must be one object."""
    r = _Reader(data)
    obj = r.read()
    if r.pos != len(r.buf):
        raise ValueError(f"{len(r.buf) - r.pos} bytes after the msgpack "
                         "object")
    return obj
