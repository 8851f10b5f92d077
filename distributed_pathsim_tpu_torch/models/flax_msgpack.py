"""Flax's msgpack state-dict encoding, read and written without flax.

``flax.serialization.to_bytes`` stores a pytree's state dict as one
msgpack document: nested maps with string keys, and every array leaf as
msgpack ext type 1 whose payload is itself a msgpack array ``[shape,
dtype name, row-major bytes]`` (a numpy scalar is ext type 3 with the
same payload). NeuralPathSim checkpoints hold their tower parameters and
optimizer state in that form. The card machine has neither flax nor the
``msgpack`` package, so this module is a small msgpack codec of its own:

- :func:`packb` writes what ``flax.serialization.msgpack_serialize``
  writes for a tree of dicts, strings, ints, floats, bools, None, bytes
  and numpy arrays — byte for byte, keys in the dict's own order
  (flax restores by key, so order is not part of the contract);
- :func:`unpackb` reads any such document (and every other msgpack
  type: arrays come back as lists) into dicts and numpy arrays,
  refusing an ext type other than 1 and 3 by name.

Arrays past flax's 1 GiB chunking threshold are refused: no state dict
this package writes comes near it.
"""

from __future__ import annotations

import struct

import numpy as np

EXT_NDARRAY = 1
EXT_NPSCALAR = 3
_EXT_NAMES = {1: "ndarray", 2: "native_complex", 3: "npscalar"}
# flax.serialization.MAX_CHUNK_SIZE: larger leaves are written chunked
_MAX_LEAF_BYTES = 2**30


# -- writing ---------------------------------------------------------------


def _pack_int(x: int, out: bytearray) -> None:
    if 0 <= x < 0x80:
        out.append(x)
    elif 0 <= x:
        for tag, fmt, lim in ((0xCC, ">B", 1 << 8), (0xCD, ">H", 1 << 16),
                              (0xCE, ">I", 1 << 32), (0xCF, ">Q", 1 << 64)):
            if x < lim:
                out.append(tag)
                out += struct.pack(fmt, x)
                return
        raise OverflowError(f"int {x} does not fit msgpack's uint64")
    elif x >= -32:
        out += struct.pack(">b", x)
    else:
        for tag, fmt, lim in ((0xD0, ">b", 1 << 7), (0xD1, ">h", 1 << 15),
                              (0xD2, ">i", 1 << 31), (0xD3, ">q", 1 << 63)):
            if x >= -lim:
                out.append(tag)
                out += struct.pack(fmt, x)
                return
        raise OverflowError(f"int {x} does not fit msgpack's int64")


def _pack_len(n: int, out: bytearray, fix: int | None, fix_max: int,
              tags: tuple[int, int, int]) -> None:
    """A length header: the fix form below ``fix_max``, else 8/16/32-bit
    (a tag of 0 means the format has no such width)."""
    if fix is not None and n < fix_max:
        out.append(fix | n)
        return
    for tag, fmt, lim in zip(tags, (">B", ">H", ">I"),
                             (1 << 8, 1 << 16, 1 << 32)):
        if tag and n < lim:
            out.append(tag)
            out += struct.pack(fmt, n)
            return
    raise ValueError(f"msgpack object of length {n} is too long")


def _pack_ext(code: int, data: bytes, out: bytearray) -> None:
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if len(data) in fixed:
        out.append(fixed[len(data)])
    else:
        _pack_len(len(data), out, None, 0, (0xC7, 0xC8, 0xC9))
    out += struct.pack(">b", code)
    out += data


def _ndarray_payload(arr: np.ndarray) -> bytes:
    """flax's ``_ndarray_to_bytes``: msgpack of (shape, dtype name,
    C-order bytes)."""
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes cannot be stored")
    if arr.nbytes > _MAX_LEAF_BYTES:
        raise ValueError(
            f"array of {arr.nbytes} bytes is past flax's chunking "
            "threshold; this codec writes unchunked leaves only"
        )
    return packb((list(arr.shape), arr.dtype.name, arr.tobytes("C")))


def _pack(obj, out: bytearray) -> None:
    # exact types first: flax packs with strict_types, so a numpy scalar
    # (a float subclass for float64) takes the ext path, never float
    t = type(obj)
    if obj is None:
        out.append(0xC0)
    elif t is bool:
        out.append(0xC3 if obj else 0xC2)
    elif t is int:
        _pack_int(obj, out)
    elif t is float:
        out.append(0xCB)
        out += struct.pack(">d", obj)
    elif t is str:
        raw = obj.encode("utf-8")
        _pack_len(len(raw), out, 0xA0, 32, (0xD9, 0xDA, 0xDB))
        out += raw
    elif t in (bytes, bytearray, memoryview):
        raw = bytes(obj)
        _pack_len(len(raw), out, None, 0, (0xC4, 0xC5, 0xC6))
        out += raw
    elif t in (list, tuple):
        _pack_len(len(obj), out, 0x90, 16, (0, 0xDC, 0xDD))
        for item in obj:
            _pack(item, out)
    elif t is dict:
        _pack_len(len(obj), out, 0x80, 16, (0, 0xDE, 0xDF))
        for key, value in obj.items():
            _pack(key, out)
            _pack(value, out)
    elif isinstance(obj, np.ndarray):
        _pack_ext(EXT_NDARRAY, _ndarray_payload(obj), out)
    elif isinstance(obj, np.generic):
        _pack_ext(EXT_NPSCALAR, _ndarray_payload(np.asarray(obj)), out)
    else:
        raise TypeError(f"cannot msgpack-encode {t.__name__}")


def packb(obj) -> bytes:
    """msgpack bytes of ``obj``: what flax's ``msgpack_serialize`` writes
    for a state dict (tuples, inside an array payload only, as arrays)."""
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


# -- reading ---------------------------------------------------------------


class _Reader:
    def __init__(self, data: bytes, raw: bool = False):
        self.data = memoryview(data)
        self.pos = 0
        self.raw = raw

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack document")
        chunk = self.data[self.pos:self.pos + n]
        self.pos += n
        return chunk

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def text(self, n: int):
        raw = bytes(self.take(n))
        return raw if self.raw else raw.decode("utf-8")

    def ext(self, n: int):
        code = self.unpack(">b")
        data = bytes(self.take(n))
        if code == EXT_NDARRAY:
            return _ndarray_from_payload(data)
        if code == EXT_NPSCALAR:
            return _ndarray_from_payload(data)[()]
        name = _EXT_NAMES.get(code, "unknown")
        raise ValueError(
            f"unsupported msgpack ext type {code} ({name}); flax state "
            "dicts here hold ndarray (1) and npscalar (3) leaves only"
        )

    def items(self, n: int) -> list:
        return [self.read() for _ in range(n)]

    def mapping(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.read()
            out[key] = self.read()
        return out

    def read(self):
        b = self.unpack(">B")
        if b < 0x80:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.mapping(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.items(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self.text(b & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        sized = {
            0xC4: (">B", "bin"), 0xC5: (">H", "bin"), 0xC6: (">I", "bin"),
            0xC7: (">B", "ext"), 0xC8: (">H", "ext"), 0xC9: (">I", "ext"),
            0xD9: (">B", "str"), 0xDA: (">H", "str"), 0xDB: (">I", "str"),
            0xDC: (">H", "array"), 0xDD: (">I", "array"),
            0xDE: (">H", "map"), 0xDF: (">I", "map"),
        }
        if b in sized:
            fmt, kind = sized[b]
            n = self.unpack(fmt)
            if kind == "bin":
                return bytes(self.take(n))
            if kind == "ext":
                return self.ext(n)
            if kind == "str":
                return self.text(n)
            if kind == "array":
                return self.items(n)
            return self.mapping(n)
        scalars = {
            0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
            0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q",
        }
        if b in scalars:
            return self.unpack(scalars[b])
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if b in fixext:
            return self.ext(fixext[b])
        raise ValueError(f"invalid msgpack type byte 0x{b:02x}")


def _ndarray_from_payload(data: bytes) -> np.ndarray:
    """flax's ``_ndarray_from_bytes``: a read-only array over the
    payload's bytes."""
    shape, dtype_name, buffer = unpackb(data, raw=True)
    if dtype_name == b"bfloat16":
        raise ValueError("bfloat16 leaves need ml_dtypes; not supported")
    return np.frombuffer(
        buffer, dtype=np.dtype(dtype_name.decode()), count=-1, offset=0
    ).reshape(shape, order="C")


def unpackb(data: bytes, raw: bool = False):
    """The object of one msgpack document (``raw``: strings as bytes).
    Trailing bytes are an error."""
    reader = _Reader(data, raw=raw)
    obj = reader.read()
    if reader.pos != len(reader.data):
        raise ValueError(
            f"{len(reader.data) - reader.pos} bytes after the msgpack "
            "document"
        )
    if isinstance(obj, dict) and "__msgpack_chunked_array__" in obj:
        raise ValueError("chunked flax arrays are not supported")
    return obj
