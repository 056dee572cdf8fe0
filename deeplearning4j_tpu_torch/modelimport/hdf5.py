"""A read-only HDF5 reader with no dependency beyond ``struct``, ``zlib``
and numpy.

The JAX package reads Keras ``.h5`` files, and the ``model.weights.h5``
inside a ``.keras`` archive, through h5py (``modelimport/keras.py:958,
999-1097, 1136, 1153``). The card's machine has no h5py, so the port
reads the format itself, from the HDF5 File Format Specification
(version 3), as ``proto/wire.py`` reads protobuf. It offers the part of
h5py's surface the Keras importer uses and no more:

- :class:`File` (a path, the bytes of a file, or a binary file object),
  a context manager;
- :class:`Group`: ``g["a/b"]``, ``in``, ``keys()`` and ``len`` in h5py's
  order, ``.attrs[...]``, ``.attrs.get`` and ``.attrs.keys()``, and
  ``visititems(fn)`` in h5py's order (depth first, each group's links by
  name, each object once);
- :class:`Dataset`: ``shape``, ``dtype``, ``np.array(ds)`` and ``ds[()]``.

What it reads:

- superblocks 0 and 1, and 2 and 3 (their Jenkins lookup3 checksums
  checked);
- object headers v1, and v2 (``OHDR``/``OCHK``, checksums checked), with
  continuation blocks;
- groups in a symbol table (a v1 B-tree of node type 0 at any depth,
  ``SNOD`` nodes, the local ``HEAP``) and groups of compact link
  messages (hard links);
- datatypes: fixed-point (8 to 64 bits) and IEEE floating-point (16, 32
  and 64 bits), both byte orders; fixed-length strings; variable-length
  strings through the global heap (``GCOL``), scalar and array;
- dataspaces: scalar and simple;
- layouts: compact; contiguous, where an undefined address reads as the
  fill value; chunked under a v1 B-tree (node type 1), with the deflate
  (zlib) and shuffle filters, a chunk never written reading as the fill
  value.

Values come back as h5py gives them: numbers and fixed-length strings in
the file's dtype (its byte order kept), a variable-length string as
``str`` in an attribute and as ``bytes`` in a dataset (object arrays for
arrays), a scalar attribute as a numpy scalar.

What it does not read raises ``NotImplementedError`` naming the feature,
and it never returns wrong or partial data: dense link or attribute
storage (a fractal heap), layout version 4 chunk indices, virtual
layouts, filters other than deflate and shuffle, shared object header
messages, soft and external links, null dataspaces, variable-length
sequences, and the compound, enum, reference, array, bitfield, opaque and
time datatypes.
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np

__all__ = ["File", "Group", "Dataset", "AttributeManager", "lookup3"]

_SIGNATURE = b"\x89HDF\r\n\x1a\n"

# object header message types
_NIL, _DATASPACE, _LINK_INFO, _DATATYPE = 0x00, 0x01, 0x02, 0x03
_FILL_OLD, _FILL, _LINK, _LAYOUT = 0x04, 0x05, 0x06, 0x08
_FILTERS, _ATTRIBUTE, _CONTINUATION = 0x0B, 0x0C, 0x10
_SYMBOL_TABLE, _ATTRIBUTE_INFO = 0x11, 0x15

_FILTER_DEFLATE, _FILTER_SHUFFLE = 1, 2
_FILTER_NAMES = {3: "fletcher32", 4: "szip", 5: "nbit", 6: "scaleoffset",
                 32000: "lzf", 32001: "blosc", 32004: "lz4",
                 32008: "bitshuffle", 32015: "zstd"}
_TYPE_CLASSES = {2: "time", 4: "bitfield", 5: "opaque", 6: "compound",
                 7: "reference", 8: "enum", 10: "array"}


def _unsupported(feature: str) -> NotImplementedError:
    return NotImplementedError(
        f"HDF5: {feature} is not read by the port's reader "
        "(modelimport/hdf5.py)")


def _pad8(n: int) -> int:
    return (n + 7) & ~7


# ---------------------------------------------------------------------------
# Jenkins lookup3 (hashlittle), the checksum of superblocks 2/3 and of v2
# object headers
# ---------------------------------------------------------------------------

_M32 = 0xFFFFFFFF


def _rot(x: int, k: int) -> int:
    return ((x << k) | (x >> (32 - k))) & _M32


def lookup3(data: bytes, initval: int = 0) -> int:
    """Bob Jenkins' lookup3 ``hashlittle`` of ``data`` (HDF5's
    ``H5_checksum_lookup3``)."""
    n = len(data)
    a = b = c = (0xDEADBEEF + n + initval) & _M32
    k = bytes(data)
    off = 0
    while n > 12:
        a = (a + int.from_bytes(k[off:off + 4], "little")) & _M32
        b = (b + int.from_bytes(k[off + 4:off + 8], "little")) & _M32
        c = (c + int.from_bytes(k[off + 8:off + 12], "little")) & _M32
        a = (a - c) & _M32; a ^= _rot(c, 4); c = (c + b) & _M32
        b = (b - a) & _M32; b ^= _rot(a, 6); a = (a + c) & _M32
        c = (c - b) & _M32; c ^= _rot(b, 8); b = (b + a) & _M32
        a = (a - c) & _M32; a ^= _rot(c, 16); c = (c + b) & _M32
        b = (b - a) & _M32; b ^= _rot(a, 19); a = (a + c) & _M32
        c = (c - b) & _M32; c ^= _rot(b, 4); b = (b + a) & _M32
        n -= 12
        off += 12
    if n == 0:
        return c
    tail = k[off:off + n] + bytes(12 - n)
    a = (a + int.from_bytes(tail[0:4], "little")) & _M32
    b = (b + int.from_bytes(tail[4:8], "little")) & _M32
    c = (c + int.from_bytes(tail[8:12], "little")) & _M32
    c ^= b; c = (c - _rot(b, 14)) & _M32
    a ^= c; a = (a - _rot(c, 11)) & _M32
    b ^= a; b = (b - _rot(a, 25)) & _M32
    c ^= b; c = (c - _rot(b, 16)) & _M32
    a ^= c; a = (a - _rot(c, 4)) & _M32
    b ^= a; b = (b - _rot(a, 14)) & _M32
    c ^= b; c = (c - _rot(b, 24)) & _M32
    return c


# ---------------------------------------------------------------------------
# types and spaces
# ---------------------------------------------------------------------------

class _Type:
    """A parsed datatype: ``kind`` "num" (``dtype`` a numpy number dtype),
    "fstr" (``dtype`` ``S<n>``) or "vstr" (``size`` bytes an element in
    the file: a length, a global heap address and an index)."""

    def __init__(self, kind: str, dtype: np.dtype, size: int):
        self.kind, self.dtype, self.size = kind, dtype, size


def _float_dtype(size: int, order: str, props: tuple) -> np.dtype:
    bit_off, prec, exp_loc, exp_size, man_loc, man_size, bias = props
    ieee = {2: (16, 10, 5, 10, 0, 15), 4: (32, 23, 8, 23, 0, 127),
            8: (64, 52, 11, 52, 0, 1023)}
    want = ieee.get(size)
    if want is None or (prec, exp_loc, exp_size, man_size, man_loc, bias) \
            != want or bit_off:
        raise _unsupported(f"a {size}-byte floating-point type that is not "
                           "IEEE half, single or double")
    return np.dtype(f"{order}f{size}")


class _Reader:
    """The file's bytes and the superblock's parameters; parses objects."""

    def __init__(self, data: bytes):
        self.b = data
        sb = self._find_superblock()
        ver = data[sb + 8]
        if ver in (0, 1):
            self.O, self.L = data[sb + 13], data[sb + 14]
            pos = sb + (24 if ver == 0 else 28)
            base = self._uint(pos, self.O)
            # base, free-space info, end of file, driver info; then the
            # root group's symbol table entry
            pos += 4 * self.O
            self.base = base
            root = self._uint(pos + self.O, self.O)
        elif ver in (2, 3):
            self.O, self.L = data[sb + 9], data[sb + 10]
            pos = sb + 12
            base = self._uint(pos, self.O)
            root = self._uint(pos + 3 * self.O, self.O)
            end = pos + 4 * self.O
            (stored,) = struct.unpack_from("<I", data, end)
            if lookup3(data[sb:end]) != stored:
                raise ValueError("HDF5: superblock checksum mismatch")
            self.base = base
        else:
            raise _unsupported(f"superblock version {ver}")
        if self.O not in (2, 4, 8) or self.L not in (2, 4, 8):
            raise ValueError(f"HDF5: offset/length sizes {self.O}/{self.L}")
        self.undef = (1 << (8 * self.O)) - 1
        self.root = self.base + root
        self._headers: Dict[int, list] = {}
        self._heaps: Dict[int, Dict[int, bytes]] = {}

    def _find_superblock(self) -> int:
        off = 0
        while off + 8 <= len(self.b):
            if self.b[off:off + 8] == _SIGNATURE:
                return off
            off = 512 if off == 0 else off * 2
        raise ValueError("not an HDF5 file (no superblock signature)")

    # -- scalars -------------------------------------------------------------
    def _uint(self, off: int, size: int) -> int:
        return int.from_bytes(self.b[off:off + size], "little")

    def addr(self, off: int) -> Optional[int]:
        """The address stored at ``off`` as an absolute offset, or None
        where it is undefined."""
        v = self._uint(off, self.O)
        return None if v == self.undef else self.base + v

    def length(self, off: int) -> int:
        return self._uint(off, self.L)

    # -- object headers --------------------------------------------------------
    def header(self, addr: int) -> list:
        """The messages of the object header at ``addr``: ``[(type, flags,
        creation order or None, data offset, size)]``, continuation blocks
        followed, NIL messages dropped."""
        got = self._headers.get(addr)
        if got is None:
            if self.b[addr:addr + 4] == b"OHDR":
                got = self._header_v2(addr)
            elif self.b[addr] == 1:
                got = self._header_v1(addr)
            else:
                raise _unsupported(
                    f"object header version {self.b[addr]} at {addr}")
            for mtype, mflags, _, _, _ in got:
                if mflags & 0x02:
                    raise _unsupported(
                        f"shared object header messages (type {mtype:#x})")
            self._headers[addr] = got
        return got

    def _header_v1(self, addr: int) -> list:
        (size,) = struct.unpack_from("<I", self.b, addr + 8)
        blocks, msgs = [(addr + 16, addr + 16 + size)], []
        while blocks:
            pos, end = blocks.pop(0)
            while pos + 8 <= end:
                mtype, msize, mflags = struct.unpack_from("<HHB", self.b, pos)
                data = pos + 8
                if mtype == _CONTINUATION:
                    cont = self.addr(data)
                    blocks.append((cont, cont + self.length(data + self.O)))
                elif mtype != _NIL:
                    msgs.append((mtype, mflags, None, data, msize))
                pos = data + msize
        return msgs

    def _header_v2(self, addr: int) -> list:
        b = self.b
        if b[addr + 4] != 2:
            raise _unsupported(f"object header version {b[addr + 4]}")
        flags = b[addr + 5]
        pos = addr + 6 + (16 if flags & 0x20 else 0) + \
            (4 if flags & 0x10 else 0)
        width = 1 << (flags & 0x03)
        chunk0 = self._uint(pos, width)
        start = pos + width
        end = start + chunk0
        self._check_v2(addr, end, "object header")
        hsize = 6 if flags & 0x04 else 4
        blocks, msgs = [(start, end)], []
        while blocks:
            pos, end = blocks.pop(0)
            while pos + hsize <= end:
                mtype, msize, mflags = struct.unpack_from("<BHB", b, pos)
                crt = struct.unpack_from("<H", b, pos + 4)[0] \
                    if flags & 0x04 else None
                data = pos + hsize
                if mtype == _CONTINUATION:
                    cont = self.addr(data)
                    clen = self.length(data + self.O)
                    if b[cont:cont + 4] != b"OCHK":
                        raise ValueError("HDF5: continuation block without "
                                         "its OCHK signature")
                    self._check_v2(cont, cont + clen - 4, "continuation")
                    blocks.append((cont + 4, cont + clen - 4))
                elif mtype != _NIL:
                    msgs.append((mtype, mflags, crt, data, msize))
                pos = data + msize
        return msgs

    def _check_v2(self, start: int, end: int, what: str) -> None:
        (stored,) = struct.unpack_from("<I", self.b, end)
        if lookup3(self.b[start:end]) != stored:
            raise ValueError(f"HDF5: {what} checksum mismatch at {start}")

    @staticmethod
    def first(msgs: list, mtype: int):
        for m in msgs:
            if m[0] == mtype:
                return m
        return None

    # -- datatype / dataspace ------------------------------------------------
    def dtype(self, off: int) -> _Type:
        b = self.b
        cls, ver = b[off] & 0x0F, b[off] >> 4
        bits = b[off + 1] | (b[off + 2] << 8) | (b[off + 3] << 16)
        (size,) = struct.unpack_from("<I", b, off + 4)
        p = off + 8
        if cls == 0:  # fixed-point
            order = ">" if bits & 0x01 else "<"
            bit_off, prec = struct.unpack_from("<HH", b, p)
            if bit_off or prec != 8 * size or size not in (1, 2, 4, 8):
                raise _unsupported(f"a {prec}-bit fixed-point type at bit "
                                   f"offset {bit_off} in {size} bytes")
            kind = "i" if bits & 0x08 else "u"
            return _Type("num", np.dtype(f"{order}{kind}{size}"), size)
        if cls == 1:  # floating-point
            if bits & 0x40:
                raise _unsupported("VAX-order floating-point")
            order = ">" if bits & 0x01 else "<"
            props = struct.unpack_from("<HHBBBBI", b, p)
            return _Type("num", _float_dtype(size, order, props), size)
        if cls == 3:  # fixed-length string
            return _Type("fstr", np.dtype(f"S{size}"), size)
        if cls == 9:  # variable-length
            if bits & 0x0F != 1:
                raise _unsupported("variable-length sequences")
            return _Type("vstr", np.dtype(object), size)
        name = _TYPE_CLASSES.get(cls, f"class {cls}")
        raise _unsupported(f"the {name} datatype (version {ver})")

    def space(self, off: int) -> Tuple[int, ...]:
        b = self.b
        ver, rank, flags = b[off], b[off + 1], b[off + 2]
        if ver == 1:
            p = off + 8
        elif ver == 2:
            if b[off + 3] == 2:
                raise _unsupported("null dataspaces")
            p = off + 4
        else:
            raise _unsupported(f"dataspace version {ver}")
        return tuple(self.length(p + i * self.L) for i in range(rank))

    # -- element decoding --------------------------------------------------
    def decode(self, typ: _Type, raw, count: int, as_str: bool) -> np.ndarray:
        """``count`` elements of ``typ`` from ``raw`` as a flat array."""
        if typ.kind != "vstr":
            return np.frombuffer(raw, typ.dtype, count).copy()
        out = np.empty(count, dtype=object)
        raw = bytes(raw)
        for i in range(count):
            p = i * typ.size
            (n,) = struct.unpack_from("<I", raw, p)
            if n == 0:
                s = b""
            else:
                coll = self.base + int.from_bytes(
                    raw[p + 4:p + 4 + self.O], "little")
                (idx,) = struct.unpack_from("<I", raw, p + 4 + self.O)
                s = self._global(coll)[idx][:n]
            out[i] = s.decode("utf-8") if as_str else s
        return out

    def _global(self, addr: int) -> Dict[int, bytes]:
        """The objects of the global heap collection at ``addr``."""
        got = self._heaps.get(addr)
        if got is not None:
            return got
        b = self.b
        if b[addr:addr + 4] != b"GCOL":
            raise ValueError(f"HDF5: no global heap collection at {addr}")
        end = addr + self.length(addr + 8)
        pos, got = addr + 8 + self.L, {}
        while pos + 8 + self.L <= end:
            idx = struct.unpack_from("<H", b, pos)[0]
            if idx == 0:  # free space to the end of the collection
                break
            size = self.length(pos + 8)
            data = pos + 8 + self.L
            got[idx] = bytes(b[data:data + size])
            pos = data + _pad8(size)
        self._heaps[addr] = got
        return got

    # -- groups ----------------------------------------------------------------
    def links(self, msgs: list) -> List[Tuple[str, int]]:
        """A group's ``(name, object header address)`` links in h5py's
        order: by name, or by creation order where the group tracks it."""
        st = self.first(msgs, _SYMBOL_TABLE)
        if st is not None:
            _, _, _, off, _ = st
            out = self._symbol_table(self.addr(off), self.addr(off + self.O))
            return sorted(out, key=lambda kv: kv[0].encode())
        tracked = False
        li = self.first(msgs, _LINK_INFO)
        if li is not None:
            _, _, _, off, _ = li
            lflags = self.b[off + 1]
            tracked = bool(lflags & 0x01)
            p = off + 2 + (8 if lflags & 0x01 else 0)
            if self.addr(p) is not None:
                raise _unsupported("dense link storage (a fractal heap)")
        out = []
        for mtype, _, _, off, _ in msgs:
            if mtype == _LINK:
                out.append(self._link(off))
        if tracked and all(c is not None for _, _, c in out):
            out.sort(key=lambda t: t[2])
        else:
            out.sort(key=lambda t: t[0].encode())
        return [(n, a) for n, a, _ in out]

    def _link(self, off: int):
        b = self.b
        if b[off] != 1:
            raise _unsupported(f"link message version {b[off]}")
        flags = b[off + 1]
        p = off + 2
        ltype = 0
        if flags & 0x08:
            ltype = b[p]
            p += 1
        crt = None
        if flags & 0x04:
            crt = struct.unpack_from("<q", b, p)[0]
            p += 8
        if flags & 0x10:
            p += 1  # the name's character set
        width = 1 << (flags & 0x03)
        n = self._uint(p, width)
        p += width
        name = bytes(b[p:p + n]).decode("utf-8")
        p += n
        if ltype != 0:
            kind = {1: "soft", 64: "external"}.get(ltype, f"type {ltype}")
            raise _unsupported(f"{kind} links ({name!r})")
        return name, self.addr(p), crt

    def _symbol_table(self, btree: int, heap: int) -> List[Tuple[str, int]]:
        b = self.b
        if b[heap:heap + 4] != b"HEAP":
            raise ValueError(f"HDF5: no local heap at {heap}")
        names = self.addr(heap + 8 + 2 * self.L)
        out = []
        for snod in self._btree_leaves(btree, 0):
            if b[snod:snod + 4] != b"SNOD":
                raise ValueError(f"HDF5: no symbol table node at {snod}")
            (count,) = struct.unpack_from("<H", b, snod + 6)
            p = snod + 8
            for _ in range(count):
                name_off = self.length(p)
                obj = self.addr(p + self.O)
                s = names + name_off
                name = bytes(b[s:b.index(b"\0", s)]).decode("utf-8")
                (cache,) = struct.unpack_from("<I", b, p + 2 * self.O)
                if cache == 2 or obj is None:  # a symbolic link
                    raise _unsupported(f"soft links ({name!r})")
                out.append((name, obj))
                p += 2 * self.O + 24
        return out

    def _btree_leaves(self, addr: int, node_type: int, ndims: int = 0):
        """The level-0 children of a v1 B-tree, with each child's key for
        node type 1: ``[child]`` (type 0) or ``[(key offset, child)]``."""
        b = self.b
        if b[addr:addr + 4] != b"TREE":
            raise ValueError(f"HDF5: no v1 B-tree node at {addr}")
        if b[addr + 4] != node_type:
            raise ValueError(f"HDF5: B-tree node type {b[addr + 4]}, "
                             f"expected {node_type}")
        level = b[addr + 5]
        (entries,) = struct.unpack_from("<H", b, addr + 6)
        key = self.L if node_type == 0 else 8 + 8 * ndims
        p = addr + 8 + 2 * self.O
        out = []
        for _ in range(entries):
            child = self.addr(p + key)
            if level > 0:
                out += self._btree_leaves(child, node_type, ndims)
            else:
                out.append(child if node_type == 0 else (p, child))
            p += key + self.O
        return out

    # -- attributes ----------------------------------------------------------
    def attributes(self, msgs: list) -> Dict[str, tuple]:
        """``{name: (type, shape, data offset)}`` in h5py's order."""
        tracked = False
        ai = self.first(msgs, _ATTRIBUTE_INFO)
        if ai is not None:
            _, _, _, off, _ = ai
            aflags = self.b[off + 1]
            tracked = bool(aflags & 0x01)
            p = off + 2 + (2 if aflags & 0x01 else 0)
            if self.addr(p) is not None:
                raise _unsupported("dense attribute storage (a fractal heap)")
        found = []
        for mtype, _, crt, off, _ in msgs:
            if mtype == _ATTRIBUTE:
                found.append(self._attribute(off) + (crt,))
        if tracked and all(t[-1] is not None for t in found):
            found.sort(key=lambda t: t[-1])
        else:
            found.sort(key=lambda t: t[0].encode())
        return {name: (typ, shape, data)
                for name, typ, shape, data, _ in found}

    def _attribute(self, off: int):
        b = self.b
        ver = b[off]
        name_size, dt_size, ds_size = struct.unpack_from("<HHH", b, off + 2)
        if ver == 1:
            p = off + 8
            align = _pad8
        elif ver in (2, 3):
            if b[off + 1] & 0x03:
                raise _unsupported("shared attribute datatypes or "
                                   "dataspaces")
            p = off + (9 if ver == 3 else 8)
            align = int
        else:
            raise _unsupported(f"attribute message version {ver}")
        name = bytes(b[p:p + name_size]).rstrip(b"\0").decode("utf-8")
        p += align(name_size)
        typ = self.dtype(p)
        p += align(dt_size)
        shape = self.space(p)
        p += align(ds_size)
        return name, typ, shape, p


# ---------------------------------------------------------------------------
# the h5py-like objects
# ---------------------------------------------------------------------------

class AttributeManager:
    """An object's attributes (h5py's ``.attrs``), read on access."""

    def __init__(self, reader: _Reader, msgs: list):
        self._r = reader
        self._items = reader.attributes(msgs)

    def __getitem__(self, name: str):
        typ, shape, off = self._items[name]
        count = int(np.prod(shape)) if shape else 1
        raw = self._r.b[off:off + count * typ.size]
        arr = self._r.decode(typ, raw, count, as_str=True)
        if shape == ():
            return arr[0]
        return arr.reshape(shape)

    def get(self, name: str, default=None):
        return self[name] if name in self._items else default

    def keys(self):
        return list(self._items)


def _join(parent: str, name: str) -> str:
    return "/" + name if parent == "/" else f"{parent}/{name}"


class _Object:
    def __init__(self, reader: _Reader, name: str, addr: int):
        self._r = reader
        self.name = name
        self._addr = addr
        self._msgs = reader.header(addr)
        self._attrs = None

    @property
    def attrs(self) -> AttributeManager:
        if self._attrs is None:
            self._attrs = AttributeManager(self._r, self._msgs)
        return self._attrs


def _open(reader: _Reader, name: str, addr: int):
    msgs = reader.header(addr)
    if reader.first(msgs, _LAYOUT) is not None:
        return Dataset(reader, name, addr)
    if any(m[0] in (_SYMBOL_TABLE, _LINK_INFO, _LINK) for m in msgs):
        return Group(reader, name, addr)
    raise _unsupported(f"the object at {name!r} (neither a group nor a "
                       "dataset: a committed datatype?)")


class Group(_Object):
    """A group: its members by name in h5py's order."""

    @property
    def _links(self) -> List[Tuple[str, int]]:
        got = getattr(self, "_links_cache", None)
        if got is None:
            got = self._links_cache = self._r.links(self._msgs)
        return got

    def _child(self, name: str):
        for n, addr in self._links:
            if n == name:
                return _open(self._r, _join(self.name, n), addr)
        raise KeyError(f"{name!r} is not in HDF5 group {self.name!r}")

    def __getitem__(self, path: str):
        obj = self
        if path.startswith("/"):
            obj = File._root_of(self)
        for part in (p for p in path.split("/") if p and p != "."):
            if not isinstance(obj, Group):
                raise KeyError(f"{path!r}: {obj.name!r} is a dataset")
            obj = obj._child(part)
        return obj

    def __contains__(self, path) -> bool:
        try:
            self[path]
        except KeyError:
            return False
        return True

    def keys(self) -> List[str]:
        return [n for n, _ in self._links]

    def __len__(self) -> int:
        return len(self._links)

    def visititems(self, fn):
        """Call ``fn(name, obj)`` for every object below this group, depth
        first, each group's links by name, each object once (h5py's
        ``visititems``); a value other than None stops the walk and is
        returned."""
        seen = {self._addr}

        def walk(group: "Group", prefix: str):
            for n, addr in group._links:
                if addr in seen:
                    continue
                seen.add(addr)
                rel = f"{prefix}{n}"
                obj = _open(self._r, _join(group.name, n), addr)
                got = fn(rel, obj)
                if got is not None:
                    return got
                if isinstance(obj, Group):
                    got = walk(obj, rel + "/")
                    if got is not None:
                        return got
            return None

        return walk(self, "")

    def __repr__(self) -> str:
        return f"<HDF5 group {self.name!r} ({len(self)} members)>"


class Dataset(_Object):
    """A dataset: ``shape``, ``dtype``, and its values on ``np.array(ds)``
    or ``ds[()]``."""

    def __init__(self, reader: _Reader, name: str, addr: int):
        super().__init__(reader, name, addr)
        r, msgs = reader, self._msgs
        dt = r.first(msgs, _DATATYPE)
        ds = r.first(msgs, _DATASPACE)
        if dt is None or ds is None:
            raise ValueError(f"HDF5: dataset {name!r} lacks a datatype or "
                             "dataspace message")
        self._type = r.dtype(dt[3])
        self.shape = r.space(ds[3])
        self.dtype = self._type.dtype
        self._layout = r.first(msgs, _LAYOUT)[3]

    @property
    def size(self) -> int:
        return int(np.prod(self.shape)) if self.shape else 1

    def __array__(self, dtype=None, copy=None):
        a = self._read()
        return a if dtype is None else a.astype(dtype)

    def __getitem__(self, key):
        return self._read()[key]

    def __repr__(self) -> str:
        return (f"<HDF5 dataset {self.name!r}: shape {self.shape}, type "
                f"{self.dtype}>")

    # -- storage -------------------------------------------------------------
    def _fill(self) -> bytes:
        """One element of the fill value (zeros where none is defined)."""
        r, b = self._r, self._r.b
        m = r.first(self._msgs, _FILL)
        if m is not None:
            off = m[3]
            ver = b[off]
            size = 0
            if ver < 3:
                if b[off + 3]:
                    (size,) = struct.unpack_from("<i", b, off + 4)
                    p = off + 8
            else:
                if b[off + 1] & 0x20:
                    (size,) = struct.unpack_from("<i", b, off + 2)
                    p = off + 6
            if size > 0:
                if size != self._type.size:
                    raise ValueError(f"HDF5: fill value of {size} bytes for "
                                     f"{self._type.size}-byte elements")
                if self._type.kind == "vstr":
                    raise _unsupported("variable-length fill values")
                return bytes(b[p:p + size])
        else:
            m = r.first(self._msgs, _FILL_OLD)
            if m is not None:
                (size,) = struct.unpack_from("<I", b, m[3])
                if size:
                    if size != self._type.size or self._type.kind == "vstr":
                        raise _unsupported("this old-style fill value")
                    return bytes(b[m[3] + 4:m[3] + 4 + size])
        return bytes(self._type.size)

    def _filled(self, count: int) -> np.ndarray:
        return self._r.decode(self._type, self._fill() * count, count,
                              as_str=False)

    def _filters(self) -> list:
        """The filter pipeline: ``[(id, client data)]`` in order."""
        r, b = self._r, self._r.b
        m = r.first(self._msgs, _FILTERS)
        if m is None:
            return []
        off = m[3]
        ver, n = b[off], b[off + 1]
        p = off + (8 if ver == 1 else 2)
        out = []
        for _ in range(n):
            (fid,) = struct.unpack_from("<H", b, p)
            p += 2
            name_len = 0
            if ver == 1 or fid >= 256:
                (name_len,) = struct.unpack_from("<H", b, p)
                p += 2
            _flags, ncd = struct.unpack_from("<HH", b, p)
            p += 4
            p += _pad8(name_len) if ver == 1 else name_len
            cd = struct.unpack_from(f"<{ncd}I", b, p)
            p += 4 * ncd
            if ver == 1 and ncd % 2:
                p += 4
            if fid not in (_FILTER_DEFLATE, _FILTER_SHUFFLE):
                raise _unsupported(
                    f"the {_FILTER_NAMES.get(fid, 'unknown')} filter (id "
                    f"{fid})")
            out.append((fid, cd))
        return out

    def _read(self) -> np.ndarray:
        r, b = self._r, self._r.b
        count = self.size
        off = self._layout
        ver = b[off]
        if ver in (1, 2):
            ndims, cls = b[off + 1], b[off + 2]
            p = off + 8
            if cls == 0:
                p += 4 * ndims
                (size,) = struct.unpack_from("<I", b, p)
                return self._flat(b[p + 4:p + 4 + size], count)
            addr = r.addr(p)
            p += r.O
            dims = struct.unpack_from(f"<{ndims}I", b, p)
            if cls == 1:
                return self._contiguous(addr, count * self._type.size, count)
            if cls == 2:
                return self._chunked(addr, dims)
            raise _unsupported(f"layout class {cls}")
        if ver in (3, 4):
            cls = b[off + 1]
            p = off + 2
            if cls == 0:
                (size,) = struct.unpack_from("<H", b, p)
                return self._flat(b[p + 2:p + 2 + size], count)
            if cls == 1:
                return self._contiguous(r.addr(p), r.length(p + r.O), count)
            if cls == 2:
                if ver == 4:
                    raise _unsupported("layout version 4 chunk indices")
                ndims = b[p]
                addr = r.addr(p + 1)
                dims = struct.unpack_from(f"<{ndims}I", b, p + 1 + r.O)
                return self._chunked(addr, dims)
            if cls == 3:
                raise _unsupported("virtual dataset layouts")
            raise _unsupported(f"layout class {cls}")
        raise _unsupported(f"data layout message version {ver}")

    def _flat(self, raw, count: int) -> np.ndarray:
        need = count * self._type.size
        if len(raw) < need:
            raise ValueError(f"HDF5: {self.name!r} holds {len(raw)} bytes "
                             f"of {need}")
        return self._r.decode(self._type, raw[:need], count,
                              as_str=False).reshape(self.shape)

    def _contiguous(self, addr, size: int, count: int) -> np.ndarray:
        self._filters()  # a filter on contiguous storage would raise
        if addr is None:
            return self._filled(count).reshape(self.shape)
        need = count * self._type.size
        if size < need or addr + need > len(self._r.b):
            raise ValueError(f"HDF5: {self.name!r}: {size} bytes stored for "
                             f"{need}")
        return self._flat(self._r.b[addr:addr + need], count)

    def _chunked(self, addr, dims) -> np.ndarray:
        r, b = self._r, self._r.b
        chunk = tuple(int(d) for d in dims[:-1])
        if len(chunk) != len(self.shape) or dims[-1] != self._type.size:
            raise ValueError(f"HDF5: {self.name!r}: chunk dims {dims} for "
                             f"shape {self.shape}")
        filters = self._filters()
        out = self._filled(self.size).reshape(self.shape)
        if addr is None:
            return out
        per = int(np.prod(chunk))
        for key, child in r._btree_leaves(addr, 1, len(dims)):
            size, mask = struct.unpack_from("<II", b, key)
            offs = struct.unpack_from(f"<{len(dims)}Q", b, key + 8)[:-1]
            raw = bytes(b[child:child + size])
            for i in reversed(range(len(filters))):
                if mask & (1 << i):
                    continue
                fid, cd = filters[i]
                if fid == _FILTER_DEFLATE:
                    raw = zlib.decompress(raw)
                else:
                    raw = _unshuffle(raw, int(cd[0]) if cd
                                     else self._type.size)
            vals = r.decode(self._type, raw, per, as_str=False)
            vals = vals.reshape(chunk)
            dst = tuple(slice(o, min(o + c, s))
                        for o, c, s in zip(offs, chunk, self.shape))
            src = tuple(slice(0, d.stop - d.start) for d in dst)
            out[dst] = vals[src]
        return out


def _unshuffle(raw: bytes, esize: int) -> bytes:
    """Undo the shuffle filter: byte planes back to elements; a tail
    shorter than one element stays as it is."""
    n = len(raw) // esize
    if esize <= 1 or n <= 1:
        return raw
    body = np.frombuffer(raw, np.uint8, n * esize).reshape(esize, n)
    return body.T.tobytes() + raw[n * esize:]


class File(Group):
    """An HDF5 file opened for reading: ``File(path)``, ``File(bytes)`` or
    ``File(binary file object)``; the root group."""

    def __init__(self, source, mode: str = "r"):
        if mode != "r":
            raise ValueError("the port's HDF5 reader only reads (mode 'r')")
        if isinstance(source, (bytes, bytearray, memoryview)):
            data = bytes(source)
        elif hasattr(source, "read"):
            data = source.read()
        else:
            with open(os.fspath(source), "rb") as f:
                data = f.read()
        reader = _Reader(data)
        super().__init__(reader, "/", reader.root)

    @staticmethod
    def _root_of(obj: _Object) -> "Group":
        return Group(obj._r, "/", obj._r.root)

    def close(self) -> None:
        self._r = None

    def __enter__(self) -> "File":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
