"""Reader and writer of the HDF5 files hloc and ``h5py`` make, in numpy and
``struct`` only (the card's machine has no ``h5py``).

The API is the small part of ``h5py``'s that the feature and match stores
use: ``File(path, mode)`` with modes ``"r"``, ``"w"`` and ``"a"`` (a
context manager), ``Group`` and ``Dataset`` objects with ``.name`` and
``.parent``, ``f["a/b/c"]``, ``name in group``, ``keys()``,
``visititems``, ``create_group``, ``create_dataset(name, data=...)``,
``ds[()]`` and ``.attrs``.

Reading covers both layouts that occur in practice:

- ``h5py``'s default (``libver="earliest"``): superblock v0 / v1, version 1
  object headers with continuation blocks, symbol-table groups (a version 1
  B-tree of type 0, any depth, ``SNOD`` nodes and a local heap);
- ``libver="latest"``, which hloc writes: superblock v2 / v3, version 2
  ``OHDR`` / ``OCHK`` object headers, compact link messages and, above 8
  links, dense link storage (the link-info message, a fractal heap of
  direct and indirect blocks, and its version 2 B-tree of type 5).

Datasets: little-endian fixed-point (8 to 64 bits, signed or not) and IEEE
f16 / f32 / f64; scalar and simple dataspaces; contiguous (an undefined
address is an empty dataset) and compact layouts. Attributes of numeric
type stored in the object header are read into ``.attrs``; other messages
are skipped by their length. Chunked or filtered datasets, external
storage, variable-length, string and big-endian types, soft and external
links, and densely stored attributes raise ``NotImplementedError`` naming
what was found and the file. Checksums are not verified.

A member is found by a search down its group's B-tree (by name in a
symbol table, by the name's lookup3 hash in dense storage), so opening
``f["a/b"]`` does not list the group; ``keys``, ``len`` and
``visititems`` list it.

Writing produces superblock v0 with symbol-table groups (what ``h5py``
writes by default): every member of a group sits in ``SNOD`` nodes of 8
under a version 1 B-tree of as many levels as the group needs, so a group
holds any number of members. The file is written into a temporary file
beside it: a dataset's bytes when ``create_dataset`` is called (only its
name, type, shape and address stay in memory), the groups' metadata and
the superblock on close, and then the temporary file replaces the file.
Mode ``"a"`` reads the existing file (either layout) and copies its
datasets over, one at a time, on close.
"""

from __future__ import annotations

import mmap
import os
import struct
import tempfile
from typing import Callable, Dict, List, Optional

import numpy as np

SIGNATURE = b"\x89HDF\r\n\x1a\n"
UNDEF = 0xFFFFFFFFFFFFFFFF
LEAF_K, INTERNAL_K = 4, 16  # h5py's defaults: 8 symbols an SNOD, 32 children a B-tree node

# message types
DATASPACE, LINK_INFO, DATATYPE, FILL, LINK, EXTERNAL, LAYOUT = 1, 2, 3, 5, 6, 7, 8
FILTERS, ATTRIBUTE, CONTINUATION, SYMBOL_TABLE, ATTRIBUTE_INFO = 11, 12, 16, 17, 21

_FLOATS = {  # size -> (sign location, exponent location, exponent size, mantissa size, bias)
    2: (15, 10, 5, 10, 15),
    4: (31, 23, 8, 23, 127),
    8: (63, 52, 11, 52, 1023),
}


def _uint(buf, off: int, n: int) -> int:
    return int.from_bytes(buf[off:off + n], "little")


def lookup3(key: bytes, initval: int = 0) -> int:
    """Bob Jenkins' lookup3 ``hashlittle``, as HDF5's
    ``H5_checksum_lookup3``: the hash that keys a dense group's name index."""
    M = 0xFFFFFFFF

    def rot(x, k):
        return ((x << k) | (x >> (32 - k))) & M

    n = len(key)
    a = b = c = (0xDEADBEEF + n + initval) & M
    p = 0
    while n > 12:
        a = (a + int.from_bytes(key[p:p + 4], "little")) & M
        b = (b + int.from_bytes(key[p + 4:p + 8], "little")) & M
        c = (c + int.from_bytes(key[p + 8:p + 12], "little")) & M
        a = ((a - c) & M) ^ rot(c, 4); c = (c + b) & M  # noqa: E702
        b = ((b - a) & M) ^ rot(a, 6); a = (a + c) & M  # noqa: E702
        c = ((c - b) & M) ^ rot(b, 8); b = (b + a) & M  # noqa: E702
        a = ((a - c) & M) ^ rot(c, 16); c = (c + b) & M  # noqa: E702
        b = ((b - a) & M) ^ rot(a, 19); a = (a + c) & M  # noqa: E702
        c = ((c - b) & M) ^ rot(b, 4); b = (b + a) & M  # noqa: E702
        n -= 12
        p += 12
    if n == 0:
        return c
    tail = key[p:] + bytes(12 - n)
    a = (a + int.from_bytes(tail[0:4], "little")) & M
    b = (b + int.from_bytes(tail[4:8], "little")) & M
    c = (c + int.from_bytes(tail[8:12], "little")) & M
    c = (c ^ b) - rot(b, 14) & M
    a = (a ^ c) - rot(c, 11) & M
    b = (b ^ a) - rot(a, 25) & M
    c = (c ^ b) - rot(b, 16) & M
    a = (a ^ c) - rot(c, 4) & M
    b = (b ^ a) - rot(a, 14) & M
    c = (c ^ b) - rot(b, 24) & M
    return c


# --------------------------------------------------------------------------
# reading
# --------------------------------------------------------------------------


class _Reader:
    """An HDF5 file mapped read-only, with the superblock's sizes."""

    def __init__(self, path: str):
        self.path = path
        self._fh = open(path, "rb")
        self.buf = b = mmap.mmap(self._fh.fileno(), 0, access=mmap.ACCESS_READ)
        if b[:8] != SIGNATURE:
            self.close()
            raise ValueError(f"{path}: no HDF5 superblock at the start of the file")
        version = b[8]
        if version in (0, 1):
            self.so, self.sl = b[13], b[14]
            # four addresses (base, free space, end of file and the file
            # layer's info block), then the root symbol table entry: link
            # name offset, object header
            p = 24 + (4 if version == 1 else 0) + 4 * self.so
            self.root = _uint(b, p + self.so, self.so)
        elif version in (2, 3):
            self.so, self.sl = b[9], b[10]
            self.root = _uint(b, 12 + 3 * self.so, self.so)
        else:
            self.close()
            raise NotImplementedError(f"{path}: superblock version {version}")

    @property
    def undef(self) -> int:
        return (1 << (8 * self.so)) - 1

    def close(self):
        self.buf.close()
        self._fh.close()

    def unsupported(self, what: str):
        raise NotImplementedError(f"{self.path}: {what} is not supported by pram_tpu_torch.io.h5")

    def addr(self, off: int) -> int:
        return _uint(self.buf, off, self.so)

    def length(self, off: int) -> int:
        return _uint(self.buf, off, self.sl)

    # ---- object headers
    def messages(self, addr: int) -> List[tuple]:
        """``(type, flags, start, size)`` of every message of the object
        header at ``addr``, continuation blocks followed."""
        b = self.buf
        a = addr
        out: List[tuple] = []
        if b[a:a + 4] == b"OHDR":
            flags = b[a + 5]
            p = a + 6
            if flags & 0x20:
                p += 16
            if flags & 0x10:
                p += 4
            n = 1 << (flags & 3)
            size = _uint(b, p, n)
            p += n
            blocks = [(p, p + size)]
            order = bool(flags & 0x04)
            while blocks:
                start, end = blocks.pop(0)
                q = start
                hdr = 6 if order else 4
                while q + hdr <= end:
                    mtype, msize, mflags = b[q], _uint(b, q + 1, 2), b[q + 3]
                    q += hdr
                    out.append((mtype, mflags, q, msize))
                    if mtype == CONTINUATION:
                        c = self.addr(q)
                        cl = self.length(q + self.so)
                        blocks.append((c + 4, c + cl - 4))  # "OCHK" ... checksum
                    q += msize
            return out
        if b[a] != 1:
            self.unsupported(f"object header version {b[a]} at {addr}")
        size = _uint(b, a + 8, 4)
        blocks = [(a + 16, a + 16 + size)]
        while blocks:
            start, end = blocks.pop(0)
            q = start
            while q + 8 <= end:
                mtype, msize, mflags = _uint(b, q, 2), _uint(b, q + 2, 2), b[q + 4]
                q += 8
                out.append((mtype, mflags, q, msize))
                if mtype == CONTINUATION:
                    c = self.addr(q)
                    blocks.append((c, c + self.length(q + self.so)))
                q += msize
        return out

    # ---- groups
    @staticmethod
    def is_group(msgs) -> bool:
        types = {m[0] for m in msgs}
        return bool(types & {SYMBOL_TABLE, LINK, LINK_INFO}) or not types & {DATASPACE, LAYOUT}

    def links(self, msgs) -> Dict[str, int]:
        """Name -> object header address of every member of a group."""
        out: Dict[str, int] = {}
        for mtype, _, start, _ in msgs:
            if mtype == SYMBOL_TABLE:
                out.update(self._symbol_table(self.addr(start), self.addr(start + self.so)))
            elif mtype == LINK:
                name, target = self._link(start)
                out[name] = target
            elif mtype == LINK_INFO:
                heap, btree = self._link_info(start)
                if heap != self.undef:
                    out.update(self._dense_links(heap, btree))
        return out  # a v2 group with no members has none of these

    def find(self, msgs, name: str) -> Optional[int]:
        """The object header address of a group's member ``name``, or None:
        a search down the group's B-tree, by name (symbol tables) or by the
        name's hash (dense links), so a lookup reads O(log members)."""
        key = name.encode("utf-8")
        for mtype, _, start, _ in msgs:
            if mtype == SYMBOL_TABLE:
                return self._symbol_table_find(self.addr(start), self.addr(start + self.so), key)
            if mtype == LINK:
                link, target = self._link(start)
                if link == name:
                    return target
            elif mtype == LINK_INFO:
                heap, btree = self._link_info(start)
                if heap != self.undef:
                    return self._dense_find(heap, btree, name)
        return None

    def _link_info(self, start: int) -> tuple:
        """The link-info message's fractal heap and name-index B-tree."""
        p = start + 2 + (8 if self.buf[start + 1] & 1 else 0)
        return self.addr(p), self.addr(p + self.so)

    def _link(self, p: int):
        """A link message (also the record of dense storage): (name, address)."""
        b = self.buf
        flags = b[p + 1]
        p += 2
        ltype = 0
        if flags & 0x08:
            ltype = b[p]
            p += 1
        if flags & 0x04:
            p += 8
        if flags & 0x10:
            p += 1
        n = 1 << (flags & 3)
        nlen = _uint(b, p, n)
        p += n
        name = bytes(b[p:p + nlen]).decode("utf-8")
        p += nlen
        if ltype != 0:
            self.unsupported(f"{'soft' if ltype == 1 else 'external'} link {name!r}")
        return name, self.addr(p)

    def _heap_names(self, heap: int) -> Callable[[int], bytes]:
        """The name at an offset of a group's local heap."""
        b = self.buf
        if b[heap:heap + 4] != b"HEAP":
            raise ValueError(f"{self.path}: no local heap at {heap}")
        data = self.addr(heap + 8 + 2 * self.sl)

        def name_at(off):
            s = data + off
            return bytes(b[s:b.find(b"\0", s)])

        return name_at

    def _symbol_table(self, btree: int, heap: int) -> Dict[str, int]:
        b = self.buf
        name_at = self._heap_names(heap)
        out: Dict[str, int] = {}
        stack = [btree]
        entry = 2 * self.so + 24
        while stack:
            node = stack.pop()
            sig = b[node:node + 4]
            if sig == b"SNOD":
                for i in range(_uint(b, node + 6, 2)):
                    e = node + 8 + i * entry
                    name = name_at(self.addr(e)).decode("utf-8")
                    if _uint(b, e + 2 * self.so, 4) == 2:
                        self.unsupported(f"soft link {name!r}")
                    out[name] = self.addr(e + self.so)
                continue
            stack.extend(reversed(self._tree_children(node)[1]))
        return out

    def _tree_children(self, node: int) -> tuple:
        """A group B-tree node's keys (heap offsets of names, one more than
        children) and children."""
        b = self.buf
        if b[node:node + 4] != b"TREE":
            raise ValueError(f"{self.path}: bad group B-tree node at {node}")
        used = _uint(b, node + 6, 2)
        p = node + 8 + 2 * self.so  # key 0, child 0, key 1, ...
        step = self.so + self.sl
        keys = [self.length(p + i * step) for i in range(used + 1)]
        kids = [self.addr(p + self.sl + i * step) for i in range(used)]
        return keys, kids

    def _symbol_table_find(self, btree: int, heap: int, key: bytes) -> Optional[int]:
        """Child i of a group B-tree node holds the names after key i up to
        key i + 1, in byte order (HDF5 compares them with strcmp)."""
        b = self.buf
        name_at = self._heap_names(heap)
        node = btree
        while b[node:node + 4] != b"SNOD":
            keys, kids = self._tree_children(node)
            node = next((kids[i] for i in range(len(kids)) if key <= name_at(keys[i + 1])), None)
            if node is None:
                return None
        entry = 2 * self.so + 24
        for i in range(_uint(b, node + 6, 2)):
            e = node + 8 + i * entry
            if name_at(self.addr(e)) == key:
                if _uint(b, e + 2 * self.so, 4) == 2:
                    self.unsupported(f"soft link {key.decode('utf-8')!r}")
                return self.addr(e + self.so)
        return None

    # ---- dense link storage: a fractal heap indexed by a v2 B-tree of type 5
    def _heap_objects(self, heap: int) -> tuple:
        """``(id length, address of a heap id's object)`` of a fractal heap."""
        b = self.buf
        h = heap
        if b[h:h + 4] != b"FRHP":
            raise ValueError(f"{self.path}: no fractal heap at {heap}")
        id_len = _uint(b, h + 5, 2)
        filters_len = _uint(b, h + 7, 2)
        if filters_len:
            self.unsupported("a filtered fractal heap")
        p = h + 14 + 2 * (self.sl + self.so) + 8 * self.sl
        width = _uint(b, p, 2)
        start_size = self.length(p + 2)
        max_direct = self.length(p + 2 + self.sl)
        max_heap_bits = _uint(b, p + 2 + 2 * self.sl, 2)
        root = self.addr(p + 6 + 2 * self.sl)
        root_rows = _uint(b, p + 6 + 2 * self.sl + self.so, 2)
        off_size = (max_heap_bits + 7) // 8
        dir_bits = max_direct.bit_length() - 1
        start_bits = start_size.bit_length() - 1
        max_direct_rows = dir_bits - start_bits + 2

        blocks: List[tuple] = []  # (heap offset, address) of every direct block

        def row_size(r):
            return start_size if r == 0 else start_size << (r - 1)

        def indirect(addr, nrows):
            q = addr + 5 + self.so + off_size
            for r in range(nrows):
                for _ in range(width):
                    child = self.addr(q)
                    q += self.so
                    if child == self.undef:
                        continue
                    if r < max_direct_rows:
                        blocks.append((_uint(b, child + 5 + self.so, off_size), child))
                    else:
                        bits = row_size(r).bit_length() - 1
                        indirect(child, bits - (start_bits + (width.bit_length() - 1)) + 1)

        if root != self.undef:
            if root_rows == 0:
                blocks.append((0, root))
            else:
                indirect(root, root_rows)
        blocks.sort()
        starts = [o for o, _ in blocks]

        def obj(heap_id: bytes) -> int:
            kind = (heap_id[0] >> 4) & 3
            if kind != 0:
                self.unsupported(f"a {'huge' if kind == 1 else 'tiny'} fractal heap object")
            # an object's offset counts from its direct block's start, header included
            off = int.from_bytes(heap_id[1:1 + off_size], "little")
            i = int(np.searchsorted(starts, off, side="right")) - 1
            bstart, baddr = blocks[i]
            return baddr + (off - bstart)

        return id_len, obj

    def _dense_links(self, heap: int, btree: int) -> Dict[str, int]:
        id_len, obj = self._heap_objects(heap)
        out: Dict[str, int] = {}
        for rec in self._btree2_records(btree):
            name, target = self._link(obj(bytes(rec[4:4 + id_len])))
            out[name] = target
        return out

    def _dense_find(self, heap: int, btree: int, name: str) -> Optional[int]:
        """A search of the name index (records of the name's lookup3 hash and
        heap id, in hash order) for ``name``; equal hashes compare names."""
        id_len, obj = self._heap_objects(heap)
        want = lookup3(name.encode("utf-8"))
        root, root_n, depth, node = self._btree2(btree)
        if root is None:
            return None

        def search(addr, n, d):
            recs, kids = node(addr, n, d)
            for i, rec in enumerate(recs):
                h = _uint(rec, 0, 4)
                if want < h:
                    return search(*kids[i], d - 1) if d else None
                if want == h:
                    if d:
                        got = search(*kids[i], d - 1)
                        if got is not None:
                            return got
                    link, target = self._link(obj(bytes(rec[4:4 + id_len])))
                    if link == name:
                        return target
            return search(*kids[n], d - 1) if d else None

        return search(root, root_n, depth)

    def _btree2(self, addr: int) -> tuple:
        """``(root, records in the root, depth, node)`` of a version 2
        B-tree; ``node(addr, n, d)`` gives a node's records and its children
        ``(address, records)``. ``root`` is None for an empty tree."""
        b = self.buf
        h = addr
        if b[h:h + 4] != b"BTHD":
            raise ValueError(f"{self.path}: no v2 B-tree header at {addr}")
        node_size = _uint(b, h + 6, 4)
        rec_size = _uint(b, h + 10, 2)
        depth = _uint(b, h + 12, 2)
        root = self.addr(h + 16)
        root_n = _uint(b, h + 16 + self.so, 2)
        # records a node holds and the widths of its children's counts (H5B2__hdr_init)
        max_nrec = [(node_size - 10) // rec_size]
        cum_max = [max_nrec[0]]
        max_nrec_size = (max_nrec[0].bit_length() - 1) // 8 + 1
        cum_size = [0]
        for d in range(1, depth + 1):
            ptr = self.so + max_nrec_size + (cum_size[d - 1] if d > 1 else 0)
            max_nrec.append((node_size - (10 + ptr)) // (rec_size + ptr))
            cum_max.append((max_nrec[d] + 1) * cum_max[d - 1] + max_nrec[d])
            cum_size.append((cum_max[d].bit_length() - 1) // 8 + 1)

        def node(addr, n, d):
            q = addr + 6  # signature, version, type
            recs = [b[q + i * rec_size:q + (i + 1) * rec_size] for i in range(n)]
            kids = []
            if d:
                q += n * rec_size
                for _ in range(n + 1):
                    child = self.addr(q)
                    q += self.so
                    kids.append((child, _uint(b, q, max_nrec_size)))
                    q += max_nrec_size + (cum_size[d - 1] if d > 1 else 0)
            return recs, kids

        return (None if root == self.undef else root), root_n, depth, node

    def _btree2_records(self, addr: int) -> List[memoryview]:
        """Every record of a version 2 B-tree, in key order."""
        root, root_n, depth, node = self._btree2(addr)
        out: List[memoryview] = []

        def walk(addr, n, d):
            recs, kids = node(addr, n, d)
            if not d:
                out.extend(recs)
                return
            for i, kid in enumerate(kids):
                walk(*kid, d - 1)
                if i < n:
                    out.append(recs[i])

        if root is not None:
            walk(root, root_n, depth)
        return out

    # ---- datasets
    def dtype(self, p: int, what: str) -> np.dtype:
        b = self.buf
        cls, bits0, size = b[p] & 0x0F, b[p + 1], _uint(b, p + 4, 4)
        if cls == 0:
            if bits0 & 1:
                self.unsupported(f"big-endian integers in {what}")
            offset, precision = _uint(b, p + 8, 2), _uint(b, p + 10, 2)
            if offset != 0 or precision != 8 * size or size not in (1, 2, 4, 8):
                self.unsupported(f"a {precision}-bit integer at bit {offset} of {size} bytes in {what}")
            return np.dtype(f"<{'i' if bits0 & 8 else 'u'}{size}")
        if cls == 1:
            if bits0 & 1 or bits0 & 0x40:
                self.unsupported(f"big-endian or VAX floats in {what}")
            layout = (b[p + 2], b[p + 12], b[p + 13], b[p + 15], _uint(b, p + 16, 4))
            if size not in _FLOATS or layout != _FLOATS[size] or b[p + 14] != 0:
                self.unsupported(f"a non-IEEE {size}-byte float in {what}")
            return np.dtype(f"<f{size}")
        names = {2: "time", 3: "string", 4: "bitfield", 5: "opaque", 6: "compound", 7: "reference",
                 8: "enum", 9: "variable-length", 10: "array"}
        self.unsupported(f"the {names.get(cls, f'class {cls}')} datatype of {what}")

    def dataspace(self, p: int, what: str) -> tuple:
        b = self.buf
        version, rank, flags = b[p], b[p + 1], b[p + 2]
        if version == 1:
            q = p + 8
        elif version == 2:
            if b[p + 3] == 2:
                self.unsupported(f"the null dataspace of {what}")
            q = p + 4
        else:
            self.unsupported(f"dataspace version {version} in {what}")
        return tuple(self.length(q + i * self.sl) for i in range(rank))

    def dataset(self, msgs, what: str) -> dict:
        """``dtype``, ``shape`` and where the raw data sits."""
        info: dict = {}
        for mtype, mflags, start, _ in msgs:
            if mtype in (DATATYPE, DATASPACE) and mflags & 2:
                self.unsupported(f"a shared (committed) {'datatype' if mtype == DATATYPE else 'dataspace'} "
                                 f"in {what}")
            if mtype == DATATYPE:
                info["dtype"] = self.dtype(start, what)
            elif mtype == DATASPACE:
                info["shape"] = self.dataspace(start, what)
            elif mtype == FILTERS:
                self.unsupported(f"a filter pipeline (compression) on {what}")
            elif mtype == EXTERNAL:
                self.unsupported(f"external data files of {what}")
            elif mtype == LAYOUT:
                version, cls = self.buf[start], self.buf[start + 1]
                if version not in (3, 4):
                    self.unsupported(f"layout message version {version} of {what}")
                if cls == 0:
                    info["data"] = (start + 4, _uint(self.buf, start + 2, 2))
                elif cls == 1:
                    a = self.addr(start + 2)
                    n = self.length(start + 2 + self.so)
                    info["data"] = (None, 0) if a == self.undef else (a, n)
                else:
                    self.unsupported(f"the {'chunked' if cls == 2 else 'virtual'} layout of {what}")
        return info

    def read(self, info: dict) -> np.ndarray:
        dtype, shape = info["dtype"], info["shape"]
        n = int(np.prod(shape, dtype=np.int64))
        start, size = info["data"]
        if start is None or n == 0:
            return np.zeros(shape, dtype)
        raw = self.buf[start:start + n * dtype.itemsize]
        return np.frombuffer(raw, dtype).reshape(shape).copy()

    def attributes(self, msgs, what: str) -> Dict[str, np.ndarray]:
        b = self.buf
        out: Dict[str, np.ndarray] = {}
        for mtype, _, start, _ in msgs:
            if mtype == ATTRIBUTE_INFO:
                flags = b[start + 1]
                p = start + 2 + (2 if flags & 1 else 0)
                if self.addr(p) != self.undef:
                    self.unsupported(f"densely stored attributes of {what}")
            if mtype != ATTRIBUTE:
                continue
            version = b[start]
            if b[start + 1] & 3 and version > 1:
                self.unsupported(f"a shared datatype or dataspace in an attribute of {what}")
            nsize, tsize, ssize = (_uint(b, start + 2 + 2 * i, 2) for i in range(3))
            pad = (lambda n: (n + 7) & ~7) if version == 1 else (lambda n: n)
            p = start + 8 + (1 if version == 3 else 0)
            name = bytes(b[p:p + nsize]).split(b"\0")[0].decode("utf-8")
            p += pad(nsize)
            dtype = self.dtype(p, f"attribute {name!r} of {what}")
            p += pad(tsize)
            shape = self.dataspace(p, f"attribute {name!r} of {what}")
            p += pad(ssize)
            n = int(np.prod(shape, dtype=np.int64))
            arr = np.frombuffer(b[p:p + n * dtype.itemsize], dtype).reshape(shape).copy()
            out[name] = arr[()] if arr.ndim == 0 else arr
        return out


# --------------------------------------------------------------------------
# the object model
# --------------------------------------------------------------------------


class Attributes(dict):
    """An object's attributes: name -> numpy value."""

    def __setitem__(self, name, value):
        arr = np.asarray(value)
        super().__setitem__(name, arr[()] if arr.ndim == 0 else arr)


class _Object:
    def __init__(self, file: "File", name: str, addr: Optional[int] = None, msgs=None):
        self.file = file
        self._name = name
        self._addr = addr
        self._msgs = msgs
        self._attrs: Optional[Attributes] = None

    @property
    def name(self) -> str:
        return self._name

    @property
    def parent(self) -> "Group":
        if self._name == "/":
            return self  # type: ignore[return-value]
        head = self._name.rsplit("/", 1)[0] or "/"
        return self.file[head]

    @property
    def attrs(self) -> Attributes:
        if self._attrs is None:
            self._attrs = Attributes()
            if self._msgs is not None:
                self._attrs.update(self.file._r.attributes(self._msgs, self._name))
        return self._attrs

    def _child_name(self, key: str) -> str:
        return (self._name.rstrip("/") + "/" + key) if key else self._name


class Dataset(_Object):
    """An array: ``ds[()]`` reads it whole; other keys index the result."""

    def __init__(self, file, name, info: dict, addr=None, msgs=None):
        super().__init__(file, name, addr, msgs)
        self._info = info  # dtype, shape and where the bytes sit

    @property
    def shape(self) -> tuple:
        return self._info["shape"]

    @property
    def dtype(self) -> np.dtype:
        return self._info["dtype"]

    def _array(self) -> np.ndarray:
        # a dataset read from the file, or one this File wrote to its new file
        return (self.file._r if self._msgs is not None else self.file._w).read(self._info)

    def __getitem__(self, key):
        """``ds[()]``: the array (a numpy scalar for a scalar dataset)."""
        return self._array()[key]

    def __repr__(self):
        return f"<pram_tpu_torch.io.h5 Dataset {self._name!r} shape {self.shape} {self.dtype}>"


class Group(_Object):
    """A group: members by name, ``a/b`` paths walk nested groups. A name
    is looked up in the file's B-tree; the members are listed only for
    ``keys``, ``len``, ``visititems`` and writing."""

    def __init__(self, file, name, addr=None, msgs=None):
        super().__init__(file, name, addr, msgs)
        self._members: Dict[str, _Object] = {}  # opened or created
        self._links: Optional[Dict[str, int]] = None if msgs is not None else {}  # in the file, once listed

    def _address(self, key: str) -> Optional[int]:
        if self._links is not None:
            return self._links.get(key)
        return self.file._r.find(self._msgs, key)

    def _member(self, key: str) -> _Object:
        obj = self._members.get(key)
        if obj is None:
            addr = self._address(key)
            if addr is None:
                raise KeyError(f"{key!r} not in {self._name!r} of {self.file.filename}")
            obj = self._members[key] = self.file._open(self._child_name(key), addr)
        return obj

    def _names(self) -> List[str]:
        if self._links is None:
            self._links = self.file._r.links(self._msgs)
        return sorted(set(self._members) | set(self._links), key=lambda s: s.encode("utf-8"))

    def __getitem__(self, path: str) -> _Object:
        if path.startswith("/"):
            return self.file._walk(path.strip("/"))
        obj: _Object = self
        for part in [p for p in path.split("/") if p]:
            if not isinstance(obj, Group):
                raise KeyError(f"{path!r}: {obj.name!r} is a dataset in {self.file.filename}")
            obj = obj._member(part)
        return obj

    def __contains__(self, path: str) -> bool:
        try:
            self[path]
        except KeyError:
            return False
        return True

    def keys(self) -> List[str]:
        return self._names()

    def __len__(self) -> int:
        return len(self._names())

    def visititems(self, fn: Callable):
        """``fn(name, obj)`` for every object below this group, depth first
        in name order as ``h5py`` (H5Ovisit) visits them; a value that is not
        None stops the walk and is returned."""
        def walk(group: Group, prefix: str):
            for key in group._names():
                obj = group._member(key)
                rel = prefix + key
                ret = fn(rel, obj)
                if ret is not None:
                    return ret
                if isinstance(obj, Group):
                    ret = walk(obj, rel + "/")
                    if ret is not None:
                        return ret
            return None

        return walk(self, "")

    # ---- writing
    def _writable(self):
        if self.file.mode == "r":
            raise ValueError(f"{self.file.filename} is open read-only")

    def _parent_of(self, path: str, create: bool):
        parts = [p for p in path.split("/") if p]
        if not parts:
            raise ValueError("an empty name")
        g: Group = self
        for part in parts[:-1]:
            if part in g:
                nxt = g._member(part)
                if not isinstance(nxt, Group):
                    raise ValueError(f"{nxt.name!r} is a dataset")
                g = nxt
            elif create:
                g = g.create_group(part)
            else:
                raise KeyError(path)
        if parts[-1] in g:
            raise ValueError(f"{g._child_name(parts[-1])!r} already exists in {self.file.filename}")
        return g, parts[-1]

    def create_group(self, path: str) -> "Group":
        self._writable()
        g, key = self._parent_of(path, True)
        child = g._members[key] = Group(self.file, g._child_name(key))
        return child

    def create_dataset(self, path: str, data) -> Dataset:
        """Writes ``data``'s bytes to the new file now; only its name, type,
        shape and address stay in memory."""
        self._writable()
        arr = np.asarray(data)
        _encode_dtype(arr.dtype, f"dataset {path!r}")
        arr = arr.astype(arr.dtype.newbyteorder("<"), order="C", copy=False)
        g, key = self._parent_of(path, True)
        ds = g._members[key] = Dataset(self.file, g._child_name(key), self.file._w.array(arr))
        return ds

    def __repr__(self):
        return f"<pram_tpu_torch.io.h5 Group {self._name!r}>"


class File(Group):
    """An HDF5 file: ``"r"`` reads; ``"w"`` writes anew and ``"a"`` reads an
    existing file (or starts one), both into a temporary file beside it that
    replaces the file on close."""

    def __init__(self, path: str, mode: str = "r"):
        if mode not in ("r", "w", "a"):
            raise ValueError(f"mode {mode!r}: pram_tpu_torch.io.h5 opens files with 'r', 'w' or 'a'")
        self.filename = os.fspath(path)
        self.mode = mode
        self._r: Optional[_Reader] = None
        self._w: Optional[_Writer] = None
        if mode == "r" or (mode == "a" and os.path.exists(self.filename)):
            self._r = _Reader(self.filename)
            super().__init__(self, "/", self._r.root, self._r.messages(self._r.root))
        else:
            super().__init__(self, "/")
        if mode != "r":
            self._w = _Writer(self.filename)
        self._open_ = True

    def _open(self, name: str, addr: int) -> _Object:
        msgs = self._r.messages(addr)
        if self._r.is_group(msgs):
            return Group(self, name, addr, msgs)
        return Dataset(self, name, self._r.dataset(msgs, f"dataset {name!r}"), addr, msgs)

    def _walk(self, path: str) -> _Object:
        return Group.__getitem__(self, path) if path else self

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def close(self):
        if not getattr(self, "_open_", False):
            return
        self._open_ = False
        try:
            if self._w is not None:
                tmp = self._w.finish(self)
                self._close_reader()
                os.replace(tmp, self.filename)
        finally:
            if self._w is not None:
                self._w.discard()
            self._close_reader()

    def _close_reader(self):
        if self._r is not None:
            self._r.close()
            self._r = None


# --------------------------------------------------------------------------
# writing: superblock v0, version 1 object headers, symbol-table groups
# --------------------------------------------------------------------------


def _encode_dtype(dtype: np.dtype, what: str) -> bytes:
    dtype = np.dtype(dtype)
    size = dtype.itemsize
    if dtype.kind in "iu" and size in (1, 2, 4, 8):
        bits = 0x08 if dtype.kind == "i" else 0
        return struct.pack("<BBBBIHH", 0x10, bits, 0, 0, size, 0, 8 * size)
    if dtype.kind == "f" and size in _FLOATS:
        sign, eloc, esize, msize, bias = _FLOATS[size]
        return struct.pack("<BBBBIHHBBBBI", 0x11, 0x20, sign, 0, size, 0, 8 * size, eloc, esize, 0, msize, bias)
    raise TypeError(f"{what}: pram_tpu_torch.io.h5 writes integers and IEEE floats, not {dtype}")


def _dataspace(shape: tuple) -> bytes:
    return struct.pack("<BBBBI", 1, len(shape), 0, 0, 0) + b"".join(struct.pack("<Q", d) for d in shape)


def _pad8(b: bytes) -> bytes:
    return b + b"\0" * (-len(b) % 8)


def _attribute(name: str, value: np.ndarray) -> bytes:
    arr = np.asarray(value)
    arr = arr.astype(arr.dtype.newbyteorder("<"), order="C")
    nm = name.encode("utf-8") + b"\0"
    dt = _encode_dtype(arr.dtype, f"attribute {name!r}")
    sp = _dataspace(arr.shape)
    return struct.pack("<BBHHH", 1, 0, len(nm), len(dt), len(sp)) + _pad8(nm) + _pad8(dt) + _pad8(sp) + arr.tobytes()


class _Writer:
    """A file written front to back into a temporary file beside its path:
    each dataset's bytes when it is created; the groups' heaps, ``SNOD``
    nodes, B-trees and object headers, and then the superblock, on close."""

    def __init__(self, path: str):
        fd, self.tmp = tempfile.mkstemp(prefix=".h5_", dir=os.path.dirname(os.path.abspath(path)))
        self.fh = os.fdopen(fd, "w+b")
        self.pos = 0
        self.put(bytes(96))  # the superblock, written last

    def put(self, data) -> int:
        view = memoryview(data).cast("B")
        addr = self.pos
        self.fh.write(view)
        pad = -view.nbytes % 8
        if pad:
            self.fh.write(bytes(pad))
        self.pos += view.nbytes + pad
        return addr

    def array(self, arr: np.ndarray) -> dict:
        """Writes a little-endian C-ordered array; its dataset's info."""
        start = self.put(arr.reshape(-1)) if arr.size else None
        return {"dtype": arr.dtype, "shape": arr.shape, "data": (start, arr.nbytes)}

    def read(self, info: dict) -> np.ndarray:
        dtype, shape = info["dtype"], info["shape"]
        start, size = info["data"]
        if start is None:
            return np.zeros(shape, dtype)
        self.fh.flush()
        return np.frombuffer(os.pread(self.fh.fileno(), size, start), dtype).reshape(shape).copy()

    def header(self, msgs: List[tuple]) -> int:
        body = b""
        for mtype, flags, data in msgs:
            data = _pad8(data)
            body += struct.pack("<HHB3x", mtype, len(data), flags) + data
        return self.put(struct.pack("<BBHII4x", 1, 0, len(msgs), 1, len(body)) + body)

    def dataset(self, ds: Dataset) -> int:
        """A dataset's object header; one read from the old file (mode
        ``"a"``) has its bytes copied over first."""
        info = ds._info if ds._msgs is None else self.array(ds._array())
        start, nbytes = info["data"]
        layout = struct.pack("<BBQQ", 3, 1, UNDEF if start is None else start, nbytes)
        msgs = [(DATASPACE, 1, _dataspace(info["shape"])),
                (DATATYPE, 1, _encode_dtype(info["dtype"], f"dataset {ds.name!r}")),
                (FILL, 1, b"\x02\x02\x02\x01\x00\x00\x00\x00"), (LAYOUT, 0, layout)]
        msgs += [(ATTRIBUTE, 0, _attribute(k, v)) for k, v in ds.attrs.items()]
        return self.header(msgs)

    def group(self, g: Group) -> tuple:
        """Writes a group's members, heap, SNODs and B-tree; returns
        (object header, B-tree, heap) addresses."""
        names = g._names()
        entries = []  # (name, header address, cache type, scratch)
        for key in names:
            obj = g._member(key)
            if isinstance(obj, Group):
                hdr, bt, hp = self.group(obj)
                entries.append((key, hdr, 1, struct.pack("<QQ", bt, hp)))
            else:
                entries.append((key, self.dataset(obj), 0, bytes(16)))
        # local heap: "" at 0, then the names
        heap_data = bytearray(8)
        offsets = {}
        for key in names:
            offsets[key] = len(heap_data)
            heap_data += _pad8(key.encode("utf-8") + b"\0")
        data_addr = self.pos + 32
        heap = self.put(struct.pack("<4sB3xQQQ", b"HEAP", 0, len(heap_data), 1, data_addr) + bytes(heap_data))
        # SNODs of 2 * LEAF_K symbols
        snods = []  # (address, last name)
        for s in range(0, len(entries), 2 * LEAF_K):
            chunk = entries[s:s + 2 * LEAF_K]
            body = struct.pack("<4sBBH", b"SNOD", 1, 0, len(chunk))
            for key, hdr, cache, scratch in chunk:
                body += struct.pack("<QQI4x", offsets[key], hdr, cache) + scratch
            body += b"\0" * (40 * (2 * LEAF_K - len(chunk)))
            snods.append((self.put(body), chunk[-1][0]))
        btree = self.btree(snods, offsets)
        attrs = [(ATTRIBUTE, 0, _attribute(k, v)) for k, v in g.attrs.items()]
        hdr = self.header([(SYMBOL_TABLE, 0, struct.pack("<QQ", btree, heap))] + attrs)
        return hdr, btree, heap

    def btree(self, children: List[tuple], offsets: Dict[str, int]) -> int:
        """Levels of group B-tree nodes of up to 2 * INTERNAL_K children
        over ``children`` ((address, last name) in name order); returns the
        root's address. Key i is the largest name left of child i ("" first)."""
        node_size = 24 + (2 * INTERNAL_K + 1) * 8 + 2 * INTERNAL_K * 8
        level = 0
        while True:
            groups = [children[s:s + 2 * INTERNAL_K] for s in range(0, max(len(children), 1), 2 * INTERNAL_K)]
            first = self.pos
            addrs = [first + i * node_size for i in range(len(groups))]
            nxt, left_key = [], 0
            for i, kids in enumerate(groups):
                body = struct.pack("<4sBBHQQ", b"TREE", 0, level, len(kids),
                                   addrs[i - 1] if i else UNDEF, addrs[i + 1] if i + 1 < len(groups) else UNDEF)
                body += struct.pack("<Q", left_key)
                for addr, last in kids:
                    body += struct.pack("<QQ", addr, offsets[last])
                body += b"\0" * (node_size - len(body))
                assert self.put(body) == addrs[i]
                if kids:
                    left_key = offsets[kids[-1][1]]
                    nxt.append((addrs[i], kids[-1][1]))
            if len(groups) == 1:
                return addrs[0]
            children, level = nxt, level + 1

    def finish(self, root: Group) -> str:
        """Writes the tree under ``root`` and the superblock; the path of
        the finished temporary file."""
        hdr, btree, heap = self.group(root)
        sb = SIGNATURE + struct.pack("<BBBBBBBBHHI", 0, 0, 0, 0, 0, 8, 8, 0, LEAF_K, INTERNAL_K, 0)
        sb += struct.pack("<QQQQ", 0, UNDEF, self.pos, UNDEF)
        sb += struct.pack("<QQI4xQQ", 0, hdr, 1, btree, heap)
        assert len(sb) == 96
        self.fh.seek(0)
        self.fh.write(sb)
        self.fh.close()
        return self.tmp

    def discard(self):
        """Closes the temporary file and removes it if it was not renamed."""
        self.fh.close()
        if os.path.exists(self.tmp):
            os.remove(self.tmp)
