"""HDF5 files in numpy and zlib: the counterpart of h5py in the JAX package.

The card's machine has no h5py, so the port reads the subset of HDF5 that
h5py writes by default and with its common options, and writes the one
kind of file the trainer saves (a superblock-v0 file holding one contiguous
dataset, ``write_h5``).

``File(path)[name]`` is a ``Dataset`` with ``.shape`` and ``.dtype`` (the
stored dtype, byte order included, as h5py gives it) whose
``__getitem__`` takes integers, basic slices (step >= 1) and an Ellipsis
on any axis and reads only what the selection touches: a memory map of
contiguous storage, and only the chunks it crosses of chunked storage.

Covered: superblocks v0 and v2/v3 (a user block before them too); object
headers v1 and v2 (``OHDR``, ``OCHK`` continuations, checksums checked);
groups by symbol table (v1 B-tree type 0, ``SNOD``, local heap) and by
compact link messages; fixed-point of 1/2/4/8 bytes, signed or not, and
IEEE floats of 2/4/8 bytes, in either byte order; dataspaces v1 and v2;
layout v3 (compact, contiguous, chunked on a v1 B-tree) and v4 (the same,
and chunked on the single-chunk or fixed-array index); filter pipelines v1
and v2 with deflate (1), shuffle (2) and fletcher32 (3, checked and
stripped), undone in reverse order under each chunk's filter mask; edge
chunks cropped; unallocated chunks and undefined addresses read as the
fill value (0 unless the file sets one). Everything else raises
``NotImplementedError`` naming the structure or the filter id.
"""

from __future__ import annotations

import itertools
import os
import zlib

import numpy as np

SIGNATURE = b"\x89HDF\r\n\x1a\n"

_FILTER_NAMES = {4: "szip", 32000: "lzf", 32001: "blosc", 32004: "lz4", 32008: "bitshuffle",
                 32015: "zstd"}
_DEFLATE, _SHUFFLE, _FLETCHER32 = 1, 2, 3
# IEEE layouts by size: (sign bit, exponent location, exponent size, mantissa size, bias).
_IEEE = {2: (15, 10, 5, 10, 15), 4: (31, 23, 8, 23, 127), 8: (63, 52, 11, 52, 1023)}


def _unsupported(what):
    return NotImplementedError(f"HDF5 {what} is not read by the port's reader")


def _u(buf, off, n):
    return int.from_bytes(buf[off:off + n], "little")


def lookup3(data):
    """Bob Jenkins' lookup3 ``hashlittle`` (initial value 0): the checksum
    of HDF5's v2 structures."""
    m = 0xFFFFFFFF

    def rot(x, k):
        return ((x << k) | (x >> (32 - k))) & m

    length = len(data)
    a = b = c = (0xDEADBEEF + length) & m
    i = 0
    while length > 12:
        a = (a + _u(data, i, 4)) & m
        b = (b + _u(data, i + 4, 4)) & m
        c = (c + _u(data, i + 8, 4)) & m
        a = (a - c) & m; a ^= rot(c, 4); c = (c + b) & m
        b = (b - a) & m; b ^= rot(a, 6); a = (a + c) & m
        c = (c - b) & m; c ^= rot(b, 8); b = (b + a) & m
        a = (a - c) & m; a ^= rot(c, 16); c = (c + b) & m
        b = (b - a) & m; b ^= rot(a, 19); a = (a + c) & m
        c = (c - b) & m; c ^= rot(b, 4); b = (b + a) & m
        length -= 12
        i += 12
    if length == 0:
        return c
    tail = bytes(data[i:]) + bytes(12 - length)
    a = (a + _u(tail, 0, 4)) & m
    b = (b + _u(tail, 4, 4)) & m
    c = (c + _u(tail, 8, 4)) & m
    c ^= b; c = (c - rot(b, 14)) & m
    a ^= c; a = (a - rot(c, 11)) & m
    b ^= a; b = (b - rot(a, 25)) & m
    c ^= b; c = (c - rot(b, 16)) & m
    a ^= c; a = (a - rot(c, 4)) & m
    b ^= a; b = (b - rot(a, 14)) & m
    c ^= b; c = (c - rot(b, 24)) & m
    return c


def fletcher32(data):
    """HDF5's Fletcher-32 of `data`: 16-bit big-endian words (an odd last
    byte as the high byte of a word), each sum folded mod 65535 with a
    nonzero multiple of 65535 kept as 65535, as the library's end-around
    carries leave it."""
    raw = np.frombuffer(data, np.uint8)
    if raw.size % 2:
        raw = np.concatenate([raw, np.zeros(1, np.uint8)])
    words = (raw[0::2].astype(np.uint64) << np.uint64(8)) | raw[1::2].astype(np.uint64)
    n = words.size
    s1 = int(words.sum())
    # sum2 adds every prefix sum of sum1: word i counts n - i times.
    counts = (np.uint64(n) - np.arange(n, dtype=np.uint64)) % np.uint64(65535)
    s2 = int(((words * counts) % np.uint64(65535)).sum())

    def fold(s, nonzero):
        return 0 if not nonzero else (s - 1) % 65535 + 1

    nonzero = bool(s1)
    return (fold(s2, nonzero) << 16) | fold(s1, nonzero)


def _unshuffle(buf, size):
    n = len(buf) // size
    if size <= 1 or n <= 1:
        return buf
    body = np.frombuffer(buf, np.uint8, n * size).reshape(size, n).T.tobytes()
    return body + bytes(buf[n * size:])


def _selection(key, shape):
    """Basic indexing of `shape` -> (an index array per axis, the axes an
    integer index drops)."""
    if not isinstance(key, tuple):
        key = (key,)
    if any(k is Ellipsis for k in key):
        at = next(i for i, k in enumerate(key) if k is Ellipsis)
        key = key[:at] + (slice(None),) * (len(shape) - len(key) + 1) + key[at + 1:]
    if len(key) > len(shape):
        raise IndexError(f"{len(key)} indices for a dataset of rank {len(shape)}")
    key = key + (slice(None),) * (len(shape) - len(key))
    index, dropped = [], []
    for axis, (k, n) in enumerate(zip(key, shape)):
        if isinstance(k, slice):
            start, stop, step = k.indices(n)
            if step < 1:
                raise ValueError(f"Step must be >= 1 (got {step})")
            index.append(np.arange(start, stop, step, dtype=np.int64))
        elif isinstance(k, (int, np.integer)):
            i = int(k) + (n if k < 0 else 0)
            if not 0 <= i < n:
                raise IndexError(f"index {int(k)} out of range for axis {axis} of size {n}")
            index.append(np.array([i], np.int64))
            dropped.append(axis)
        else:
            raise TypeError(f"only integers, slices and an Ellipsis index a dataset, not "
                            f"{type(k).__name__}")
    return index, dropped


class File:
    """An HDF5 file opened for reading; `file[name]` is a Dataset or a
    Group. The file stays open until `close()` (or the end of a `with`)."""

    def __init__(self, path):
        self.filename = os.fspath(path)
        self._fd = os.open(self.filename, os.O_RDONLY)
        try:
            root = self._read_superblock()
            self._root = Group(self, root)
        except BaseException:
            self.close()
            raise

    # --- raw reads ----------------------------------------------------------------------

    def read(self, addr, n):
        data = os.pread(self._fd, n, self.base + addr)
        if len(data) != n:
            raise ValueError(f"{self.filename}: truncated at address {addr} (+{n} bytes)")
        return data

    def undefined(self, addr):
        return addr == (1 << (8 * self.sizeof_addr)) - 1

    def _read_superblock(self):
        size = os.fstat(self._fd).st_size
        at = 0
        while at < size:
            if os.pread(self._fd, 8, at) == SIGNATURE:
                break
            at = 512 if at == 0 else 2 * at
        else:
            raise ValueError(f"{self.filename}: not an HDF5 file")
        self.base = at
        head = os.pread(self._fd, 16, at)
        version = head[8]
        if version in (0, 1):
            self.sizeof_addr, self.sizeof_size = head[13], head[14]
            o = self.sizeof_addr
            fixed = 24 + (4 if version == 1 else 0)
            sb = os.pread(self._fd, fixed + 4 * o + 8 + 2 * o, at)
            # The root group's symbol table entry: name offset, object header address.
            return _u(sb, fixed + 4 * o + o, o)
        if version in (2, 3):
            self.sizeof_addr, self.sizeof_size = head[9], head[10]
            o = self.sizeof_addr
            n = 12 + 4 * o
            sb = os.pread(self._fd, n + 4, at)
            if lookup3(sb[:n]) != _u(sb, n, 4):
                raise ValueError(f"{self.filename}: superblock checksum mismatch")
            return _u(sb, 12 + 3 * o, o)
        raise _unsupported(f"superblock version {version}")

    # --- object headers -----------------------------------------------------------------

    def messages(self, addr):
        """The header messages of the object at `addr`: [(type, flags, data)]."""
        head = self.read(addr, 16)
        if head[:4] == b"OHDR":
            return self._messages_v2(addr)
        if head[0] != 1:
            raise _unsupported(f"object header version {head[0]}")
        out, blocks = [], [(addr + 16, _u(head, 8, 4))]
        while blocks:
            start, length = blocks.pop(0)
            block = self.read(start, length)
            pos = 0
            while pos + 8 <= length:
                mtype, msize, mflags = _u(block, pos, 2), _u(block, pos + 2, 2), block[pos + 4]
                data = block[pos + 8: pos + 8 + msize]
                pos += 8 + msize
                if mtype == 0x10:
                    blocks.append((_u(data, 0, self.sizeof_addr),
                                   _u(data, self.sizeof_addr, self.sizeof_size)))
                elif mtype:
                    out.append((mtype, mflags, data))
        return out

    def _messages_v2(self, addr):
        pre = self.read(addr, 6 + 16 + 4 + 8)
        version, flags = pre[4], pre[5]
        if version != 2:
            raise _unsupported(f"object header version {version}")
        pos = 6 + (16 if flags & 0x20 else 0) + (4 if flags & 0x10 else 0)
        width = 1 << (flags & 3)
        chunk0 = _u(pre, pos, width)
        pos += width
        order = 2 if flags & 0x04 else 0
        out, blocks = [], [(addr, pos, pos + chunk0)]
        while blocks:
            start, first, end = blocks.pop(0)
            block = self.read(start, end + 4)
            if lookup3(block[:end]) != _u(block, end, 4):
                raise ValueError(f"{self.filename}: object header checksum mismatch at {start}")
            p = first
            while p + 4 + order <= end:
                mtype, msize, mflags = block[p], _u(block, p + 1, 2), block[p + 3]
                p += 4 + order
                data = block[p: p + msize]
                p += msize
                if mtype == 0x10:
                    cont = _u(data, 0, self.sizeof_addr)
                    length = _u(data, self.sizeof_addr, self.sizeof_size)
                    if self.read(cont, 4) != b"OCHK":
                        raise ValueError(f"{self.filename}: no OCHK at {cont}")
                    blocks.append((cont, 4, length - 4))
                elif mtype:
                    out.append((mtype, mflags, data))
        return out

    def node(self, addr):
        """A Dataset or Group for the object header at `addr`."""
        msgs = self.messages(addr)
        types = {t for t, _, _ in msgs}
        if 0x08 in types:
            return Dataset(self, msgs)
        return Group(self, addr, msgs)

    # --- the mapping --------------------------------------------------------------------

    def __getitem__(self, name):
        return self._root[name]

    def __contains__(self, name):
        return name in self._root

    def keys(self):
        return self._root.keys()

    def close(self):
        if self._fd is not None:
            os.close(self._fd)
            self._fd = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        if getattr(self, "_fd", None) is not None:
            self.close()


class Group:
    """A group's links by name (symbol table or compact link messages)."""

    def __init__(self, file, addr, msgs=None):
        self._file = file
        self._links = {}
        for mtype, _, data in (file.messages(addr) if msgs is None else msgs):
            if mtype == 0x11:
                o = file.sizeof_addr
                self._symbol_table(_u(data, 0, o), _u(data, o, o))
            elif mtype == 0x02:
                flags = data[1]
                pos = 2 + (8 if flags & 1 else 0)
                if not file.undefined(_u(data, pos, file.sizeof_addr)):
                    raise _unsupported("dense link storage (fractal heap)")
            elif mtype == 0x06:
                self._link(data)

    def _symbol_table(self, btree, heap):
        f, o, s = self._file, self._file.sizeof_addr, self._file.sizeof_size
        hh = f.read(heap, 8 + 2 * s + o)
        if hh[:4] != b"HEAP":
            raise ValueError(f"{f.filename}: no local heap at {heap}")
        names = f.read(_u(hh, 8 + 2 * s, o), _u(hh, 8, s))

        def name_at(off):
            return names[off: names.index(b"\0", off)].decode()

        stack = [btree]
        while stack:
            addr = stack.pop()
            head = f.read(addr, 8 + 2 * o)
            if head[:4] == b"SNOD":
                n = _u(head, 6, 2)
                entries = f.read(addr + 8, n * (2 * o + 24))
                for i in range(n):
                    e = i * (2 * o + 24)
                    self._links[name_at(_u(entries, e, o))] = _u(entries, e + o, o)
                continue
            if head[:4] != b"TREE" or head[4] != 0:
                raise ValueError(f"{f.filename}: no group B-tree node at {addr}")
            used = _u(head, 6, 2)
            body = f.read(addr + 8 + 2 * o, used * (s + o) + s)
            stack.extend(_u(body, s + i * (s + o), o) for i in range(used))

    def _link(self, data):
        f = self._file
        flags = data[1]
        pos = 2
        kind = 0
        if flags & 0x08:
            kind = data[pos]
            pos += 1
        pos += (8 if flags & 0x04 else 0) + (1 if flags & 0x10 else 0)
        width = 1 << (flags & 3)
        length = _u(data, pos, width)
        pos += width
        name = data[pos: pos + length].decode()
        pos += length
        self._links[name] = _u(data, pos, f.sizeof_addr) if kind == 0 else (
            {1: "soft", 64: "external"}.get(kind, f"type-{kind}") + " link")

    def __getitem__(self, name):
        node = self
        for part in [p for p in name.split("/") if p]:
            if not isinstance(node, Group):
                raise KeyError(name)
            target = node._links.get(part)
            if target is None:
                raise KeyError(f"{name!r} is not in {self._file.filename}")
            if isinstance(target, str):
                raise _unsupported(target)
            node = self._file.node(target)
        return node

    def __contains__(self, name):
        try:
            self[name]
        except KeyError:
            return False
        return True

    def keys(self):
        return sorted(self._links)


class Dataset:
    """A dataset's shape, dtype and storage; reads on indexing."""

    def __init__(self, file, msgs):
        self._file = file
        self._filters = []
        self._fill_bytes = None
        layout = None
        for mtype, flags, data in msgs:
            if mtype == 0x01:
                self.shape = self._dataspace(data)
            elif mtype == 0x03:
                if flags & 0x02:
                    raise _unsupported("shared (committed) datatype")
                self.dtype = _datatype(data)
            elif mtype == 0x04 and self._fill_bytes is None:
                self._fill_bytes = data[4: 4 + _u(data, 0, 4)] or None
            elif mtype == 0x05:
                self._fill_bytes = _fill_value(data)
            elif mtype == 0x07:
                raise _unsupported("external storage")
            elif mtype == 0x08:
                layout = data
            elif mtype == 0x0B:
                self._filters = _filter_pipeline(data)
        self._layout(layout)
        fill = np.zeros((), self.dtype)
        if self._fill_bytes:
            fill = np.frombuffer(self._fill_bytes, self.dtype, 1)[0]
        self.fillvalue = fill

    @property
    def file(self):
        return self._file

    def _dataspace(self, data):
        version, rank = data[0], data[1]
        s = self._file.sizeof_size
        if version == 1:
            pos = 8
        elif version == 2:
            if data[3] == 2:
                raise _unsupported("null dataspace")
            pos = 4
        else:
            raise _unsupported(f"dataspace version {version}")
        return tuple(_u(data, pos + i * s, s) for i in range(rank))

    def _layout(self, data):
        f, o, s = self._file, self._file.sizeof_addr, self._file.sizeof_size
        version, cls = data[0], data[1]
        if version not in (3, 4):
            raise _unsupported(f"data layout message version {version}")
        self._edge_unfiltered = False
        if cls == 0:
            self._storage = "compact"
            self._compact = data[4: 4 + _u(data, 2, 2)]
        elif cls == 1:
            self._storage = "contiguous"
            self._address = _u(data, 2, o)
        elif cls == 2 and version == 3:
            rank = data[2] - 1
            self.chunks = tuple(_u(data, 3 + o + 4 * i, 4) for i in range(rank))
            self._storage = "chunked"
            self._index = ("btree1", _u(data, 3, o))
        elif cls == 2:
            flags, rank, width = data[2], data[3] - 1, data[4]
            self.chunks = tuple(_u(data, 5 + width * i, width) for i in range(rank))
            pos = 5 + width * (rank + 1)
            kind = data[pos]
            pos += 1
            self._storage = "chunked"
            self._edge_unfiltered = bool(flags & 1)
            if kind == 1:
                size, mask = None, 0
                if flags & 2:
                    size, mask = _u(data, pos, s), _u(data, pos + s, 4)
                    pos += s + 4
                self._index = ("single", _u(data, pos, o), size, mask)
            elif kind == 3:
                self._index = ("fixed", _u(data, pos + 1, o))
            else:
                raise _unsupported({2: "implicit chunk index", 4: "extensible-array chunk index",
                                    5: "v2-B-tree chunk index"}.get(kind, f"chunk index {kind}"))
        elif cls == 3:
            raise _unsupported("virtual storage")
        else:
            raise _unsupported(f"layout class {cls}")

    # --- reading ------------------------------------------------------------------------

    def __array__(self, dtype=None, copy=None):
        out = self[()]
        return out if dtype is None else out.astype(dtype)

    def __getitem__(self, key):
        index, dropped = _selection(key, self.shape)
        out_shape = tuple(len(i) for i in index)
        if self._storage == "contiguous":
            if self._file.undefined(self._address) or 0 in self.shape:
                out = np.full(out_shape, self.fillvalue, self.dtype)
            else:
                mm = np.memmap(self._file.filename, self.dtype, "r",
                               offset=self._file.base + self._address, shape=self.shape)
                out = np.array(mm[tuple(_as_slice(i) for i in index)])
                del mm
        elif self._storage == "compact":
            whole = np.frombuffer(self._compact, self.dtype,
                                  int(np.prod(self.shape))).reshape(self.shape)
            out = np.array(whole[tuple(_as_slice(i) for i in index)])
        else:
            out = self._read_chunked(index, out_shape)
        if dropped:
            out = out.reshape(tuple(n for a, n in enumerate(out_shape) if a not in dropped))
        return out[()] if out.ndim == 0 else out

    def _chunk_table(self):
        """{chunk grid coordinates: (address, stored bytes, filter mask)}."""
        if getattr(self, "_table", None) is not None:
            return self._table
        f, o = self._file, self._file.sizeof_addr
        rank = len(self.chunks)
        nbytes = int(np.prod(self.chunks)) * self.dtype.itemsize
        table = {}
        kind = self._index[0]
        if kind == "single":
            _, addr, size, mask = self._index
            if not f.undefined(addr):
                table[(0,) * rank] = (addr, nbytes if size is None else size, mask)
        elif kind == "fixed":
            if not f.undefined(self._index[1]):
                table = self._fixed_array(self._index[1], nbytes)
        elif not f.undefined(self._index[1]):
            key = 8 + 8 * (rank + 1)
            stack = [self._index[1]]
            while stack:
                addr = stack.pop()
                head = f.read(addr, 8 + 2 * o)
                if head[:4] != b"TREE" or head[4] != 1:
                    raise ValueError(f"{f.filename}: no chunk B-tree node at {addr}")
                level, used = head[5], _u(head, 6, 2)
                body = f.read(addr + 8 + 2 * o, used * (key + o) + key)
                for i in range(used):
                    k = i * (key + o)
                    child = _u(body, k + key, o)
                    if level:
                        stack.append(child)
                        continue
                    offsets = [_u(body, k + 8 + 8 * d, 8) for d in range(rank)]
                    coords = tuple(off // c for off, c in zip(offsets, self.chunks))
                    table[coords] = (child, _u(body, k, 4), _u(body, k + 4, 4))
        self._table = table
        return table

    def _fixed_array(self, header, nbytes):
        f, o, s = self._file, self._file.sizeof_addr, self._file.sizeof_size
        hdr = f.read(header, 8 + s + o + 4)
        if hdr[:4] != b"FAHD":
            raise ValueError(f"{f.filename}: no fixed-array header at {header}")
        if lookup3(hdr[:8 + s + o]) != _u(hdr, 8 + s + o, 4):
            raise ValueError(f"{f.filename}: fixed-array header checksum mismatch")
        client, entry, page_bits = hdr[5], hdr[6], hdr[7]
        count, block = _u(hdr, 8, s), _u(hdr, 8 + s, o)
        table = {}
        if f.undefined(block):
            return table
        page = 1 << page_bits
        pages = -(-count // page) if count > page else 0
        prefix = 6 + o + -(-pages // 8)  # signature, version, client, header, page bitmap
        if pages:
            head = f.read(block, prefix + 4)
            if head[:4] != b"FADB" or lookup3(head[:prefix]) != _u(head, prefix, 4):
                raise ValueError(f"{f.filename}: bad fixed-array data block at {block}")
            raw = b""
            at = block + prefix + 4
            for p in range(pages):
                n = min(page, count - p * page)
                if head[6 + o + p // 8] & (0x80 >> (p % 8)):
                    blob = f.read(at, n * entry + 4)
                    if lookup3(blob[:-4]) != _u(blob, n * entry, 4):
                        raise ValueError(f"{f.filename}: fixed-array page checksum mismatch")
                    raw += blob[:-4]
                else:
                    raw += b"\xff" * (n * entry)
                at += page * entry + 4
        else:
            blob = f.read(block, prefix + count * entry + 4)
            if blob[:4] != b"FADB" or lookup3(blob[:-4]) != _u(blob, prefix + count * entry, 4):
                raise ValueError(f"{f.filename}: bad fixed-array data block at {block}")
            raw = blob[prefix:-4]
        grid = tuple(-(-n // c) for n, c in zip(self.shape, self.chunks))
        for i in range(count):
            e = i * entry
            addr = _u(raw, e, o)
            if f.undefined(addr) or (client == 1 and addr == 0):
                continue
            size, mask = nbytes, 0
            if client == 1:
                size, mask = _u(raw, e + o, entry - o - 4), _u(raw, e + entry - 4, 4)
            table[tuple(int(x) for x in np.unravel_index(i, grid))] = (addr, size, mask)
        return table

    def _chunk(self, coords):
        entry = self._chunk_table().get(coords)
        if entry is None:
            return None
        addr, size, mask = entry
        data = self._file.read(addr, size)
        edge = any((c + 1) * n > d for c, n, d in zip(coords, self.chunks, self.shape))
        if not (self._edge_unfiltered and edge):
            for i in reversed(range(len(self._filters))):
                if mask & (1 << i):
                    continue
                fid, client = self._filters[i]
                if fid == _DEFLATE:
                    data = zlib.decompress(data)
                elif fid == _SHUFFLE:
                    data = _unshuffle(data, client[0] if client else self.dtype.itemsize)
                else:
                    stored = _u(data, len(data) - 4, 4)
                    data = data[:-4]
                    got = fletcher32(data)
                    swapped = ((got & 0xFF) << 16 | (got >> 8 & 0xFF) << 24
                               | (got >> 16 & 0xFF) | (got >> 24 & 0xFF) << 8)
                    if stored not in (got, swapped):
                        raise ValueError(f"{self._file.filename}: fletcher32 checksum mismatch "
                                         f"in the chunk at {addr}")
        count = int(np.prod(self.chunks))
        return np.frombuffer(data, self.dtype, count).reshape(self.chunks)

    def _read_chunked(self, index, out_shape):
        out = np.empty(out_shape, self.dtype)
        per_axis = []
        for idx, c in zip(index, self.chunks):
            ids = idx // c
            per_axis.append([(int(k), np.nonzero(ids == k)[0]) for k in np.unique(ids)])
        for combo in itertools.product(*per_axis):
            coords = tuple(k for k, _ in combo)
            where = np.ix_(*[pos for _, pos in combo])
            chunk = self._chunk(coords)
            if chunk is None:
                out[where] = self.fillvalue
                continue
            local = np.ix_(*[idx[pos] - k * c for (k, pos), idx, c
                             in zip(combo, index, self.chunks)])
            out[where] = chunk[local]
        return out


def _as_slice(idx):
    """An arange index as a slice (an empty one as 0:0)."""
    if idx.size == 0:
        return slice(0, 0)
    step = int(idx[1] - idx[0]) if idx.size > 1 else 1
    return slice(int(idx[0]), int(idx[-1]) + 1, step)


def _datatype(data):
    cls, bits, size = data[0] & 0x0F, data[1] | data[2] << 8 | data[3] << 16, _u(data, 4, 4)
    order = ">" if bits & 1 else "<"
    if cls == 0:
        offset, precision = _u(data, 8, 2), _u(data, 10, 2)
        if size not in (1, 2, 4, 8) or offset or precision != 8 * size:
            raise _unsupported(f"{size}-byte fixed-point of {precision} bits at {offset}")
        return np.dtype(order + ("i" if bits & 0x08 else "u") + str(size))
    if cls == 1:
        layout = (bits >> 8 & 0xFF, data[12], data[13], data[15], _u(data, 16, 4))
        if bits & 0x40 or size not in _IEEE or layout != _IEEE[size] or _u(data, 8, 2) or \
                _u(data, 10, 2) != 8 * size or data[14]:
            raise _unsupported(f"{size}-byte float other than IEEE's")
        return np.dtype(order + "f" + str(size))
    names = {2: "time", 3: "string", 4: "bitfield", 5: "opaque", 6: "compound", 7: "reference",
             8: "enum", 9: "variable-length", 10: "array"}
    raise _unsupported(f"datatype class {cls} ({names.get(cls, 'unknown')})")


def _fill_value(data):
    version = data[0]
    if version in (1, 2):
        if version == 1 or data[3]:
            return data[8: 8 + _u(data, 4, 4)] or None
        return None
    if version == 3:
        if data[1] & 0x20:
            return data[6: 6 + _u(data, 2, 4)] or None
        return None
    raise _unsupported(f"fill value message version {version}")


def _filter_pipeline(data):
    version, count = data[0], data[1]
    if version not in (1, 2):
        raise _unsupported(f"filter pipeline version {version}")
    pos = 8 if version == 1 else 2
    out = []
    for _ in range(count):
        fid = _u(data, pos, 2)
        name_len = _u(data, pos + 2, 2) if version == 1 or fid >= 256 else 0
        pos += 2 + (2 if version == 1 or fid >= 256 else 0)
        n_values = _u(data, pos + 2, 2)
        pos += 4
        if version == 1:
            pos += (name_len + 7) // 8 * 8
        else:
            pos += name_len
        client = [_u(data, pos + 4 * i, 4) for i in range(n_values)]
        pos += 4 * n_values + (4 if version == 1 and n_values % 2 else 0)
        if fid not in (_DEFLATE, _SHUFFLE, _FLETCHER32):
            name = _FILTER_NAMES.get(fid, "unregistered")
            raise _unsupported(f"filter {fid} ({name})")
        out.append((fid, client))
    return out


# --- the writer ------------------------------------------------------------------------


def _datatype_message(dtype):
    order = 1 if dtype.byteorder == ">" or (dtype.byteorder == "=" and
                                             np.little_endian is False) else 0
    size = dtype.itemsize
    if dtype.kind in "iu" and size in (1, 2, 4, 8):
        bits = order | (0x08 if dtype.kind == "i" else 0)
        props = (0).to_bytes(2, "little") + (8 * size).to_bytes(2, "little")
        cls = 0
    elif dtype.kind == "f" and size in _IEEE:
        sign, eloc, esize, msize, bias = _IEEE[size]
        bits = order | 0x20 | sign << 8
        props = (b"\0\0" + (8 * size).to_bytes(2, "little") + bytes([eloc, esize, 0, msize])
                 + bias.to_bytes(4, "little"))
        cls = 1
    else:
        raise NotImplementedError(f"write_h5 writes integers and IEEE floats, not {dtype}")
    return bytes([0x10 | cls]) + bits.to_bytes(3, "little") + size.to_bytes(4, "little") + props


def _header_message(mtype, body):
    body += bytes(-len(body) % 8)
    return mtype.to_bytes(2, "little") + len(body).to_bytes(2, "little") + bytes(4) + body


def write_h5(path, name, array):
    """Write `array` as the dataset `name` of a new HDF5 file at `path`: a
    superblock-v0 file whose root group (symbol table) holds one contiguous
    dataset, as h5py's `f.create_dataset(name, data=array)` stores it.
    The data is written from the array's memory as it lies (a memory map
    streams), in its own byte order."""
    array = np.asarray(array)
    if not array.flags.c_contiguous:
        array = np.ascontiguousarray(array)
    undef = b"\xff" * 8
    q = lambda x: int(x).to_bytes(8, "little")  # noqa: E731

    names = b"\0" * 8 + name.encode() + b"\0"
    names += bytes(-len(names) % 8)
    heap_size = len(names) + 16  # the names, then one free block
    leaf_k, internal_k = 4, 16
    sb_size, root_size = 96, 16 + 24
    tree_at = sb_size + root_size
    tree_size = 24 + (2 * internal_k + 1) * 8 + 2 * internal_k * 8
    snod_at = tree_at + tree_size
    snod_size = 8 + 2 * leaf_k * 40
    heap_at = snod_at + snod_size
    heap_data_at = heap_at + 32

    space = bytes([1, array.ndim, 0, 0]) + bytes(4) + b"".join(q(n) for n in array.shape)
    fill = bytes([2, 2, 2, 0])  # version 2, late allocation, write if set, no value
    messages_wo_layout = (_header_message(0x01, space)
                          + _header_message(0x03, _datatype_message(array.dtype))
                          + _header_message(0x05, fill))
    layout_len = len(_header_message(0x08, bytes(18)))
    dset_at = heap_data_at + heap_size
    dset_size = 16 + len(messages_wo_layout) + layout_len
    data_at = dset_at + dset_size
    data_at += -data_at % 8
    eof = data_at + array.nbytes

    sb = (SIGNATURE + bytes([0, 0, 0, 0, 0, 8, 8, 0]) + leaf_k.to_bytes(2, "little")
          + internal_k.to_bytes(2, "little") + bytes(4) + q(0) + undef + q(eof) + undef
          + q(0) + q(sb_size) + (1).to_bytes(4, "little") + bytes(4) + q(tree_at) + q(heap_at))
    root = (bytes([1, 0]) + (1).to_bytes(2, "little") + (1).to_bytes(4, "little")
            + (24).to_bytes(4, "little") + bytes(4)
            + _header_message(0x11, q(tree_at) + q(heap_at)))
    tree = (b"TREE" + bytes([0, 0]) + (1).to_bytes(2, "little") + undef + undef
            + q(0) + q(snod_at) + q(8))
    tree += bytes(tree_size - len(tree))
    snod = b"SNOD" + bytes([1, 0]) + (1).to_bytes(2, "little") + q(8) + q(dset_at) + bytes(24)
    snod += bytes(snod_size - len(snod))
    heap = (b"HEAP" + bytes(4) + q(heap_size) + q(len(names)) + q(heap_data_at)
            + names + q(1) + q(16))
    layout = bytes([3, 1]) + q(data_at) + q(array.nbytes)
    dset = (bytes([1, 0]) + (4).to_bytes(2, "little") + (1).to_bytes(4, "little")
            + (dset_size - 16).to_bytes(4, "little") + bytes(4) + messages_wo_layout
            + _header_message(0x08, layout))
    head = sb + root + tree + snod + heap + dset
    head += bytes(data_at - len(head))
    with open(path, "wb") as f:
        f.write(head)
        array.tofile(f)
