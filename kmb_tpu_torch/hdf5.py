"""HDF5 files of the port's layout, written without h5py.

The dataset and result files are HDF5 (the reference layout: attributes on
the root group, one contiguous array per name).  `write` is the writer
below, which handles exactly that layout:

- attributes: str (variable-length UTF-8, as h5py stores a Python str),
  bool (h5py's enum of int8 FALSE / TRUE), int (int64), float (float64),
  and 1-D numeric arrays;
- arrays: float64, float32, int64 or int32, any rank, stored contiguously.

The writer emits HDF5 1.10 structures (superblock version 2, version 2
object headers with Jenkins lookup3 checksums, links stored compactly in
the root group, one global heap collection for the strings), which h5py
reads as it reads its own files.  `open_read` uses h5py where it is
installed, since files that h5py or the reference wrote are not of this
layout, and the reader below where it is not (the card's machine has no
h5py); that reader reads files of this writer only.  The plotting layer's
metric caches (a group added to each result file) need h5py; so does
matplotlib, which that machine lacks too.
"""

from __future__ import annotations

import struct

import numpy as np

SIGNATURE = b"\x89HDF\r\n\x1a\n"
UNDEF = 0xFFFFFFFFFFFFFFFF
GLOBAL_HEAP_MIN = 4096

# Object header message types.
DATASPACE, LINK_INFO, DATATYPE, FILL_VALUE, LINK, LAYOUT, GROUP_INFO, \
    ATTRIBUTE = 0x01, 0x02, 0x03, 0x05, 0x06, 0x08, 0x0A, 0x0C

_NUMERIC = {np.dtype("<f8"), np.dtype("<f4"), np.dtype("<i8"),
            np.dtype("<i4")}


def open_read(path):
    """The file at `path` opened for reading: an h5py.File, or this
    module's `File` where h5py is missing (the same `attrs`, `f[name][:]`,
    `f[name].shape`, `close()` and context manager)."""
    try:
        import h5py
    except ImportError:
        return File(path)
    return h5py.File(path, "r")


# -- checksum ------------------------------------------------------------------

def _rot(x, k):
    return ((x << k) | (x >> (32 - k))) & 0xFFFFFFFF


def lookup3(data, initval=0):
    """Bob Jenkins' lookup3 `hashlittle`, HDF5's metadata checksum."""
    mask = 0xFFFFFFFF
    length = len(data)
    a = b = c = (0xDEADBEEF + length + initval) & mask
    if length == 0:
        return c
    blocks = -(-length // 12)
    words = struct.unpack(f"<{3 * blocks}I",
                          data + b"\0" * (12 * blocks - length))
    for i in range(blocks - 1):   # every 12-byte block but the last
        a = (a + words[3 * i]) & mask
        b = (b + words[3 * i + 1]) & mask
        c = (c + words[3 * i + 2]) & mask
        a = (a - c) & mask; a ^= _rot(c, 4); c = (c + b) & mask
        b = (b - a) & mask; b ^= _rot(a, 6); a = (a + c) & mask
        c = (c - b) & mask; c ^= _rot(b, 8); b = (b + a) & mask
        a = (a - c) & mask; a ^= _rot(c, 16); c = (c + b) & mask
        b = (b - a) & mask; b ^= _rot(a, 19); a = (a + c) & mask
        c = (c - b) & mask; c ^= _rot(b, 4); b = (b + a) & mask
    i = blocks - 1
    a = (a + words[3 * i]) & mask
    b = (b + words[3 * i + 1]) & mask
    c = (c + words[3 * i + 2]) & mask
    c ^= b; c = (c - _rot(b, 14)) & mask
    a ^= c; a = (a - _rot(c, 11)) & mask
    b ^= a; b = (b - _rot(a, 25)) & mask
    c ^= b; c = (c - _rot(b, 16)) & mask
    a ^= c; a = (a - _rot(c, 4)) & mask
    b ^= a; b = (b - _rot(a, 14)) & mask
    c ^= b; c = (c - _rot(b, 24)) & mask
    return c


# -- encoding ------------------------------------------------------------------

def _fixed(size, signed):
    """Datatype message of a little-endian integer of `size` bytes."""
    return struct.pack("<B3BIHH", 0x10, 0x08 if signed else 0, 0, 0, size,
                       0, 8 * size)


def _float(size):
    """Datatype message of a little-endian IEEE float of `size` bytes."""
    sign, exp_loc, exp_size, mant, bias = (
        (63, 52, 11, 52, 1023) if size == 8 else (31, 23, 8, 23, 127))
    return struct.pack("<B3BIHHBBBBI", 0x11, 0x20, sign, 0, size, 0,
                       8 * size, exp_loc, exp_size, 0, mant, bias)


def _numeric_type(dtype):
    if dtype.kind == "f":
        return _float(dtype.itemsize)
    return _fixed(dtype.itemsize, True)


# The enum h5py stores numpy bools as: int8 base, members FALSE and TRUE.
_BOOL = (struct.pack("<B3BI", 0x38, 2, 0, 0, 1) + _fixed(1, True)
         + b"FALSE\0TRUE\0" + b"\x00\x01")
# A variable-length UTF-8 string (padding: null terminated), of bytes.
_VLEN_STR = struct.pack("<B3BI", 0x19, 0x01, 0x01, 0, 16) + _fixed(1, False)


def _dataspace(shape):
    if not shape:
        return struct.pack("<4B", 2, 0, 0, 0)
    return struct.pack(f"<4B{len(shape)}Q", 2, len(shape), 0, 1, *shape)


def _message(kind, body):
    return struct.pack("<BHB", kind, len(body), 0) + body


def _object_header(messages):
    body = b"".join(messages)
    head = b"OHDR" + struct.pack("<BBI", 2, 0x02, len(body)) + body
    return head + struct.pack("<I", lookup3(head))


def _attribute(name, value, strings, heap):
    """An attribute message's body for `value`; a str goes to `strings`,
    the objects of the global heap collection at `heap`."""
    if isinstance(value, (bool, np.bool_)):
        dtype, space, data = _BOOL, _dataspace(()), bytes([bool(value)])
    elif isinstance(value, str):
        raw = value.encode()
        strings.append(raw)
        dtype, space = _VLEN_STR, _dataspace(())
        data = struct.pack("<IQI", len(raw), heap, len(strings))
    elif isinstance(value, (int, np.integer)):
        dtype, space = _fixed(8, True), _dataspace(())
        data = struct.pack("<q", int(value))
    elif isinstance(value, (float, np.floating)):
        dtype, space = _float(8), _dataspace(())
        data = struct.pack("<d", float(value))
    else:
        arr = np.asarray(value)
        if arr.ndim != 1 or arr.dtype.newbyteorder("<") not in _NUMERIC:
            raise TypeError(f"attribute {name!r}: cannot store "
                            f"{type(value).__name__} {value!r}")
        arr = arr.astype(arr.dtype.newbyteorder("<"))
        dtype, space, data = (_numeric_type(arr.dtype),
                              _dataspace(arr.shape), arr.tobytes())
    encoded = name.encode() + b"\0"
    return struct.pack("<BBHHHB", 3, 0, len(encoded), len(dtype),
                       len(space), 1) + encoded + dtype + space + data


def write(path, attrs, arrays):
    """Write `attrs` on the root group and each of `arrays` as a dataset.

    The file: superblock, root group header, each dataset's header,
    the strings' global heap, then the arrays' bytes."""
    data = {}
    for name, value in arrays.items():
        arr = np.ascontiguousarray(value)
        if arr.dtype.newbyteorder("<") not in _NUMERIC:
            raise TypeError(f"array {name!r}: cannot store {arr.dtype}")
        data[name] = arr.astype(arr.dtype.newbyteorder("<"), copy=False)

    def dataset_header(arr, address):
        return _object_header([
            _message(DATASPACE, _dataspace(arr.shape)),
            _message(DATATYPE, _numeric_type(arr.dtype)),
            # Fill value version 3: allocated early, written if set, none.
            _message(FILL_VALUE, struct.pack("<BB", 3, 0x09)),
            _message(LAYOUT, struct.pack("<BBQQ", 3, 1, address,
                                         arr.nbytes)),
        ])

    def root_header(addresses, heap):
        strings = []
        messages = [
            _message(LINK_INFO, struct.pack("<BBQQ", 0, 0, UNDEF, UNDEF)),
            _message(GROUP_INFO, struct.pack("<BB", 0, 0)),
        ]
        for name, address in addresses.items():
            encoded = name.encode()
            messages.append(_message(LINK, struct.pack(
                "<BBB", 1, 0, len(encoded)) + encoded
                + struct.pack("<Q", address)))
        for name, value in attrs.items():
            messages.append(_message(ATTRIBUTE, _attribute(
                name, value, strings, heap)))
        return _object_header(messages), strings

    # No size depends on an address: lay out with zeros, then write.
    superblock = 48
    root, strings = root_header(dict.fromkeys(data, 0), 0)
    heap = _global_heap(strings) if strings else b""
    offset = superblock + len(root)
    headers, array_address = {}, {}
    for k, a in data.items():
        headers[k] = offset
        offset += len(dataset_header(a, 0))
    heap_address = offset
    offset += len(heap)
    for k, a in data.items():
        array_address[k] = offset
        offset += a.nbytes
    root, _ = root_header(headers, heap_address)
    head = SIGNATURE + struct.pack("<BBBBQQQQ", 2, 8, 8, 0, 0, UNDEF,
                                   offset, superblock)
    with open(path, "wb") as f:
        f.write(head + struct.pack("<I", lookup3(head)))
        f.write(root)
        for k, a in data.items():
            f.write(dataset_header(a, array_address[k]))
        f.write(heap)
        for a in data.values():
            f.write(a.tobytes())


def _global_heap(objects):
    """One global heap collection holding `objects` (bytes), indices from
    1, with its free space as object 0."""
    parts = []
    for index, raw in enumerate(objects, 1):
        parts.append(struct.pack("<HHIQ", index, 1, 0, len(raw)) + raw
                     + b"\0" * (-len(raw) % 8))
    used = 16 + sum(len(p) for p in parts)
    size = max(GLOBAL_HEAP_MIN, used + 16)
    free = struct.pack("<HHIQ", 0, 0, 0, size - used)
    body = b"".join(parts) + free
    return (b"GCOL" + struct.pack("<B3xQ", 1, size) + body
            + b"\0" * (size - 16 - len(body)))


# -- reading -------------------------------------------------------------------

class Dataset:
    """One contiguous array of a `File`; `[...]` reads it."""

    def __init__(self, path, address, dtype, shape):
        self._path, self._address = path, address
        self.dtype, self.shape = dtype, shape

    def __getitem__(self, key):
        count = int(np.prod(self.shape))
        with open(self._path, "rb") as f:
            f.seek(self._address)
            arr = np.fromfile(f, dtype=self.dtype, count=count)
        return arr.reshape(self.shape)[key]


class File:
    """A file of this module's writer, read: `attrs` (a dict) and its
    arrays by name."""

    def __init__(self, path):
        self._path = path
        with open(path, "rb") as f:
            self._raw = f.read(1 << 16)
        raw = self._raw
        if raw[:8] != SIGNATURE or raw[8] != 2:
            raise OSError(f"{path!r}: not an HDF5 file of this writer")
        (root,) = struct.unpack_from("<Q", raw, 36)
        self._links, self.attrs = {}, {}
        for kind, body in self._messages(root):
            if kind == LINK:
                n = body[2]
                name = body[3:3 + n].decode()
                (self._links[name],) = struct.unpack_from("<Q", body, 3 + n)
            elif kind == ATTRIBUTE:
                name, value = self._attribute(body)
                self.attrs[name] = value

    def _read(self, address, size):
        if address + size <= len(self._raw):
            return self._raw[address:address + size]
        with open(self._path, "rb") as f:
            f.seek(address)
            return f.read(size)

    def _messages(self, address):
        head = self._read(address, 10)
        if head[:4] != b"OHDR" or head[5] != 0x02:
            raise OSError(f"{self._path!r}: object header at {address}")
        (size,) = struct.unpack_from("<I", head, 6)
        block = self._read(address, 10 + size + 4)
        if lookup3(block[:-4]) != struct.unpack_from("<I", block, 10 + size)[0]:
            raise OSError(f"{self._path!r}: object header checksum")
        pos, out = 10, []
        while pos + 4 <= 10 + size:
            kind, length, _ = struct.unpack_from("<BHB", block, pos)
            out.append((kind, block[pos + 4:pos + 4 + length]))
            pos += 4 + length
        return out

    def _type(self, body, pos):
        """(kind, numpy dtype or None) of the datatype at `pos`."""
        cls = body[pos] & 0x0F
        (size,) = struct.unpack_from("<I", body, pos + 4)
        if cls == 0:
            signed = bool(body[pos + 1] & 0x08)
            return "num", np.dtype(f"<{'i' if signed else 'u'}{size}")
        if cls == 1:
            return "num", np.dtype(f"<f{size}")
        if cls in (8, 9):   # this writer's enums are bools, its vlens str
            return ("bool" if cls == 8 else "str"), None
        raise OSError(f"{self._path!r}: datatype class {cls}")

    @staticmethod
    def _shape(body, pos):
        rank = body[pos + 1]
        return tuple(struct.unpack_from(f"<{rank}Q", body, pos + 4))

    def _attribute(self, body):
        _, _, name_len, type_len, space_len, _ = struct.unpack_from(
            "<BBHHHB", body)
        pos = 9
        name = body[pos:pos + name_len - 1].decode()
        pos += name_len
        kind, dtype = self._type(body, pos)
        shape = self._shape(body, pos + type_len)
        data = body[pos + type_len + space_len:]
        if kind == "bool":
            return name, np.bool_(data[0])
        if kind == "str":
            length, heap, index = struct.unpack_from("<IQI", data)
            return name, self._heap_object(heap, index)[:length].decode()
        value = np.frombuffer(data, dtype=dtype, count=int(np.prod(shape)))
        return name, value.reshape(shape)[()] if not shape else value.copy()

    def _heap_object(self, address, index):
        (size,) = struct.unpack_from("<Q", self._read(address, 16), 8)
        heap = self._read(address, size)
        pos = 16
        while pos + 16 <= size:
            idx, _, _, length = struct.unpack_from("<HHIQ", heap, pos)
            if idx == index:
                return heap[pos + 16:pos + 16 + length]
            if idx == 0:
                break
            pos += 16 + length + (-length % 8)
        raise OSError(f"{self._path!r}: no heap object {index}")

    def __getitem__(self, name):
        address = self._links[name]
        shape = dtype = layout = None
        for kind, body in self._messages(address):
            if kind == DATASPACE:
                shape = self._shape(body, 0)
            elif kind == DATATYPE:
                _, dtype = self._type(body, 0)
            elif kind == LAYOUT:
                layout = struct.unpack_from("<Q", body, 2)[0]
        return Dataset(self._path, layout, dtype, shape)

    def keys(self):
        return self._links.keys()

    def close(self):
        self._raw = b""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
