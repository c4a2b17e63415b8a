"""A reader of tensorstore's OCDBT key-value databases, in Python.

The JAX package's Orbax checkpoints keep their arrays in an OCDBT database
(`train/orbax.py` reads the zarr arrays in it). A database is a directory:

- `manifest.ocdbt`: a header (magic 0x0cdb3a2a, the file's length as a
  little-endian uint64, a varint format version and a varint compression:
  0 none, 1 zstd), the body, and a CRC-32C of everything before it. The body
  holds the config (uuid, manifest kind, inline and node size limits, the
  version tree's arity, the compression) and, for a single-file manifest, a
  data file table and the newest versions: generation, root height and the
  root node's location (file, offset, length) a version, in columns;
- `d/<name>` data files: B-tree nodes (each with a header of magic
  0x0cdb20de, like the manifest's) and values stored indirectly, which are
  raw bytes at an offset.

A B-tree node's body is its height, a data file table and its entries in
columns: the keys prefix-coded against the entry before, then for a leaf each
value's length, kind (0 inline, 1 indirect), the indirect values' files and
offsets, and the inline bytes; for an interior node, each child's common key
prefix length, location and statistics. A child's keys continue its entry's
common prefix. File paths are relative to the database's directory, so the
values that an Orbax step's root database merges from `ocdbt.process_0/`
are read from there.

A database of numbered manifests (config `manifest_kind` 1) keeps only its
config in `manifest.ocdbt`; its versions are in `manifest.<16 hex digits>`
files, the newest having the highest number, each a manifest of the same
form (its own header and CRC-32C, the same uuid) whose body holds the data
file table and versions after the config.

Only the newest version is read. tensorstore keeps it among a manifest's
inline versions (older ones move to version tree nodes), so those nodes are
never read.
"""
from __future__ import annotations

import os
import re
from typing import Dict, List, Tuple

from mofanerf_tpu_torch.utils import zstd

MANIFEST_MAGIC = 0x0CDB3A2A
_NUMBERED = re.compile(r"^manifest\.[0-9a-fA-F]{16}$")
NODE_MAGIC = 0x0CDB20DE

Location = Tuple[str, int, int]   # (file relative to the database, offset, length)


class OcdbtError(ValueError):
    """A database that is corrupt or uses what this reader refuses."""


def _crc32c_table():
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ (0x82F63B78 if c & 1 else 0)
        table.append(c)
    return table


_CRC_TABLE = _crc32c_table()


def crc32c(data) -> int:
    """CRC-32C (Castagnoli) of `data`."""
    c = 0xFFFFFFFF
    t = _CRC_TABLE
    for b in bytes(data):
        c = t[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


class _Reader:
    def __init__(self, data, what: str):
        self.data, self.pos, self.what = data, 0, what

    def byte(self) -> int:
        if self.pos >= len(self.data):
            raise OcdbtError(f"{self.what}: truncated")
        b = self.data[self.pos]
        self.pos += 1
        return b

    def varint(self) -> int:
        v, shift = 0, 0
        while True:
            b = self.byte()
            v |= (b & 0x7F) << shift
            if b < 0x80:
                return v
            shift += 7
            if shift > 63:
                raise OcdbtError(f"{self.what}: varint too long")

    def varints(self, n: int) -> List[int]:
        return [self.varint() for _ in range(n)]

    def raw(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise OcdbtError(f"{self.what}: truncated")
        out = bytes(self.data[self.pos:self.pos + n])
        self.pos += n
        return out


def _unwrap(data, magic: int, what: str) -> _Reader:
    """The body of a manifest or node, its header and checksum checked."""
    if len(data) < 18:
        raise OcdbtError(f"{what}: too short")
    if int.from_bytes(data[:4], "big") != magic:
        raise OcdbtError(f"{what}: bad magic {bytes(data[:4]).hex()}")
    if int.from_bytes(data[4:12], "little") != len(data):
        raise OcdbtError(f"{what}: length field {int.from_bytes(data[4:12], 'little')} != "
                         f"{len(data)} bytes")
    if crc32c(data[:-4]) != int.from_bytes(data[-4:], "little"):
        raise OcdbtError(f"{what}: CRC-32C mismatch")
    head = _Reader(data[:-4], what)
    head.pos = 12
    version, compression = head.varint(), head.varint()
    if version != 0:
        raise OcdbtError(f"{what}: format version {version}")
    body = data[head.pos:-4]
    if compression == 1:
        try:
            body = zstd.decompress(body)
        except zstd.ZstdError as e:
            raise OcdbtError(f"{what}: {e}") from None
    elif compression != 0:
        raise OcdbtError(f"{what}: compression {compression}")
    return _Reader(body, what)


def _file_table(r: _Reader) -> List[str]:
    n = r.varint()
    prefix = [0] + r.varints(n - 1) if n else []
    suffix = r.varints(n)
    r.varints(n)   # base path lengths: the paths are whole already
    paths, prev = [], b""
    for p, s in zip(prefix, suffix):
        prev = prev[:p] + r.raw(s)
        paths.append(prev.decode())
    return paths


def _config(path: str):
    """(uuid, manifest kind, the reader after the config) of the manifest
    file `path`, its header and CRC-32C checked."""
    with open(path, "rb") as f:
        r = _unwrap(f.read(), MANIFEST_MAGIC, path)
    uuid = r.raw(16)
    kind = r.varint()
    r.varint()   # max inline value bytes
    r.varint()   # max decoded node bytes
    r.byte()     # version tree arity (log2)
    if r.varint() == 1:
        r.varint()   # zstd level
    extra = r.varints(3)
    if any(extra):
        raise OcdbtError(f"{path}: unknown config fields {extra}")
    return uuid, kind, r


def _keys(r: _Reader, n: int, interior: bool):
    prefix = [0] + r.varints(n - 1) if n else []
    suffix = r.varints(n)
    common = r.varints(n) if interior else None
    keys, prev = [], b""
    for p, s in zip(prefix, suffix):
        prev = prev[:p] + r.raw(s)
        keys.append(prev)
    return keys, common


class Database:
    """The newest version of the OCDBT database in `root` (a directory)."""

    def __init__(self, root: str):
        self.root = root
        path = os.path.join(root, "manifest.ocdbt")
        if not os.path.isfile(path):
            raise FileNotFoundError(f"no OCDBT manifest in {root}")
        uuid, kind, r = _config(path)
        if kind == 1:       # numbered: the versions are in the newest numbered manifest
            if r.pos != len(r.data):
                raise OcdbtError(f"{path}: a numbered database's config manifest holds more")
            numbered = sorted((int(n[9:], 16), n) for n in os.listdir(root) if _NUMBERED.match(n))
            if not numbered:
                raise OcdbtError(f"{root}: numbered manifests, and none is there")
            path = os.path.join(root, numbered[-1][1])
            their_uuid, _, r = _config(path)
            if their_uuid != uuid:
                raise OcdbtError(f"{path}: uuid {their_uuid.hex()} is not the database's "
                                 f"{uuid.hex()}")
        elif kind != 0:
            raise OcdbtError(f"{path}: manifest kind {kind}")
        files = _file_table(r)
        n = r.varint()
        if n == 0:
            raise OcdbtError(f"{path}: no versions")
        gens = r.varints(n)
        heights = [r.byte() for _ in range(n)]
        fid, off, length = r.varints(n), r.varints(n), r.varints(n)
        newest = max(range(n), key=gens.__getitem__)
        self.height = heights[newest]
        if fid[newest] >= len(files):
            raise OcdbtError(f"{path}: root file id {fid[newest]} out of range")
        self.root_location: Location | None = (files[fid[newest]], off[newest], length[newest])
        if not files[fid[newest]]:   # an empty tree
            self.root_location = None
        self._files: Dict[str, bytes] = {}

    def _read(self, loc: Location) -> bytes:
        name, offset, length = loc
        if name not in self._files:
            path = os.path.join(self.root, name)
            if not os.path.isfile(path):
                raise OcdbtError(f"missing data file {path}")
            with open(path, "rb") as f:
                self._files[name] = f.read()
        data = self._files[name]
        if offset + length > len(data):
            raise OcdbtError(f"{name}: [{offset}, {offset + length}) past its "
                             f"{len(data)} bytes")
        return data[offset:offset + length]

    def entries(self) -> Dict[bytes, object]:
        """{key: inline bytes or a Location of the value}, every key."""
        out: Dict[bytes, object] = {}
        if self.root_location is not None:
            self._walk(self.root_location, self.height, b"", out)
        return out

    def _walk(self, loc: Location, height: int, base: bytes, out) -> None:
        what = f"{os.path.join(self.root, loc[0])}@{loc[1]}"
        r = _unwrap(self._read(loc), NODE_MAGIC, what)
        h = r.byte()
        if h != height:
            raise OcdbtError(f"{what}: node height {h}, its parent says {height}")
        files = _file_table(r)
        n = r.varint()
        keys, common = _keys(r, n, interior=h > 0)
        if h > 0:
            fid, off, length = r.varints(n), r.varints(n), r.varints(n)
            for i, key in enumerate(keys):
                self._walk((files[fid[i]], off[i], length[i]), h - 1,
                           base + key[:common[i]], out)
            return
        lengths = r.varints(n)
        kinds = [r.byte() for _ in range(n)]
        indirect = [i for i, k in enumerate(kinds) if k == 1]
        if any(k not in (0, 1) for k in kinds):
            raise OcdbtError(f"{what}: value kind {max(kinds)}")
        fid, off = r.varints(len(indirect)), r.varints(len(indirect))
        locs = {i: (files[f], o, lengths[i]) for i, f, o in zip(indirect, fid, off)}
        for i, key in enumerate(keys):
            out[base + key] = locs[i] if i in locs else r.raw(lengths[i])

    def value(self, ref) -> bytes:
        """The bytes of an entry's value (inline, or read from its data file)."""
        return ref if isinstance(ref, bytes) else self._read(ref)
