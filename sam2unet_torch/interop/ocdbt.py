"""The key-value store under the JAX package's Orbax checkpoints: a reader
and a writer of the subset of tensorstore's OCDBT format (format version 0)
that orbax-checkpoint 0.11 writes, with no tensorstore, orbax or zstd
Python package. The one native dependency is the system Zstandard library,
`libzstd.so.1`, loaded with ctypes.

A database is a directory. `manifest.ocdbt` at its root names the latest
version's B-tree root; nodes and large values live in data files under it
(`d/<hex>`). Orbax writes one sub-database per process
(`ocdbt.process_<i>/`) and then a top-level manifest whose tree merges
them: its nodes name the sub-database's data files with a base path
(`ocdbt.process_0/`). The top-level manifest is the authoritative one;
the sub-databases' own manifests are not read.

Every manifest and node is framed as
    magic (uint32 big-endian) | length of the whole file or node
    (uint64 LE) | format version (varint, 0) | compression (varint: 0
    none, 1 zstd) | body, compressed as one zstd frame | crc32c of all
    the bytes before it (uint32 LE)
and the reader verifies the magic, the length and the checksum. Integers
in a body are unsigned LEB128 varints except where noted; arrays of
records are stored column by column. A body is:

- manifest: config (uuid: 16 bytes; manifest kind; max inline value
  bytes; max decoded node bytes; version-tree arity log2: 1 byte;
  compression: 0, or 1 then the zstd level as int32 LE), a data file
  table, the latest versions (count; generation numbers; root heights, 1
  byte each; root locations as file ids, offsets, lengths; statistics as
  key counts, tree bytes, indirect value bytes; commit times, uint64 LE),
  and the interior version-tree nodes (count; generations; locations;
  generations covered; commit times; heights, 1 byte). An empty tree's
  root location is (the file "", 2**64 - 1, 2**64 - 1).
- data file table: count; for each file after the first the length of the
  prefix it shares with the previous path; each path's suffix length; each
  path's base-path length; the suffixes. A path is relative to the
  database's root; its base path is where the file's own database lives.
- B-tree node: height (1 byte), a data file table, the entry count, each
  key's prefix shared with the previous key (entries after the first),
  each key's suffix length, for an interior node each entry's subtree
  common prefix length, the key suffixes; then for a leaf each value's
  length, each value's kind (1 byte: 0 inline, 1 in a data file), the
  indirect values' file ids and offsets, and the inline values in order;
  for an interior node each child's file id, offset and length and its
  statistics (key count, tree bytes, indirect value bytes). A node's keys
  are relative: the root's to "", a child's to its parent's prefix plus
  the entry's subtree common prefix.

The writer writes what `save_variables` needs: one version at generation
1, the tree as one leaf node unless `max_decoded_node_bytes` forces
interior nodes, values over `max_inline_value_bytes` and every node in one
data file, the manifest last. tensorstore reads it back (the tests read
it through the JAX package's `restore_variables` and compare every
decoded manifest and node with `tensorstore.ocdbt.dump`).
"""

from __future__ import annotations

import ctypes
import ctypes.util
import functools
import os
import time
import uuid as uuid_lib
from pathlib import Path
from typing import NamedTuple

import numpy as np

MANIFEST_MAGIC = 0x0CDB3A2A
NODE_MAGIC = 0x0CDB20DE
FORMAT_VERSION = 0
MANIFEST_NAME = "manifest.ocdbt"
# orbax-checkpoint 0.11's configuration of its databases
MAX_INLINE_VALUE_BYTES = 1024
MAX_DECODED_NODE_BYTES = 100_000_000
VERSION_TREE_ARITY_LOG2 = 4
NODE_ZSTD_LEVEL = 0   # zstd's default level
_NO_OFFSET = 2 ** 64 - 1


class OcdbtError(ValueError):
    """A database that does not decode, or fails its checksum."""


# ------------------------------------------------------------------ zstd


@functools.cache
def _zstd() -> ctypes.CDLL:
    name = ctypes.util.find_library("zstd") or "libzstd.so.1"
    try:
        lib = ctypes.CDLL(name)
    except OSError as e:
        raise RuntimeError(
            "libzstd.so.1 (the Zstandard library) was not found; Orbax "
            "checkpoints are zstd-compressed and cannot be read or written "
            f"without it ({e})") from e
    size_t, vp = ctypes.c_size_t, ctypes.c_void_p
    for fn, res, args in (
            ("ZSTD_compress", size_t, [vp, size_t, vp, size_t, ctypes.c_int]),
            ("ZSTD_compressBound", size_t, [size_t]),
            ("ZSTD_decompress", size_t, [vp, size_t, vp, size_t]),
            ("ZSTD_getFrameContentSize", ctypes.c_ulonglong, [vp, size_t]),
            ("ZSTD_isError", ctypes.c_uint, [size_t]),
            ("ZSTD_getErrorName", ctypes.c_char_p, [size_t])):
        getattr(lib, fn).restype = res
        getattr(lib, fn).argtypes = args
    return lib


def _zstd_check(lib: ctypes.CDLL, code: int, what: str) -> int:
    if lib.ZSTD_isError(code):
        raise OcdbtError(f"zstd {what} failed: "
                         f"{lib.ZSTD_getErrorName(code).decode()}")
    return code


def zstd_decompress(data: bytes, size: int | None = None) -> bytes:
    """The frames of `data`, decompressed. `size` is the expected length
    where the caller knows it (a zarr chunk); else the frame header's
    content size, and where a frame omits it the output buffer grows until
    the frame fits."""
    lib = _zstd()
    src = ctypes.c_char_p(data)
    if size is None:
        content = lib.ZSTD_getFrameContentSize(src, len(data))
        if content == 2 ** 64 - 2:
            raise OcdbtError("zstd: not a zstd frame")
        if content != 2 ** 64 - 1:
            size = int(content)
    cap = size if size is not None else max(4 * len(data), 1 << 16)
    while True:
        out = ctypes.create_string_buffer(max(cap, 1))
        n = lib.ZSTD_decompress(out, cap, src, len(data))
        if not lib.ZSTD_isError(n):
            break
        if size is not None or cap >= 1 << 31:
            _zstd_check(lib, n, "decompress")
        cap *= 4
    if size is not None and n != size:
        raise OcdbtError(f"zstd: decompressed {n} bytes, expected {size}")
    return out.raw[:n]


def zstd_compress(data: bytes, level: int) -> bytes:
    lib = _zstd()
    cap = lib.ZSTD_compressBound(len(data))
    out = ctypes.create_string_buffer(cap)
    n = _zstd_check(lib, lib.ZSTD_compress(out, cap, ctypes.c_char_p(data),
                                           len(data), level), "compress")
    return out.raw[:n]


# ---------------------------------------------------------------- crc32c


@functools.cache
def _crc_table() -> list[int]:
    t = np.arange(256, dtype=np.uint32)
    for _ in range(8):
        t = np.where(t & 1, (t >> 1) ^ np.uint32(0x82F63B78), t >> 1)
    return t.tolist()


def crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli), as tensorstore's trailers carry it."""
    table = _crc_table()
    c = 0xFFFFFFFF
    for b in data:
        c = table[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


# --------------------------------------------------------------- records


class DataFile(NamedTuple):
    base: str      # where the file's own database lives, relative to root
    relative: str  # the path under that base

    @property
    def path(self) -> str:
        return self.base + self.relative


class Ref(NamedTuple):
    """A byte range of a data file: a node or an indirect value."""
    file: DataFile
    offset: int
    length: int


class Statistics(NamedTuple):
    num_keys: int
    num_tree_bytes: int
    num_indirect_value_bytes: int


class Version(NamedTuple):
    generation: int
    root_height: int
    root: Ref | None          # None: the empty tree
    statistics: Statistics
    commit_time: int          # nanoseconds since the epoch


class VersionNode(NamedTuple):
    generation: int
    location: Ref
    num_generations: int
    commit_time: int
    height: int


class Config(NamedTuple):
    uuid: bytes
    manifest_kind: int
    max_inline_value_bytes: int
    max_decoded_node_bytes: int
    version_tree_arity_log2: int
    zstd_level: int | None    # None: nodes are not compressed


class Manifest(NamedTuple):
    config: Config
    versions: list[Version]
    version_tree_nodes: list[VersionNode]


class LeafEntry(NamedTuple):
    key: bytes                # relative to the node's prefix
    value: bytes | Ref        # inline bytes, or where the value lives


class InteriorEntry(NamedTuple):
    key: bytes                # the child's first key, relative
    subtree_common_prefix_length: int
    location: Ref
    statistics: Statistics


class Node(NamedTuple):
    height: int
    entries: list


# -------------------------------------------------------------- decoding


class _Reader:
    def __init__(self, buf: bytes):
        self.buf, self.pos = buf, 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.buf):
            raise OcdbtError("truncated body")
        out = self.buf[self.pos: self.pos + n]
        self.pos += n
        return out

    def byte(self) -> int:
        return self.take(1)[0]

    def varint(self) -> int:
        out = shift = 0
        while True:
            b = self.byte()
            out |= (b & 0x7F) << shift
            if not b & 0x80:
                return out
            shift += 7
            if shift > 63:
                raise OcdbtError("varint too long")

    def varints(self, n: int) -> list[int]:
        return [self.varint() for _ in range(n)]

    def u64(self) -> int:
        return int.from_bytes(self.take(8), "little")

    def done(self) -> None:
        if self.pos != len(self.buf):
            raise OcdbtError(f"{len(self.buf) - self.pos} trailing bytes")


def _unframe(data: bytes, magic: int, what: str) -> bytes:
    """The body of a framed manifest or node, its frame checked."""
    if len(data) < 18 or int.from_bytes(data[:4], "big") != magic:
        raise OcdbtError(f"{what}: bad magic number")
    length = int.from_bytes(data[4:12], "little")
    if length != len(data):
        raise OcdbtError(f"{what}: length field {length} against {len(data)} "
                         "bytes")
    if crc32c(data[:-4]) != int.from_bytes(data[-4:], "little"):
        raise OcdbtError(f"{what}: crc32c checksum mismatch")
    r = _Reader(data[12:-4])
    version, compression = r.varint(), r.varint()
    if version != FORMAT_VERSION:
        raise OcdbtError(f"{what}: format version {version}")
    body = data[12 + r.pos: -4]
    if compression == 0:
        return body
    if compression == 1:
        return zstd_decompress(body)
    raise OcdbtError(f"{what}: unknown compression {compression}")


def _read_files(r: _Reader) -> list[DataFile]:
    n = r.varint()
    prefix = [0] + r.varints(max(n - 1, 0))
    suffix, base = r.varints(n), r.varints(n)
    files, prev = [], ""
    for i in range(n):
        if prefix[i] > len(prev):
            raise OcdbtError("data file table: prefix past the previous path")
        path = prev[: prefix[i]] + r.take(suffix[i]).decode()
        if base[i] > len(path):
            raise OcdbtError("data file table: base path past the path")
        files.append(DataFile(path[: base[i]], path[base[i]:]))
        prev = path
    return files


def _read_refs(r: _Reader, files: list[DataFile], n: int) -> list[Ref]:
    ids, offsets, lengths = r.varints(n), r.varints(n), r.varints(n)
    if any(i >= len(files) for i in ids):
        raise OcdbtError("file id past the data file table")
    return [Ref(files[i], o, ln) for i, o, ln in zip(ids, offsets, lengths)]


def _read_statistics(r: _Reader, n: int) -> list[Statistics]:
    cols = [r.varints(n) for _ in range(3)]
    return [Statistics(*c) for c in zip(*cols)]


def decode_manifest(data: bytes) -> Manifest:
    r = _Reader(_unframe(data, MANIFEST_MAGIC, "manifest"))
    uuid, kind = r.take(16), r.varint()
    max_inline, max_node, arity = r.varint(), r.varint(), r.byte()
    method = r.varint()
    if method not in (0, 1):
        raise OcdbtError(f"manifest: unknown node compression {method}")
    level = int.from_bytes(r.take(4), "little", signed=True) if method else None
    config = Config(uuid, kind, max_inline, max_node, arity, level)
    if kind != 0:
        raise OcdbtError("manifest: numbered manifests are not supported")
    files = _read_files(r)
    n = r.varint()
    gens, heights = r.varints(n), [r.byte() for _ in range(n)]
    roots, stats = _read_refs(r, files, n), _read_statistics(r, n)
    times = [r.u64() for _ in range(n)]
    versions = [Version(g, h, None if ref.offset == _NO_OFFSET else ref, s, t)
                for g, h, ref, s, t in zip(gens, heights, roots, stats, times)]
    m = r.varint()
    vgens, vrefs = r.varints(m), _read_refs(r, files, m)
    covered, vtimes = r.varints(m), [r.u64() for _ in range(m)]
    vheights = [r.byte() for _ in range(m)]
    r.done()
    nodes = [VersionNode(*v) for v in zip(vgens, vrefs, covered, vtimes,
                                          vheights)]
    return Manifest(config, versions, nodes)


def _read_keys(r: _Reader, n: int, interior: bool) -> tuple[list, list]:
    prefix = [0] + r.varints(max(n - 1, 0))
    suffix = r.varints(n)
    common = r.varints(n) if interior else [0] * n
    keys, prev = [], b""
    for i in range(n):
        if prefix[i] > len(prev):
            raise OcdbtError("node: key prefix past the previous key")
        prev = prev[: prefix[i]] + r.take(suffix[i])
        keys.append(prev)
    return keys, common


def decode_node(data: bytes) -> Node:
    r = _Reader(_unframe(data, NODE_MAGIC, "B-tree node"))
    height = r.byte()
    files = _read_files(r)
    n = r.varint()
    keys, common = _read_keys(r, n, interior=height > 0)
    if height > 0:
        refs, stats = _read_refs(r, files, n), _read_statistics(r, n)
        r.done()
        return Node(height, [InteriorEntry(*e) for e in
                             zip(keys, common, refs, stats)])
    lengths = r.varints(n)
    kinds = [r.byte() for _ in range(n)]
    if any(k not in (0, 1) for k in kinds):
        raise OcdbtError("node: unknown value kind")
    m = sum(kinds)
    ids, offsets = r.varints(m), r.varints(m)
    if any(i >= len(files) for i in ids):
        raise OcdbtError("node: file id past the data file table")
    entries, j = [], 0
    for key, length, kind in zip(keys, lengths, kinds):
        if kind:
            value = Ref(files[ids[j]], offsets[j], length)
            j += 1
        else:
            value = r.take(length)
        entries.append(LeafEntry(key, value))
    r.done()
    return Node(0, entries)


# --------------------------------------------------------------- reading


class Database:
    """The latest version of the database at `root`, read from its
    top-level manifest: `entries` maps every key to its inline value or the
    range of a data file that holds it; `value(key)` reads it."""

    def __init__(self, root: str | os.PathLike):
        self.root = Path(root).resolve()
        manifest = self.root / MANIFEST_NAME
        if not manifest.is_file():
            raise FileNotFoundError(f"{manifest}: no OCDBT manifest (an Orbax "
                                    "checkpoint directory holds one)")
        self.manifest = decode_manifest(manifest.read_bytes())
        if not self.manifest.versions:
            raise OcdbtError(f"{manifest}: no version")
        self.entries: dict[bytes, bytes | Ref] = {}
        latest = max(self.manifest.versions, key=lambda v: v.generation)
        if latest.root is not None:
            self._walk(latest.root, latest.root_height, b"")
        if len(self.entries) != latest.statistics.num_keys:
            raise OcdbtError(f"{manifest}: {len(self.entries)} keys, the "
                             f"manifest counts {latest.statistics.num_keys}")

    def _path(self, file: DataFile) -> Path:
        path = (self.root / file.path).resolve()
        if self.root not in path.parents:
            raise OcdbtError(f"data file {file.path!r} lies outside {self.root}")
        return path

    def read(self, ref: Ref) -> bytes:
        with open(self._path(ref.file), "rb") as f:
            f.seek(ref.offset)
            data = f.read(ref.length)
        if len(data) != ref.length:
            raise OcdbtError(f"{ref.file.path}: {len(data)} of {ref.length} "
                             f"bytes at offset {ref.offset}")
        return data

    def _walk(self, ref: Ref, height: int, prefix: bytes) -> None:
        node = decode_node(self.read(ref))
        if node.height != height:
            raise OcdbtError(f"node at {ref} has height {node.height}, its "
                             f"parent says {height}")
        for e in node.entries:
            if height:
                self._walk(e.location, height - 1,
                           prefix + e.key[: e.subtree_common_prefix_length])
            else:
                self.entries[prefix + e.key] = e.value

    def value(self, key: bytes) -> bytes:
        v = self.entries[key]
        return self.read(v) if isinstance(v, Ref) else v


# -------------------------------------------------------------- encoding


def _varint(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _varints(vs) -> bytes:
    return b"".join(_varint(v) for v in vs)


def _common(a: bytes | str, b: bytes | str) -> int:
    n = 0
    for x, y in zip(a, b):
        if x != y:
            break
        n += 1
    return n


def _frame(magic: int, body: bytes, level: int | None) -> bytes:
    head = _varint(FORMAT_VERSION) + _varint(0 if level is None else 1)
    payload = body if level is None else zstd_compress(body, level)
    n = 4 + 8 + len(head) + len(payload) + 4
    data = magic.to_bytes(4, "big") + n.to_bytes(8, "little") + head + payload
    return data + crc32c(data).to_bytes(4, "little")


def _file_table(files: list[DataFile]) -> bytes:
    paths = [f.path for f in files]
    prefix = [_common(a, b) for a, b in zip(paths, paths[1:])]
    return (_varint(len(files)) + _varints(prefix)
            + _varints(len(p) - k for p, k in zip(paths, [0] + prefix))
            + _varints(len(f.base) for f in files)
            + b"".join(p[k:].encode() for p, k in zip(paths, [0] + prefix)))


def _keys(keys: list[bytes], common: list[int] | None) -> bytes:
    prefix = [_common(a, b) for a, b in zip(keys, keys[1:])]
    return (_varint(len(keys)) + _varints(prefix)
            + _varints(len(k) - p for k, p in zip(keys, [0] + prefix))
            + (_varints(common) if common is not None else b"")
            + b"".join(k[p:] for k, p in zip(keys, [0] + prefix)))


def encode_node_body(node: Node) -> bytes:
    refs = ([e.location for e in node.entries] if node.height else
            [e.value for e in node.entries if isinstance(e.value, Ref)])
    files = sorted({r.file for r in refs}, key=lambda f: f.path)
    fid = {f: i for i, f in enumerate(files)}
    out = [bytes([node.height]), _file_table(files)]
    keys = [e.key for e in node.entries]
    if node.height:
        out += [_keys(keys, [e.subtree_common_prefix_length
                             for e in node.entries]),
                _varints(fid[r.file] for r in refs),
                _varints(r.offset for r in refs),
                _varints(r.length for r in refs)]
        for col in range(3):
            out.append(_varints(e.statistics[col] for e in node.entries))
        return b"".join(out)
    values = [e.value for e in node.entries]
    out += [_keys(keys, None),
            _varints(v.length if isinstance(v, Ref) else len(v) for v in values),
            bytes(int(isinstance(v, Ref)) for v in values),
            _varints(fid[r.file] for r in refs),
            _varints(r.offset for r in refs),
            b"".join(v for v in values if not isinstance(v, Ref))]
    return b"".join(out)


def encode_node(node: Node, level: int | None) -> bytes:
    return _frame(NODE_MAGIC, encode_node_body(node), level)


def encode_manifest(manifest: Manifest) -> bytes:
    """A manifest of versions only (the writer's one): interior
    version-tree nodes are not written."""
    if manifest.version_tree_nodes:
        raise ValueError("encoding version-tree nodes is not supported")
    c = manifest.config
    vs = manifest.versions
    refs = [v.root or Ref(DataFile("", ""), _NO_OFFSET, _NO_OFFSET) for v in vs]
    files = sorted({r.file for r in refs}, key=lambda f: f.path)
    fid = {f: i for i, f in enumerate(files)}
    out = [c.uuid, _varint(c.manifest_kind), _varint(c.max_inline_value_bytes),
           _varint(c.max_decoded_node_bytes), bytes([c.version_tree_arity_log2]),
           _varint(0) if c.zstd_level is None else
           _varint(1) + c.zstd_level.to_bytes(4, "little", signed=True),
           _file_table(files), _varint(len(vs)),
           _varints(v.generation for v in vs), bytes(v.root_height for v in vs)]
    out += [_varints(fid[r.file] for r in refs),
            _varints(r.offset for r in refs), _varints(r.length for r in refs)]
    for col in range(3):
        out.append(_varints(v.statistics[col] for v in vs))
    out += [v.commit_time.to_bytes(8, "little") for v in vs]
    out.append(_varint(0))   # no interior version-tree node
    return _frame(MANIFEST_MAGIC, b"".join(out), c.zstd_level)


# --------------------------------------------------------------- writing


def _runs(entries: list, height: int, limit: int, lo: int = 0,
          hi: int | None = None) -> list[tuple[int, int]]:
    """[lo, hi) cut into index ranges whose node body fits in `limit`
    bytes (counted with the keys unstripped, so never under)."""
    hi = len(entries) if hi is None else hi
    if (hi - lo == 1
            or len(encode_node_body(Node(height, entries[lo:hi]))) <= limit):
        return [(lo, hi)]
    mid = (lo + hi) // 2
    return (_runs(entries, height, limit, lo, mid)
            + _runs(entries, height, limit, mid, hi))


def write_database(root: str | os.PathLike, items: dict[bytes, bytes], *,
                   max_decoded_node_bytes: int = MAX_DECODED_NODE_BYTES
                   ) -> None:
    """A new database at `root` holding `items` in orbax's configuration:
    one version (generation 1); values longer than MAX_INLINE_VALUE_BYTES
    and every node (zstd at its default level) in one data file `d/<hex>`;
    the manifest written last. The B-tree is one leaf
    node unless its body would exceed `max_decoded_node_bytes`; then
    leaves under as many interior levels as that limit needs, each node's
    keys stripped of the prefix that all keys of its subtree share."""
    root = Path(root)
    (root / "d").mkdir(parents=True, exist_ok=True)
    data_file = DataFile("", f"d/{uuid_lib.uuid4().hex}")
    blobs, offset = [], 0
    # a level's entries with full keys (an interior entry's subtree common
    # prefix length counted on its full key too), and each one's subtree's
    # first and last key
    entries, bounds = [], []
    for key in sorted(items):
        value = bytes(items[key])
        if len(value) > MAX_INLINE_VALUE_BYTES:
            blobs.append(value)
            value = Ref(data_file, offset, len(value))
            offset += value.length
        entries.append(LeafEntry(key, value))
        bounds.append((key, key))
    height, top = 0, None
    while entries:
        runs = _runs(entries, height, max_decoded_node_bytes)
        parents, parent_bounds = [], []
        for lo, hi in runs:
            first, last = bounds[lo][0], bounds[hi - 1][1]
            strip = 0 if len(runs) == 1 else _common(first, last)
            if height:
                run = [e._replace(key=e.key[strip:],
                                  subtree_common_prefix_length=
                                  e.subtree_common_prefix_length - strip)
                       for e in entries[lo:hi]]
                stats = [sum(e.statistics[i] for e in run) for i in range(3)]
            else:
                run = [e._replace(key=e.key[strip:]) for e in entries[lo:hi]]
                stats = [len(run), 0, sum(e.value.length for e in run
                                          if isinstance(e.value, Ref))]
            data = encode_node(Node(height, run), NODE_ZSTD_LEVEL)
            blobs.append(data)
            stats[1] += len(data)
            parents.append(InteriorEntry(first, strip,
                                         Ref(data_file, offset, len(data)),
                                         Statistics(*stats)))
            parent_bounds.append((first, last))
            offset += len(data)
        if len(parents) == 1:
            top = parents[0]
            break
        entries, bounds, height = parents, parent_bounds, height + 1
    with open(root / data_file.relative, "wb") as f:
        for blob in blobs:
            f.write(blob)
    version = Version(1, height, top.location if top else None,
                      top.statistics if top else Statistics(0, 0, 0),
                      time.time_ns())
    config = Config(uuid_lib.uuid4().bytes, 0, MAX_INLINE_VALUE_BYTES,
                    max_decoded_node_bytes, VERSION_TREE_ARITY_LOG2,
                    NODE_ZSTD_LEVEL)
    tmp = root / f"{MANIFEST_NAME}.tmp{os.getpid()}"
    tmp.write_bytes(encode_manifest(Manifest(config, [version], [])))
    os.replace(tmp, root / MANIFEST_NAME)
