"""Read and write the JAX package's Orbax checkpoints, with numpy and the
port's own zstd decoder and CRC-32C: no orbax, tensorstore, jax or
zstandard.

``retinex_tpu/train/checkpoint.py`` writes ``<save_dir>/{best,latest}`` with
``orbax.checkpoint.StandardCheckpointer``. Such a directory holds:

- ``_METADATA`` (JSON): every leaf of the saved tree by its key path, each
  key a dict key (``key_type`` 2; namedtuple fields are saved so too) or a
  sequence index (1), and the leaf's value type;
- an OCDBT key-value store (tensorstore's "optionally-cooperative
  distributed B+tree"): ``manifest.ocdbt`` at the root names the latest
  version's root B-tree node; leaf nodes hold each key's value inline, or
  its place in a data file. Each process of the save wrote its own database
  under ``ocdbt.process_<i>/``, and the root's nodes refer to their data
  files. Manifests and nodes start with a magic number and their length,
  end with a CRC-32C (checked), and their bodies are zstd-compressed;
- one zarr v2 array per leaf in that store, named by the leaf's key path
  joined with dots (``params.fusion.kernel/.zarray`` and the chunks
  ``params.fusion.kernel/0.0.0.0``, ...), each chunk zstd-compressed. An
  array sharded over n devices is n chunks; they are put back together
  here, so a checkpoint reads the same whatever mesh wrote it.

``read_orbax(path)`` returns the tree as orbax's own restore without a
target does: nested dicts, lists for sequences, numpy arrays (``scalar``
leaves as Python numbers, empty containers and ``None`` as saved).
``bfloat16`` arrays come back as float32, which holds every bfloat16 value
exactly. Only the layout orbax 0.11 writes by default is read: anything
else (a zarr v3 ``zarr.json``, an aggregated ``checkpoint`` msgpack file, a
non-OCDBT layout, a numbered manifest, a compressor other than zstd) raises
``OrbaxFormatError`` naming what was found. A checkpoint written by several
processes is read the same way (the root's nodes point into every
process's files); the tests can only write single-process ones.

``write_orbax(path, tree)`` writes what orbax 0.11's
``StandardCheckpointer`` writes in one process, in the simplest form the
format allows, since the port has no zstd encoder: each array one zarr v2
chunk that is a zstd frame of stored blocks (``zstd_stored``), the store
one uncompressed B-tree leaf node (the arrays' chunks over 1024 bytes in
one data file under ``d/``, the rest inline) and an uncompressed
single-file manifest; no ``_sharding`` file (orbax then restores with the
template's shardings, or as numpy arrays without a template). Orbax,
tensorstore and ``read_orbax`` read it.

The zstd decoder and the CRC-32C are ``csrc/zstd_decode.cpp``, built with
the host's C++ compiler on first use (``ops/_kernels.host_library``).
"""

from __future__ import annotations

import ctypes
import functools
import json
import math
import os
import struct
import time
import uuid

import numpy as np

from retinex_tpu_torch.ops._kernels import host_library

MANIFEST_MAGIC = 0x0CDB3A2A
NODE_MAGIC = 0x0CDB20DE
_NO_ROOT = (1 << 64) - 1  # a version whose tree is empty


class OrbaxFormatError(ValueError):
    """The path is not an Orbax checkpoint of the layout read here."""


@functools.lru_cache(maxsize=1)
def _zstd():
    lib = host_library("zstd_decode")
    lib.zstd_decode.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t, ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_size_t),
        ctypes.c_char_p, ctypes.c_size_t,
    ]
    lib.zstd_decode.restype = ctypes.c_int
    lib.zstd_free.argtypes = [ctypes.c_void_p]
    lib.zstd_free.restype = None
    lib.crc32c.argtypes = [ctypes.c_char_p, ctypes.c_size_t]
    lib.crc32c.restype = ctypes.c_uint32
    return lib


def zstd_decompress(data: bytes) -> bytes:
    """Every zstd frame in `data`, decoded and joined (skippable frames
    skipped); ValueError on anything malformed or on a dictionary."""
    lib = _zstd()
    out, n = ctypes.c_void_p(), ctypes.c_size_t()
    err = ctypes.create_string_buffer(256)
    rc = lib.zstd_decode(data, len(data), ctypes.byref(out), ctypes.byref(n), err, len(err))
    if rc != 0:
        raise ValueError(f"zstd: {err.value.decode()}")
    try:
        return ctypes.string_at(out, n.value)
    finally:
        lib.zstd_free(out)


def crc32c(data: bytes) -> int:
    return int(_zstd().crc32c(data, len(data)))


# ---- OCDBT -------------------------------------------------------------------


class _Bytes:
    """A cursor over a decoded manifest or node body."""

    def __init__(self, data: bytes, what: str):
        self.b, self.p, self.what = data, 0, what

    def take(self, n: int) -> bytes:
        if self.p + n > len(self.b):
            raise OrbaxFormatError(f"{self.what}: truncated")
        out = self.b[self.p:self.p + n]
        self.p += n
        return out

    def u8(self) -> int:
        return self.take(1)[0]

    def varint(self) -> int:
        v = shift = 0
        while True:
            c = self.u8()
            v |= (c & 0x7F) << shift
            shift += 7
            if c < 0x80:
                return v
            if shift > 63:
                raise OrbaxFormatError(f"{self.what}: varint too long")

    def varints(self, n: int) -> list[int]:
        return [self.varint() for _ in range(n)]


def _framed(raw: bytes, magic: int, what: str) -> _Bytes:
    """The body of a manifest or node: magic (big-endian), total length,
    version 0, compression (0 none, 1 zstd), body, CRC-32C of the rest."""
    if len(raw) < 16 or struct.unpack(">I", raw[:4])[0] != magic:
        raise OrbaxFormatError(f"{what}: not an OCDBT {'manifest' if magic == MANIFEST_MAGIC else 'B-tree node'}")
    if struct.unpack("<Q", raw[4:12])[0] != len(raw):
        raise OrbaxFormatError(f"{what}: length field does not match the file")
    if crc32c(raw[:-4]) != struct.unpack("<I", raw[-4:])[0]:
        raise OrbaxFormatError(f"{what}: CRC-32C mismatch")
    head = _Bytes(raw[:-4], what)
    head.p = 12
    version, compression = head.varint(), head.varint()
    if version != 0:
        raise OrbaxFormatError(f"{what}: OCDBT format version {version}")
    body = raw[head.p:-4]
    if compression == 1:
        body = zstd_decompress(body)
    elif compression != 0:
        raise OrbaxFormatError(f"{what}: compression format {compression}")
    return _Bytes(body, what)


def _file_table(r: _Bytes, base: str) -> list[tuple[str, str]]:
    """The data files a manifest or node refers to, as (path from the
    checkpoint's root, that file's base path). Paths are prefix-coded; each
    is relative to the base path of the file holding the table."""
    n = r.varint()
    prefix = [0] + r.varints(max(n - 1, 0))
    suffix = r.varints(n)
    base_len = r.varints(n)
    out, prev = [], b""
    for i in range(n):
        full = prev[:prefix[i]] + r.take(suffix[i])
        prev = full
        text = full.decode()
        out.append((base + text, base + text[:base_len[i]]))
    return out


def _read_at(path: str, offset: int, length: int) -> bytes:
    with open(path, "rb") as f:
        data = os.pread(f.fileno(), length, offset)
    if len(data) != length:
        raise OrbaxFormatError(f"{path}: {length} bytes at {offset} run past the file")
    return data


def _manifest_root(root: str):
    """(file, base, offset, length, height) of the latest version's root
    node, or None for an empty store."""
    path = os.path.join(root, "manifest.ocdbt")
    with open(path, "rb") as f:
        r = _framed(f.read(), MANIFEST_MAGIC, path)
    r.take(16)  # the database's uuid
    kind = r.varint()
    if kind != 0:
        raise OrbaxFormatError(f"{path}: manifest kind {kind} (numbered manifests); orbax writes a single one")
    r.varint(), r.varint()  # max inline value bytes, max decoded node bytes
    r.u8()  # version tree arity (log2)
    if r.varint() == 1:  # node compression: zstd, and its level
        r.take(4)
    files = _file_table(r, "")
    n = r.varint()
    if n == 0:
        return None
    r.varints(n)  # generation numbers
    heights = list(r.take(n))
    file_ids, offsets, lengths = r.varints(n), r.varints(n), r.varints(n)
    if offsets[-1] == _NO_ROOT:
        return None
    name, base = files[file_ids[-1]]
    return os.path.join(root, name), base, offsets[-1], lengths[-1], heights[-1]


def _node(root: str, file: str, base: str, offset: int, length: int, height: int, key_prefix: bytes, out: dict):
    """Every entry under one B-tree node into `out`: key -> the value's bytes
    (inline) or (file, offset, length)."""
    what = f"{file}@{offset}"
    r = _framed(_read_at(file, offset, length), NODE_MAGIC, what)
    if r.u8() != height:
        raise OrbaxFormatError(f"{what}: node height does not match its parent's")
    files = _file_table(r, base)
    n = r.varint()
    prefix = [0] + r.varints(max(n - 1, 0))
    suffix = r.varints(n)
    subtree_prefix = r.varints(n) if height > 0 else None
    keys, prev = [], b""
    for i in range(n):
        k = prev[:prefix[i]] + r.take(suffix[i])
        keys.append(k)
        prev = k
    if height > 0:
        file_ids, offsets, lengths = r.varints(n), r.varints(n), r.varints(n)
        r.varints(3 * n)  # per child: keys, tree bytes, indirect value bytes
        for i in range(n):
            name, child_base = files[file_ids[i]]
            _node(root, os.path.join(root, name), child_base, offsets[i], lengths[i], height - 1,
                  key_prefix + keys[i][:subtree_prefix[i]], out)
        return
    value_lengths = r.varints(n)
    kinds = r.varints(n)
    indirect = [i for i in range(n) if kinds[i] == 1]
    if any(k not in (0, 1) for k in kinds):
        raise OrbaxFormatError(f"{what}: value kind {max(kinds)}")
    file_ids, offsets = r.varints(len(indirect)), r.varints(len(indirect))
    where = dict(zip(indirect, zip(file_ids, offsets)))
    for i in range(n):
        key = (key_prefix + keys[i]).decode()
        if kinds[i] == 0:
            out[key] = r.take(value_lengths[i])
        else:
            fid, off = where[i]
            out[key] = (os.path.join(root, files[fid][0]), off, value_lengths[i])


def read_ocdbt(root: str) -> dict:
    """The store's keys -> inline bytes or (file, offset, length) of the
    value in a data file (``value_bytes`` reads either)."""
    top = _manifest_root(root)
    out: dict = {}
    if top is not None:
        file, base, offset, length, height = top
        _node(root, file, base, offset, length, height, b"", out)
    return out


def value_bytes(ref) -> bytes:
    return ref if isinstance(ref, bytes) else _read_at(*ref)


# ---- zarr v2 arrays -------------------------------------------------------------


def _zarr_dtype(text: str, what: str):
    """(stored dtype, dtype returned); bfloat16 is stored as its 16 bits."""
    if text == "bfloat16":
        return np.dtype("<u2"), np.dtype(np.float32)
    try:
        dt = np.dtype(text)
    except TypeError as e:
        raise OrbaxFormatError(f"{what}: zarr dtype {text!r}") from e
    if dt.kind not in "biufc" or dt.fields is not None:
        raise OrbaxFormatError(f"{what}: zarr dtype {text!r}")
    return dt, dt


_FILLS = {None: 0, "NaN": np.nan, "Infinity": np.inf, "-Infinity": -np.inf}  # zarr v2's JSON fill values


def read_zarr(store: dict, name: str) -> np.ndarray:
    """One zarr v2 array of the store, its chunks put back together."""
    key = f"{name}/.zarray"
    if key not in store:
        if f"{name}/zarr.json" in store:
            raise OrbaxFormatError(f"{name}: a zarr v3 array (zarr.json); orbax writes zarr v2 here")
        raise OrbaxFormatError(f"{name}: no {key} in the checkpoint")
    meta = json.loads(value_bytes(store[key]))
    if meta.get("zarr_format") != 2:
        raise OrbaxFormatError(f"{name}: zarr_format {meta.get('zarr_format')}")
    compressor = meta.get("compressor")
    if not isinstance(compressor, dict) or compressor.get("id") != "zstd":
        raise OrbaxFormatError(f"{name}: compressor {compressor}; orbax writes zstd")
    if meta.get("filters"):
        raise OrbaxFormatError(f"{name}: filters {meta['filters']}")
    order = meta.get("order", "C")
    sep = meta.get("dimension_separator", ".")
    if order not in ("C", "F") or sep != ".":
        raise OrbaxFormatError(f"{name}: order {order!r}, dimension separator {sep!r}")
    stored, dtype = _zarr_dtype(meta["dtype"], name)
    shape, chunks = tuple(meta["shape"]), tuple(meta["chunks"])
    fill = meta.get("fill_value")
    if fill is None or isinstance(fill, str):
        if fill not in _FILLS:
            raise OrbaxFormatError(f"{name}: fill value {fill!r}")
        fill = _FILLS[fill]
    if stored != dtype and fill != 0:
        raise OrbaxFormatError(f"{name}: bfloat16 fill value {meta['fill_value']!r}")
    raw = np.full(shape, fill, stored)
    grid = [math.ceil(s / c) if s else 0 for s, c in zip(shape, chunks)]
    chunk_bytes = math.prod(chunks) * stored.itemsize
    for idx in np.ndindex(*grid):
        ref = store.get(f"{name}/{'.'.join(map(str, idx)) if idx else '0'}")
        if ref is None:
            continue  # never written: the fill value
        data = zstd_decompress(value_bytes(ref))
        if len(data) != chunk_bytes:
            raise OrbaxFormatError(f"{name}: chunk {idx} holds {len(data)} bytes, not {chunk_bytes}")
        chunk = np.frombuffer(data, stored).reshape(chunks, order=order)
        dst = tuple(slice(i * c, min((i + 1) * c, s)) for i, c, s in zip(idx, chunks, shape))
        raw[dst] = chunk[tuple(slice(0, d.stop - d.start) for d in dst)]
    if stored != dtype:
        return (raw.astype(np.uint32) << 16).view(np.float32)
    return raw


# ---- the tree ---------------------------------------------------------------------

_EMPTY = {"None": None, "Dict": dict, "List": list, "Tuple": tuple}
_ARRAY_TYPES = ("np.ndarray", "jax.Array", "scalar")


def _check_layout(path: str) -> dict:
    if not os.path.isdir(path):
        raise OrbaxFormatError(f"{path} is not a directory, so not an Orbax checkpoint")
    if os.path.exists(os.path.join(path, "checkpoint")):
        raise OrbaxFormatError(f"{path}: an aggregated 'checkpoint' msgpack file; orbax 0.11 writes per-leaf arrays")
    meta_path = os.path.join(path, "_METADATA")
    if not os.path.exists(meta_path) or not os.path.exists(os.path.join(path, "manifest.ocdbt")):
        found = sorted(os.listdir(path))[:8]
        raise OrbaxFormatError(
            f"{path} is not an Orbax checkpoint: it needs _METADATA and manifest.ocdbt (found {found})"
        )
    with open(meta_path) as f:
        meta = json.load(f)
    if meta.get("use_zarr3"):
        raise OrbaxFormatError(f"{path}: written with use_zarr3 (zarr v3 arrays); orbax's default is zarr v2")
    if not meta.get("use_ocdbt", False):
        raise OrbaxFormatError(f"{path}: written without OCDBT")
    if "tree_metadata" not in meta:
        raise OrbaxFormatError(f"{path}: _METADATA has no tree_metadata")
    return meta["tree_metadata"]


def _seqs_to_lists(node):
    if isinstance(node, _Seq):
        items = sorted(node.items())
        if [i for i, _ in items] != list(range(len(items))):
            raise OrbaxFormatError(f"sequence indices {[i for i, _ in items]} are not 0..n-1")
        return [_seqs_to_lists(v) for _, v in items]
    if isinstance(node, dict):
        return {k: _seqs_to_lists(v) for k, v in node.items()}
    return node


class _Seq(dict):
    """A sequence node while the tree is built (index -> child)."""


def read_orbax(path: str, select: tuple[str, ...] | None = None) -> dict:
    """The checkpoint at `path` as nested dicts and lists of numpy arrays
    (module docstring); with `select`, only those top-level keys."""
    tree_meta = _check_layout(path)
    store = read_ocdbt(path)
    tree: dict = {}
    for entry in tree_meta.values():
        keys = entry["key_metadata"]
        value = entry["value_metadata"]
        if select is not None and keys[0]["key"] not in select:
            continue
        node = tree
        for depth, km in enumerate(keys):
            kind = km["key_type"]
            if kind not in (1, 2):
                raise OrbaxFormatError(f"{path}: key type {kind} at {[k['key'] for k in keys]}")
            k = int(km["key"]) if kind == 1 else km["key"]
            if depth + 1 == len(keys):
                break
            nxt_kind = keys[depth + 1]["key_type"]
            child = node.get(k)
            if child is None:
                child = node[k] = _Seq() if nxt_kind == 1 else {}
            elif isinstance(child, _Seq) != (nxt_kind == 1):
                raise OrbaxFormatError(f"{path}: {[x['key'] for x in keys[:depth + 1]]} is both a list and a dict")
            node = child
        vtype = value["value_type"]
        if vtype in _EMPTY:
            node[k] = None if _EMPTY[vtype] is None else _EMPTY[vtype]()
        elif vtype in _ARRAY_TYPES and not value.get("skip_deserialize", False):
            arr = read_zarr(store, ".".join(str(km["key"]) for km in keys))
            node[k] = arr.item() if vtype == "scalar" else arr
        else:
            raise OrbaxFormatError(f"{path}: value type {vtype!r} at {[x['key'] for x in keys]}")
    return _seqs_to_lists(tree)


# ---- writing ------------------------------------------------------------------------

# orbax 0.11's store settings (tensorstore_utils.add_ocdbt_write_options) and
# its item handler's name in _CHECKPOINT_METADATA.
MAX_INLINE_VALUE_BYTES = 1024
MAX_DECODED_NODE_BYTES = 100_000_000
_VERSION_TREE_ARITY_LOG2 = 4
HANDLER = "orbax.checkpoint._src.handlers.standard_checkpoint_handler.StandardCheckpointHandler"
_ZSTD_MAGIC = b"\x28\xb5\x2f\xfd"
_ZSTD_BLOCK = 128 * 1024  # the largest block a frame may hold


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        out.append((n & 0x7F) | (0x80 if n > 0x7F else 0))
        n >>= 7
        if not n:
            return bytes(out)


def _varints(ns) -> bytes:
    return b"".join(_varint(n) for n in ns)


def zstd_stored(data) -> bytes:
    """`data` as one zstd frame of raw (stored) blocks: a valid RFC 8878
    frame that any decoder reads, about as long as `data`. Single segment,
    the content size in the header, no checksum."""
    data = memoryview(data).cast("B")
    n = len(data)
    for flag, width, size in ((0, 1, n), (1, 2, n - 256), (2, 4, n), (3, 8, n)):
        if 0 <= size < 1 << (8 * width):
            break
    out = [_ZSTD_MAGIC, bytes([flag << 6 | 0x20]), size.to_bytes(width, "little")]
    starts = range(0, n, _ZSTD_BLOCK) if n else [0]
    for start in starts:
        block = data[start:start + _ZSTD_BLOCK]
        last = start + _ZSTD_BLOCK >= n
        out += [(len(block) << 3 | int(last)).to_bytes(3, "little"), block]
    return b"".join(out)


def _frame_of(body: bytes, magic: int) -> bytes:
    """What ``_framed`` reads: magic, total length, version 0, compression
    0 (none), the body, the CRC-32C of all before it."""
    head = struct.pack(">I", magic)
    rest = _varint(0) + _varint(0) + body
    raw = head + struct.pack("<Q", len(head) + 8 + len(rest) + 4) + rest
    return raw + struct.pack("<I", crc32c(raw))


def _table_of(paths: list[str]) -> bytes:
    """A data file table (``_file_table``), each path's base path empty."""
    names = [p.encode() for p in paths]
    prefix = [len(os.path.commonprefix([a, b])) for a, b in zip(names, names[1:])]
    suffix = [len(k) - p for k, p in zip(names, [0, *prefix])]
    return (_varint(len(names)) + _varints(prefix) + _varints(suffix) + _varints([0] * len(names))
            + b"".join(k[p:] for k, p in zip(names, [0, *prefix])))


def _leaf_node(values: dict[bytes, bytes | tuple[int, int]], data_file: str) -> bytes:
    """One B-tree leaf node (height 0) of every key: inline bytes, or
    (offset, length) in `data_file`."""
    keys = sorted(values)
    prefix = [len(os.path.commonprefix([a, b])) for a, b in zip(keys, keys[1:])]
    suffix = [len(k) - p for k, p in zip(keys, [0, *prefix])]
    indirect = [k for k in keys if isinstance(values[k], tuple)]
    body = [
        b"\x00", _table_of([data_file] if indirect else []), _varint(len(keys)), _varints(prefix), _varints(suffix),
        b"".join(k[p:] for k, p in zip(keys, [0, *prefix])),
        _varints(values[k][1] if isinstance(values[k], tuple) else len(values[k]) for k in keys),
        _varints(int(isinstance(values[k], tuple)) for k in keys),
        _varints([0] * len(indirect)), _varints(values[k][0] for k in indirect),
        b"".join(values[k] for k in keys if not isinstance(values[k], tuple)),
    ]
    return b"".join(body)


def _manifest(data_file: str, node_offset: int, node_length: int, num_keys: int, indirect_bytes: int) -> bytes:
    """A single-file manifest of one version (generation 1) whose root is the
    leaf node at `node_offset` in `data_file`; config as orbax writes it but
    with uncompressed nodes."""
    body = [
        uuid.uuid4().bytes, _varint(0), _varint(MAX_INLINE_VALUE_BYTES), _varint(MAX_DECODED_NODE_BYTES),
        bytes([_VERSION_TREE_ARITY_LOG2]), _varint(0), _table_of([data_file]),
        # one version: generation, root height, file, offset, length, keys,
        # tree bytes, indirect value bytes, commit time; no version nodes
        _varint(1), _varint(1), b"\x00", _varint(0), _varint(node_offset), _varint(node_length),
        _varint(num_keys), _varint(node_length), _varint(indirect_bytes), struct.pack("<Q", time.time_ns()), _varint(0),
    ]
    return _frame_of(b"".join(body), MANIFEST_MAGIC)


_EMPTY_TYPES = {type(None) if t is None else t: name for name, t in _EMPTY.items()}


def _entries(tree, keys: tuple = ()):
    """(key metadata, leaf) of every leaf in the tree's order; a non-empty
    dict's keys are dict keys, a non-empty list's or tuple's indices."""
    if isinstance(tree, dict) and tree:
        for k, v in tree.items():
            yield from _entries(v, (*keys, {"key": str(k), "key_type": 2}))
    elif isinstance(tree, (list, tuple)) and tree:
        for i, v in enumerate(tree):
            yield from _entries(v, (*keys, {"key": str(i), "key_type": 1}))
    else:
        yield list(keys), tree


def _zarray(arr: np.ndarray) -> bytes:
    meta = {"chunks": [max(s, 1) for s in arr.shape], "compressor": {"id": "zstd", "level": 1},
            "dimension_separator": ".", "dtype": arr.dtype.str, "fill_value": None, "filters": None,
            "order": "C", "shape": list(arr.shape), "zarr_format": 2}
    return json.dumps(meta, separators=(",", ":"), sort_keys=True).encode()


def write_orbax(path: str, tree, numpy_keys=()) -> int:
    """Write `tree` at `path` (a new directory) as orbax 0.11's
    ``StandardCheckpointer`` writes it in one process: ``_METADATA``,
    ``_CHECKPOINT_METADATA``, ``manifest.ocdbt`` and one data file under
    ``d/`` holding every array's chunk that is not inline and the store's
    one B-tree leaf node. Leaves: numpy arrays (value type ``jax.Array``,
    or ``np.ndarray`` at the key paths of `numpy_keys`, tuples of keys),
    Python ints and floats (``scalar``), None and empty containers. Each
    array is one zarr v2 chunk, a zstd frame of stored blocks; nodes and
    the manifest are uncompressed. Returns the bytes written."""
    os.makedirs(path)
    numpy_keys = {tuple(k) for k in numpy_keys}
    tree_meta, values, chunks = {}, {}, []
    for keys, leaf in _entries(tree):
        names = tuple(km["key"] for km in keys)
        if type(leaf) in _EMPTY_TYPES:
            value = {"value_type": _EMPTY_TYPES[type(leaf)], "skip_deserialize": True}
        elif isinstance(leaf, (int, float, np.ndarray)) and not isinstance(leaf, bool):
            arr = np.asarray(leaf)
            if arr.dtype.kind not in "biufc":
                raise TypeError(f"{'.'.join(names)}: cannot write dtype {arr.dtype}")
            if isinstance(leaf, np.ndarray):
                value = ({"value_type": "np.ndarray", "skip_deserialize": False} if names in numpy_keys else
                         {"value_type": "jax.Array", "skip_deserialize": False, "write_shape": list(arr.shape)})
            else:
                value = {"value_type": "scalar", "skip_deserialize": False}
            name = ".".join(names)
            values[f"{name}/.zarray".encode()] = _zarray(arr)
            if arr.size:
                chunk = zstd_stored(np.ascontiguousarray(arr).view(np.uint8).reshape(-1))
                key = f"{name}/{'.'.join('0' * arr.ndim) if arr.ndim else '0'}".encode()
                values[key] = chunk
        else:
            raise TypeError(f"{'.'.join(names)}: cannot write a leaf of type {type(leaf).__name__}")
        tree_meta[repr(names)] = {"key_metadata": keys, "value_metadata": value}
    # Chunks over the inline limit go to the data file, the node after them.
    data_file = f"d/{uuid.uuid4().hex}"
    offset = 0
    for key, value in values.items():
        if len(value) > MAX_INLINE_VALUE_BYTES:
            chunks.append(value)
            values[key] = (offset, len(value))
            offset += len(value)
    node = _frame_of(_leaf_node(values, data_file), NODE_MAGIC)
    if len(node) > MAX_DECODED_NODE_BYTES:
        raise ValueError(f"{path}: a B-tree node of {len(node)} bytes; orbax's limit is {MAX_DECODED_NODE_BYTES}")
    started = time.time_ns()
    os.makedirs(os.path.join(path, "d"))
    files = {
        data_file: [*chunks, node],
        "manifest.ocdbt": [_manifest(data_file, offset, len(node), len(values), offset)],
        "_METADATA": [json.dumps({"tree_metadata": tree_meta, "use_ocdbt": True, "use_zarr3": False,
                                  "store_array_data_equal_to_fill_value": True, "custom_metadata": None}).encode()],
    }
    written = 0
    for name, parts in files.items():
        with open(os.path.join(path, name), "wb") as f:
            f.writelines(parts)
        written += sum(len(p) for p in parts)
    meta = json.dumps({"item_handlers": HANDLER, "metrics": {}, "performance_metrics": {},
                       "init_timestamp_nsecs": started, "commit_timestamp_nsecs": time.time_ns(),
                       "custom_metadata": {}}).encode()
    with open(os.path.join(path, "_CHECKPOINT_METADATA"), "wb") as f:
        f.write(meta)
    return written + len(meta)
