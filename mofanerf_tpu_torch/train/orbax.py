"""Read a step that the JAX package saved with Orbax, without Orbax.

A step directory (`mofanerf_tpu/train/checkpoint.py::save_checkpoint`, or
any `PyTreeCheckpointHandler` of orbax-checkpoint 0.11 that
`StandardCheckpointer().restore` reads) holds:

- `_METADATA`, JSON whose `tree_metadata` maps each leaf's key path (a
  stringified tuple such as "('opt_state', '0', 'mu', 'w')") to its keys, each
  with a `key_type` (1: a sequence index, so a tuple or list; 2: a dict key or
  a NamedTuple field by name) and a `value_metadata` whose `value_type` is
  "jax.Array" or "np.ndarray" for an array, "None" or null for an empty node
  (an optax state without fields), "List", "Tuple" or "Dict" for an empty
  container;
- each array under the key path joined by dots, as a zarr array: its
  metadata at `<key>/.zarray` (zarr v2) or `<key>/zarr.json` (zarr v3) and
  its chunks beside it. With OCDBT (`use_ocdbt`, the default) the keys are
  in an OCDBT database (`utils/ocdbt.py`; `manifest.ocdbt` and `d/` at the
  root, the values it merges from `ocdbt.process_0/`); without, each key is a
  file under the step directory. Both go through one reader of keys
  (`_Files`, `_Ocdbt`), so both layouts share the array code. The helper
  files `_CHECKPOINT_METADATA`, `_sharding` and `array_metadatas/` are not
  needed.

zarr v2 (`use_zarr3=False`): `{"chunks", "compressor", "dtype",
"fill_value", "order", "shape", "dimension_separator", "filters"}`, a chunk
at `<key>/0.1` (`0` for a scalar), each one zstd frame (`utils/zstd.py`);
null, zlib, gzip and bz2 compressors are read too.

zarr v3 (`use_zarr3=True`): `{"shape", "data_type", "chunk_grid" (regular),
"chunk_key_encoding" ("default": `c/0/1`, `c` for a scalar; "v2": `0.1`),
"fill_value", "codecs"}`. Orbax's codec chain is one `sharding_indexed`
codec: a shard holds a grid of inner chunks, each encoded by the codec's own
chain (`bytes` in either byte order, then `zstd`), and an index of (offset,
length) uint64 pairs at its end (or start), encoded by `bytes` and checked
by `crc32c`; an inner chunk not stored (both 2^64 - 1) holds the fill value,
as does a shard not stored. `transpose`, `gzip` and `crc32c` codecs are read
anywhere in a chain.

Refused (ValueError, naming what): zarr filters and structured dtypes
(tensorstore refuses them too), the blosc compressor and codec (tensorstore
reads them; no Orbax handler writes them), any other codec or compressor, a
shard index whose CRC-32C does not hold or that points past its shard, and a
chunk of the wrong size (tensorstore refuses those too).

`read_step` gives the tree as nested dicts and lists of CPU tensors. zarr's
`bfloat16` has no numpy dtype: it is read as uint16 and viewed as
torch.bfloat16. The JAX state types become `Node`s (dicts whose keys also
read as attributes), so that `bridge.train_state_to_torch` and
`bridge.refine_state_to_torch` take the tree as they take a JAX state.
"""
from __future__ import annotations

import ast
import bz2
import gzip
import itertools
import json
import math
import os
import zlib
from typing import Iterable, Optional

import numpy as np
import torch

from mofanerf_tpu_torch.utils import zstd
from mofanerf_tpu_torch.utils.ocdbt import Database, crc32c

_ARRAY_TYPES = ("jax.Array", "np.ndarray", "scalar")
_EMPTY = {None: lambda: None, "None": lambda: None, "List": list, "Tuple": list,
          "Dict": lambda: Node()}
_MISSING = 2 ** 64 - 1     # a sharding index entry of an inner chunk not stored
_DECOMPRESS = {"zstd": zstd.decompress, "zlib": zlib.decompress, "gzip": gzip.decompress,
               "bz2": bz2.decompress}


class Node(dict):
    """A dict node of a restored tree; its keys read as attributes too (the
    fields of the NamedTuples it stands for)."""

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError:
            raise AttributeError(name) from None


def is_orbax_step(path: str) -> bool:
    return os.path.isfile(os.path.join(path, "_METADATA"))


class _Files:
    """The keys of a step saved without OCDBT: files under its directory."""

    def __init__(self, root: str):
        self.root = root

    def get(self, key: str) -> bytes | None:
        path = os.path.join(self.root, *key.split("/"))
        if not os.path.isfile(path):
            return None
        with open(path, "rb") as f:
            return f.read()


class _Ocdbt:
    """The keys of a step saved with OCDBT: the newest version of its
    database."""

    def __init__(self, root: str):
        self.root = root
        self.db = Database(root)
        self.entries = self.db.entries()

    def get(self, key: str) -> bytes | None:
        ref = self.entries.get(key.encode())
        return None if ref is None else self.db.value(ref)


def _open(path: str):
    for root in (path, os.path.join(path, "ocdbt.process_0")):
        if os.path.isfile(os.path.join(root, "manifest.ocdbt")):
            return _Ocdbt(root)
    return _Files(path)


def _dtype(name) -> np.dtype:
    """The numpy dtype a zarr dtype is read as (bfloat16: little-endian uint16)."""
    if name == "bfloat16":
        return np.dtype("<u2")
    if not isinstance(name, str):
        raise ValueError(f"structured zarr dtype {name} is not read (nor by tensorstore)")
    dt = np.dtype(name)
    if dt.kind not in "biufc":
        raise ValueError(f"zarr dtype {name} is not read")
    return dt


_SPECIAL_FILLS = {"NaN": float("nan"), "Infinity": float("inf"), "-Infinity": float("-inf")}


def _fill(value, name, dt: np.dtype):
    """A zarr fill value as a scalar of `dt`: a number, a bool, "NaN",
    "Infinity" or "-Infinity"; null is 0."""
    if value is None:
        value = 0
    if isinstance(value, str):
        if value not in _SPECIAL_FILLS:
            raise ValueError(f"zarr fill value {value!r} is not read")
        value = _SPECIAL_FILLS[value]
    if name == "bfloat16":
        return torch.tensor(float(value), dtype=torch.bfloat16).view(torch.int16).item() & 0xFFFF
    return np.array(value).astype(dt)[()]


def _grid(shape, chunks):
    return itertools.product(*[range(-(-s // c)) for s, c in zip(shape, chunks)])


def _place(out: np.ndarray, idx, chunks, block: np.ndarray) -> None:
    """Write chunk `idx` of grid `chunks` into `out`, cropped at its edges."""
    sl = tuple(slice(i * c, min((i + 1) * c, s)) for i, c, s in zip(idx, chunks, out.shape))
    out[sl] = block[tuple(slice(0, s.stop - s.start) for s in sl)]


def _read_v2(store, key: str, meta: dict) -> np.ndarray:
    if meta.get("filters"):
        raise ValueError(f"{key}: zarr filters {meta['filters']} are not read (nor by "
                         "tensorstore)")
    comp = meta.get("compressor")
    if comp is not None and comp.get("id") not in _DECOMPRESS:
        raise ValueError(f"{key}: zarr compressor {comp.get('id')} is not read")
    order = meta.get("order", "C")
    shape, chunks = tuple(meta["shape"]), tuple(meta["chunks"])
    dt = _dtype(meta["dtype"])
    out = np.full(shape, _fill(meta.get("fill_value"), meta["dtype"], dt), dt.newbyteorder("="))
    sep = meta.get("dimension_separator", ".")
    n = math.prod(chunks) * dt.itemsize
    for idx in _grid(shape, chunks):
        raw = store.get(f"{key}/{sep.join(map(str, idx)) if idx else '0'}")
        if raw is None:
            continue   # a chunk not stored holds the fill value
        if comp is not None:
            raw = _DECOMPRESS[comp["id"]](raw)
        if len(raw) != n:
            raise ValueError(f"{key}: chunk {idx} holds {len(raw)} bytes, not {n}")
        _place(out, idx, chunks, np.frombuffer(raw, dt).reshape(chunks, order=order))
    return out


def _codec(c: dict):
    """(name, configuration) of a zarr v3 codec."""
    return c["name"], c.get("configuration") or {}


def _decode_v3(raw: bytes, codecs, shape, dt: np.dtype, fill, what: str) -> np.ndarray:
    """One chunk of `shape` from its bytes by the zarr v3 codec chain:
    array -> array codecs (transpose), one array -> bytes codec (bytes or
    sharding_indexed), bytes -> bytes codecs (zstd, gzip, crc32c)."""
    names = [_codec(c)[0] for c in codecs]
    a2b = [i for i, n in enumerate(names) if n in ("bytes", "sharding_indexed")]
    if len(a2b) != 1:
        unknown = [n for n in names if n not in ("transpose", "zstd", "gzip", "crc32c")]
        raise ValueError(f"{what}: zarr v3 codecs {unknown or names} are not read")
    for name, conf in map(_codec, reversed(codecs[a2b[0] + 1:])):
        if name == "zstd":
            raw = zstd.decompress(raw)
        elif name == "gzip":
            raw = gzip.decompress(raw)
        elif name == "crc32c":
            if len(raw) < 4 or crc32c(raw[:-4]) != int.from_bytes(raw[-4:], "little"):
                raise ValueError(f"{what}: CRC-32C mismatch")
            raw = raw[:-4]
        else:
            raise ValueError(f"{what}: zarr v3 codec {name} is not read")
    perm = list(range(len(shape)))
    for name, conf in map(_codec, codecs[:a2b[0]]):
        if name != "transpose":
            raise ValueError(f"{what}: zarr v3 codec {name} is not read")
        order = conf["order"]
        perm = [perm[o] for o in order]
    stored = tuple(shape[p] for p in perm)
    name, conf = _codec(codecs[a2b[0]])
    if name == "bytes":
        endian = {"little": "<", "big": ">"}[conf.get("endian", "little")]
        n = math.prod(stored) * dt.itemsize
        if len(raw) != n:
            raise ValueError(f"{what}: chunk holds {len(raw)} bytes, not {n}")
        arr = np.frombuffer(raw, dt.newbyteorder(endian)).reshape(stored)
    else:
        arr = _read_shard(raw, conf, stored, dt, fill, what)
    return arr.transpose(np.argsort(perm)) if perm != sorted(perm) else arr


def _read_shard(raw: bytes, conf: dict, shape, dt: np.dtype, fill, what: str) -> np.ndarray:
    """A shard of the sharding_indexed codec: its index (at its end unless
    `index_location` says start) of (offset, length) per inner chunk, decoded
    by `index_codecs`; the inner chunks by `codecs`."""
    inner = tuple(conf["chunk_shape"])
    if any(s % c for s, c in zip(shape, inner)):
        raise ValueError(f"{what}: inner chunks {inner} do not divide the shard {shape}")
    grid = tuple(s // c for s, c in zip(shape, inner))
    index_codecs = conf.get("index_codecs", [{"name": "bytes"}, {"name": "crc32c"}])
    n_index = 16 * math.prod(grid) + 4 * sum(_codec(c)[0] == "crc32c" for c in index_codecs)
    if len(raw) < n_index:
        raise ValueError(f"{what}: shard of {len(raw)} bytes is shorter than its index")
    at_start = conf.get("index_location", "end") == "start"
    head = raw[:n_index] if at_start else raw[len(raw) - n_index:]
    index = _decode_v3(head, index_codecs, grid + (2,), np.dtype("<u8"), 0, f"{what} index")
    out = np.full(shape, fill, dt.newbyteorder("="))
    for idx in itertools.product(*map(range, grid)):
        offset, length = (int(v) for v in index[idx])
        if offset == _MISSING and length == _MISSING:
            continue   # an inner chunk not stored holds the fill value
        if offset + length > len(raw):
            raise ValueError(f"{what}: inner chunk {idx} at [{offset}, {offset + length}) "
                             f"past its shard's {len(raw)} bytes")
        block = _decode_v3(raw[offset:offset + length], conf["codecs"], inner, dt, fill, what)
        _place(out, idx, inner, block)
    return out


def _read_v3(store, key: str, meta: dict) -> np.ndarray:
    if meta.get("node_type", "array") != "array":
        raise ValueError(f"{key}: zarr v3 node of type {meta['node_type']}")
    grid = meta["chunk_grid"]
    if grid.get("name") != "regular":
        raise ValueError(f"{key}: zarr v3 chunk grid {grid.get('name')} is not read")
    shape, chunks = tuple(meta["shape"]), tuple(grid["configuration"]["chunk_shape"])
    name = meta["data_type"]
    dt = _dtype({"bool": "|b1", "bfloat16": "bfloat16"}.get(name, name))
    fill = _fill(meta.get("fill_value"), name, dt)
    out = np.full(shape, fill, dt.newbyteorder("="))
    encoding, conf = _codec(meta.get("chunk_key_encoding", {"name": "default"}))
    if encoding not in ("default", "v2"):
        raise ValueError(f"{key}: zarr v3 chunk key encoding {encoding} is not read")
    sep = conf.get("separator", "/" if encoding == "default" else ".")
    for idx in _grid(shape, chunks):
        if encoding == "default":
            chunk_key = "c" + "".join(f"{sep}{i}" for i in idx)
        else:
            chunk_key = sep.join(map(str, idx)) if idx else "0"
        raw = store.get(f"{key}/{chunk_key}")
        if raw is None:
            continue   # a chunk (a whole shard) not stored holds the fill value
        _place(out, idx, chunks, _decode_v3(raw, meta["codecs"], chunks, dt, fill,
                                            f"{key}/{chunk_key}"))
    return out


def _read_array(store, key: str) -> torch.Tensor:
    raw = store.get(f"{key}/.zarray")
    if raw is not None:
        meta = json.loads(raw)
        if meta.get("zarr_format") != 2:
            raise ValueError(f"{key}: .zarray of zarr format {meta.get('zarr_format')}")
        out, dtype = _read_v2(store, key, meta), meta["dtype"]
    else:
        raw = store.get(f"{key}/zarr.json")
        if raw is None:
            raise ValueError(f"{store.root}: no zarr array {key}")
        meta = json.loads(raw)
        if meta.get("zarr_format") != 3:
            raise ValueError(f"{key}: zarr.json of zarr format {meta.get('zarr_format')}")
        out, dtype = _read_v3(store, key, meta), meta["data_type"]
    t = torch.from_numpy(out)
    return t.view(torch.bfloat16) if dtype == "bfloat16" else t


def _assemble(node):
    """Dicts keyed by (key, key_type) -> Nodes and lists."""
    if not isinstance(node, dict):
        return node
    kinds = {kt for _, kt in node}
    if kinds == {1}:
        items = sorted(node.items(), key=lambda kv: int(kv[0][0]))
        if [int(k) for (k, _), _ in items] != list(range(len(items))):
            raise ValueError(f"sequence indices {[k for (k, _), _ in items]} have gaps")
        return [_assemble(v) for _, v in items]
    return Node({k: _assemble(v) for (k, _), v in node.items()})


def read_step(path: str, only: Optional[Iterable[str]] = None):
    """The tree saved in the Orbax step directory `path`, with CPU tensor
    leaves. `only` names the top-level keys to read (`("params",)` reads a
    model's params and skips its Adam moments)."""
    meta_path = os.path.join(path, "_METADATA")
    if not os.path.isfile(meta_path):
        raise FileNotFoundError(f"{path} is not an Orbax step (no _METADATA)")
    with open(meta_path) as f:
        meta = json.load(f)
    store = _open(path)
    only = None if only is None else set(only)
    tree: dict = {}
    for name, leaf in meta["tree_metadata"].items():
        keys = [(k["key"], k["key_type"]) for k in leaf["key_metadata"]]
        if [k for k, _ in keys] != [str(k) for k in ast.literal_eval(name)]:
            raise ValueError(f"{path}: tree key {name} does not match its key metadata")
        if only is not None and keys[0][0] not in only:
            continue
        vtype = (leaf.get("value_metadata") or {}).get("value_type")
        if vtype in _EMPTY:
            value = _EMPTY[vtype]()
        elif vtype in _ARRAY_TYPES:
            value = _read_array(store, ".".join(k for k, _ in keys))
        else:
            raise ValueError(f"{path}: leaf {name} has value type {vtype}")
        node = tree
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = value
    return _assemble(tree)
