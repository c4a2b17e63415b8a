"""Read a step that the JAX package saved with Orbax, without Orbax.

A step directory (`mofanerf_tpu/train/checkpoint.py::save_checkpoint`)
holds:

- `_METADATA`, JSON whose `tree_metadata` maps each leaf's key path (a
  stringified tuple such as "('opt_state', '0', 'mu', 'w')") to its keys, each
  with a `key_type` (1: a sequence index, so a tuple or list; 2: a dict key or
  a NamedTuple field by name) and a `value_metadata` whose `value_type` is
  "jax.Array" or "np.ndarray" for an array, "None" or null for an empty node
  (an optax state without fields), "List", "Tuple" or "Dict" for an empty
  container;
- an OCDBT database (`utils/ocdbt.py`; `manifest.ocdbt` and `d/` at the root,
  the values it merges from `ocdbt.process_0/`) holding each array as a zarr
  v2 array under the key path joined by dots: `params.coarse.b0/.zarray`
  (`{"chunks", "compressor": {"id": "zstd"}, "dtype", "fill_value", "order":
  "C", "shape", ...}`) and its chunks `params.coarse.b0/0.0`, each one zstd
  frame (`utils/zstd.py`).

`read_step` gives the tree as nested dicts and lists of CPU tensors. zarr's
`bfloat16` has no numpy dtype: it is read as uint16 and viewed as
torch.bfloat16. The JAX state types become `Node`s (dicts whose keys also
read as attributes), so that `bridge.train_state_to_torch` and
`bridge.refine_state_to_torch` take the tree as they take a JAX state.
"""
from __future__ import annotations

import ast
import itertools
import json
import os
from typing import Iterable, Optional

import numpy as np
import torch

from mofanerf_tpu_torch.utils import zstd
from mofanerf_tpu_torch.utils.ocdbt import Database

_ARRAY_TYPES = ("jax.Array", "np.ndarray", "scalar")
_EMPTY = {None: lambda: None, "None": lambda: None, "List": list, "Tuple": list,
          "Dict": lambda: Node()}


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


def _dtype(name: str):
    if name == "bfloat16":
        return np.dtype("<u2")
    dt = np.dtype(name)
    if dt.byteorder == ">":
        raise ValueError(f"big-endian zarr dtype {name}")
    return dt


def _read_array(db: Database, entries, key: str):
    meta_ref = entries.get(f"{key}/.zarray".encode())
    if meta_ref is None:
        raise ValueError(f"{db.root}: no zarr array {key}")
    meta = json.loads(db.value(meta_ref))
    if meta.get("zarr_format") != 2:
        raise ValueError(f"{key}: zarr format {meta.get('zarr_format')}, only 2 is read")
    if meta.get("filters"):
        raise ValueError(f"{key}: zarr filters {meta['filters']} are not read")
    comp = meta.get("compressor")
    if comp is not None and comp.get("id") != "zstd":
        raise ValueError(f"{key}: compressor {comp.get('id')} is not read")
    order = meta.get("order", "C")
    shape, chunks = tuple(meta["shape"]), tuple(meta["chunks"])
    dt = _dtype(meta["dtype"])
    fill = meta.get("fill_value")
    out = np.full(shape, 0 if fill is None else fill, dt)
    sep = meta.get("dimension_separator", ".")
    grid = [range(-(-s // c)) for s, c in zip(shape, chunks)]
    for idx in itertools.product(*grid):
        ref = entries.get(f"{key}/{sep.join(map(str, idx)) if idx else '0'}".encode())
        if ref is None:
            continue   # a chunk not stored holds the fill value
        raw = db.value(ref)
        if comp is not None:
            raw = zstd.decompress(raw)
        n = int(np.prod(chunks)) * dt.itemsize
        if len(raw) != n:
            raise ValueError(f"{key}: chunk {idx} holds {len(raw)} bytes, not {n}")
        block = np.frombuffer(raw, dt).reshape(chunks, order=order)
        sl = tuple(slice(i * c, min((i + 1) * c, s)) for i, c, s in zip(idx, chunks, shape))
        out[sl] = block[tuple(slice(0, s.stop - s.start) for s in sl)]
    t = torch.from_numpy(out)
    return t.view(torch.bfloat16) if meta["dtype"] == "bfloat16" else t


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
    if not meta.get("use_ocdbt", False) or meta.get("use_zarr3", False):
        raise ValueError(f"{path}: only OCDBT steps of zarr v2 arrays are read")
    root = path if os.path.isfile(os.path.join(path, "manifest.ocdbt")) \
        else os.path.join(path, "ocdbt.process_0")
    db = Database(root)
    entries = db.entries()
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
            value = _read_array(db, entries, ".".join(k for k, _ in keys))
        else:
            raise ValueError(f"{path}: leaf {name} has value type {vtype}")
        node = tree
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = value
    return _assemble(tree)
