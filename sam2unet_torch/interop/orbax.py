"""The JAX package's Orbax checkpoint directories, read and written without
JAX, orbax or tensorstore: the layout that orbax-checkpoint 0.11's
`StandardCheckpointer` gives a tree of numpy arrays
(`sam2unet_tpu/train/checkpoints.py::save_variables`).

A directory holds
- `_METADATA`: JSON; `tree_metadata` maps each leaf's path, written as a
  Python tuple string (`"('params', 'a', 'kernel')"`), to its dict keys
  (`key_metadata`) and its value type; `use_ocdbt` true, `use_zarr3` false;
- `_CHECKPOINT_METADATA`: JSON, the handler's name and timestamps;
- an OCDBT database (`interop/ocdbt.py`) in which each leaf is a zarr v2
  array named by its path joined with ".": the key `<name>/.zarray` holds
  its JSON metadata (dtype, shape, chunks, C order, the compressor,
  `fill_value`), and `<name>/<i>.<j>...` each chunk, a full chunk's C-order
  bytes, zstd-compressed when the compressor says so.

The tree's keys, as the JAX package's train state has them
(`sam2unet_tpu/train/checkpoints.py::save_train_state`): a dict key
(`key_type` 2) is a string, or a tuple of strings where a dict was
flattened by flax (`TrainState.trainable`, optax's `mu`), whose key orbax
writes as the tuple's Python string `"('encoder', 'blocks_0', ...)"`; a
sequence index (`key_type` 1, optax's chain of states) is an int. The
nested dicts here carry them as such: str, tuple of str, int.

`read_tree` reads every chunk. A chunk that is absent equals the fill
value (orbax's `store_array_data_equal_to_fill_value` writes every chunk;
tensorstore may leave chunks at their fill unwritten); one absent where
`fill_value` is null, an unknown compressor, filters, Fortran order, a
value type other than an array or None (optax's `EmptyState`, which
holds no array and reads as None), another key type, or a dtype other than
bool, integer or float (the JAX train CLI saves fp32 parameters and int32
counts) fails the read. `write_tree` writes the same layout, one chunk per
leaf, compressed as orbax compresses (zstd level 1).
"""

from __future__ import annotations

import ast
import itertools
import json
import math
import os
import shutil
import time
from pathlib import Path

import numpy as np

from sam2unet_torch.interop import ocdbt

METADATA = "_METADATA"
CHECKPOINT_METADATA = "_CHECKPOINT_METADATA"
HANDLER = ("orbax.checkpoint._src.handlers.standard_checkpoint_handler."
           "StandardCheckpointHandler")
ZSTD_LEVEL = 1
_SEQUENCE_KEY, _DICT_KEY = 1, 2   # orbax's key_type values
_ARRAY_TYPES = ("np.ndarray", "jax.Array")
# the value metadata of an empty node (optax's EmptyState), which holds no
# array
_EMPTY = {"value_type": "None", "skip_deserialize": True}


def _dtype(name: str) -> np.dtype:
    try:
        dtype = np.dtype(name)
    except TypeError as e:
        raise ValueError(f"zarr dtype {name!r} is not supported") from e
    if dtype.kind not in "biuf":
        raise ValueError(f"zarr dtype {name!r} is not supported")
    return dtype


def _fill(value):
    if isinstance(value, str):
        special = {"NaN": np.nan, "Infinity": np.inf, "-Infinity": -np.inf}
        if value not in special:
            raise ValueError(f"zarr fill_value {value!r} is not supported")
        return special[value]
    return value


def _read_array(db: ocdbt.Database, name: str) -> np.ndarray:
    key = f"{name}/.zarray".encode()
    if key not in db.entries:
        raise KeyError(f"no zarr array {name!r} in {db.root}")
    meta = json.loads(db.value(key))
    if meta.get("zarr_format") != 2:
        raise ValueError(f"{name}: zarr_format {meta.get('zarr_format')}")
    if meta.get("order", "C") != "C" or meta.get("filters"):
        raise ValueError(f"{name}: order {meta.get('order')!r} and filters "
                         f"{meta.get('filters')!r} are not supported")
    compressor = meta.get("compressor")
    if compressor is not None and compressor.get("id") != "zstd":
        raise ValueError(f"{name}: unknown compressor {compressor!r}")
    dtype = _dtype(meta["dtype"])
    shape, chunks = tuple(meta["shape"]), tuple(meta["chunks"])
    sep = meta.get("dimension_separator", ".")
    out = np.empty(shape, dtype)
    grid = [math.ceil(s / c) for s, c in zip(shape, chunks)]
    chunk_bytes = math.prod(chunks) * dtype.itemsize
    for idx in itertools.product(*map(range, grid)):
        region = tuple(slice(i * c, min((i + 1) * c, s))
                       for i, c, s in zip(idx, chunks, shape))
        ckey = f"{name}/{sep.join(map(str, idx)) or '0'}".encode()
        if ckey not in db.entries:
            if meta.get("fill_value") is None:
                raise ValueError(f"{name}: chunk {ckey.decode()} is missing "
                                 "and the array has no fill value")
            out[region] = _fill(meta["fill_value"])
            continue
        raw = db.value(ckey)
        if compressor is not None:
            raw = ocdbt.zstd_decompress(raw, chunk_bytes)
        if len(raw) != chunk_bytes:
            raise ValueError(f"{name}: chunk {ckey.decode()} holds {len(raw)} "
                             f"bytes, expected {chunk_bytes}")
        block = np.frombuffer(raw, dtype).reshape(chunks)
        out[region] = block[tuple(slice(0, r.stop - r.start) for r in region)]
    return out.astype(dtype.newbyteorder("="), copy=False)


def _tree_key(meta: dict) -> str | tuple[str, ...] | int:
    """A node's key as the tree holds it, from orbax's key metadata."""
    key, kind = meta["key"], meta.get("key_type")
    if kind == _SEQUENCE_KEY:
        return int(key)
    if kind != _DICT_KEY:
        raise ValueError(f"key {key!r} has the unknown key_type {kind!r}")
    if key.startswith("("):
        try:
            parts = ast.literal_eval(key)
        except (ValueError, SyntaxError):
            return key
        if isinstance(parts, tuple) and all(isinstance(p, str) for p in parts):
            return parts
    return key


def _key_metadata(key) -> dict:
    """The inverse of `_tree_key`."""
    if isinstance(key, bool) or not isinstance(key, (str, tuple, int)) or (
            isinstance(key, tuple) and not all(isinstance(p, str) for p in key)):
        raise TypeError(f"tree key {key!r} is not a str, a tuple of str or "
                        "an int")
    if isinstance(key, int):
        return {"key": str(key), "key_type": _SEQUENCE_KEY}
    return {"key": key if isinstance(key, str) else repr(key),
            "key_type": _DICT_KEY}


def read_tree(path: str | os.PathLike) -> dict:
    """The checkpoint at `path` as a nested dict of numpy arrays under the
    JAX tree's names (keys as the module docstring says)."""
    path = Path(path)
    meta = json.loads((path / METADATA).read_text())
    if not meta.get("use_ocdbt") or meta.get("use_zarr3"):
        raise ValueError(f"{path}: only OCDBT checkpoints with zarr v2 arrays "
                         f"are supported (use_ocdbt {meta.get('use_ocdbt')}, "
                         f"use_zarr3 {meta.get('use_zarr3')})")
    db = ocdbt.Database(path)
    tree: dict = {}
    for leaf_name, leaf in meta["tree_metadata"].items():
        keys = [k["key"] for k in leaf["key_metadata"]]
        try:
            tree_keys = [_tree_key(k) for k in leaf["key_metadata"]]
        except ValueError as e:
            raise ValueError(f"{path}: leaf {leaf_name}: {e}") from None
        if tuple(keys) != ast.literal_eval(leaf_name):
            raise ValueError(f"{path}: leaf {leaf_name} names the keys {keys}")
        value = leaf["value_metadata"]
        empty = value == _EMPTY
        if not empty and (value.get("value_type") not in _ARRAY_TYPES
                          or value.get("skip_deserialize")):
            raise ValueError(f"{path}: leaf {leaf_name} is a "
                             f"{value.get('value_type')}, not an array")
        node = tree
        for k in tree_keys[:-1]:
            node = node.setdefault(k, {})
        node[tree_keys[-1]] = None if empty else _read_array(db, ".".join(keys))
    return tree


def _leaves(tree: dict, prefix: tuple = ()) -> list[tuple[tuple, np.ndarray]]:
    """(orbax key metadata of the path, array) of every leaf."""
    out = []
    for k, v in tree.items():
        try:
            meta = _key_metadata(k)
        except TypeError as e:
            raise TypeError(f"under {[m['key'] for m in prefix]}: {e}") from None
        if isinstance(v, dict):
            out += _leaves(v, prefix + (meta,))
        else:
            out.append((prefix + (meta,), None if v is None else np.asarray(v)))
    return out


def write_tree(path: str | os.PathLike, tree: dict) -> None:
    """Write the nested dict of arrays `tree` to the directory `path` as
    `StandardCheckpointer.save(..., force=True)` does: a directory that is
    there is replaced (the new one is written beside it and renamed)."""
    path = Path(path).absolute()
    leaves = sorted(((tuple(m["key"] for m in metas), metas, arr)
                     for metas, arr in _leaves(tree)), key=lambda kv: kv[0])
    tmp = path.with_name(f"{path.name}.tmp{os.getpid()}")
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir(parents=True)
    start = time.time_ns()
    items, tree_metadata = {}, {}
    for keys, metas, arr in leaves:
        if arr is None:
            tree_metadata[repr(keys)] = {"key_metadata": list(metas),
                                         "value_metadata": dict(_EMPTY)}
            continue
        if arr.dtype.kind not in "biuf" or arr.dtype.itemsize > 8:
            raise TypeError(f"{'/'.join(keys)}: dtype {arr.dtype} is not "
                            "supported")
        name = ".".join(keys)
        # (np.ascontiguousarray would make a 0-d array 1-d)
        arr = np.asarray(arr, arr.dtype.newbyteorder("<"), order="C")
        zarray = {"chunks": [max(s, 1) for s in arr.shape],
                  "compressor": {"id": "zstd", "level": ZSTD_LEVEL},
                  "dimension_separator": ".", "dtype": arr.dtype.str,
                  "fill_value": None, "filters": None, "order": "C",
                  "shape": list(arr.shape), "zarr_format": 2}
        items[f"{name}/.zarray".encode()] = json.dumps(
            zarray, sort_keys=True, separators=(",", ":")).encode()
        if arr.size:
            ckey = ".".join("0" * arr.ndim) or "0"
            items[f"{name}/{ckey}".encode()] = ocdbt.zstd_compress(
                arr.tobytes(), ZSTD_LEVEL)
        tree_metadata[repr(keys)] = {
            "key_metadata": list(metas),
            "value_metadata": {"value_type": "np.ndarray",
                               "skip_deserialize": False}}
    ocdbt.write_database(tmp, items)
    (tmp / METADATA).write_text(json.dumps({
        "tree_metadata": tree_metadata, "use_ocdbt": True, "use_zarr3": False,
        "store_array_data_equal_to_fill_value": True,
        "custom_metadata": None}))
    (tmp / CHECKPOINT_METADATA).write_text(json.dumps({
        "item_handlers": HANDLER, "metrics": {}, "performance_metrics": {},
        "init_timestamp_nsecs": start, "commit_timestamp_nsecs": time.time_ns(),
        "custom_metadata": {}}))
    if path.exists():
        shutil.rmtree(path)
    os.replace(tmp, path)
