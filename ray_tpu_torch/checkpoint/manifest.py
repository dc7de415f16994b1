"""Manifest codec for sharded checkpoints (the port's copy of what it
needs from ray_tpu/checkpoint/manifest.py): the tree skeleton as JSON,
the commit files' names, the durable small-file writes and the dtype
names.

The format is the reference's, so either package reads the other's
directories.  Two differences, both so that the port needs neither JAX
nor `ml_dtypes`:

- dtypes are named as numpy names them and resolved to torch dtypes
  (`TORCH_DTYPES`); bf16 is "bfloat16", as ml_dtypes names it, and its
  bytes are the raw 16-bit patterns;
- a namedtuple node is rebuilt as a namedtuple of the recorded name,
  module and fields, made here, not imported: a tree the reference
  saved with optax's states decodes without importing optax, and
  encodes back to the same skeleton.
"""

from __future__ import annotations

import collections
import json
import os
from typing import Any, Dict, List, Tuple

import torch

FORMAT = "ray_tpu.sharded_ckpt.v1"
MANIFEST_FILE = "manifest.json"
COMMIT_FILE = "COMMIT"

_SCALARS = (bool, int, float, str, type(None))

# numpy's (and ml_dtypes') dtype names -> torch dtypes.
TORCH_DTYPES = {
    "bool": torch.bool, "uint8": torch.uint8, "int8": torch.int8,
    "int16": torch.int16, "int32": torch.int32, "int64": torch.int64,
    "uint16": torch.uint16, "uint32": torch.uint32, "uint64": torch.uint64,
    "float16": torch.float16, "float32": torch.float32,
    "float64": torch.float64, "bfloat16": torch.bfloat16,
    "float8_e4m3fn": torch.float8_e4m3fn, "float8_e5m2": torch.float8_e5m2,
    "complex64": torch.complex64, "complex128": torch.complex128,
}
DTYPE_NAMES = {v: k for k, v in TORCH_DTYPES.items()}


def dtype_name(leaf) -> str:
    """The manifest's dtype name of a torch tensor or a numpy array."""
    if isinstance(leaf, torch.Tensor):
        return DTYPE_NAMES[leaf.dtype]
    return leaf.dtype.name


def torch_dtype(name: str) -> torch.dtype:
    try:
        return TORCH_DTYPES[name]
    except KeyError:
        raise ValueError(f"checkpoint dtype {name!r} has no torch "
                         f"counterpart") from None


class LeafRef:
    """Placeholder standing where array leaf `id` goes in a decoded
    skeleton."""

    __slots__ = ("id",)

    def __init__(self, id: int):
        self.id = id

    def __repr__(self):
        return f"LeafRef({self.id})"


def _is_array(x) -> bool:
    return hasattr(x, "shape") and hasattr(x, "dtype")


def encode_tree(tree: Any) -> Tuple[dict, List[Any]]:
    """(skeleton, leaves): JSON-able skeleton with array leaves (torch
    tensors, numpy arrays and scalars) replaced by {"kind": "array",
    "id": i}; `leaves[i]` is the original array."""
    leaves: List[Any] = []

    def enc(node, path):
        if _is_array(node):
            i = len(leaves)
            leaves.append(node)
            return {"kind": "array", "id": i, "path": path}
        if isinstance(node, _SCALARS):
            return {"kind": "scalar", "value": node}
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            cls = type(node)
            return {"kind": "namedtuple",
                    "cls": f"{cls.__module__}:{cls.__qualname__}",
                    "fields": list(node._fields),
                    "items": [enc(v, f"{path}.{f}")
                              for f, v in zip(node._fields, node)]}
        if isinstance(node, dict):
            bad = [k for k in node if not isinstance(k, str)]
            if bad:
                raise TypeError(
                    f"sharded checkpoint dict keys must be str, got "
                    f"{bad[0]!r} at {path or '<root>'}")
            return {"kind": "dict",
                    "items": {k: enc(v, f"{path}.{k}" if path else k)
                              for k, v in node.items()}}
        if isinstance(node, tuple):
            return {"kind": "tuple",
                    "items": [enc(v, f"{path}[{i}]")
                              for i, v in enumerate(node)]}
        if isinstance(node, list):
            return {"kind": "list",
                    "items": [enc(v, f"{path}[{i}]")
                              for i, v in enumerate(node)]}
        raise TypeError(
            f"unsupported pytree node {type(node).__name__} at "
            f"{path or '<root>'} — sharded checkpoints support "
            f"dict/list/tuple/namedtuple containers, array leaves, and "
            f"python scalars")

    return enc(tree, ""), leaves


_NAMEDTUPLES: Dict[Tuple[str, Tuple[str, ...]], type] = {}


def namedtuple_type(cls: str, fields) -> type:
    """A namedtuple type named and placed as `cls` ("module:qualname")
    says, with `fields`; one type per (cls, fields)."""
    key = (cls, tuple(fields))
    if key not in _NAMEDTUPLES:
        module, _, qualname = cls.partition(":")
        t = collections.namedtuple(qualname.rpartition(".")[2], key[1],
                                   module=module)
        t.__qualname__ = qualname
        _NAMEDTUPLES[key] = t
    return _NAMEDTUPLES[key]


def decode_tree(skeleton: dict, leaf_values: Dict[int, Any]) -> Any:
    """Rebuild the tree; array placeholders resolve through
    `leaf_values` (pass {i: LeafRef(i)} to get the bare structure)."""

    def dec(node):
        kind = node["kind"]
        if kind == "array":
            return leaf_values[node["id"]]
        if kind == "scalar":
            return node["value"]
        if kind == "dict":
            return {k: dec(v) for k, v in node["items"].items()}
        if kind == "list":
            return [dec(v) for v in node["items"]]
        if kind == "tuple":
            return tuple(dec(v) for v in node["items"])
        if kind == "namedtuple":
            return namedtuple_type(node["cls"], node["fields"])(
                *[dec(v) for v in node["items"]])
        raise ValueError(f"unknown skeleton node kind {kind!r}")

    return dec(skeleton)


def skeleton_refs(skeleton: dict) -> Any:
    """The saved tree with LeafRef placeholders at every array leaf."""
    ids: Dict[int, LeafRef] = {}

    def collect(node):
        if node["kind"] == "array":
            ids[node["id"]] = LeafRef(node["id"])
        elif node["kind"] == "dict":
            for v in node["items"].values():
                collect(v)
        elif node["kind"] in ("list", "tuple", "namedtuple"):
            for v in node["items"]:
                collect(v)

    collect(skeleton)
    return decode_tree(skeleton, ids)


# ---------------------------------------------------------------------------
# Durable small-file writes
# ---------------------------------------------------------------------------


def fsync_dir(path: str) -> None:
    """fsync a directory so a rename into it survives power loss (no-op
    on platforms that refuse O_RDONLY dir fds)."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def write_bytes_atomic(path: str, blob) -> None:
    """tmp-file + fsync + atomic rename: the file either exists complete
    or not at all.  `blob` is anything with the buffer protocol."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(blob)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def write_json_atomic(path: str, obj: Any) -> None:
    write_bytes_atomic(path, json.dumps(obj, indent=1).encode())


def read_manifest(path: str) -> dict:
    with open(os.path.join(path, MANIFEST_FILE)) as f:
        man = json.load(f)
    if man.get("format") != FORMAT:
        raise ValueError(
            f"{path}: not a {FORMAT} checkpoint "
            f"(format={man.get('format')!r})")
    return man


def has_manifest(path: str) -> bool:
    return os.path.isfile(os.path.join(path, MANIFEST_FILE))
