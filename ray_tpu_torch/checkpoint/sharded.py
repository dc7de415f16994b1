"""Sharded save and restore of a tree of torch tensors (port of
ray_tpu/checkpoint/sharded.py).

The on-disk layout is the reference's, byte for byte, so either
package restores the other's directories and the reference trainer's
`CheckpointManager.latest_checkpoint()` finds the port's saves:

    checkpoint_000042/
      manifest.json        tree skeleton + per-array shape/dtype/spec +
                           chunk->file inventory (written by rank 0)
      a0_c0.bin            raw C-order bytes of array 0, chunk 0: one
      a0_c1.bin            file per distinct shard of a DTensor leaf
      a1_c0.bin            (chunks numbered in the order of their
                           sorted indices, as the reference numbers
                           them), written by the lowest rank holding
                           it; a plain tensor is one full-extent chunk,
                           written by rank 0
      DONE.0.<save_id>     per-rank completion markers
      DONE.1.<save_id>
      COMMIT               atomic commit marker — written only after every
                           rank's DONE marker is present AND the chunk
                           inventory verifies; a directory without COMMIT
                           is torn and is never restored from

Every file lands via tmp + fsync + atomic rename, and the COMMIT rename
is the linearisation point.  The ranks are the `torch.distributed`
group's when one is initialised, else the process is rank 0 of 1.  The
last rank to write its DONE marker commits, as the reference's
replica_id==0 rule does.

A DTensor leaf (a mesh's params, `parallel.sharding`) records its
global shape and its spec, and each rank writes the shards it owns.
`restore_sharded(mesh=)` re-binds each saved spec to the current mesh
(axes it lacks, or of size 1, are dropped) and reads each rank's window
from whichever chunks overlap it, so a tree saved by the reference's
8-device mesh restores on 8 ranks, and the reverse.

Spans and events go to the caller's `Observer` under the reference's
plane and kinds: ("ckpt", "stage") around the synchronous half,
("ckpt", "commit") at the commit.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass, field
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from ray_tpu_torch._device import DeviceLike, resolve_device
from ray_tpu_torch.checkpoint.manifest import (
    COMMIT_FILE, FORMAT, MANIFEST_FILE, LeafRef, decode_tree, dtype_name,
    encode_tree, fsync_dir, read_manifest, skeleton_refs, torch_dtype,
    write_bytes_atomic, write_json_atomic)
from ray_tpu_torch.parallel.mesh import axis_sizes
from ray_tpu_torch.parallel.sharding import (NamedSharding, local_index,
                                             spec_of)
from ray_tpu_torch.util.observe import NOOP, Observer


def _process_info() -> Tuple[int, int]:
    """(rank, world size) of the torch.distributed group, else (0, 1)."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _host_copy(leaf):
    """A host snapshot of one leaf: a tensor is copied (the train step
    updates params and moments in place), a device tensor into pinned
    memory without waiting, a numpy leaf is the caller's own, as in the
    reference.  The caller synchronises with the device's copies."""
    if isinstance(leaf, torch.Tensor):
        host = torch.empty(leaf.shape, dtype=leaf.dtype,
                           pin_memory=leaf.is_cuda)
        return host.copy_(leaf.detach(), non_blocking=leaf.is_cuda)
    return np.asarray(leaf)


def _raw_bytes(data) -> np.ndarray:
    """The C-order bytes of a host tensor or array, as a uint8 array (no
    numpy dtype is needed for bf16 or float8)."""
    if isinstance(data, torch.Tensor):
        return data.reshape(-1).view(torch.uint8).numpy()
    return np.ascontiguousarray(data).reshape(-1).view(np.uint8)


@dataclass
class Staged:
    """A device-to-host snapshot ready for the (background) writer."""

    manifest: dict
    local_chunks: List[Tuple[str, Any]]
    process_index: int
    process_count: int
    save_id: str = "0"
    directory: str = ""
    committed: bool = field(default=False)


def stage(tree: Any, *, save_id: str = "0", step: Optional[int] = None,
          metrics: Optional[dict] = None,
          observer: Optional[Observer] = None) -> Staged:
    """The synchronous half of a save: copy rank 0's leaves to host
    memory (a device's leaves all queued, then one wait) and build the
    manifest.  Runs at the step boundary, so its span is the
    checkpoint's tax on training; the write can then run on a
    background thread against the snapshot."""
    obs = observer or NOOP
    tok = obs.begin("ckpt", "stage", save_id=str(save_id), step=step)
    pidx, pcount = _process_info()
    skeleton, leaves = encode_tree(tree)
    arrays = []
    local: List[Tuple[str, Any]] = []
    for i, leaf in enumerate(leaves):
        shape = tuple(int(s) for s in leaf.shape)
        name = dtype_name(leaf)
        itemsize = torch_dtype(name).itemsize
        if _is_dtensor(leaf):
            spec = spec_of(leaf)
            unique, owned = _chunks_of(leaf, spec, pidx)
            ordinal = {idx: n for n, idx in enumerate(unique)}
            for idx in owned:
                local.append((f"a{i}_c{ordinal[idx]}.bin",
                              _host_copy(leaf.to_local())))
            spec_json = [None if e is None else
                         [e] if isinstance(e, str) else list(e)
                         for e in spec]
        else:
            unique = [tuple((0, d) for d in shape)]
            if pidx == 0:
                local.append((f"a{i}_c0.bin", _host_copy(leaf)))
            spec_json = None
        arrays.append({
            "id": i,
            "path": _leaf_path(skeleton, i),
            "shape": list(shape),
            "dtype": name,
            "spec": spec_json,
            "chunks": [{
                "file": f"a{i}_c{n}.bin",
                "index": [[a, b] for a, b in idx],
                "nbytes": int(math.prod(b - a for a, b in idx) * itemsize),
            } for n, idx in enumerate(unique)],
        })
    manifest = {
        "format": FORMAT,
        "save_id": str(save_id),
        "process_count": pcount,
        "step": step,
        "metrics": dict(metrics) if metrics else {},
        "tree": skeleton,
        "arrays": arrays,
    }
    for device in {leaf.device for leaf in leaves
                   if isinstance(leaf, torch.Tensor) and leaf.is_cuda}:
        torch.cuda.current_stream(device).synchronize()
    obs.end(tok, chunks=len(local))
    return Staged(manifest=manifest, local_chunks=local,
                  process_index=pidx, process_count=pcount,
                  save_id=str(save_id))


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def _chunks_of(leaf, spec: tuple, rank: int):
    """(the sorted distinct shard indices of a DTensor leaf over its
    whole mesh, the ones `rank` writes): a shard held by several ranks
    is written by the lowest of them."""
    mesh = leaf.device_mesh
    layout = mesh.mesh.cpu().numpy()
    owner: dict = {}
    mine = None
    for coord in np.ndindex(layout.shape):
        idx = tuple((s.start, s.stop) for s in local_index(
            leaf.shape, spec, mesh, coord))
        r = int(layout[coord])
        owner[idx] = min(owner.get(idx, r), r)
        if r == rank:
            mine = idx
    owned = [mine] if mine is not None and owner[mine] == rank else []
    return sorted(owner), owned


def _leaf_path(skeleton: dict, leaf_id: int) -> str:
    stack = [skeleton]
    while stack:
        node = stack.pop()
        kind = node["kind"]
        if kind == "array" and node["id"] == leaf_id:
            return node["path"]
        if kind == "dict":
            stack.extend(node["items"].values())
        elif kind in ("list", "tuple", "namedtuple"):
            stack.extend(node["items"])
    return ""


def _clear_stale(path: str, save_id: str) -> None:
    """Rank 0's clean-up of a torn directory of another save: its
    manifest and its DONE markers go, so they cannot alias into this
    save; chunks are overwritten.  The reference removes the whole
    directory, which here could remove a peer rank's DONE marker of
    this save, written (or, as its tmp file, being written) before rank
    0 got here (rank 0 writes every chunk, the others nothing else)."""
    try:
        stale = read_manifest(path).get("save_id")
    except (OSError, ValueError):
        stale = None
    ours = (f".{save_id}", f".{save_id}.tmp")
    for name in os.listdir(path):
        if (name == MANIFEST_FILE and stale != save_id) or (
                name.startswith("DONE.") and not name.endswith(ours)):
            try:
                os.remove(os.path.join(path, name))
            except FileNotFoundError:       # a peer renamed its tmp
                pass


def write_staged(staged: Staged, path: str, *, commit: bool = True,
                 observer: Optional[Observer] = None) -> str:
    """The I/O half of a save (background-thread safe): write chunks,
    manifest, DONE marker; then attempt the commit rename."""
    staged.directory = path
    if staged.process_index == 0 and os.path.isdir(path) \
            and not is_committed(path):
        _clear_stale(path, staged.save_id)
    os.makedirs(path, exist_ok=True)
    for fname, data in staged.local_chunks:
        write_bytes_atomic(os.path.join(path, fname), _raw_bytes(data))
    if staged.process_index == 0:
        write_json_atomic(os.path.join(path, MANIFEST_FILE), staged.manifest)
    write_bytes_atomic(
        os.path.join(path, f"DONE.{staged.process_index}.{staged.save_id}"),
        b"")
    fsync_dir(path)
    if commit:
        staged.committed = maybe_commit(path, staged.save_id,
                                        staged.process_count, observer)
    return path


def maybe_commit(path: str, save_id: str, process_count: int,
                 observer: Optional[Observer] = None) -> bool:
    """Write COMMIT iff every rank's DONE marker (for THIS save_id) is
    present and the manifest's chunk inventory verifies.  Idempotent and
    safe to race: os.replace makes the marker appear exactly once."""
    if is_committed(path):
        return True
    try:
        man = read_manifest(path)
    except (OSError, ValueError):
        return False
    if man.get("save_id") != save_id:
        return False
    for i in range(process_count):
        if not os.path.isfile(os.path.join(path, f"DONE.{i}.{save_id}")):
            return False
    for entry in man["arrays"]:
        for chunk in entry["chunks"]:
            try:
                if os.path.getsize(os.path.join(path, chunk["file"])) \
                        != chunk["nbytes"]:
                    return False
            except OSError:
                return False
    write_bytes_atomic(os.path.join(path, COMMIT_FILE),
                       b'{"save_id": "%s"}\n' % save_id.encode())
    fsync_dir(path)
    (observer or NOOP).record("ckpt", "commit", path=path, save_id=save_id)
    return True


def is_committed(path: str) -> bool:
    return os.path.isfile(os.path.join(path, COMMIT_FILE))


def save_sharded(path: str, tree: Any, *, save_id: str = "0",
                 step: Optional[int] = None, metrics: Optional[dict] = None,
                 commit: bool = True,
                 observer: Optional[Observer] = None) -> str:
    """Synchronous sharded save (the async path runs the same two halves
    on either side of a thread hop — see async_writer.AsyncCheckpointer).
    `commit=False` leaves a deliberately torn directory."""
    staged = stage(tree, save_id=save_id, step=step, metrics=metrics,
                   observer=observer)
    return write_staged(staged, path, commit=commit, observer=observer)


def _read_window(path: str, entry: dict, window: tuple) -> torch.Tensor:
    """The slices `window` of one saved array as a host tensor, from
    every chunk that overlaps it."""
    shape = tuple(entry["shape"])
    dtype = torch_dtype(entry["dtype"])
    req = [(0 if w.start is None else w.start,
            n if w.stop is None else w.stop) for w, n in zip(window, shape)]
    out = torch.empty([b - a for a, b in req], dtype=dtype)
    for chunk in entry["chunks"]:
        cidx = [tuple(x) for x in chunk["index"]]
        cshape = tuple(e - s for s, e in cidx)
        inter = [(max(a, c), min(b, e)) for (a, b), (c, e) in zip(req,
                                                                 cidx)]
        if math.prod(cshape) == 0 or any(a >= b for a, b in inter):
            continue
        raw = np.fromfile(os.path.join(path, chunk["file"]), dtype=np.uint8)
        if raw.size != chunk["nbytes"]:
            raise ValueError(f"{path}/{chunk['file']}: {raw.size} bytes, "
                             f"the manifest says {chunk['nbytes']}")
        data = torch.from_numpy(raw).view(dtype).reshape(cshape)
        src = tuple(slice(a - c, b - c) for (a, b), (c, _) in zip(inter,
                                                                 cidx))
        dst = tuple(slice(a - r, b - r) for (a, b), (r, _) in zip(inter, req))
        if cshape == tuple(out.shape) and cidx == req:
            return data
        out[dst] = data[src]
    return out


def _spec_for_mesh(entry: dict, mesh) -> tuple:
    """Re-bind the SAVED spec to the CURRENT mesh: axis names that the
    mesh lacks (or of size 1) are dropped, so a tree saved on a
    ("data", "tensor") mesh restores onto a ("data",) mesh with the
    tensor split gone."""
    sizes = axis_sizes(mesh)
    out = []
    for dim in entry.get("spec") or []:
        axes = tuple(a for a in (dim or []) if sizes.get(a, 1) > 1)
        out.append(None if not axes else axes[0] if len(axes) == 1
                   else axes)
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def _leaf_shardings(man: dict, shardings) -> dict:
    """{leaf id: NamedSharding} from one sharding or a tree of them
    congruent with the saved tree."""
    if isinstance(shardings, NamedSharding):
        return {e["id"]: shardings for e in man["arrays"]}
    out: dict = {}

    def walk(ref, sh):
        if isinstance(ref, LeafRef):
            out[ref.id] = sh
        elif isinstance(ref, dict):
            for k, v in ref.items():
                walk(v, sh[k])
        elif isinstance(ref, (list, tuple)):
            for r, s_ in zip(ref, sh):
                walk(r, s_)
    walk(skeleton_refs(man["tree"]), shardings)
    return out


def restore_sharded(path: str, *, device: DeviceLike = None, mesh=None,
                    shardings=None, allow_uncommitted: bool = False) -> Any:
    """Re-materialise a saved tree from `path`, python scalars and
    containers as saved (a namedtuple as a namedtuple of the recorded
    name and fields).  Only committed directories restore unless
    `allow_uncommitted`.

    - default: whole tensors on `device` (None -> CUDA);
    - `mesh=` (a DeviceMesh): each array as a DTensor holding this
      rank's window, laid out by its saved spec re-bound to the mesh
      (the reference's elastic restore); on the mesh's card unless
      `device` says otherwise;
    - `shardings=`: one `parallel.sharding.NamedSharding`, or a tree of
      them congruent with the saved tree (where it has no entry, the
      leaf restores whole)."""
    if mesh is not None and not hasattr(mesh, "mesh_dim_names"):
        raise TypeError(f"restore_sharded(mesh=) takes a DeviceMesh, got "
                        f"{type(mesh).__name__}")
    if not allow_uncommitted and not is_committed(path):
        raise FileNotFoundError(
            f"{path}: no COMMIT marker — checkpoint is torn or still "
            f"being written (pass allow_uncommitted=True to override)")
    man = read_manifest(path)
    per_leaf = _leaf_shardings(man, shardings) if shardings is not None \
        else {}
    leaves = {}
    for entry in man["arrays"]:
        sharding = per_leaf.get(entry["id"])
        if sharding is None and mesh is not None:
            sharding = NamedSharding(mesh, _spec_for_mesh(entry, mesh))
        if sharding is None:
            full = tuple(slice(0, n) for n in entry["shape"])
            leaves[entry["id"]] = _read_window(path, entry, full).to(
                resolve_device(device))
            continue
        window = local_index(entry["shape"], sharding.spec, sharding.mesh)
        leaves[entry["id"]] = sharding.wrap(
            _read_window(path, entry, window), tuple(entry["shape"]),
            device)
    return decode_tree(man["tree"], leaves)


def checkpoint_metadata(path: str) -> dict:
    """step/metrics/save_id/process_count of a saved directory, without
    touching any chunk data."""
    man = read_manifest(path)
    return {k: man.get(k) for k in
            ("step", "metrics", "save_id", "process_count")}
