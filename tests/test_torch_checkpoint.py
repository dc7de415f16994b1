"""The port's sharded checkpoints (ray_tpu_torch/checkpoint/) against the
reference's (ray_tpu/checkpoint/), on the CPU:

- a nested tree with f32, bf16, int and bool leaves, namedtuples and
  scalars round-trips bit-exact with `ml_dtypes` unimportable;
- the same tree saved by both packages gives the same files, byte for
  byte;
- the reference's directories (a sharded array of a 4-device mesh
  included) restore in the port, and the port's in the reference's
  `restore_sharded` and `Checkpoint.from_sharded_dir(...).to_pytree()`,
  bit-exact;
- an uncommitted directory never restores;
- the manager's retention, async handles and gc of torn directories;
- a train state crosses both ways: the reference's after two optax
  steps continues in the port, the port's after three continues in the
  reference, each next step matching the other package's.
"""

import collections
import os
import sys
import threading

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ray_tpu import checkpoint as jckpt
from ray_tpu.air import Checkpoint
from ray_tpu.models import gpt as jgpt
from ray_tpu_torch import checkpoint as ckpt
from ray_tpu_torch.checkpoint import sharded
from ray_tpu_torch.models import gpt
from ray_tpu_torch.models._functional import adamw
from ray_tpu_torch.models.convert import (params_from_numpy,
                                          params_to_numpy,
                                          train_state_from_numpy,
                                          train_state_to_tree)

torch.set_num_threads(1)

Pair = collections.namedtuple("Pair", ["left", "right"])
LR = 1e-4


def _np_tree():
    """Numpy leaves (bf16 via ml_dtypes) in the reference's idiom."""
    rng = np.random.default_rng(0)
    return {
        "params": {"w": rng.standard_normal((8, 4)).astype(np.float32),
                   "b16": rng.standard_normal((3, 5)).astype(
                       ml_dtypes.bfloat16)},
        "opt": Pair(left=np.arange(6, dtype=np.int64).reshape(2, 3),
                    right=[np.int32(7), np.array([True, False])]),
        "empty": np.zeros((0, 3), np.float32),
        "step": 42, "tag": "run-a", "none": None,
    }


def _to_torch(x):
    if isinstance(x, dict):
        return {k: _to_torch(v) for k, v in x.items()}
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*map(_to_torch, x))
    if isinstance(x, (list, tuple)):
        return type(x)(map(_to_torch, x))
    if isinstance(x, np.ndarray) or isinstance(x, np.generic):
        arr = np.asarray(x)
        if arr.dtype == ml_dtypes.bfloat16:
            return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        return torch.from_numpy(arr.copy())
    return x


def _bits(x):
    """Leaf -> (dtype name, shape, raw bytes), for bit-exact compares."""
    if isinstance(x, torch.Tensor):
        name = ckpt.manifest.DTYPE_NAMES[x.dtype]
        return name, tuple(x.shape), sharded._raw_bytes(x.contiguous()) \
            .tobytes()
    arr = np.asarray(x)
    return arr.dtype.name, arr.shape, np.ascontiguousarray(arr).tobytes()


def _assert_same(got, want, path="root"):
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        for k in want:
            _assert_same(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert type(got).__name__ == type(want).__name__, path
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same(g, w, f"{path}[{i}]")
    elif hasattr(want, "shape") and hasattr(want, "dtype"):
        assert _bits(got) == _bits(want), path
    else:
        assert got == want, path


def test_round_trip_without_ml_dtypes(tmp_path, monkeypatch):
    tree = _to_torch(_np_tree())
    monkeypatch.setitem(sys.modules, "ml_dtypes", None)
    path = ckpt.save_sharded(str(tmp_path / "c"), tree, step=3,
                             metrics={"loss": 1.5})
    assert ckpt.is_committed(path)
    out = ckpt.restore_sharded(path, device="cpu")
    _assert_same(out, tree)
    assert out["params"]["b16"].dtype == torch.bfloat16
    assert out["opt"].left.dtype == torch.int64 and out["opt"]._fields == (
        "left", "right")
    assert ckpt.checkpoint_metadata(path)["step"] == 3


def test_both_packages_write_the_same_bytes(tmp_path):
    ref = jckpt.save_sharded(str(tmp_path / "ref"), _np_tree(), step=1)
    port = ckpt.save_sharded(str(tmp_path / "port"), _to_torch(_np_tree()),
                             step=1)
    names = sorted(os.listdir(ref))
    assert names == sorted(os.listdir(port))
    for name in names:
        with open(os.path.join(ref, name), "rb") as a, \
                open(os.path.join(port, name), "rb") as b:
            assert a.read() == b.read(), name


def test_port_reads_the_reference(tmp_path):
    tree = _np_tree()
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
    sharded_w = jax.device_put(np.arange(64, dtype=np.float32).reshape(8, 8),
                               NamedSharding(mesh, P("data", "model")))
    tree["sharded"] = sharded_w
    path = jckpt.save_sharded(str(tmp_path / "ref"), tree)
    out = ckpt.restore_sharded(path, device="cpu")
    tree["sharded"] = np.asarray(sharded_w)
    _assert_same(out, _to_torch(tree))


def test_reference_reads_the_port(tmp_path):
    path = ckpt.save_sharded(str(tmp_path / "port"), _to_torch(_np_tree()))
    want = _np_tree()
    _assert_same(jckpt.restore_sharded(path), want)
    _assert_same(Checkpoint.from_sharded_dir(path).to_pytree(), want)


def test_uncommitted_directory_never_restores(tmp_path):
    path = ckpt.save_sharded(str(tmp_path / "torn"), {"x": torch.ones(3)},
                             commit=False)
    assert not ckpt.is_committed(path)
    with pytest.raises(FileNotFoundError, match="COMMIT"):
        ckpt.restore_sharded(path, device="cpu")
    with pytest.raises(ValueError, match="COMMIT"):
        Checkpoint.from_sharded_dir(path)
    out = ckpt.restore_sharded(path, device="cpu", allow_uncommitted=True)
    assert torch.equal(out["x"], torch.ones(3))


def test_restore_refuses_a_mesh_and_needs_a_card(tmp_path):
    path = ckpt.save_sharded(str(tmp_path / "c"), {"x": torch.ones(1)})
    with pytest.raises(NotImplementedError, match="multi-device"):
        ckpt.restore_sharded(path, device="cpu", mesh=object())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            ckpt.restore_sharded(path)


def test_manager_keep_last_k_and_keep_best(tmp_path):
    mgr = ckpt.CheckpointManager(str(tmp_path / "last"), keep_last_k=2)
    for step in range(5):
        mgr.save(step, {"x": torch.full((4,), float(step))}, sync=True)
    assert mgr.steps() == [3, 4] and mgr.latest_step() == 4
    assert torch.equal(mgr.restore_latest(device="cpu")["x"],
                       torch.full((4,), 4.0))
    assert mgr.latest_checkpoint() == mgr.step_dir(4)
    best = ckpt.CheckpointManager(str(tmp_path / "best"), keep_best_k=1,
                                  best_metric="loss", best_mode="min")
    for step, loss in enumerate([3.0, 1.0, 2.0]):
        best.save(step, {"x": torch.zeros(1)}, metrics={"loss": loss},
                  sync=True)
    assert best.steps() == [1, 2]     # the best, and always the latest


def test_manager_async_handles_and_barrier(tmp_path, monkeypatch):
    """save() returns once the host copy exists: the write waits on a
    gate here, the caller goes on, and the next save force-joins it."""
    gate = threading.Event()
    write = sharded.write_staged

    def gated(*args, **kwargs):
        assert gate.wait(30)
        return write(*args, **kwargs)

    monkeypatch.setattr(sharded, "write_staged", gated)
    mgr = ckpt.CheckpointManager(str(tmp_path))
    x = torch.zeros(8)
    handle = mgr.save(1, {"x": x})
    x += 5                       # the snapshot was taken at save()
    assert not handle.done() and not handle.committed()
    assert mgr.in_flight is handle and mgr.latest_step() is None
    gate.set()
    assert handle.wait(30) == mgr.step_dir(1) and handle.committed()
    mgr.save(2, {"x": x})
    mgr.wait_until_finished()
    assert mgr.steps() == [1, 2]
    assert torch.equal(mgr.restore(1, device="cpu")["x"], torch.zeros(8))
    assert torch.equal(mgr.restore(2, device="cpu")["x"], torch.full((8,), 5.))


def test_manager_surfaces_a_failed_write(tmp_path, monkeypatch):
    def boom(*args, **kwargs):
        raise OSError("disk on fire")

    monkeypatch.setattr(sharded, "write_staged", boom)
    mgr = ckpt.CheckpointManager(str(tmp_path))
    mgr.save(1, {"x": torch.zeros(1)})
    with pytest.raises(ckpt.CheckpointWriteError):
        mgr.wait_until_finished()


def test_manager_gc_torn_dirs_and_latest_skips_them(tmp_path):
    mgr = ckpt.CheckpointManager(str(tmp_path))
    mgr.save(1, {"x": torch.ones(2)}, sync=True)
    ckpt.save_sharded(mgr.step_dir(2), {"x": torch.ones(2)}, commit=False)
    assert mgr.latest_step() == 1
    assert mgr.gc() == []        # a torn step past the latest may be live
    mgr.save(3, {"x": torch.ones(2)}, sync=True)
    assert sorted(os.listdir(tmp_path)) == ["checkpoint_000001",
                                            "checkpoint_000003"]


def test_reference_trainer_manager_finds_the_ports_saves(tmp_path):
    mgr = ckpt.CheckpointManager(str(tmp_path), save_id="i0")
    mgr.save(4, {"x": torch.arange(3)}, sync=True)
    ckpt.save_sharded(mgr.step_dir(5), {"x": torch.arange(3)}, commit=False)
    found = jckpt.CheckpointManager(str(tmp_path)).latest_checkpoint()
    assert found.is_sharded
    np.testing.assert_array_equal(found.to_pytree()["x"], np.arange(3))


def test_two_ranks_commit_once_both_markers_land(tmp_path, monkeypatch):
    """Every rank holds a whole replica: rank 0 writes the chunks and
    the manifest, each rank its DONE marker, and the last marker
    commits.  Rank 1 first; a stale manifest of a dead save is cleared
    without removing rank 1's fresh marker."""
    path = str(tmp_path / "c")
    ckpt.save_sharded(path, {"x": torch.zeros(2)}, save_id="old",
                      commit=False)
    tree = {"x": torch.arange(4.0)}
    for rank in (1, 0):
        monkeypatch.setattr(sharded, "_process_info", lambda r=rank: (r, 2))
        staged = sharded.stage(tree, save_id="i1")
        assert len(staged.local_chunks) == (1 if rank == 0 else 0)
        sharded.write_staged(staged, path)
        assert staged.committed == (rank == 0)
    assert sorted(n for n in os.listdir(path) if n.startswith("DONE")) == [
        "DONE.0.i1", "DONE.1.i1"]
    assert torch.equal(ckpt.restore_sharded(path, device="cpu")["x"],
                       tree["x"])


def test_rank0_keeps_a_peers_marker_in_flight(tmp_path, monkeypatch):
    """Rank 1's marker of this save still being written (its tmp file)
    when rank 0 clears a torn directory of a dead save: the dead save's
    markers go, the tmp file stays, and once it lands the save
    commits."""
    path = str(tmp_path / "c")
    ckpt.save_sharded(path, {"x": torch.zeros(2)}, save_id="old",
                      commit=False)
    monkeypatch.setattr(sharded, "_process_info", lambda: (1, 2))
    ckpt.save_sharded(path, {"x": torch.zeros(2)}, save_id="old",
                      commit=False)
    inflight = os.path.join(path, "DONE.1.i1.tmp")
    open(inflight, "wb").close()
    monkeypatch.setattr(sharded, "_process_info", lambda: (0, 2))
    tree = {"x": torch.arange(4.0)}
    staged = sharded.stage(tree, save_id="i1")
    sharded.write_staged(staged, path)
    assert not staged.committed and os.path.isfile(inflight)
    assert sorted(n for n in os.listdir(path) if n.startswith("DONE")) == [
        "DONE.0.i1", "DONE.1.i1.tmp"]
    os.replace(inflight, os.path.join(path, "DONE.1.i1"))
    assert sharded.maybe_commit(path, "i1", 2)
    assert torch.equal(ckpt.restore_sharded(path, device="cpu")["x"],
                       tree["x"])


# ------------------------------------------------------- train state

NANO_J, NANO_T = jgpt.CONFIGS["nano"], gpt.CONFIGS["nano"]


def _tokens(seed):
    return np.random.default_rng(seed).integers(0, 512, (2, 32)).astype(
        np.int32)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def test_reference_train_state_continues_in_the_port(tmp_path):
    """The reference's state after two optax.adamw steps, saved by the
    reference and restored by the port: the port's third step matches
    the reference's (loss within 1e-5; params within 2e-6, where a
    fresh optimizer's bias correction alone would move them by ~lr)."""
    init_j, step_j = jgpt.make_train_step(NANO_J, optax.adamw(LR))
    step_j = jax.jit(step_j)
    state_j = init_j(jax.random.key(0))
    for i in range(2):
        state_j, _ = step_j(state_j, {"tokens": jnp.asarray(_tokens(i))})
    path = jckpt.save_sharded(str(tmp_path / "ref"), state_j, step=2)
    tree = ckpt.restore_sharded(path, device="cpu")
    assert tree["opt_state"][0]._fields == ("count", "mu", "nu")
    state_t = train_state_from_numpy(tree, NANO_T, adamw(LR), device="cpu")
    assert state_t["step"] == 2
    _, step_t = gpt.make_train_step(NANO_T, adamw(LR), device="cpu")
    state_j, m_j = step_j(state_j, {"tokens": jnp.asarray(_tokens(2))})
    state_t, m_t = step_t(state_t, {"tokens": torch.from_numpy(_tokens(2))})
    np.testing.assert_allclose(float(m_t["loss"]), float(m_j["loss"]),
                               rtol=1e-5)
    got = _flat(params_to_numpy(state_t["params"]))
    want = _flat(jax.tree.map(np.asarray, state_j["params"]))
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=2e-6, rtol=0,
                                   err_msg=k)
    assert state_t["step"] == 3 and int(state_j["step"]) == 3


def test_stage_snapshots_the_live_train_state(tmp_path):
    """`train_state_to_tree` hands `stage` the state's own tensors; the
    stage's host copy is the snapshot, so a step taken before the write
    does not reach the saved bytes."""
    init_t, step_t = gpt.make_train_step(NANO_T, adamw(LR), device="cpu")
    state = init_t(0)
    state, _ = step_t(state, {"tokens": torch.from_numpy(_tokens(0))})
    tree = train_state_to_tree(state)
    assert tree["params"]["tok_embed"].data_ptr() == \
        state["params"]["tok_embed"].data_ptr()
    assert type(tree["opt_state"][0]).__name__ == "ScaleByAdamState"
    want = _clone(tree)
    staged = sharded.stage(tree, step=1)
    state, _ = step_t(state, {"tokens": torch.from_numpy(_tokens(1))})
    sharded.write_staged(staged, str(tmp_path / "s"))
    _assert_same(ckpt.restore_sharded(str(tmp_path / "s"), device="cpu"),
                 want)
    assert int(jckpt.restore_sharded(str(tmp_path / "s"))["opt_state"][0]
               .count) == 1


def _clone(tree):
    """A copy of a tree of tensors, its containers' types kept."""
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        items = map(_clone, tree)
        return type(tree)(*items) if hasattr(tree, "_fields") \
            else tuple(items)
    return tree.clone()


def test_port_train_state_continues_in_the_reference(tmp_path):
    """The port's state after three steps, saved by the port (in the
    reference's train-state layout) and restored by the reference: its
    fourth step matches the port's."""
    init_t, step_t = gpt.make_train_step(NANO_T, adamw(LR), device="cpu")
    init_j, step_j = jgpt.make_train_step(NANO_J, optax.adamw(LR))
    start = jax.tree.map(np.asarray, init_j(jax.random.key(1))["params"])
    state_t = init_t(params=params_from_numpy(start, NANO_T, device="cpu"))
    for i in range(3):
        state_t, _ = step_t(state_t, {"tokens": torch.from_numpy(
            _tokens(i))})
    mgr = ckpt.CheckpointManager(str(tmp_path))
    mgr.save(3, train_state_to_tree(state_t))
    mgr.wait_until_finished()
    state_j = jax.tree.map(jnp.asarray,
                           jckpt.restore_sharded(mgr.step_dir(3)))
    assert type(state_j["opt_state"][0]) is optax.ScaleByAdamState
    assert int(state_j["opt_state"][0].count) == 3
    state_j, m_j = jax.jit(step_j)(state_j,
                                   {"tokens": jnp.asarray(_tokens(3))})
    state_t, m_t = step_t(state_t, {"tokens": torch.from_numpy(_tokens(3))})
    np.testing.assert_allclose(float(m_t["loss"]), float(m_j["loss"]),
                               rtol=1e-5)
    got = _flat(params_to_numpy(state_t["params"]))
    want = _flat(jax.tree.map(np.asarray, state_j["params"]))
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=2e-6, rtol=0,
                                   err_msg=k)
    assert int(state_j["step"]) == 4
