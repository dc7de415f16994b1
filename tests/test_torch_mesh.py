"""The port's mesh and sharding rules (ray_tpu_torch/parallel/) against
the JAX package's (ray_tpu/parallel/), on the CPU.

JAX runs on the 8 virtual CPU devices of tests/conftest.py; the port
runs gloo ranks spawned by `run_ranks` (one group of 8 and one of 4 for
the whole module, each bounded by RANK_TIMEOUT_S), rank r standing
where JAX's device r stands.  Held equal to the reference:

- `MeshConfig.resolve`, the logical specs, the flat and two-level
  layouts (the slice of every position), the DCN refusal;
- every leaf's local shard on every rank against the reference's
  `addressable_shards` at data2/fsdp2/tensor2, for gpt nano and
  llama-tiny (and the DTensor view of each against the global tensor);
- `fused_cross_entropy_spmd`'s loss, dx and dhead at data2/tensor2 and
  data2/fsdp2/tensor2, f32, within 1e-5;
- a checkpoint across both ways: the port's save from 8 ranks has the
  reference's manifest and chunk bytes and restores in the reference,
  and the reference's save from its 8-device mesh restores on the
  port's 8 ranks;
- a global batch's rows on every rank by `shard_batch`,
  `global_batch` and the device feed with `sharding=mesh`, against the
  reference's `shard_batch`; `shard_opt_state`'s placements;
- seq, expert and stage above 1 build the train step's `MeshPlan`
  (both families; a MoE config too);
- both families' loss on a batch whose rows the row ranks do not
  divide (3 rows over data2/tensor2, 6 over data2/fsdp2): the loss
  within 1e-5 relative of the reference's fallback to materialised
  logits (its jitted `loss_fn` on placed params), every summed
  gradient within 1e-5 of the leaf's largest of the reference's
  one-device gradient (its mesh gradient leaks the pad row into token
  0's embedding row on data2/tensor2: tests/test_torch_mesh_uneven.py);
  a vocab that tensor = 3 does not divide is refused by placement in
  both packages.
"""

import functools
import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu import checkpoint as jckpt
from ray_tpu.models import gpt as jgpt
from ray_tpu.models import llama as jllama
from ray_tpu.ops.cross_entropy import fused_cross_entropy_spmd as jce
from ray_tpu.parallel import (MeshConfig as JMeshConfig,
                              create_mesh as jcreate_mesh,
                              create_two_level_mesh as jtwo_level,
                              logical_to_spec as jlogical_to_spec,
                              slice_index_of as jslice_index_of)
from ray_tpu_torch.models import gpt, llama
from ray_tpu_torch.parallel import (MeshConfig, logical_to_spec,
                                    mesh_layout, slice_index_of,
                                    two_level_layout)
from ray_tpu_torch.parallel import rank_bodies
from ray_tpu_torch.parallel.launch import run_ranks

torch.set_num_threads(1)

# Each group of ranks must finish inside this, or its tests fail.
RANK_TIMEOUT_S = 240
SIZES8 = dict(data=2, fsdp=2, tensor=2)
SIZES4 = dict(data=2, tensor=2)
NANO_J, NANO_T = jgpt.CONFIGS["nano"], gpt.CONFIGS["nano"]
TINY_J, TINY_T = jllama.CONFIGS["llama-tiny"], llama.CONFIGS["llama-tiny"]
# fused_cross_entropy_spmd's shape in tests/test_model_parallel.py.
CE_B, CE_L, CE_D, CE_V = 4, 8, 16, 32


def _ids(jmesh) -> np.ndarray:
    return np.vectorize(lambda d: d.id)(jmesh.devices)


@functools.cache
def _np_params(family: str) -> dict:
    mod, cfg = (jgpt, NANO_J) if family == "gpt" else (jllama, TINY_J)
    return jax.tree.map(np.asarray, mod.init_params(cfg, jax.random.key(3)))


@functools.cache
def _ce_inputs():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((CE_B, CE_L, CE_D)).astype(np.float32)
    head = rng.standard_normal((CE_D, CE_V)).astype(np.float32)
    t = rng.integers(0, CE_V, (CE_B, CE_L)).astype(np.int32)
    valid = np.ones((CE_B, CE_L), np.float32)
    valid[:, -1] = 0.0
    valid[1, 2] = 0.0
    return x, head, t, valid


def _tokens():
    return np.random.default_rng(9).integers(0, 512, (8, 32)).astype(
        np.int32)


def _jmesh(sizes):
    n = int(np.prod(list(sizes.values())))
    return jcreate_mesh(JMeshConfig(**sizes), devices=jax.devices()[:n])


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def _slices(index):
    return tuple(slice(a, b) for a, b in index)


def _jax_shards(arr) -> dict:
    """{device id: (index, data)} of a JAX array's addressable shards."""
    out = {}
    for sh in arr.addressable_shards:
        index = [[0 if s.start is None else s.start,
                  n if s.stop is None else s.stop]
                 for s, n in zip(sh.index, arr.shape)]
        out[sh.device.id] = (index, np.asarray(sh.data))
    return out


@pytest.fixture(scope="module")
def ranks8(tmp_path_factory):
    """One group of 8 ranks for the module: the shards of both
    families, the CE, a save from the mesh and a restore of the
    reference's save."""
    d = tmp_path_factory.mktemp("mesh8")
    jmesh = _jmesh(SIZES8)
    ref_tree = {"params": jgpt.shard_params(_np_params("gpt"), jmesh,
                                            NANO_J)}
    ref_path = jckpt.save_sharded(str(d / "ref"), ref_tree)
    calls = [
        ("shards", ("gpt", NANO_T, SIZES8, _np_params("gpt"))),
        ("shards", ("llama", TINY_T, SIZES8, _np_params("llama"))),
        ("cross_entropy", (SIZES8,) + _ce_inputs()),
        ("save", ("gpt", NANO_T, SIZES8, _np_params("gpt"),
                  str(d / "port"))),
        ("restore", (SIZES8, ref_path)),
        ("batches", (SIZES8, _tokens(), _np_params("gpt"), NANO_T)),
        ("restore", (SIZES8, ref_path, "cpu", True)),
        ("plans", (dict(data=4, seq=2),)),
        ("plans", (dict(data=4, expert=2),)),
        ("plans", (dict(data=4, stage=2),)),
    ]
    out = run_ranks(rank_bodies.sequence, 8, args=(calls,), device="cpu",
                    init_dir=str(d / "init"), timeout_s=RANK_TIMEOUT_S)
    return types.SimpleNamespace(
        dir=d, jmesh=jmesh, ref_path=ref_path, port_path=str(d / "port"),
        shards={"gpt": [r[0] for r in out], "llama": [r[1] for r in out]},
        ce=[r[2] for r in out], restored=[r[4] for r in out],
        batches=[r[5] for r in out], replicated=[r[6] for r in out],
        plans={"seq": [r[7] for r in out], "expert": [r[8] for r in out],
               "stage": [r[9] for r in out]})


# The uneven batches of test_uneven_mesh_loss_matches_the_reference_
# fallback: (mesh sizes, tokens shape) by id.
UNEVEN = {"batch-over-data": (SIZES4, (3, 8)),
          "batch-over-data-fsdp": (dict(data=2, fsdp=2), (6, 8))}


def _uneven_tokens(shape):
    return np.random.default_rng(17).integers(0, 512, shape).astype(
        np.int32)


@pytest.fixture(scope="module")
def ranks4(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh4")
    calls = [("cross_entropy", (SIZES4,) + _ce_inputs())]
    for sizes, shape in UNEVEN.values():
        for family, cfg in (("gpt", NANO_T), ("llama", TINY_T)):
            calls.append(("loss_grads", (family, cfg, sizes,
                                         _np_params(family),
                                         _uneven_tokens(shape))))
    out = run_ranks(rank_bodies.sequence, 4, args=(calls,), device="cpu",
                    init_dir=str(d), timeout_s=RANK_TIMEOUT_S)
    uneven = {}
    for i, (name, family) in enumerate((n, f) for n in UNEVEN
                                       for f in ("gpt", "llama")):
        uneven[name, family] = [r[1 + i] for r in out]
    return types.SimpleNamespace(ce=[r[0] for r in out], uneven=uneven)


# --------------------------------------------------------------------------
# Layouts and specs: no ranks needed.
# --------------------------------------------------------------------------


def test_mesh_resolve():
    for kw, n in ((dict(data=-1, tensor=2), 8), (dict(data=1, fsdp=-1), 4),
                  (dict(data=2, fsdp=2, tensor=2), 8)):
        assert MeshConfig(**kw).resolve(n) == JMeshConfig(**kw).resolve(n)
    with pytest.raises(ValueError):
        MeshConfig(data=3, tensor=2).resolve(8)
    with pytest.raises(ValueError, match="at most one"):
        MeshConfig(data=-1, fsdp=-1).resolve(8)


@pytest.mark.parametrize("sizes", [SIZES8, SIZES4, dict(data=-1, seq=4),
                                   dict(fsdp=4, tensor=2)])
def test_create_mesh_layout_is_the_reference_device_order(sizes):
    n = 8 if -1 in sizes.values() or int(np.prod(list(
        sizes.values()))) == 8 else 4
    want = _ids(jcreate_mesh(JMeshConfig(**sizes),
                             devices=jax.devices()[:n]))
    got = mesh_layout(MeshConfig(**sizes), range(n))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("logical", [
    ("batch", "length", "embed"), ("embed", "mlp"), ("batch", "length"),
    ("vocab", None), ("embed", "vocab"), ("layers", "embed", "heads", "kv"),
    ("layers", "embed", "kv_heads", "kv"), ("batch", "length", "vocab"),
    ("layers", "experts", "embed", "expert_mlp")])
@pytest.mark.parametrize("sizes", [SIZES8, SIZES4])
def test_logical_specs_match_the_reference(logical, sizes):
    jmesh = _jmesh(sizes)
    layout = types.SimpleNamespace(shape=dict(jmesh.shape))
    assert logical_to_spec(logical, mesh=layout) == \
        tuple(jlogical_to_spec(logical, mesh=jmesh))
    assert logical_to_spec(logical) == tuple(jlogical_to_spec(logical))


@pytest.mark.parametrize("ici,dcn", [
    (dict(data=1, fsdp=2, tensor=2), dict(data=2)),
    (dict(data=2, tensor=2), dict(data=2)),
    (dict(fsdp=4), dict(data=1, fsdp=2))])
def test_two_level_layout_and_slices_match_the_reference(ici, dcn):
    jmesh = jtwo_level(ici=JMeshConfig(**ici), dcn=JMeshConfig(**dcn),
                       n_slices=2, devices=jax.devices()[:8])
    got = two_level_layout(MeshConfig(**ici), MeshConfig(**dcn), 2,
                           range(8))
    np.testing.assert_array_equal(got, _ids(jmesh))
    np.testing.assert_array_equal(slice_index_of(got, 2),
                                  jslice_index_of(jmesh, 2))


def test_two_level_layout_keeps_ici_axes_inside_a_slice():
    """tests/test_model_parallel.py's topology check on the port's
    layout: walking fsdp or tensor never changes slice, walking data
    does."""
    layout = two_level_layout(MeshConfig(data=1, fsdp=2, tensor=2),
                              MeshConfig(data=2), 2, range(8))
    slc = slice_index_of(layout, 2)
    names = ["data", "fsdp", "expert", "seq", "tensor", "stage"]
    for ax in ("fsdp", "tensor"):
        assert (np.diff(slc, axis=names.index(ax)) == 0).all()
    moved = np.moveaxis(slc, names.index("data"), 0).reshape(2, -1)
    assert (moved[0] != moved[1]).all()


def test_two_level_layout_rejects_tensor_over_dcn():
    for mod_cfg, fn in ((JMeshConfig, lambda i, d: jtwo_level(
            ici=i, dcn=d, n_slices=2, devices=jax.devices()[:8])),
            (MeshConfig, lambda i, d: two_level_layout(i, d, 2, range(8)))):
        with pytest.raises(ValueError, match="inside a slice"):
            fn(mod_cfg(data=4), mod_cfg(data=1, tensor=2))


@pytest.mark.parametrize("axis", ["seq", "expert", "stage"])
def test_seq_expert_stage_build_the_train_steps_plan(ranks8, axis):
    """seq, expert and stage above 1 build the train step's plan for
    both families (on 8 ranks, the axis at 2 beside data 4).  seq and
    expert get their groups; stage ranks are replicas, so no group is
    made for them and no gradient is summed over stage (the reference
    maps no leaf and no batch dim to it)."""
    for out in ranks8.plans[axis]:
        for name in ("gpt", "llama"):
            assert out[name]["plan"] == "MeshPlan"
            if axis != "stage":
                assert out[name]["groups"][axis] == 2
                continue
            assert out[name]["groups"] == {"seq": 1, "expert": 1, "moe": 1}
            assert all("stage" not in sums
                       for sums in out[name]["sums"].values()), out[name]


@pytest.mark.parametrize("sizes", [SIZES8, SIZES4, dict(data=2, seq=2),
                                   dict(data=8)])
@pytest.mark.parametrize("shape", [(32, 4, 8), (31, 4, 8), (32, 3, 8),
                                   (32, 4, 7)])
def test_spmd_ce_applicable_matches_the_reference(sizes, shape):
    from ray_tpu.ops.cross_entropy import spmd_ce_applicable as japplicable
    from ray_tpu_torch.ops.cross_entropy import spmd_ce_applicable

    n = int(np.prod(list(sizes.values())))
    jmesh = jcreate_mesh(JMeshConfig(**sizes), devices=jax.devices()[:n])
    layout = types.SimpleNamespace(shape=dict(jmesh.shape))
    assert spmd_ce_applicable(layout, *shape) == japplicable(jmesh, *shape)
    assert not spmd_ce_applicable(None, *shape)


@pytest.mark.parametrize("sizes,shape", [
    (dict(data=2, tensor=2), (3, 8)),
    (dict(data=2, fsdp=2), (6, 8)),
    (dict(data=1, tensor=3), (2, 8)),
], ids=["batch-over-data", "batch-over-data-fsdp", "vocab-over-tensor"])
def test_uneven_mesh_loss_matches_the_reference_fallback(request, sizes,
                                                         shape):
    """Where `spmd_ce_applicable` is false the reference falls back to
    materialised logits.  Rows the row ranks do not divide: both
    families' losses on the port's 4 ranks (placed params, the global
    batch) are the fallback's, and their summed gradients the
    reference's one device's.  A vocab that tensor = 3 does not divide
    (nor does nano's d_model or llama-tiny's heads): the reference's
    train step refuses it at placement, and so does the port's, on a
    mesh of no process group (before any collective)."""
    name = request.node.callspec.id
    families = (("gpt", jgpt, NANO_J), ("llama", jllama, TINY_J))
    if name == "vocab-over-tensor":
        fake = types.SimpleNamespace(
            shape=sizes, mesh=np.zeros((1, 1, 1, 1, 3, 1)),
            mesh_dim_names=("data", "fsdp", "expert", "seq", "tensor",
                            "stage"),
            get_coordinate=lambda: [0, 0, 0, 0, 1, 0])
        for family, jmod, jcfg in families:
            mod, cfg = (gpt, NANO_T) if family == "gpt" else (llama, TINY_T)
            with pytest.raises(ValueError, match="does not split evenly"):
                mod.shard_params(mod.init_params(cfg, device="cpu"), fake,
                                 cfg, device="cpu")
            with pytest.raises(ValueError, match="divisible"):
                jmod.shard_params(_np_params(family), _jmesh(sizes), jcfg)
        return
    ranks4 = request.getfixturevalue("ranks4")
    jmesh = _jmesh(sizes)
    batch = {"tokens": _uneven_tokens(shape)}
    for family, jmod, jcfg in families:
        params = _np_params(family)
        loss = jax.jit(lambda p: jmod.loss_fn(p, batch, jcfg, jmesh))(
            jmod.shard_params(params, jmesh, jcfg))
        want = _flat(jax.grad(lambda p: jmod.loss_fn(p, batch, jcfg, None))(
            params))
        got = {k: np.full(v.shape, np.nan, np.float32)
               for k, v in want.items()}
        for out in ranks4.uneven[name, family]:
            np.testing.assert_allclose(out["loss"], float(loss), rtol=1e-5)
            for path, (index, data) in out["grads"].items():
                got[path][_slices(index)] = data
        for path, w in want.items():
            w = np.asarray(w)
            np.testing.assert_allclose(got[path], w, rtol=0,
                                       atol=1e-5 * np.abs(w).max(),
                                       err_msg=f"{family} {path}")


def test_moe_under_a_mesh_builds_its_expert_groups(ranks8):
    """A MoE config's train step builds its plan under a mesh of data 4
    and expert 2, its MoE partial outputs summed over the expert group
    (tests/test_torch_mesh_seq_expert.py holds its numbers)."""
    for out in ranks8.plans["expert"]:
        assert out["gpt-moe"]["plan"] == "MeshPlan"
        assert out["gpt-moe"]["groups"] == {"seq": 1, "expert": 2,
                                            "moe": 2}


# --------------------------------------------------------------------------
# On the ranks.
# --------------------------------------------------------------------------


@pytest.mark.parametrize("family", ["gpt", "llama"])
def test_every_shard_equals_the_reference_addressable_shard(ranks8, family):
    mod, cfg = (jgpt, NANO_J) if family == "gpt" else (jllama, TINY_J)
    placed = _flat(mod.shard_params(_np_params(family), ranks8.jmesh, cfg))
    ids = _ids(ranks8.jmesh)
    for rank, out in enumerate(ranks8.shards[family]):
        assert ids[tuple(out["coordinate"])] == rank
        for path, (index, data) in out["shards"].items():
            want_index, want = _jax_shards(placed[path])[rank]
            assert index == want_index, (rank, path)
            np.testing.assert_array_equal(data, want, err_msg=path)
        assert out["full_tensor_differs"] == []
        assert out["spec_of_differs"] == []


def _check_ce(ranks, sizes):
    x, head, t, valid = _ce_inputs()
    jmesh = _jmesh(sizes)
    with jmesh:
        def f(x, h):
            return jce(x, h, jnp.asarray(t), jnp.asarray(valid), jmesh)
        loss = float(jax.jit(f)(x, head))
        dx, dhead = jax.jit(jax.grad(f, argnums=(0, 1)))(x, head)
    dx, dhead = np.asarray(dx), np.asarray(dhead)
    for out in ranks:
        np.testing.assert_allclose(out["loss"], loss, rtol=1e-5, atol=1e-5)
        index, got = out["dx"]
        np.testing.assert_allclose(got, dx[_slices(index)], atol=1e-5)
        index, got = out["dhead"]
        np.testing.assert_allclose(got, dhead[_slices(index)], atol=1e-5)


def test_spmd_cross_entropy_matches_reference_dp2_tp2(ranks4):
    _check_ce(ranks4.ce, SIZES4)


def test_spmd_cross_entropy_matches_reference_dp2_fsdp2_tp2(ranks8):
    _check_ce(ranks8.ce, SIZES8)


def _manifest(path):
    with open(os.path.join(path, "manifest.json")) as f:
        return json.load(f)


def _by_path(man) -> dict:
    return {e["path"]: e for e in man["arrays"]}


def test_mesh_save_is_the_reference_format(ranks8):
    """The port's save from 8 ranks and the reference's from its
    8-device mesh of the same tree: the same arrays by path (shape,
    dtype, spec, chunk indices and sizes) and the same chunk bytes.
    (Leaf ids follow each tree's key order: the reference's pytree is
    key-sorted, the port's keeps its param order.)"""
    ref = _by_path(_manifest(ranks8.ref_path))
    port = _by_path(_manifest(ranks8.port_path))
    assert set(port) == set(ref)
    for path, want in ref.items():
        got = port[path]
        for key in ("shape", "dtype", "spec"):
            assert got[key] == want[key], (path, key)
        assert [(c["index"], c["nbytes"]) for c in got["chunks"]] == \
            [(c["index"], c["nbytes"]) for c in want["chunks"]], path
        assert [c["file"] for c in got["chunks"]] == [
            f"a{got['id']}_c{n}.bin" for n in range(len(got["chunks"]))]
        for a, b in zip(want["chunks"], got["chunks"]):
            with open(os.path.join(ranks8.ref_path, a["file"]), "rb") as fa, \
                    open(os.path.join(ranks8.port_path, b["file"]),
                         "rb") as fb:
                assert fa.read() == fb.read(), (path, a["index"])
    assert _manifest(ranks8.port_path)["process_count"] == 8
    assert all(os.path.exists(os.path.join(ranks8.port_path,
                                           f"DONE.{r}.mesh"))
               for r in range(8))


def test_reference_restores_the_mesh_save(ranks8):
    want = _flat(_np_params("gpt"))
    got = _flat(jckpt.restore_sharded(ranks8.port_path)["params"])
    for path in want:
        np.testing.assert_array_equal(got[path], want[path], err_msg=path)
    onto = _flat(jckpt.restore_sharded(ranks8.port_path,
                                       mesh=ranks8.jmesh)["params"])
    placed = _flat(jgpt.shard_params(_np_params("gpt"), ranks8.jmesh,
                                     NANO_J))
    for path, arr in onto.items():
        assert arr.sharding.spec == placed[path].sharding.spec, path
        np.testing.assert_array_equal(np.asarray(arr), want[path])


def test_port_ranks_restore_the_reference_mesh_save(ranks8):
    placed = {f"params.{k.replace('/', '.')}": v for k, v in _flat(
        jgpt.shard_params(_np_params("gpt"), ranks8.jmesh, NANO_J)).items()}
    for rank, out in enumerate(ranks8.restored):
        assert set(out) == set(placed)
        for path, (index, data) in out.items():
            want_index, want = _jax_shards(placed[path])[rank]
            assert index == want_index, (rank, path)
            np.testing.assert_array_equal(data, want, err_msg=path)


def test_batch_rows_match_the_reference_shard_batch(ranks8):
    from ray_tpu.parallel import shard_batch as jshard_batch

    tokens = _tokens()
    placed = jshard_batch(ranks8.jmesh, {"tokens": tokens})["tokens"]
    spec = tuple(placed.sharding.spec)
    for rank, out in enumerate(ranks8.batches):
        want_index, want = _jax_shards(placed)[rank]
        assert out["index"] == want_index
        assert out["spec"] == spec
        np.testing.assert_array_equal(out["shard_batch"], want)
        for shape, got_spec, got in (out["global_batch"], out["fed"]):
            assert shape == list(tokens.shape) and got_spec == spec
            np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(out["replicated"], tokens)


def test_with_logical_constraint_moves_rows_to_columns(ranks8):
    """The port's collectives carry the move (a gather, then the new
    slice), and its backward moves the gradient back: the gradient of
    the sum of the moved shard's squares is twice the rows' shard."""
    tokens = _tokens()
    spec = tuple(jlogical_to_spec((None, "batch"), mesh=ranks8.jmesh))
    for out in ranks8.batches:
        got_spec, index, data = out["resharded"]
        assert got_spec == spec
        np.testing.assert_array_equal(data, tokens[_slices(index)])
        np.testing.assert_array_equal(out["resharded_grad"],
                                      2 * out["shard_batch"])


def test_shard_opt_state_places_moments_like_params(ranks8):
    specs = _flat(jax.tree.map(
        lambda s: tuple(jlogical_to_spec(s, mesh=ranks8.jmesh)),
        jgpt.param_specs(NANO_J), is_leaf=lambda x: isinstance(x, tuple)))
    for out in ranks8.batches:
        got = out["opt_specs"]
        assert _flat(got["mu"]) == specs and _flat(got["nu"]) == specs
        assert got["count"] == ()


def test_single_device_mesh_is_one_device_and_axis_sizes(ranks8):
    for out in ranks8.batches:
        sizes, on_mesh, alone = out["single_device_mesh"]
        assert sizes == dict.fromkeys(sizes, 1) and len(sizes) == 6
        assert on_mesh == alone
        assert out["mesh_axis_size"] == {"data": 2, "fsdp": 2, "expert": 1,
                                         "seq": 1, "tensor": 2, "stage": 1}


def test_port_ranks_restore_with_one_replicated_sharding(ranks8):
    want = {f"params.{k.replace('/', '.')}": v
            for k, v in _flat(_np_params("gpt")).items()}
    for out in ranks8.replicated:
        assert set(out) == set(want)
        for path, (index, data) in out.items():
            assert index == [[0, n] for n in want[path].shape]
            np.testing.assert_array_equal(data, want[path], err_msg=path)
