"""The port's mesh train step (models/_functional.py under a mesh, gpt.py
and llama.py) against the JAX package's `make_train_step` under the
same mesh, on the CPU, and the rank launcher's failure paths.

JAX runs on the 8 virtual CPU devices of tests/conftest.py; the port on
gloo ranks spawned by `run_ranks` (one group of 8 and one of 4 for the
module, each bounded by RANK_TIMEOUT_S; the reference's train steps run
while they do).  From the reference's initial
weights, on the same batches, 3 AdamW steps (optax.adamw and the port's
adamw, lr 1e-3), f32:

- gpt nano at data2/fsdp2/tensor2 (tests/test_model_parallel.py:106's
  shape) and llama-tiny at data2/tensor2 and data2/fsdp2/tensor2
  (:269's), both families at data2/fsdp2/tensor2 also with remat (each
  block recomputed in the backward, its fsdp gathers inside it): every
  rank's losses within 1e-5 relative of the reference's,
  and so the loss of one more step on the last batch, the first loss
  that sees the third update; the final params, put together from
  every rank's shards, within 2 * lr per step of the reference's
  (Adam's first steps move a weight by about lr * sign(g), so a
  gradient near 0 whose sign differs in the last bits moves it by up to
  2 * lr; the same bound as tests/test_torch_gpt_train.py), and each
  leaf's update (final - start) within UPDATE_REL_TOL of the
  reference's in L2 norm (a tree never updated reads 1);
- the mesh's losses equal the port's own single-device step's within
  1e-5 relative;
- params placed by other rules (llama-tiny at data2/tensor2 with heads,
  kv heads and the MLP replicated and the vocab over data) are moved
  into the step's layout and train bit for bit as the default layout;
- AdamW's moments are DTensors placed like their params;
- each rank's fsdp gathers of block leaves in a step: 2 x layers x the
  leaves sharded over fsdp under remat (the forward's and the
  recompute's), 1 x without; their reduce-scatters 1 x in either;
- the mesh init (`init_state(0)`, drawn shard-wise) gives every rank
  slices of the single-device init, bit for bit, holding one whole leaf
  at a time while it draws.
"""

import concurrent.futures
import dataclasses
import functools
import types

import jax
import numpy as np
import optax
import pytest
import torch

from ray_tpu.models import gpt as jgpt
from ray_tpu.models import llama as jllama
from ray_tpu.parallel import (MeshConfig as JMeshConfig,
                              create_mesh as jcreate_mesh,
                              shard_batch as jshard_batch)
from ray_tpu_torch.models import gpt, llama
from ray_tpu_torch.models._functional import adamw
from ray_tpu_torch.models.convert import params_from_numpy
from ray_tpu_torch.parallel import rank_bodies
from ray_tpu_torch.parallel.launch import run_ranks
from ray_tpu_torch.parallel.sharding import (DEFAULT_RULES, logical_to_spec,
                                             spec_axes)

torch.set_num_threads(1)

RANK_TIMEOUT_S = 240
LR = 1e-3
STEPS = 3
SIZES8 = dict(data=2, fsdp=2, tensor=2)
SIZES4 = dict(data=2, tensor=2)
# Each leaf's ||update - reference update||_2 / ||reference update||_2.
UPDATE_REL_TOL = 1e-3
# Placement rules for the reshard case: what DEFAULT_RULES shards over
# tensor stays whole and the vocab splits over data instead.
OTHER_RULES = {**DEFAULT_RULES, "heads": None, "kv_heads": None,
               "mlp": None, "vocab": "data"}
FAMILIES = {"gpt": (jgpt, gpt, "nano"), "llama": (jllama, llama,
                                                   "llama-tiny")}


def _configs(family):
    """gpt-remat (llama-remat) is gpt nano (llama-tiny) with each block
    recomputed in the port's backward (its collectives run again there);
    the reference's numbers are nano's (llama-tiny's)."""
    jmod, tmod, name = FAMILIES[family.removesuffix("-remat")]
    tcfg = tmod.CONFIGS[name]
    if family.endswith("-remat"):
        tcfg = dataclasses.replace(tcfg, remat=True)
    return jmod, tmod, jmod.CONFIGS[name], tcfg


def _batches():
    rng = np.random.default_rng(21)
    return [rng.integers(0, 512, (8, 32)).astype(np.int32)
            for _ in range(STEPS)]


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def _reference_step(family: str, sizes: tuple):
    jmod, _, jcfg, _ = _configs(family.removesuffix("-remat"))
    sizes = dict(sizes)
    n = int(np.prod(list(sizes.values())))
    mesh = jcreate_mesh(JMeshConfig(**sizes), devices=jax.devices()[:n])
    init, step = jmod.make_train_step(jcfg, optax.adamw(LR), mesh)
    return mesh, init(jax.random.key(4)), step


@functools.cache
def _start(family: str, sizes: tuple):
    """The reference's initial numpy params under the mesh `sizes`."""
    _, state, _ = _reference_step(family, sizes)
    return jax.tree.map(np.asarray, state["params"])


@functools.cache
def _reference(family: str, sizes: tuple):
    """(initial numpy params, losses, final numpy params, the loss of
    one more step on the last batch) of the reference's jitted train
    step under the mesh `sizes`."""
    mesh, state, step = _reference_step(family, sizes)
    start = jax.tree.map(np.asarray, state["params"])
    step = jax.jit(step)
    losses = []
    for tokens in _batches():
        state, m = step(state, jshard_batch(mesh, {"tokens": tokens}))
        losses.append(float(m["loss"]))
    final = jax.tree.map(np.asarray, state["params"])
    _, m = step(state, jshard_batch(mesh, {"tokens": _batches()[-1]}))
    return start, losses, final, float(m["loss"])


def _train_call(family, sizes):
    _, _, _, tcfg = _configs(family)
    start = _start(family.removesuffix("-remat"), tuple(sizes.items()))
    return ("train", (family.removesuffix("-remat"), tcfg, sizes, start,
                      _batches(), LR))


def _run_beside_the_reference(calls, world, init_dir, cases):
    """The ranks' `calls` (`rank_bodies.sequence`), with the reference's
    runs of `cases` [(family, sizes)] computed while they run."""
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        running = pool.submit(run_ranks, rank_bodies.sequence, world,
                              args=(calls,), device="cpu",
                              init_dir=init_dir, timeout_s=RANK_TIMEOUT_S)
        for family, sizes in cases:
            _reference(family, tuple(sizes.items()))
        return running.result()


RUNS8 = ("gpt", "llama", "gpt-remat", "llama-remat")
INITS8 = ("gpt", "llama")


@pytest.fixture(scope="module")
def gang8(tmp_path_factory):
    """The group of 8's results by rank: the train runs of RUNS8, then
    the mesh init of INITS8."""
    calls = [_train_call(family, SIZES8) for family in RUNS8] + [
        ("init_shards", (family, _configs(family)[3], SIZES8))
        for family in INITS8]
    return _run_beside_the_reference(
        calls, 8, str(tmp_path_factory.mktemp("train8")),
        [("gpt", SIZES8), ("llama", SIZES8)])


@pytest.fixture(scope="module")
def ranks8(gang8):
    return {(family, "dp2_fsdp2_tp2"): [r[i] for r in gang8]
            for i, family in enumerate(RUNS8)}


@pytest.fixture(scope="module")
def init8(gang8):
    return {family: [r[len(RUNS8) + i] for r in gang8]
            for i, family in enumerate(INITS8)}


@pytest.fixture(scope="module")
def ranks4(tmp_path_factory):
    name, args = _train_call("llama", SIZES4)
    calls = [(name, args), (name, args + ("cpu", True, OTHER_RULES))]
    out = _run_beside_the_reference(
        calls, 4, str(tmp_path_factory.mktemp("train4")),
        [("llama", SIZES4)])
    return {("llama", "dp2_tp2"): [r[0] for r in out],
            ("llama", "dp2_tp2_other_rules"): [r[1] for r in out]}


CASES = [("gpt", "dp2_fsdp2_tp2", SIZES8), ("llama", "dp2_fsdp2_tp2", SIZES8),
         ("llama", "dp2_tp2", SIZES4), ("gpt-remat", "dp2_fsdp2_tp2", SIZES8),
         ("llama-remat", "dp2_fsdp2_tp2", SIZES8)]


def _ranks_of(request, family, name, sizes):
    fixture = "ranks8" if sizes is SIZES8 else "ranks4"
    return request.getfixturevalue(fixture)[(family, name)]


@pytest.mark.parametrize("family,name,sizes", CASES,
                         ids=[f"{f}-{n}" for f, n, _ in CASES])
def test_losses_match_the_reference_mesh_step(request, family, name,
                                              sizes):
    _, want, _, final_loss = _reference(family.removesuffix("-remat"),
                                        tuple(sizes.items()))
    for out in _ranks_of(request, family, name, sizes):
        np.testing.assert_allclose(out["losses"] + [out["final_loss"]],
                                   want + [final_loss], rtol=1e-5)


@pytest.mark.parametrize("family,name,sizes", CASES,
                         ids=[f"{f}-{n}" for f, n, _ in CASES])
def test_final_params_match_the_reference_mesh_step(request, family, name,
                                                    sizes):
    start, _, final, _ = _reference(family.removesuffix("-remat"),
                                    tuple(sizes.items()))
    start, want = _flat(start), _flat(final)
    got = {k: np.full(v.shape, np.nan, np.float32) for k, v in want.items()}
    for out in _ranks_of(request, family, name, sizes):
        for path, (index, data) in out["shards"].items():
            got[path][tuple(slice(a, b) for a, b in index)] = data
    for path in want:
        assert not np.isnan(got[path]).any(), path
        np.testing.assert_allclose(got[path], want[path],
                                   atol=2 * LR * STEPS, rtol=0,
                                   err_msg=path)
        moved = want[path].astype(np.float64) - start[path]
        err = np.linalg.norm(got[path] - start[path] - moved)
        assert err <= UPDATE_REL_TOL * np.linalg.norm(moved), (path, err)


@pytest.mark.parametrize("family,name,sizes", CASES,
                         ids=[f"{f}-{n}" for f, n, _ in CASES])
def test_mesh_losses_match_the_single_device_port(request, family, name,
                                                  sizes):
    _, tmod, _, tcfg = _configs(family)
    start = _reference(family.removesuffix("-remat"),
                       tuple(sizes.items()))[0]
    init, step = tmod.make_train_step(tcfg, adamw(LR), device="cpu")
    state = init(params=params_from_numpy(start, tcfg, device="cpu"))
    single = []
    for tokens in _batches() + _batches()[-1:]:
        state, m = step(state, {"tokens": torch.from_numpy(tokens)})
        single.append(float(m["loss"]))
    for out in _ranks_of(request, family, name, sizes):
        np.testing.assert_allclose(out["losses"] + [out["final_loss"]],
                                   single, rtol=1e-5)
        assert out["backend"] == "gloo"


@pytest.mark.parametrize("family,name,sizes", CASES,
                         ids=[f"{f}-{n}" for f, n, _ in CASES])
def test_adamw_moments_are_dtensors_placed_like_params(request, family,
                                                       name, sizes):
    for out in _ranks_of(request, family, name, sizes):
        assert out["moments_placed_like_params"]


@pytest.mark.parametrize("family", RUNS8)
def test_fsdp_gathers_of_the_blocks_per_step(ranks8, family):
    """The measured step's gathers of block leaves over fsdp
    (`MeshPlan.layer`, filed as "layer_all_gather"): under remat each
    block gathers in the forward and again in its recompute, so 2 x
    layers x the leaves fsdp shards; without remat once.  Their
    gradients are reduce-scattered once either way, from the
    recomputed graph under remat."""
    _, tmod, _, tcfg = _configs(family)
    mesh = types.SimpleNamespace(shape=SIZES8)
    leaves = sum("fsdp" in spec_axes(logical_to_spec(spec, mesh=mesh))
                 for spec in tmod.param_specs(tcfg)["blocks"].values())
    assert leaves == len(tmod.param_specs(tcfg)["blocks"])
    per_layer = 2 if tcfg.remat else 1
    for out in ranks8[(family, "dp2_fsdp2_tp2")]:
        ops = out["collectives"]["by_op"]
        assert ops["layer_all_gather"]["calls"] == \
            per_layer * tcfg.n_layers * leaves
        assert ops["layer_reduce_scatter"]["calls"] == \
            tcfg.n_layers * leaves


@pytest.mark.parametrize("family", INITS8)
def test_mesh_init_shards_are_slices_of_the_single_device_init(init8,
                                                               family):
    """`init_state(0)` under the mesh draws each leaf whole from the
    single device's stream and keeps the rank's slice (a copy) before
    the next draw: every shard equals the single-device init's slice to
    the bit, and no rank held two whole leaves at once."""
    _, tmod, _, tcfg = _configs(family)
    whole = _flat(tmod.init_params(tcfg, torch.Generator().manual_seed(0),
                                   device="cpu"))
    for out in init8[family]:
        assert out["most_whole_leaves_alive"] == 1
        assert out["shares_storage"] == []
        assert out["shards"].keys() == whole.keys()
        for path, (index, data) in out["shards"].items():
            np.testing.assert_array_equal(
                data, whole[path][tuple(slice(a, b) for a, b in index)]
                .numpy(), err_msg=path)


def test_params_placed_by_other_rules_train_as_the_default_layout(ranks4):
    """`shard_params(..., rules=OTHER_RULES)` hands the step DTensors in
    another layout; `MeshPlan.place` moves them into its own (through the
    port's collectives), so the run is the default one bit for bit."""
    default = ranks4[("llama", "dp2_tp2")]
    for out, base in zip(ranks4[("llama", "dp2_tp2_other_rules")], default):
        assert out["losses"] + [out["final_loss"]] == \
            base["losses"] + [base["final_loss"]]
        assert out["shards"].keys() == base["shards"].keys()
        for path, (index, data) in out["shards"].items():
            assert index == base["shards"][path][0], path
            np.testing.assert_array_equal(data, base["shards"][path][1],
                                          err_msg=path)


def test_mesh_train_round_trips_a_replicating_constraint(ranks8):
    for runs in ranks8.values():
        assert all(out["constraint_round_trip"] for out in runs)


def test_a_rank_that_raises_fails_the_group(tmp_path):
    with pytest.raises(RuntimeError, match=r"rank \d raised"):
        run_ranks(rank_bodies.shards, 2, args=("no-such-family", None,
                                                dict(data=2), {}),
                  device="cpu", init_dir=str(tmp_path), timeout_s=120)


def test_llama_kv_heads_must_split_over_tensor(tmp_path):
    """llama-tiny's 2 kv heads over tensor = 4: the GQA repeat would need
    another rank's kv head, so the placement raises, as the reference's
    sharding would."""
    from ray_tpu_torch.models.convert import params_to_numpy

    params = params_to_numpy(llama.init_params(llama.CONFIGS["llama-tiny"],
                                               device="cpu"))
    with pytest.raises(RuntimeError, match="does not split evenly"):
        run_ranks(rank_bodies.shards, 4, args=(
            "llama", llama.CONFIGS["llama-tiny"], dict(data=1, tensor=4),
            params), device="cpu", init_dir=str(tmp_path), timeout_s=120)


def test_a_group_past_its_timeout_is_killed(tmp_path):
    with pytest.raises(RuntimeError, match="had not finished after"):
        run_ranks(rank_bodies.train, 2, args=(
            "gpt", gpt.CONFIGS["nano"], dict(data=2), None, _batches(), LR),
            device="cpu", init_dir=str(tmp_path), timeout_s=0.5)
