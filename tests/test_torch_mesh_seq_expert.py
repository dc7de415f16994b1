"""The port's seq and expert mesh axes (models/_functional.py `MeshPlan`,
ring attention in gpt.py and llama.py, gpt.py's Switch MoE under a
mesh) against the JAX package under the same meshes, on the CPU.

JAX runs on the 8 virtual CPU devices of tests/conftest.py; the port on
one group of 8 gloo ranks spawned by `run_ranks` for the module, every
mesh of the file built in turn on it (`rank_bodies.sequence`), rank r
standing where JAX's device r stands; the module's fixture computes the
reference's side while the ranks run.  f32 throughout.  Held:

- gpt nano's logits on data2/seq4 (tests/test_model_parallel.py:135's
  case) against the reference's, on the mesh and on one device, within
  its own 2e-4;
- gpt nano's train step on data2/seq4, 3 AdamW steps (optax.adamw and
  the port's adamw, lr 1e-3) from the reference's initial weights:
  every rank's losses, and the loss of one more step on the last batch,
  within 1e-5 relative of the reference's jitted mesh step (:156's
  shape); each leaf's update within UPDATE_REL_TOL of the reference's in
  L2 norm.  The gradients of the replicated leaves are summed over seq
  as well as data (`grad_sum_axes`), which these updates need;
- llama-tiny's loss on data2/tensor2/seq2 (:250's case) within 1e-5
  relative of the reference's on the mesh, and its mesh losses within
  1e-5 of the port's own single-device step's;
- `fused_cross_entropy_spmd` on dp2/tp2/seq2 (:364's shape): loss, dx
  and dhead within 1e-5;
- nano-moe on data2/expert4 (:124's case): the aux at the initial
  weights within 1e-5 relative, and the losses and updates of 3 AdamW
  steps as for gpt nano;
- the Switch MoE layer on data2/expert2/seq2 with one expert taking
  nearly every token, so that the capacity (counted over the global
  batch) drops tokens in global order: tokens of the first seq rank's
  second row are dropped after tokens of the second seq rank's first
  row are kept.  Output, aux and the gradients of sum(out * dout) + aux
  (x, router, w_up, w_down) within 1e-5 of the reference's `_moe_mlp`
  on the global batch;
- seq and expert meshes build a `MeshPlan` (the refusals of
  tests/test_torch_mesh.py lifted).
"""

import concurrent.futures
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ray_tpu.models import gpt as jgpt
from ray_tpu.models import llama as jllama
from ray_tpu.ops.cross_entropy import fused_cross_entropy_spmd as jce
from ray_tpu.parallel import (MeshConfig as JMeshConfig,
                              create_mesh as jcreate_mesh,
                              shard_batch as jshard_batch)
from ray_tpu_torch.models import gpt, llama
from ray_tpu_torch.models._functional import adamw
from ray_tpu_torch.models.convert import params_from_numpy
from ray_tpu_torch.parallel import rank_bodies
from ray_tpu_torch.parallel.launch import run_ranks

torch.set_num_threads(1)

RANK_TIMEOUT_S = 240
LR = 1e-3
STEPS = 3
UPDATE_REL_TOL = 1e-3       # tests/test_torch_mesh_train.py's
SEQ = dict(data=2, seq=4)
LLAMA_SEQ = dict(data=2, tensor=2, seq=2)
EXPERT = dict(data=2, expert=4)
OVERFLOW = dict(data=2, expert=2, seq=2)
PLANS = dict(data=4, seq=2), dict(data=4, expert=2)
# family -> (reference module, port module, config name)
MODELS = {"gpt": (jgpt, gpt, "nano"), "moe": (jgpt, gpt, "nano-moe"),
          "llama": (jllama, llama, "llama-tiny")}
CE_B, CE_L, CE_D, CE_V = 4, 8, 16, 32


def _jmesh(sizes):
    n = int(np.prod(list(sizes.values())))
    return jcreate_mesh(JMeshConfig(**sizes), devices=jax.devices()[:n])


def _family(model):
    return "llama" if model == "llama" else "gpt"


def _batches(length=32):
    rng = np.random.default_rng(23)
    return [rng.integers(0, 512, (8, length)).astype(np.int32)
            for _ in range(STEPS)]


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


@functools.cache
def _start(model):
    jmod, _, name = MODELS[model]
    return jax.tree.map(np.asarray, jmod.init_params(jmod.CONFIGS[name],
                                                     jax.random.key(4)))


@functools.cache
def _reference_train(model, sizes):
    """Losses, final numpy params and the loss of one more step on the
    last batch of the reference's jitted train step under `sizes`, from
    `_start(model)` (its own init under the mesh on the same key)."""
    jmod, _, name = MODELS[model]
    mesh = _jmesh(dict(sizes))
    init, step = jmod.make_train_step(jmod.CONFIGS[name], optax.adamw(LR),
                                      mesh)
    state = init(jax.random.key(4))
    for path, leaf in _flat(state["params"]).items():
        np.testing.assert_array_equal(np.asarray(leaf),
                                      _flat(_start(model))[path])
    step = jax.jit(step)
    losses = []
    for tokens in _batches():
        state, m = step(state, jshard_batch(mesh, {"tokens": tokens}))
        losses.append(float(m["loss"]))
    final = jax.tree.map(np.asarray, state["params"])
    _, m = step(state, jshard_batch(mesh, {"tokens": _batches()[-1]}))
    return losses, final, float(m["loss"])


def _tokens():
    return np.random.default_rng(7).integers(0, 512, (4, 32)).astype(
        np.int32)


@functools.cache
def _llama_tokens():
    return np.random.default_rng(1).integers(0, 256, (8, 64)).astype(
        np.int32)


@functools.cache
def _ce_inputs():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((CE_B, CE_L, CE_D)).astype(np.float32)
    head = rng.standard_normal((CE_D, CE_V)).astype(np.float32)
    t = rng.integers(0, CE_V, (CE_B, CE_L)).astype(np.int32)
    valid = np.ones((CE_B, CE_L), np.float32)
    valid[:, -1] = 0.0
    valid[2, 3] = 0.0
    return x, head, t, valid


@functools.cache
def _overflow_inputs():
    """nano-moe's widths (4 experts), x [4, 16, 64] with a shared
    component that router column 0 follows, so nearly every token picks
    expert 0 and the capacity (ceil(64 / 4 * 1.25) = 20) keeps only the
    first 20 tokens of the global order."""
    rng = np.random.default_rng(8)
    d, f, e = 64, 128, 4
    common = rng.standard_normal(d).astype(np.float32)
    x = (rng.standard_normal((4, 16, d)) * 0.3 + common).astype(np.float32)
    router = (rng.standard_normal((d, e)) * 0.05).astype(np.float32)
    router[:, 0] += common / np.linalg.norm(common) * 2
    w_up = (rng.standard_normal((e, d, f)) / np.sqrt(d)).astype(np.float32)
    w_down = (rng.standard_normal((e, f, d)) / np.sqrt(f)).astype(np.float32)
    dout = rng.standard_normal((4, 16, d)).astype(np.float32)
    return x, router, w_up, w_down, dout


def _train_call(model, sizes, batches=None):
    return ("train", (_family(model), MODELS[model][1].CONFIGS[
        MODELS[model][2]], sizes, _start(model),
        _batches() if batches is None else batches, LR))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    calls = {
        "gpt_forward": ("forward", ("gpt", gpt.CONFIGS["nano"], SEQ,
                                    _start("gpt"), _tokens())),
        "gpt_train": _train_call("gpt", SEQ),
        "llama_train": _train_call("llama", LLAMA_SEQ, [_llama_tokens()]),
        "ce": ("cross_entropy", (LLAMA_SEQ,) + _ce_inputs()),
        "moe_forward": ("forward", ("gpt", gpt.CONFIGS["nano-moe"], EXPERT,
                                    _start("moe"), _batches()[0])),
        "moe_train": _train_call("moe", EXPERT),
        "overflow": ("moe", (gpt.CONFIGS["nano-moe"], OVERFLOW)
                     + _overflow_inputs()),
        "plans_seq": ("plans", (PLANS[0],)),
        "plans_expert": ("plans", (PLANS[1],)),
    }
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        running = pool.submit(
            run_ranks, rank_bodies.sequence, 8, args=(list(calls.values()),),
            device="cpu", init_dir=str(tmp_path_factory.mktemp(
                "seq_expert")), timeout_s=RANK_TIMEOUT_S)
        # XLA compiles outside the GIL: two threads overlap the compiles.
        with concurrent.futures.ThreadPoolExecutor(2) as jax_pool:
            for done in [jax_pool.submit(fn) for fn in (
                    functools.partial(_reference_train, "gpt",
                                      tuple(SEQ.items())),
                    functools.partial(_reference_train, "moe",
                                      tuple(EXPERT.items())),
                    _gpt_logits, _llama_loss, _ce_reference, _moe_forward,
                    _overflow_reference)]:
                done.result()
        out = running.result()
    return types.SimpleNamespace(**{
        name: [r[i] for r in out] for i, name in enumerate(calls)})


@functools.cache
def _gpt_logits():
    """The reference's logits on data2/seq4 and on one device."""
    cfg = jgpt.CONFIGS["nano"]
    mesh = _jmesh(SEQ)
    tokens = _tokens()
    sharded = jgpt.shard_params(_start("gpt"), mesh, cfg)
    on_mesh = np.asarray(jax.jit(
        lambda p, t: jgpt.forward(p, t, cfg, mesh)[0])(
            sharded, jax.device_put(tokens, jax.sharding.NamedSharding(
                mesh, jax.sharding.PartitionSpec("data", "seq")))))
    alone = jax.jit(lambda p, t: jgpt.forward(p, t, cfg)[0])(
        _start("gpt"), tokens)
    return on_mesh, np.asarray(alone)


def test_gpt_logits_on_data2_seq4_match_the_reference(ranks):
    on_mesh, alone = _gpt_logits()
    for out in ranks.gpt_forward:
        index, got = out["logits"]
        for want in (on_mesh, alone):
            np.testing.assert_allclose(got, want[_slices(index)],
                                       atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("model,sizes", [("gpt", SEQ), ("moe", EXPERT)],
                         ids=["gpt-data2_seq4", "moe-data2_expert4"])
def test_train_losses_and_updates_match_the_reference(ranks, model, sizes):
    want, final, final_loss = _reference_train(model, tuple(sizes.items()))
    start, final = _flat(_start(model)), _flat(final)
    runs = ranks.gpt_train if model == "gpt" else ranks.moe_train
    got = {k: np.full(v.shape, np.nan, np.float32) for k, v in final.items()}
    for out in runs:
        np.testing.assert_allclose(out["losses"] + [out["final_loss"]],
                                   want + [final_loss], rtol=1e-5)
        assert out["moments_placed_like_params"]
        for path, (index, data) in out["shards"].items():
            got[path][_slices(index)] = data
    for path, want_leaf in final.items():
        assert not np.isnan(got[path]).any(), path
        moved = want_leaf.astype(np.float64) - start[path]
        err = np.linalg.norm(got[path] - start[path] - moved)
        assert err <= UPDATE_REL_TOL * np.linalg.norm(moved), (path, err)


@functools.cache
def _llama_loss():
    cfg = jllama.CONFIGS["llama-tiny"]
    mesh = _jmesh(LLAMA_SEQ)
    batch = {"tokens": _llama_tokens()}
    return float(jax.jit(lambda p, b: jllama.loss_fn(p, b, cfg, mesh))(
        jllama.shard_params(_start("llama"), mesh, cfg),
        jshard_batch(mesh, batch)))


def test_llama_loss_on_data2_tensor2_seq2_matches_the_reference(ranks):
    want = _llama_loss()
    tcfg = llama.CONFIGS["llama-tiny"]
    init, step = llama.make_train_step(tcfg, adamw(LR), device="cpu")
    state = init(params=params_from_numpy(_start("llama"), tcfg,
                                          device="cpu"))
    single = []
    for _ in range(2):
        state, m = step(state, {"tokens": torch.from_numpy(
            _llama_tokens())})
        single.append(float(m["loss"]))
    for out in ranks.llama_train:
        np.testing.assert_allclose(out["losses"][0], want, rtol=1e-5)
        np.testing.assert_allclose(out["losses"] + [out["final_loss"]],
                                   single, rtol=1e-5)


@functools.cache
def _ce_reference():
    x, head, t, valid = _ce_inputs()
    jmesh = _jmesh(LLAMA_SEQ)
    with jmesh:
        def f(x, h):
            return jce(x, h, jnp.asarray(t), jnp.asarray(valid), jmesh)
        loss = float(jax.jit(f)(x, head))
        dx, dhead = jax.jit(jax.grad(f, argnums=(0, 1)))(x, head)
    return loss, np.asarray(dx), np.asarray(dhead)


def test_spmd_cross_entropy_matches_reference_dp2_tp2_seq2(ranks):
    loss, dx, dhead = _ce_reference()
    for out in ranks.ce:
        np.testing.assert_allclose(out["loss"], loss, rtol=1e-5, atol=1e-5)
        index, got = out["dx"]
        np.testing.assert_allclose(got, dx[_slices(index)], atol=1e-5)
        index, got = out["dhead"]
        np.testing.assert_allclose(got, dhead[_slices(index)], atol=1e-5)


@functools.cache
def _moe_forward():
    cfg = jgpt.CONFIGS["nano-moe"]
    mesh = _jmesh(EXPERT)
    logits, aux = jax.jit(lambda p, t: jgpt.forward(p, t, cfg, mesh))(
        jgpt.shard_params(_start("moe"), mesh, cfg),
        jshard_batch(mesh, {"tokens": _batches()[0]})["tokens"])
    return np.asarray(logits), float(aux)


def test_moe_aux_on_data2_expert4_matches_the_reference(ranks):
    logits, aux = _moe_forward()
    for out in ranks.moe_forward:
        np.testing.assert_allclose(out["aux"], float(aux), rtol=1e-5)
        index, got = out["logits"]
        np.testing.assert_allclose(got, logits[_slices(index)], atol=2e-4,
                                   rtol=2e-4)


@functools.cache
def _overflow_reference():
    x, router, w_up, w_down, dout = _overflow_inputs()
    cfg = jgpt.CONFIGS["nano-moe"]

    def f(x, router, w_up, w_down):
        out, aux = jgpt._moe_mlp(x, router, w_up, w_down, cfg, None)
        return jnp.sum(out * dout) + aux, (out, aux)

    grads, (out, aux) = jax.jit(jax.grad(f, argnums=(0, 1, 2, 3),
                                         has_aux=True))(
        x, router, w_up, w_down)
    return np.asarray(out), float(aux), [np.asarray(g) for g in grads]


def test_moe_overflow_keeps_the_global_queue_order(ranks):
    out_ref, aux_ref, grads = _overflow_reference()
    kept = (out_ref != 0).any(-1)
    # The setting drops tokens across ranks: expert 0 overflows, row 0
    # (split over seq ranks 0 and 1) is kept whole, and row 1 is kept
    # only in its first 4 positions, on seq rank 0; data rank 1's rows
    # are all dropped.
    assert kept[0].all() and kept[1, :4].all() and not kept[1, 4:].any()
    assert not kept[2:].any()
    seen = np.zeros(kept.shape, int)
    for out in ranks.overflow:
        index, got = out["out"]
        seen[_slices(index)[:2]] += 1
        np.testing.assert_allclose(got, out_ref[_slices(index)], atol=1e-5,
                                   rtol=1e-5)
        np.testing.assert_allclose(out["aux"], aux_ref, rtol=1e-5)
        for name, want in zip(("dx", "drouter", "dw_up", "dw_down"), grads):
            index, got = out[name]
            np.testing.assert_allclose(got, want[_slices(index)], atol=1e-5,
                                       rtol=1e-5, err_msg=name)
    assert (seen == 2).all()        # each token on both expert ranks


@pytest.mark.parametrize("which", ["seq", "expert"])
def test_seq_and_expert_meshes_build_a_plan(ranks, which):
    sizes = PLANS[0] if which == "seq" else PLANS[1]
    for rank, out in enumerate(getattr(ranks, f"plans_{which}")):
        for name, got in out.items():
            assert got["plan"] == "MeshPlan", name
            assert got["groups"][which] == 2
            assert got["groups"]["moe"] == sizes.get("expert", 1)
            seq_rank = rank % 2 if which == "seq" else 0
            assert got["offset"] == 8 * seq_rank
            for leaf, axes in got["sums"].items():
                # No leaf is sharded over data or seq: every gradient is
                # summed over both (fsdp is 1 here).
                assert tuple(a for a in axes if sizes.get(a, 1) > 1) == \
                    tuple(a for a in ("data", "seq") if a in sizes), \
                    (name, leaf)
