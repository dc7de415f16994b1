"""The port's train steps on global batches whose rows the row ranks
(data x fsdp) do not divide, against the JAX package's jitted mesh steps
on the same unplaced batches, on the CPU, f32.

GSPMD pads an uneven row split: each row rank holds ceil(B / ranks)
rows, a rank may hold none, and the reference's loss falls back to
materialised logits (`spmd_ce_applicable` false).  The port pads each
rank's rows to the same chunk and masks the pads
(`sharding.row_split`).  JAX runs on the virtual CPU devices of
tests/conftest.py; the port on one `RankGang` of 4 gloo ranks for the
module (`rank_bodies.sequence`, the reference's side computed while
the ranks run).  A mesh of 2 in the reference is the port's mesh of 2
with a `stage` axis of 2 beside it: stage ranks are replicas that hold
the same rows and params (tests/test_torch_mesh_replicas.py holds them
equal to the bit).  Held, from the reference's initial weights, 3 AdamW
steps (optax.adamw and the port's adamw, lr 1e-3):

- gpt nano on data2/tensor2, data4 (the last rank holds a pad row
  only), data2/fsdp2 (6 rows: 2, 2, 2 and 0) and data2/stage2, B 3;
  llama-tiny on fsdp2/tensor2, B 3; nano-moe on data2/expert2 and
  data2, B 3; gpt nano on data2/tensor2 with a `loss_mask` that zeroes
  the one real row of the second data rank: every rank's losses (and
  one more step's) within 1e-5 relative of the reference's, the final
  params within 2 * lr per step of the reference's and each leaf's
  update within UPDATE_REL_TOL of it in L2 norm (as
  tests/test_torch_mesh_train.py), and each rank's real rows GSPMD's;
- the reference's own fault (found while porting, not repaired there):
  on data2 beside a replica axis of 2 (tensor, stage or expert), with
  a real row on the second data rank, its jitted step adds the pad
  row's gradient into token 0's row of the embedding table
  (`PAD_LEAK`).  Its first loss is right, and every other gradient
  element is its one-device step's; its later losses drift (2.2e-5
  relative by the fourth).  On those meshes the port is held to the
  reference's one-device step (the function its fallback computes),
  and the leak is pinned: the reference's first gradient differs from
  its one device's in that row alone (shown on gpt-dp2_tp2), the
  port's does nowhere;
- nano-moe's routing on the first batch: capacity 8 (ceil(24 / 4 *
  1.25), the pad row not counted) in every layer, the dropped tokens
  per layer the port's one device's, the aux summed over the layers
  the reference's forward's within 1e-5 relative;
- ResNet on data2 with 3 images of 8 x 8 (2 and 1 a rank), at
  tests/test_torch_mesh_replicas.py's narrow widths (basic blocks,
  width 8, stage sizes (1, 1), 2 groups; resnet18-cifar's reference
  step alone takes ~33 s to compile here): losses within 1e-5 relative
  and accuracies equal to the reference's mesh step, every leaf's
  update within 0.05 * lr of it (tests/test_torch_resnet.py's bound),
  and every leaf equal to the port's one device taking the same halves
  within 1e-6 relative;
- what the reference refuses raises ValueError in both packages,
  before any of the port's collectives: an uneven length or rows under
  seq, `shard_batch` of 3 rows over data 2, `pipeline_loss_dryrun`
  with microbatch rows 3 over data 2, and `init_state` on tensor 3 at
  nano (3 ranks of their own).
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
from ray_tpu.models import resnet as jresnet
from ray_tpu.parallel import (MeshConfig as JMeshConfig,
                              create_mesh as jcreate_mesh,
                              shard_batch as jshard_batch)
from ray_tpu.parallel import pipeline as jpipeline
from ray_tpu_torch.models import gpt, llama, resnet
from ray_tpu_torch.models.convert import resnet_state_dict, resnet_variables
from ray_tpu_torch.parallel import rank_bodies
from ray_tpu_torch.parallel.launch import RankGang, run_ranks

torch.set_num_threads(1)
torch.backends.cudnn.allow_tf32 = False

RANK_TIMEOUT_S = 240
LR = 1e-3
STEPS = 3
UPDATE_REL_TOL = 1e-3       # tests/test_torch_mesh_train.py's
FAMILIES = {"gpt": (jgpt, gpt, "nano"), "moe": (jgpt, gpt, "nano-moe"),
            "llama": (jllama, llama, "llama-tiny")}
# case: (family, the reference's mesh, the port's mesh, rows, loss mask)
CASES = {
    "gpt-dp2_tp2": ("gpt", dict(data=2, tensor=2), None, 3, False),
    "gpt-dp4": ("gpt", dict(data=4), None, 3, False),
    "gpt-dp2_fsdp2": ("gpt", dict(data=2, fsdp=2), None, 6, False),
    "gpt-dp2_stage2": ("gpt", dict(data=2, stage=2), None, 3, False),
    "llama-fsdp2_tp2": ("llama", dict(fsdp=2, tensor=2), None, 3, False),
    "moe-dp2_ep2": ("moe", dict(data=2, expert=2), None, 3, False),
    "moe-dp2": ("moe", dict(data=2), dict(data=2, stage=2), 3, False),
    "gpt-dp2_tp2-mask": ("gpt", dict(data=2, tensor=2), None, 3, True),
}
RESNET_SHAPE = (8, 8, 3)
REFUSALS = ("seq_length", "seq_rows", "shard_batch", "pipeline",
            "placement")
# The cases whose reference mesh step leaks the pad row's gradient into
# token 0's embedding row (see the module docstring).
PAD_LEAK = ("gpt-dp2_tp2", "gpt-dp2_stage2", "moe-dp2_ep2")
LEAK_SHOWN = "gpt-dp2_tp2"


def _jmesh(sizes):
    n = int(np.prod(list(sizes.values())))
    return jcreate_mesh(JMeshConfig(**sizes), devices=jax.devices()[:n])


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _slices(index):
    return tuple(slice(a, b) for a, b in index)


@functools.cache
def _start(family):
    jmod, _, name = FAMILIES[family]
    return jax.tree.map(np.asarray, jmod.init_params(jmod.CONFIGS[name],
                                                     jax.random.key(4)))


def _batches(case):
    _, _, _, rows, mask = CASES[case]
    return _draw(rows, mask)


@functools.cache
def _draw(rows, mask):
    rng = np.random.default_rng(41)
    out = []
    for _ in range(STEPS):
        b = {"tokens": rng.integers(0, 512, (rows, 8)).astype(np.int32)}
        if mask:
            # Row 2 is the one real row of the second data rank.
            b["loss_mask"] = np.ones((rows, 8), np.float32)
            b["loss_mask"][2] = 0.0
        out.append(b)
    return out


@functools.cache
def _reference(family, sizes, rows, mask):
    """(losses, final numpy params, the loss of one more step on the
    last batch) of the reference's jitted train step under the mesh
    `sizes` (a tuple of items; None: one device), each batch passed
    unplaced."""
    jmod, _, name = FAMILIES[family]
    init, step = jmod.make_train_step(
        jmod.CONFIGS[name], optax.adamw(LR),
        None if sizes is None else _jmesh(dict(sizes)))
    state = init(jax.random.key(4))
    step = jax.jit(step)
    losses = []
    for b in _draw(rows, mask):
        state, m = step(state, b)
        losses.append(float(m["loss"]))
    final = jax.tree.map(np.asarray, state["params"])
    _, m = step(state, _draw(rows, mask)[-1])
    return losses, final, float(m["loss"])


def _want_key(case) -> tuple:
    """`_reference`'s arguments for what the port is held to: the
    reference's mesh step, or on the PAD_LEAK meshes its one-device
    step."""
    family, sizes, _, rows, mask = CASES[case]
    return (family, None if case in PAD_LEAK else tuple(sizes.items()),
            rows, mask)


def _want(case):
    return _reference(*_want_key(case))


@functools.cache
def _reference_grads(case):
    """The reference's loss and first gradients (flat numpy trees) on
    the case's first batch: under the mesh (placed params, jitted) and
    on one device."""
    family, sizes, _, _, _ = CASES[case]
    jmod, _, name = FAMILIES[family]
    cfg, mesh, batch = jmod.CONFIGS[name], _jmesh(sizes), _batches(case)[0]
    placed = jmod.shard_params(_start(family), mesh, cfg)
    loss, on_mesh = jax.jit(jax.value_and_grad(
        lambda p: jmod.loss_fn(p, batch, cfg, mesh)))(placed)
    one = jax.grad(lambda p: jmod.loss_fn(p, batch, cfg, None))
    return float(loss), _flat(on_mesh), _flat(one(_start(family)))


@functools.cache
def _reference_aux():
    """The reference's aux summed over nano-moe's layers on the first
    batch of moe-dp2_ep2 (its forward on one device)."""
    cfg = jgpt.CONFIGS["nano-moe"]
    _, aux = jgpt.forward_trunk(_start("moe"),
                                _batches("moe-dp2_ep2")[0]["tokens"], cfg)
    return float(aux)


def _resnet_configs():
    kw = dict(stage_sizes=(1, 1), width=8, num_groups=2, num_classes=10,
              bottleneck=False, cifar_stem=True)
    return (jresnet.ResNetConfig(dtype=jnp.float32, **kw),
            resnet.ResNetConfig(dtype=torch.float32, **kw))


@functools.cache
def _resnet_batches():
    rng = np.random.default_rng(13)
    return [{"images": rng.standard_normal((3,) + RESNET_SHAPE).astype(
        np.float32), "labels": rng.integers(0, 10, (3,)).astype(np.int32)}
        for _ in range(STEPS)]


@functools.cache
def _reference_resnet():
    """The reference's start and final flax variables and its losses and
    accuracies on data2, each batch unplaced."""
    cj, _ = _resnet_configs()
    init, step = jresnet.make_train_step(cj, optax.adamw(LR),
                                         _jmesh(dict(data=2)),
                                         input_shape=RESNET_SHAPE)
    state = init(jax.random.key(0))
    start = jax.tree.map(np.array, state["params"])
    step = jax.jit(step)
    losses, accs = [], []
    for b in _resnet_batches():
        state, m = step(state, b)
        losses.append(float(m["loss"]))
        accs.append(float(m["accuracy"]))
    return start, jax.tree.map(np.asarray, state["params"]), losses, accs


@functools.cache
def _resnet_start_dict():
    _, ct = _resnet_configs()
    return {k: v.numpy() for k, v in resnet_state_dict(
        _reference_resnet()[0], ct, device="cpu").items()}


def _reference_refusal(case):
    """The reference's error on each case the port refuses, or None."""
    cfg = jgpt.CONFIGS["nano"]

    def step(sizes, shape):
        init, fn = jgpt.make_train_step(cfg, optax.adamw(LR), _jmesh(sizes))
        jax.jit(fn)(init(jax.random.key(0)),
                    {"tokens": np.zeros(shape, np.int32)})

    def dryrun():
        jpipeline.pipeline_loss_dryrun(
            lambda p, x: jnp.tanh(x @ p["w"]),
            lambda y, t: ((y - t) ** 2).mean(),
            _jmesh(dict(data=2, stage=2)), {"w": jnp.zeros((2, 4, 4))},
            np.zeros((2, 3, 4), np.float32), np.zeros((2, 3, 4), np.float32))

    calls = {
        "seq_length": lambda: step(dict(data=2, seq=2), (2, 7)),
        "seq_rows": lambda: step(dict(data=2, seq=2), (3, 8)),
        "shard_batch": lambda: jshard_batch(
            _jmesh(dict(data=2, tensor=2)),
            {"tokens": np.zeros((3, 8), np.int32)}),
        "pipeline": dryrun,
        "placement": lambda: jgpt.make_train_step(
            cfg, optax.adamw(LR), _jmesh(dict(tensor=3)))[0](
                jax.random.key(0)),
    }
    try:
        calls[case]()
    except Exception as e:                      # the refusal under test
        return type(e).__name__, str(e)
    return None


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    calls = {}
    for case, (family, sizes, port_sizes, _, _) in CASES.items():
        _, mod, name = FAMILIES[family]
        calls[case] = ("train", (family.replace("moe", "gpt"),
                                 mod.CONFIGS[name], port_sizes or sizes,
                                 _start(family), _batches(case), LR))
    moe = gpt.CONFIGS["nano-moe"]
    first = _batches("moe-dp2_ep2")[0]["tokens"]
    calls["routing"] = ("routing", (dict(data=2, expert=2), moe, first,
                                    "cpu", _start("moe")))
    calls["routing_dp2"] = ("routing", (dict(data=2, stage=2), moe, first,
                                        "cpu", _start("moe")))
    _, ct = _resnet_configs()
    calls["resnet"] = ("resnet", (dict(data=2, stage=2), ct,
                                  _resnet_batches(), LR, "cpu",
                                  _resnet_start_dict()))
    calls["refusals"] = ("refusals", (list(REFUSALS[:-1]),))
    family, sizes, _, _, _ = CASES[LEAK_SHOWN]
    calls["grads"] = ("loss_grads", ("gpt", gpt.CONFIGS["nano"], sizes,
                                     _start(family),
                                     _batches(LEAK_SHOWN)[0]["tokens"]))
    d = tmp_path_factory.mktemp("uneven")
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        running = pool.submit(_run_gang, str(d / "gang"),
                              list(calls.values()))
        three = pool.submit(run_ranks, rank_bodies.refusals, 3,
                            args=(["placement"],), device="cpu",
                            init_dir=str(d / "three"),
                            timeout_s=RANK_TIMEOUT_S)
        # XLA compiles outside the GIL: threads overlap the compiles.
        with concurrent.futures.ThreadPoolExecutor(4) as jax_pool:
            keys = {_want_key(case) for case in CASES}
            for done in [jax_pool.submit(_reference, *k) for k in keys] \
                    + [jax_pool.submit(fn) for fn in (
                        _reference_resnet, _reference_aux,
                        functools.partial(_reference_grads, LEAK_SHOWN))]:
                done.result()
        out, placement = running.result(), three.result()
    ns = types.SimpleNamespace(**{
        name: [r[i] for r in out] for i, name in enumerate(calls)})
    for r, p in zip(ns.refusals, placement + [{}]):
        r.update(p)
    return ns


def _run_gang(init_dir: str, calls: list) -> list:
    with RankGang(4, device="cpu", init_dir=init_dir,
                  timeout_s=RANK_TIMEOUT_S) as gang:
        return gang.run(rank_bodies.sequence, calls)


def _real_rows(rows: int, parts: int) -> list:
    """GSPMD's real rows of each of `parts` row ranks."""
    chunk = -(-rows // parts)
    return [max(0, min(rows, (i + 1) * chunk) - i * chunk)
            for i in range(parts)]


@pytest.mark.parametrize("case", list(CASES))
def test_losses_match_the_reference_on_uneven_rows(ranks, case):
    want, _, final_loss = _want(case)
    for out in getattr(ranks, case):
        np.testing.assert_allclose(out["losses"] + [out["final_loss"]],
                                   want + [final_loss], rtol=1e-5)


@pytest.mark.parametrize("case", list(CASES))
def test_final_params_match_the_reference_on_uneven_rows(ranks, case):
    family = CASES[case][0]
    _, final, _ = _want(case)
    start, want = _flat(_start(family)), _flat(final)
    got = {k: np.full(v.shape, np.nan, np.float32) for k, v in want.items()}
    for out in getattr(ranks, case):
        for path, (index, data) in out["shards"].items():
            got[path][_slices(index)] = data
    for path in want:
        assert not np.isnan(got[path]).any(), path
        np.testing.assert_allclose(got[path], want[path],
                                   atol=2 * LR * STEPS, rtol=0,
                                   err_msg=path)
        moved = want[path].astype(np.float64) - start[path]
        err = np.linalg.norm(got[path] - start[path] - moved)
        assert err <= UPDATE_REL_TOL * np.linalg.norm(moved), (path, err)


def test_the_reference_leaks_pad_rows_into_token_0_and_the_port_not(ranks):
    loss, on_mesh, one = _reference_grads(LEAK_SHOWN)
    for path, want in one.items():
        got = on_mesh[path]
        if path == "tok_embed":
            assert np.abs(got[0] - want[0]).max() > 1e-3
            got, want = got[1:], want[1:]
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6,
                                   err_msg=path)
    got = {k: np.full(v.shape, np.nan, np.float32) for k, v in one.items()}
    for out in ranks.grads:
        np.testing.assert_allclose(out["loss"], loss, rtol=1e-5)
        for path, (index, data) in out["grads"].items():
            got[path][_slices(index)] = data
    for path, want in one.items():
        np.testing.assert_allclose(got[path], want, rtol=0,
                                   atol=1e-5 * np.abs(want).max(),
                                   err_msg=path)


@pytest.mark.parametrize("case", list(CASES))
def test_each_rank_holds_gspmds_rows(ranks, case):
    """Real rows by data-major row rank, the pads up to one chunk; a
    pad-only rank still took every step (its losses are the others')."""
    _, sizes, port_sizes, rows, _ = CASES[case]
    sizes = port_sizes or sizes
    parts = sizes.get("data", 1) * sizes.get("fsdp", 1)
    want = _real_rows(rows, parts)
    for out in getattr(ranks, case):
        c = dict(zip(("data", "fsdp", "expert", "seq", "tensor", "stage"),
                     out["coordinate"]))
        i = c["data"] * sizes.get("fsdp", 1) + c["fsdp"]
        assert out["real_rows"] == want[i]
        assert out["chunk"] == -(-rows // parts)
        assert len(out["losses"]) == STEPS


@functools.cache
def _one_device_routing():
    return rank_bodies.routing(0, 1, None, gpt.CONFIGS["nano-moe"],
                               _batches("moe-dp2_ep2")[0]["tokens"], "cpu",
                               _start("moe"))


@pytest.mark.parametrize("mesh", ["routing", "routing_dp2"])
def test_moe_capacity_drops_and_aux_on_uneven_rows(ranks, mesh):
    moe = gpt.CONFIGS["nano-moe"]
    one = _one_device_routing()
    assert one["capacity"] == [8] * moe.n_layers
    for out in getattr(ranks, mesh):
        assert out["capacity"] == one["capacity"]
        assert out["dropped"] == one["dropped"]
        np.testing.assert_allclose(out["aux"], _reference_aux(), rtol=1e-5)
        np.testing.assert_allclose(one["aux"], _reference_aux(), rtol=1e-5)


def test_resnet_on_uneven_rows_matches_the_reference_and_one_device(ranks):
    start, final, losses, accs = _reference_resnet()
    _, ct = _resnet_configs()
    split = rank_bodies.resnet(0, 1, None, ct, _resnet_batches(), LR, "cpu",
                               _resnet_start_dict(), split=2)
    begin, want = _flat(start), _flat(final)
    for out in ranks.resnet:
        np.testing.assert_allclose(out["losses"], losses, rtol=1e-5)
        assert out["accuracies"] == accs
        model = resnet.ResNet(ct)
        model.load_state_dict({k: torch.from_numpy(v)
                               for k, v in out["final"].items()})
        got = _flat(resnet_variables(model))
        for k, w in want.items():
            base = np.asarray(begin[k], np.float64)
            np.testing.assert_allclose(np.asarray(got[k], np.float64) - base,
                                       np.asarray(w, np.float64) - base,
                                       atol=0.05 * LR, rtol=0, err_msg=k)
        for k, v in out["final"].items():
            np.testing.assert_allclose(v, split["final"][k], rtol=1e-6,
                                       atol=1e-7, err_msg=k)


@pytest.mark.parametrize("case", REFUSALS)
def test_what_the_reference_refuses_raises_before_any_collective(ranks,
                                                                 case):
    want = _reference_refusal(case)
    assert want is not None and want[0] == "ValueError", want
    for out in ranks.refusals[:3 if case == "placement" else 4]:
        (kind, message), calls = out[case]
        assert kind == "ValueError", message
        assert calls == 0
