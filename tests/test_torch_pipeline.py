"""The port's MPMD pipeline (ray_tpu_torch/train/pipeline_{trainer,stage}.py
and ray_tpu_torch/parallel/) against the JAX package's, on the CPU.

- `torch_stage_fns` against `jax_stage_fns` (the tanh MLP of
  tests/test_pipeline_mpmd.py and gpt nano blocks, f32), and the
  reference's `PipelineTrainer` running the torch quartet;
- the port's `PipelineTrainer(runtime=ray_tpu)` on the reference tests'
  numpy quartet, loss for loss against the reference's pump, and every
  interleave / prefetch / backpressure combination against v=1 with the
  torch quartet on tensor params;
- gpt nano (untied) in four chunks against the reference's
  single-program `gpt.loss_fn` step on the same weights;
- a stage killed through the runtime (surgical replay from the port's
  checkpoints), a failing op (global rollback), the placement group of
  a gang whose setup fails, and the placement helpers over a grid.

Stage workers run on one module-scoped cluster.  Every stage function
below is built inside a function, so cloudpickle ships it by value and
the workers never import this module (or JAX) for it; the numpy quartet
is the reference test's own.
"""

import functools
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_tpu
from ray_tpu.models import gpt as jgpt
from ray_tpu.parallel import mesh as jmesh
from ray_tpu.parallel import pipeline as jpipeline
from ray_tpu.train import PipelineTrainer as RefTrainer
from ray_tpu.train import jax_stage_fns
from ray_tpu_torch.checkpoint import CheckpointManager
from ray_tpu_torch.models import gpt
from ray_tpu_torch.models.convert import params_from_numpy
from ray_tpu_torch.ops.cross_entropy import fused_cross_entropy
from ray_tpu_torch.parallel import (chunk_assignment, dcn_cut_edges,
                                    pipeline_placement_resources,
                                    stack_stage_params, stage_slice_plan)
from ray_tpu_torch.train import PipelineTrainer, StageGroup, torch_stage_fns
from ray_tpu_torch.util.observe import Observer
from tests.test_pipeline_mpmd import (N_MICRO, N_STAGES, NP_FNS, mk_data,
                                      mk_params, np_loss_bwd, np_loss_fwd,
                                      np_stage_bwd, np_stage_fwd)

torch.set_num_threads(1)

LR = 0.1
# f32 on both sides, sums in other orders (XLA's and torch's CPU
# kernels): every compared value within F32_TOL of its array's largest.
F32_TOL = 2e-5
# Nano untied, the same weights in both packages, 3 SGD steps: the
# losses within 1e-5 relative, each leaf's update within 1e-4 of its
# largest (the per-microbatch gradients are summed, the reference takes
# one gradient of the batch).
GPT_LOSS_TOL, GPT_UPDATE_TOL = 1e-5, 1e-4


@pytest.fixture(scope="module")
def pp_cluster():
    info = ray_tpu.init(num_cpus=8, object_store_memory=256 << 20)
    try:
        yield info
    finally:
        ray_tpu.shutdown()


def _close(got, want, tol=F32_TOL, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, f"{what}: {got.shape} != {want.shape}"
    err = float(np.abs(got - want).max()) if got.size else 0.0
    scale = float(np.abs(want).max()) if want.size else 0.0
    assert err <= tol * scale + 1e-7, f"{what}: {err} vs max {scale}"


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in tree:
            yield from _leaves(tree[k], f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}{i}/")
    else:
        yield prefix, tree


def _np(tree):
    return {k: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                else np.asarray(v)) for k, v in _leaves(tree)}


def _f32(params):
    return [{k: v.astype(np.float32) for k, v in p.items()} for p in params]


def _tensors(params):
    return [{k: torch.from_numpy(v) for k, v in p.items()} for p in params]


class Recorder(Observer):
    """Counts the driver's counter increments by name; the stage workers
    get a plain Observer (this class pickles to one)."""

    def __init__(self):
        self.counts = {}

    def inc(self, name, n=1.0):
        self.counts[name] = self.counts.get(name, 0) + n

    def __reduce__(self):
        return (Observer, ())


# ---------------------------------------------------------------------------
# stage functions (built in functions: shipped by value)
# ---------------------------------------------------------------------------

def tanh_fns(device="cpu"):
    def stage_fn(p, x):
        return torch.tanh(x @ p["w"] + p["b"])

    def loss_fn(y, t):
        return ((y - t) ** 2).mean()
    return torch_stage_fns(stage_fn, loss_fn, device=device)


def jax_tanh_fns():
    def stage_fn(p, x):
        return jnp.tanh(x @ p["w"] + p["b"])

    def loss_fn(y, t):
        return jnp.mean((y - t) ** 2)
    return jax_stage_fns(stage_fn, loss_fn)


NANO = dict(vocab_size=512, n_layers=2, d_model=64, n_heads=4, d_ff=128,
            max_seq_len=128, tie_embeddings=False)
CFG_J = jgpt.GPTConfig(dtype=jnp.float32, **NANO)
CFG_T = gpt.GPTConfig(dtype=torch.float32, **NANO)
# Four chunks of the 2-layer nano: the embeddings; block 0; block 1; the
# final LayerNorm and the head.
BOUNDS = ((0, 0), (0, 1), (1, 2), (2, 2))


def gpt_chunk_params(params, bounds=BOUNDS):
    last = len(bounds) - 1
    chunks = []
    for c, (lo, hi) in enumerate(bounds):
        p = {}
        if c == 0:
            p["tok_embed"], p["pos_embed"] = (params["tok_embed"],
                                              params["pos_embed"])
        if hi > lo:
            p["blocks"] = {k: v[lo:hi] for k, v in params["blocks"].items()}
        if c == last:
            p.update(final_ln_scale=params["final_ln_scale"],
                     final_ln_bias=params["final_ln_bias"],
                     lm_head=params["lm_head"])
        chunks.append(p)
    return chunks


def gpt_fns(config, device="cpu"):
    """The four-chunk gpt's quartet (chip_smoke.py's, at nano): embed or
    cast back to the activation dtype, the chunk's blocks, and on the
    last chunk (final LayerNorm output, head) into the fused loss on the
    rolled tokens with the last position masked."""
    c = config

    def stage_fn(p, x):
        if "tok_embed" in p:
            x = p["tok_embed"][x.long()].to(c.dtype) + \
                p["pos_embed"][:x.shape[1]][None].to(c.dtype)
        else:
            x = x.to(c.dtype)
        if "blocks" in p:
            layers = {k: v.unbind(0) for k, v in p["blocks"].items()}
            for i in range(len(layers["wq"])):
                x, _ = gpt._block(x, {k: v[i] for k, v in layers.items()},
                                  c)
        if "lm_head" in p:
            return (gpt._layernorm(x, p["final_ln_scale"],
                                   p["final_ln_bias"]),
                    p["lm_head"].to(c.dtype))
        return x

    def loss_fn(y, tokens):
        x, head = y
        targets = torch.roll(tokens, -1, dims=1)
        valid = torch.ones(tokens.shape, dtype=torch.float32)
        valid[:, -1] = 0.0
        b, l, d = x.shape
        return fused_cross_entropy(x.reshape(b * l, d), head,
                                   targets.reshape(-1), valid.reshape(-1))
    return torch_stage_fns(stage_fn, loss_fn, device=device)


def nano_blocks_fns():
    """Two nano blocks as one chunk, with a mean-square loss: (torch
    quartet, jax quartet)."""
    def t_stage(p, x):
        layers = {k: v.unbind(0) for k, v in p.items()}
        for i in range(len(layers["wq"])):
            x, _ = gpt._block(x, {k: v[i] for k, v in layers.items()}, CFG_T)
        return x

    def t_loss(y, t):
        return ((y - t) ** 2).mean()

    def j_stage(p, x):
        for i in range(CFG_J.n_layers):
            x, _ = jgpt._block(x, {k: v[i] for k, v in p.items()}, CFG_J,
                               None)
        return x

    def j_loss(y, t):
        return jnp.mean((y - t) ** 2)
    return (torch_stage_fns(t_stage, t_loss, device="cpu"),
            jax_stage_fns(j_stage, j_loss))


def _nano_params(seed=0):
    return jax.tree.map(np.asarray, jgpt.init_params(CFG_J,
                                                     jax.random.key(seed)))


def _tokens_data(n_micro=2, b=2, l=64):
    def data_fn(step):
        rng = np.random.default_rng(500 + step)
        xs = [rng.integers(0, CFG_T.vocab_size, (b, l)).astype(np.int32)
              for _ in range(n_micro)]
        return xs, xs
    return data_fn


# ---------------------------------------------------------------------------
# no cluster
# ---------------------------------------------------------------------------

def test_placement_helpers_equal_the_references():
    def same(port, ref, *args):
        try:
            want = ref(*args)
        except ValueError:
            with pytest.raises(ValueError):
                port(*args)
            return
        assert port(*args) == want, args

    for n_chunks in range(0, 9):
        for n_gangs in range(-1, 9):
            same(chunk_assignment, jpipeline.chunk_assignment, n_chunks,
                 n_gangs)
    for n_gangs in range(0, 9):
        for n_slices in range(-1, 9):
            same(stage_slice_plan, jmesh.stage_slice_plan, n_gangs,
                 n_slices)
    for plan in ([0], [0, 0, 1, 1], [0, 1, 0, 1], [0, 0, 0, 1, 1, 1],
                 [2, 1, 0]):
        for n_chunks in range(0, 9):
            same(dcn_cut_edges, jmesh.dcn_cut_edges, plan, n_chunks)
        same(pipeline_placement_resources,
             jmesh.pipeline_placement_resources, plan)
        assert pipeline_placement_resources(plan, "s") == \
            jmesh.pipeline_placement_resources(plan, "s")


def test_stack_stage_params_equals_the_references():
    params = _f32(mk_params())
    got = stack_stage_params(_tensors(params))
    want = jpipeline.stack_stage_params(
        [{k: jnp.asarray(v) for k, v in p.items()} for p in params])
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_torch_stage_fns_defaults_to_the_card():
    if torch.cuda.is_available():
        torch_stage_fns(lambda p, x: x, lambda y, t: y.sum())
        return
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        torch_stage_fns(lambda p, x: x, lambda y, t: y.sum())


def _run_quartet(fns, params, x, t):
    fwd, bwd, loss_fwd, loss_bwd = fns
    y, cache = fwd(params, x)
    loss, lcache = loss_fwd(y, t)
    gy = loss_bwd(lcache)
    gx, gparams = bwd(params, cache, gy)
    return dict(y=y, loss=loss, gy=gy, gx=gx, gparams=gparams)


def _check_quartets(got, want):
    _close(got["y"], want["y"], what="y")
    assert abs(got["loss"] - want["loss"]) <= F32_TOL * abs(want["loss"])
    _close(got["gy"], want["gy"], what="gy")
    _close(got["gx"], want["gx"], what="gx")
    for k, v in _np(want["gparams"]).items():
        _close(_np(got["gparams"])[k], v, what=f"gparams {k}")


def test_quartet_matches_jax_on_the_tanh_mlp():
    params = _f32(mk_params())[1]
    xs, ts = mk_data(0)
    x, t = xs[0].astype(np.float32), ts[0].astype(np.float32)
    want = _run_quartet(jax_tanh_fns(), params, x, t)
    got = _run_quartet(tanh_fns(), params, x, t)
    assert isinstance(got["y"], np.ndarray)
    assert all(isinstance(v, np.ndarray) for v in got["gparams"].values())
    _check_quartets(got, want)
    # Tensor params keep everything a tensor, with the same values.
    on_device = _run_quartet(tanh_fns(), _tensors([params])[0],
                             torch.from_numpy(x), t)
    assert isinstance(on_device["y"], torch.Tensor)
    assert isinstance(on_device["gparams"]["w"], torch.Tensor)
    np.testing.assert_array_equal(on_device["gx"].numpy(), got["gx"])
    np.testing.assert_array_equal(on_device["gparams"]["w"].numpy(),
                                  got["gparams"]["w"])


def test_quartet_matches_jax_on_gpt_nano_blocks():
    blocks = _nano_params()["blocks"]
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 32, CFG_T.d_model)).astype(np.float32)
    t = rng.normal(size=x.shape).astype(np.float32)
    t_fns, j_fns = nano_blocks_fns()
    want = _run_quartet(j_fns, blocks, x, t)
    got = _run_quartet(t_fns, blocks, x, t)
    assert set(got["gparams"]) == set(blocks)
    _check_quartets(got, want)


def test_a_pair_output_crosses_the_torch_quartet_not_the_references():
    """A last chunk may hand the loss a pytree, as the four-chunk gpt
    hands it (hidden, head): the torch quartet returns the pair and the
    gradients of both its leaves.  The reference's `jax_stage_fns` turns
    every output into one numpy array and raises on a pair of unequal
    shapes (ROADMAP, Queue C)."""
    rng = np.random.default_rng(4)
    params = {"w": rng.normal(size=(3, 5)).astype(np.float32),
              "head": rng.normal(size=(5, 2)).astype(np.float32)}
    x = rng.normal(size=(4, 3)).astype(np.float32)
    t = rng.normal(size=(4, 2)).astype(np.float32)

    def t_stage(p, x):
        return torch.tanh(x @ p["w"]), p["head"] * 1.0

    def t_loss(y, t):
        h, head = y
        return ((h @ head - t) ** 2).mean()

    got = _run_quartet(torch_stage_fns(t_stage, t_loss, device="cpu"),
                       params, x, t)
    assert [a.shape for a in got["y"]] == [(4, 5), (5, 2)]
    assert [a.shape for a in got["gy"]] == [(4, 5), (5, 2)]

    def j_stage(p, x):
        return jnp.tanh(x @ p["w"]), p["head"] * 1.0

    def j_loss(y, t):
        h, head = y
        return jnp.mean((h @ head - t) ** 2)

    loss, (gp, gx) = jax.value_and_grad(
        lambda p, x: j_loss(j_stage(p, x), t), argnums=(0, 1))(params, x)
    assert abs(got["loss"] - float(loss)) <= F32_TOL * abs(float(loss))
    _close(got["gx"], gx, what="gx")
    for k in params:
        _close(got["gparams"][k], gp[k], what=f"gparams {k}")
    with pytest.raises(ValueError, match="inhomogeneous"):
        jax_stage_fns(j_stage, j_loss)[0](params, x)


# ---------------------------------------------------------------------------
# stage workers (one cluster)
# ---------------------------------------------------------------------------

def test_reference_pump_runs_the_torch_quartet(pp_cluster):
    """The reference's PipelineTrainer with `torch_stage_fns` (numpy
    params, so every output is numpy) gives `jax_stage_fns`' losses."""
    params = _f32(mk_params())
    xs, ts = mk_data(0)
    xs = [x.astype(np.float32) for x in xs]
    ts = [t.astype(np.float32) for t in ts]

    def data_fn(step):
        a, b = mk_data(step)
        return ([x.astype(np.float32) for x in a],
                [t.astype(np.float32) for t in b])

    out = {}
    for name, fns in (("jax", jax_tanh_fns()), ("torch", tanh_fns())):
        tr = RefTrainer(fns, params, lr=LR, n_microbatches=N_MICRO)
        try:
            out[name] = [tr.forward_only(xs, ts)] + [
                h["loss"] for h in tr.fit(data_fn, 3)]
        finally:
            tr.shutdown()
    for got, want in zip(out["torch"], out["jax"]):
        assert abs(got - want) <= F32_TOL * abs(want), out
    assert out["torch"][-1] < out["torch"][1]


@functools.cache
def _port_losses(schedule="1f1b", queue_depth=2):
    """The numpy quartet through the port's pump, 3 steps (shared by the
    tests that compare a disturbed run with an uninterrupted one)."""
    tr = PipelineTrainer(NP_FNS, mk_params(), runtime=ray_tpu, lr=LR,
                         n_microbatches=N_MICRO, schedule=schedule,
                         queue_depth=queue_depth)
    try:
        return tuple(h["loss"] for h in tr.fit(mk_data, 3))
    finally:
        tr.shutdown()


@pytest.mark.parametrize("schedule,queue_depth", [
    ("1f1b", 2), ("gpipe", 2), ("1f1b", 1)])
def test_port_pump_equals_the_reference_pump(pp_cluster, schedule,
                                             queue_depth):
    """The numpy quartet through both pumps: the same losses, bit for
    bit (the shape of test_pipeline_mpmd.py's schedule test)."""
    tr = RefTrainer(NP_FNS, mk_params(), lr=LR, n_microbatches=N_MICRO,
                    schedule=schedule, queue_depth=queue_depth)
    try:
        ref = tuple(h["loss"] for h in tr.fit(mk_data, 3))
    finally:
        tr.shutdown()
    port = _port_losses(schedule, queue_depth)
    assert port == ref
    assert port[-1] < port[0]


def test_interleave_prefetch_backpressure_bit_identical(pp_cluster):
    """Every (schedule, interleave, prefetch, backpressure) combination
    gives the v=1 trajectory bit for bit, with the torch quartet on
    tensor params (updated in place in the workers); the receive window
    is hit and stays within its bound (test_pipeline_mpmd.py's
    interleave test, through the port)."""
    losses, stats = {}, {}
    for key, kw in (
            ("base", dict(schedule="1f1b")),
            ("v2_1f1b", dict(schedule="1f1b", interleave=2,
                             prefetch=True)),
            ("v2_gpipe", dict(schedule="gpipe", interleave=2,
                              prefetch=True)),
            ("v1_prepush", dict(schedule="1f1b", prefetch=True)),
            ("v2_tight", dict(schedule="1f1b", interleave=2,
                              prefetch=True, queue_depth=1,
                              recv_window=1)),
    ):
        tr = PipelineTrainer(tanh_fns(), _tensors(mk_params()),
                             runtime=ray_tpu, lr=LR,
                             n_microbatches=N_MICRO, **kw)
        try:
            if kw.get("interleave"):
                assert tr._assignment == chunk_assignment(
                    N_STAGES, N_STAGES // kw["interleave"])
            losses[key] = [h["loss"] for h in tr.fit(mk_data, 3)]
            stats[key] = [m for gang in tr.stage_stats() for m in gang]
        finally:
            tr.shutdown()
    for key in losses:
        assert losses[key] == losses["base"], (key, losses)
    assert losses["base"][-1] < losses["base"][0]
    for key, window in (("v2_1f1b", 2), ("v1_prepush", 2),
                        ("v2_tight", 1)):
        assert sum(m["recv_hits"] for m in stats[key]) > 0, key
        assert max(m["recv_peak"] for m in stats[key]) <= window + 1, key
    assert all(m["recv_hits"] == 0 and m["recv_peak"] == 0
               for m in stats["base"])


def test_gpt_nano_in_four_chunks_matches_the_single_program_step(
        pp_cluster, tmp_path):
    """gpt nano (untied, f32) in four chunks through the port's pump, 2
    microbatches a step, against the reference's single-program
    `gpt.loss_fn` gradient over the whole batch with the same SGD, on
    weights carried over by convert.params_from_numpy: every loss, and
    every leaf after 3 steps (read back from the gangs' checkpoints)."""
    ref_params = _nano_params(1)
    port = params_from_numpy(ref_params, CFG_T, device="cpu")
    data_fn = _tokens_data()
    tr = PipelineTrainer(gpt_fns(CFG_T), gpt_chunk_params(port),
                         runtime=ray_tpu, lr=LR, n_microbatches=2,
                         storage_path=str(tmp_path))
    try:
        losses = [h["loss"] for h in tr.fit(data_fn, 3)]
        groups = len(tr.groups)
    finally:
        tr.shutdown()
    final = []
    for g in range(groups):
        tree = CheckpointManager(str(tmp_path / f"stage_{g:02d}")).restore(
            device="cpu")
        assert tree["version"] == 3
        final.append(tree["params"][str(g)])

    grad = jax.jit(jax.value_and_grad(
        lambda p, tok: jgpt.loss_fn(p, {"tokens": tok}, CFG_J)))
    p = ref_params
    want = []
    for step in range(3):
        xs, _ = data_fn(step)
        loss, g = grad(p, jnp.asarray(np.concatenate(xs)))
        want.append(float(loss))
        p = jax.tree.map(lambda a, b: np.asarray(a - LR * b), p, g)
    for got, w in zip(losses, want):
        assert abs(got - w) <= GPT_LOSS_TOL * abs(w), (losses, want)
    start = dict(_leaves(gpt_chunk_params(ref_params)))
    ref_final = dict(_leaves(gpt_chunk_params(p)))
    got_final = _np(final)
    for k, w in ref_final.items():
        d_want = np.asarray(w, np.float64) - start[k]
        d_got = got_final[k] - start[k]
        _close(d_got, d_want, GPT_UPDATE_TOL, what=f"update of {k}")


class _KillingRuntime:
    """`ray_tpu` with one chaos hook: before an actor call, `when(ordinal,
    method, args)` (ordinal: the actor's creation order, from 1) may kill
    that actor through `ray_tpu.kill`, so the call lands on a dead actor
    as it would after a worker crash."""

    def __init__(self, when):
        self.when = when
        self.created = 0
        self.kills = []

    def __getattr__(self, name):
        return getattr(ray_tpu, name)

    def kill(self, actor):
        ray_tpu.kill(getattr(actor, "handle", actor))

    def remote(self, **opts):
        rt = self

        def bind(cls):
            return _KillingRuntime.Class(rt, ray_tpu.remote(**opts)(cls))
        return bind

    class Class:
        def __init__(self, rt, cls):
            self.rt, self.cls = rt, cls

        def options(self, **opts):
            return _KillingRuntime.Class(self.rt, self.cls.options(**opts))

        def remote(self, *args, **kwargs):
            self.rt.created += 1
            return _KillingRuntime.Actor(self.rt, self.cls.remote(
                *args, **kwargs), self.rt.created)

    class Actor:
        def __init__(self, rt, handle, ordinal):
            self.rt, self.handle, self.ordinal = rt, handle, ordinal

        def __getattr__(self, name):
            if name.startswith("_"):
                raise AttributeError(name)
            return _KillingRuntime.Method(self, name, 1)

    class Method:
        def __init__(self, actor, name, num_returns):
            self.actor, self.name, self.n = actor, name, num_returns

        def options(self, num_returns=1, **_):
            return _KillingRuntime.Method(self.actor, self.name, num_returns)

        def remote(self, *args):
            a = self.actor
            if a.rt.when(a.ordinal, self.name, args):
                a.rt.kills.append((a.ordinal, self.name, args[:3]))
                ray_tpu.kill(a.handle)
                time.sleep(0.5)             # let the death land first
            return getattr(a.handle, self.name).options(
                num_returns=self.n).remote(*args)




def test_stage_kill_replays_surgically_loss_exact(pp_cluster, tmp_path):
    """Gang 1 is killed as its backward for microbatch 2 of step 1 is
    sent: only that gang re-forms, restores step 1 from its committed
    checkpoint and replays the step's microbatches; the survivors keep
    their pids and run exactly the clean op count; the losses equal an
    uninterrupted run's (test_pipeline_mpmd.py's stage-kill gate, through
    the port's pump and checkpoints)."""
    rt = _KillingRuntime(lambda ordinal, name, args: (
        ordinal == 2 and name == "backward" and args[0] == 1
        and args[2] == 2))
    obs = Recorder()
    tr = PipelineTrainer(NP_FNS, mk_params(), runtime=rt, lr=LR,
                         n_microbatches=N_MICRO,
                         storage_path=str(tmp_path / "chaos"),
                         ckpt_every=1, stage_timeout_s=15.0, observer=obs)
    try:
        before = tr.stage_idents()
        chaos = tuple(h["loss"] for h in tr.fit(mk_data, 3))
        after = tr.stage_idents()
        stats = {s["stage"]: s for s in ray_tpu.get(
            [g.members[0].stats.remote() for g in tr.groups], timeout=30)}
        recoveries = tr._recoveries
    finally:
        tr.shutdown()
    assert rt.kills == [(2, "backward", (1, 1, 2))]
    assert recoveries == 1
    assert obs.counts == {"pp_recoveries{kind=replay}": 1}
    assert after[1][0]["pid"] != before[1][0]["pid"]
    clean_ops = 3 * (2 * N_MICRO + 2)
    for g in (0, 2, 3):
        assert after[g][0]["pid"] == before[g][0]["pid"]
        assert stats[g]["ops"] == clean_ops, (g, stats[g])
    assert chaos == _port_losses()


def failing_once_fns(marker: str):
    """NP_FNS whose forward raises once, in whichever worker first finds
    `marker` (and removes it)."""
    def stage_fwd(params, x):
        try:
            os.remove(marker)
        except FileNotFoundError:
            return np_stage_fwd(params, x)
        raise RuntimeError("injected stage failure")
    return stage_fwd, np_stage_bwd, np_loss_fwd, np_loss_bwd


def test_failing_op_rolls_back_to_the_committed_step(pp_cluster, tmp_path):
    """An op that raises while every gang answers leaves no gang to
    re-form: the pump rolls every gang back to the newest step all have
    committed (loaded in place) and re-runs it; the losses equal an
    uninterrupted run's."""
    marker = str(tmp_path / "fail")
    armed = []

    def data_fn(step):
        if step == 2 and not armed:
            armed.append(step)
            open(marker, "w").close()
        return mk_data(step)

    obs = Recorder()
    tr = PipelineTrainer(failing_once_fns(marker), mk_params(),
                         runtime=ray_tpu, lr=LR, n_microbatches=N_MICRO,
                         storage_path=str(tmp_path / "chaos"),
                         ckpt_every=1, observer=obs)
    try:
        before = tr.stage_idents()
        chaos = tuple(h["loss"] for h in tr.fit(data_fn, 3))
        after = tr.stage_idents()
        recoveries = tr._recoveries
    finally:
        tr.shutdown()
    assert not os.path.exists(marker)
    assert recoveries == 1
    assert obs.counts == {"pp_recoveries{kind=rollback}": 1}
    assert [i[0]["pid"] for i in after] == [i[0]["pid"] for i in before]
    assert chaos == _port_losses()


def test_stage_group_pg_cleanup_on_setup_failure(pp_cluster):
    """A spec that makes setup() raise must not leave the gang's
    placement group reserved.  The earlier tests' gangs release their
    CPUs asynchronously, so first wait for the whole cluster to be
    free."""
    base = ray_tpu.cluster_resources()["CPU"]
    _wait_for_cpus(base)
    spec = {"stage": 0, "n_stages": 1, "stage_fwd": np_stage_fwd,
            "stage_bwd": np_stage_bwd, "loss_fwd": np_loss_fwd,
            "loss_bwd": np_loss_bwd, "params": mk_params(1)[0],
            "lr": "not-a-float"}
    with pytest.raises(Exception):
        StageGroup(0, spec, 2, {"CPU": 1}, runtime=ray_tpu)
    assert _wait_for_cpus(base), "StageGroup leaked its placement group"


def _wait_for_cpus(n, timeout=30.0) -> bool:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if ray_tpu.available_resources().get("CPU", 0.0) == n:
            return True
        time.sleep(0.1)
    return False
