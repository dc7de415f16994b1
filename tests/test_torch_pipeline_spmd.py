"""The port's SPMD pipeline (ray_tpu_torch/parallel/pipeline.py:
`pipeline_apply`, `pipeline_loss_dryrun`) against the JAX package's on
the same numpy inputs, on the CPU, f32.

JAX runs on the 8 virtual CPU devices of tests/conftest.py under
MeshConfig(data=2, stage=4); the port on one group of 8 gloo ranks
spawned by `run_ranks` for the module (rank r stands where JAX's device
r stands: data r // 4, stage r % 4), the reference's side computed while
the ranks run.  Held:

- `pipeline_apply` at tests/test_model_parallel.py:72's shapes (4
  stages of tanh(x @ w), 6 microbatches of 4 x 8): each rank's rows of
  the output within 1e-5 of the reference's and of the sequential
  product (the port's `pipeline_apply` with no mesh);
- `pipeline_loss_dryrun` at tests/test_pipeline_mpmd.py:92's shapes
  (tanh(x @ w + b), mean-square loss against tanh(x @ 0.1)): every
  rank's loss within 1e-5 relative of the reference's, of the port's
  MPMD pump (`PipelineTrainer(torch_stage_fns(...)).forward_only` on an
  in-process runtime) and of the sequential dryrun;
- the dryrun's gradients, of every stage's w and b and of the
  microbatches, within 1e-5 of `jax.grad` of the reference's dryrun
  (which equals the sequential gradient: the transpose of its `psum`
  hands the last stage the gradient of one loss).  The same run with
  the final all-reduce's backward summing too (`control=
  "sum_backward"`) must miss: it gives every stage n_stages times the
  gradient.
"""

import concurrent.futures
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import _PumpRuntime
from ray_tpu.parallel import (MeshConfig as JMeshConfig,
                              create_mesh as jcreate_mesh,
                              pipeline_apply as jpipeline_apply,
                              pipeline_loss_dryrun as jdryrun)
from ray_tpu_torch.parallel import (pipeline_apply, pipeline_loss_dryrun,
                                    rank_bodies)
from ray_tpu_torch.parallel.launch import run_ranks
from ray_tpu_torch.train import PipelineTrainer, torch_stage_fns

torch.set_num_threads(1)

RANK_TIMEOUT_S = 240
SIZES = dict(data=2, stage=4)
N_STAGES, N_MICRO, D = 4, 6, 8
TOL = 1e-5


def _jmesh():
    return jcreate_mesh(JMeshConfig(**SIZES), devices=jax.devices()[:8])


@functools.cache
def _apply_inputs():
    """tests/test_model_parallel.py:72's shapes: 4 stages of [8, 8] / 3,
    6 microbatches of 4 x 8."""
    rng = np.random.default_rng(3)
    ws = (rng.standard_normal((N_STAGES, D, D)) / 3).astype(np.float32)
    mb = rng.standard_normal((N_MICRO, 4, D)).astype(np.float32)
    return {"w": ws}, mb


@functools.cache
def _dryrun_inputs():
    """tests/test_pipeline_mpmd.py's mk_params / mk_data(0): w ~ N(0,
    0.3), b = 0, xs normal [4, 8], targets tanh(x @ ones * 0.1)."""
    rng = np.random.default_rng(0)
    params = [{"w": rng.normal(0, 0.3, (D, D)).astype(np.float32),
               "b": np.zeros(D, np.float32)} for _ in range(N_STAGES)]
    r = np.random.default_rng(1000)
    xs = [r.normal(size=(4, D)).astype(np.float32) for _ in range(N_MICRO)]
    ts = [np.tanh(x @ np.ones((D, D)) * 0.1).astype(np.float32)
          for x in xs]
    stacked = {k: np.stack([p[k] for p in params]) for k in ("w", "b")}
    return params, stacked, np.stack(xs), np.stack(ts)


def _jstage(p, x):
    y = x @ p["w"]
    return jnp.tanh(y + p["b"] if "b" in p else y)


def _jloss(y, t):
    return jnp.mean((y - t) ** 2)


def _tstage(p, x):
    y = x @ p["w"]
    return torch.tanh(y + p["b"] if "b" in p else y)


def _tloss(y, t):
    return ((y - t) ** 2).mean()


@functools.cache
def _reference_apply():
    stages, mb = _apply_inputs()
    return np.asarray(jpipeline_apply(
        _jstage, _jmesh(), {"w": jnp.asarray(stages["w"])}, jnp.asarray(mb)))


@functools.cache
def _reference_dryrun():
    """The reference's dryrun loss and `jax.grad` of it with respect to
    the stacked params and the microbatches."""
    _, stacked, xs, ts = _dryrun_inputs()
    mesh = _jmesh()

    def f(p, x):
        return jdryrun(_jstage, _jloss, mesh, p, x, jnp.asarray(ts))
    p = {k: jnp.asarray(v) for k, v in stacked.items()}
    loss = float(f(p, jnp.asarray(xs)))
    gp, gx = jax.grad(f, argnums=(0, 1))(p, jnp.asarray(xs))
    return loss, {k: np.asarray(v) for k, v in gp.items()}, np.asarray(gx)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    stages, mb = _apply_inputs()
    _, stacked, xs, ts = _dryrun_inputs()
    calls = [("pipeline", (SIZES, stages, mb)),
             ("pipeline", (SIZES, stacked, xs, ts)),
             ("pipeline", (SIZES, stacked, xs, ts, "sum_backward"))]
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        running = pool.submit(
            run_ranks, rank_bodies.sequence, 8, args=(calls,), device="cpu",
            init_dir=str(tmp_path_factory.mktemp("pipeline_spmd")),
            timeout_s=RANK_TIMEOUT_S)
        _reference_apply()
        _reference_dryrun()
        out = running.result()
    return types.SimpleNamespace(apply=[r[0] for r in out],
                                 dryrun=[r[1] for r in out],
                                 control=[r[2] for r in out])


def _rows(out):
    return slice(*out["rows"])


def test_pipeline_apply_matches_the_reference_and_the_sequential_product(
        ranks):
    stages, mb = _apply_inputs()
    want = _reference_apply()
    seq = pipeline_apply(_tstage, None, {"w": torch.from_numpy(stages["w"])},
                         torch.from_numpy(mb)).numpy()
    expect = mb
    for w in stages["w"]:
        expect = np.tanh(expect @ w)
    np.testing.assert_allclose(seq, expect, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(want, expect, atol=TOL, rtol=TOL)
    for rank, out in enumerate(ranks.apply):
        assert out["coordinate"]["data"] == rank // 4
        assert out["coordinate"]["stage"] == rank % 4
        np.testing.assert_allclose(out["out"], want[:, _rows(out)],
                                   atol=TOL, rtol=TOL)


def test_dryrun_loss_matches_the_reference_and_the_mpmd_pump(ranks):
    params, stacked, xs, ts = _dryrun_inputs()
    want, _, _ = _reference_dryrun()
    trainer = PipelineTrainer(torch_stage_fns(_tstage, _tloss, device="cpu"),
                              params, runtime=_PumpRuntime(),
                              n_microbatches=N_MICRO)
    try:
        mpmd = trainer.forward_only(list(xs), list(ts))
    finally:
        trainer.shutdown()
    seq = float(pipeline_loss_dryrun(
        _tstage, _tloss, None, {k: torch.from_numpy(v)
                                for k, v in stacked.items()},
        torch.from_numpy(xs), torch.from_numpy(ts)))
    for got in [out["loss"] for out in ranks.dryrun] + [mpmd, seq]:
        assert got == pytest.approx(want, rel=TOL)


def _assert_gradients_match(outs, grads, dx):
    for out in outs:
        stage = out["coordinate"]["stage"]
        for k, g in out["grads"].items():
            np.testing.assert_allclose(g, grads[k][stage], atol=TOL,
                                       rtol=TOL, err_msg=k)
        np.testing.assert_allclose(out["dmicrobatches"], dx[:, _rows(out)],
                                   atol=TOL, rtol=TOL)


def test_dryrun_gradients_match_jax_grad(ranks):
    _, grads, dx = _reference_dryrun()
    _assert_gradients_match(ranks.dryrun, grads, dx)
    # An all-reduce whose backward sums as well hands every stage
    # n_stages times the gradient: the check must catch it.
    with pytest.raises(AssertionError):
        _assert_gradients_match(ranks.control, grads, dx)
    for out, sound in zip(ranks.control, ranks.dryrun):
        np.testing.assert_allclose(out["grads"]["w"],
                                   N_STAGES * sound["grads"]["w"],
                                   rtol=1e-4, atol=1e-6)


def test_a_stack_that_is_neither_whole_nor_a_slice_raises():
    from ray_tpu_torch.parallel.pipeline import _own_stage

    stack = {"w": torch.zeros(3, 2, 2)}
    assert _own_stage(stack, 2, 3)["w"].shape == (2, 2)
    assert _own_stage({"w": torch.zeros(1, 2, 2)}, 2, 3)["w"].shape == (2, 2)
    with pytest.raises(ValueError, match="leading dim of 3"):
        _own_stage(stack, 1, 4)
