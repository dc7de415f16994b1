"""The port's training fabric under the reference's trainer, on the CPU:
`ray_tpu.train.DataParallelTrainer` with the port's
`CudaConfig(device="cpu")` (a gloo group) and 2 workers.

- the group forms on every rank and `dist.all_reduce` agrees;
- a data-parallel `nano` GPT loop (gradients all-reduced by the loop) is
  fed by the port's `iter_device_batches` over
  `session.get_dataset_shard("train")` and saves every 4 steps with the
  port's CheckpointManager under the run's checkpoint root; a failure
  injected on every rank at step 6 makes the trainer restart the gang,
  find the port's latest committed save (step 4) and hand it back, and
  the loop resumes from it; every loss, before and after the restart,
  equals an uninterrupted run's in this process bit for bit (one CPU
  thread on both sides; the all-reduce of two ranks sums one pair).
"""

import types

import jax
import numpy as np
import pytest
import torch

import ray_tpu
from ray_tpu import data as rd
from ray_tpu.air import FailureConfig, RunConfig, ScalingConfig
from ray_tpu.models import gpt as jgpt
from ray_tpu.train import DataParallelTrainer
from ray_tpu_torch.models import gpt
from ray_tpu_torch.models._functional import _leaves, adamw
from ray_tpu_torch.models.convert import params_from_numpy
from ray_tpu_torch.train import CudaBackend, CudaConfig

torch.set_num_threads(1)

WORKERS, BATCH, SEQ, STEPS, SAVE_EVERY, FAIL_AT = 2, 2, 32, 8, 4, 6
LR = 1e-3


@pytest.fixture(scope="module")
def cluster():
    info = ray_tpu.init(num_cpus=8, object_store_memory=64 << 20)
    yield info
    ray_tpu.shutdown()


def _trainer(loop, tmp_path=None, **kw):
    run = RunConfig(name="fabric", storage_path=str(tmp_path),
                    failure_config=FailureConfig(max_failures=1)) \
        if tmp_path is not None else None
    return DataParallelTrainer(
        loop, backend_config=CudaConfig(device="cpu"),
        scaling_config=ScalingConfig(num_workers=WORKERS), run_config=run,
        **kw)


def test_group_forms_and_all_reduce_agrees(cluster):
    def loop():
        import torch
        import torch.distributed as dist

        from ray_tpu.train import session

        t = torch.tensor([float(dist.get_rank() + 1)])
        dist.all_reduce(t)
        session.report({"sum": float(t), "world": dist.get_world_size(),
                        "rank": dist.get_rank(),
                        "context_rank": session.get_world_rank()})

    result = _trainer(loop).fit()
    assert result.error is None
    assert result.metrics == {"sum": 3.0, "world": 2, "rank": 0,
                              "context_rank": 0}


def _dp_step(state, shard_batches, config, world_all_reduce=None):
    """One data-parallel AdamW step.  In a worker, `world_all_reduce`
    sums across the ranks; in this process the shards' backward passes
    accumulate the same sum into .grad."""
    params, opt = state["params"], state["opt_state"]
    opt.zero_grad(set_to_none=True)
    losses = []
    for batch in shard_batches:
        loss = gpt.loss_fn(params, {"tokens": batch}, config)
        loss.backward()
        losses.append(loss.detach())
    loss = torch.stack(losses).sum()
    if world_all_reduce is not None:
        for p in _leaves(params):
            world_all_reduce(p.grad)
        world_all_reduce(loss)
    for p in _leaves(params):
        p.grad /= WORKERS
    opt.step()
    state["step"] += 1
    return float(loss / WORKERS)


def test_fed_loop_resumes_from_the_ports_checkpoint(cluster, tmp_path):
    np_params = jax.tree.map(np.asarray, jgpt.init_params(
        jgpt.CONFIGS["nano"], jax.random.key(0)))
    tokens = np.random.default_rng(1).integers(
        0, 512, (WORKERS * STEPS * BATCH, SEQ)).astype(np.int32)
    step_fn = _dp_step

    def loop(config):
        import torch
        import torch.distributed as dist

        from ray_tpu.train import session
        from ray_tpu_torch.checkpoint import CheckpointManager
        from ray_tpu_torch.data import iter_device_batches
        from ray_tpu_torch.models import gpt
        from ray_tpu_torch.models._functional import adamw
        from ray_tpu_torch.models.convert import (params_from_numpy,
                                                  train_state_from_numpy,
                                                  train_state_to_tree)

        torch.set_num_threads(1)
        ctx = session.get_context()
        cfg = gpt.CONFIGS["nano"]
        mgr = CheckpointManager(ctx.checkpoint_root,
                                save_id=f"i{ctx.restart_count}")
        init_state, _ = gpt.make_train_step(cfg, adamw(config["lr"]),
                                            device="cpu")
        if session.get_checkpoint() is None:
            state = init_state(params=params_from_numpy(
                config["params"], cfg, device="cpu"))
        else:
            state = train_state_from_numpy(mgr.restore_latest(device="cpu"),
                                           cfg, adamw(config["lr"]),
                                           device="cpu")
        start = state["step"]
        feed = iter_device_batches(session.get_dataset_shard("train"),
                                   device="cpu", batch_size=config["batch"],
                                   drop_last=True)
        for i, batch in enumerate(feed):
            if i < start:
                continue
            if ctx.restart_count == 0 and i == config["fail_at"]:
                mgr.wait_until_finished()    # the save of step 4 commits
                # Once every rank's part of it is written: a rank that
                # raised first would have its peers torn down mid-write.
                dist.barrier()
                raise RuntimeError("injected failure")
            loss = config["step_fn"](state, [batch["tokens"]], cfg,
                                     dist.all_reduce)
            if state["step"] % config["save_every"] == 0:
                mgr.save(state["step"], train_state_to_tree(state))
            session.report({"step": i, "loss": loss, "resumed_from": start,
                            "restart": ctx.restart_count})
        mgr.wait_until_finished()

    ds = rd.from_numpy(tokens, column="tokens")
    result = _trainer(
        loop, tmp_path, datasets={"train": ds},
        train_loop_config={"params": np_params, "lr": LR, "batch": BATCH,
                           "save_every": SAVE_EVERY, "fail_at": FAIL_AT,
                           "step_fn": step_fn}).fit()
    assert result.error is None
    history = [(m["restart"], m["step"], m["resumed_from"], m["loss"])
               for m in result.metrics_history]
    assert [h[:3] for h in history] == \
        [(0, i, 0) for i in range(FAIL_AT)] + \
        [(1, i, 4) for i in range(4, STEPS)]

    # The uninterrupted run, in this process: worker r's rows are the
    # r-th equal slice of the dataset, in order.
    cfg = gpt.CONFIGS["nano"]
    init_state, _ = gpt.make_train_step(cfg, adamw(LR), device="cpu")
    state = init_state(params=params_from_numpy(np_params, cfg,
                                                device="cpu"))
    shards = torch.from_numpy(tokens).view(WORKERS, STEPS, BATCH, SEQ)
    want = [_dp_step(state, list(shards[:, i]), cfg) for i in range(STEPS)]
    for restart, step, _, loss in history:
        assert loss == want[step], (restart, step, loss, want[step])
    root = tmp_path / "fabric"
    assert sorted(p.name for p in root.iterdir()) == [
        "checkpoint_000004", "checkpoint_000008"]
    assert sorted(p.name for p in (root / "checkpoint_000008").iterdir()
                  if p.name.startswith("DONE")) == ["DONE.0.i1", "DONE.1.i1"]


class _LocalGroup:
    """A worker group of one, run in this process."""

    def __init__(self):
        import os
        self.workers = [types.SimpleNamespace(pid=os.getpid())]

    def execute(self, fn, *args):
        return [fn(*args)]

    def execute_single(self, rank, fn, *args):
        return fn(*args)

    def local_ranks(self):
        return [(0, 1)]


def test_backend_needs_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        CudaBackend().on_start(_LocalGroup(), CudaConfig())


def test_backend_forms_a_one_rank_gloo_group_in_process():
    group = _LocalGroup()
    backend = CudaConfig(device="cpu").backend_cls()()
    infos = backend.on_start(group, CudaConfig(device="cpu"))
    try:
        assert infos == [{"rank": 0, "world_size": 1, "device": "cpu"}]
        t = torch.ones(3)
        torch.distributed.all_reduce(t)
        assert torch.equal(t, torch.ones(3))
    finally:
        backend.on_shutdown(group, CudaConfig(device="cpu"))
    assert not torch.distributed.is_initialized()
