"""The check that decides `correct` catches each fault that a cell can
have, planted under a whole run of the tiny cells on the CPU (the look
for a card skipped): a step that returns its state unchanged, half of
the batch left out with the mean over the rest, a token altered where
it is produced, and, in the cell over four ranks, the exchange between
them left out (each rank's gradient shard its own rows' alone).  The
four-rank cell's ranks are spawned processes, so its faults are planted
in each rank by a first call of a gang made for the test
(`_plant`)."""

import pytest
import torch

TRAIN = "gpt2-xl.train-1k"
SERVE = "cerebras-gpt-6.7b.serve-longprompt"
FSDP = "cerebras-gpt-6.7b.fsdp4-train-2k"


def _correct(root, workload):
    from benchmark.run import run_cell
    result, checks = run_cell(workload, 2 ** 32 + 17, 1.0, False,
                              device="cpu", root=root)
    return result["correct"], dict((n, v) for n, v, _ in checks)


def test_sound_runs_are_correct(tiny_root):
    assert _correct(tiny_root, TRAIN)[0]
    assert _correct(tiny_root, SERVE)[0]


def test_step_returns_state_unchanged(tiny_root, monkeypatch):
    monkeypatch.setattr(torch.optim.AdamW, "step",
                        lambda self, closure=None: None)
    correct, got = _correct(tiny_root, TRAIN)
    assert not correct and got["change_gap"] == pytest.approx(1.0)


def test_half_the_batch_left_out(tiny_root, monkeypatch):
    from ray_tpu_torch.models import gpt

    loss_fn = gpt.loss_fn

    def half(params, batch, config, mesh=None):
        rows = batch["tokens"].shape[0] // 2
        return loss_fn(params, {"tokens": batch["tokens"][:rows]}, config,
                       mesh)

    monkeypatch.setattr(gpt, "loss_fn", half)
    correct, got = _correct(tiny_root, TRAIN)
    assert not correct, got


def test_token_altered_where_produced(tiny_root, monkeypatch):
    from ray_tpu_torch.inference.engine import InferenceEngine

    run_step = InferenceEngine._run_step

    def altered(self, *args, **kw):
        out, lps = run_step(self, *args, **kw)
        return (out + 1) % self.config.vocab_size, lps

    monkeypatch.setattr(InferenceEngine, "_run_step", altered)
    correct, got = _correct(tiny_root, SERVE)
    assert not correct, got


def _plant(rank, world, state, fault):
    """Plant `fault` in this rank's program (for the rest of its life)."""
    import torch.distributed as dist
    from ray_tpu_torch.models import _functional, gpt
    from ray_tpu_torch.parallel import collectives

    if fault == "unchanged":
        _functional.ShardedAdamW.step = lambda self: None
    elif fault == "half_batch":
        loss_fn = gpt.loss_fn

        def half(params, batch, config, mesh=None):
            rows = batch["tokens"].shape[0] // 2
            return loss_fn(params, {"tokens": batch["tokens"][:rows]},
                           config, mesh)

        gpt.loss_fn = half
    elif fault == "no_exchange":
        def own_chunk(ctx, g):
            n, r = dist.get_world_size(ctx.group), dist.get_rank(ctx.group)
            return g.chunk(n, ctx.dim)[r].contiguous(), None, None, None

        collectives._AllGather.backward = staticmethod(own_chunk)


@pytest.mark.parametrize("fault", ["unchanged", "half_batch",
                                   "no_exchange"])
def test_fsdp_faults(tiny_root, monkeypatch, fault):
    from ray_tpu_torch.parallel import launch

    class Planted(launch.RankGang):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            self.call(_plant, fault)

    monkeypatch.setattr(launch, "RankGang", Planted)
    correct, got = _correct(tiny_root, FSDP)
    assert not correct, got
    if fault == "unchanged":
        assert got["change_gap"] == pytest.approx(1.0)
