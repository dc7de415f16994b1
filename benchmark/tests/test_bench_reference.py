"""The plain reference against the port at small widths on the CPU, in
float32: logits, loss and gradients on the same weights and rows; the
fp8 control departs from it; the reference imports nothing of the
program."""

import subprocess
import sys

import pytest
import torch

from benchmark import weights
from benchmark.drivers.train import compare
from benchmark.references import gpt2 as ref
from conftest import ROOT

CFG = dict(vocab_size=512, n_layers=2, d_model=128, n_heads=2, d_ff=256,
           max_seq_len=64, dtype="float32")
SEED = 2 ** 35 + 11


def _port(cfg):
    from benchmark.drivers._common import gpt_config
    return gpt_config(cfg)


def _tokens(rows=3, length=32):
    return weights.token_batch(SEED, 1, rows, length, 500, "cpu")


def test_logits_match_the_port():
    from ray_tpu_torch.models import gpt

    params = ref.f32_params(CFG, SEED, "cpu")
    tokens = _tokens()
    want = ref.logits(params, ref.hidden(params, tokens))
    got, _ = gpt.forward(params, tokens, _port(CFG))
    assert torch.allclose(got, want, atol=2e-5, rtol=1e-4)


def test_loss_and_gradients_match_the_port():
    from ray_tpu_torch.models import gpt

    tokens = _tokens()
    params = ref.f32_params(CFG, SEED, "cpu", requires_grad=True)
    loss = ref.loss_and_grads(params, tokens, "f32", rows_per_pass=2)
    port = ref.f32_params(CFG, SEED, "cpu", requires_grad=True)
    got = gpt.loss_fn(port, {"tokens": tokens}, _port(CFG))
    got.backward()
    assert float(got.detach()) == pytest.approx(loss, rel=1e-5)
    for k in params["blocks"]:
        assert torch.allclose(port["blocks"][k].grad,
                              params["blocks"][k].grad, atol=1e-6,
                              rtol=1e-3), k


def test_three_steps_match_the_port():
    from ray_tpu_torch.models import gpt
    from ray_tpu_torch.models._functional import adamw

    hp = dict(lr=1e-4, b1=0.9, b2=0.999, eps=1e-8, wd=1e-4)
    batches = [weights.token_batch(SEED, s, 2, 32, 500, "cpu")
               for s in (1, 2, 3)]
    want = ref.train_readings(CFG, SEED, batches, hp, "cpu")
    init, step = gpt.make_train_step(_port(CFG), adamw(1e-4), device="cpu")
    state = init(params=weights.draw_params(CFG, SEED, "cpu"))
    losses = []
    for b in batches:
        state, out = step(state, {"tokens": b})
        losses.append(float(out["loss"]))
    assert losses == pytest.approx(want["losses"], rel=1e-5)
    delta = {k: float((state["params"]["blocks"][k.split("/")[1]].detach()
                       - weights.draw_leaf(CFG, SEED, k, "cpu")).norm())
             for k in want["change_norms"] if k.startswith("blocks/w")}
    for k, v in delta.items():
        assert v == pytest.approx(want["change_norms"][k], rel=1e-3), k


def test_fp8_control_departs():
    """The control (fp8 operands) moves the first gradients well beyond
    what the port's f32 run does."""
    batches = [weights.token_batch(SEED, s, 2, 32, 500, "cpu")
               for s in (1, 2, 3)]
    hp = dict(lr=1e-4, b1=0.9, b2=0.999, eps=1e-8, wd=1e-4)
    f32 = ref.train_readings(CFG, SEED, batches, hp, "cpu", keep=True)
    low = ref.train_readings(CFG, SEED, batches, hp, "cpu", "fp8",
                             judged=f32, kept_by=f32["first_grads"])
    judge = dict(f32, grad_diff_norms=low["grad_diff_norms"],
                 change_diff_norms=low["change_diff_norms"])
    gaps = dict(compare(low, judge))
    assert gaps["grad_diff"] > 1e-2
    seq = [(list(range(1, 20)), [3, 4, 5, 6])]
    assert max(ref.served_gaps(CFG, SEED, seq, "cpu", "fp8")) >= 0.0


def test_reference_imports_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r); "
            "import benchmark.references.gpt2, benchmark.flops, "
            "benchmark.requests, benchmark.trace; "
            "bad = sorted({m.split('.')[0] for m in sys.modules} & "
            "{'ray_tpu_torch', 'ray_tpu', 'jax', 'jaxlib', 'flax'}); "
            "print(bad); sys.exit(1 if bad else 0)" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
