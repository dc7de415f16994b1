"""A training cell on one card: the port's train step fed fresh rows
from the seed, timed over whole steps.

Set-up draws the weights from the seed on the card (f32, the port's
training form) and hands them to `make_train_step`'s state, then drives
that same state through the first `check_steps` steps with the window's
own call and feed: their losses, each leaf's first gradient (from
AdamW's first moment after one step) and each leaf's change after the
last are read there, for the reference to follow.  The window then runs
whole steps on new rows, at most one step ahead of the device, and ends
on a synchronise.  After it, the state is freed and the plain reference
repeats the first steps from the same weights and rows.
"""

from __future__ import annotations

import statistics
import sys

import torch

from benchmark import flops, trace, weights
from benchmark.drivers._common import (Fence, free, gpt_config, log,
                                       memory_peak, now)
from benchmark.references import gpt2 as reference


def _leaf(tree: dict, path: str):
    for key in path.split("/"):
        tree = tree[key]
    return tree


def _program_readings(state, cfg: dict, seed: int, losses: list,
                      first: tuple, device) -> dict:
    """The checked steps' losses, and by leaf path the first gradient
    (`first`, from `_first_grads`) and the change after the last step:
    their norms (taken on the device), and host copies for the reference
    to judge."""
    norms, grads = first
    out = {"losses": losses, "grad_norms": norms, "change_norms": {},
           "first_grads": grads, "changes": {}}
    with torch.no_grad():
        for path in weights.leaf_specs(cfg):
            p = _leaf(state["params"], path).detach()
            change = p - weights.draw_leaf(cfg, seed, path, device)
            out["change_norms"][path] = float(change.norm())
            out["changes"][path] = change.cpu()
    return out


def _first_grads(state, cfg: dict, b1: float) -> tuple:
    """({path: norm}, {path: host copy}) of each leaf's first gradient,
    from AdamW's first moment after one step (m_1 = (1 - b1) g_1); zero
    for a leaf that the optimizer has not stepped."""
    opt = state["opt_state"]
    norms, grads = {}, {}
    with torch.no_grad():
        for path in weights.leaf_specs(cfg):
            p = _leaf(state["params"], path)
            m = opt.state[p].get("exp_avg")
            g = torch.zeros_like(p) if m is None else m / (1 - b1)
            norms[path] = float(g.norm())
            grads[path] = g.cpu()
    return norms, grads


def _numbers(prog: dict, ref: dict, grad_floor: float) -> dict:
    """{number: {leaf: reading}} (`compare`'s numbers, leaf by leaf)."""
    g_ref = ref["grad_norms"]
    g_med = statistics.median(g_ref.values())
    moved = [k for k, g in g_ref.items() if g >= grad_floor * g_med]
    c_ref, k_ref = ref["change_norms"], ref["change_kept_norms"]
    c_med = statistics.median(c_ref[k] for k in moved)
    k_med = statistics.median(k_ref[k] for k in moved)
    return {
        "grad_gap": {k: abs(prog["grad_norms"][k] - g) / max(g, g_med)
                     for k, g in g_ref.items()},
        "change_gap": {k: abs(prog["change_norms"][k] - c_ref[k])
                       / max(c_ref[k], c_med) for k in moved},
        "grad_diff": {k: ref["grad_diff_norms"][k] / max(g, g_med)
                      for k, g in g_ref.items()},
        "change_diff": {k: ref["change_diff_norms"][k]
                        / max(k_ref[k], k_med) for k in moved},
    }


def compare(prog: dict, ref: dict, grad_floor: float = 1e-3) -> list:
    """The numbers that decide `correct`, each as the worst case:
    loss_gap, the largest |program - reference| / |reference| loss over
    the checked steps; grad_gap and change_gap, over leaves, the gap
    between the program's and the reference's norm of the leaf's first
    gradient (its change after the last checked step) over the larger of
    the reference's norm of that leaf and of the median leaf; grad_diff,
    over leaves, the norm of the difference between the two sides'
    first gradients on the same scale; change_diff the same of their
    changes, on the elements whose reference first gradient is at least
    a tenth of its leaf's root mean square (`reference.change_kept`).
    Leaves whose reference gradient is under `grad_floor` of the median
    leaf's move under AdamW by round-off alone and are left out of the
    change.  `ref` is the reference's readings judging `prog`'s."""
    loss_gap = max(abs(p - r) / abs(r)
                   for p, r in zip(prog["losses"], ref["losses"]))
    numbers = _numbers(prog, ref, grad_floor)
    return [("loss_gap", loss_gap)] + [(name, max(by_leaf.values()))
                                       for name, by_leaf in numbers.items()]


def worst_leaves(prog: dict, ref: dict, grad_floor: float = 1e-3) -> dict:
    """{number: (leaf, reading)}: the leaf that sets each of `compare`'s
    numbers, and the worst leaf's first-gradient gap over its own norm
    ("grad_gap_own")."""
    out = {name: max(by_leaf.items(), key=lambda kv: kv[1])
           for name, by_leaf in _numbers(prog, ref, grad_floor).items()}
    own = {k: abs(prog["grad_norms"][k] - g) / g
           for k, g in ref["grad_norms"].items() if g > 0}
    out["grad_gap_own"] = max(own.items(), key=lambda kv: kv[1])
    return out


class Setup:
    """The program's train step and state for one seed, driven through
    the checked first steps (`readings`), and the window's feed."""

    def __init__(self, spec: dict, seed: int, device):
        from ray_tpu_torch.models import gpt
        from ray_tpu_torch.models._functional import adamw

        cfg, tr = spec["config"]["run"], spec["traffic"]
        self.cfg, self.tr, self.seed = cfg, tr, seed
        self.device = device = torch.device(device)
        self.vocab = spec["config"]["vocab_published"]
        hp = tr["optimizer"]
        conf = gpt_config(cfg, remat=tr["remat"])
        init_state, self.train_step = gpt.make_train_step(
            conf, adamw(hp["lr"], hp["b1"], hp["b2"], hp["eps"], hp["wd"]),
            device=device)
        self.state = init_state(params=weights.draw_params(cfg, seed,
                                                           device))
        free(device)
        losses, first = [], ({}, {})
        for step in range(1, tr["check_steps"] + 1):
            self.step(step)
            losses.append(float(self.out["loss"]))
            if step == 1:
                first = _first_grads(self.state, cfg, hp["b1"])
        self.readings = _program_readings(self.state, cfg, seed, losses,
                                          first, device)

    def feed(self, step: int) -> dict:
        tr = self.tr
        return {"tokens": weights.token_batch(
            self.seed, step, tr["rows"], tr["length"], self.vocab,
            self.device)}

    def step(self, step: int) -> None:
        self.state, self.out = self.train_step(self.state, self.feed(step))

    def close(self) -> None:
        """Free the program's state (before the reference runs)."""
        self.state = self.out = self.train_step = None
        free(self.device)

    def reference(self, precision: str = "f32", rows: int = None,
                  judged: dict = None, keep: bool = False,
                  lr: float = None, kept_by: dict = None) -> dict:
        """The plain reference's readings of the checked steps (on the
        first `rows` rows of each batch, at learning rate `lr`, when
        given), judging `judged`'s first gradients and changes (default:
        the program's), the changes on the elements that the first
        gradients `kept_by` keep (default: its own)."""
        tr = self.tr
        hp = dict(tr["optimizer"], **({} if lr is None else {"lr": lr}))
        return reference.train_readings(
            self.cfg, self.seed,
            [self.feed(s)["tokens"][:rows]
             for s in range(1, tr["check_steps"] + 1)],
            hp, self.device, precision=precision,
            rows_per_pass=tr["reference_rows_per_pass"],
            judged=self.readings if judged is None else judged, keep=keep,
            kept_by=kept_by)


def run(spec: dict, seed: int, seconds: float, traced: bool, device,
        t_start: float) -> dict:
    setup = Setup(spec, seed, device)
    cfg, tr, device = setup.cfg, setup.tr, setup.device
    rows, length, n_check = tr["rows"], tr["length"], tr["check_steps"]

    tracer = trace.TraceWindow(traced)
    tracer.start()
    t0 = now()
    tracer.open()
    trace_end = t0 + tr["trace_seconds"]
    steps, pending, done = 0, None, []
    while True:
        setup.step(n_check + 1 + steps)
        fence = Fence(device)
        steps += 1
        if pending is not None:
            pending.wait()
            done.append(now())
        pending = fence
        if tracer.enabled and not tracer.closed and done \
                and done[-1] >= trace_end:
            tracer.close()
            traced_steps, traced_s = len(done), done[-1] - t0
        if now() >= t0 + seconds:
            break
    pending.wait()
    t1 = now()
    done.append(t1)
    if tracer.enabled and not tracer.closed:
        tracer.close()
        traced_steps, traced_s = len(done), t1 - t0
    peak = memory_peak(device)
    log(f"setup {t0 - t_start:.3f} s, {steps} steps in the window", t0)
    del pending, fence
    setup.close()

    t_ref = now()
    ref = setup.reference()
    log("reference", t_ref)
    for name, (leaf, value) in worst_leaves(setup.readings, ref).items():
        print(f"benchmark: worst leaf of {name}: {leaf} {value!r}",
              file=sys.stderr)
    ctx = {
        "kind": "train", "cfg": cfg, "traffic": tr, "chips": 1,
        "setup_s": t0 - t_start, "window_s": t1 - t0, "steps": steps,
        "tokens_per_step": rows * length,
        "flops_per_step": flops.train_step_flops(cfg, rows, length),
        "flash_call": (rows, length, cfg["n_heads"],
                       cfg["d_model"] // cfg["n_heads"], cfg["dtype"]),
        "trace": tracer.trace,
    }
    if tracer.enabled:
        ctx.update(traced_steps=traced_steps, traced_s=traced_s)
    return {"ctx": ctx, "checks": compare(setup.readings, ref),
            "attempted": steps, "failed": 0, "memory_peak_bytes": peak}
