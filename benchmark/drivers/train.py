"""A training cell on one card: the port's train step fed fresh rows
from the seed, timed over whole steps.

Set-up draws the weights from the seed on the card (f32, the port's
training form) and hands them to the family's `make_train_step` state,
then drives that same state through the first `check_steps` steps with
the window's own call and feed: their losses, each leaf's first gradient
(from AdamW's first moment after one step) and each leaf's change after
the last are read there, for the reference to follow.  The window then
runs whole steps on new rows, at most one step ahead of the device, and
ends on a synchronise.  After it, the state is freed and the plain
reference repeats the first steps from the same weights and rows.

`Setup`, `window` and the comparison serve the mesh's training driver
(`train_fsdp.py`) too: there each rank holds its shards, reads its part
of each leaf, and the norms are summed over the ranks
(`train_reference.DataParallel`).
"""

from __future__ import annotations

import statistics
import sys
from typing import Callable, Optional

import torch

from benchmark import harness, trace, train_reference, weights
from benchmark.drivers._common import Fence, free, log, memory_peak, now, \
    program


def _flat(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def _local(t: torch.Tensor) -> torch.Tensor:
    """A parameter's values on this rank (a DTensor's local shard)."""
    return t.to_local() if hasattr(t, "to_local") else t


def _exp_avgs(opt) -> dict:
    """{id(parameter): its first moment, on this rank} of the program's
    optimizer (torch's AdamW, or the mesh's `ShardedAdamW`)."""
    if isinstance(opt, torch.optim.Optimizer):
        return {id(p): st.get("exp_avg") for p, st in opt.state.items()}
    return {id(p): opt.optimizer.state.get(shard, {}).get("exp_avg")
            for p, shard in zip(opt.params, opt.shards)}


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
    a tenth of its leaf's root mean square
    (`train_reference.change_kept`).  Leaves whose reference gradient is
    under `grad_floor` of the median leaf's move under AdamW by
    round-off alone and are left out of the change.  `ref` is the
    reference's readings judging `prog`'s."""
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


def log_worst(prog: dict, ref: dict) -> None:
    """The checked steps' losses, and the leaf that sets each number."""
    print(f"benchmark: losses {prog['losses']!r}, reference "
          f"{ref['losses']!r}", file=sys.stderr)
    for name, (leaf, value) in worst_leaves(prog, ref).items():
        print(f"benchmark: worst leaf of {name}: {leaf} {value!r}",
              file=sys.stderr)


class Setup:
    """The program's train step and state for one seed, driven through
    the checked first steps (`readings`), and the window's feed.  With a
    `mesh` (every rank of the process group builds one alike) the params
    are drawn whole on each rank and each rank keeps its shard of each
    leaf; `parts` then reads each rank's part of the leaves."""

    def __init__(self, spec: dict, seed: int, device, mesh=None):
        from ray_tpu_torch.models._functional import adamw

        self.spec, self.seed = spec, seed
        self.ref = harness.reference(spec)
        self.run, self.tr = spec["config"]["run"], spec["traffic"]
        self.device = device = torch.device(device)
        self.vocab = spec["config"]["vocab_published"]
        hp = self.tr["optimizer"]
        fam, conf = program(spec, remat=self.tr["remat"])
        init_state, self.train_step = fam.make_train_step(
            conf, adamw(hp["lr"], hp["b1"], hp["b2"], hp["eps"], hp["wd"]),
            mesh, device=device)
        keep = None
        if mesh is not None:
            from ray_tpu_torch.parallel.sharding import tree_shardings

            shardings = _flat(tree_shardings(mesh, fam.param_specs(conf)))
            keep = lambda path, t: shardings[path].shard(t, device)  # noqa
        self.state = init_state(params=self.ref.draw_params(
            self.run, seed, device, keep=keep))
        free(device)
        self.parts = self._parts(mesh)
        losses, first = [], ({}, {})
        for step in range(1, self.tr["check_steps"] + 1):
            self.step(step)
            losses.append(float(self.out["loss"]))
            if step == 1:
                first = self._first_grads(hp["b1"])
        self.readings = self._program_readings(losses, first)

    def _parts(self, mesh):
        """How this process reads its part of each leaf: whole on one
        device; under a mesh, its shard (`index`: its slices of the
        whole leaf)."""
        if mesh is None:
            return train_reference.Whole()
        import torch.distributed as dist
        from ray_tpu_torch.parallel.sharding import local_index, spec_of

        params = _flat(self.state["params"])
        parts = train_reference.DataParallel(
            dist.get_rank(), dist.get_world_size(),
            {k: local_index(p.shape, spec_of(p), mesh)
             for k, p in params.items()}, self.device)
        parts.shapes = {k: tuple(p.shape) for k, p in params.items()}
        return parts

    def _first_grads(self, b1: float) -> tuple:
        """({path: norm}, {path: host copy of this rank's part}) of each
        leaf's first gradient, from AdamW's first moment after one step
        (m_1 = (1 - b1) g_1); zero for a leaf that the optimizer has not
        stepped."""
        moments = _exp_avgs(self.state["opt_state"])
        norms, grads = {}, {}
        with torch.no_grad():
            for path, p in _flat(self.state["params"]).items():
                m = moments.get(id(p))
                g = torch.zeros_like(_local(p)) if m is None else m / (1 - b1)
                norms[path] = self.parts.norm(path, [g])
                grads[path] = g.cpu()
        return self.parts.done(norms), grads

    def _program_readings(self, losses: list, first: tuple) -> dict:
        """The checked steps' losses, and by leaf path the first gradient
        (`first`, from `_first_grads`) and the change after the last
        step: their norms, and host copies of this rank's part for the
        reference to judge."""
        norms, grads = first
        out = {"losses": losses, "grad_norms": norms, "change_norms": {},
               "first_grads": grads, "changes": {}}
        params = _flat(self.state["params"])
        index = getattr(self.parts, "index", None)
        change_norms = {}

        def judge(path, start):
            p = _local(params[path]).detach()
            change = p - (start if index is None else start[index[path]])
            change_norms[path] = self.parts.norm(path, [change])
            out["changes"][path] = change.cpu()

        with torch.no_grad():
            self.ref.draw_params(self.run, self.seed, self.device, keep=judge)
        out["change_norms"] = self.parts.done(change_norms)
        return out

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
                  lr: float = None, kept_by: dict = None,
                  exchange: bool = True) -> dict:
        """The plain reference's readings of the checked steps (on the
        first `rows` rows of each batch, at learning rate `lr`, when
        given; under a mesh data parallel over the same ranks, with the
        gradients' sum left out when not `exchange`), judging `judged`'s
        first gradients and changes (default: the program's), the
        changes on the elements that the masks `kept_by` keep (default:
        its own)."""
        tr = self.tr
        hp = dict(tr["optimizer"], **({} if lr is None else {"lr": lr}))
        parts = self.parts
        if isinstance(parts, train_reference.DataParallel):
            parts = train_reference.DataParallel(
                parts.rank, parts.world, parts.index, self.device, exchange)
        return self.ref.train_readings(
            self.run, self.seed,
            [self.feed(s)["tokens"][:rows]
             for s in range(1, tr["check_steps"] + 1)],
            hp, self.device, precision=precision,
            rows_per_pass=tr["reference_rows_per_pass"],
            judged=self.readings if judged is None else judged, keep=keep,
            kept_by=kept_by, parts=parts)

    def controls(self) -> dict:
        """The readings of the reference put in the program's place: one
        precision below the configuration's (the control, "fp8"), on half
        of each batch ("half_batch"), at learning rate 0 ("unchanged": a
        step that leaves the state unchanged), and, under a mesh, with
        the gradients' exchange left out ("no_exchange"); each judged by
        the f32 reference.  Also the program's own ("program") and the
        leaves that set them ("worst")."""
        ref = self.reference(keep=True)
        out = {"program": dict(compare(self.readings, ref)),
               "worst": worst_leaves(self.readings, ref)}
        faults = [("control", {"precision": "fp8"}),
                  ("half_batch", {"rows": self.tr["rows"] // 2}),
                  ("unchanged", {"lr": 0.0})]
        if isinstance(self.parts, train_reference.DataParallel):
            faults.append(("no_exchange", {"exchange": False}))
        for name, kw in faults:
            other = self.reference(judged=ref, kept_by=ref["kept"], **kw)
            judge = dict(ref, grad_diff_norms=other["grad_diff_norms"],
                         change_diff_norms=other["change_diff_norms"])
            out[name] = dict(compare(other, judge))
        return out


def window(setup: Setup, seconds: float, traced: bool,
           agree: Callable[[bool], bool] = lambda stop: stop,
           barrier: Optional[Callable[[], None]] = None) -> dict:
    """The timed whole steps: from `t0` on new rows, at most one step
    ahead of the device, until the window's `seconds` have passed,
    ending on a synchronise (`t1`); `done` holds the host times at which
    each step was seen to end.  Under a mesh every rank runs it:
    `barrier` (a synchronise of every rank) opens and closes it, and
    `agree` gives every rank the decision to stop that rank 0 takes.
    With `traced`, the profiler records the first `trace_seconds`
    (`traced_steps` whole steps in `traced_s`)."""
    device, tr = setup.device, setup.tr
    tracer = trace.TraceWindow(traced)
    tracer.start()
    if barrier is not None:
        barrier()
    t0 = now()
    tracer.open()
    trace_end = t0 + tr["trace_seconds"]
    out = {}
    steps, pending, done = 0, None, []
    while True:
        setup.step(tr["check_steps"] + 1 + steps)
        fence = Fence(device)
        steps += 1
        if pending is not None:
            pending.wait()
            done.append(now())
        pending = fence
        if tracer.enabled and not tracer.closed and done \
                and done[-1] >= trace_end:
            tracer.close()
            out.update(traced_steps=len(done), traced_s=done[-1] - t0)
        if agree(now() >= t0 + seconds):
            break
    pending.wait()
    if barrier is not None:
        barrier()
    t1 = now()
    done.append(t1)
    if tracer.enabled and not tracer.closed:
        tracer.close()
        out.update(traced_steps=len(done), traced_s=t1 - t0)
    out.update(t0=t0, t1=t1, steps=steps, done=done,
               peak=memory_peak(device), trace=tracer.trace)
    return out


def train_ctx(spec: dict, win: dict, setup_s: float) -> dict:
    """What the readers read of a training run (`win`, `window`'s)."""
    run, tr = spec["config"]["run"], spec["traffic"]
    rows, length, chips = tr["rows"], tr["length"], spec["cell"]["chips"]
    ctx = {
        "kind": "train", "cfg": run, "traffic": tr, "chips": chips,
        "setup_s": setup_s, "window_s": win["t1"] - win["t0"],
        "steps": win["steps"], "tokens_per_step": rows * length,
        "flops_per_step": harness.reference(spec).train_flops(
            run, rows, length),
        "flash_call": (rows // chips, length, run["n_heads"],
                       run["d_model"] // run["n_heads"], run["dtype"]),
        "trace": win["trace"],
    }
    if "traced_steps" in win:
        ctx.update(traced_steps=win["traced_steps"],
                   traced_s=win["traced_s"])
    return ctx


def run(spec: dict, seed: int, seconds: float, traced: bool, device,
        t_start: float) -> dict:
    setup = Setup(spec, seed, device)
    win = window(setup, seconds, traced)
    log(f"setup {win['t0'] - t_start:.3f} s, {win['steps']} steps in the "
        "window", win["t0"])
    setup.close()

    t_ref = now()
    ref = setup.reference()
    log("reference", t_ref)
    log_worst(setup.readings, ref)
    return {"ctx": train_ctx(spec, win, win["t0"] - t_start),
            "checks": compare(setup.readings, ref),
            "attempted": win["steps"], "failed": 0,
            "memory_peak_bytes": win["peak"]}


def readings(spec: dict, seed: int, device, seconds: float,
             control: bool) -> dict:
    """The program's numbers at `seed` and, with `control`, the
    control's and the faults' (`Setup.controls`).  A training cell needs
    no window: the checked first steps are the readings."""
    setup = Setup(spec, seed, device)
    setup.close()
    if control:
        return setup.controls()
    ref = setup.reference()
    return {"program": dict(compare(setup.readings, ref)),
            "worst": worst_leaves(setup.readings, ref)}


def tiny(mix: dict) -> dict:
    """The mix at the CPU tests' sizes."""
    return dict(mix, rows=4, length=64, trace_seconds=0.5)
