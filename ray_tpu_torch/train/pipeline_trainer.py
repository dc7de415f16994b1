"""MPMD pipeline-parallel trainer: the driver-side schedule pump (port of
ray_tpu/train/pipeline_trainer.py, with the runtime and the Observer
injected).

`PipelineTrainer` splits the model into `n_chunks = len(stage_params)`
stage-chunks and maps them round-robin onto `n_chunks // interleave`
actor gangs (each a `StageGroup` under its own placement group — see
`train/pipeline_stage.py`), then runs 1F1B or GPipe microbatch
schedules by pumping at most one compute op per gang member and letting
activation and gradient refs flow chunk-to-chunk over the runtime's
object plane.  The driver only ever fetches the small `meta` half of
each `num_returns=2` stage call; the payload ref is handed to the next
chunk wrapped in a tuple.

Three levers take transfer and bubble off the critical path:

- **Interleaved (looping) schedule** — with ``interleave=v > 1`` each
  gang owns v *non-adjacent* chunks (gang g owns ``g, g+n_gangs, ...``),
  so during warmup/drain every gang has some chunk with work.
  Per-(chunk, microbatch) grads fold in sorted order at the boundary, so
  the SGD trajectory is bit-identical to the v=1 1F1B/GPipe runs.
- **Pre-pushed activations** (``prefetch=True``) — the moment chunk c's
  forward for microbatch m completes, the driver ships the ref to chunk
  c+1's owner via ``prefetch``, which resolves it into a double-buffered
  receive window (`recv_window`) while that gang computes.
- **Topology-aware placement** (``placement_plan``) — a per-gang extra
  resource dict (see `parallel.mesh.stage_slice_plan` /
  `pipeline_placement_resources`) pins each gang inside one slice;
  gang members themselves form the intra-stage data-parallel group
  (microbatch j lands on member j % gang).

Backpressure: chunk *c* may complete at most `queue_depth` forwards
ahead of chunk *c+1*, and in-flight pre-pushed activations count
against the consumer's memory on top of that — the dispatcher blocks a
forward when ``(sealed-unconsumed) + (resident prefetched) >=
queue_depth + recv_window``.  1F1B additionally caps chunk *c* at
``n_chunks - c`` forwards not yet backward-ed (the classic warmup
depth).

Failure semantics:

- a dead gang member marks its whole gang dead; the gang re-forms in
  place via `StageGroup.reform()` — fresh PG, fresh actors, params
  (every owned chunk) from the gang's latest COMMITTED checkpoint;
- if the restored version equals the in-flight step, recovery is
  *surgical*: only the dead gang's chunks replay their microbatches,
  re-fed (and re-pushed) from upstream chunks' sealed activations and
  downstream chunks' sealed grads; surviving gangs never restart and
  never recompute;
- if the re-formed gang restored a *newer* version (it died after
  applying + committing the step), it is marked applied and skips the
  boundary;
- anything else — or a recovery that finds no dead gang (e.g. objects
  lost with a node) — falls back to a global rollback: every gang loads
  the newest checkpoint step committed by *all* gangs (survivors load in
  place, without restarting), and `fit` resumes from there.

All recoveries count against `max_failures`.

The runtime is a handle (`runtime=ray_tpu`, or an in-process stand-in;
see `pipeline_stage`), and the Observer (`observer=`) records the
reference's spans, events and metrics (`pp_bubble_fraction`,
`pp_step_seconds`, `pp_prepush_total`, ``pp_recoveries{kind=...}``).
`torch_stage_fns` builds the stage quartet from torch functions.
"""

from __future__ import annotations

import os
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ray_tpu_torch._device import DeviceLike, resolve_device
from ray_tpu_torch.train.pipeline_stage import StageGroup, to_host, tree_map
from ray_tpu_torch.util.observe import NOOP, Observer


def _flat(tree) -> list:
    out: list = []
    tree_map(out.append, tree)
    return out


def _leaf(x, device: torch.device, grad: bool):
    """x (a tensor or an array) as a tensor on `device`; a floating one
    becomes a fresh autograd leaf when `grad`."""
    if x is None:
        return None
    t = (x.detach() if isinstance(x, torch.Tensor)
         else torch.as_tensor(np.asarray(x))).to(device)
    if grad and t.is_floating_point():
        t.requires_grad_()
    return t


def _detach(t):
    return t.detach() if isinstance(t, torch.Tensor) else t


def _grad(t):
    if not isinstance(t, torch.Tensor) or not t.requires_grad:
        return None
    return t.grad if t.grad is not None else torch.zeros_like(t)


def torch_stage_fns(stage_fn: Callable, loss_fn: Callable, *,
                    device: DeviceLike = None):
    """Build the (stage_fwd, stage_bwd, loss_fwd, loss_bwd) quartet from
    a torch ``stage_fn(params, x) -> y`` / ``loss_fn(y, target) ->
    scalar`` pair with autograd — the counterpart of the reference's
    `jax_stage_fns`.

    Params decide where a call runs.  Tensor params: the call runs on
    their device, inputs are moved there, and outputs stay tensors on it.
    Numpy params (the reference's pump): the call runs on `device` (None
    -> CUDA; without a card that raises here) and every output is numpy,
    bf16 as f32.  `y` may be a pytree (the last chunk may hand the loss a
    (hidden, head) pair); a gradient arriving for it is cast to each
    leaf's dtype before the backward.  The autograd graph lives only in
    the stage worker's caches; nothing here holds a tensor, so the
    quartet pickles."""
    default = resolve_device(device)

    def where(tree):
        first = next((t for t in _flat(tree)
                      if isinstance(t, torch.Tensor)), None)
        if first is None:
            return default, True
        return first.device, False

    def out(tree, host: bool):
        return tree_map(to_host, tree) if host else tree

    def stage_fwd(params, x):
        dev, host = where(params)
        p = tree_map(lambda t: _leaf(t, dev, True), params)
        xl = tree_map(lambda t: _leaf(t, dev, True), x)
        with torch.enable_grad():
            y = stage_fn(p, xl)
        return out(tree_map(_detach, y), host), (y, xl, p, host)

    def stage_bwd(params, cache, gy):
        y, xl, p, host = cache
        ys, gys = [], []
        for yt, g in zip(_flat(y), _flat(gy)):
            if isinstance(yt, torch.Tensor) and yt.requires_grad:
                ys.append(yt)
                gys.append(_leaf(g, yt.device, False).to(yt.dtype))
        torch.autograd.backward(ys, gys)
        return out(tree_map(_grad, xl), host), out(tree_map(_grad, p), host)

    def loss_fwd(y, target):
        dev, host = where(y)
        yl = tree_map(lambda t: _leaf(t, dev, True), y)
        tl = tree_map(lambda t: _leaf(t, dev, False), target)
        with torch.enable_grad():
            loss = loss_fn(yl, tl)
        return float(loss.detach()), (yl, loss, host)

    def loss_bwd(lcache):
        yl, loss, host = lcache
        loss.backward()
        return out(tree_map(_grad, yl), host)

    return stage_fwd, stage_bwd, loss_fwd, loss_bwd


class _StageFailure(Exception):
    """Internal: a gang op failed; recovery should run."""

    def __init__(self, gang: int, reason: str):
        super().__init__(f"gang {gang}: {reason}")
        self.stage = gang
        self.reason = reason


class _Rollback(Exception):
    """Internal: global rollback to `step` (all gangs reloaded)."""

    def __init__(self, step: int):
        super().__init__(f"rollback to step {step}")
        self.step = step


class _Op:
    __slots__ = ("gang", "chunk", "member", "kind", "mb", "t")

    def __init__(self, gang, chunk, member, kind, mb):
        self.gang = gang
        self.chunk = chunk
        self.member = member
        self.kind = kind
        self.mb = mb
        self.t = time.monotonic()


class _StepState:
    """Driver-side bookkeeping for one train step's schedule pump.
    Schedule progress is per CHUNK; busy/applied are per GANG (a member
    runs one op at a time across all its owned chunks)."""

    def __init__(self, n_chunks: int, n_gangs: int, n_micro: int):
        self.n_chunks = n_chunks
        self.n_gangs = n_gangs
        self.n_micro = n_micro
        self.owner = [c % n_gangs for c in range(n_chunks)]
        self.fwd_disp = [set() for _ in range(n_chunks)]
        self.fwd_done = [set() for _ in range(n_chunks)]
        self.bwd_disp = [set() for _ in range(n_chunks)]
        self.bwd_done = [set() for _ in range(n_chunks)]
        # Microbatches whose activation ref was pre-pushed into chunk
        # c's receive window this step (the send queue's memory bound).
        self.prepushed = [set() for _ in range(n_chunks)]
        self.busy: List[Dict[int, Any]] = [dict() for _ in range(n_gangs)]
        self.act: List[Dict[int, Any]] = [dict() for _ in range(n_chunks)]
        self.gout: List[Dict[int, Any]] = [dict() for _ in range(n_chunks)]
        self.losses: Dict[int, float] = {}
        self.pending: Dict[Any, _Op] = {}
        self.applied = [False] * n_gangs

    def reset_gang(self, g: int):
        """Forget gang g's schedule progress (it re-formed with empty
        caches and an empty receive window): every microbatch replays
        through every chunk g owns, nothing else changes.  Refs its
        chunks produced earlier stay in act/gout maps until the replay
        overwrites them — consumers that already fetched them are
        unaffected (sealed objects are immutable, and the stage fns are
        deterministic so replayed bytes are identical)."""
        for c in range(self.n_chunks):
            if self.owner[c] != g:
                continue
            self.fwd_disp[c] = set()
            self.fwd_done[c] = set()
            self.bwd_disp[c] = set()
            self.bwd_done[c] = set()
            self.prepushed[c] = set()    # fresh actors, empty windows
        self.busy[g] = {}
        self.applied[g] = False
        self.pending = {r: op for r, op in self.pending.items()
                        if op.gang != g}

    def mark_gang_applied(self, g: int):
        full = set(range(self.n_micro))
        for c in range(self.n_chunks):
            if self.owner[c] != g:
                continue
            self.fwd_disp[c] = set(full)
            self.fwd_done[c] = set(full)
            self.bwd_disp[c] = set(full)
            self.bwd_done[c] = set(full)
        self.applied[g] = True

    def compute_done(self) -> bool:
        return all(self.applied[self.owner[c]]
                   or len(self.bwd_done[c]) == self.n_micro
                   for c in range(self.n_chunks))


class PipelineTrainer:
    """Fault-tolerant MPMD pipeline-parallel SGD trainer.

    Args:
      stage_fns: (stage_fwd, stage_bwd, loss_fwd, loss_bwd) — see
        `pipeline_stage` module docs, or build from torch via
        `torch_stage_fns`.
      stage_params: list of per-chunk param pytrees (tensor or numpy
        leaves); one entry per pipeline stage-chunk.
      runtime: the runtime handle (the `ray_tpu` module, or a stand-in
        with the same calls).
      n_microbatches: microbatches per global step.
      schedule: "1f1b" (bwd-first, bounded warmup) or "gpipe"
        (all-fwd-then-bwd).
      queue_depth: max microbatches a chunk may run ahead of its
        downstream consumer (the inter-stage queue bound).
      workers_per_stage: gang size (data parallel within a gang;
        microbatch j lands on member j % gang at every chunk).
      interleave: chunks per gang (v).  `len(stage_params)` must divide
        evenly; gang g owns chunks ``g, g+n_gangs, ...`` (non-adjacent).
      prefetch: pre-push sealed activations into downstream receive
        windows so `pp/xfer` resolves concurrently with compute.
      recv_window: max pre-pushed activations resident per chunk in a
        consumer's receive window (2 = double-buffered).
      placement_plan: optional per-gang extra resource dicts (length
        n_gangs) merged into each gang's bundle specs (see
        `parallel.mesh.pipeline_placement_resources`).
      storage_path: checkpoint root; per-gang trees commit under
        `<root>/stage_XX`.  None disables checkpointing (and therefore
        restart recovery — only surgical replay works).
      ckpt_every: commit per-gang checkpoints every k steps.
      max_failures: recoveries allowed across the fit before giving up.
      stage_timeout_s: op-completion watchdog; an op outstanding this
        long triggers a gang beacon probe.
      observer: the port's `Observer` (None: record nothing).
    """

    def __init__(self, stage_fns: Tuple[Callable, Callable, Callable,
                                        Callable],
                 stage_params: List[Any], *, runtime: Any,
                 lr: float = 0.05,
                 n_microbatches: int = 8, schedule: str = "1f1b",
                 queue_depth: int = 2, workers_per_stage: int = 1,
                 interleave: int = 1, prefetch: bool = False,
                 recv_window: int = 2,
                 resources_per_worker: Optional[dict] = None,
                 placement_plan: Optional[List[dict]] = None,
                 storage_path: Optional[str] = None, ckpt_every: int = 1,
                 max_failures: int = 2, stage_timeout_s: float = 30.0,
                 placement_strategy: str = "PACK",
                 pg_timeout_s: float = 60.0,
                 observer: Optional[Observer] = None):
        if runtime is None:
            raise ValueError("the pipeline's stage gangs are remote: pass "
                             "runtime=ray_tpu (or a stand-in)")
        if schedule not in ("1f1b", "gpipe"):
            raise ValueError(f"unknown schedule {schedule!r}")
        self.rt = runtime
        self._obs = observer or NOOP
        self.n_chunks = len(stage_params)
        self.v = max(1, int(interleave))
        if self.n_chunks % self.v:
            raise ValueError(
                f"interleave={self.v} must divide the {self.n_chunks} "
                f"stage-chunks evenly")
        self.n_gangs = self.n_chunks // self.v
        self.n_stages = self.n_chunks           # end-to-end chunk count
        self.n_micro = int(n_microbatches)
        self.schedule = schedule
        self.queue_depth = max(1, int(queue_depth))
        self.prefetch = bool(prefetch)
        self.recv_window = max(1, int(recv_window))
        self.gang = max(1, int(workers_per_stage))
        self.max_failures = int(max_failures)
        self.stage_timeout_s = float(stage_timeout_s)
        self.ckpt_every = max(1, int(ckpt_every))
        self.storage_path = storage_path
        self._recoveries = 0
        self.history: List[dict] = []
        if placement_plan is not None and len(placement_plan) != \
                self.n_gangs:
            raise ValueError(
                f"placement_plan has {len(placement_plan)} entries for "
                f"{self.n_gangs} gangs")
        fwd, bwd, loss_fwd, loss_bwd = stage_fns
        # Round-robin ownership — must match parallel.pipeline.
        # chunk_assignment (tests pin the equivalence).
        self._assignment = [list(range(g, self.n_chunks, self.n_gangs))
                            for g in range(self.n_gangs)]
        self.groups: List[StageGroup] = []
        try:
            for g in range(self.n_gangs):
                chunks = self._assignment[g]
                root = ""
                if storage_path:
                    root = os.path.join(storage_path, f"stage_{g:02d}")
                spec = {"stage": g, "n_stages": self.n_chunks,
                        "chunks": chunks,
                        "stage_fwd": fwd, "stage_bwd": bwd,
                        "loss_fwd": loss_fwd, "loss_bwd": loss_bwd,
                        "params": {c: stage_params[c] for c in chunks},
                        "lr": lr, "ckpt_root": root,
                        "observer": observer}
                res = dict(resources_per_worker or {"CPU": 1})
                if placement_plan is not None:
                    res.update(placement_plan[g])
                self.groups.append(StageGroup(
                    g, spec, self.gang, res,
                    placement_strategy=placement_strategy,
                    pg_timeout_s=pg_timeout_s, runtime=runtime))
            if placement_plan is not None:
                self._obs.record(
                    "pp", "placement", gangs=self.n_gangs,
                    interleave=self.v,
                    plan=[sorted(p) for p in placement_plan])
        except BaseException:
            self.shutdown()
            raise

    def _errors(self, timeout: bool = False) -> tuple:
        """The runtime's exception classes that mean a gang op failed."""
        ex = self.rt.exceptions
        errs = (ex.ActorError, ex.WorkerCrashedError, ex.ObjectLostError,
                ex.TaskError)
        return errs + (ex.RayTpuTimeoutError,) if timeout else errs

    # ------------------------------------------------------------------
    # dispatch
    # ------------------------------------------------------------------

    def _member(self, mb: int) -> int:
        return mb % self.gang

    def _owner(self, c: int) -> int:
        return c % self.n_gangs

    def _chunks_of(self, g: int) -> List[int]:
        return list(range(g, self.n_chunks, self.n_gangs))

    def _fwd_ready(self, st: _StepState, c: int, mb: int) -> bool:
        # Gate on the producer op having COMPLETED (activation sealed),
        # not on the ref existing: a dispatch-time ref whose producer
        # died unexecuted would feed the consumer a poisoned object.
        if c == 0:
            return True
        return mb in st.fwd_done[c - 1]

    def _bwd_ready(self, st: _StepState, c: int, mb: int) -> bool:
        if mb not in st.fwd_done[c]:
            return False
        if c == self.n_chunks - 1:
            return True
        return mb in st.bwd_done[c + 1]

    def _next_mb(self, disp: set, member: int) -> Optional[int]:
        for j in range(self.n_micro):
            if j not in disp and self._member(j) == member:
                return j
        return None

    def _fwd_window_ok(self, st: _StepState, c: int) -> bool:
        if self.schedule == "1f1b":
            warmup = max(1, self.n_chunks - c)
            if len(st.fwd_disp[c]) - len(st.bwd_done[c]) >= warmup:
                return False
        if c + 1 < self.n_chunks:
            # Bounded inter-stage queue: don't outrun the consumer.
            # Sealed-but-unconsumed activations count against
            # queue_depth; activations pre-pushed into the consumer's
            # receive window but not yet consumed occupy a SECOND copy
            # of the bytes, so the combined bound is queue_depth +
            # recv_window.
            ahead = len(st.fwd_done[c]) - len(st.fwd_done[c + 1])
            if ahead >= self.queue_depth:
                return False
            resident = len(st.prepushed[c + 1] - st.fwd_disp[c + 1])
            if ahead + resident >= self.queue_depth + self.recv_window:
                return False
        return True

    def _pump_prefetch(self, step: int, st: _StepState, mbs):
        """Ship sealed activation refs into downstream receive windows,
        bounded per chunk by recv_window (resident = pushed but not yet
        consumed by a dispatched forward)."""
        # Chunk 0 is fed from driver-local puts — nothing to hide there,
        # so pre-push only real inter-stage activations (c >= 1).
        for c in range(1, self.n_chunks):
            g = self._owner(c)
            if st.applied[g]:
                continue
            resident = len(st.prepushed[c] - st.fwd_disp[c])
            if resident >= self.recv_window:
                continue
            ready = sorted(st.fwd_done[c - 1])
            for mb in ready:
                if mb in st.prepushed[c] or mb in st.fwd_disp[c]:
                    continue
                src = st.act[c - 1][mb]
                actor = self.groups[g].members[self._member(mb)]
                # Fire-and-forget: a failed prefetch surfaces through
                # the consuming forward (parked error) or the watchdog.
                actor.prefetch.remote(step, c, mb, (src,))
                self._obs.record("pp", "prepush", step=step, chunk=c,
                                 mb=mb)
                self._obs.inc("pp_prepush_total")
                st.prepushed[c].add(mb)
                resident += 1
                if resident >= self.recv_window:
                    break

    def _pick_bwd(self, st: _StepState, g: int, m: int):
        # Deepest owned chunk first: drains the pipeline and frees the
        # 1F1B warmup window of shallower chunks soonest.
        for c in reversed(self._chunks_of(g)):
            jb = self._next_mb(st.bwd_disp[c], m)
            if jb is not None and self._bwd_ready(st, c, jb):
                return c, jb
        return None

    def _pick_fwd(self, st: _StepState, g: int, m: int):
        # Shallowest owned chunk first: keeps feeding the pipeline so
        # downstream gangs exit warmup as early as possible.
        for c in self._chunks_of(g):
            jf = self._next_mb(st.fwd_disp[c], m)
            if jf is not None and self._fwd_ready(st, c, jf) \
                    and self._fwd_window_ok(st, c):
                return c, jf
        return None

    def _dispatch(self, step: int, st: _StepState, mbs, tgts):
        if self.prefetch:
            self._pump_prefetch(step, st, mbs)
        last = self.n_chunks - 1
        for g, grp in enumerate(self.groups):
            if st.applied[g]:
                continue
            for m, actor in enumerate(grp.members):
                if m in st.busy[g]:
                    continue
                pb = self._pick_bwd(st, g, m)
                pf = self._pick_fwd(st, g, m)
                if self.schedule == "gpipe" and pf is not None:
                    pb = None           # all forwards drain first
                if pb is not None:
                    c, jb = pb
                    gyw = None if c == last else ((st.gout[c + 1][jb],))
                    meta, gx = actor.backward.options(
                        num_returns=2).remote(step, c, jb, gyw)
                    st.gout[c][jb] = gx
                    st.bwd_disp[c].add(jb)
                    st.busy[g][m] = meta
                    st.pending[meta] = _Op(g, c, m, "bwd", jb)
                elif pf is not None:
                    c, jf = pf
                    xw = (mbs[jf],) if c == 0 else ((st.act[c - 1][jf],))
                    tw = (tgts[jf],) if c == last else None
                    meta, y = actor.forward.options(
                        num_returns=2).remote(step, c, jf, xw, tw)
                    if c != last:
                        st.act[c][jf] = y
                    st.fwd_disp[c].add(jf)
                    st.busy[g][m] = meta
                    st.pending[meta] = _Op(g, c, m, "fwd", jf)

    def _poll(self, st: _StepState):
        """Consume completed op metas; raise _StageFailure on death or
        on a silent stall past the op watchdog."""
        if not st.pending:
            time.sleep(0.005)
            return
        ready, _ = self.rt.wait(list(st.pending), num_returns=1,
                                timeout=0.2)
        for r in ready:
            op = st.pending.pop(r)
            st.busy[op.gang].pop(op.member, None)
            try:
                meta = self.rt.get(r)
            except self._errors() as e:
                # TaskError rides along: under node loss a replayed op
                # can fetch a ref whose bytes died with the store — the
                # rollback path, not a user bug (a genuine user error
                # re-raises once recoveries exhaust max_failures, with
                # this exception chained as the cause).
                raise _StageFailure(op.gang, type(e).__name__) from e
            if op.kind == "fwd":
                st.fwd_done[op.chunk].add(op.mb)
                if op.chunk == self.n_chunks - 1:
                    st.losses[op.mb] = meta["loss"]
            else:
                st.bwd_done[op.chunk].add(op.mb)
        if not ready and st.pending:
            now = time.monotonic()
            stale = [op for op in st.pending.values()
                     if now - op.t > self.stage_timeout_s]
            for op in stale:
                beacons = self.groups[op.gang].beacons(timeout=5.0)
                if any(b is None for b in beacons):
                    raise _StageFailure(op.gang, "beacon_lost")
                op.t = now      # alive but slow: re-arm the watchdog

    # ------------------------------------------------------------------
    # recovery
    # ------------------------------------------------------------------

    def _probe_dead_stages(self) -> List[int]:
        dead = []
        for g, grp in enumerate(self.groups):
            if any(b is None for b in grp.beacons(timeout=5.0)):
                dead.append(g)
        return dead

    def _recovered(self, kind: str):
        self._obs.inc(f"pp_recoveries{{kind={kind}}}")

    def _recover(self, step: int, st: _StepState, failure: _StageFailure):
        """Re-form dead gangs and pick the cheapest sound recovery.

        Raises _Rollback when per-gang surgical replay is not provably
        sufficient."""
        self._recoveries += 1
        if self._recoveries > self.max_failures:
            raise RuntimeError(
                f"pipeline exceeded max_failures={self.max_failures}"
            ) from failure
        with self._obs.span("pp", "recover", step=step,
                            reason=failure.reason):
            dead = self._probe_dead_stages()
            if failure.stage not in dead:
                beacons = self.groups[failure.stage].beacons(timeout=5.0)
                if any(b is None for b in beacons):
                    dead.append(failure.stage)
            self._obs.record("pp", "stage_dead", step=step, stages=dead,
                             reason=failure.reason)
            if not dead:
                # The op failed but every gang answers (e.g. an object
                # was lost with its node): replay lineage is broken, so
                # fall back to the checkpoint intersection.
                self._recovered("rollback")
                self._rollback(step)
            for g in dead:
                version = self.groups[g].reform()
                restored = version if version is not None else 0
                if restored == step:
                    # Pre-apply params for the in-flight step: replay
                    # only this gang's chunks (surgical).
                    self._obs.record("pp", "replay", step=step, stage=g,
                                     n_micro=self.n_micro)
                    self._recovered("replay")
                    st.reset_gang(g)
                elif restored == step + 1:
                    # Died after apply+commit: nothing to replay and the
                    # boundary must not re-apply.  Done-sets read full so
                    # neighbours (which, having reached the boundary,
                    # already consumed this gang's sealed outputs) never
                    # wait on it.
                    self._recovered("already_applied")
                    st.reset_gang(g)
                    st.mark_gang_applied(g)
                else:
                    self._recovered("rollback")
                    self._rollback(step)

    def _rollback(self, step: int):
        """Load the newest step committed by ALL gangs everywhere (no
        gang restarts — survivors load in place), then unwind to `fit`."""
        per_stage = []
        for grp in self.groups:
            try:
                steps = self.rt.get(
                    grp.members[0].committed_steps.remote(), timeout=30)
            except Exception:
                grp.reform()
                steps = self.rt.get(
                    grp.members[0].committed_steps.remote(), timeout=30)
            per_stage.append(set(steps))
        common = set.intersection(*per_stage) if per_stage else set()
        target = max(common) if common else None
        if target is None:
            # Nothing commonly committed: restart from initial params.
            for grp in self.groups:
                grp.shutdown()
                grp.incarnation += 1
                grp._form()
            self._obs.record("pp", "rollback", step=step, to=0)
            raise _Rollback(0)
        refs = [a.load_ckpt.remote(target)
                for grp in self.groups for a in grp.members]
        self.rt.get(refs, timeout=120)
        self._obs.record("pp", "rollback", step=step, to=target)
        raise _Rollback(target)

    # ------------------------------------------------------------------
    # step
    # ------------------------------------------------------------------

    def _boundary(self, step: int, st: _StepState):
        """Grad fold + SGD apply + per-gang checkpoint commit, all
        version-guarded so a mid-boundary death retries cleanly."""
        partials: Dict[int, list] = {}
        metas = {}
        for g, grp in enumerate(self.groups):
            if st.applied[g]:
                continue
            partials[g] = []
            for a in grp.members:
                meta, grads = a.partial_grads.options(
                    num_returns=2).remote(step)
                partials[g].append(grads)
                metas[meta] = g
        for meta, g in metas.items():
            try:
                self.rt.get(meta, timeout=self.stage_timeout_s)
            except self._errors(timeout=True) as e:
                raise _StageFailure(
                    g, f"partial_grads:{type(e).__name__}") from e
        apply_refs: Dict[int, list] = {}
        for g, grp in enumerate(self.groups):
            if st.applied[g]:
                continue
            apply_refs[g] = [a.apply_update.remote(
                step, partials[g], self.n_micro) for a in grp.members]
        busy = idle = 0.0
        for g, refs in apply_refs.items():
            try:
                for out in self.rt.get(refs, timeout=self.stage_timeout_s):
                    busy += out.get("busy_s", 0.0)
                    idle += out.get("idle_s", 0.0)
            except self._errors(timeout=True) as e:
                raise _StageFailure(
                    g, f"apply_update:{type(e).__name__}") from e
            # This gang fully applied: a boundary retry after a later
            # gang's death must not re-enter it.
            st.applied[g] = True
        if self.storage_path and (step + 1) % self.ckpt_every == 0:
            saves = {grp.members[0].save_ckpt.remote(step + 1): g
                     for g, grp in enumerate(self.groups)}
            ex = self.rt.exceptions
            for ref, g in saves.items():
                try:
                    self.rt.get(ref, timeout=90)
                except (ex.ActorError, ex.WorkerCrashedError, ex.TaskError,
                        ex.RayTpuTimeoutError) as e:
                    raise _StageFailure(
                        g, f"save_ckpt:{type(e).__name__}") from e
        return busy, idle

    def _train_step(self, step: int, mbs, tgts) -> dict:
        st = _StepState(self.n_chunks, self.n_gangs, self.n_micro)
        t0 = time.monotonic()
        with self._obs.span("pp", "step", step=step, n_micro=self.n_micro,
                            interleave=self.v):
            while True:
                try:
                    while not st.compute_done():
                        self._dispatch(step, st, mbs, tgts)
                        self._poll(st)
                    busy, idle = self._boundary(step, st)
                    break
                except _StageFailure as f:
                    self._recover(step, st, f)
        wall = time.monotonic() - t0
        members = self.n_gangs * self.gang
        bubble = max(0.0, 1.0 - busy / (members * wall)) if wall > 0 \
            else 0.0
        self._obs.observe("pp_bubble_fraction", bubble)
        self._obs.observe("pp_step_seconds", wall)
        loss = (sum(st.losses.values()) / len(st.losses)
                if st.losses else float("nan"))
        return {"step": step, "loss": loss, "wall_s": wall,
                "bubble_fraction": bubble, "busy_s": busy, "idle_s": idle,
                "recoveries": self._recoveries}

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------

    def fit(self, data_fn: Callable[[int], Tuple[list, list]],
            num_steps: int) -> List[dict]:
        """Run `num_steps` pipeline steps.  ``data_fn(step)`` returns
        (microbatches, targets) — it must be deterministic per step,
        because a rollback re-requests earlier steps' data."""
        s = 0
        while s < num_steps:
            xs, ts = data_fn(s)
            if len(xs) != self.n_micro or len(ts) != self.n_micro:
                raise ValueError(
                    f"data_fn(step) must return {self.n_micro} "
                    f"microbatches, got {len(xs)}/{len(ts)}")
            mbs = [self.rt.put(np.asarray(x)) for x in xs]
            tgts = [self.rt.put(np.asarray(t)) for t in ts]
            try:
                rec = self._train_step(s, mbs, tgts)
            except _Rollback as rb:
                s = rb.step
                continue
            self.history.append(rec)
            s += 1
        return self.history

    def forward_only(self, xs: list, ts: list) -> float:
        """One fwd-only pass over the schedule; returns the mean loss.
        No recovery (parity/bench probe).  Leaves no per-step state."""
        st = _StepState(self.n_chunks, self.n_gangs, self.n_micro)
        mbs = [self.rt.put(np.asarray(x)) for x in xs]
        tgts = [self.rt.put(np.asarray(t)) for t in ts]
        # Forward-only wants no bwd dispatch: mark bwd complete up front.
        for c in range(self.n_chunks):
            st.bwd_disp[c] = set(range(self.n_micro))
            st.bwd_done[c] = set(range(self.n_micro))
        while not all(len(st.fwd_done[c]) == self.n_micro
                      for c in range(self.n_chunks)):
            self._dispatch(0, st, mbs, tgts)
            self._poll(st)
        self.rt.get([a.reset_step.remote(0)
                     for g in self.groups for a in g.members], timeout=60)
        return sum(st.losses.values()) / len(st.losses)

    def stage_idents(self) -> List[List[dict]]:
        return [list(grp.idents) for grp in self.groups]

    def stage_stats(self) -> List[List[dict]]:
        """Per-gang, per-member runtime stats (ops, busy/idle, receive-
        window peaks/hits) — the backpressure and overlap observables."""
        return [self.rt.get([a.stats.remote() for a in grp.members],
                            timeout=30) for grp in self.groups]

    def shutdown(self):
        for grp in self.groups:
            try:
                grp.shutdown()
            except Exception:
                pass
        self.groups = []
