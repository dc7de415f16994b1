"""MPMD pipeline-parallel stage runtime: per-stage actor gangs (port of
ray_tpu/train/pipeline_stage.py, with the runtime and the Observer
injected).

Each pipeline *gang* is a group of actors under its own placement group,
running its own program.  A gang owns one or more **stage-chunks** (the
interleaved/looping schedule: gang g owns chunks ``g, g+n_gangs, ...`` —
non-adjacent, so every gang computes during warmup/drain).  Activations
and gradients cross chunks as objects of the runtime: a chunk's
``forward`` returns the activation as a second return value whose ref
the driver hands to the next chunk *wrapped in a tuple*, so the
receiving gang resolves it inside a ``pp/xfer`` span (top-level args
would be resolved by the task layer before the method body runs).

What crosses a chunk boundary is numpy, as in the reference: a tensor
output is copied to the host (`to_host`), bf16 as f32 (numpy has no
bf16; bf16 -> f32 -> bf16 is exact), and the consumer's stage function
moves it back to its own device.  Params stay where they were given:
tensors on their device, updated in place by SGD; numpy params as
numpy, updated as the reference updates them.

**Pre-pushed activations** take the transfer off the critical path: the
driver ships a sealed activation ref to the consumer's ``prefetch``
method the moment the producer's forward completes; ``prefetch``
resolves it inside a ``pp/xfer_overlap`` span and parks the bytes in a
bounded **double-buffered receive window**; the consumer's ``forward``
then takes the resident copy, waits inside ``pp/recv_wait`` if the
prefetch is still in flight, or falls back to the blocking ``pp/xfer``
fetch if nothing was pushed.

Robustness contract: a gang dying must not tear down the pipeline.  All
state a gang holds falls into three recovery classes:

- **params / optimizer version** — recovered from the gang's own
  checkpoint (`ray_tpu_torch.checkpoint`, COMMITTED steps only; one
  tree holding every owned chunk's params);
- **autograd graphs + per-microbatch grad contributions + the receive
  window** — process-local and unrecoverable, so the driver replays
  exactly the current step's microbatches through the re-formed gang,
  re-feeding (and re-pushing) the upstream chunks' still-sealed outputs;
- **activations already shipped downstream** — held by the runtime's
  object plane, which outlives the worker, so downstream chunks never
  recompute.

Grad contributions are kept **per chunk, per microbatch** and summed in
sorted microbatch order at update time, so a replayed (or interleaved)
schedule folds to bit-identical gradients regardless of completion
order.

The stage fns are framework-agnostic plain callables (cloudpickled to
the gang):

    stage_fwd(params, x)            -> (y, cache)
    stage_bwd(params, cache, gy)    -> (gx, gparams)
    loss_fwd(y, target)             -> (loss, lcache)
    loss_bwd(lcache)                -> gy

`pipeline_trainer.torch_stage_fns` builds the quartet from a torch
``stage_fn``/``loss_fn`` pair with autograd.

The runtime handle (the `ray_tpu` module, or any object with its
`remote`, `get`, `wait`, `put`, `kill`, `ObjectRef`, `exceptions` and
`util.placement_group` / `util.remove_placement_group`) reaches the
actors through their spec.  The Observer records the reference's spans
and events under the same (plane, kind) pairs; a metric the reference
tags is named ``name{key=value}``.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ray_tpu_torch.util.observe import NOOP


def tree_map(fn: Callable, *trees):
    """jax.tree.map for the dict/list/tuple/leaf pytrees pipeline params
    use."""
    t0 = trees[0]
    if isinstance(t0, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in t0}
    if isinstance(t0, (list, tuple)):
        seq = [tree_map(fn, *(t[i] for t in trees)) for i in range(len(t0))]
        return type(t0)(seq) if isinstance(t0, list) else tuple(seq)
    return fn(*trees)


def tree_add(a, b):
    return tree_map(lambda x, y: x + y, a, b)


def to_host(leaf):
    """One leaf as it crosses a chunk boundary: a tensor copied to a
    numpy array (bf16 as f32), anything else through np.asarray; None
    (no gradient) stays None."""
    if leaf is None:
        return None
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy()
    return np.asarray(leaf)


def _own(leaf):
    """The actor's own copy of a param leaf: a tensor cloned on its
    device (SGD updates it in place), numpy as the reference keeps it."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().clone()
    return np.asarray(leaf)


def _bank(leaf):
    return leaf if isinstance(leaf, torch.Tensor) else np.asarray(leaf)


def _sgd(lr: float, scale: float):
    def step(p, g):
        if isinstance(p, torch.Tensor):
            return p.sub_(lr * (torch.as_tensor(g).to(p.device) * scale))
        return p - lr * (g * scale)
    return step


def _first_tensor(tree) -> Optional[torch.Tensor]:
    found = []
    tree_map(lambda t: found.append(t) if isinstance(t, torch.Tensor)
             else None, tree)
    return found[0] if found else None


class PipelineStageActor:
    """One member of one gang: a plain class, bound by `StageGroup` with
    the runtime's `remote(...)`.

    Methods that compute (`forward`/`backward`/`partial_grads`/
    `apply_update`) are dispatched at most one-at-a-time per member by
    the driver; `beacon`/`stats`/`prefetch` ride the actor's spare
    concurrency threads so liveness probes answer — and pre-pushed
    activations resolve — mid-compute."""

    def setup(self, spec: dict) -> bool:
        self.stage = int(spec["stage"])          # gang index
        self.n_stages = int(spec["n_stages"])    # total chunks end-to-end
        self.member = int(spec["member"])
        self.gang = int(spec["gang"])
        self.incarnation = int(spec.get("incarnation", 0))
        self.rt = spec["runtime"]
        self._obs = spec.get("observer") or NOOP
        chunks = spec.get("chunks")
        if chunks is None:
            # Single-chunk legacy spec: the gang index IS the chunk.
            self.chunks = [self.stage]
            params = {self.stage: spec["params"]}
        else:
            self.chunks = sorted(int(c) for c in chunks)
            params = {int(c): t for c, t in spec["params"].items()}
        self._fwd = spec["stage_fwd"]
        self._bwd = spec["stage_bwd"]
        self._loss_fwd = spec.get("loss_fwd")
        self._loss_bwd = spec.get("loss_bwd")
        self.lr = float(spec["lr"])
        self.params = {c: tree_map(_own, params[c]) for c in self.chunks}
        first = _first_tensor(self.params)
        # Where a checkpoint restores to: the params' device, or numpy.
        self._device = first.device if first is not None else None
        self.version = 0
        self._ckpt_mgr = None
        root = spec.get("ckpt_root") or ""
        if root:
            from ray_tpu_torch.checkpoint import CheckpointManager
            self._ckpt_mgr = CheckpointManager(
                root, keep_last_k=int(spec.get("keep_last_k", 8)),
                save_id=f"s{self.stage}m{self.member}i{self.incarnation}",
                observer=self._obs)
        # Per-step state: autograd caches keyed (chunk, mb) + per-chunk
        # per-microbatch grad contributions.
        self._caches: Dict[Tuple[int, int], Any] = {}
        self._grads: Dict[int, Dict[int, Any]] = {c: {} for c in self.chunks}
        self._losses: Dict[int, float] = {}
        self._partial_cache = None
        # Double-buffered receive window: pre-pushed activations keyed
        # (step, chunk, mb).  prefetch() threads produce, forward()
        # consumes; the condition serializes the hand-off.  Consumed
        # keys are remembered so a late prefetch (forward already fell
        # back to the blocking fetch) is discarded, not leaked.
        self._recv_cv = threading.Condition()
        self._recv: Dict[Tuple[int, int, int], Any] = {}
        self._recv_pending: set = set()
        self._recv_err: Dict[Tuple[int, int, int], BaseException] = {}
        self._recv_consumed: set = set()
        self._recv_peak = 0
        self._recv_hits = 0
        self._recv_waits = 0
        self._recv_misses = 0
        self._prefetch_discards = 0
        self._recv_wait_timeout_s = float(
            spec.get("recv_wait_timeout_s", 30.0))
        # Bubble/stall accounting: gaps between ops inside one step.
        self._last_op_end = time.monotonic()
        self._busy_s = 0.0
        self._idle_s = 0.0
        self._ops = 0
        return True

    # ---------------- liveness / identity ----------------

    def beacon(self) -> dict:
        return {"stage": self.stage, "member": self.member,
                "version": self.version, "ops": self._ops,
                "age_s": time.monotonic() - self._last_op_end}

    def ident(self) -> dict:
        import os
        return {"pid": os.getpid(),
                "node_id": os.environ.get("RAY_TPU_NODE_ID", ""),
                "salt": os.environ.get("RAY_TPU_CHAOS_PROC_SALT", "")}

    def stats(self) -> dict:
        return {"stage": self.stage, "member": self.member,
                "busy_s": self._busy_s, "idle_s": self._idle_s,
                "ops": self._ops, "version": self.version,
                "chunks": list(self.chunks),
                "recv_peak": self._recv_peak,
                "recv_hits": self._recv_hits,
                "recv_waits": self._recv_waits,
                "recv_misses": self._recv_misses,
                "prefetch_discards": self._prefetch_discards}

    # ---------------- op bookkeeping ----------------

    def _op_begin(self) -> float:
        now = time.monotonic()
        gap = now - self._last_op_end
        if gap > 1e-4:
            self._idle_s += gap
            self._obs.record("pp", "bubble", stage=self.stage,
                             member=self.member, idle_s=round(gap, 6))
        return now

    def _op_end(self, t0: float) -> None:
        now = time.monotonic()
        self._busy_s += now - t0
        self._last_op_end = now
        self._ops += 1

    def _fetch(self, wrapped, what: str, chunk: Optional[int] = None):
        """Resolve a tuple-wrapped ref (or pass a raw value through)
        inside a pp/xfer span — the *blocking* inter-stage hop (the
        prefetch path resolves inside pp/xfer_overlap instead)."""
        if wrapped is None:
            return None
        (ref,) = wrapped
        if not isinstance(ref, self.rt.ObjectRef):
            return ref
        with self._obs.span("pp", "xfer", stage=self.stage, what=what,
                            chunk=chunk):
            return self.rt.get(ref)

    # ---------------- pre-pushed receive window ----------------

    def prefetch(self, step: int, chunk: int, mb: int, xw) -> dict:
        """Resolve a pre-pushed activation ref into the receive window.

        Runs on a spare concurrency thread while forward/backward
        compute on another.  Errors (e.g. the object died with a node)
        are parked for the consuming forward to re-raise — the driver's
        recovery then runs exactly as it would for a blocking-fetch
        failure."""
        key = (int(step), int(chunk), int(mb))
        with self._recv_cv:
            if (key in self._recv_consumed or key in self._recv
                    or key in self._recv_pending):
                # Late push after the consumer fell back to a blocking
                # fetch, or a replay re-push of a still-resident entry:
                # drop it (the sealed bytes are identical either way).
                self._prefetch_discards += 1
                return {"stored": False}
            self._recv_pending.add(key)
        val = err = None
        try:
            (ref,) = xw
            if isinstance(ref, self.rt.ObjectRef):
                with self._obs.span("pp", "xfer_overlap", stage=self.stage,
                                    chunk=chunk, mb=mb):
                    val = self.rt.get(ref)
            else:
                val = ref
        except BaseException as e:       # parked, re-raised by forward
            err = e
        with self._recv_cv:
            self._recv_pending.discard(key)
            if key in self._recv_consumed:
                self._prefetch_discards += 1
            elif err is not None:
                self._recv_err[key] = err
            else:
                self._recv[key] = val
                # Peak residency per CHUNK — the observable the
                # backpressure bound governs (<= recv_window, +1 while
                # a consuming forward is mid-execution).
                depth = sum(1 for k in self._recv if k[1] == key[1])
                self._recv_peak = max(self._recv_peak, depth)
            self._recv_cv.notify_all()
        return {"stored": err is None}

    def _take_recv(self, step: int, chunk: int, mb: int, wrapped,
                   what: str):
        """Consume a pre-pushed activation if one is resident (or in
        flight, waiting inside pp/recv_wait); otherwise fall back to the
        blocking pp/xfer fetch of `wrapped`."""
        key = (step, chunk, mb)
        with self._recv_cv:
            if key not in self._recv and key not in self._recv_err \
                    and key in self._recv_pending:
                # Prefetch raced us: wait bounded — a wedged prefetch
                # degrades to the blocking fetch instead of deadlocking
                # the compute thread.
                self._recv_waits += 1
                tok = self._obs.begin("pp", "recv_wait", stage=self.stage,
                                      chunk=chunk, mb=mb)
                deadline = time.monotonic() + self._recv_wait_timeout_s
                while key in self._recv_pending \
                        and time.monotonic() < deadline:
                    self._recv_cv.wait(timeout=0.25)
                self._obs.end(tok)
            if key in self._recv:
                self._recv_hits += 1
                self._recv_consumed.add(key)
                return self._recv.pop(key)
            if key in self._recv_err:
                self._recv_consumed.add(key)
                raise self._recv_err.pop(key)
            self._recv_consumed.add(key)
            self._recv_misses += 1
        return self._fetch(wrapped, what, chunk=chunk)

    def _clear_recv(self):
        with self._recv_cv:
            self._recv.clear()
            self._recv_err.clear()
            self._recv_consumed.clear()
            # In-flight prefetches re-park after this clear; they are
            # keyed by (step, chunk, mb), so a stale entry can never be
            # consumed by a later step and the next clear drops it.

    def _drop_step_state(self):
        self._caches.clear()
        self._grads = {c: {} for c in self.chunks}
        self._losses.clear()

    # ---------------- compute ----------------

    def forward(self, step: int, chunk: int, mb: int, xw, tw=None):
        """One microbatch through one owned chunk.  Returns
        (meta, activation); the last chunk computes the loss chain
        instead and carries the scalar in meta (its second return is
        None)."""
        chunk = int(chunk)
        t0 = self._op_begin()
        x = self._take_recv(step, chunk, mb, xw, "act")
        last = chunk == self.n_stages - 1
        with self._obs.span("pp", "stage_fwd", stage=self.stage,
                            chunk=chunk, mb=mb, step=step):
            y, cache = self._fwd(self.params[chunk], x)
            if last:
                target = self._fetch(tw, "target", chunk=chunk)
                loss, lcache = self._loss_fwd(y, target)
                self._caches[(chunk, mb)] = (cache, lcache)
                self._losses[mb] = float(loss)
                self._op_end(t0)
                return ({"mb": mb, "step": step, "chunk": chunk,
                         "loss": float(loss), "version": self.version},
                        None)
        self._caches[(chunk, mb)] = cache
        out = tree_map(to_host, y)
        self._op_end(t0)
        return ({"mb": mb, "step": step, "chunk": chunk,
                 "version": self.version}, out)

    def backward(self, step: int, chunk: int, mb: int, gyw=None):
        """Backward for one microbatch through one owned chunk: consumes
        the forward's cache, banks this (chunk, microbatch) param-grad
        contribution, and returns (meta, gx) — gx is the grad this chunk
        sends upstream."""
        chunk = int(chunk)
        t0 = self._op_begin()
        if (chunk, mb) not in self._caches:
            raise RuntimeError(
                f"gang {self.stage} has no forward cache for chunk "
                f"{chunk} microbatch {mb} (step {step}) — forward must "
                f"replay first")
        with self._obs.span("pp", "stage_bwd", stage=self.stage,
                            chunk=chunk, mb=mb, step=step):
            if chunk == self.n_stages - 1:
                cache, lcache = self._caches.pop((chunk, mb))
                gy = self._loss_bwd(lcache)
            else:
                cache = self._caches.pop((chunk, mb))
                gy = self._fetch(gyw, "grad", chunk=chunk)
            gx, gparams = self._bwd(self.params[chunk], cache, gy)
        self._grads[chunk][mb] = tree_map(_bank, gparams)
        out = tree_map(to_host, gx)
        self._op_end(t0)
        return ({"mb": mb, "step": step, "chunk": chunk,
                 "version": self.version}, out)

    def partial_grads(self, step: int):
        """This member's summed grad contribution per owned chunk, each
        in sorted microbatch order (replay- and interleave-order
        independent).  Returns (meta, {chunk: grad_tree}).

        The sum is cached per step and survives apply_update: if the
        update boundary dies partway (some members applied, grads
        cleared), the retry still fetches identical partials from every
        member, so params never diverge across the gang."""
        if self._partial_cache is not None \
                and self._partial_cache[0] == step:
            totals = self._partial_cache[1]
            return ({"stage": self.stage, "member": self.member,
                     "step": step, "cached": True}, totals)
        t0 = self._op_begin()
        totals: Dict[int, Any] = {}
        for c in self.chunks:
            got = self._grads[c]
            if not got:
                raise RuntimeError(
                    f"gang {self.stage} member {self.member} has no grad "
                    f"contributions for chunk {c} at step {step}")
            order = sorted(got)
            total = got[order[0]]
            for j in order[1:]:
                total = tree_add(total, got[j])
            totals[c] = total
        self._partial_cache = (step, totals)
        self._op_end(t0)
        n = sum(len(self._grads[c]) for c in self.chunks)
        return ({"stage": self.stage, "member": self.member, "step": step,
                 "n_micro": n}, totals)

    def apply_update(self, step: int, grad_refs, n_micro: int) -> dict:
        """Fold the gang's partial grads (in member order — every member
        computes the identical per-chunk sum, so params stay replicated)
        and take one SGD step per owned chunk (tensors in place).
        Version-guarded: a retry after this member already applied is a
        no-op, so recovery can never double-apply."""
        if self.version >= step + 1:
            return {"stage": self.stage, "member": self.member,
                    "version": self.version, "applied": False}
        t0 = self._op_begin()
        with self._obs.span("pp", "apply", stage=self.stage, step=step):
            totals = None
            for ref in grad_refs:
                g = self._fetch((ref,), "partial_grads")
                totals = g if totals is None else \
                    {c: tree_add(totals[c], g[c]) for c in totals}
            sgd = _sgd(self.lr, 1.0 / float(n_micro))
            for c in self.chunks:
                self.params[c] = tree_map(sgd, self.params[c], totals[c])
        self.version = step + 1
        self._drop_step_state()
        self._clear_recv()
        self._obs.observe(f"pp_stage_stall_seconds{{stage={self.stage}}}",
                          self._idle_s)
        self._op_end(t0)
        busy, idle = self._busy_s, self._idle_s
        # Busy/idle are per-step: the driver derives the step's bubble
        # fraction from these, so reset at the update boundary.
        self._busy_s = 0.0
        self._idle_s = 0.0
        return {"stage": self.stage, "member": self.member,
                "version": self.version, "applied": True,
                "busy_s": busy, "idle_s": idle}

    def reset_step(self, step: int) -> bool:
        """Drop per-step state (rollback support: the step will replay)."""
        self._drop_step_state()
        self._partial_cache = None
        self._clear_recv()
        return True

    def reset_stats(self) -> dict:
        out = self.stats()
        self._busy_s = 0.0
        self._idle_s = 0.0
        self._last_op_end = time.monotonic()
        return out

    # ---------------- checkpoint ----------------

    def save_ckpt(self, step: int) -> bool:
        """Commit this gang's params+version as `step` (leader member
        only; params are replicated across the gang; one tree carries
        every owned chunk).  Waits for the COMMIT marker so the driver's
        boundary is durable."""
        if self._ckpt_mgr is None:
            return False
        with self._obs.span("pp", "ckpt", stage=self.stage, step=step):
            h = self._ckpt_mgr.save(
                step, {"params": {str(c): self.params[c]
                                  for c in self.chunks},
                       "version": self.version})
            h.wait(60)
        return True

    def load_ckpt(self, step: Optional[int] = None) -> Optional[int]:
        """Restore params+version from the latest COMMITTED step (or an
        exact step), onto the params' device (numpy params as numpy).
        Returns the restored version, or None when nothing committed
        exists (caller falls back to initial params)."""
        if self._ckpt_mgr is None:
            return None
        target = step if step is not None else self._ckpt_mgr.latest_step()
        if target is None or target not in self._ckpt_mgr.steps():
            return None
        # Drop this step's graphs and banked grads before the restored
        # copy lands beside the live params.
        self._drop_step_state()
        self._partial_cache = None
        self._clear_recv()
        if self._device is not None:
            tree = self._ckpt_mgr.restore(target, device=self._device)
        else:
            tree = tree_map(lambda t: t.numpy() if isinstance(
                t, torch.Tensor) else t,
                self._ckpt_mgr.restore(target, device="cpu"))
        p = tree["params"]
        if isinstance(p, dict) and set(p) == {str(c) for c in self.chunks}:
            self.params = {c: p[str(c)] for c in self.chunks}
        else:                            # single-chunk legacy tree
            self.params = {self.chunks[0]: p}
        self.version = int(tree["version"])
        return self.version

    def committed_steps(self) -> List[int]:
        if self._ckpt_mgr is None:
            return []
        return self._ckpt_mgr.steps()


class StageGroup:
    """One gang's actors under one placement group.

    PG reserve -> actor construction -> identity resolution, with
    partial-failure cleanup: a half-built gang removes its just-created
    PG before re-raising, so elastic restarts can never leak
    reservations.  `reform()` builds a fresh gang (new PG, new actors),
    bumps the incarnation so checkpoint save_ids never alias a dead
    gang's torn markers, and restores from the gang's latest COMMITTED
    checkpoint.

    Topology-aware placement rides `resources_per_worker`: the trainer
    merges a per-gang slice resource (e.g. ``{"pp_slice_0": 1}``, from
    `parallel.mesh.pipeline_placement_resources`) into the bundle specs.
    `runtime` is the handle every call goes through (see the module
    docstring)."""

    def __init__(self, stage: int, spec: dict, gang: int,
                 resources_per_worker: dict,
                 placement_strategy: str = "PACK",
                 pg_timeout_s: float = 60.0, *, runtime: Any):
        self.stage = stage
        self.spec = dict(spec)
        self.gang = int(gang)
        self.resources = dict(resources_per_worker or {"CPU": 1})
        self.strategy = placement_strategy
        self.pg_timeout_s = pg_timeout_s
        self.rt = runtime
        self.incarnation = 0
        self._pg = None
        self.members: List[Any] = []
        self.idents: List[dict] = []
        self._form()

    def _form(self):
        rt = self.rt
        pg = None
        members: List[Any] = []
        try:
            pg = rt.util.placement_group(
                [dict(self.resources) for _ in range(self.gang)],
                strategy=self.strategy)
            if not pg.wait(self.pg_timeout_s):
                raise RuntimeError(
                    f"stage {self.stage}: could not reserve {self.gang} x "
                    f"{self.resources} within {self.pg_timeout_s:g}s")
            res = dict(self.resources)
            cpu = res.pop("CPU", 0)
            tpu = res.pop("TPU", None)
            # max_concurrency covers 1 compute op + the double-buffered
            # prefetch resolves per owned chunk + beacon probes.
            cls = rt.remote(num_cpus=cpu, num_tpus=tpu,
                            resources=res or None,
                            max_concurrency=8)(PipelineStageActor)
            for m in range(self.gang):
                members.append(cls.options(
                    placement_group=pg,
                    placement_group_bundle_index=m).remote())
            spec = dict(self.spec)
            spec["gang"] = self.gang
            spec["incarnation"] = self.incarnation
            spec["runtime"] = rt
            refs = []
            for m, actor in enumerate(members):
                s = dict(spec)
                s["member"] = m
                refs.append(actor.setup.remote(s))
            rt.get(refs, timeout=120)
            self.idents = rt.get(
                [a.ident.remote() for a in members], timeout=60)
        except BaseException:
            # Partial-failure hygiene: kill whatever booted and remove
            # the PG reservation before re-raising.
            for a in members:
                try:
                    rt.kill(a)
                except Exception:
                    pass
            if pg is not None:
                try:
                    rt.util.remove_placement_group(pg)
                except Exception:
                    pass
            raise
        self._pg = pg
        self.members = members

    def reform(self) -> Optional[int]:
        """Tear down and rebuild this gang in place; restore from the
        gang's latest COMMITTED checkpoint.  Returns the restored
        version (None = nothing committed; members hold initial params)."""
        rt = self.rt
        self.shutdown()
        self.incarnation += 1
        self._form()
        versions = rt.get(
            [a.load_ckpt.remote() for a in self.members], timeout=120)
        vs = {v for v in versions}
        if len(vs) != 1:
            # Members disagree (a commit raced a member's scan): converge
            # on the lowest common committed version.
            steps = rt.get(
                [a.committed_steps.remote() for a in self.members],
                timeout=60)
            common = set(steps[0]).intersection(*map(set, steps[1:])) \
                if steps else set()
            if not common:
                return None
            tgt = max(common)
            rt.get([a.load_ckpt.remote(tgt) for a in self.members],
                   timeout=120)
            return tgt
        return vs.pop()

    def beacons(self, timeout: float = 5.0) -> List[Optional[dict]]:
        """Best-effort liveness snapshot; None per member that did not
        answer (dead, or wedged past the probe timeout)."""
        rt = self.rt
        refs = {a.beacon.remote(): m for m, a in enumerate(self.members)}
        out: List[Optional[dict]] = [None] * len(self.members)
        ready, _ = rt.wait(list(refs), num_returns=len(refs),
                           timeout=timeout)
        for r in ready:
            try:
                out[refs[r]] = rt.get(r)
            except Exception:
                pass
        return out

    def shutdown(self):
        for a in self.members:
            try:
                self.rt.kill(a)
            except Exception:
                pass
        self.members = []
        self.idents = []
        if self._pg is not None:
            try:
                self.rt.util.remove_placement_group(self._pg)
            except Exception:
                pass
            self._pg = None
