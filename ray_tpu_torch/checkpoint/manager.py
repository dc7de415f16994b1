"""CheckpointManager (port of ray_tpu/checkpoint/manager.py):
step-indexed layout, retention and GC over the port's sharded saves.

Directory layout under one root (the reference's, so its trainer's
manager finds the port's saves and the port's finds the reference's):

    <root>/checkpoint_000000/   (committed)
    <root>/checkpoint_000001/   (committed)
    <root>/checkpoint_000002/   (no COMMIT marker -> torn, ignored)

Retention is the union of three sets over COMMITTED steps: the last
`keep_last_k`, the best `keep_best_k` by `best_metric` (read back from
each manifest, so keep-best survives restarts), and always the latest.
Uncommitted directories are invisible to `steps()`/`latest_step()` and
are GC'd once a committed step at or past them exists (never before —
one may be an in-flight save by a peer rank).
"""

from __future__ import annotations

import os
import re
import shutil
from typing import Any, Dict, List, Optional

from ray_tpu_torch._device import DeviceLike
from ray_tpu_torch.checkpoint import sharded
from ray_tpu_torch.checkpoint.async_writer import AsyncCheckpointer, SaveHandle
from ray_tpu_torch.util.observe import Observer

_STEP_RE = re.compile(r"^checkpoint_(\d+)$")


class CheckpointManager:
    PREFIX = "checkpoint_"

    def __init__(self, root: str, *, keep_last_k: Optional[int] = None,
                 keep_best_k: Optional[int] = None,
                 best_metric: Optional[str] = None, best_mode: str = "max",
                 save_id: str = "0", observer: Optional[Observer] = None):
        if best_mode not in ("max", "min"):
            raise ValueError(f"best_mode must be max|min, got {best_mode!r}")
        self.root = root
        self.keep_last_k = keep_last_k
        self.keep_best_k = keep_best_k
        self.best_metric = best_metric
        self.best_mode = best_mode
        self.save_id = str(save_id)
        self._ckptr = AsyncCheckpointer(observer)
        self._metrics: Dict[int, dict] = {}
        os.makedirs(root, exist_ok=True)

    # -------- layout --------

    def step_dir(self, step: int) -> str:
        return os.path.join(self.root, f"{self.PREFIX}{step:06d}")

    def _scan(self) -> Dict[int, bool]:
        """{step: committed} for every checkpoint-shaped directory."""
        out: Dict[int, bool] = {}
        try:
            names = os.listdir(self.root)
        except FileNotFoundError:
            return out
        for name in names:
            m = _STEP_RE.match(name)
            if m and os.path.isdir(os.path.join(self.root, name)):
                out[int(m.group(1))] = sharded.is_committed(
                    os.path.join(self.root, name))
        return out

    def steps(self) -> List[int]:
        """Committed steps, ascending."""
        return sorted(s for s, ok in self._scan().items() if ok)

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    # -------- save --------

    def save(self, step: int, tree: Any, *, metrics: Optional[dict] = None,
             sync: bool = False) -> SaveHandle:
        """Save `tree` as `step`: the copy to host memory now, the write
        on a thread (unless `sync`).  Force-joins the previous save
        first, so at most one write is ever in flight."""
        if metrics:
            self._metrics[int(step)] = dict(metrics)
        handle = self._ckptr.save(
            self.step_dir(step), tree, step=int(step), metrics=metrics,
            save_id=self.save_id, sync=sync)
        if sync:
            self.gc()
        return handle

    def wait_until_finished(self) -> None:
        """Barrier on the in-flight save, then retention/GC."""
        self._ckptr.wait_until_finished()
        self.gc()

    @property
    def in_flight(self) -> Optional[SaveHandle]:
        return self._ckptr.in_flight

    # -------- restore --------

    def restore(self, step: Optional[int] = None, *,
                device: DeviceLike = None) -> Any:
        """Re-materialise a committed step (default: latest) as tensors
        on `device` (None -> CUDA) — see sharded.restore_sharded."""
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(
                    f"no committed checkpoint under {self.root}")
        return sharded.restore_sharded(self.step_dir(step), device=device)

    def restore_latest(self, *, device: DeviceLike = None) -> Any:
        return self.restore(None, device=device)

    def latest_checkpoint(self) -> Optional[str]:
        """The latest committed step's directory (None if no step has
        committed).  The reference returns an air.Checkpoint over the
        same directory."""
        step = self.latest_step()
        return None if step is None else self.step_dir(step)

    def metrics_for(self, step: int) -> Optional[dict]:
        if step in self._metrics:
            return self._metrics[step]
        try:
            meta = sharded.checkpoint_metadata(self.step_dir(step))
        except (OSError, ValueError):
            return None
        self._metrics[step] = meta.get("metrics") or {}
        return self._metrics[step]

    # -------- retention / GC --------

    def _keep_set(self, committed: List[int]) -> set:
        if self.keep_last_k is None and self.best_metric is None:
            return set(committed)     # retention off: keep everything
        keep: set = set(committed[-1:])   # the latest always survives
        if self.keep_last_k is not None and self.keep_last_k > 0:
            keep.update(committed[-self.keep_last_k:])
        if self.best_metric is not None:
            scored = []
            for s in committed:
                m = self.metrics_for(s) or {}
                if self.best_metric in m:
                    scored.append((float(m[self.best_metric]), s))
            scored.sort(reverse=(self.best_mode == "max"))
            k = self.keep_best_k if self.keep_best_k is not None \
                else len(scored)
            keep.update(s for _, s in scored[:k])
        return keep

    def gc(self) -> List[int]:
        """Apply retention to committed steps and delete torn
        directories that a committed step has overtaken.  Returns the
        steps removed."""
        scan = self._scan()
        committed = sorted(s for s, ok in scan.items() if ok)
        keep = self._keep_set(committed)
        latest = committed[-1] if committed else None
        removed = []
        for step, ok in scan.items():
            doomed = (ok and step not in keep) or \
                (not ok and latest is not None and step <= latest)
            if doomed:
                shutil.rmtree(self.step_dir(step), ignore_errors=True)
                removed.append(step)
                self._metrics.pop(step, None)
        return sorted(removed)
