"""A learner group: k data-parallel learners, one per rank of a
`RankGang` (Ray's rllib/core/learner/learner_group.py: a fleet of
data-parallel learners).  The reference runs its learner as one SPMD
program over the mesh's `data` axis; here each rank builds the learner
under a DeviceMesh of `data` = k and the learner averages its gradients
over that axis (`learner.DataParallel`).

`LearnerGroup(make, k, device=...)` starts the gang and builds
`make(mesh=..., device=...)` on every rank; it offers the learner's
interface: `update` sends the batch to every rank and returns rank 0's
metrics, `get_weights` / `get_state` come from rank 0, `set_weights` /
`set_state` go to every rank, and `num_updates` counts the updates.
Its calls run one at a time (the gang's lock), so IMPALA's learner
thread and the algorithm's reads of the weights take turns.  `stop()` ends
the ranks.  `learner_for` is what the algorithms call with the config's
`learner_mesh`.

What crosses to the ranks is pickled, and a rank imports neither optax
nor JAX: a state's optax look-alikes (`convert.ScaleByAdamState`, ...)
pickle as the port's own, and a state or weights given to `set_state`
/ `set_weights` go with every namedtuple as a plain tuple (the learners
read either), so optax's own types, from a reference checkpoint, stay
on the caller's side.
"""

from __future__ import annotations

import functools
import shutil
import tempfile
from typing import Any, Callable, Dict

from ray_tpu_torch._device import DeviceLike, resolve_device
from ray_tpu_torch.parallel.launch import RankGang
from ray_tpu_torch.parallel.mesh import MeshConfig
from ray_tpu_torch.rllib.learner import learner_mesh_sizes

# A call's limit: a learner's first call builds it (the ranks' start
# and imports included).
LEARNER_TIMEOUT_S = 900.0


def _tuples(tree):
    """`tree` with every tuple (a namedtuple too) as a plain tuple."""
    if isinstance(tree, dict):
        return {k: _tuples(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_tuples(v) for v in tree)
    if isinstance(tree, list):
        return [_tuples(v) for v in tree]
    return tree


def _build(rank: int, world_size: int, state: dict, make: Callable,
           device: str) -> None:
    from ray_tpu_torch.parallel.mesh import create_mesh

    mesh = create_mesh(MeshConfig(data=world_size), device=device)
    state["learner"] = make(mesh=mesh, device=device)


def _method(rank: int, world_size: int, state: dict, name: str, *args):
    return getattr(state["learner"], name)(*args)


class LearnerGroup:
    """`k` learners `make(mesh=, device=)`, data-parallel over `data`,
    behind the learner's interface (see the module docstring)."""

    def __init__(self, make: Callable, k: int, *, device: DeviceLike = None,
                 timeout_s: float = LEARNER_TIMEOUT_S):
        dev = resolve_device(device)
        self.k = k
        self.num_updates = 0
        self._dir = tempfile.mkdtemp(prefix="learner_group-")
        self.gang = RankGang(k, device=dev, init_dir=self._dir,
                             timeout_s=timeout_s)
        try:
            self.gang.call(_build, make, dev.type)
        except BaseException:
            self.stop()
            raise

    def _all(self, name: str, *args) -> list:
        return self.gang.call(_method, name, *args)

    def update(self, batch) -> Dict[str, float]:
        metrics = self._all("update", batch)[0]
        self.num_updates += 1
        return metrics

    def get_weights(self):
        return self._all("get_weights")[0]

    def set_weights(self, weights) -> None:
        self._all("set_weights", _tuples(weights))

    def get_state(self) -> Dict[str, Any]:
        return self._all("get_state")[0]

    def set_state(self, state: Dict[str, Any]) -> None:
        self._all("set_state", _tuples(state))

    def stop(self) -> None:
        self.gang.close()
        shutil.rmtree(self._dir, ignore_errors=True)


def learner_for(cls, *args, mesh=None, device: DeviceLike = None,
                **kwargs):
    """`cls(*args, mesh=mesh, device=device, **kwargs)` when `mesh` is
    one device (None, or every axis 1), else a `LearnerGroup` of
    `data` such learners."""
    k = 1 if mesh is None else learner_mesh_sizes(mesh).get("data", 1)
    if k == 1:
        return cls(*args, mesh=None, device=device, **kwargs)
    return LearnerGroup(functools.partial(cls, *args, **kwargs), k,
                        device=device)


def picklable_config(cfg) -> Any:
    """A copy of an algorithm config without what a rank cannot receive
    or needs not: the runtime handle, the observer and the mapping
    function."""
    import copy

    out = copy.copy(cfg)
    out.runtime = out.observer = out.policy_mapping_fn = None
    return out

