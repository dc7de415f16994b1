"""Shared train-step factory for the functional LM families (port of
ray_tpu/models/_functional.py), and what the families' modules share
besides: the engine's working copy of the params, the mesh checks and
the mesh plan of the forward.

The reference's contract: `init_state` gives {"params", "opt_state",
"step"} and `train_step(state, batch)` gives (state, {"loss"}).  JAX's
step is a pure function; here the parameters and the optimizer's
moments are updated in place (the returned state holds the same
tensors), which saves a second copy of both.

Under a mesh of data, fsdp, expert, seq, tensor and stage
(`make_train_step(mesh=...)`) the params are DTensors placed by
`tree_shardings(mesh, param_specs)`, and AdamW's moments, made like
them, take the same placements.  Each rank computes on its local
shards, and `MeshPlan` puts in the collectives that GSPMD puts into the
reference's program: a parameter sharded over fsdp is gathered where
it is used (its gradient reduce-scattered in the backward), the
tensor-parallel products sum their partial outputs over `tensor`, the
embedding looks tokens up in the rank's vocab slice, attention over a
seq axis is `ring_attention` at the rank's absolute positions, the
Switch MoE computes the rank's experts' slots and sums them over
`expert` and `tensor`, and after the backward each gradient is summed
over the row axes that its parameter is not sharded over.  The rows of
a batch split over (data, fsdp) and their length over seq.  Rows of any
count split as GSPMD pads them (`sharding.row_split`): each row rank
holds ceil(B / (data x fsdp)) rows, its real rows first and pad rows
(token 0) after them, so every rank has the same shapes (every
collective stays even, and no kernel sees an empty batch); a rank may
hold pad rows only, and still joins every collective.  The pad rows
weigh nothing: their targets are masked, the Switch MoE neither counts
nor queues them, and the means take the global real tokens.  Under seq
above 1 the rows and the length must split evenly (the ring's blocks),
as the reference's `shard_map` requires.  No leaf and
no batch dim maps to `stage` (as in the reference, whose GSPMD step is
then replicated over it): stage ranks are replicas that hold the same
rows and params, and no gradient is summed over them.
`OneDevice` is the same interface with no collective, so the families'
forward is one code path.

Under remat (`config.remat`) the families' trunks hand each
checkpointed block the rank's own slices of its layer's leaves, and the
block gathers them over fsdp itself (`MeshPlan.layer`): the gathered
weights live only while the block runs, in the forward and again in
the recompute of the backward, whose graph alone carries the gather's
backward (the reduce-scatter, once a step).  A rank so holds its
shards and one layer gathered at a time, the program that the
reference's `jax.checkpoint` inside its `lax.scan` gives under GSPMD
(ZeRO-3).  The tensor all-reduces and the ring inside a block are
recomputed with it.  The collectives of a recompute pair up across
ranks only because every rank recomputes the same layers in the same
order: the backward walks the layers last to first on every rank,
whose graphs are alike (the same blocks, the same collectives).
Without remat the gathers stay outside the block, as before.

`init_state` under a mesh draws the params shard-wise: the family's
`init_params` draws each leaf whole, in the order and from the
generator stream of the single-device init, and hands it to
`MeshPlan.init_leaf`, which keeps the rank's slice (a copy) before the
next leaf is drawn, so a rank holds its shards and at most one whole
leaf.  The shards are bit-equal to slices of the single-device init.
The generator is the caller's (`init_state(key)`): an int seeds a CPU
generator, the stream the tests hold; a CUDA generator draws on the
card, much faster at 7B, and gives the same values to a single-device
init that draws from a CUDA generator of the same seed.
"""

from __future__ import annotations

import copy
import dataclasses
import math
from typing import Optional, Union

import torch

from ray_tpu_torch._device import DeviceLike, resolve_device
from ray_tpu_torch.ops.attention import flash_attention
from ray_tpu_torch.ops.cross_entropy import ROW_AXES
from ray_tpu_torch.ops.ring_attention import ring_attention
from ray_tpu_torch.parallel import collectives
from ray_tpu_torch.parallel.mesh import axis_sizes
from ray_tpu_torch.parallel.sharding import (
    BATCH_AXES, _entry_axes, _is_spec, local_index, logical_to_spec,
    mesh_device, pad_rows, redistribute, row_split, spec_axes, tree_map,
    tree_shardings)


@dataclasses.dataclass(frozen=True)
class AdamW:
    """`optax.adamw`'s update: decoupled weight decay on every leaf,
    eps outside the square root, bias-corrected moments.  torch's AdamW
    computes the same update; only its default decay (1e-2) differs."""
    learning_rate: float
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 1e-4

    def init(self, params: dict):
        """A torch AdamW over the leaves of `params`; over DTensor leaves,
        a `ShardedAdamW`."""
        from torch.distributed.tensor import DTensor

        leaves = _leaves(params)
        kw = dict(lr=self.learning_rate, betas=(self.b1, self.b2),
                  eps=self.eps, weight_decay=self.weight_decay,
                  fused=leaves[0].is_cuda)
        if isinstance(leaves[0], DTensor):
            return ShardedAdamW(leaves, **kw)
        return torch.optim.AdamW(leaves, **kw)


class ShardedAdamW:
    """torch's AdamW stepping the local shards of DTensor parameters in
    place (the DTensors see the update: they share the storage).  AdamW
    is elementwise, so each rank's step on its shards is the step on the
    whole; DTensor's own dispatch of the fused op, on its first call,
    enumerates placement strategies over the six mesh axes for every
    tensor of the call, which takes minutes.  `moments()` gives the
    first and second moments as DTensors laid out like their
    parameters."""

    def __init__(self, params: list, **kw):
        self.params = params
        with torch.no_grad():
            self.shards = [p.to_local() for p in params]
        self.optimizer = torch.optim.AdamW(self.shards, **kw)

    def zero_grad(self, set_to_none: bool = True) -> None:
        for p in self.params:
            p.grad = None
        self.optimizer.zero_grad(set_to_none=True)

    def step(self) -> None:
        with torch.no_grad():
            for p, shard in zip(self.params, self.shards):
                shard.grad = None if p.grad is None else p.grad.to_local()
        self.optimizer.step()

    def moments(self) -> list:
        """[(exp_avg, exp_avg_sq)] per parameter, as DTensors."""
        from torch.distributed.tensor import DTensor

        out = []
        for p, shard in zip(self.params, self.shards):
            st = self.optimizer.state[shard]
            out.append(tuple(DTensor.from_local(
                st[k], p.device_mesh, p.placements, run_check=False,
                shape=p.shape, stride=p.stride())
                for k in ("exp_avg", "exp_avg_sq")))
        return out


def adamw(learning_rate: float, b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8, weight_decay: float = 1e-4) -> AdamW:
    """AdamW with `optax.adamw`'s defaults (weight_decay 1e-4)."""
    return AdamW(learning_rate, b1, b2, eps, weight_decay)


def _leaves(tree: dict) -> list:
    out = []
    for v in tree.values():
        out.extend(_leaves(v) if isinstance(v, dict) else [v])
    return out


def _map(tree: dict, fn) -> dict:
    return {k: _map(v, fn) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def working_params(params: dict, dtype: torch.dtype, matmul_keys,
                   device: DeviceLike = None) -> dict:
    """The serving engine's copy of `params` on `device`, with every leaf
    named in `matmul_keys` (weights the forward only uses cast to the
    activation dtype: matmul weights and embedding tables) cast to
    `dtype` ONCE here, and every other leaf (the norms' scales and
    biases, which the forward mixes in at fp32) kept as it is.

    Casting fp32 -> bf16 once gives the same bits as the per-call
    `.to(h.dtype)` in the forward (which is then a no-op), so the numbers
    do not change."""
    device = resolve_device(device)
    return {k: working_params(v, dtype, matmul_keys, device)
            if isinstance(v, dict) else
            v.to(device=device, dtype=dtype if k in matmul_keys else v.dtype)
            for k, v in params.items()}


def multi_device(mesh) -> bool:
    return mesh is not None and any(s > 1 for s in
                                    axis_sizes(mesh).values())


def check_mesh_rows(mesh, shape) -> None:
    """A batch of `shape` [B, L, ...] under a mesh with seq above 1: the
    ring's blocks need the rows to split evenly over (data, fsdp) and the
    length over seq, as the reference's `shard_map` does; either raises
    ValueError here, before any collective.  Without seq, rows of any
    count split (`sharding.row_split`)."""
    if not multi_device(mesh):
        return
    sizes = axis_sizes(mesh)
    if sizes.get("seq", 1) == 1:
        return
    rows = math.prod(sizes.get(a, 1) for a in BATCH_AXES)
    for dim, axes, parts in ((0, BATCH_AXES, rows),
                             (1, ("seq",), sizes["seq"])):
        if shape[dim] % parts:
            raise ValueError(
                f"dim {dim} of the batch {tuple(shape)} is not evenly "
                f"divisible by {parts}, the size of {axes}: the ring over "
                f"seq takes even blocks")


def batch_plan(mesh, logical_specs: Optional[dict], shape):
    """The forward's plan for a global batch of `shape` [B, L, ...]
    (`check_mesh_rows`, then `plan_for(...).for_batch(B)`)."""
    check_mesh_rows(mesh, shape)
    return plan_for(mesh, logical_specs).for_batch(shape[0])


class OneDevice:
    """The forward's plan on one device: no collective, whole params."""

    tensor = None
    moe = None            # the group the MoE's partial outputs sum over

    def local(self, params: dict) -> dict:
        return params

    def for_batch(self, n: int):
        """The plan for a global batch of `n` rows."""
        return self

    def rows(self, x):
        return x

    def leaf(self, t, name: str):
        return t

    def layer(self, t, name: str):
        return t

    def embed(self, table, tokens, dtype):
        return table[tokens.long()].to(dtype)

    def position_offset(self, length: int) -> int:
        """The absolute position of the rank's first token in a row."""
        return 0

    def attend(self, q, k, v):
        """Causal attention over the rows' whole length: K1-K3."""
        return flash_attention(q, k, v, causal=True)

    def targets(self, tokens):
        """(targets, valid) of next-token prediction on the rows
        `tokens` [b, l]: the tokens rolled left by one in each global
        row, the last position of a row masked (it would predict the
        row's rolled-around first token), as the reference's loss."""
        valid = torch.ones(tokens.shape, dtype=torch.float32,
                           device=tokens.device)
        valid[:, -1] = 0.0
        return torch.roll(tokens, -1, dims=1), valid

    def experts(self, router):
        """The router [D, E] over every expert."""
        return router

    def first_expert(self, n_local: int) -> int:
        """The index of the first of the rank's `n_local` experts."""
        return 0

    def global_rows(self, x):
        """The global [B, L] of a per-token int tensor on the rows."""
        return x

    def real_rows(self, x):
        """Which rows of a global [B, L] (`global_rows`) are real, as a
        [B, 1] bool; None when all are."""
        return None

    def real_tokens(self, x) -> int:
        """The number of real tokens of a global [B, L]."""
        return x.numel()

    def local_rows(self, x):
        """The rank's [b, l] of a global [B, L] tensor."""
        return x

    def row_mean(self, x):
        """The mean over the global tokens of x [T_local, ...]."""
        return x.mean(0)

    def place(self, params: dict, device) -> dict:
        return _map(params, lambda t: t.detach().to(
            device=device, dtype=torch.float32, copy=True).requires_grad_())

    def init_leaf(self, path: str, t, device):
        """The leaf at `path` ("blocks/wq") of a fresh init, `t` the
        whole leaf as drawn: an f32 leaf on `device`."""
        return t.detach().to(device=device,
                             dtype=torch.float32).requires_grad_()

    def sync_grads(self, params: dict) -> None:
        pass


ONE_DEVICE = OneDevice()


class _LocalShard(torch.autograd.Function):
    """`t.to_local()` whose gradient is a DTensor laid out as `t`, its
    global stride given.  torch's `to_local` computes the gradient's
    global stride from the local gradient's strides, and a local dim of
    size one (llama-tiny's kv heads over tensor = 2) makes that pick
    another order of dims than the parameter's; AccumulateGrad then
    copies the gradient into the parameter's layout, a DTensor `copy_`
    whose sharding propagation over the six mesh axes takes over a
    minute on its first call."""

    @staticmethod
    def forward(ctx, t):
        ctx.layout = (t.device_mesh, t.placements, t.shape, t.stride())
        return t.to_local().view_as(t.to_local())

    @staticmethod
    def backward(ctx, g):
        from torch.distributed.tensor import DTensor

        mesh, placements, shape, stride = ctx.layout
        return DTensor.from_local(g.contiguous(), mesh, placements,
                                  run_check=False, shape=shape,
                                  stride=stride)


class MeshPlan(OneDevice):
    """The forward's plan on this rank of `mesh`, for params laid out by
    the logical spec tree `logical_specs` (see the module docstring).
    Building one makes the process groups it needs: every rank of the
    mesh builds it at the same point."""

    def __init__(self, mesh, logical_specs: dict):
        self.mesh = mesh
        self.specs = tree_map(lambda s: logical_to_spec(s, mesh=mesh),
                              logical_specs, is_leaf=_is_spec)
        self.shardings = tree_shardings(mesh, logical_specs)
        self.tensor = collectives.axis_group(mesh, ("tensor",))
        self.fsdp = collectives.axis_group(mesh, ("fsdp",))
        self.seq = collectives.axis_group(mesh, ("seq",))
        self.expert = collectives.axis_group(mesh, ("expert",))
        self.moe = collectives.axis_group(mesh, ("expert", "tensor"))
        self.row_group = collectives.axis_group(mesh, ROW_AXES)
        # The groups `sync_grads` sums over, made here by every rank in
        # the same (sorted) order.
        for axes in sorted({self.grad_sum_axes(s)
                            for s in _leaves(self.specs)}):
            collectives.axis_group(mesh, axes)
        self.coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
        self.sizes = axis_sizes(mesh)
        self.device = mesh_device(mesh)
        self.n_rows = None

    def local(self, params: dict) -> dict:
        return _map(params, _LocalShard.apply)

    def for_batch(self, n: int) -> "MeshPlan":
        """A copy of the plan bound to a global batch of `n` rows: this
        rank's real rows (`n_real`) of the `chunk` it holds
        (`sharding.row_split`)."""
        plan = copy.copy(self)
        own, plan.chunk = row_split(n, self.mesh)
        plan.n_rows, plan.n_real = n, own.stop - own.start
        return plan

    def rows(self, x):
        """This rank's rows of a batch leaf (its batch rows over (data,
        fsdp), padded with zero rows to the chunk every row rank holds,
        and, for a [B, L, ...] leaf, its length slice over seq): a
        DTensor's local tensor (placed evenly), or the slice of a plain
        (global) tensor, on the mesh's device."""
        from torch.distributed.tensor import DTensor

        if isinstance(x, DTensor):
            return x.to_local().to(self.device)
        x = torch.as_tensor(x)
        own, chunk = row_split(x.shape[0], self.mesh)
        x = x[own]
        if x.dim() >= 2 and self.seq is not None:
            l = x.shape[1] // self.sizes["seq"]
            x = x[:, self.coord["seq"] * l:(self.coord["seq"] + 1) * l]
        return pad_rows(x, chunk).to(self.device)

    def position_offset(self, length: int) -> int:
        return self.coord["seq"] * length

    def attend(self, q, k, v):
        """`ring_attention` over seq (`flash_attention` when seq is 1)."""
        return ring_attention(q, k, v, mesh=self.mesh, causal=True)

    def targets(self, tokens):
        """Under seq a row's last local position predicts the first token
        of the next seq rank's slice; only the last seq rank masks its
        last position.  The pad rows' targets are masked."""
        if self.seq is None:
            targets, valid = super().targets(tokens)
        else:
            nxt = collectives.rotate([tokens[:, :1].contiguous()], self.seq,
                                     -1)[0]
            targets = torch.cat([tokens[:, 1:], nxt], dim=1)
            valid = torch.ones(tokens.shape, dtype=torch.float32,
                               device=tokens.device)
            if self.coord["seq"] == self.sizes["seq"] - 1:
                valid[:, -1] = 0.0
        valid[self.n_real:] = 0.0
        return targets, valid

    def experts(self, router):
        """The rank's router columns ("experts" over expert) gathered
        into every expert's; every rank of the expert group routes the
        same tokens, so the gradient of its columns is its slice."""
        return collectives.gather_replicated(router, self.expert, 1)

    def first_expert(self, n_local: int) -> int:
        return self.coord["expert"] * n_local

    def _row_layout(self):
        sizes = [self.sizes[a] for a in ROW_AXES]
        return sizes[0] * sizes[1], sizes[2]

    def global_rows(self, x):
        """The row group's [b, l] pieces gathered (ranks in (data, fsdp,
        seq) order) and laid out as the global [B, L]."""
        if self.row_group is None:
            return x
        n_batch, n_seq = self._row_layout()
        b, l = x.shape
        parts = collectives.all_gather(x.contiguous(), self.row_group, 0)
        return parts.view(n_batch, n_seq, b, l).transpose(1, 2).reshape(
            n_batch * b, n_seq * l)

    def real_rows(self, x):
        """The pad rows of every rank follow the real rows of all ranks
        in the global layout (rank i's chunk holds global rows i * chunk
        onwards), so the real ones are the first `n_rows`."""
        return (torch.arange(x.shape[0], device=x.device)
                < self.n_rows)[:, None]

    def real_tokens(self, x) -> int:
        return self.n_rows * x.shape[1]

    def local_rows(self, x):
        n_batch, n_seq = self._row_layout()
        b, l = x.shape[0] // n_batch, x.shape[1] // n_seq
        i = self.coord["data"] * self.sizes["fsdp"] + self.coord["fsdp"]
        s = self.coord["seq"]
        return x[i * b:(i + 1) * b, s * l:(s + 1) * l]

    def row_mean(self, x):
        """The sum of the rank's real tokens (its first n_real rows'),
        summed over the row group, over the global real tokens; the
        gradient of each rank's term is its own tokens' share."""
        per_row = x.shape[0] // self.chunk
        total = collectives.all_reduce_value(
            x[:self.n_real * per_row].sum(0), self.row_group)
        return total / (self.n_rows * per_row * self.sizes["seq"])

    def _gather(self, t, spec: tuple, label=None):
        """`t` gathered over fsdp on the dim that fsdp shards (fsdp must
        be that dim's minor axis, so the pieces join contiguously)."""
        for d, entry in enumerate(spec):
            axes = _entry_axes(entry)
            if "fsdp" in axes:
                if axes[-1] != "fsdp":
                    raise ValueError(f"fsdp must be the minor axis of "
                                     f"{entry}")
                return collectives.all_gather_value(t, self.fsdp, d, label)
        return t

    def leaf(self, t, name: str):
        return self._gather(t, self.specs[name])

    def layer(self, t, name: str):
        """A stacked block leaf's layer (the "layers" dim dropped),
        gathered over fsdp where it is sharded so; `collectives.measure`
        files these gathers under "layer_all_gather" (and their
        backward under "layer_reduce_scatter")."""
        return self._gather(t, self.specs["blocks"][name][1:], "layer")

    def embed(self, table, tokens, dtype):
        """The vocab-parallel lookup: the rank's slice of the table
        ("vocab" over (tensor, fsdp)) serves the tokens of its fsdp
        group's rows; the partial rows are summed over fsdp back onto
        each rank's rows and over tensor.  Every output row has one
        non-zero term, so the sums are exact."""
        spec = self.specs["tok_embed"]
        axes = _entry_axes(spec[0]) if spec else ()
        index = 0
        for a in axes:
            index = index * self.sizes[a] + self.coord[a]
        lo = index * table.shape[0]
        group = self.fsdp if "fsdp" in axes else None
        ids = collectives.all_gather(tokens.long(), group, 0) - lo
        inside = (ids >= 0) & (ids < table.shape[0])
        x = table[ids.clamp(0, table.shape[0] - 1)].to(dtype)
        x = torch.where(inside[..., None], x, 0)
        x = collectives.reduce_scatter_value(x, group, 0)
        if "tensor" in axes:
            x = collectives.all_reduce_value(x, self.tensor)
        return x

    def place(self, params: dict, device) -> dict:
        """Each leaf as a DTensor leaf of fp32 on `device`, laid out by
        the plan's specs: a plain (global) tensor is sliced, a DTensor is
        copied, and one laid out otherwise (other rules, another saved
        layout) is moved into the plan's layout first, as the
        reference's jit reshards its arguments."""
        from torch.distributed.tensor import DTensor

        def put(t, sharding):
            if isinstance(t, DTensor):
                t = redistribute(t.detach(), sharding.spec, self.mesh)
                t = DTensor.from_local(
                    t.to_local().to(device, torch.float32, copy=True),
                    self.mesh, t.placements, run_check=False,
                    shape=t.shape, stride=t.stride())
            else:
                t = sharding.shard(t.detach().float(), device)
            return t.requires_grad_()
        return tree_map(put, params, self.shardings)

    def init_leaf(self, path: str, t, device):
        """The rank's shard of the leaf at `path` ("blocks/wq") of a
        fresh init, `t` the whole leaf as drawn: a DTensor of f32 on
        `device` laid out by the plan's spec, its local tensor a copy
        (never a view that would keep the whole leaf alive)."""
        sharding = self.shardings
        for key in path.split("/"):
            sharding = sharding[key]
        local = t.detach()[local_index(t.shape, sharding.spec, self.mesh)]
        local = local.to(device=device, dtype=torch.float32, copy=True)
        return sharding.wrap(local.contiguous(), tuple(t.shape),
                             device).requires_grad_()

    def grad_sum_axes(self, spec: tuple) -> tuple:
        """The row axes (data, fsdp, seq) that the gradient of a
        parameter laid out by `spec` is summed over after the backward:
        those it is not sharded over."""
        return tuple(a for a in ROW_AXES if a not in spec_axes(spec))

    def sync_grads(self, params: dict) -> None:
        """Sum each gradient over the row axes its parameter is not
        sharded over (fsdp-sharded ones were reduce-scattered over fsdp
        in the backward), one all-reduce per set of axes."""
        buckets: dict = {}

        def bucket(p, spec):
            axes = self.grad_sum_axes(spec)
            group = collectives.axis_group(self.mesh, axes)
            if group is not None:
                buckets.setdefault(axes, (group, []))[1].append(p.grad)
        tree_map(bucket, params, self.specs)
        with torch.no_grad():
            for group, grads in buckets.values():
                local = [g.to_local() for g in grads]
                flat = collectives.all_reduce(
                    torch.cat([t.reshape(-1) for t in local]), group)
                for t, part in zip(local, flat.split(
                        [t.numel() for t in local])):
                    t.copy_(part.view_as(t))


def gather_layer(own: dict, plan) -> dict:
    """A layer's leaves {name: the rank's slice} gathered for use
    (`plan.layer`; on one device, as they are)."""
    return {k: plan.layer(v, k) for k, v in own.items()}


_plans: dict = {}


def plan_for(mesh, logical_specs: Optional[dict]) -> OneDevice:
    """`ONE_DEVICE` without a mesh (or with every axis 1), else the
    mesh's `MeshPlan` for `logical_specs` (made once per mesh and spec
    tree)."""
    if not multi_device(mesh):
        return ONE_DEVICE
    key = (mesh, repr(logical_specs))
    if key not in _plans:
        _plans[key] = MeshPlan(mesh, logical_specs)
    return _plans[key]


def make_train_step(config, optimizer: AdamW, *, init_params, loss_fn,
                    device: DeviceLike = None, mesh=None,
                    param_specs=None):
    """`init_params(config, generator, device, keep)`,
    `loss_fn(params, batch, config, mesh)` and `param_specs(config)`
    define the family.

    `init_state(key=0, params=None)`: params from `init_params` with a
    generator seeded by `key` (an int seeds a CPU generator; or a
    torch.Generator, on the CPU or a card), or a copy of `params` when
    given (e.g. weights carried across from the reference with
    convert.params_from_numpy).  Each leaf goes to `plan.init_leaf` as
    soon as it is drawn: under a mesh every rank draws every leaf (the
    same values) and keeps only its shard, a DTensor leaf on `device`
    (see the module docstring).  `train_step(state, batch)` runs the
    loss, its backward, the gradient sums over the row axes and one
    optimizer step; the loss it returns is a device scalar (reading it
    blocks until the step is done).  Under a mesh a batch leaf is a
    DTensor (from `shard_batch` or `global_batch`) or the global batch,
    of any row count without seq (`MeshPlan.rows`)."""
    device = resolve_device(device)
    plan = plan_for(mesh, param_specs(config) if param_specs else None)

    def init_state(key: Union[int, torch.Generator] = 0,
                   params: Optional[dict] = None) -> dict:
        if params is None:
            gen = key if isinstance(key, torch.Generator) \
                else torch.Generator().manual_seed(int(key))
            params = init_params(config, gen, device=gen.device,
                                 keep=lambda path, t: plan.init_leaf(
                                     path, t, device))
        else:
            params = plan.place(params, device)
        return {"params": params, "opt_state": optimizer.init(params),
                "step": 0}

    def train_step(state: dict, batch: dict):
        params, opt = state["params"], state["opt_state"]
        opt.zero_grad(set_to_none=True)
        if plan is ONE_DEVICE:
            batch = {k: v.to(device, non_blocking=True)
                     for k, v in batch.items()}
        loss = loss_fn(params, batch, config, mesh)
        loss.backward()
        plan.sync_grads(params)
        opt.step()
        return ({"params": params, "opt_state": opt,
                 "step": state["step"] + 1},
                {"loss": loss.detach()})

    return init_state, train_step
