"""What `run_ranks` runs on each rank of a mesh: the mesh path driven
through its entry points, reporting numpy results to the caller.

They live in the package so that a spawned rank imports the port and
nothing else (neither the caller's script nor JAX).  Each takes
`(rank, world_size, ...)`, builds its mesh with `create_mesh` from a
dict of axis sizes, and returns plain data:

- `shards`: each leaf's local shard of a params tree placed by the
  family's `param_specs`, with its index in the global tensor;
- `cross_entropy`: `fused_cross_entropy_spmd`'s loss, dx and dhead
  (summed over the row axes) on this rank's slices;
- `ring`: `ring_attention` and `ring_attention_plain` on this rank's
  slices of global q, k and v, with their gradients;
- `forward`: the family's logits (and aux) on this rank's rows;
- `moe`: gpt's Switch MoE layer on this rank's rows and experts, with
  its gradients;
- `plans`: the plan each family's train step builds on the mesh;
- `train`: the family's `make_train_step` under the mesh for a few
  AdamW steps: the losses, the launches of K1-K3 on this rank, step
  times, the share of a step spent in collectives, peak memory, the
  final params' shards or their updates against a single-device run's,
  and whether AdamW's moments are placed like their params; with a
  `control`, the same run with a fault injected;
- `save` / `restore`: a sharded checkpoint written from the mesh, or
  restored onto it;
- `batches`: a global batch through `shard_batch`, `global_batch`,
  the device feed and `with_logical_constraint`, and an optimizer
  state through `shard_opt_state`;
- `sequence`: several of these in turn on one group of ranks.
"""

from __future__ import annotations

import statistics
import time
from typing import Optional

import numpy as np
import torch

from ray_tpu_torch.parallel.mesh import MeshConfig, create_mesh


def _family(name: str):
    from ray_tpu_torch.models import gpt, llama
    return {"gpt": gpt, "llama": llama}[name]


def _mesh(sizes: dict, device):
    return create_mesh(MeshConfig(**sizes), device=device)


def _device(device: str) -> torch.device:
    if device == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)


def _numpy(t: torch.Tensor) -> np.ndarray:
    """A copy: on the CPU the array would otherwise share the storage of
    a parameter that later steps update in place."""
    return t.detach().float().cpu().numpy().copy()


def _index(slices) -> list:
    return [[s.start, s.stop] for s in slices]


def local_shards(tree: dict, specs: dict, mesh) -> dict:
    """{leaf path: (index, local array)} of a tree of DTensors whose
    layout is `specs` (spec tuples)."""
    from ray_tpu_torch.parallel.sharding import local_index

    out = {}

    def walk(node, spec, prefix):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, spec[k], f"{prefix}{k}/")
            return
        out[prefix[:-1]] = (_index(local_index(node.shape, spec, mesh)),
                            _numpy(node.to_local()))
    walk(tree, specs, "")
    return out


def _specs(family, config, mesh) -> dict:
    from ray_tpu_torch.parallel.sharding import (_is_spec, logical_to_spec,
                                                 tree_map)
    return tree_map(lambda s: logical_to_spec(s, mesh=mesh),
                    family.param_specs(config), is_leaf=_is_spec)


def shards(rank: int, world_size: int, family: str, config, sizes: dict,
           np_params: dict, device: str = "cpu") -> dict:
    """Also the leaves whose DTensor view disagrees with the global
    tensor (`full_tensor()`, a collective: the CPU only) or whose
    placements do not give back their spec (`spec_of`)."""
    from ray_tpu_torch.models.convert import params_from_numpy
    from ray_tpu_torch.parallel.sharding import spec_of

    fam = _family(family)
    mesh = _mesh(sizes, device)
    full = params_from_numpy(np_params, config, device="cpu")
    params = fam.shard_params(full, mesh, config)
    specs = _specs(fam, config, mesh)
    out = {"coordinate": list(mesh.get_coordinate()),
           "shards": local_shards(params, specs, mesh),
           "full_tensor_differs": [], "spec_of_differs": []}

    def walk(node, whole, spec, prefix):
        if isinstance(node, dict):
            for k in node:
                walk(node[k], whole[k], spec[k], f"{prefix}{k}/")
            return
        if device == "cpu" and not torch.equal(node.full_tensor(), whole):
            out["full_tensor_differs"].append(prefix[:-1])
        if spec_of(node) != spec:
            out["spec_of_differs"].append(prefix[:-1])
    walk(params, full, specs, "")
    return out


def batches(rank: int, world_size: int, sizes: dict, tokens: np.ndarray,
            np_params: dict, config, device: str = "cpu") -> dict:
    """This rank's rows of the global `tokens` by `shard_batch`, by
    `global_batch` from its own rows, by the device feed with
    `sharding=mesh`, replicated again by `with_logical_constraint`, and
    moved by it onto the columns (with the gradient of the sum of the
    moved shard's squares, which is 2x the rows' shard); the specs
    `shard_opt_state` gives a gpt state {"mu", "nu", "count"} built
    from `np_params`; and
    `single_device_mesh`'s sizes with gpt's loss on it and without a
    mesh, and `mesh_axis_size` of each axis."""
    from ray_tpu_torch.data import iter_device_batches
    from ray_tpu_torch.models import gpt
    from ray_tpu_torch.parallel.sharding import (
        global_batch, local_index, shard_batch, shard_opt_state, spec_of,
        tree_map, tree_shardings, with_logical_constraint)

    mesh = _mesh(sizes, device)
    placed = shard_batch(mesh, {"tokens": torch.from_numpy(tokens)})["tokens"]
    index = local_index(tokens.shape, spec_of(placed), mesh)
    own = global_batch(mesh, {"tokens": tokens[index]})["tokens"]
    fed = next(iter(iter_device_batches(
        [{"tokens": tokens}], device=device, batch_size=tokens.shape[0],
        sharding=mesh)))["tokens"]
    out = {"index": _index(index), "spec": spec_of(placed),
           "shard_batch": _numpy(placed.to_local()),
           "global_batch": (list(own.shape), spec_of(own),
                            _numpy(own.to_local())),
           "fed": (list(fed.shape), spec_of(fed), _numpy(fed.to_local()))}
    out["replicated"] = _numpy(with_logical_constraint(
        placed, (None, None), mesh=mesh).to_local())
    x = shard_batch(mesh, {"x": torch.from_numpy(tokens).float()})["x"]
    x.requires_grad_()
    moved = with_logical_constraint(x, (None, "batch"), mesh=mesh)
    (moved.to_local() ** 2).sum().backward()
    out["resharded"] = (spec_of(moved), _index(local_index(
        tokens.shape, spec_of(moved), mesh)), _numpy(moved.to_local()))
    out["resharded_grad"] = _numpy(x.grad.to_local())
    from ray_tpu_torch.models.convert import params_from_numpy
    from ray_tpu_torch.parallel.mesh import (AXES, axis_sizes,
                                             mesh_axis_size,
                                             single_device_mesh)
    one = single_device_mesh(device)
    whole = params_from_numpy(np_params, config, device=device)
    batch = {"tokens": torch.from_numpy(tokens)}
    out["single_device_mesh"] = (axis_sizes(one), float(gpt.loss_fn(
        whole, batch, config, one)), float(gpt.loss_fn(whole, batch, config)))
    out["mesh_axis_size"] = {a: mesh_axis_size(mesh, a) for a in AXES}
    state = {"mu": np_params, "nu": np_params, "count": np.int32(3)}
    placed_state = shard_opt_state(state, np_params, tree_shardings(
        mesh, gpt.param_specs(config)), mesh)
    out["opt_specs"] = tree_map(spec_of, placed_state)
    return out


def cross_entropy(rank: int, world_size: int, sizes: dict, x, head,
                  targets, valid, device: str = "cpu") -> dict:
    """x [B, L, D], head [D, V], targets / valid [B, L] global numpy;
    this rank's rows and vocab slice go through the mesh CE."""
    from ray_tpu_torch.ops.cross_entropy import (ROW_AXES,
                                                 fused_cross_entropy_spmd)
    from ray_tpu_torch.parallel import collectives
    from ray_tpu_torch.parallel.sharding import (local_index,
                                                 logical_to_spec)

    mesh = _mesh(sizes, device)
    dev = _device(device)
    rows = logical_to_spec(("batch", "length", None), mesh=mesh)
    cols = logical_to_spec((None, "heads"), mesh=mesh)
    xi = local_index(x.shape, rows, mesh)
    hi = local_index(head.shape, cols, mesh)
    x_l = torch.from_numpy(x[xi]).to(dev).requires_grad_()
    head_l = torch.from_numpy(head[hi]).to(dev).requires_grad_()
    ti = xi[:2]
    loss = fused_cross_entropy_spmd(
        x_l, head_l, torch.from_numpy(targets[ti]).to(dev),
        torch.from_numpy(valid[ti]).to(dev), mesh)
    dx, dhead = torch.autograd.grad(loss, [x_l, head_l])
    dhead = collectives.all_reduce(
        dhead.contiguous(), collectives.axis_group(mesh, ROW_AXES))
    return {"loss": float(loss), "dx": (_index(xi), _numpy(dx)),
            "dhead": (_index(hi), _numpy(dhead))}


def ring(rank: int, world_size: int, sizes: dict, q, k, v, dout,
         causal: bool = True, device: str = "cpu",
         dtype: str = "float32") -> dict:
    """q, k, v, dout [B, L, H, D] global numpy; this rank's slice (rows
    over (data, fsdp), length over seq, heads over tensor), rounded to
    `dtype`, goes through the kernel ring in `dtype` and through the
    plain ring in f32 (the exact function of the same values): {"index",
    "kernel": (out, dq, dk, dv), "plain": (...)} as f32 numpy, the
    gradients those of sum(out * dout)."""
    from ray_tpu_torch.ops.ring_attention import (ring_attention,
                                                  ring_attention_plain)
    from ray_tpu_torch.parallel.sharding import (local_index,
                                                 logical_to_spec)

    mesh = _mesh(sizes, device)
    dev = _device(device)
    index = local_index(q.shape, logical_to_spec(
        ("batch", "length", "heads", None), mesh=mesh), mesh)
    out = {"index": _index(index)}
    given = [torch.from_numpy(a[index]).to(dev, getattr(torch, dtype))
             for a in (q, k, v, dout)]
    for name, fn, cast in (("kernel", ring_attention, given[0].dtype),
                           ("plain", ring_attention_plain, torch.float32)):
        qkv = [t.to(cast).requires_grad_() for t in given[:3]]
        o = fn(*qkv, mesh=mesh, causal=causal)
        grads = torch.autograd.grad(o, qkv, given[3].to(cast))
        out[name] = tuple(_numpy(t) for t in (o, *grads))
    return out


def forward(rank: int, world_size: int, family: str, config, sizes: dict,
            np_params: dict, tokens: np.ndarray,
            device: str = "cpu") -> dict:
    """The family's `forward` on the mesh from the reference's numpy
    params: this rank's logits (its rows, length slice and vocab slice)
    with their index in the global [B, L, V], and gpt's aux."""
    from ray_tpu_torch.models.convert import params_from_numpy
    from ray_tpu_torch.parallel.sharding import (local_index,
                                                 logical_to_spec)

    fam = _family(family)
    mesh = _mesh(sizes, device)
    params = fam.shard_params(params_from_numpy(np_params, config,
                                                device="cpu"), mesh, config)
    with torch.no_grad():
        got = fam.forward(params, torch.from_numpy(tokens), config, mesh)
    logits, aux = got if isinstance(got, tuple) else (got, None)
    shape = tokens.shape + (config.vocab_size,)
    index = local_index(shape, logical_to_spec(
        ("batch", "length", "vocab"), mesh=mesh), mesh)
    return {"logits": (_index(index), _numpy(logits)),
            "aux": None if aux is None else float(aux)}


def moe(rank: int, world_size: int, config, sizes: dict, x, router, w_up,
        w_down, dout, device: str = "cpu") -> dict:
    """gpt's `_moe_mlp` under the mesh on this rank's slices of global
    numpy x [B, L, D], router [D, E], w_up [E, D, F], w_down [E, F, D]
    (rows over (data, fsdp), length over seq, experts over expert, F
    over tensor): its output rows, aux and the tokens it kept, and the
    gradients of sum(out * dout) + aux, the weights' summed over the row
    axes (as the train step sums them)."""
    from ray_tpu_torch.models import gpt
    from ray_tpu_torch.models._functional import plan_for
    from ray_tpu_torch.ops.cross_entropy import ROW_AXES
    from ray_tpu_torch.parallel import collectives
    from ray_tpu_torch.parallel.sharding import (local_index,
                                                 logical_to_spec)

    mesh = _mesh(sizes, device)
    dev = _device(device)
    plan = plan_for(mesh, gpt.param_specs(config))
    specs = {"x": ("batch", "length", None), "router": (None, "experts"),
             "w_up": ("experts", None, "expert_mlp"),
             "w_down": ("experts", "expert_mlp", None)}
    arrays = {"x": x, "router": router, "w_up": w_up, "w_down": w_down}
    index = {k: local_index(a.shape, logical_to_spec(specs[k], mesh=mesh),
                            mesh) for k, a in arrays.items()}
    local = {k: torch.from_numpy(a[index[k]]).to(dev).requires_grad_()
             for k, a in arrays.items()}
    out, aux = gpt._moe_mlp(local["x"], local["router"], local["w_up"],
                            local["w_down"], config, plan)
    val = (out * torch.from_numpy(dout[index["x"]]).to(dev)).sum() + aux
    grads = dict(zip(local, torch.autograd.grad(val, list(local.values()))))
    rows = collectives.axis_group(mesh, ROW_AXES)
    result = {"out": (_index(index["x"]), _numpy(out)), "aux": float(aux)}
    for k, g in grads.items():
        if k != "x":
            g = collectives.all_reduce(g.contiguous(), rows)
        result["d" + k] = (_index(index[k]), _numpy(g))
    return result


def plans(rank: int, world_size: int, sizes: dict,
          device: str = "cpu") -> dict:
    """The plan that `make_train_step` builds on the mesh for gpt nano,
    nano-moe and llama-tiny: {name: {"plan": class name, "groups": the
    sizes of its seq, expert and MoE groups, "offset": the absolute
    position of a length-8 shard's first token, "sums": {leaf: the row
    axes its gradient is summed over}}}."""
    import torch.distributed as dist

    from ray_tpu_torch.models import gpt, llama
    from ray_tpu_torch.models._functional import adamw, plan_for

    mesh = _mesh(sizes, device)
    out = {}
    for name, fam, config in (("gpt", gpt, gpt.CONFIGS["nano"]),
                              ("gpt-moe", gpt, gpt.CONFIGS["nano-moe"]),
                              ("llama", llama, llama.CONFIGS["llama-tiny"])):
        fam.make_train_step(config, adamw(1e-3), mesh, device=device)
        plan = plan_for(mesh, fam.param_specs(config))
        groups = {"seq": plan.seq, "expert": plan.expert, "moe": plan.moe}
        out[name] = {
            "plan": type(plan).__name__,
            "groups": {k: 1 if g is None else dist.get_world_size(g)
                       for k, g in groups.items()},
            "offset": plan.position_offset(8),
            "sums": {k: plan.grad_sum_axes(s)
                     for k, s in _flat(plan.specs).items()}}
    return out


def _flash_launches() -> dict:
    from ray_tpu_torch.ops import attention as A
    return {fn.__name__: fn.launches
            for fn in (A.flash_forward, A.flash_dq, A.flash_dkv)}


def _zero_flash_launches() -> None:
    from ray_tpu_torch.ops import attention as A
    for fn in (A.flash_forward, A.flash_dq, A.flash_dkv):
        fn.launches = 0


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


CONTROLS = ("no_grad_sync", "no_update")


def _flat(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def _update_errors(params: dict, specs: dict, mesh, path: str) -> dict:
    """Against a single-device run saved at `path` (torch.save of
    {"start": , "final": } flat trees of the global params, the final
    one after the same steps): per leaf, this rank's shard's
    ||(got - start) - (want - start)||_2 / ||want - start||_2, `start`
    the saved one (so a start that differs shows here too)."""
    from ray_tpu_torch.parallel.sharding import local_index

    ref = torch.load(path, mmap=True, weights_only=True)
    got, spec = _flat(params), _flat(specs)
    out = {}
    for k, t in got.items():
        index = local_index(t.shape, spec[k], mesh)
        start = ref["start"][k][index].double()
        want = ref["final"][k][index].double() - start
        have = t.to_local().detach().cpu().double() - start
        out[k] = float((have - want).norm() / want.norm().clamp_min(1e-30))
    return out


def train(rank: int, world_size: int, family: str, config, sizes: dict,
          np_params: Optional[dict], batches: list, lr: float,
          device: str = "cpu", return_params: bool = True,
          rules: Optional[dict] = None, reference: Optional[str] = None,
          control: Optional[str] = None) -> dict:
    """One AdamW step per batch, each timed (host clock around a
    synchronize; the median leaves out the first, which warms up), the
    K1-K3 counts set to 0 just before the steps and read just after;
    the params' shards after these steps (`shards`, with
    `return_params`), and each leaf's update against a single-device
    run's (`update_rel_err`, with `reference`, see `_update_errors`);
    then one more step on the last batch under `collectives.measure()`
    for the share of a step spent in collectives, whose loss
    (`final_loss`) is the first that sees the last update.

    The params come from `np_params` (the reference's numpy tree;
    placed by `shard_params` under `rules` when given, which the train
    step then moves into its own layout) or, when None, from the
    family's init on seed 0 (drawn on the CPU, as the single-device
    `init_state(0)` draws them).  `control` injects a fault the checks
    must catch: "no_grad_sync" skips the gradients' sums over the row
    axes, "no_update" the optimizer's step.  Also `constraint_round_trip`:
    the token table replicated by `with_logical_constraint` and sliced
    back equals its shard."""
    import torch.distributed as dist

    from ray_tpu_torch.models._functional import adamw, plan_for
    from ray_tpu_torch.models.convert import params_from_numpy
    from ray_tpu_torch.parallel import collectives
    from ray_tpu_torch.parallel.sharding import (local_index, shard_batch,
                                                 spec_of,
                                                 with_logical_constraint)

    if control is not None and control not in CONTROLS:
        raise ValueError(f"control {control!r} is not one of {CONTROLS}")
    fam = _family(family)
    dev = _device(device)
    mesh = _mesh(sizes, device)
    init_state, train_step = fam.make_train_step(config, adamw(lr), mesh,
                                                 device=dev)
    if np_params is None:
        state = init_state(0)
    else:
        full = params_from_numpy(np_params, config, device="cpu")
        state = init_state(params=full if rules is None else
                           fam.shard_params(full, mesh, config, rules))
    plan = plan_for(mesh, fam.param_specs(config))
    if control == "no_grad_sync":
        plan.sync_grads = lambda params: None
    if control == "no_update":
        state["opt_state"].step = lambda: None
    feed = [shard_batch(mesh, {"tokens": torch.from_numpy(b)})
            for b in batches]
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    _zero_flash_launches()
    losses, step_ms = [], []
    for batch in feed:
        _sync(dev)
        t0 = time.perf_counter()
        state, metrics = train_step(state, batch)
        losses.append(float(metrics["loss"]))
        step_ms.append((time.perf_counter() - t0) * 1e3)
    launches = _flash_launches()
    specs = _specs(fam, config, mesh)
    out = {}
    if return_params:
        out["shards"] = local_shards(state["params"], specs, mesh)
    if reference is not None:
        out["update_rel_err"] = _update_errors(state["params"], specs, mesh,
                                               reference)
    _sync(dev)
    t0 = time.perf_counter()
    with collectives.measure() as stats:
        state, metrics = train_step(state, feed[-1])
        final_loss = float(metrics["loss"])
    measured_ms = (time.perf_counter() - t0) * 1e3
    if control == "no_grad_sync":
        del plan.sync_grads         # the cached plan's own method again
    table = state["params"]["tok_embed"].detach()
    whole = with_logical_constraint(table, (None, None), mesh=mesh)
    opt = state["opt_state"]
    out.update({
        "moments_placed_like_params": None if control == "no_update"
        else all(spec_of(mu) == spec_of(p) == spec_of(nu)
                 for p, (mu, nu) in zip(opt.params, opt.moments())),
        "constraint_round_trip": bool(torch.equal(
            whole.to_local()[local_index(table.shape, spec_of(table),
                                         mesh)], table.to_local())),
        "coordinate": list(mesh.get_coordinate()),
        "backend": dist.get_backend(),
        "losses": losses,
        "final_loss": final_loss,
        "step_ms": step_ms,
        "median_step_ms": statistics.median(step_ms[1:] or step_ms),
        "launches": launches,
        "collectives": {"calls": stats["calls"],
                        "ms": stats["seconds"] * 1e3,
                        "bytes": stats["bytes"],
                        "step_ms": measured_ms,
                        "share": stats["seconds"] * 1e3 / measured_ms,
                        "by_op": {op: {"calls": o["calls"],
                                       "ms": o["seconds"] * 1e3,
                                       "bytes": o["bytes"]}
                                  for op, o in stats["by_op"].items()}},
        "peak_memory_gib": (torch.cuda.max_memory_allocated(dev) / 2 ** 30
                            if dev.type == "cuda" else None),
    })
    return out


def save(rank: int, world_size: int, family: str, config, sizes: dict,
         np_params: dict, path: str, device: str = "cpu") -> None:
    """The params tree placed on the mesh, saved with `save_sharded`."""
    from ray_tpu_torch.checkpoint import save_sharded
    from ray_tpu_torch.models.convert import params_from_numpy

    fam = _family(family)
    mesh = _mesh(sizes, device)
    params = fam.shard_params(params_from_numpy(np_params, config,
                                                device="cpu"), mesh, config)
    save_sharded(path, {"params": params}, save_id="mesh", step=1)


def restore(rank: int, world_size: int, sizes: dict, path: str,
            device: str = "cpu", replicated: bool = False) -> dict:
    """`restore_sharded(mesh=...)` on the mesh (with `replicated`,
    `shardings=` one replicated NamedSharding instead): {leaf path:
    (index, local array)}, the index read off each DTensor's
    placements."""
    from ray_tpu_torch.checkpoint import restore_sharded
    from ray_tpu_torch.parallel.sharding import (NamedSharding, local_index,
                                                 spec_of)

    mesh = _mesh(sizes, device)
    tree = restore_sharded(path, device=device, mesh=mesh) if not replicated \
        else restore_sharded(path, device=device,
                             shardings=NamedSharding(mesh, ()))
    out = {}

    def walk(node, prefix):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{prefix}.{k}" if prefix else k)
            return
        out[prefix] = (_index(local_index(node.shape, spec_of(node), mesh)),
                       _numpy(node.to_local()))
    walk(tree, "")
    return out


def sequence(rank: int, world_size: int, calls: list) -> list:
    """[(name, args)] -> the results of the bodies named, in turn."""
    return [globals()[name](rank, world_size, *args) for name, args in calls]
