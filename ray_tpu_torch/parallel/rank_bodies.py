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
  AdamW steps on global batches of any row count: the losses, the
  launches of K1-K3 on this rank, step times, the share of a step spent
  in collectives (by op, the blocks' fsdp gathers apart), peak memory,
  the init's seconds and host memory, the final params' shards or their
  updates (and first gradients) against a single-device run's, this
  rank's real rows, and whether AdamW's moments are placed like their
  params; with a `control`, the same run with a fault injected (the 7B
  configs run through it too, their params drawn on the card);
- `init_shards`: the family's init under the mesh, each leaf's shard,
  and how many whole leaves the rank held at once while drawing;
- `loss_grads`: the family's loss and its summed gradients' shards on
  placed params;
- `routing`: gpt's Switch MoE trunk once: this rank's real rows, and
  each layer's capacity and dropped tokens;
- `refusals`: what the reference refuses, each case's error and the
  collectives run before it;
- `save` / `restore`: a sharded checkpoint written from the mesh, or
  restored onto it;
- `batches`: a global batch through `shard_batch`, `global_batch`,
  the device feed and `with_logical_constraint`, and an optimizer
  state through `shard_opt_state`;
- `pipeline`: `pipeline_apply` and `pipeline_loss_dryrun` of tanh
  stages on this rank's stage and rows, with the dryrun's gradients;
- `pipeline_gpt`: gpt's blocks as pipeline stages, a few AdamW steps
  through `pipeline_loss_dryrun` (the embeddings and the head fixed);
- `resnet`: ResNet's `make_train_step` under the mesh for a few AdamW
  steps;
- `learner`: the RL learners (`TorchLearner`, `_VTraceLearner`)
  data-parallel over the ranks for a few updates;
- `sequence`: several of these in turn on one group of ranks.

`gang_keep` and `gang_stall` take a `RankGang`'s state: what the
launcher's checks drive.  With `sizes` None, `pipeline_gpt` and `resnet`
run on one device with no process group (the plain version that the
mesh runs are held against), and save their start and final params
where `save` says.
"""

from __future__ import annotations

import hashlib
import math
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
    plan = plan_for(mesh, gpt.param_specs(config)).for_batch(x.shape[0])
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
GRAD_CONTROLS = ("rank_means",)


def _rank_means_ce(x, head, targets, valid, mesh, n_chunks: int = 4):
    """A fault for `train`'s grad control "rank_means": each row rank's loss
    normalised by its own count of valid tokens, then averaged over the
    row ranks (`fused_cross_entropy_spmd` normalises by the global
    count)."""
    import torch.distributed as dist

    from ray_tpu_torch.ops import cross_entropy as CE
    from ray_tpu_torch.parallel import collectives

    vocab = collectives.axis_group(mesh, (CE.VOCAB_AXIS,))
    rows = collectives.axis_group(mesh, CE.ROW_AXES)
    offset = _coordinate(mesh)[CE.VOCAB_AXIS] * head.shape[1]
    own = CE._FusedCrossEntropySpmd.apply(x, head, targets, valid.float(),
                                          (vocab, None), offset, n_chunks)
    n = 1 if rows is None else dist.get_world_size(rows)
    return collectives.all_reduce_value(own, rows) / n


def _feed(mesh, batch) -> dict:
    """A global batch (a tokens array, or a dict of arrays) as the train
    step takes it: placed by `shard_batch` where its rows split evenly
    over the row ranks, else the global tensors, whose rows the step
    splits as GSPMD pads them."""
    from ray_tpu_torch.parallel.mesh import axis_sizes
    from ray_tpu_torch.parallel.sharding import BATCH_AXES, shard_batch

    batch = {k: torch.from_numpy(v) for k, v in (
        batch if isinstance(batch, dict) else {"tokens": batch}).items()}
    parts = math.prod(axis_sizes(mesh)[a] for a in BATCH_AXES)
    if batch["tokens"].shape[0] % parts:
        return batch
    return shard_batch(mesh, batch)


def _flat(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def _grad_errors(params: dict, specs: dict, mesh,
                 path: Optional[str]) -> dict:
    """Against the first step's gradients saved at `path` (its "grad",
    a flat tree of the single device's global gradients, before the
    optimizer's step), per leaf, this rank's shard of its summed
    gradient's `_rel_err`; {} without them."""
    from ray_tpu_torch.parallel.sharding import local_index

    if path is None:
        return {}
    ref = torch.load(path, mmap=True, weights_only=True).get("grad")
    if ref is None:
        return {}
    spec = _flat(specs)
    out = {}
    for k, p in _flat(params).items():
        got = p.grad.to_local().detach()
        out[k] = _rel_err(got, ref[k][local_index(p.shape, spec[k], mesh)]
                          .to(got.device, got.dtype))
    return out


def _update_errors(params: dict, specs: dict, mesh, path: str) -> dict:
    """Against a single-device run saved at `path` (torch.save of
    {"start": , "final": } flat trees of the global params, the final
    one after the same steps; {} without them): per leaf, this rank's
    shard's
    ||(got - start) - (want - start)||_2 / ||want - start||_2 (in f64,
    on the shard's device), `start` the saved one (so a start that
    differs shows here too)."""
    from ray_tpu_torch.parallel.sharding import local_index

    ref = torch.load(path, mmap=True, weights_only=True)
    if "final" not in ref:
        return {}
    got, spec = _flat(params), _flat(specs)
    out = {}
    for k, t in got.items():
        index = local_index(t.shape, spec[k], mesh)
        have = t.to_local().detach()
        out[k] = _rel_update(*(x.to(have.device, torch.float64) for x in (
            ref["start"][k][index], have, ref["final"][k][index])))
    return out


def train(rank: int, world_size: int, family: str, config, sizes: dict,
          np_params: Optional[dict], batches: list, lr: float,
          device: str = "cpu", return_params: bool = True,
          rules: Optional[dict] = None, reference: Optional[str] = None,
          control: Optional[str] = None, digest: bool = False,
          grad_controls: tuple = (), generator: str = "cpu") -> dict:
    """One AdamW step per batch, each timed (host clock around a
    synchronize; the median leaves out the first, which warms up), the
    K1-K3 counts set to 0 just before the steps and read just after;
    the params' shards after these steps (`shards`, with
    `return_params`; with `digest`, a sha256 of their bytes, which
    replicas share, and one of the first step's gradients' shards,
    `grad_digest`), and each leaf's update against a single-device
    run's (`update_rel_err`, with `reference`, see `_update_errors`;
    where the reference also holds the first step's gradients, each
    leaf's first summed gradient against them, `grad_rel_err`); then
    one more step on the last batch under `collectives.measure()` for
    the share of a step spent in collectives, whose loss (`final_loss`)
    is the first that sees the last update.

    A batch is a global tokens array or a dict of arrays ("tokens",
    optional "loss_mask"), of any row count (`_feed`); `real_rows` and
    `chunk` are this rank's real rows of the first batch and the rows
    it holds (`sharding.row_split`).  Before the steps, each of
    `grad_controls` ("rank_means": each row rank's loss normalised by
    its own count and the ranks' averaged, the weighting an uneven
    split must not take) computes the first batch's summed gradients
    with its fault, read as `grad_rel_err` is (`grad_controls`).
    `peak_memory_gib` is the largest of the timed steps' peaks (each
    step's alone, `peak_memory_gib_by_step`), `host_seconds` this
    rank's host time by part (setup, grad controls, steps, checks, the
    measured step, the round trip), `init_seconds` the init's (to its
    last shard on the device), and `host_rss_gib` the rank's resident
    host memory before and after it (`_host_rss_gib`).

    The params come from `np_params` (the reference's numpy tree;
    placed by `shard_params` under `rules` when given, which the train
    step then moves into its own layout) or, when None, from the
    family's init on seed 0 from a generator on `generator` ("cpu", as
    the single-device `init_state(0)` draws them; "cuda", this rank's
    card, as a single-device init from a CUDA generator seeded 0 draws
    them).  `control` injects a fault the checks
    must catch: "no_grad_sync" skips the gradients' sums over the row
    axes, "no_update" the optimizer's step.  Also
    `constraint_round_trip`:
    the token table replicated by `with_logical_constraint` and sliced
    back equals its shard."""
    import torch.distributed as dist

    from ray_tpu_torch.models._functional import adamw, plan_for
    from ray_tpu_torch.models.convert import params_from_numpy
    from ray_tpu_torch.parallel import collectives
    from ray_tpu_torch.parallel.sharding import (local_index, row_split,
                                                 spec_of,
                                                 with_logical_constraint)

    if control is not None and control not in CONTROLS:
        raise ValueError(f"control {control!r} is not one of {CONTROLS}")
    if set(grad_controls) - set(GRAD_CONTROLS):
        raise ValueError(f"grad controls {grad_controls} are not in "
                         f"{GRAD_CONTROLS}")
    seconds, lap = {}, [time.perf_counter()]

    def clock(name):            # this rank's host seconds, by part
        now = time.perf_counter()
        seconds[name] = seconds.get(name, 0.0) + now - lap[0]
        lap[0] = now

    fam = _family(family)
    dev = _device(device)
    mesh = _mesh(sizes, device)
    init_state, train_step = fam.make_train_step(config, adamw(lr), mesh,
                                                 device=dev)
    host_before_init = _host_rss_gib()
    t_init = time.perf_counter()
    if np_params is None:
        state = init_state(torch.Generator(
            dev if generator == "cuda" else "cpu").manual_seed(0))
        _sync(dev)
    else:
        full = params_from_numpy(np_params, config, device="cpu")
        state = init_state(params=full if rules is None else
                           fam.shard_params(full, mesh, config, rules))
    init_seconds = time.perf_counter() - t_init
    host_after_init = _host_rss_gib()
    plan = plan_for(mesh, fam.param_specs(config))
    if control == "no_grad_sync":
        plan.sync_grads = lambda params: None
    if control == "no_update":
        state["opt_state"].step = lambda: None
    feed = [_feed(mesh, b) for b in batches]
    own, chunk = row_split(feed[0]["tokens"].shape[0], mesh)
    specs = _specs(fam, config, mesh)
    clock("setup")
    read_controls = {}
    for name in grad_controls:
        loss_ce = fam.fused_cross_entropy_spmd
        fam.fused_cross_entropy_spmd = _rank_means_ce
        try:
            fam.loss_fn(state["params"], feed[0], config, mesh).backward()
        finally:
            fam.fused_cross_entropy_spmd = loss_ce
        plan.sync_grads(state["params"])
        read_controls[name] = _grad_errors(state["params"], specs, mesh,
                                           reference)
        state["opt_state"].zero_grad(set_to_none=True)
    clock("grad_controls")
    _zero_flash_launches()
    losses, step_ms, first_grad, peaks = [], [], None, []
    grad_digest = None
    for batch in feed:
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        _sync(dev)
        t0 = time.perf_counter()
        state, metrics = train_step(state, batch)
        losses.append(float(metrics["loss"]))
        step_ms.append((time.perf_counter() - t0) * 1e3)
        peaks.append(_peak_gib(dev))
        clock("steps")
        if first_grad is None:
            first_grad = _grad_errors(state["params"], specs, mesh,
                                      reference)
            if digest:
                grad_digest = _digest(p.grad.to_local() for p in
                                      _flat(state["params"]).values())
            clock("checks")
    launches = _flash_launches()
    out = {"real_rows": own.stop - own.start, "chunk": chunk}
    if first_grad:
        out["grad_rel_err"] = first_grad
    if read_controls:
        out["grad_controls"] = read_controls
    if return_params:
        out["shards"] = local_shards(state["params"], specs, mesh)
    if reference is not None:
        out["update_rel_err"] = _update_errors(state["params"], specs, mesh,
                                               reference)
    if digest:
        out["params_digest"] = _digest(
            p.to_local() for p in _flat(state["params"]).values())
        out["grad_digest"] = grad_digest
    _sync(dev)
    clock("checks")
    t0 = time.perf_counter()
    with collectives.measure() as stats:
        state, metrics = train_step(state, feed[-1])
        final_loss = float(metrics["loss"])
    measured_ms = (time.perf_counter() - t0) * 1e3
    clock("measured_step")
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
        # The steps' peak alone: the checks' temporaries are not the
        # step's.
        "peak_memory_gib": None if dev.type != "cuda" else max(peaks),
        "peak_memory_gib_by_step": peaks,
        "init_seconds": init_seconds,
        "host_rss_gib": [host_before_init, host_after_init],
    })
    clock("round_trip")
    out["host_seconds"] = seconds
    return out


def init_shards(rank: int, world_size: int, family: str, config,
                sizes: dict, device: str = "cpu") -> dict:
    """The family's init on seed 0 under the mesh (`init_state(0)` of
    its `make_train_step`): each leaf's shard (`local_shards`); the most
    whole leaves the rank held at once while drawing, counted at each
    `MeshPlan.init_leaf` call (the leaf handed in, and those handed in
    before whose tensors are still alive); and the leaves whose shard
    shares the whole leaf's storage (and so would keep it alive)."""
    import weakref

    from ray_tpu_torch.models._functional import MeshPlan, adamw

    fam = _family(family)
    mesh = _mesh(sizes, device)
    init_state, _ = fam.make_train_step(config, adamw(1e-3), mesh,
                                        device=_device(device))
    handed, most, shared = [], [0], []
    init_leaf = MeshPlan.init_leaf

    def counted(plan, path, t, device):
        handed[:] = [r for r in handed if r() is not None]
        most[0] = max(most[0], len(handed) + 1)
        shard = init_leaf(plan, path, t, device)
        if (shard.to_local().untyped_storage().data_ptr()
                == t.untyped_storage().data_ptr()):
            shared.append(path)
        handed.append(weakref.ref(t))
        return shard

    MeshPlan.init_leaf = counted
    try:
        params = init_state(0)["params"]
    finally:
        MeshPlan.init_leaf = init_leaf
    return {"shards": local_shards(params, _specs(fam, config, mesh), mesh),
            "most_whole_leaves_alive": most[0], "shares_storage": shared}


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


def _host_rss_gib() -> Optional[float]:
    """This process's resident host memory now (VmRSS), in GiB; None
    where /proc does not report it.  (The peak is not read: `getrusage`'s
    maxrss of a spawned rank starts at its parent's size at the fork,
    and VmHWM is missing from some kernels' /proc.)"""
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) / 2 ** 20
    return None


def _digest(tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().view(torch.uint8).numpy())
    return h.hexdigest()


def _collective_stats(stats: dict, step_ms: float) -> dict:
    return {"calls": stats["calls"], "ms": stats["seconds"] * 1e3,
            "bytes": stats["bytes"], "step_ms": step_ms,
            "share": stats["seconds"] * 1e3 / step_ms,
            "by_op": {op: {"calls": o["calls"], "ms": o["seconds"] * 1e3,
                           "bytes": o["bytes"]}
                      for op, o in stats["by_op"].items()}}


def _coordinate(mesh) -> dict:
    return dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))


def _rel_update(start, got, want) -> float:
    """||(got - start) - (want - start)||_2 / ||want - start||_2."""
    moved = want.double() - start.double()
    return float((got.double() - want.double()).norm()
                 / moved.norm().clamp_min(1e-30))


def _rel_err(got, want) -> float:
    """||got - want||_2 / ||want||_2."""
    return _rel_update(torch.zeros_like(want), got, want)


def _tanh_stage(p, x):
    y = x @ p["w"]
    return torch.tanh(y + p["b"] if "b" in p else y)


def _mean_square(y, t):
    return ((y - t) ** 2).mean()


class _SumBoth(torch.autograd.Function):
    """A fault for `pipeline`'s control: an all-reduce whose backward
    sums the gradient over the group too."""

    @staticmethod
    def forward(ctx, x, group):
        from ray_tpu_torch.parallel import collectives

        ctx.group = group
        return collectives.all_reduce(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        from ray_tpu_torch.parallel import collectives

        return collectives.all_reduce(g.clone(), ctx.group), None


def pipeline(rank: int, world_size: int, sizes: dict, stages: dict,
             microbatches: np.ndarray, targets: Optional[np.ndarray] = None,
             control: Optional[str] = None, device: str = "cpu") -> dict:
    """`pipeline_apply` of `_tanh_stage` (tanh(x @ w [+ b])) with the
    stacked numpy `stages` (leading dim n_stages) on this rank's rows
    of `microbatches` [n_micro, B, D]: {"coordinate", "rows", "out"}.
    With `targets`, also `pipeline_loss_dryrun`'s mean-square loss and
    its gradients: of this rank's stage (summed over the row ranks, so
    each is the gradient of the replicated stage params, as the
    reference's `jax.grad` gives it) and of this rank's rows of the
    microbatches (summed over the stage group: only stage 0 reads
    them).  `control` "sum_backward" swaps the final all-reduce for one
    whose backward sums as well, a fault the gradient check must
    catch."""
    from ray_tpu_torch.parallel import collectives
    from ray_tpu_torch.parallel import pipeline as P
    from ray_tpu_torch.parallel.sharding import BATCH_AXES, local_index

    mesh = _mesh(sizes, device)
    dev = _device(device)
    coord = _coordinate(mesh)
    rows = local_index((microbatches.shape[1],), (BATCH_AXES,), mesh)[0]
    params = {k: torch.from_numpy(v).to(dev).requires_grad_()
              for k, v in stages.items()}
    mb = torch.from_numpy(microbatches[:, rows]).to(dev).requires_grad_()
    out = {"coordinate": coord, "rows": [rows.start, rows.stop],
           "out": _numpy(P.pipeline_apply(_tanh_stage, mesh, params, mb))}
    if targets is None:
        return out
    if control not in (None, "sum_backward"):
        raise ValueError(f"control {control!r}")
    original = collectives.all_reduce_value
    if control == "sum_backward":
        collectives.all_reduce_value = _SumBoth.apply
    try:
        loss = P.pipeline_loss_dryrun(
            _tanh_stage, _mean_square, mesh, params, mb,
            torch.from_numpy(targets[:, rows]).to(dev))
        grads = torch.autograd.grad(loss, list(params.values()) + [mb],
                                    allow_unused=True)
    finally:
        collectives.all_reduce_value = original
    row_group = collectives.axis_group(mesh, BATCH_AXES)
    stage_group = collectives.axis_group(mesh, ("stage",))
    stage = coord["stage"]
    out["loss"] = float(loss)
    out["grads"] = {k: _numpy(collectives.all_reduce(
        g[stage].contiguous(), row_group)) for k, g in zip(params, grads)}
    dmb = torch.zeros_like(mb) if grads[-1] is None else grads[-1]
    out["dmicrobatches"] = _numpy(collectives.all_reduce(
        dmb.contiguous(), stage_group))
    return out


def _mesh_or_none(sizes: Optional[dict], device: str):
    return None if sizes is None else _mesh(sizes, device)


def _timed_steps(dev, steps, step) -> tuple:
    """Run `step(i)` for each i, each timed on the host clock around a
    synchronize, with K1-K3's counts set to 0 just before and read just
    after: (results, step ms, launches)."""
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    _zero_flash_launches()
    results, step_ms = [], []
    for i in range(steps):
        _sync(dev)
        t0 = time.perf_counter()
        results.append(step(i))
        _sync(dev)
        step_ms.append((time.perf_counter() - t0) * 1e3)
    return results, step_ms, _flash_launches()


def _measured_step(dev, step) -> tuple:
    """One more step under `collectives.measure()`: (its result, the
    collective stats)."""
    from ray_tpu_torch.parallel import collectives

    _sync(dev)
    t0 = time.perf_counter()
    with collectives.measure() as stats:
        result = step()
        _sync(dev)
    return result, _collective_stats(stats, (time.perf_counter() - t0) * 1e3)


def _peak_gib(dev):
    return (torch.cuda.max_memory_allocated(dev) / 2 ** 30
            if dev.type == "cuda" else None)


def pipeline_gpt(rank: int, world_size: int, sizes: Optional[dict], config,
                 batches: list, lr: float, device: str = "cpu",
                 n_stages: int = 4, reference: Optional[str] = None,
                 save: Optional[str] = None,
                 control: Optional[str] = None) -> dict:
    """gpt's blocks as `n_stages` pipeline stages of n_layers / n_stages
    blocks each (hidden in, hidden out), one AdamW step per batch of
    tokens [n_micro, micro_batch, L] through `pipeline_loss_dryrun` on
    the `stage` axis of `sizes`: the embeddings are looked up before the
    stages and the final LayerNorm, the tied head and
    `fused_cross_entropy` (on the tokens rolled left, the last position
    masked) follow them, all fixed.  The params are the family's init on
    seed 0 (drawn on the CPU, as on one device), f32, the activations in
    `config.dtype`.  Returns the losses, step ms, K1-K3 launches,
    peak memory, then one more step on the last batch under
    `collectives.measure()` (its loss is the first that sees the last
    update); with `reference` (torch.save of {"start", "final", "grad"}:
    the one-device stacks, and the first step's gradients before the
    optimizer's) each stage leaf's update (`_rel_update`) and first
    gradient (`_rel_err`) against it.  With `sizes` None: every stage in
    turn on one device, its start and final stacks and first gradients
    saved to `save`.  `control` "sum_backward" swaps the final
    all-reduce for one whose backward sums as well, so that every stage
    takes n_stages times its gradient: a fault the gradient check must
    catch (AdamW's update barely moves under a common scale)."""
    from ray_tpu_torch.models import gpt
    from ray_tpu_torch.models._functional import adamw
    from ray_tpu_torch.ops.cross_entropy import fused_cross_entropy
    from ray_tpu_torch.parallel import collectives
    from ray_tpu_torch.parallel.pipeline import pipeline_loss_dryrun

    if control not in (None, "sum_backward"):
        raise ValueError(f"control {control!r}")
    c = config
    dev = _device(device)
    mesh = _mesh_or_none(sizes, device)
    stage = 0 if mesh is None else _coordinate(mesh)["stage"]
    full = gpt.init_params(c, torch.Generator().manual_seed(0),
                           device="cpu")
    per = c.n_layers // n_stages
    stack = {k: v.view((n_stages, per) + v.shape[1:])
             for k, v in full["blocks"].items()}
    own = stack if mesh is None else {k: v[stage:stage + 1]
                                      for k, v in stack.items()}
    params = {k: v.to(dev, copy=True).requires_grad_()
              for k, v in own.items()}
    start = {k: v.detach().clone() for k, v in own.items()}
    fixed = {k: full[k].to(dev) for k in ("tok_embed", "pos_embed",
                                          "final_ln_scale",
                                          "final_ln_bias")}
    head = fixed["tok_embed"].T.to(c.dtype)
    del full, stack
    opt = adamw(lr).init(params)

    def stage_fn(p, x):
        layers = {k: v.unbind(0) for k, v in p.items()}
        for i in range(per):
            x, _ = gpt._block(x, {k: v[i] for k, v in layers.items()}, c)
        return x

    def loss_fn(y, tokens):
        x = gpt._layernorm(y, fixed["final_ln_scale"],
                           fixed["final_ln_bias"])
        valid = torch.ones(tokens.shape, dtype=torch.float32,
                           device=tokens.device)
        valid[:, -1] = 0.0
        b, l, d = x.shape
        return fused_cross_entropy(
            x.reshape(b * l, d), head,
            torch.roll(tokens, -1, dims=1).reshape(-1), valid.reshape(-1))

    feed = [torch.from_numpy(b).to(dev) for b in batches]
    grad: dict = {}

    def step(tokens):
        opt.zero_grad(set_to_none=True)
        with torch.no_grad():
            hidden = (fixed["tok_embed"][tokens.long()]
                      + fixed["pos_embed"][:tokens.shape[-1]]).to(c.dtype)
        loss = pipeline_loss_dryrun(stage_fn, loss_fn, mesh, params, hidden,
                                    tokens)
        loss.backward()
        if not grad:
            grad.update({k: v.grad.detach().cpu().clone()
                         for k, v in params.items()})
        opt.step()
        return float(loss.detach())

    original = collectives.all_reduce_value
    if control == "sum_backward":
        collectives.all_reduce_value = _SumBoth.apply
    try:
        losses, step_ms, launches = _timed_steps(
            dev, len(feed), lambda i: step(feed[i]))
        final = {k: v.detach().cpu().clone() for k, v in params.items()}
        final_loss, stats = _measured_step(dev, lambda: step(feed[-1]))
    finally:
        collectives.all_reduce_value = original
    out = {"coordinate": None if mesh is None else _coordinate(mesh),
           "losses": losses, "step_ms": step_ms,
           "median_step_ms": statistics.median(step_ms[1:] or step_ms),
           "launches": launches, "peak_memory_gib": _peak_gib(dev),
           "final_loss": final_loss, "collectives": stats}
    if save is not None:
        torch.save({"start": start, "final": final, "grad": grad}, save)
    if reference is not None:
        ref = torch.load(reference, weights_only=True)
        own = slice(stage, stage + 1)
        out["update_rel_err"] = {
            k: _rel_update(start[k], final[k], ref["final"][k][own])
            for k in final}
        out["grad_rel_err"] = {k: _rel_err(grad[k], ref["grad"][k][own])
                               for k in grad}
        out["start_differs"] = [k for k in final if not torch.equal(
            start[k], ref["start"][k][own])]
    return out


def _split_resnet_step(k: int, device: torch.device):
    """A one-device ResNet train step that does the data = k mesh step's
    arithmetic in one place: the batch cut into k row chunks as
    `sharding.row_split` cuts it (each padded with zero images to the
    chunk a rank holds), each chunk's NLL summed over its real images,
    its f32 gradients, correct count and count computed alone, as a row
    rank computes its own, then summed in rank order and divided by the
    count, as `resnet.make_train_step` does, before the optimizer's
    step."""
    import torch.nn.functional as F

    from ray_tpu_torch.parallel.sharding import pad_rows

    def train_step(state: dict, batch: dict):
        model, opt = state["params"], state["opt_state"]
        opt.zero_grad(set_to_none=True)
        n = batch["labels"].shape[0]
        chunk = -(-n // k)
        loss = correct = 0.0
        for i in range(k):
            rows = slice(min(n, i * chunk), min(n, (i + 1) * chunk))
            real = rows.stop - rows.start
            logits = model(pad_rows(batch["images"][rows], chunk).to(
                device))[:real]
            labels = batch["labels"][rows].to(device).long()
            part = F.cross_entropy(logits.float(), labels, reduction="sum")
            part.backward()                     # adds into each .grad
            loss = loss + part.detach()
            correct = correct + (logits.argmax(-1) == labels).float().sum()
        count = torch.tensor(float(n), device=device)
        with torch.no_grad():
            for p in model.parameters():
                p.grad /= count
        opt.step()
        return (dict(state, step=state["step"] + 1),
                {"loss": loss / count, "accuracy": correct / count})

    return train_step


def _rank_means_totals(rows, tensors: list) -> list:
    """A fault for `resnet`'s control "rank_means": in place of
    `_Rows.totals` (the gradients of the summed NLL, the NLL sum, the
    correct count, then the count), each rank's sums divided by its own
    count and averaged over the row ranks, the count taken as 1."""
    from ray_tpu_torch.parallel import collectives

    count = tensors[-1].clamp_min(1.0)
    means = collectives.all_reduce_mean([t / count for t in tensors[:-1]],
                                        rows.group)
    return means + [torch.ones_like(count)]


def resnet(rank: int, world_size: int, sizes: Optional[dict], config,
           batches, lr: float, device: str = "cpu",
           params: Optional[dict] = None,
           references: Optional[dict] = None, save: Optional[str] = None,
           control: Optional[str] = None, split: int = 1) -> dict:
    """ResNet's `make_train_step(config, adamw(lr), mesh)` under `sizes`
    (None: one device), one step per batch: `batches` a list of
    {"images", "labels"} numpy (global), or {"seed", "steps", "batch",
    "image"} to draw them here (torch's CPU generator, normal images and
    uniform labels).  The params are `params` (a state dict of numpy,
    e.g. the reference's through convert.resnet_state_dict) or the init
    on seed 0.  Returns the losses, accuracies, step ms, peak memory and
    this rank's final state dict as numpy (`final`); with `references`
    ({name: path of a torch.save of {"start", "final"} state dicts})
    each leaf's update against each (`update_rel_err[name]`); with
    `save`, its own start and final saved there.  `control`
    "no_grad_sync" leaves every rank's gradients (and loss) its own, and
    "rank_means" averages the ranks' own means (`_rank_means_totals`):
    faults the checks must catch.  `split` k > 1 (one device only)
    takes each step as `_split_resnet_step` does.  A batch's rows need
    not split evenly over the row ranks (`resnet._Rows.local`)."""
    from ray_tpu_torch.models import resnet as R
    from ray_tpu_torch.models._functional import adamw

    if control not in (None, "no_grad_sync", "rank_means"):
        raise ValueError(f"control {control!r}")

    dev = _device(device)
    mesh = _mesh_or_none(sizes, device)
    if isinstance(batches, dict):
        gen = torch.Generator().manual_seed(batches["seed"])
        batches = [{"images": torch.randn(
            (batches["batch"],) + tuple(batches["image"]), generator=gen),
            "labels": torch.randint(0, config.num_classes,
                                    (batches["batch"],), generator=gen)}
            for _ in range(batches["steps"])]
    else:
        batches = [{k: torch.from_numpy(v) for k, v in b.items()}
                   for b in batches]
    init_state, train_step = R.make_train_step(config, adamw(lr), mesh,
                                               device=dev)
    if split > 1:
        if mesh is not None:
            raise ValueError("split is a one-device step")
        train_step = _split_resnet_step(split, dev)
    state = init_state(0, params=None if params is None else {
        k: torch.from_numpy(v) for k, v in params.items()})
    model = state["params"]
    start = {k: v.detach().cpu().clone()
             for k, v in model.state_dict().items()}

    def step(i):
        nonlocal state
        state, metrics = train_step(state, batches[i])
        return float(metrics["loss"]), float(metrics["accuracy"])

    totals = R._Rows.totals
    if control == "no_grad_sync":
        R._Rows.totals = lambda rows, tensors: list(tensors)
    if control == "rank_means":
        R._Rows.totals = _rank_means_totals
    try:
        results, step_ms, _ = _timed_steps(dev, len(batches), step)
    finally:
        R._Rows.totals = totals
    final = {k: v.detach().cpu().clone()
             for k, v in model.state_dict().items()}
    out = {"losses": [r[0] for r in results],
           "accuracies": [r[1] for r in results], "step_ms": step_ms,
           "median_step_ms": statistics.median(step_ms[1:] or step_ms),
           "peak_memory_gib": _peak_gib(dev),
           "final": {k: v.numpy() for k, v in final.items()}
           if references is None and save is None else None}
    if save is not None:
        torch.save({"start": start, "final": final}, save)
    if references is not None:
        out["update_rel_err"], out["start_differs"] = {}, set()
        for name, path in references.items():
            ref = torch.load(path, weights_only=True)
            out["update_rel_err"][name] = {
                k: _rel_update(start[k], final[k], ref["final"][k])
                for k in final}
            out["start_differs"] |= {k for k in final
                                     if not torch.equal(start[k],
                                                        ref["start"][k])}
        out["start_differs"] = sorted(out["start_differs"])
        out["digest"] = _digest(final.values())
    return out


def loss_grads(rank: int, world_size: int, family: str, config,
               sizes: dict, np_params: dict, tokens: np.ndarray,
               device: str = "cpu") -> dict:
    """The family's `loss_fn` under the mesh on the reference's numpy
    params (placed as the train step places them) and the global
    `tokens`, and each leaf's gradient summed as the train step sums it
    (`sync_grads`): {"loss", "grads": {leaf path: (index, local array)}}."""
    from ray_tpu_torch.models._functional import _map, plan_for
    from ray_tpu_torch.models.convert import params_from_numpy

    fam = _family(family)
    mesh = _mesh(sizes, device)
    plan = plan_for(mesh, fam.param_specs(config))
    params = plan.place(params_from_numpy(np_params, config, device="cpu"),
                        _device(device))
    loss = fam.loss_fn(params, {"tokens": torch.from_numpy(tokens)}, config,
                       mesh)
    loss.backward()
    plan.sync_grads(params)
    return {"loss": float(loss), "grads": local_shards(
        _map(params, lambda p: p.grad), _specs(fam, config, mesh), mesh)}


ROUTING_CONTROLS = ("capacity_from_padded",)


def routing(rank: int, world_size: int, sizes: Optional[dict], config,
            tokens: np.ndarray, device: str = "cpu",
            np_params: Optional[dict] = None,
            control: Optional[str] = None) -> dict:
    """gpt's Switch MoE trunk once (no step) under the mesh `sizes`
    (None: one device) on the global `tokens`, the params the
    reference's numpy `np_params` or the init from a generator seeded 0
    on `device` (every rank draws the whole tree, then keeps its
    shards), with `gpt._route` wrapped to keep each layer's capacity and
    how many real tokens it dropped (over the global batch: each rank's
    count summed over the row ranks).  Returns those lists, the aux
    summed over the layers, this rank's real rows and the chunk it
    holds.  `control` "capacity_from_padded" counts the pad rows' tokens
    in the capacity: a fault the capacity check must catch."""
    from ray_tpu_torch.models import gpt
    from ray_tpu_torch.models._functional import ONE_DEVICE, MeshPlan
    from ray_tpu_torch.models.convert import params_from_numpy
    from ray_tpu_torch.parallel import collectives
    from ray_tpu_torch.parallel.sharding import row_split

    if control not in (None,) + ROUTING_CONTROLS:
        raise ValueError(f"control {control!r}")
    dev = _device(device)
    mesh = _mesh_or_none(sizes, device)
    params = gpt.init_params(config, torch.Generator(dev).manual_seed(0),
                             device=dev) if np_params is None \
        else params_from_numpy(np_params, config, device="cpu")
    params = gpt._map(params, lambda t: t.to(dev)) if mesh is None \
        else gpt.shard_params(params, mesh, config, device=dev)
    capacity, dropped = [], []
    route, real_tokens = gpt._route, MeshPlan.real_tokens

    def record(x, router, config, plan=ONE_DEVICE, rows=None):
        out = route(x, router, config, plan, rows)
        rank_in_queue, cap = out[3], out[4]
        n = (rank_in_queue >= cap).sum().reshape(1).float()
        if plan is not ONE_DEVICE:
            n = collectives.all_reduce(n, plan.row_group)
        capacity.append(cap)
        dropped.append(int(n))
        return out

    gpt._route = record
    if control == "capacity_from_padded":
        MeshPlan.real_tokens = lambda plan, x: x.numel()
    try:
        with torch.no_grad():
            _, aux = gpt.forward_trunk(params, torch.from_numpy(tokens),
                                       config, mesh)
    finally:
        gpt._route, MeshPlan.real_tokens = route, real_tokens
    n = tokens.shape[0]
    own, chunk = (slice(0, n), n) if mesh is None else row_split(n, mesh)
    return {"real_rows": own.stop - own.start, "chunk": chunk,
            "capacity": capacity, "dropped": dropped, "aux": float(aux)}


def refusals(rank: int, world_size: int, cases: list,
             device: str = "cpu") -> dict:
    """What the reference refuses, each case on its own mesh of this
    group's ranks (gpt nano, its init on seed 0): {case: (the error's
    type name and message, the port's collectives called before it)}.
    Cases: "seq_length" (a train step on data2/seq2 with rows of length
    7), "seq_rows" (data2/seq2 with 3 rows), "shard_batch" (3 rows over
    data2/tensor2), "pipeline" (`pipeline_loss_dryrun` on data2/stage2
    with global microbatches of 3 rows, a DTensor), "placement"
    (`init_state` on tensor = world_size, which nano's dims do not
    divide when it is 3)."""
    from ray_tpu_torch.models import gpt
    from ray_tpu_torch.models._functional import adamw
    from ray_tpu_torch.parallel import collectives
    from ray_tpu_torch.parallel import pipeline as P
    from ray_tpu_torch.parallel.sharding import (BATCH_AXES, NamedSharding,
                                                 shard_batch)

    config = gpt.CONFIGS["nano"]
    dev = _device(device)

    def train_step(sizes, shape):
        init_state, step = gpt.make_train_step(config, adamw(1e-3),
                                               _mesh(sizes, device),
                                               device=dev)
        state = init_state(0)
        return lambda: step(state, {"tokens": torch.zeros(shape,
                                                          dtype=torch.long)})

    def pipeline():
        mesh = _mesh(dict(data=2, stage=2), device)
        mb = NamedSharding(mesh, (None, BATCH_AXES)).wrap(
            torch.zeros(2, 2, 4), (2, 3, 4), dev)
        params = {"w": torch.zeros(2, 4, 4, device=dev)}
        return lambda: P.pipeline_loss_dryrun(_tanh_stage, _mean_square,
                                              mesh, params, mb, mb)

    def placement():
        init_state, _ = gpt.make_train_step(
            config, adamw(1e-3), _mesh(dict(tensor=world_size), device),
            device=dev)
        return lambda: init_state(0)

    build = {
        "seq_length": lambda: train_step(dict(data=2, seq=2), (2, 7)),
        "seq_rows": lambda: train_step(dict(data=2, seq=2), (3, 8)),
        "shard_batch": lambda: (lambda mesh: lambda: shard_batch(
            mesh, {"tokens": torch.zeros(3, 8)}))(
                _mesh(dict(data=2, tensor=2), device)),
        "pipeline": pipeline,
        "placement": placement,
    }
    out = {}
    for case in cases:
        call = build[case]()
        with collectives.measure() as stats:
            try:
                call()
                error = None
            except Exception as e:              # the refusal under test
                error = (type(e).__name__, str(e))
        out[case] = (error, stats["calls"])
    return out


def learner(rank: int, world_size: int, kind: str, args: tuple,
            kwargs: dict, state: Optional[dict], batches: list,
            permutations: Optional[list] = None,
            device: str = "cpu") -> dict:
    """An RL learner data-parallel over every rank (a DeviceMesh of
    data = world_size): `TorchLearner(*args, **kwargs)` (kind "ppo") or
    `_VTraceLearner(*args, **kwargs)` (kind "vtrace"), its state set to
    `state` (either package's layout) when given, one update per batch.
    With `permutations` (one [n] array per epoch, in order), the
    TorchLearner's shuffles are these (e.g. the reference's own draws)
    instead of its generator's.  Returns each update's metrics and the
    final weights."""
    from ray_tpu_torch.parallel.mesh import create_mesh
    from ray_tpu_torch.rllib.impala import _VTraceLearner
    from ray_tpu_torch.rllib.learner import TorchLearner

    cls = {"ppo": TorchLearner, "vtrace": _VTraceLearner}[kind]
    mesh = create_mesh(MeshConfig(data=world_size), device=device)
    ln = cls(*args, mesh=mesh, device=device, **kwargs)
    if state is not None:
        ln.set_state(state)
    if permutations is not None:
        draws = iter(permutations)
        ln._permutation = lambda n: torch.from_numpy(
            np.asarray(next(draws), np.int64))
    metrics = [ln.update(b) for b in batches]
    return {"metrics": metrics, "weights": ln.get_weights()}


def imported(rank: int, world_size: int, packages: tuple) -> list:
    """The modules this rank has imported from `packages` (top-level
    names), sorted."""
    import sys

    return sorted(m for m in sys.modules if m.split(".")[0] in packages)


def gang_keep(rank: int, world_size: int, state: dict, value):
    """Keep `value` in a `RankGang` rank's state; return what was kept
    before (None the first time)."""
    before = state.get("kept")
    state["kept"] = value
    return before


def gang_stall(rank: int, world_size: int, state: dict, who: int) -> int:
    """Rank `who` waits in a barrier that no other rank joins (a hung
    rank, for a gang's timeout); the others return at once."""
    import torch.distributed as dist

    if rank == who:
        dist.barrier()
    return rank


def sequence(rank: int, world_size: int, calls: list) -> list:
    """[(name, args)] -> the results of the bodies named, in turn."""
    return [globals()[name](rank, world_size, *args) for name, args in calls]
