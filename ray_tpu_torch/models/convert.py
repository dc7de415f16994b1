"""Carry weights and train states across from the JAX reference.

The reference initialises with `jax.random`, whose draws no torch
generator reproduces, so the two packages compute the same thing only on
weights moved across: take the reference's GPT or Llama params as numpy
(`jax.tree.map(np.asarray, params)`) and turn them into the port's
params — same keys, same stacked layouts, same dtypes.  `params_to_numpy`
goes the other way, so the reference can be handed the port's weights
(or updated params compared leaf by leaf).  `resnet_state_dict` and
`resnet_variables` do the same for a ResNet: flax's variables tree and
the port's module's state dict (conv kernels HWIO <-> OIHW).

`train_state_from_numpy` and `train_state_to_tree` carry a whole train
state, `optax.adamw`'s moments and step count included, so a run that
either package checkpointed continues in the other.

The RL models (`ray_tpu_torch.rllib.models`) have their own pair,
`actor_critic_state_dict` / `actor_critic_variables` (a flax Dense
kernel [in, out] <-> a Linear weight [out, in], a flax Conv kernel HWIO
<-> a Conv2d weight OIHW, the free `log_std` as it is; the recurrent
model's plain dict as it is), and their learners' optimizer states
theirs: `rl_adam_state` / `rl_opt_state_tree` for
optax.chain(clip_by_global_norm, adam)'s tree, and `adam_state` /
`adam_state_tree` with `model_moments` / `moments_tree` for any
ScaleByAdamState(count, mu, nu) over one model, a tuple of models (SAC's
and TD3's critic optimizer spans q1 and q2) or a scalar, under optax's
namedtuple skeleton.  `qmix_state_dict` / `qmix_variables` carry QMIX's
and VDN's plain param dict ({"agent1": {"w", "b"}, ..., "hyper_b2_2"},
every w [in, out] on both sides).
"""

from __future__ import annotations

import collections

import numpy as np
import torch

from ray_tpu_torch._device import DeviceLike, resolve_device
from ray_tpu_torch.models import gpt, llama, resnet
from ray_tpu_torch.models._functional import _leaves, _map


def _tensor(arr) -> torch.Tensor:
    if isinstance(arr, torch.Tensor):      # e.g. from restore_sharded
        return arr.detach()
    arr = np.array(arr, order="C")     # a writable copy the tensor owns
    if arr.dtype.name == "bfloat16":        # ml_dtypes: no numpy-native bf16
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


_SHAPES = {gpt.GPTConfig: gpt.param_shapes,
           llama.LlamaConfig: llama.param_shapes}


def params_from_numpy(tree: dict, config, device: DeviceLike = None) -> dict:
    """The reference's param tree (numpy leaves; tensor leaves, e.g. from
    `restore_sharded`, are taken as they are) of the family that
    `config` names (a `gpt.GPTConfig` or a `llama.LlamaConfig`) as the
    port's params on `device`.  Raises if a key or a shape differs from
    that family's `param_shapes(config)`."""
    device = resolve_device(device)
    if type(config) not in _SHAPES:
        raise TypeError(f"params_from_numpy: no model family for config "
                        f"{type(config).__name__}")

    def convert(sub, shapes, path):
        if set(sub) != set(shapes):
            raise ValueError(f"params{path}: keys {sorted(sub)} != "
                             f"expected {sorted(shapes)}")
        out = {}
        for key, want in shapes.items():
            if isinstance(want, dict):
                out[key] = convert(sub[key], want, f"{path}[{key!r}]")
                continue
            t = _tensor(sub[key])
            if tuple(t.shape) != want:
                raise ValueError(f"params{path}[{key!r}]: shape "
                                 f"{tuple(t.shape)} != expected {want}")
            out[key] = t.to(device)
        return out

    return convert(tree, _SHAPES[type(config)](config), "")


def _numpy(t: torch.Tensor) -> np.ndarray:
    """A host copy of `t` (bf16 as ml_dtypes' bfloat16)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes

        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy().copy()


def params_to_numpy(params) -> dict:
    """The inverse of `params_from_numpy`: the port's params as a tree of
    numpy arrays on the host (bf16 leaves as ml_dtypes' bfloat16)."""
    return {k: params_to_numpy(v) if isinstance(v, dict) else _numpy(v)
            for k, v in params.items()}


def _is_conv(path: str) -> bool:
    return path.rpartition(".")[0].rpartition(".")[2].startswith("Conv_")


def resnet_state_dict(variables: dict, config: resnet.ResNetConfig,
                      device: DeviceLike = None) -> dict:
    """flax's variables tree ({"params": {...}}, numpy or tensor leaves)
    of the reference's ResNet as the state dict of `resnet.ResNet(config)`
    on `device`.  Raises if a key or a shape differs."""
    device = resolve_device(device)
    want = resnet.ResNet(config).state_dict()
    flat = {}

    def walk(sub, path):
        for k, v in sub.items():
            if isinstance(v, dict):
                walk(v, f"{path}{k}.")
            else:
                flat[path + k] = v

    walk(variables["params"], "")
    if set(flat) != set(want):
        raise ValueError(f"resnet params: keys {sorted(flat)} != expected "
                         f"{sorted(want)}")
    out = {}
    for key, arr in flat.items():
        t = _tensor(arr)
        if _is_conv(key):
            t = t.permute(3, 2, 0, 1).contiguous()     # HWIO -> OIHW
        if t.shape != want[key].shape:
            raise ValueError(f"resnet params[{key!r}]: shape "
                             f"{tuple(t.shape)} != expected "
                             f"{tuple(want[key].shape)}")
        out[key] = t.to(device)
    return out


def resnet_variables(model: resnet.ResNet) -> dict:
    """The inverse of `resnet_state_dict`: a port ResNet's parameters as
    flax's variables tree of numpy arrays."""
    params: dict = {}
    for key, t in model.state_dict().items():
        if _is_conv(key):
            t = t.permute(2, 3, 1, 0)                  # OIHW -> HWIO
        *path, leaf = key.split(".")
        node = params
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = _numpy(t)
    return {"params": params}


# optax.adamw's state is (ScaleByAdamState(count, mu, nu), EmptyState(),
# EmptyState()).  These types carry optax's names and modules without
# importing it, so a checkpoint of `train_state_to_tree` has the
# skeleton of the reference's own train state.
ScaleByAdamState = collections.namedtuple(
    "ScaleByAdamState", ("count", "mu", "nu"), module="optax._src.transform")
EmptyState = collections.namedtuple("EmptyState", (),
                                    module="optax._src.base")


def train_state_from_numpy(tree: dict, config, optimizer,
                           device: DeviceLike = None) -> dict:
    """The reference's GPT or Llama train state {"params", "opt_state",
    "step"} under `optax.adamw` (numpy or tensor leaves, e.g. from
    either package's `restore_sharded`) as the port's state on `device`:
    {"params", "opt_state": `optimizer.init(params)` (a
    torch.optim.AdamW), "step"}, each param's AdamW state holding the
    reference's moments (`mu` -> `exp_avg`, `nu` -> `exp_avg_sq`) and
    step count (`count` -> `step`).  The port's next step is then the
    reference's next step.  `opt_state[0]` may be a plain tuple
    (count, mu, nu)."""
    device = resolve_device(device)
    params = _map(params_from_numpy(tree["params"], config, device),
                  lambda t: t.float().requires_grad_())
    count, mu, nu = tree["opt_state"][0]
    opt = optimizer.init(params)
    # Fused and capturable AdamW keep the step count on the param's device.
    on_device = opt.defaults.get("fused") or opt.defaults.get("capturable")
    for p, m, v in zip(_leaves(params),
                       _leaves(params_from_numpy(mu, config, device)),
                       _leaves(params_from_numpy(nu, config, device))):
        opt.state[p] = {
            "step": torch.tensor(float(count), dtype=torch.float32,
                                 device=p.device if on_device else "cpu"),
            "exp_avg": m.float(), "exp_avg_sq": v.float()}
    return {"params": params, "opt_state": opt, "step": int(tree["step"])}


def train_state_to_tree(state: dict) -> dict:
    """The inverse of `train_state_from_numpy`: the port's GPT or Llama
    train state in the reference's layout under `optax.adamw`
    ({"params", "opt_state": (ScaleByAdamState(count, mu, nu),
    EmptyState(), EmptyState()), "step"}, count and step int32).  The
    leaves are the state's own tensors, on its device and copied
    nowhere: `checkpoint.sharded.stage` takes the one host snapshot."""
    opt = state["opt_state"]

    def moment(name):
        return _map(state["params"], lambda p: (
            opt.state[p][name] if p in opt.state
            else torch.zeros_like(p)).detach())

    steps = {float(s["step"]) for s in opt.state.values()}
    if len(steps) > 1:
        raise ValueError(f"params at different AdamW steps: {steps}")
    count = int(steps.pop()) if steps else 0
    return {"params": _map(state["params"], torch.Tensor.detach),
            "opt_state": (ScaleByAdamState(
                torch.tensor(count, dtype=torch.int32), moment("exp_avg"),
                moment("exp_avg_sq")), EmptyState(), EmptyState()),
            "step": torch.tensor(state["step"], dtype=torch.int32)}


# ---------------------------------------------------------------- RL models

def _to_torch_layout(key: str, t: torch.Tensor) -> torch.Tensor:
    """One flax leaf of an actor-critic in the port's layout: a Dense
    kernel [in, out] -> [out, in], a Conv kernel HWIO -> OIHW."""
    if not key.endswith(".kernel"):
        return t
    return (t.permute(3, 2, 0, 1) if t.dim() == 4 else t.t()).contiguous()


def _to_flax_layout(key: str, t: torch.Tensor) -> torch.Tensor:
    if not key.endswith(".weight"):
        return t
    return t.permute(2, 3, 1, 0) if t.dim() == 4 else t.t()


def _flat_flax(tree: dict) -> dict:
    """{"Dense_0.kernel": leaf, ..., "log_std": leaf} of a flax params
    dict (a free parameter sits at the top, beside the layers)."""
    flat = {}
    for layer, sub in tree.items():
        if isinstance(sub, dict):
            flat.update({f"{layer}.{name}": leaf
                         for name, leaf in sub.items()})
        else:
            flat[layer] = sub
    return flat


def _flat_recurrent(tree: dict) -> dict:
    """{"enc.0.w": leaf, ..., "lstm.wx": leaf, ...} of the reference's
    recurrent param dict ({"enc": [{"w", "b"}, ...], "lstm": {"wx", "wh",
    "b"}, "pi": {"w", "b"}, "vf": {"w", "b"}})."""
    flat = {f"enc.{i}.{name}": leaf for i, layer in enumerate(tree["enc"])
            for name, leaf in layer.items()}
    for part in ("lstm", "pi", "vf"):
        flat.update({f"{part}.{name}": leaf
                     for name, leaf in tree[part].items()})
    return flat


def actor_critic_state_dict(variables: dict, model) -> dict:
    """The reference's weights of an RL model as the state dict of the
    port's `model` (the same class at the same widths), on the model's
    device; numpy or tensor leaves.

    - a flax variables tree ({"params": {"Dense_0": {"kernel", "bias"},
      ..., "log_std"}}) of `ActorCritic`, `ConvActorCritic`,
      `GaussianActorCritic`, `SquashedGaussianActor`,
      `DeterministicActor` or `QNetwork`: Dense kernels [in, out] become
      Linear weights [out, in], Conv kernels HWIO Conv2d weights OIHW;
    - the recurrent model's plain dict ({"enc", "lstm", "pi", "vf"}),
      whose [in, out] matrices the port keeps as they are.

    Raises if a key or a shape differs."""
    want = model.state_dict()
    if "params" in variables:
        flat = {k.replace(".kernel", ".weight"):
                _to_torch_layout(k, _tensor(v))
                for k, v in _flat_flax(variables["params"]).items()}
    else:
        flat = {k: _tensor(v) for k, v in _flat_recurrent(variables).items()}
    if set(flat) != set(want):
        raise ValueError(f"actor-critic params: keys {sorted(flat)} != "
                         f"expected {sorted(want)}")
    for key, t in flat.items():
        if t.shape != want[key].shape:
            raise ValueError(f"actor-critic params[{key!r}]: shape "
                             f"{tuple(t.shape)} != expected "
                             f"{tuple(want[key].shape)}")
    return {k: flat[k].to(want[k].device, want[k].dtype) for k in want}


def actor_critic_variables(tensors) -> dict:
    """The inverse of `actor_critic_state_dict`: a port RL model (or any
    {name: tensor} in its state dict's names, e.g. its gradients or Adam
    moments) as the reference's tree of numpy arrays: flax's variables
    tree, or the recurrent model's plain dict."""
    if isinstance(tensors, torch.nn.Module):
        tensors = tensors.state_dict()
    if "lstm.wx" in tensors:
        tree: dict = {"enc": []}
        for key, t in tensors.items():
            part, _, name = key.rpartition(".")
            if part.startswith("enc."):
                i = int(part[4:])
                while len(tree["enc"]) <= i:
                    tree["enc"].append({})
                tree["enc"][i][name] = _numpy(t)
            else:
                tree.setdefault(part, {})[name] = _numpy(t)
        return tree
    params: dict = {}
    for key, t in tensors.items():
        layer, _, name = key.rpartition(".")
        if not layer:                  # a free parameter (log_std)
            params[key] = _numpy(t)
            continue
        flax_name = "kernel" if name == "weight" else name
        params.setdefault(layer, {})[flax_name] = _numpy(
            _to_flax_layout(key, t))
    return {"params": params}


# optax.chain(clip_by_global_norm, adam(lr)) keeps (EmptyState(),
# (ScaleByAdamState(count, mu, nu), EmptyState())); with a schedule the
# last is ScaleByScheduleState(count).
ScaleByScheduleState = collections.namedtuple(
    "ScaleByScheduleState", ("count",), module="optax._src.transform")


def model_moments(tree, models) -> list:
    """One Adam moment of the reference (a tree shaped like the weights
    of `models`: one RL model's, or a tuple of trees for a tuple of
    models, as an optimizer over (q1, q2) keeps it) as a list of f32
    tensors in the order of the models' state dicts, on their device."""
    if not isinstance(models, (tuple, list)):
        models, tree = (models,), (tree,)
    out = []
    for m, t in zip(models, tree):
        sd = actor_critic_state_dict(t, m)
        out += [sd[k].float() for k in m.state_dict()]
    return out


def moments_tree(moments, models):
    """The inverse of `model_moments`: a list of tensors in the order of
    the models' state dicts as the reference's tree (numpy)."""
    if not isinstance(models, (tuple, list)):
        return actor_critic_variables(dict(zip(models.state_dict(),
                                               moments)))
    trees, at = [], 0
    for m in models:
        keys = list(m.state_dict())
        trees.append(actor_critic_variables(dict(zip(
            keys, moments[at:at + len(keys)]))))
        at += len(keys)
    return tuple(trees)


def adam_state(state, moments) -> tuple:
    """optax.scale_by_adam's ScaleByAdamState(count, mu, nu) (namedtuple
    or tuple, numpy or tensor leaves) as (int count, moments(mu),
    moments(nu))."""
    count, mu, nu = state
    return int(count), moments(mu), moments(nu)


def adam_state_tree(count: int, mu, nu, tree) -> "ScaleByAdamState":
    """The inverse of `adam_state`: count (int32) and tree(mu), tree(nu)
    under optax's ScaleByAdamState."""
    return ScaleByAdamState(np.asarray(count, np.int32), tree(mu), tree(nu))


def rl_adam_state(opt_state, model) -> tuple:
    """An RL learner's optax state (the tree above; numpy or tensor
    leaves, namedtuples or plain tuples) as (count, mu, nu): the step
    count as an int and the moments as lists of tensors in the order of
    `model.state_dict()`, in its layouts, on its device."""
    return adam_state(opt_state[1][0],
                      lambda tree: model_moments(tree, model))


def rl_opt_state_tree(count: int, mu, nu, model,
                      schedule: bool = False) -> tuple:
    """The inverse of `rl_adam_state`: count and the moments (lists in
    the order of `model.state_dict()`) as optax's tree of numpy arrays,
    count int32, with ScaleByScheduleState(count) last when the learner
    runs a learning-rate schedule."""
    c = np.asarray(count, np.int32)
    return (EmptyState(), (
        adam_state_tree(count, mu, nu,
                        lambda moments: moments_tree(moments, model)),
        ScaleByScheduleState(c) if schedule else EmptyState()))


def qmix_state_dict(params: dict, model) -> dict:
    """The reference's QMIX / VDN param dict ({layer: {"w", "b"}}; numpy
    or tensor leaves) as the state dict of the port's `QMixNet`, on the
    model's device.  Raises if a key or a shape differs."""
    want = model.state_dict()
    flat = {f"{layer}.{name}": _tensor(leaf)
            for layer, sub in params.items() for name, leaf in sub.items()}
    if set(flat) != set(want):
        raise ValueError(f"qmix params: keys {sorted(flat)} != expected "
                         f"{sorted(want)}")
    for key, t in flat.items():
        if t.shape != want[key].shape:
            raise ValueError(f"qmix params[{key!r}]: shape "
                             f"{tuple(t.shape)} != expected "
                             f"{tuple(want[key].shape)}")
    return {k: flat[k].to(want[k].device, want[k].dtype) for k in want}


def qmix_variables(tensors) -> dict:
    """The inverse of `qmix_state_dict`: a `QMixNet` (or any {name:
    tensor} in its state dict's names, e.g. its gradients) as the
    reference's param dict of numpy arrays."""
    if isinstance(tensors, torch.nn.Module):
        tensors = tensors.state_dict()
    out: dict = {}
    for key, t in tensors.items():
        layer, _, name = key.rpartition(".")
        out.setdefault(layer, {})[name] = _numpy(t)
    return out
