"""ResNet image models (port of ray_tpu/models/resnet.py): GroupNorm in
place of BatchNorm, NHWC images, the reference's three configs.

`ResNet` is an `nn.Module` whose submodules and parameters carry the
flax param tree's names (`Conv_0.kernel`, `GroupNorm_0.scale`,
`_Block_1.Conv_2.kernel`, `Dense_0.kernel`, ...), so
`convert.resnet_state_dict` carries the reference's weights across; only
the conv kernels change layout (flax HWIO, torch OIHW).  Params are
fp32; the convolutions and norms compute in `config.dtype`, the final
Dense in f32, as in the reference.  Convolutions go through cuDNN on a
card (the reference has no Pallas kernel here).

What flax does that torch's defaults do not:
- `padding="SAME"` pads max((ceil(n / s) - 1) * s + k - n, 0) in all,
  the odd one at the bottom and right, which torch's symmetric
  `padding` cannot say: `_pad_same` pads explicitly;
- `max_pool(..., padding="SAME")` pads with -inf;
- GroupNorm's epsilon is 1e-6 and its statistics are f32 under a bf16
  dtype, the variance as E[x^2] - E[x]^2 clipped at 0.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ray_tpu_torch._device import DeviceLike, resolve_device
from ray_tpu_torch.models._functional import multi_device
from ray_tpu_torch.parallel import collectives
from ray_tpu_torch.parallel.sharding import (BATCH_AXES, mesh_device,
                                             pad_rows, row_split)


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    stage_sizes: Tuple[int, ...] = (2, 2, 2, 2)   # resnet18
    num_classes: int = 10
    width: int = 64
    bottleneck: bool = False
    cifar_stem: bool = True    # 3x3/1 stem (32x32 inputs) vs 7x7/2+pool
    num_groups: int = 8        # GroupNorm groups
    dtype: Any = torch.float32


CONFIGS = {
    "resnet18-cifar": ResNetConfig(),
    "resnet18": ResNetConfig(cifar_stem=False),
    "resnet50": ResNetConfig(stage_sizes=(3, 4, 6, 3), bottleneck=True,
                             cifar_stem=False, num_classes=1000,
                             dtype=torch.bfloat16),
}


def _same(n: int, k: int, s: int) -> Tuple[int, int]:
    """flax/XLA "SAME" padding of one spatial dim: (before, after)."""
    out = -(-n // s)
    total = max((out - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def _pad_same(x, k: int, s: int, value: float = 0.0):
    """x [B, H, W, C] padded for a SAME k x k window at stride s."""
    (top, bottom), (left, right) = (_same(x.shape[1], k, s),
                                    _same(x.shape[2], k, s))
    if top == bottom == left == right == 0:
        return x
    return F.pad(x, (0, 0, left, right, top, bottom), value=value)


class _Conv(nn.Module):
    """flax nn.Conv(f, (k, k), (s, s), padding="SAME", use_bias=False)
    over NHWC; the kernel is stored OIHW."""

    def __init__(self, c_in: int, c_out: int, k: int, s: int, dtype):
        super().__init__()
        self.k, self.s, self.dtype = k, s, dtype
        self.kernel = nn.Parameter(torch.empty(c_out, c_in, k, k))

    def forward(self, x):
        x = _pad_same(x.to(self.dtype), self.k, self.s)
        # An NHWC tensor seen as NCHW is channels_last, cuDNN's layout.
        y = F.conv2d(x.permute(0, 3, 1, 2), self.kernel.to(
            self.dtype, memory_format=torch.channels_last), stride=self.s)
        return y.permute(0, 2, 3, 1)


class _GroupNorm(nn.Module):
    """flax nn.GroupNorm(num_groups, dtype) over the channels of NHWC."""

    def __init__(self, channels: int, num_groups: int, dtype,
                 eps: float = 1e-6):
        super().__init__()
        self.groups, self.dtype, self.eps = num_groups, dtype, eps
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        b, h, w, c = x.shape
        x32 = x.float().reshape(b, h * w, self.groups, c // self.groups)
        mean = x32.mean((1, 3), keepdim=True)
        var = (x32.square().mean((1, 3), keepdim=True)
               - mean.square()).clamp_min(0.0)
        mul = torch.rsqrt(var + self.eps) * self.scale.view(
            1, 1, self.groups, -1)
        y = (x32 - mean) * mul + self.bias.view(1, 1, self.groups, -1)
        return y.reshape(b, h, w, c).to(self.dtype)


class _Dense(nn.Module):
    """flax nn.Dense(n, dtype=f32): kernel [in, out], bias [out]."""

    def __init__(self, c_in: int, c_out: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(c_in, c_out))
        self.bias = nn.Parameter(torch.zeros(c_out))

    def forward(self, x):
        return x.float() @ self.kernel + self.bias


class _Block(nn.Module):
    """The reference's `_Block`: basic (two 3x3) or bottleneck (1x1,
    3x3, 1x1 x4), with a 1x1 projection of the residual when the width
    or the stride changes.  Convs and norms are numbered in the order
    flax creates them: the projection's first."""

    def __init__(self, c_in: int, filters: int, strides: int,
                 bottleneck: bool, num_groups: int, dtype):
        super().__init__()
        out = filters * (4 if bottleneck else 1)
        self.project = c_in != out or strides != 1
        convs = []
        if self.project:
            convs.append((c_in, out, 1, strides))
        if bottleneck:
            convs += [(c_in, filters, 1, 1), (filters, filters, 3, strides),
                      (filters, out, 1, 1)]
        else:
            convs += [(c_in, filters, 3, strides), (filters, out, 3, 1)]
        for i, (ci, co, k, s) in enumerate(convs):
            self.add_module(f"Conv_{i}", _Conv(ci, co, k, s, dtype))
            self.add_module(f"GroupNorm_{i}",
                            _GroupNorm(co, num_groups, dtype))
        self.n = len(convs)

    def forward(self, x):
        layers = [(getattr(self, f"Conv_{i}"), getattr(self, f"GroupNorm_{i}"))
                  for i in range(self.n)]
        residual = x
        if self.project:
            conv, norm = layers.pop(0)
            residual = norm(conv(x))
        y = x
        for i, (conv, norm) in enumerate(layers):
            y = norm(conv(y))
            if i < len(layers) - 1:
                y = F.relu(y)
        return F.relu(y + residual)


class ResNet(nn.Module):
    """images [B, H, W, C] float -> logits [B, num_classes] f32."""

    def __init__(self, config: ResNetConfig, in_channels: int = 3):
        super().__init__()
        c = self.config = config
        k, s = (3, 1) if c.cifar_stem else (7, 2)
        self.Conv_0 = _Conv(in_channels, c.width, k, s, c.dtype)
        self.GroupNorm_0 = _GroupNorm(c.width, c.num_groups, c.dtype)
        width, n = c.width, 0
        for i, n_blocks in enumerate(c.stage_sizes):
            for j in range(n_blocks):
                block = _Block(width, c.width * 2 ** i,
                               2 if j == 0 and i > 0 else 1, c.bottleneck,
                               c.num_groups, c.dtype)
                self.add_module(f"_Block_{n}", block)
                width = c.width * 2 ** i * (4 if c.bottleneck else 1)
                n += 1
        self.n_blocks = n
        self.Dense_0 = _Dense(width, c.num_classes)

    def forward(self, images):
        c = self.config
        x = self.Conv_0(images)
        if not c.cifar_stem:
            x = _pad_same(x, 3, 2, value=-math.inf)
            x = F.max_pool2d(x.permute(0, 3, 1, 2), 3, 2).permute(0, 2, 3, 1)
        x = F.relu(self.GroupNorm_0(x))
        for i in range(self.n_blocks):
            x = getattr(self, f"_Block_{i}")(x)
        # jnp.mean of a bf16 array sums in f32 and rounds to bf16.
        x = x.float().mean((1, 2)).to(c.dtype)
        return self.Dense_0(x)


def make_model(config: ResNetConfig, *,
               generator: Optional[torch.Generator] = None,
               device: DeviceLike = None) -> ResNet:
    """A ResNet on `device` (None -> CUDA) with flax's initialisers: conv
    and Dense kernels lecun-normal (a normal truncated at 2 sigma, fan
    in), GroupNorm scales 1, biases 0.  The draws come from `generator`
    (default: a CPU generator seeded 0) and differ from `jax.random`'s;
    to run both packages on the same weights use
    convert.resnet_state_dict."""
    device = resolve_device(device)
    gen = generator if generator is not None else \
        torch.Generator().manual_seed(0)
    model = ResNet(config)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if not name.endswith("kernel"):
                continue
            fan_in = p.shape[0] if p.dim() == 2 else math.prod(p.shape[1:])
            # Variance 1 / fan_in after the truncation, as flax scales it.
            std = math.sqrt(1.0 / fan_in) / .87962566103423978
            draw = torch.empty(p.shape, device=gen.device)
            torch.nn.init.trunc_normal_(draw, std=std, a=-2 * std,
                                        b=2 * std, generator=gen)
            p.copy_(draw)
    return model.to(device)


def num_params(config: ResNetConfig) -> int:
    return sum(p.numel() for p in ResNet(config).parameters())


class _Rows:
    """A train step's data-parallel plan on this rank of `mesh`: its
    rows of a batch (`sharding`'s "batch" rule), and the group of row
    ranks over which the gradients of the summed loss, the loss, the
    correct count and the real count are summed (`totals`)."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.group = collectives.axis_group(mesh, BATCH_AXES)
        self.device = mesh_device(mesh)

    def local(self, x) -> tuple:
        """(this rank's rows of a batch leaf, how many are real): a
        DTensor's local tensor (placed evenly), or GSPMD's split of a
        plain (global) tensor (`sharding.row_split`: the rank's real
        rows, then zero rows up to the chunk every row rank holds)."""
        from torch.distributed.tensor import DTensor

        if isinstance(x, DTensor):
            x = x.to_local()
            return x.to(self.device), x.shape[0]
        x = torch.as_tensor(x)
        own, chunk = row_split(x.shape[0], self.mesh)
        return pad_rows(x[own], chunk).to(self.device), own.stop - own.start

    def totals(self, tensors: list) -> list:
        return collectives.all_reduce_sum(tensors, self.group)


def make_train_step(config: ResNetConfig, optimizer, mesh=None, *,
                    device: DeviceLike = None):
    """(init_state, train_step): batch = {"images" [B,H,W,C], "labels"
    [B]} -> (state, {"loss", "accuracy"}), on `device` (None -> CUDA).
    `init_state(key=0, params=None)` builds the model from a generator
    seeded by `key` (an int or a torch.Generator), then loads `params`
    (a state dict, e.g. from convert.resnet_state_dict) when given.  The
    step updates the model's parameters and the optimizer's moments in
    place.

    Under a mesh (on every rank of its process group; the model on the
    rank's device), as in the reference: the params are replicated, the
    batch (global tensors, or DTensors split over (data, fsdp)) splits
    its rows over (data, fsdp) and every other axis is a replica.  Rows
    of any count split as GSPMD pads them (`_Rows.local`): a rank's pad
    images pass through the model and weigh nothing.  Each rank sums
    the NLL of its real images and counts them and its correct ones;
    the gradients of those sums, the sums and the counts are summed
    over the row ranks, and each is divided by the global count before
    the optimizer's step: the global batch's mean, each image weighted
    alike however the rows split.  GroupNorm takes no statistic across
    the batch, so the split is exact."""
    rows = _Rows(mesh) if multi_device(mesh) else None
    device = rows.device if rows is not None else resolve_device(device)

    def init_state(key=0, params: Optional[dict] = None) -> dict:
        gen = key if isinstance(key, torch.Generator) \
            else torch.Generator().manual_seed(int(key))
        model = make_model(config, generator=gen, device=device)
        if params is not None:
            model.load_state_dict(params)
        return {"params": model,
                "opt_state": optimizer.init(dict(model.named_parameters())),
                "step": 0}

    def train_step(state: dict, batch: dict):
        model, opt = state["params"], state["opt_state"]
        images, labels = batch["images"], batch["labels"]
        opt.zero_grad(set_to_none=True)
        if rows is None:
            logits = model(images.to(device, non_blocking=True))
            labels = labels.to(device, non_blocking=True).long()
            loss = F.cross_entropy(logits.float(), labels)
            loss.backward()
            acc = (logits.argmax(-1) == labels).float().mean()
            loss = loss.detach()
        else:
            (images, real), (labels, _) = rows.local(images), \
                rows.local(labels)
            logits = model(images)[:real]
            labels = labels[:real].long()
            total = F.cross_entropy(logits.float(), labels,
                                    reduction="sum")
            total.backward()
            params = [p for p in model.parameters() if p.grad is not None]
            sums = rows.totals([p.grad for p in params] + [
                total.detach(), (logits.argmax(-1) == labels).float().sum(),
                torch.tensor(float(real), device=device)])
            count = sums[-1].clamp_min(1.0)
            with torch.no_grad():
                for p, g in zip(params, sums):
                    p.grad.copy_(g / count)
            loss, acc = sums[-3] / count, sums[-2] / count
        opt.step()
        return ({"params": model, "opt_state": opt,
                 "step": state["step"] + 1},
                {"loss": loss, "accuracy": acc})

    return init_state, train_step
