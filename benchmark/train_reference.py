"""The plain reference of a training cell, for any family: AdamW written
out (decoupled decay, bias-corrected moments, eps outside the root),
following the program's checked first steps from the run's weights.
It imports nothing of the program.

The family's reference module gives the weights (`draw`, its
`draw_params` bound to the run and seed) and the loss
(`loss_and_grads`).  Each layer of a stacked block leaf ("blocks/...",
[layers, ...]) is held as a leaf of its own, so that the backward of a
layer adds into that layer's gradient alone.

On one device (`Whole`) every leaf is judged whole and the norms are
torch's.  Data parallel (`DataParallel`), each rank of the default
process group runs its share of each batch's rows, the gradients are
summed by a plain all-reduce, and each rank steps the layers and leaves
it owns (moments for those alone) and broadcasts them, so every rank
holds every leaf whole.  A rank judges its part of each leaf, the part
of the program's readings it holds (`index`), and a norm is the square
root of the sum of squares over the ranks' parts (a part that several
ranks hold counted once), all-reduced: nothing is gathered to one card.

Readings (`readings`): each step's loss, and by leaf path the norm of
the first gradient, of the parameter's change after the last step, and
of that change on the elements kept by `change_kept`
("change_kept_norms").  `judged` (another side's "first_grads" and
"changes", host tensors by leaf path, each this rank's part) adds the
norms of their differences from these ("grad_diff_norms", and
"change_diff_norms" on the kept elements); `kept_by` (masks by leaf
path, a "kept" of another side) chooses the kept elements in place of
this side's own first gradients; `keep` returns this side's own
"first_grads", "changes" and "kept", copied to the host.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional

import torch

# The change after the checked steps is compared on the elements whose
# f32 first gradient is at least this share of the root mean square of
# its leaf's (of its layer's, in a stacked leaf): AdamW scales each
# element's step by that element's own gradient, so an element whose
# gradient lies at the rounding noise of a bf16 backward takes a
# full-size step whose sign the rounding decides.
CHANGE_KEEP = 0.1


def configure() -> None:
    """Every float32 product in float32 (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def stacked(path: str) -> bool:
    """A block leaf, its layers on the leading dim."""
    return path.startswith("blocks/")


def change_kept(g: torch.Tensor, is_stacked: bool) -> torch.Tensor:
    """The elements of a leaf whose change is compared, by its first
    gradient `g` (a stacked leaf: [layers, ...], by layer)."""
    dims = tuple(range(1 if is_stacked else 0, g.dim()))
    rms = g.square().mean(dim=dims, keepdim=True).sqrt() if dims else g.abs()
    return g.abs() >= CHANGE_KEEP * rms


def _pieces(path: str, t: torch.Tensor) -> List[torch.Tensor]:
    """A drawn leaf as the reference holds it: f32 leaves with a
    gradient, one a layer for a stacked leaf."""
    t = t.float()
    if not stacked(path):
        return [t.requires_grad_()]
    return [layer.clone().requires_grad_() for layer in t.unbind(0)]


def _tree(flat: Dict[str, List[torch.Tensor]]) -> dict:
    """The params tree the family's forward takes: a stacked leaf as its
    list of layers (`v[i]` is layer i), the others as tensors."""
    out: dict = {}
    for path, pieces in flat.items():
        node = out
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = pieces if stacked(path) else pieces[0]
    return out


class Whole:
    """One device: every leaf judged whole, each norm torch's own."""

    def rows(self, tokens: torch.Tensor) -> torch.Tensor:
        return tokens

    def total(self, loss: float) -> float:
        return loss

    def sum_grads(self, flat: dict) -> None:
        pass

    def owns(self, path: str, i: int) -> bool:
        return True

    def share(self, path: str, i: int, t: torch.Tensor) -> None:
        pass

    def parts(self, path: str, pieces: list) -> list:
        """This side's part of the leaf: the whole leaf."""
        return [torch.stack(pieces) if stacked(path) else pieces[0]]

    def split(self, path: str, t: torch.Tensor) -> list:
        """A part as held on the host (`join`'s) -> `parts`' list."""
        return [t]

    def join(self, path: str, parts: list) -> torch.Tensor:
        return parts[0]

    def kept(self, path: str, grads: list) -> list:
        return [change_kept(self.parts(path, grads)[0], stacked(path))]

    def norm(self, path: str, parts: list):
        return float(parts[0].norm())

    def done(self, norms: dict) -> dict:
        return norms


class DataParallel(Whole):
    """Rank `rank` of the `world` ranks of the default process group, on
    `device`.  `index` gives, by leaf path, the slices of the whole leaf
    that this rank judges; `exchange` False leaves out the gradients'
    all-reduce (a fault that the check must catch)."""

    def __init__(self, rank: int, world: int, index: Dict[str, tuple],
                 device, exchange: bool = True):
        self.rank, self.world, self.index = rank, world, index
        self.device, self.exchange = torch.device(device), exchange
        self._owner: Dict[str, int] = {}
        self.shapes: Dict[str, tuple] = {}

    def rows(self, tokens):
        per = tokens.shape[0] // self.world
        if per * self.world != tokens.shape[0]:
            raise ValueError(f"{tokens.shape[0]} rows do not split over "
                             f"{self.world} ranks")
        return tokens[self.rank * per:(self.rank + 1) * per]

    def total(self, loss):
        import torch.distributed as dist

        t = torch.tensor([loss], dtype=torch.float64, device=self.device)
        dist.all_reduce(t)
        return float(t[0])

    def sum_grads(self, flat):
        import torch.distributed as dist

        if not self.exchange:
            return
        for pieces in flat.values():
            for p in pieces:
                dist.all_reduce(p.grad)

    def owns(self, path, i):
        """Layer i of a stacked leaf is rank i % world's; an unstacked
        leaf is the next rank's in the order they come."""
        if stacked(path):
            return i % self.world == self.rank
        if path not in self._owner:
            self._owner[path] = len(self._owner) % self.world
        return self._owner[path] == self.rank

    def share(self, path, i, t):
        import torch.distributed as dist

        src = i % self.world if stacked(path) else self._owner[path]
        dist.broadcast(t, src)

    def parts(self, path, pieces):
        idx = self.index[path]
        if not stacked(path):
            return [pieces[0][idx]]
        return [pieces[i][idx[1:]] for i in range(len(pieces))[idx[0]]]

    def split(self, path, t):
        return list(t.unbind(0)) if stacked(path) else [t]

    def join(self, path, parts):
        return torch.stack(parts) if stacked(path) else parts[0]

    def kept(self, path, grads):
        idx = self.index[path]
        if not stacked(path):
            return [change_kept(grads[0], False)[idx]]
        out = []
        for i in range(len(grads))[idx[0]]:
            rms = grads[i].square().mean().sqrt()
            out.append(grads[i][idx[1:]].abs() >= CHANGE_KEEP * rms)
        return out

    def _copies(self, path: str) -> int:
        """How many ranks hold this rank's part of the leaf."""
        shape = self.shapes[path]
        part = math.prod(len(range(n)[s]) for n, s in
                         zip(shape, self.index[path]))
        return self.world * part // math.prod(shape)

    def norm(self, path, parts):
        sq = sum(torch.linalg.vector_norm(p, dtype=torch.float64).square()
                 for p in parts)
        return sq / self._copies(path)

    def done(self, norms):
        import torch.distributed as dist

        keys = list(norms)
        sums = torch.stack([norms[k] for k in keys])
        dist.all_reduce(sums)
        return dict(zip(keys, sums.sqrt().tolist()))


def readings(draw: Callable, loss_and_grads: Callable,
             batches: List[torch.Tensor], hp: dict, device,
             precision: str = "f32", rows_per_pass: int = 1,
             judged: Optional[dict] = None, keep: bool = False,
             kept_by: Optional[dict] = None,
             parts: Optional[Whole] = None) -> dict:
    """AdamW steps from the run's weights (`draw(device, keep=...)`, the
    family's `draw_params` for the run and seed), one on each of
    `batches` (global batches; `parts` takes this rank's rows), the
    loss and gradients from `loss_and_grads(params, rows, precision,
    rows_per_pass, n_targets)`.  See the module docstring."""
    configure()
    parts = Whole() if parts is None else parts
    flat: Dict[str, List[torch.Tensor]] = {}
    shapes: Dict[str, tuple] = {}

    def hold(path, t):
        shapes[path] = tuple(t.shape)
        flat[path] = _pieces(path, t)

    draw(device, keep=hold)
    if isinstance(parts, DataParallel):
        parts.shapes = shapes
    params = _tree(flat)
    m = {k: [torch.zeros_like(p) if parts.owns(k, i) else None
             for i, p in enumerate(ps)] for k, ps in flat.items()}
    v2 = {k: [None if t is None else torch.zeros_like(t) for t in ms]
          for k, ms in m.items()}
    kept: Dict[str, list] = {}
    b1, b2, lr, eps, wd = hp["b1"], hp["b2"], hp["lr"], hp["eps"], hp["wd"]
    out = {"losses": [], "grad_norms": {}, "change_norms": {},
           "change_kept_norms": {}}
    if keep:
        out.update(first_grads={}, changes={}, kept={})
    for step, tokens in enumerate(batches, start=1):
        n_targets = tokens.shape[0] * (tokens.shape[1] - 1)
        out["losses"].append(parts.total(loss_and_grads(
            params, parts.rows(tokens), precision, rows_per_pass,
            n_targets)))
        parts.sum_grads(flat)
        with torch.no_grad():
            norms = {"grad_norms": {}, "grad_diff_norms": {}}
            for k, ps in flat.items():
                grads = [p.grad for p in ps]
                if step == 1:
                    g = parts.parts(k, grads)
                    norms["grad_norms"][k] = parts.norm(k, g)
                    if judged is not None:
                        norms["grad_diff_norms"][k] = parts.norm(k, [
                            j.to(device) - x for j, x in zip(
                                parts.split(k, judged["first_grads"][k]),
                                g)])
                    if keep:
                        out["first_grads"][k] = parts.join(k, g).cpu()
                    kept[k] = (parts.kept(k, grads) if kept_by is None else
                               [x.to(device) for x in
                                parts.split(k, kept_by[k])])
                    if keep:
                        out["kept"][k] = parts.join(k, kept[k]).cpu()
                    del g
                del grads
                for i, p in enumerate(ps):
                    if parts.owns(k, i):
                        g = p.grad
                        p.mul_(1 - lr * wd)
                        m[k][i].mul_(b1).add_(g, alpha=1 - b1)
                        v2[k][i].mul_(b2).addcmul_(g, g, value=1 - b2)
                        mhat = m[k][i] / (1 - b1 ** step)
                        vhat = v2[k][i] / (1 - b2 ** step)
                        p.sub_(lr * mhat / (vhat.sqrt() + eps))
                        del g, mhat, vhat
                    p.grad = None
                    parts.share(k, i, p.data)
            if step == 1:
                out["grad_norms"] = parts.done(norms["grad_norms"])
                if judged is not None:
                    out["grad_diff_norms"] = parts.done(
                        norms["grad_diff_norms"])
    del m, v2
    norms: Dict[str, dict] = {"change_norms": {}, "change_kept_norms": {},
                              "change_diff_norms": {}}

    def judge(path, start):
        """Leaf `path`'s change from `start`, as drawn, judged."""
        change = [x - s for x, s in zip(
            parts.parts(path, [p.detach() for p in flat[path]]),
            parts.parts(path, _split_layers(path, start)))]
        norms["change_norms"][path] = parts.norm(path, change)
        norms["change_kept_norms"][path] = parts.norm(
            path, [c[k] for c, k in zip(change, kept[path])])
        if judged is not None:
            norms["change_diff_norms"][path] = parts.norm(path, [
                (j.to(device) - c)[k] for j, c, k in zip(
                    parts.split(path, judged["changes"][path]), change,
                    kept[path])])
        if keep:
            out["changes"][path] = parts.join(path, change).cpu()

    with torch.no_grad():
        draw(device, keep=judge)
    out["change_norms"] = parts.done(norms["change_norms"])
    out["change_kept_norms"] = parts.done(norms["change_kept_norms"])
    if judged is not None:
        out["change_diff_norms"] = parts.done(norms["change_diff_norms"])
    return out


def _split_layers(path: str, t: torch.Tensor) -> list:
    return list(t.unbind(0)) if stacked(path) else [t]
