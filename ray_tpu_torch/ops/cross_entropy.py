"""Fused chunked softmax cross-entropy over a large vocabulary (port of
ray_tpu/ops/cross_entropy.py, single device).

The op never materialises the full [T, V] logits: it walks row chunks,
computing chunk logits -> logsumexp -> target logit on the fly, and the
backward recomputes each chunk's logits.  Peak extra memory is one
[chunk, V] block instead of [T, V].

The reference has no Pallas kernel here (an XLA scan), so the products
stay matrix multiplies.  Its logits are bf16 x bf16 with f32 output
(`preferred_element_type=f32`): on a card `torch.mm(..., out_dtype=
torch.float32)` gives exactly that; on the CPU, where that op has no
kernel, the inputs are upcast, which gives the same products (a product
of two bf16 values is exact in f32) summed in another order.

`fused_cross_entropy_spmd` is the mesh form: each rank holds its rows
(batch x length, split over the data axes) and its vocab slice of the
head (split over `tensor`); the row max, the sum of exponentials and
the target logit are all-reduced over `tensor`, so no rank ever holds
[T, V] logits.  It is a reduction written with the port's collectives
(parallel/collectives.py), not a kernel.
"""

from __future__ import annotations

import torch

from ray_tpu_torch.parallel import collectives
from ray_tpu_torch.parallel.mesh import axis_sizes


def _dot_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b with an f32 result, accumulated in f32."""
    if a.dtype == torch.float32 and b.dtype == torch.float32:
        return a @ b
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


def _chunks(t: int, n_chunks: int) -> int:
    return n_chunks if t % n_chunks == 0 else 1


class _FusedCrossEntropy(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, head, targets, valid, n_chunks):
        nc = _chunks(x.shape[0], n_chunks)
        targets = targets.long()
        total = torch.zeros((), dtype=torch.float32, device=x.device)
        for x_c, t_c, v_c in zip(x.chunk(nc), targets.chunk(nc),
                                 valid.chunk(nc)):
            logits = _dot_f32(x_c, head)                       # [C, V]
            lse = torch.logsumexp(logits, dim=-1)
            tgt = logits.gather(1, t_c[:, None])[:, 0]
            total = total + ((lse - tgt) * v_c).sum()
        denom = valid.sum().clamp_min(1.0)
        ctx.save_for_backward(x, head, targets, valid, denom)
        ctx.n_chunks = nc
        return total / denom

    @staticmethod
    def backward(ctx, g):
        x, head, targets, valid, denom = ctx.saved_tensors
        nc = ctx.n_chunks
        scale = (g / denom).float()
        head_t = head.t().to(x.dtype)
        dhead = torch.zeros(head.shape, dtype=torch.float32,
                            device=head.device)
        dxs = []
        for x_c, t_c, v_c in zip(x.chunk(nc), targets.chunk(nc),
                                 valid.chunk(nc)):
            logits = _dot_f32(x_c, head)
            lse = torch.logsumexp(logits, dim=-1)
            # dlogits = (softmax - onehot(t)) * valid * g / denom, then
            # rounded to x's dtype as in the reference.
            dlogits = torch.exp(logits - lse[:, None])
            rows = torch.arange(dlogits.shape[0], device=dlogits.device)
            dlogits[rows, t_c] -= 1.0
            dlogits = (dlogits * (v_c * scale)[:, None]).to(x.dtype)
            dxs.append(dlogits @ head_t)                       # [C, D]
            dhead += _dot_f32(x_c.t(), dlogits)
        return torch.cat(dxs), dhead.to(head.dtype), None, None, None


def fused_cross_entropy(x, head, targets, valid, n_chunks: int = 4):
    """Mean masked NLL of `targets` under softmax(x @ head).

    x: [T, D] activations (bf16 ok); head: [D, V]; targets: [T] int;
    valid: [T] float mask.  Returns an f32 scalar:
        sum(valid * nll) / max(sum(valid), 1).
    The rows are cut into `n_chunks` chunks, or one when T % n_chunks.
    Gradients flow to x and head."""
    return _FusedCrossEntropy.apply(x, head, targets, valid.float(),
                                    n_chunks)


ROW_AXES = ("data", "fsdp", "seq")   # mesh axes that shard rows (tokens)
VOCAB_AXIS = "tensor"                # mesh axis that shards the vocab dim


def spmd_ce_applicable(mesh, vocab: int, batch: int, length: int) -> bool:
    """The mesh CE path needs the sharded dims to divide evenly."""
    if mesh is None:
        return False
    sizes = axis_sizes(mesh)
    t = sizes.get(VOCAB_AXIS, 1)
    rows = sizes.get("data", 1) * sizes.get("fsdp", 1)
    seq = sizes.get("seq", 1)
    return vocab % t == 0 and batch % rows == 0 and length % seq == 0


def _lse_tgt(logits, t_c, offset, vocab_group):
    """This chunk's logsumexp and target logit over the whole vocab from
    the local slice's logits [C, V/T]: the max-shifted sum of exponentials
    and the target logit (zero where another slice owns the target)
    summed over the vocab group."""
    m = collectives.all_reduce(logits.amax(-1), vocab_group, "max")
    s = collectives.all_reduce(
        torch.exp(logits - m[:, None]).sum(-1), vocab_group)
    local = t_c - offset
    mine = (local >= 0) & (local < logits.shape[1])
    tgt = logits.gather(1, local.clamp(0, logits.shape[1] - 1)[:, None])[:, 0]
    tgt = collectives.all_reduce(torch.where(mine, tgt, 0.0), vocab_group)
    return m + torch.log(s), tgt


class _FusedCrossEntropySpmd(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, head, targets, valid, groups, offset, n_chunks):
        vocab_group, row_group = groups
        d = x.shape[-1]
        x2, t2 = x.reshape(-1, d), targets.reshape(-1).long()
        v2 = valid.reshape(-1)
        nc = _chunks(x2.shape[0], n_chunks)
        total = torch.zeros((), dtype=torch.float32, device=x.device)
        lses = []
        for x_c, t_c, v_c in zip(x2.chunk(nc), t2.chunk(nc), v2.chunk(nc)):
            lse, tgt = _lse_tgt(_dot_f32(x_c, head), t_c, offset,
                                vocab_group)
            lses.append(lse)
            total = total + ((lse - tgt) * v_c).sum()
        sums = collectives.all_reduce(torch.stack([total, v2.sum()]),
                                      row_group)
        denom = sums[1].clamp_min(1.0)
        ctx.save_for_backward(x2, head, t2, v2, torch.cat(lses), denom)
        ctx.groups, ctx.offset, ctx.n_chunks = groups, offset, nc
        ctx.x_shape = x.shape
        return sums[0] / denom

    @staticmethod
    def backward(ctx, g):
        x2, head, t2, v2, lse, denom = ctx.saved_tensors
        vocab_group, _ = ctx.groups
        nc, offset = ctx.n_chunks, ctx.offset
        scale = (g / denom).float()
        head_t = head.t().to(x2.dtype)
        dhead = torch.zeros(head.shape, dtype=torch.float32,
                            device=head.device)
        dxs = []
        for x_c, t_c, v_c, lse_c in zip(x2.chunk(nc), t2.chunk(nc),
                                        v2.chunk(nc), lse.chunk(nc)):
            logits = _dot_f32(x_c, head)
            dlogits = torch.exp(logits - lse_c[:, None])
            local = t_c - offset
            mine = (local >= 0) & (local < logits.shape[1])
            dlogits.scatter_add_(
                1, local.clamp(0, logits.shape[1] - 1)[:, None],
                -mine.float()[:, None])
            dlogits = (dlogits * (v_c * scale)[:, None]).to(x2.dtype)
            # A partial over this vocab slice's columns; the sum over the
            # vocab group (once, after the loop) completes dx.
            dxs.append(dlogits @ head_t)
            dhead += _dot_f32(x_c.t(), dlogits)
        dx = collectives.all_reduce(torch.cat(dxs), vocab_group)
        return (dx.reshape(ctx.x_shape), dhead.to(head.dtype), None, None,
                None, None, None)


def fused_cross_entropy_spmd(x, head, targets, valid, mesh,
                             n_chunks: int = 4):
    """Mesh-parallel fused CE on this rank's local tensors: x [b, l, D]
    (its rows: the batch split over (data, fsdp), the same on every
    rank of a tensor group), head [D, V / tensor] (its vocab slice,
    tensor-major: slice i holds vocab i * V/tensor onwards),
    targets / valid [b, l].  Returns the mean masked NLL over the global
    batch, an f32 scalar equal on every rank.

    The loss and dx are the reference's (`ray_tpu/ops/cross_entropy.py`
    `fused_cross_entropy_spmd`); dhead is this rank's rows' part of the
    head's gradient.  The reference sums it over the row axes inside
    its backward; here the caller completes it (the train step's
    reduce-scatter and all-reduce of parameter gradients), so it is
    summed once.  The LSE of each chunk is kept from the forward, where
    the reference recomputes it (and its two all-reduces) in the
    backward."""
    from ray_tpu_torch.parallel.collectives import axis_group

    vocab_group = axis_group(mesh, (VOCAB_AXIS,))
    row_group = axis_group(mesh, ROW_AXES)
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    offset = coord.get(VOCAB_AXIS, 0) * head.shape[1]
    return _FusedCrossEntropySpmd.apply(
        x, head, targets, valid.float(), (vocab_group, row_group), offset,
        n_chunks)
