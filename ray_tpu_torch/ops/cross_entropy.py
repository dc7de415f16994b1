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
`fused_cross_entropy_spmd` waits for the multi-device slice.
"""

from __future__ import annotations

import torch


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
