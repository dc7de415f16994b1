"""Ring attention: exact attention over sequences sharded on a mesh axis
(port of ray_tpu/ops/ring_attention.py).

Each rank holds a contiguous sequence shard of q, k and v; the K/V
blocks rotate round the ring of the axis (`collectives.rotate`, the
reference's `ppermute`), and each rank merges its shard's partial
softmax states by their log-sum-exp in f32.  Rank r holds positions
[r * S, (r + 1) * S); under a causal mask a K/V block from ring slot
s < r is wholly in the past (attended without a mask), one from a
later slot wholly in the future (skipped, as the reference's
`lax.cond` skips it), and the rank's own block is the diagonal (the
local causal mask).  On an axis of size 1 it is `flash_attention`.

The reference attends each block with XLA einsums; here every block is
a flash kernel.  `ring_attention` is a `torch.autograd.Function`:

- forward: K1 (`flash_forward`) once per block the rank attends, causal
  on the diagonal and full otherwise; each block's (O, LSE) enters the
  f32 merge as the state (m = LSE, l = 1, acc = O), so the merge is the
  reference's `_merge` and the one rounding per block is K1's own of O
  to the input dtype;
- backward, from the global O and LSE: for each block the rank
  attended, K2 (`flash_dq`) adds to dq and K3 (`flash_dkv`) gives that
  block's dk and dv, summed into f32 accumulators that travel round
  the ring with their block and end at its owner (one more rotation).

So seq rank r launches K1, K2 and K3 r + 1 times each under a causal
mask (n times without one).  Every call is square (S x S), so all of
them qualify for the kernels: on a card a call they do not take raises
(`flash_*`), and none goes to a plain path.  Dispatch follows the
tensor: a CPU tensor takes the flash kernels' plain versions.

`ring_attention_plain` is the reference's algorithm written in torch:
its `_block_attend` and `_merge` with the f32 accumulator, the K/V
(stacked, one rotation a step) rotated by `collectives.ppermute`,
gradients by autograd through all of it.  It is the yardstick of the
kernel ring on the card (`chip_smoke.py`) and in the CPU tests.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ray_tpu_torch.ops.attention import (NEG_INF, flash_attention,
                                         flash_dkv, flash_dq, flash_forward)
from ray_tpu_torch.parallel import collectives


def _block_attend(q, k, v, scale, mask):
    """One q shard x K/V block: the partial state (m, l, acc).  q
    [B, Lq, H, D], k / v [B, Lk, H, D]; mask [Lq, Lk] bool or None.  The
    logits and acc are f32 (the reference's `preferred_element_type`);
    P is cast to v's dtype before its product, as there."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if mask is not None:
        s = s.masked_fill(~mask, NEG_INF)
    m = s.amax(-1)                                            # [B, H, Lq]
    # Guard fully-masked rows (m == NEG_INF) against exp overflow / NaN.
    m_safe = m.clamp_min(NEG_INF / 2)
    p = torch.exp(s - m_safe[..., None])
    l = p.sum(-1)                                             # [B, H, Lq]
    acc = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    return m, l, acc


def _merge(m1, l1, a1, m2, l2, a2):
    """Combine two partial softmax states (all f32)."""
    m = torch.maximum(m1, m2)
    e1 = torch.exp(m1 - m)
    e2 = torch.exp(m2 - m)
    l = l1 * e1 + l2 * e2
    # e* are [B, H, Lq]; acc is [B, Lq, H, D].
    a = a1 * e1.transpose(1, 2)[..., None] + a2 * e2.transpose(1, 2)[..., None]
    return m, l, a


def _finish(l, acc, dtype):
    denom = l.clamp_min(1e-30).transpose(1, 2)[..., None]
    return (acc / denom).to(dtype)


def _ring(mesh, axis: str):
    """(group, this rank's slot, ring size) of `axis` on `mesh`; group is
    None on an axis of size 1."""
    group = collectives.axis_group(mesh, (axis,))
    if group is None:
        return None, 0, 1
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    return group, coord[axis], mesh.mesh.shape[
        list(mesh.mesh_dim_names).index(axis)]


def ring_attention_plain(q, k, v, *, mesh, axis: str = "seq",
                         causal: bool = True,
                         scale: Optional[float] = None) -> torch.Tensor:
    """The reference's ring on this rank's local shards [B, S, H, D]
    (see the module docstring): `_block_attend` per block, `_merge`,
    differentiable rotations."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    group, r, n = _ring(mesh, axis)
    lq = q.shape[1]
    mask = torch.ones(lq, lq, dtype=torch.bool, device=q.device).tril() \
        if causal else None
    m, l, acc = _block_attend(q, k, v, scale, mask)
    kv = torch.stack([k, v])
    for i in range(1, n):
        kv = collectives.ppermute(kv, group)
        if causal and (r - i) % n > r:
            continue
        m, l, acc = _merge(m, l, acc, *_block_attend(q, kv[0], kv[1], scale,
                                                     None))
    return collectives.tie(_finish(l, acc, q.dtype), kv)


def _attended(r: int, n: int, causal: bool):
    """[(ring step i, causal)] of the blocks rank r attends: at step i it
    holds the block of slot (r - i) mod n."""
    return [(i, causal and i == 0) for i in range(n)
            if not (causal and (r - i) % n > r)]


class _RingAttention(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, group, r, n, causal, scale):
        attend = dict(_attended(r, n, causal))
        kb, vb = k, v
        state = None
        for i in range(n):
            if i:
                kb, vb = collectives.rotate([kb, vb], group)
            if i not in attend:
                continue
            o, lse = flash_forward(q, kb, vb, attend[i], scale)
            part = (lse, torch.ones_like(lse), o.float())
            state = part if state is None else _merge(*state, *part)
        m, l, acc = state
        out = _finish(l, acc, q.dtype)
        lse = m + torch.log(l.clamp_min(1e-30))
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.ring = (group, r, n, causal, scale)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        group, r, n, causal, scale = ctx.ring
        attend = dict(_attended(r, n, causal))
        dout = dout.contiguous()
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        kb, vb = k, v
        dkb = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dvb = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
        for i in range(n):
            if i:
                kb, vb, dkb, dvb = collectives.rotate([kb, vb, dkb, dvb],
                                                      group)
            if i not in attend:
                continue
            dq_b, delta = flash_dq(q, kb, vb, out, lse, dout, attend[i],
                                   scale)
            dk_b, dv_b = flash_dkv(q, kb, vb, dout, lse, delta, attend[i],
                                   scale)
            dq += dq_b.float()
            dkb += dk_b.float()
            dvb += dv_b.float()
        # After n - 1 rotations this rank holds slot r + 1's sums: one
        # more rotation takes each home.
        dkb, dvb = collectives.rotate([dkb, dvb], group)
        return (dq.to(q.dtype), dkb.to(k.dtype), dvb.to(v.dtype), None,
                None, None, None, None)


def ring_attention(q, k, v, *, mesh, axis: str = "seq", causal: bool = True,
                   scale: Optional[float] = None) -> torch.Tensor:
    """Exact attention with q, k and v sequence-sharded over `axis` of
    `mesh`: this rank's local shards [B_local, S, H_local, D] in, its
    shard of the output out.  Every rank of the axis calls it at the
    same point.  K1-K3 per block on a card (see the module docstring);
    `flash_attention` on an axis of size 1."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    group, r, n = _ring(mesh, axis)
    if group is None:
        return flash_attention(q, k, v, causal=causal, scale=scale)
    return _RingAttention.apply(q.contiguous(), k.contiguous(),
                                v.contiguous(), group, r, n, causal, scale)
