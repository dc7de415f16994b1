"""Paged-KV attention for the serving path (port of ray_tpu/ops/attention.py).

The KV cache lives in a preallocated block pool [num_blocks, block_size,
kv_heads, head_dim]; each sequence owns a row of a block table mapping
its logical context positions onto pool blocks (inference/kv_cache.py).
The decode step asks: one query per lane attends over that lane's block
table.  That step runs the hand-written Hopper kernel
`csrc/paged_decode.cu` on CUDA tensors; multi-token prefill chunks run
the masked-dense `paged_attention_reference`.

Dispatch follows the tensor, never the environment: a CPU tensor takes
the kernel's plain PyTorch version, a CUDA tensor launches the kernel or
raises.

Layouts: q is [batch, length, heads, head_dim] (BLHD) as in the
reference.  Flash attention (training) is not ported yet.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

NEG_INF = -1e30

_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_KERNEL_HEAD_DIMS = (64, 128, 256)


def paged_kv_update(k_pool, v_pool, k_new, v_new, block_tables, positions,
                    valid):
    """Scatter new K/V for one layer into the paged pools, IN PLACE.

    k_pool/v_pool [NB, BS, KH, D] (contiguous); k_new/v_new [B, T, KH, D];
    block_tables [B, MB] int; positions [B, T] absolute; valid [B, T]
    bool.  Invalid slots (padding lanes, prompt overhang) and slots whose
    flat index falls outside the pool are dropped, as the reference's
    `.at[].set(mode="drop")` drops them (`index_copy_` alone would raise).
    Returns the same pool tensors.

    A dropped slot is turned into a second copy of the first kept slot's
    write (the same bytes to the same row, harmless in any order); with
    no kept slot at all, every slot rewrites pool row 0 with its own
    contents.  So the update needs no host sync, where selecting the
    kept slots with `nonzero` would wait for the device."""
    nb, bs, kh, d = k_pool.shape
    blk = torch.div(positions, bs, rounding_mode="floor").clamp(
        0, block_tables.shape[1] - 1).long()
    phys = torch.gather(block_tables.long(), 1, blk)                 # [B, T]
    flat = (phys * bs + torch.remainder(positions, bs)).reshape(-1)
    keep = valid.reshape(-1) & (flat >= 0) & (flat < nb * bs)
    first = torch.argmax(keep.to(torch.int32))
    any_kept = keep[first]
    src = torch.where(keep, torch.arange(keep.numel(), device=keep.device),
                      first)
    idx = torch.where(any_kept, flat[src], 0)
    for pool, new in ((k_pool, k_new), (v_pool, v_new)):
        rows = pool.view(nb * bs, kh, d)
        vals = torch.where(any_kept, new.reshape(-1, kh, d)[src].to(
            pool.dtype), rows[:1])
        rows.index_copy_(0, idx, vals)
    return k_pool, v_pool


def paged_attention_reference(q, k_pool, v_pool, block_tables, ctx_lens,
                              q_positions, *, scale: Optional[float] = None):
    """Masked-dense paged attention (the prefill path and the kernel's
    plain version).

    q [B, T, H, D] at absolute q_positions [B, T]; pools [NB, BS, KH, D]
    (KH may divide H — GQA); ctx_lens [B] = tokens written per lane.
    Each query attends to context positions <= its own (the query's K/V
    must already be in the pool).  All-masked rows (a lane with
    ctx_len = 0) come out as a uniform average over the gathered
    context, never NaN (finite NEG_INF) — as in the reference."""
    b, t, h, d = q.shape
    nb, bs, kh, _ = k_pool.shape
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    max_ctx = block_tables.shape[1] * bs
    tables = block_tables.long()
    k_ctx = k_pool[tables].reshape(b, max_ctx, kh, d)
    v_ctx = v_pool[tables].reshape(b, max_ctx, kh, d)
    if h != kh:
        k_ctx = k_ctx.repeat_interleave(h // kh, dim=2)
        v_ctx = v_ctx.repeat_interleave(h // kh, dim=2)
    logits = torch.einsum("bthd,bkhd->bhtk", q.float(), k_ctx.float()) * scale
    kpos = torch.arange(max_ctx, device=q.device)
    mask = ((kpos[None, None, None, :] <= q_positions[:, None, :, None])
            & (kpos[None, None, None, :] < ctx_lens[:, None, None, None]))
    logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhtk,bkhd->bthd", probs, v_ctx.float())
    return out.to(q.dtype)


def paged_decode_attention_plain(q, k_pool, v_pool, block_tables, ctx_lens,
                                 *, scale: Optional[float] = None):
    """Plain PyTorch version of the decode kernel: `paged_attention_reference`
    at T = 1, the query at position ctx_len - 1.  q [B, H, D] -> [B, H, D].

    Differs from the kernel only on a lane with ctx_len = 0: here the
    all-masked row is a uniform average (as the reference's dense path),
    the kernel writes zeros (as the reference's Pallas kernel)."""
    out = paged_attention_reference(
        q[:, None], k_pool, v_pool, block_tables, ctx_lens,
        (ctx_lens - 1)[:, None], scale=scale)
    return out[:, 0]


@functools.cache
def _kernel():
    """The kernel's C entry point, built and bound on first use."""
    from ray_tpu_torch.ops._build import load_library

    fn = load_library("paged_decode").paged_decode_attention
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, ctypes.c_float, i, p]
    fn.restype = ctypes.c_int
    return fn


def _check_kernel_args(q, k_pool, v_pool, block_tables, ctx_lens) -> None:
    """Raise on any input the CUDA kernel does not take."""
    if q.dim() != 3 or k_pool.dim() != 4 or v_pool.shape != k_pool.shape:
        raise ValueError(
            f"paged_decode_attention: want q [B, H, D] and pools "
            f"[NB, BS, KH, D]; got {tuple(q.shape)}, {tuple(k_pool.shape)}, "
            f"{tuple(v_pool.shape)}")
    b, h, d = q.shape
    nb, bs, kh, pd = k_pool.shape
    if q.dtype not in _KERNEL_DTYPES or k_pool.dtype != q.dtype \
            or v_pool.dtype != q.dtype:
        raise TypeError(
            f"paged_decode_attention: q and pools must share one dtype of "
            f"float32/bfloat16; got {q.dtype}, {k_pool.dtype}, {v_pool.dtype}")
    if d not in _KERNEL_HEAD_DIMS or pd != d:
        raise ValueError(f"paged_decode_attention: head dim must be one of "
                         f"{_KERNEL_HEAD_DIMS} and match the pool; got q "
                         f"{d}, pool {pd}")
    if kh < 1 or h % kh:
        raise ValueError(f"paged_decode_attention: {h} query heads are not a "
                         f"multiple of {kh} kv heads")
    if block_tables.dtype != torch.int32 or ctx_lens.dtype != torch.int32:
        raise TypeError("paged_decode_attention: block_tables and ctx_lens "
                        "must be int32")
    if block_tables.dim() != 2 or block_tables.shape[0] != b \
            or tuple(ctx_lens.shape) != (b,):
        raise ValueError(
            f"paged_decode_attention: want block_tables [{b}, MB] and "
            f"ctx_lens [{b}]; got {tuple(block_tables.shape)}, "
            f"{tuple(ctx_lens.shape)}")
    if b > 65535:
        raise ValueError(f"paged_decode_attention: batch {b} > 65535")
    for name, t in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool),
                    ("block_tables", block_tables), ("ctx_lens", ctx_lens)):
        if t.device != q.device:
            raise ValueError(f"paged_decode_attention: {name} is on "
                             f"{t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"paged_decode_attention: {name} must be "
                             f"contiguous")


def paged_decode_attention(q, k_pool, v_pool, block_tables, ctx_lens, *,
                           scale: Optional[float] = None):
    """Single-query paged attention: q [B, H, D] (one decode token per
    lane) over each lane's block table.  ctx_lens counts tokens already
    written to the pool INCLUDING the current one.

    On a CPU tensor this is `paged_decode_attention_plain`.  On a CUDA
    tensor it launches `csrc/paged_decode.cu` (bf16/f32, D in
    {64, 128, 256}, any q_per_kv) on the current stream, or raises; it
    never falls back.  A lane with ctx_len = 0 comes out as zeros on the
    kernel path (see the plain version).  `paged_decode_attention.launches`
    counts kernel launches."""
    if q.device.type == "cpu":
        return paged_decode_attention_plain(q, k_pool, v_pool, block_tables,
                                            ctx_lens, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention: no kernel for device "
                         f"{q.device}")
    _check_kernel_args(q, k_pool, v_pool, block_tables, ctx_lens)
    b, h, d = q.shape
    _nb, bs, kh, _ = k_pool.shape
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    out = torch.empty_like(q)
    fn = _kernel()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                 block_tables.data_ptr(), ctx_lens.data_ptr(),
                 out.data_ptr(), b, h, kh, d, bs, block_tables.shape[1],
                 float(scale), _KERNEL_DTYPES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"paged_decode_attention: kernel launch failed "
                           f"with cudaError_t {err}")
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0


def paged_attention(q, k_pool, v_pool, block_tables, ctx_lens, q_positions,
                    *, scale: Optional[float] = None):
    """Dispatch paged attention for a [B, T, H, D] query slice: the T=1
    decode step rides the single-query kernel path, multi-token prefill
    chunks ride the masked-dense path."""
    if q.shape[1] == 1:
        return paged_decode_attention(
            q[:, 0], k_pool, v_pool, block_tables, ctx_lens,
            scale=scale)[:, None]
    return paged_attention_reference(q, k_pool, v_pool, block_tables,
                                     ctx_lens, q_positions, scale=scale)
