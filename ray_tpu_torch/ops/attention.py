"""Attention ops (port of ray_tpu/ops/attention.py).

Training: `flash_attention` is a `torch.autograd.Function` whose forward
runs K1 (`csrc/flash_attention.cu`) and saves (O, LSE), and whose
backward runs K2 (dq, and delta = rowsum(dO * O)) then K3 (dk, dv).
bf16 calls at head dim 64 and 128 run all three on the tensor cores,
with P and dS rounded to bf16 before the products that take them (as
`reference_attention` rounds P); f32 calls and bf16 at head dim 256 run
the f32 kernels (`flash_design`).  Calls the kernels do not take go to
`reference_attention` and its autograd, as the reference sends them to
its XLA path.

Serving: the KV cache lives in a preallocated block pool [num_blocks,
block_size, kv_heads, head_dim]; each sequence owns a row of a block
table mapping its logical context positions onto pool blocks
(inference/kv_cache.py).  The decode step asks: one query per lane
attends over that lane's block table.  At head dims 64, 128 and 256
that step runs the hand-written Hopper kernel K4 `csrc/paged_decode.cu`
(split-context: partials per context split, then a merge) on CUDA
tensors.  A multi-token call (prefill chunks, the speculative verify
step) in bf16 at those head dims runs K5 `csrc/paged_prefill.cu`, which
reads each lane's own visible context through its table on the tensor
cores; the reference sends every such call to its masked-dense path,
and so does the port for f32 calls and other head dims
(`paged_attention_reference`).

Every paged call takes an optional sliding `window`: a query at
position i then sees key j only where i - window < j <= i (the window
layers of a model that mixes window and full attention).  K4 and K5 run
only the context splits that can hold a visible key, under kernel names
of their own; without a window nothing changes.

Dispatch follows the tensor, never the environment: a CPU tensor takes
the kernel's plain PyTorch version, a CUDA tensor launches the kernel or
raises.

Layouts: q is [batch, length, heads, head_dim] (BLHD) as in the
reference.
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

# A bf16 output of K1 (O), K2 (dq) or K3 (dk, dv) on the tensor cores
# against its plain version, entry by entry: |kernel - plain| <=
# a * rowmax|plain| + r * |plain|, as (a, r), where rowmax is the largest
# |plain| in the entry's own row (a q row of O or dq, a kv row of dk or
# dv: the last dim).  P (for O and dv) or dS (for dq and dk) is rounded
# to bf16 (unit roundoff 2**-8) before the product that takes it.  A
# row's sums have terms of mixed sign, so that error scales with the
# row's magnitude rather than with each entry's.  Both sides round their
# output to bf16, which may leave them one ulp apart (up to 2**-7 of
# |plain|).  Scaling by the row, not by the tensor, keeps the limit tight
# on late causal rows, whose values are small: a kv or q tile skipped
# there moves a row by far more than 2**-7 of its own largest entry.  LSE
# and delta keep the f32 tolerance (l is summed from the f32 P, delta
# from the inputs in f32); every f32 call keeps the f32 kernels'.
TENSOR_CORE_TOLERANCE = (2 ** -7, 2 ** -7)
# dq alone also gets an absolute floor, this share of the tensor's largest
# |dq|.  A dq row is a sum whose weights cancel (sum_j dS_ij = 0): the
# first causal row sees one key, so its exact dq is 0 and each side
# returns the f32 rounding noise of dP - delta, about 1e-7 of the largest
# |dq|, which no share of the row's own (noise) size covers.  2**-14 is
# one bf16 ulp of one bf16 ulp, far below any other row's magnitude.
TENSOR_CORE_DQ_FLOOR = 2 ** -14


def tensor_core_limit(plain: torch.Tensor, what: str) -> torch.Tensor:
    """The largest |kernel - plain| that TENSOR_CORE_TOLERANCE allows at
    each entry of a bf16 output `what` ("O", "dq", "dk" or "dv"; [..., D]
    f32, like `plain`), with TENSOR_CORE_DQ_FLOOR of the largest |plain|
    added for dq."""
    if what not in ("O", "dq", "dk", "dv"):
        raise ValueError(f"no tensor-core limit for {what!r}")
    a, r = TENSOR_CORE_TOLERANCE
    floor = TENSOR_CORE_DQ_FLOOR if what == "dq" else 0.0
    mag = plain.float().abs()
    return a * mag.amax(dim=-1, keepdim=True) + r * mag + floor * mag.max()


# ---------------------------------------------------------------------------
# Flash attention (training): K1-K3
# ---------------------------------------------------------------------------

def _build_mask(q_len, k_len, causal, segment_ids, device):
    """[1|B, 1, q_len, k_len] bool mask or None.  Causal is aligned to the
    bottom right: query i sees keys <= i + k_len - q_len."""
    mask = None
    if causal:
        mask = torch.ones(q_len, k_len, dtype=torch.bool, device=device).tril(
            k_len - q_len)[None, None]
    if segment_ids is not None:
        seg = segment_ids[:, None, :, None] == segment_ids[:, None, None, :]
        mask = seg if mask is None else (mask & seg)
    return mask


def reference_attention(q, k, v, *, causal: bool = True,
                        scale: Optional[float] = None, segment_ids=None):
    """Plain attention, as the reference's XLA path: logits in the input
    dtype, softmax in f32, probabilities cast back to v's dtype."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    mask = _build_mask(q.shape[1], k.shape[1], causal, segment_ids, q.device)
    if mask is not None:
        logits = logits.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(logits.float(), dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v)


def _use_kernel(q_len, kv_len, d, causal) -> bool:
    """The reference's `_use_pallas` rule without its tiling condition:
    the CUDA kernels mask a ragged last tile themselves, so any length
    rides them.  The kernels mask causal top-left (q >= k), which agrees
    with the reference's bottom-right mask only on square calls."""
    return d in _KERNEL_HEAD_DIMS and not (causal and q_len != kv_len)


def _heads_first(x):
    return x.float().transpose(1, 2)                  # [B, H, L, D] f32


def _scores(q, k, causal, scale):
    """(q * scale) . k in f32 as [B, H, Lq, Lk], and the visibility mask
    of the kernels (top-left causal)."""
    s = (_heads_first(q) * scale) @ _heads_first(k).transpose(-1, -2)
    if not causal:
        return s, None
    lq, lk = q.shape[1], k.shape[1]
    pos_q = torch.arange(lq, device=q.device)[:, None]
    pos_k = torch.arange(lk, device=q.device)[None, :]
    return s, pos_q >= pos_k


def flash_forward_plain(q, k, v, causal: bool, scale: float):
    """Plain version of K1: (O [B, L, H, D] in q's dtype, LSE [B, H, L]
    f32), with l clamped to 1e-30 as in the kernel."""
    s, mask = _scores(q, k, causal, scale)
    if mask is not None:
        s = s.masked_fill(~mask, NEG_INF)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l_safe = p.sum(-1, keepdim=True).clamp_min(1e-30)
    out = (p @ _heads_first(v)) / l_safe
    lse = (m + torch.log(l_safe))[..., 0]
    return out.transpose(1, 2).to(q.dtype), lse


def _probs(q, k, lse, causal, scale):
    s, mask = _scores(q, k, causal, scale)
    p = torch.exp(s - lse[..., None])
    return p if mask is None else p.masked_fill(~mask, 0.0)


def flash_dq_plain(q, k, v, out, lse, dout, causal: bool, scale: float):
    """Plain version of K2: (dq in q's dtype, delta [B, H, L] f32)."""
    do = _heads_first(dout)
    delta = (do * _heads_first(out)).sum(-1)
    p = _probs(q, k, lse, causal, scale)
    ds = p * (do @ _heads_first(v).transpose(-1, -2) - delta[..., None])
    dq = (ds @ _heads_first(k)) * scale
    return dq.transpose(1, 2).to(q.dtype), delta


def flash_dkv_plain(q, k, v, dout, lse, delta, causal: bool, scale: float):
    """Plain version of K3: (dk, dv) in k's and v's dtypes."""
    do = _heads_first(dout)
    p = _probs(q, k, lse, causal, scale)
    dv = p.transpose(-1, -2) @ do
    ds = p * (do @ _heads_first(v).transpose(-1, -2) - delta[..., None])
    dk = (ds.transpose(-1, -2) @ _heads_first(q)) * scale
    return dk.transpose(1, 2).to(k.dtype), dv.transpose(1, 2).to(v.dtype)


def flash_backward_plain(q, k, v, out, lse, dout, causal: bool,
                         scale: float):
    """Plain version of K2 then K3, written out (delta, P from LSE, dS):
    (dq, dk, dv)."""
    dq, delta = flash_dq_plain(q, k, v, out, lse, dout, causal, scale)
    dk, dv = flash_dkv_plain(q, k, v, dout, lse, delta, causal, scale)
    return dq, dk, dv


@functools.cache
def _flash_kernels():
    """The C entry points of csrc/flash_attention.cu (forward, dq, dkv,
    then the design query), built and bound on first use."""
    from ray_tpu_torch.ops._build import load_library

    lib = load_library("flash_attention")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    tail = [i, i, i, i, i, f, i, i, p]     # b, h, lq, lk, d, scale, causal,
    fns = (lib.flash_attention_forward,     # dtype, stream
           lib.flash_attention_dq, lib.flash_attention_dkv)
    for fn, n_ptr in zip(fns, (5, 8, 8)):
        fn.argtypes = [p] * n_ptr + tail
        fn.restype = ctypes.c_int
    lib.flash_attention_design.argtypes = [i, i]
    lib.flash_attention_design.restype = ctypes.c_int
    return fns + (lib.flash_attention_design,)


def flash_design(dtype, head_dim: int) -> str:
    """Which kernels K1, K2 and K3 run on the card for (dtype, head_dim),
    as the CUDA source decides: "tensor cores (mma.sync bf16)" or "CUDA
    cores (f32)"; the three always share one design.  Builds the library
    on first use."""
    tc = _flash_kernels()[3](_KERNEL_DTYPES[dtype], head_dim)
    if tc < 0:
        raise ValueError(f"no flash kernel takes {dtype} at head dim "
                         f"{head_dim}")
    return "tensor cores (mma.sync bf16)" if tc else "CUDA cores (f32)"


def _check_flash_args(name, causal, tensors, lens) -> None:
    """Raise on any input the flash kernels do not take.  `tensors` are
    the [B, L, H, D] operands (q, k, v, then q-length ones); `lens` the
    f32 [B, H, Lq] ones."""
    q = tensors[0]
    b, lq, h, d = q.shape
    lk = tensors[1].shape[1]
    if q.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"{name}: dtype must be float32 or bfloat16; got "
                        f"{q.dtype}")
    if not _use_kernel(lq, lk, d, causal) or lk == 0:
        raise ValueError(f"{name}: no kernel for head dim {d}, q_len {lq}, "
                         f"kv_len {lk}, causal={causal}")
    if b * h > 65535:
        raise ValueError(f"{name}: batch * heads {b * h} > 65535")
    for i, t in enumerate(tensors):
        want = (b, lq if i == 0 or i >= 3 else lk, h, d)
        if t.dim() != 4 or tuple(t.shape) != want or t.dtype != q.dtype:
            raise ValueError(f"{name}: operand {i} is {tuple(t.shape)} "
                             f"{t.dtype}, want {want} {q.dtype}")
    for t in lens:
        if tuple(t.shape) != (b, h, lq) or t.dtype != torch.float32:
            raise ValueError(f"{name}: want f32 [{b}, {h}, {lq}]; got "
                             f"{tuple(t.shape)} {t.dtype}")
    for t in (*tensors, *lens):
        if t.device != q.device or not t.is_contiguous() \
                or t.data_ptr() % 16:
            raise ValueError(f"{name}: every operand must be contiguous, "
                             f"16-byte aligned and on {q.device}")


def _launch(name, which, operands, causal, scale):
    """Launch entry point `which` of `_flash_kernels()` on the current
    stream; `operands` start with q and k."""
    q, k = operands[:2]
    b, lq, h, d = q.shape
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _flash_kernels()[which](
            *[t.data_ptr() for t in operands], b, h, lq, k.shape[1], d,
            float(scale), int(causal), _KERNEL_DTYPES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with cudaError_t "
                           f"{err}")


def _on_cuda(name, x) -> bool:
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {x.device}")
    return True


def flash_forward(q, k, v, causal: bool, scale: float):
    """K1: (O, LSE [B, H, Lq] f32).  A CPU tensor takes
    `flash_forward_plain`; a CUDA tensor launches the kernel or raises.
    `flash_forward.launches` counts kernel launches."""
    if not _on_cuda("flash_forward", q):
        return flash_forward_plain(q, k, v, causal, scale)
    _check_flash_args("flash_forward", causal, (q, k, v), ())
    b, lq, h, _ = q.shape
    out = torch.empty_like(q)
    lse = torch.empty(b, h, lq, dtype=torch.float32, device=q.device)
    _launch("flash_forward", 0, (q, k, v, out, lse), causal, scale)
    flash_forward.launches += 1
    return out, lse


def flash_dq(q, k, v, out, lse, dout, causal: bool, scale: float):
    """K2: (dq, delta [B, H, Lq] f32).  CPU: `flash_dq_plain`.
    `flash_dq.launches` counts kernel launches."""
    if not _on_cuda("flash_dq", q):
        return flash_dq_plain(q, k, v, out, lse, dout, causal, scale)
    _check_flash_args("flash_dq", causal, (q, k, v, out, dout), (lse,))
    b, lq, h, _ = q.shape
    dq = torch.empty_like(q)
    delta = torch.empty(b, h, lq, dtype=torch.float32, device=q.device)
    _launch("flash_dq", 1, (q, k, v, out, dout, lse, dq, delta), causal,
            scale)
    flash_dq.launches += 1
    return dq, delta


def flash_dkv(q, k, v, dout, lse, delta, causal: bool, scale: float):
    """K3: (dk, dv), reading the delta that K2 wrote.  CPU:
    `flash_dkv_plain`.  `flash_dkv.launches` counts kernel launches."""
    if not _on_cuda("flash_dkv", q):
        return flash_dkv_plain(q, k, v, dout, lse, delta, causal, scale)
    _check_flash_args("flash_dkv", causal, (q, k, v, dout), (lse, delta))
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch("flash_dkv", 2, (q, k, v, dout, lse, delta, dk, dv), causal,
            scale)
    flash_dkv.launches += 1
    return dk, dv


flash_forward.launches = 0
flash_dq.launches = 0
flash_dkv.launches = 0


class _FlashAttention(torch.autograd.Function):
    """Forward K1, saving (q, k, v, O, LSE) with O as returned (rounded
    to the input dtype, as the reference's residual); backward K2 then
    K3."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        out, lse = flash_forward(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dout = dout.contiguous()
        dq, delta = flash_dq(q, k, v, out, lse, dout, ctx.causal, ctx.scale)
        dk, dv = flash_dkv(q, k, v, dout, lse, delta, ctx.causal, ctx.scale)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, *, causal: bool = True,
                    scale: Optional[float] = None):
    """Differentiable attention over [B, L, H, D] through K1-K3 where the
    kernels take the call (head dim 64/128/256, square when causal);
    otherwise `reference_attention` and its autograd, as the reference
    falls back to XLA.  The reference's block_q/block_k are TPU tiling
    and have no counterpart.  Non-contiguous inputs are copied."""
    d = q.shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    if not _use_kernel(q.shape[1], k.shape[1], d, causal):
        return reference_attention(q, k, v, causal=causal, scale=scale)
    return _FlashAttention.apply(q.contiguous(), k.contiguous(),
                                 v.contiguous(), causal, scale)


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
    any_kept = keep.any()
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
                              q_positions, *, scale: Optional[float] = None,
                              window: Optional[int] = None):
    """Masked-dense paged attention (the prefill path and the kernel's
    plain version).

    q [B, T, H, D] at absolute q_positions [B, T]; pools [NB, BS, KH, D]
    (KH may divide H — GQA); ctx_lens [B] = tokens written per lane.
    Each query attends to context positions <= its own (the query's K/V
    must already be in the pool), and with a `window` to those past its
    own minus the window.  All-masked rows (a lane with ctx_len = 0) come
    out as a uniform average over the gathered context, never NaN (finite
    NEG_INF) — as in the reference."""
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
    if window is not None:
        mask &= (kpos[None, None, None, :]
                 > q_positions[:, None, :, None] - window)
    logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhtk,bkhd->bthd", probs, v_ctx.float())
    return out.to(q.dtype)


def paged_decode_attention_plain(q, k_pool, v_pool, block_tables, ctx_lens,
                                 *, scale: Optional[float] = None,
                                 window: Optional[int] = None):
    """Plain PyTorch version of the decode kernel: `paged_attention_reference`
    at T = 1, the query at position ctx_len - 1.  q [B, H, D] -> [B, H, D].

    Differs from the kernel only on a lane with ctx_len = 0: here the
    all-masked row is a uniform average (as the reference's dense path),
    the kernel writes zeros (as the reference's Pallas kernel)."""
    out = paged_attention_reference(
        q[:, None], k_pool, v_pool, block_tables, ctx_lens,
        (ctx_lens - 1)[:, None], scale=scale, window=window)
    return out[:, 0]


# Context positions per split of the decode kernel.  The split count,
# ceil(max_blocks * block_size / DECODE_SPLIT_LEN), follows the table's
# width and never ctx_lens, so launching needs no host sync.
DECODE_SPLIT_LEN = 128


def decode_splits(max_blocks: int, block_size: int,
                  window: Optional[int] = None) -> int:
    """How many context splits the decode kernel runs per (lane, head)
    over a table of max_blocks blocks of block_size positions; with a
    `window`, at most the splits that the window's positions can reach
    from its first, ceil((window + DECODE_SPLIT_LEN - 1) /
    DECODE_SPLIT_LEN)."""
    n = -(-max_blocks * block_size // DECODE_SPLIT_LEN)
    if window:
        n = min(n, -(-(window + DECODE_SPLIT_LEN - 1) // DECODE_SPLIT_LEN))
    return n


@functools.cache
def _kernel():
    """The kernel's C entry point, built and bound on first use."""
    from ray_tpu_torch.ops._build import load_library

    fn = load_library("paged_decode").paged_decode_attention
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p] * 8 + [i] * 8 + [ctypes.c_float, i, i, p]
    fn.restype = ctypes.c_int
    return fn


def _check_window(fn, window) -> None:
    if window is not None and (not isinstance(window, int) or window < 1):
        raise ValueError(f"{fn}: window must be a positive int or None; got "
                         f"{window!r}")


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
    _check_operands("paged_decode_attention", q, k_pool, v_pool,
                    block_tables=block_tables, ctx_lens=ctx_lens)


def _check_operands(fn, q, k_pool, v_pool, **rest) -> None:
    """Raise unless every operand is on q's device and contiguous, and q
    and the pools (read in 16-byte loads) are 16-byte aligned."""
    for name, t in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool),
                    *rest.items()):
        if t.device != q.device:
            raise ValueError(f"{fn}: {name} is on {t.device}, q on "
                             f"{q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{fn}: {name} must be contiguous")
        if name in ("q", "k_pool", "v_pool") and t.data_ptr() % 16:
            raise ValueError(f"{fn}: {name} must be 16-byte aligned")


def paged_decode_attention(q, k_pool, v_pool, block_tables, ctx_lens, *,
                           scale: Optional[float] = None,
                           window: Optional[int] = None):
    """Single-query paged attention: q [B, H, D] (one decode token per
    lane) over each lane's block table.  ctx_lens counts tokens already
    written to the pool INCLUDING the current one.  With a `window` the
    query sees the last `window` positions of its context only, and the
    kernel reads no other (`paged_decode_window_*` kernels).

    On a CPU tensor this is `paged_decode_attention_plain`.  On a CUDA
    tensor it launches `csrc/paged_decode.cu` (bf16/f32, D in
    {64, 128, 256}, any q_per_kv) on the current stream, or raises; it
    never falls back.  A lane with ctx_len = 0 comes out as zeros on the
    kernel path (see the plain version).  `paged_decode_attention.launches`
    counts calls that launched the kernel (its split and merge passes
    count as one)."""
    _check_window("paged_decode_attention", window)
    if q.device.type == "cpu":
        return paged_decode_attention_plain(q, k_pool, v_pool, block_tables,
                                            ctx_lens, scale=scale,
                                            window=window)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention: no kernel for device "
                         f"{q.device}")
    _check_kernel_args(q, k_pool, v_pool, block_tables, ctx_lens)
    out = _decode_launch(q, k_pool, v_pool, block_tables, ctx_lens, scale,
                         window)
    paged_decode_attention.launches += 1
    return out


def _decode_launch(q, k_pool, v_pool, block_tables, ctx_lens, scale,
                   window=None):
    """Launch the decode kernel on checked CUDA operands, its f32
    partials allocated here.  They are freed on return, before the kernel
    runs: the caching allocator hands them out again only to work queued
    after it on the same stream."""
    b, h, d = q.shape
    _nb, bs, kh, _ = k_pool.shape
    mb = block_tables.shape[1]
    n_splits = decode_splits(mb, bs, window)
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    out = torch.empty_like(q)
    part_ml = torch.empty(b, h, n_splits, 2, dtype=torch.float32,
                          device=q.device)
    part_acc = torch.empty(b, h, n_splits, d, dtype=torch.float32,
                           device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _kernel()(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            block_tables.data_ptr(), ctx_lens.data_ptr(), out.data_ptr(),
            part_ml.data_ptr(), part_acc.data_ptr(), b, h, kh, d, bs, mb,
            DECODE_SPLIT_LEN, n_splits, float(scale), _KERNEL_DTYPES[q.dtype],
            window or 0, stream)
    if err != 0:
        raise RuntimeError(f"paged_decode_attention: kernel launch failed "
                           f"with cudaError_t {err}")
    return out


paged_decode_attention.launches = 0


# Context positions per split of the prefill kernel (K5).  As for K4,
# the split count, ceil(max_blocks * block_size / PREFILL_SPLIT_LEN),
# follows the table's width and never ctx_lens.  A split's partials are
# T x q_per_kv rows where K4's are one, and every split past a lane's
# context is a block that starts and exits, hence longer splits: at the
# serve cell's prefill dispatch (H100) 512 took 0.129 ms a layer against
# 0.141 at 256 and 0.134 at 1024.
PREFILL_SPLIT_LEN = 512


def prefill_splits(max_blocks: int, block_size: int,
                   split_len: int = PREFILL_SPLIT_LEN,
                   window: Optional[int] = None, q_len: int = 1) -> int:
    """How many context splits of split_len positions the prefill kernel
    runs per (lane, kv head) over a table of max_blocks blocks of
    block_size positions; with a `window`, at most the splits that the
    visible keys of q_len queries can reach from the window's first,
    ceil((window + split_len + q_len - 2) / split_len).  Its C entry
    point counts them the same way from the split_len it is given."""
    n = -(-max_blocks * block_size // split_len)
    if window:
        n = min(n, -(-(window + split_len + q_len - 2) // split_len))
    return n


@functools.cache
def _prefill_kernel():
    """K5's C entry point, built and bound on first use."""
    from ray_tpu_torch.ops._build import load_library

    fn = load_library("paged_prefill").paged_prefill_attention
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p] * 9 + [i] * 8 + [ctypes.c_float, i, p]
    fn.restype = ctypes.c_int
    return fn


def _check_prefill_args(q, k_pool, v_pool, block_tables, ctx_lens,
                        q_positions) -> None:
    """Raise on any input K5 does not take."""
    fn = "paged_prefill_attention"
    if q.dim() != 4 or k_pool.dim() != 4 or v_pool.shape != k_pool.shape:
        raise ValueError(
            f"{fn}: want q [B, T, H, D] and pools [NB, BS, KH, D]; got "
            f"{tuple(q.shape)}, {tuple(k_pool.shape)}, "
            f"{tuple(v_pool.shape)}")
    b, t, h, d = q.shape
    nb, bs, kh, pd = k_pool.shape
    if not q.dtype == k_pool.dtype == v_pool.dtype == torch.bfloat16:
        raise TypeError(f"{fn}: q and pools must be bfloat16; got "
                        f"{q.dtype}, {k_pool.dtype}, {v_pool.dtype}")
    if d not in _KERNEL_HEAD_DIMS or pd != d:
        raise ValueError(f"{fn}: head dim must be one of {_KERNEL_HEAD_DIMS} "
                         f"and match the pool; got q {d}, pool {pd}")
    if kh < 1 or h % kh:
        raise ValueError(f"{fn}: {h} query heads are not a multiple of "
                         f"{kh} kv heads")
    if block_tables.dtype != torch.int32 or ctx_lens.dtype != torch.int32:
        raise TypeError(f"{fn}: block_tables and ctx_lens must be int32")
    if q_positions.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"{fn}: q_positions must be int32 or int64; got "
                        f"{q_positions.dtype}")
    if block_tables.dim() != 2 or block_tables.shape[0] != b \
            or tuple(ctx_lens.shape) != (b,) \
            or tuple(q_positions.shape) != (b, t):
        raise ValueError(
            f"{fn}: want block_tables [{b}, MB], ctx_lens [{b}] and "
            f"q_positions [{b}, {t}]; got {tuple(block_tables.shape)}, "
            f"{tuple(ctx_lens.shape)}, {tuple(q_positions.shape)}")
    if b > 65535 or b * t * h >= 2 ** 31 or nb * bs >= 2 ** 31 \
            or prefill_splits(block_tables.shape[1], bs) > 65535:
        raise ValueError(f"{fn}: batch {b} (at most 65535), rows "
                         f"{b * t * h}, pool rows {nb * bs} or table width "
                         f"{block_tables.shape[1] * bs} past the grid's "
                         f"limits")
    _check_operands(fn, q, k_pool, v_pool, block_tables=block_tables,
                    ctx_lens=ctx_lens, q_positions=q_positions)


def paged_prefill_attention(q, k_pool, v_pool, block_tables, ctx_lens,
                            q_positions, *, scale: Optional[float] = None,
                            window: Optional[int] = None):
    """Multi-token paged attention: q [B, T, H, D] at absolute
    q_positions [B, T] over each lane's block table; the function of
    `paged_attention_reference`.  With a `window` (the
    `paged_prefill_window_*` kernels) each lane's queries must ascend by
    one from its first, as the engine's chunks do.

    On a CPU tensor this is `paged_attention_reference`.  On a CUDA
    tensor it launches K5, `csrc/paged_prefill.cu` (bf16, D in
    {64, 128, 256}, any q_per_kv), on the current stream, or raises; it
    never falls back.  A query row that sees no key (ctx_len = 0, or a
    position below 0) comes out as zeros on the kernel path, as K4's
    ctx_len = 0 lane does, where the plain version averages the table.
    `paged_prefill_attention.launches` counts calls that launched the
    kernel (its split and merge passes count as one)."""
    _check_window("paged_prefill_attention", window)
    if q.device.type == "cpu":
        return paged_attention_reference(q, k_pool, v_pool, block_tables,
                                          ctx_lens, q_positions, scale=scale,
                                          window=window)
    if q.device.type != "cuda":
        raise ValueError(f"paged_prefill_attention: no kernel for device "
                         f"{q.device}")
    _check_prefill_args(q, k_pool, v_pool, block_tables, ctx_lens,
                        q_positions)
    b, t, h, d = q.shape
    _nb, bs, kh, _ = k_pool.shape
    mb = block_tables.shape[1]
    n_splits = prefill_splits(mb, bs, window=window, q_len=t)
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    positions = q_positions.to(torch.int64)
    out = torch.empty_like(q)
    # Freed on return, before the kernel runs: the caching allocator hands
    # them out again only to work queued after it on the same stream.
    part_ml = torch.empty(b * t * h, n_splits, 2, dtype=torch.float32,
                          device=q.device)
    part_acc = torch.empty(b * t * h, n_splits, d, dtype=torch.float32,
                           device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _prefill_kernel()(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            block_tables.data_ptr(), ctx_lens.data_ptr(),
            positions.data_ptr(), out.data_ptr(), part_ml.data_ptr(),
            part_acc.data_ptr(), b, t, h, kh, d, bs, mb, PREFILL_SPLIT_LEN,
            float(scale), window or 0, stream)
    if err != 0:
        raise RuntimeError(f"paged_prefill_attention: kernel launch failed "
                           f"with cudaError_t {err}")
    paged_prefill_attention.launches += 1
    return out


paged_prefill_attention.launches = 0


def _use_paged_kernel(d: int) -> bool:
    """The reference's rule for the decode kernel: head dims 64, 128 and
    256.  A route by shape, as `_use_kernel` is for flash: other head
    dims take the masked-dense path, on any device."""
    return d in _KERNEL_HEAD_DIMS


def _use_prefill_kernel(q) -> bool:
    """K5 takes bf16 at the decode kernel's head dims; f32 calls and
    other head dims keep the masked-dense path, on any device."""
    return q.dtype == torch.bfloat16 and _use_paged_kernel(q.shape[-1])


def paged_attention(q, k_pool, v_pool, block_tables, ctx_lens, q_positions,
                    *, scale: Optional[float] = None,
                    window: Optional[int] = None):
    """Dispatch paged attention for a [B, T, H, D] query slice: the T=1
    decode step rides the single-query kernel path where the head dim
    allows (`_use_paged_kernel`), the masked-dense path at the query's
    position ctx_len - 1 elsewhere, as the reference routes it.  A
    multi-token call (prefill chunk, verify step) rides K5 in bf16 at
    those head dims (`_use_prefill_kernel`), the masked-dense path
    otherwise.  `window`: each query sees the last `window` positions up
    to its own only."""
    if q.shape[1] == 1:
        if _use_paged_kernel(q.shape[-1]):
            return paged_decode_attention(
                q[:, 0], k_pool, v_pool, block_tables, ctx_lens,
                scale=scale, window=window)[:, None]
        q_positions = (ctx_lens - 1)[:, None]
    elif _use_prefill_kernel(q):
        return paged_prefill_attention(q.contiguous(), k_pool, v_pool,
                                       block_tables, ctx_lens, q_positions,
                                       scale=scale, window=window)
    return paged_attention_reference(q, k_pool, v_pool, block_tables,
                                     ctx_lens, q_positions, scale=scale,
                                     window=window)
