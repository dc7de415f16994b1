#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (ray_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py                     # one card

It runs every phase, each printing one JSON line; any failure ends the
run with a nonzero exit code and no result line:

  device   the card (nvidia-smi name and power limit), torch/CUDA versions,
           then every kernel of the port built from csrc/ with nvcc, one
           nvcc per source, all started together.
  kernels  the paged-decode kernel (K4, split-context: one partial per
           context split, then a merge) against its plain PyTorch version
           on the same inputs at the serving paths' shapes (gpt2-small
           decode: 32 lanes, 12 heads of 64, block 16, ragged contexts up
           to 1024, bf16 and f32; llama-1b decode: 32 lanes, 4 kv heads x
           q_per_kv 8 of 64, ragged contexts up to 2048, bf16), at 4
           lanes of the gpt2 shape, and at GQA shapes (q_per_kv 2, 4, 7,
           8 and 12), then timed with CUDA
           events (median over launches, L2 flushed and the device held
           busy by a spin before each, so the host's launch is not timed)
           beside its bound, its plain version and one PyTorch library
           call; and once more without the spin, the host's enqueue
           included (ms_with_launch).  Each case names its split count
           and split length.
  flash    the flash-attention kernels K1 (forward), K2 (dq) and K3
           (dk, dv) against their plain versions at the train shape
           (B 24, L 1024, 12 heads of 64, causal; bf16 and f32), at the
           llama-1b train shape (B 4, L 2048, 32 heads of 64, causal,
           bf16), at D 128 and 256, non-causal with q_len != kv_len, and
           at a length that is no multiple of a tile; then timed the same
           way, beside
           scaled_dot_product_attention's forward (K1) and backward (K2
           and K3 together).  Each case names the design K1-K3 ran (bf16
           at D 64/128: the tensor cores, with P and dS rounded to bf16,
           held to TENSOR_CORE_TOLERANCE, 2**-7 of each row's largest
           value + 2**-7 relative, and for dq an absolute floor).
           Three faults planted on late rows of the train shape's plain
           outputs (K1's O, K2's dq, K3's dk and dv) must break that
           limit.
  serve    the serving path: InferenceEngine("gpt", "gpt2-small") at full
           width, random bf16 weights from a seed, 32 lanes, answering 24
           streamed requests (greedy and seeded, a shared prefix).  The
           kernel launch counts are set to 0 just before and read just
           after; the decode kernel must have run once per layer per
           decode step.
  train    the training path: gpt.make_train_step(gpt2-small, adamw(1e-4))
           at full width (bf16 activations, fp32 params, random weights
           from a seed) on one repeated batch of 24 x 1024 random tokens,
           as bench.py drives the reference: 2 warm-up steps, then timed
           steps.  K1, K2 and K3 must each have run 12 times per timed
           step, every loss must be finite, the last below the first, and
           each within 0.02 of the trajectory recorded before K1 and K3
           moved to the tensor cores.
  parity   gpt2-small in float32: the same greedy requests through the
           engine on the card and on the CPU must give the same tokens.
  train_parity  gpt2-small widths in float32 at 2 layers, batch 2 x 256:
           one train step on the card and one on the CPU from the same
           weights and tokens; the losses and every gradient must agree.
  serve_llama  the Llama serving path: InferenceEngine("llama",
           "llama-1b") at full width and depth (22 layers, 32 query heads
           over 4 kv heads of 64), random bf16 weights drawn on the card
           from a seed, 32 lanes, 24 streamed requests as in serve; K4
           must have run once per layer per decode step, at q_per_kv 8.
  train_llama  llama.make_train_step(llama-1b, adamw(1e-4)) at full width
           and depth on one repeated batch of 4 x 2048 random tokens: 2
           warm-up steps, then 6 timed steps; K1, K2 and K3 (over the
           repeated kv heads) must each have run 22 times per timed step,
           the losses must be finite and falling, each within 0.02 of the
           trajectory recorded on the first run.
  llama_parity  llama-1b widths in float32 at 2 layers: the same greedy
           requests through the engine on the card and on the CPU (K4 at
           q_per_kv 8 in f32) must give the same tokens; one train step on
           2 x 128 tokens must give the same loss and gradients; and
           llama-tiny (head dim 16, whose decode step takes the
           masked-dense route) must give the same greedy tokens.

Each phase's wall seconds follow it on a line of their own.  Then, on
lines of their own: the kernels' JSON record, the card's name and power
limit, and last {"ok": true, "device": {...}}.  Exits nonzero without a
card, and when the ray_tpu_torch package is not beside it.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import math
import statistics
import subprocess
import sys
import threading
import time

import torch

# NVIDIA's H100 SXM data sheet: HBM3 rate; dense bf16 tensor-core and
# f32 (non-tensor) peaks, at the full 700 W power limit.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
# Kernel vs plain on the same inputs.  f32: the sums run in another
# order.  bf16: both sides compute in f32 and round once to bf16, so they
# may differ by one bf16 ulp (2**-7 relative at most).
TOLERANCE = {torch.float32: (2e-5, 2e-5), torch.bfloat16: (1e-3, 2 ** -7)}


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {what}")


# ---------------------------------------------------------------- kernels

def _decode_case(gen, *, b, kh, q_per_kv, d, bs, max_ctx, dtype):
    h = kh * q_per_kv
    mb = max_ctx // bs
    nb = b * mb + 8
    ctx = torch.randint(1, max_ctx + 1, (b,), generator=gen)
    ctx[:4] = torch.tensor([1, max_ctx, bs, bs + 1])  # edges of the tiling
    tables = torch.randperm(nb, generator=gen)[:b * mb].view(b, mb)

    def rand(*shape):
        return torch.randn(*shape, generator=gen).to(dtype).cuda()

    return dict(q=rand(b, h, d), k_pool=rand(nb, bs, kh, d),
                v_pool=rand(nb, bs, kh, d),
                block_tables=tables.to(torch.int32).cuda(),
                ctx_lens=ctx.to(torch.int32).cuda())


# About a millisecond of device time at the H100's clock: queued before
# each timed call, it keeps the device busy while the host enqueues the
# call, so the events time the device's work and not the host's launch.
SPIN_CYCLES = 2_000_000


def _time_ms(fn, reps: int = 40, spin: bool = True) -> float:
    """Median time of one call, L2 flushed before each.  With `spin`
    the device time; without it the events also take in the host's
    enqueue of the call, wherever that is longer than the device's
    work."""
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(reps):
        flush.zero_()
        if spin:
            torch.cuda._sleep(SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def _decode_bound(c) -> tuple:
    """Least time for this call's work on an H100: each input byte the
    call needs read once (the context's K/V rows, q, the table entries it
    reads, ctx_lens), the output written once; or its QK and PV flops at
    the peak for the input type.  Returns (ms, "bytes"|"operations")."""
    q, k = c["q"], c["k_pool"]
    b, h, d = q.shape
    _, bs, kh, _ = k.shape
    ctx = c["ctx_lens"].long()
    sz = q.element_size()
    kv_bytes = int(ctx.sum()) * kh * d * 2 * sz
    table_bytes = int(((ctx + bs - 1) // bs).sum()) * 4 + b * 4
    nbytes = kv_bytes + 2 * q.numel() * sz + table_bytes
    flops = 4 * int(ctx.sum()) * h * d
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[q.dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def _sdpa_inputs(c):
    """The contiguous, pre-gathered context for the library yardstick."""
    q, k_pool, v_pool = c["q"], c["k_pool"], c["v_pool"]
    b, h, d = q.shape
    _, bs, kh, _ = k_pool.shape
    tables = c["block_tables"].long()
    max_ctx = tables.shape[1] * bs

    def ctx(pool):
        x = pool[tables].reshape(b, max_ctx, kh, d).transpose(1, 2)
        return x.repeat_interleave(h // kh, dim=1).contiguous()

    mask = (torch.arange(max_ctx, device=q.device)[None]
            < c["ctx_lens"][:, None])[:, None, None, :]
    return q[:, :, None], ctx(k_pool), ctx(v_pool), mask


def phase_kernels(report: dict) -> None:
    import torch.nn.functional as F

    from ray_tpu_torch.ops import attention as A

    gen = torch.Generator().manual_seed(0)
    cases = {
        "gpt2-small-bf16": dict(b=32, kh=12, q_per_kv=1, d=64, bs=16,
                                max_ctx=1024, dtype=torch.bfloat16),
        "gpt2-small-f32": dict(b=32, kh=12, q_per_kv=1, d=64, bs=16,
                               max_ctx=1024, dtype=torch.float32),
        # Few lanes: one block per (lane, kv head) would be 48 blocks on
        # 132 SMs; the splits fill the card.
        "4-lane-bf16": dict(b=4, kh=12, q_per_kv=1, d=64, bs=16,
                            max_ctx=1024, dtype=torch.bfloat16),
        "gqa4-d128-bf16": dict(b=16, kh=8, q_per_kv=4, d=128, bs=16,
                               max_ctx=1024, dtype=torch.bfloat16),
        # q_per_kv 2: one block of two query heads per kv head.
        "gqa2-d128-bf16": dict(b=8, kh=4, q_per_kv=2, d=128, bs=16,
                               max_ctx=1024, dtype=torch.bfloat16),
        # q_per_kv 7 (Qwen2-7B: 28 query heads over 4): seven blocks of
        # one query head each per kv head.
        "gqa7-d128-bf16": dict(b=8, kh=4, q_per_kv=7, d=128, bs=16,
                               max_ctx=1024, dtype=torch.bfloat16),
        # q_per_kv 12: three blocks of four query heads per kv head.
        "gqa12-d64-f32": dict(b=4, kh=2, q_per_kv=12, d=64, bs=16,
                              max_ctx=512, dtype=torch.float32),
        # A 1 KB row: one warp per position, two 16-byte loads a thread.
        "gqa8-d256-f32": dict(b=4, kh=2, q_per_kv=8, d=256, bs=32,
                              max_ctx=256, dtype=torch.float32),
        # The llama-1b decode step: 32 query heads over 4 kv heads, one
        # block of eight query heads per kv head.
        "llama-1b-bf16": dict(b=32, kh=4, q_per_kv=8, d=64, bs=16,
                              max_ctx=2048, dtype=torch.bfloat16),
    }
    results = {}
    for name, spec in cases.items():
        c = _decode_case(gen, **spec)
        out = A.paged_decode_attention(**c)
        plain = A.paged_decode_attention_plain(**c)
        torch.cuda.synchronize()
        atol, rtol = TOLERANCE[spec["dtype"]]
        err = (out.float() - plain.float()).abs()
        ok = bool((err <= atol + rtol * plain.float().abs()).all())
        check(bool(torch.isfinite(out.float()).all()),
              f"{name}: kernel output not finite")
        check(ok, f"{name}: kernel disagrees with its plain version "
                  f"(max abs err {float(err.max())}, atol {atol}, "
                  f"rtol {rtol})")
        sdpa = _sdpa_inputs(c)
        bound_ms, bound_by = _decode_bound(c)
        results[name] = dict(
            max_abs_err=float(err.max()), atol=atol, rtol=rtol,
            ms=_time_ms(lambda: A.paged_decode_attention(**c)),
            ms_with_launch=_time_ms(lambda: A.paged_decode_attention(**c),
                                    spin=False),
            plain_ms=_time_ms(lambda: A.paged_decode_attention_plain(**c)),
            library_ms=_time_ms(lambda: F.scaled_dot_product_attention(
                sdpa[0], sdpa[1], sdpa[2], attn_mask=sdpa[3])),
            bound_ms=bound_ms, bound_by=bound_by,
            ctx_tokens=int(c["ctx_lens"].long().sum()),
            q_per_kv=spec["q_per_kv"], split_len=A.DECODE_SPLIT_LEN,
            splits=A.decode_splits(c["block_tables"].shape[1], spec["bs"]))
    emit("kernels", cases=results)
    keys = ("max_abs_err", "ms", "ms_with_launch", "plain_ms", "bound_ms",
            "bound_by", "library_ms")
    report["paged_decode_attention"] = dict(
        name="paged_decode_attention", route="cuda",
        source="ray_tpu_torch/ops/csrc/paged_decode.cu",
        replaces="ray_tpu/ops/attention.py:291",
        **{k: results["gpt2-small-bf16"][k] for k in keys},
        llama_1b={k: results["llama-1b-bf16"][k] for k in keys})


# ------------------------------------------------------------------ flash

# Flash kernels vs plain on the same inputs, as (atol, rtol).  f32: both
# sides compute in f32 and sum up to L * D products in another order.
# bf16 on the f32 kernels (D 256): both compute in f32 and round once, so
# they may differ by one bf16 ulp (2**-7 relative at most).  LSE and
# delta are f32 for either input type.  O (K1), dq (K2) and dk, dv (K3)
# from the tensor-core kernels are held to ops.attention.tensor_core_limit
# instead: there P and dS are rounded to bf16 before the products that
# take them.
FLASH_TOLERANCE = {torch.float32: (1e-4, 1e-4),
                   torch.bfloat16: (1e-3, 2 ** -7)}
FLASH_CASES = {
    "train-bf16": dict(b=24, lq=1024, lk=1024, h=12, d=64, causal=True,
                       dtype=torch.bfloat16),
    "train-f32": dict(b=24, lq=1024, lk=1024, h=12, d=64, causal=True,
                      dtype=torch.float32),
    # The llama-1b train step: 32 query heads over the repeated kv heads.
    "llama-1b-train-bf16": dict(b=4, lq=2048, lk=2048, h=32, d=64,
                                causal=True, dtype=torch.bfloat16),
    "d128-bf16": dict(b=4, lq=1024, lk=1024, h=8, d=128, causal=True,
                      dtype=torch.bfloat16),
    "d256-f32": dict(b=2, lq=512, lk=512, h=4, d=256, causal=True,
                     dtype=torch.float32),
    "d256-bf16": dict(b=2, lq=512, lk=512, h=4, d=256, causal=True,
                      dtype=torch.bfloat16),
    # Non-causal with q_len != kv_len, neither a multiple of a tile.
    "full-ragged-bf16": dict(b=4, lq=500, lk=1000, h=12, d=64, causal=False,
                             dtype=torch.bfloat16),
    # Causal at a length that is no multiple of the 64-row tile.
    "causal-ragged-f32": dict(b=3, lq=1000, lk=1000, h=12, d=64,
                              causal=True, dtype=torch.float32),
}


def _flash_bounds(c) -> dict:
    """Least time of each kernel's work at case c on an H100, as
    (ms, "bytes"|"operations"): each operand it reads once, each output
    written once; 2 flops per multiply-add of its products (K1: S and
    PV; K2: S, dP and dQ; K3: S, dP, dV and dK) over the visible (q, k)
    pairs only, at the peak for the input type."""
    b, lq, lk, h, d = c["b"], c["lq"], c["lk"], c["h"], c["d"]
    sz = torch.empty((), dtype=c["dtype"]).element_size()
    pairs = b * h * (lq * (lq + 1) // 2 if c["causal"] else lq * lk)
    row_q, row_k, lens = b * lq * h * d * sz, b * lk * h * d * sz, b * h * lq * 4
    work = {  # name: (bytes, flops)
        "K1": (2 * row_q + 2 * row_k + lens, 4 * d * pairs),  # q,k,v -> o, lse
        "K2": (4 * row_q + 2 * row_k + 2 * lens, 6 * d * pairs),
        "K3": (2 * row_q + 4 * row_k + 2 * lens, 8 * d * pairs),
    }
    out = {}
    for name, (nbytes, flops) in work.items():
        t_bytes = nbytes / HBM_BYTES_PER_S
        t_ops = flops / PEAK_FLOPS[c["dtype"]]
        out[name] = (max(t_bytes, t_ops) * 1e3,
                     "bytes" if t_bytes >= t_ops else "operations")
    return out


def _flash_errors(name, dtype, pairs, tensor_cores) -> tuple:
    """Check each (what, kernel, plain) pair: O, dq, dk and dv from the
    tensor-core kernels against ops.attention.tensor_core_limit, anything
    else against FLASH_TOLERANCE for its dtype.  Returns the largest abs
    error and the largest share of its limit that an entry used."""
    from ray_tpu_torch.ops import attention as A

    worst, used = 0.0, 0.0
    for what, got, want in pairs:
        out_dtype = got.dtype
        got, want = got.float(), want.float()
        check(bool(torch.isfinite(got).all()), f"{name} {what}: not finite")
        err = (got - want).abs()
        if tensor_cores and what in ("O", "dq", "dk", "dv"):
            limit = A.tensor_core_limit(want, what)
            rule = "TENSOR_CORE_TOLERANCE (2**-7 of the row's max|plain| " \
                   "+ 2**-7 * |plain|, for dq + 2**-14 * max|plain|)"
        else:
            atol, rtol = FLASH_TOLERANCE[torch.float32 if out_dtype ==
                                         torch.float32 else dtype]
            limit = atol + rtol * want.abs()
            rule = f"{atol} + {rtol} * |plain|"
        share = _share(err, limit)
        check(share <= 1.0, f"{name} {what}: kernel disagrees with its plain "
                            f"version (max abs err {float(err.max())}, "
                            f"tolerance {rule})")
        worst, used = max(worst, float(err.max())), max(used, share)
    return worst, used


def _share(err, limit) -> float:
    """The largest err / limit over the entries (<= 1 passes)."""
    return float((err / limit.clamp_min(1e-30)).max())


def _planted_faults(q, k, v, do, lse, delta, po, pdq, pdk, pdv,
                    scale) -> dict:
    """The share of tensor_core_limit that three faults limited to late
    rows would use at the train shape, built from the plain outputs: K1
    skipping kv tile 0 for q tiles >= 8 (O rows 512+ lose those keys
    from both sums), K2 skipping the same tile (dq rows 512+ lose
    scale * sum_{j<64} dS_ij k_j), and K3 skipping q tile 15 for kv tiles
    8-14 (dk and dv rows 512-959 lose that tile's terms).  Each must
    exceed 1."""
    from ray_tpu_torch.ops.attention import tensor_core_limit

    f = lambda x: x.float()  # noqa: E731
    out = {}
    # K1: O_i = (O_i - sum_{j<64} p_ij v_j) / (1 - sum_{j<64} p_ij).
    qs = f(q[:, 512:])
    p = torch.exp(torch.einsum("bihd,bjhd->bhij", qs, f(k[:, :64])) * scale
                  - lse[:, :, 512:, None])
    part = torch.einsum("bhij,bjhd->bihd", p, f(v[:, :64]))
    kept = (1 - p.sum(-1)).transpose(1, 2)[..., None]
    o = f(po).clone()
    o[:, 512:] = (o[:, 512:] - part) / kept
    o = o.to(po.dtype).float()
    out["O"] = _share((o - f(po)).abs(), tensor_core_limit(po, "O"))
    # K2: dq_i -= scale * sum_{j<64} dS_ij k_j over q rows 512+.
    ds = p * (torch.einsum("bihd,bjhd->bhij", f(do[:, 512:]), f(v[:, :64]))
              - delta[:, :, 512:, None])
    dq = f(pdq).clone()
    dq[:, 512:] -= torch.einsum("bhij,bjhd->bihd", ds, f(k[:, :64])) * scale
    dq = dq.to(pdq.dtype).float()
    out["dq"] = _share((dq - f(pdq)).abs(), tensor_core_limit(pdq, "dq"))
    # K3: dv_j -= sum_i p_ij dO_i, dk_j -= scale * sum_i dS_ij q_i over
    # q rows 960-1023 and kv rows 512-959.
    qi, doi, kj, vj = f(q[:, 960:]), f(do[:, 960:]), f(k[:, 512:960]), \
        f(v[:, 512:960])
    p = torch.exp(torch.einsum("bihd,bjhd->bhij", qi, kj) * scale
                  - lse[:, :, 960:, None])
    ds = p * (torch.einsum("bihd,bjhd->bhij", doi, vj)
              - delta[:, :, 960:, None])
    for what, plain, drop in (
            ("dv", pdv, torch.einsum("bhij,bihd->bjhd", p, doi)),
            ("dk", pdk, torch.einsum("bhij,bihd->bjhd", ds, qi) * scale)):
        got = f(plain).clone()
        got[:, 512:960] -= drop
        got = got.to(plain.dtype).float()
        out[what] = _share((got - f(plain)).abs(), tensor_core_limit(plain, what))
    for what, share in out.items():
        check(share > 1.0, f"a planted late-row fault in {what} used only "
                           f"{share} of TENSOR_CORE_TOLERANCE")
    return out


def phase_flash(report: dict) -> None:
    import torch.nn.functional as F

    from ray_tpu_torch.ops import attention as A

    gen = torch.Generator().manual_seed(1)
    results = {}
    for name, c in FLASH_CASES.items():
        b, lq, lk, h, d, causal = (c[k] for k in
                                   ("b", "lq", "lk", "h", "d", "causal"))

        def rand(l):
            return torch.randn(b, l, h, d, generator=gen).to(
                c["dtype"]).cuda()

        q, k, v, do = rand(lq), rand(lk), rand(lk), rand(lq)
        scale = d ** -0.5
        o, lse = A.flash_forward(q, k, v, causal, scale)
        po, plse = A.flash_forward_plain(q, k, v, causal, scale)
        dq, delta = A.flash_dq(q, k, v, o, lse, do, causal, scale)
        pdq, pdelta = A.flash_dq_plain(q, k, v, o, lse, do, causal, scale)
        dk, dv = A.flash_dkv(q, k, v, do, lse, delta, causal, scale)
        pdk, pdv = A.flash_dkv_plain(q, k, v, do, lse, pdelta, causal, scale)
        torch.cuda.synchronize()
        design = A.flash_design(c["dtype"], d)
        tc = design.startswith("tensor cores")
        err = {
            "K1": _flash_errors(name, c["dtype"], [("O", o, po),
                                                   ("LSE", lse, plse)], tc),
            "K2": _flash_errors(name, c["dtype"], [("dq", dq, pdq),
                                                   ("delta", delta, pdelta)],
                                tc),
            "K3": _flash_errors(name, c["dtype"], [("dk", dk, pdk),
                                                   ("dv", dv, pdv)], tc),
        }
        if name == "train-bf16":
            faults = _planted_faults(q, k, v, do, plse, pdelta, po, pdq, pdk,
                                     pdv, scale)
        del po, plse, pdq, pdelta, pdk, pdv
        # The library yardstick: SDPA on [B, H, L, D] views (never called
        # by the port); its backward is K2 and K3 together.
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                      for x in (q, k, v))
        dot = do.transpose(1, 2)

        def sdpa():
            return F.scaled_dot_product_attention(qt, kt, vt,
                                                  is_causal=causal)

        def sdpa_fwd_bwd():
            torch.autograd.grad(sdpa(), (qt, kt, vt), dot)

        lib_fwd = _time_ms(sdpa, reps=20)
        lib_bwd = _time_ms(sdpa_fwd_bwd, reps=20) - lib_fwd
        bounds = _flash_bounds(c)
        times = {
            "K1": (lambda: A.flash_forward(q, k, v, causal, scale),
                   lambda: A.flash_forward_plain(q, k, v, causal, scale),
                   lib_fwd),
            "K2": (lambda: A.flash_dq(q, k, v, o, lse, do, causal, scale),
                   lambda: A.flash_dq_plain(q, k, v, o, lse, do, causal,
                                            scale), lib_bwd),
            "K3": (lambda: A.flash_dkv(q, k, v, do, lse, delta, causal,
                                       scale),
                   lambda: A.flash_dkv_plain(q, k, v, do, lse, delta, causal,
                                             scale), lib_bwd),
        }
        results[name] = {
            kern: dict(max_abs_err=err[kern][0], tolerance_used=err[kern][1],
                       design=design,
                       ms=_time_ms(fn, reps=20),
                       plain_ms=_time_ms(plain, reps=5), library_ms=lib,
                       bound_ms=bounds[kern][0], bound_by=bounds[kern][1])
            for kern, (fn, plain, lib) in times.items()}
        del q, k, v, do, o, lse, dq, delta, dk, dv, qt, kt, vt, dot
        torch.cuda.empty_cache()
    atol = {str(t).replace("torch.", ""): FLASH_TOLERANCE[t]
            for t in FLASH_TOLERANCE}
    emit("flash", tolerance_atol_rtol=atol,
         tensor_core_tolerance_of_rowmax_and_rel=A.TENSOR_CORE_TOLERANCE,
         planted_late_row_faults_tolerance_used=faults, cases=results)
    train, llama_train = results["train-bf16"], results["llama-1b-train-bf16"]
    for kern, fn, line in (("K1", "flash_forward", 53),
                           ("K2", "flash_dq", 414), ("K3", "flash_dkv", 457)):
        report[fn] = dict(
            name=fn, route="cuda",
            source="ray_tpu_torch/ops/csrc/flash_attention.cu",
            replaces=f"ray_tpu/ops/attention.py:{line}", **train[kern],
            llama_1b=dict(llama_train[kern]))
        if kern != "K1":
            report[fn]["library_note"] = (
                "scaled_dot_product_attention backward: dq, dk and dv "
                "together (K2 + K3)")


# ------------------------------------------------------------------ serve

def _serve_requests(vocab: int, rng_seed: int = 0):
    import numpy as np

    rng = np.random.default_rng(rng_seed)
    shared = rng.integers(0, vocab, 64).tolist()           # four blocks

    def req(prompt, i):
        kw = dict(max_new_tokens=int(rng.integers(32, 65)))
        if i % 2:
            kw.update(temperature=0.8, seed=1000 + i)
        if i % 7 == 3:
            kw.update(eos_id=int(rng.integers(0, vocab)))
        return prompt, kw

    first = [req(shared + rng.integers(0, vocab, 8).tolist(), 0)]
    first += [req(rng.integers(0, vocab, int(rng.integers(16, 161))).tolist(),
                  i) for i in range(1, 16)]
    second = [req(shared + rng.integers(0, vocab,
                                        int(rng.integers(1, 40))).tolist(), i)
              for i in range(16, 24)]
    return first, second


class _Consumer(threading.Thread):
    """Streams one handle: submit-to-first-token time and the tokens."""

    def __init__(self, handle, t_submit: float):
        super().__init__(daemon=True)
        self.handle, self.t_submit = handle, t_submit
        self.first = threading.Event()
        self.tokens: list = []
        self.ttft = None

    def run(self):
        for tok in self.handle:
            if self.ttft is None:
                self.ttft = time.perf_counter() - self.t_submit
                self.first.set()
            self.tokens.append(tok)
        self.first.set()


def _serve(family: str, config_name: str, params=None) -> dict:
    """Serve the 24 requests of `_serve_requests` through
    InferenceEngine(family, config_name) at 32 lanes, block 16, with the
    decode kernel's count set to 0 just before and read just after;
    check every stream and the count (once per layer per decode step).
    Returns the phase's metrics."""
    from ray_tpu_torch.inference import InferenceEngine
    from ray_tpu_torch.ops import attention as A

    t0 = time.perf_counter()
    eng = InferenceEngine(family, config_name, params=params, device="cuda",
                          seed=1234, max_lanes=32, block_size=16)
    n_layers, vocab = eng.config.n_layers, eng.config.vocab_size
    try:
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        eng.generate(list(range(40)), max_new_tokens=4)         # warm-up
        torch.cuda.synchronize()
        before = eng.stats()
        first, second = _serve_requests(vocab)

        A.paged_decode_attention.launches = 0
        t_start = time.perf_counter()

        def submit(batch):
            out = []
            for prompt, kw in batch:
                c = _Consumer(eng.submit(prompt, **kw), time.perf_counter())
                c.start()
                out.append((kw, c))
            return out

        streams = submit(first)
        # Wave two shares wave one's first prompt's sealed prefix.
        check(streams[0][1].first.wait(timeout=300),
              "first request produced no token")
        streams += submit(second)
        for _, c in streams:
            c.join(timeout=600)
            check(not c.is_alive(), "a request did not finish")
        wall = time.perf_counter() - t_start
        launches = A.paged_decode_attention.launches
        after = eng.stats()
    finally:
        eng.shutdown()

    decode_steps = after["decode_steps"] - before["decode_steps"]
    decode_s = after["decode_seconds"] - before["decode_seconds"]
    hits = after["prefix_hits"] - before["prefix_hits"]
    for kw, c in streams:
        reason = c.handle.finish_reason
        check(reason in ("length", "eos"), f"finish_reason {reason!r}")
        check(len(c.tokens) == kw["max_new_tokens"] or reason == "eos",
              "a request stopped short")
        check(all(0 <= t < vocab for t in c.tokens), "token out of range")
    check(launches == decode_steps * n_layers,
          f"decode kernel launched {launches} times for {decode_steps} "
          f"decode steps x {n_layers} layers")
    check(launches > 0, "the decode kernel never ran")
    check(hits >= 1, "no prefix-cache hit")
    generated = sum(len(c.tokens) for _, c in streams)
    ttfts = sorted(c.ttft for _, c in streams)
    decode_tokens = generated - len(streams)     # first tokens: prefill
    return dict(
        config=config_name, requests=len(streams),
        generated_tokens=generated,
        wall_s=wall, engine_setup_s=setup_s,
        output_tokens_per_s=generated / wall,
        decode_tokens_per_s=decode_tokens / decode_s,
        decode_steps=decode_steps,
        decode_step_ms=decode_s / decode_steps * 1e3,
        prefill_steps=after["prefill_steps"] - before["prefill_steps"],
        ttft_p50_ms=statistics.median(ttfts) * 1e3,
        ttft_max_ms=ttfts[-1] * 1e3,
        prefix_hits=hits,
        prefix_hit_tokens=(after["prefix_hit_tokens"]
                           - before["prefix_hit_tokens"]),
        finish_reasons={r: sum(c.handle.finish_reason == r
                               for _, c in streams)
                        for r in ("length", "eos")},
        decode_kernel_launches=launches)


def phase_serve(report: dict) -> None:
    out = _serve("gpt", "gpt2-small")
    report["paged_decode_attention"]["launches"] = \
        out["decode_kernel_launches"]
    emit("serve", **out)


def phase_serve_llama(report: dict) -> None:
    """llama-1b at full width and depth; the 1.1B random weights are
    drawn on the card (a CPU draw costs seconds), and the engine is shut
    down and freed before training."""
    from ray_tpu_torch.models import llama

    t0 = time.perf_counter()
    params = llama.init_params(
        llama.CONFIGS["llama-1b"],
        torch.Generator(device="cuda").manual_seed(1234), device="cuda")
    torch.cuda.synchronize()
    params_s = time.perf_counter() - t0
    out = _serve("llama", "llama-1b", params)
    del params
    report["paged_decode_attention"]["llama_1b"]["launches"] = \
        out["decode_kernel_launches"]
    emit("serve_llama", params_s=params_s,
         q_per_kv=llama.CONFIGS["llama-1b"].q_per_kv, **out)


# ----------------------------------------------------------------- parity

def _f32_exact() -> None:
    """Plain f32 products on the card (TF32 off), as on the CPU."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def _greedy_parity(phase: str, family: str, config, params, label: str,
                   **engine_kw) -> None:
    """The same 4 greedy requests through the engine on the card and on
    the CPU, from the same weights, must give the same tokens."""
    from ray_tpu_torch.inference import InferenceEngine

    vocab = config.vocab_size
    prompts = [[(37 * i + 11 * j) % vocab for j in range(n)]
               for i, n in enumerate((5, 17, 33, 48))]
    outs = {}
    for device in ("cuda", "cpu"):
        eng = InferenceEngine(family, config, params=params, device=device,
                              max_lanes=4, block_size=16, max_seq_len=128,
                              auto_start=False, **engine_kw)
        handles = [eng.submit(p, max_new_tokens=16) for p in prompts]
        while eng.step():
            pass
        outs[device] = [h.tokens(timeout=60) for h in handles]
    same = outs["cuda"] == outs["cpu"]
    emit(phase, config=label, requests=len(prompts), new_tokens=16,
         tokens_equal=same,
         mismatched=[i for i, (a, b) in enumerate(zip(outs["cuda"],
                                                      outs["cpu"]))
                     if a != b])
    check(same, f"{label}: CUDA and CPU greedy tokens differ")


def phase_parity() -> None:
    from ray_tpu_torch.models import gpt

    _f32_exact()
    config = dataclasses.replace(gpt.CONFIGS["gpt2-small"],
                                 dtype=torch.float32)
    params = gpt.init_params(config, torch.Generator().manual_seed(7),
                             device="cpu")
    _greedy_parity("parity", "gpt", config, params, "gpt2-small float32")


# ------------------------------------------------------------------ train

TRAIN_WARMUP, TRAIN_STEPS = 2, 6
# The 8 losses of this run (2 warm-up + 6 timed steps, same seeds) as
# recorded in PERF.md when every flash product ran in f32 on the CUDA
# cores.  With P and dS rounded to bf16 on the tensor cores each must
# stay within LOSS_DRIFT of them.
F32_FLASH_LOSSES = (10.974, 10.857, 10.749, 10.684, 10.628, 10.557, 10.431,
                    10.359)
# llama-1b's 8 losses (train_llama: 4 x 2048, weights drawn on the card
# from seed 0, tokens from seed 1) as recorded on their first run.
LLAMA_1B_LOSSES = (10.888, 10.359, 10.130, 9.796, 9.691, 9.395, 9.594,
                   9.142)
LOSS_DRIFT = 0.02


def _train(model, config, batch: int, seq: int, key) -> dict:
    """TRAIN_WARMUP + TRAIN_STEPS AdamW(1e-4) steps of
    `model.make_train_step(config)` on one repeated batch of random
    tokens (seed 1), the flash kernels' counts set to 0 just before the
    timed steps and read just after.  `key` seeds the weights (a torch
    Generator draws them on its own device).  Checks the losses are
    finite and falling and that K1, K2 and K3 each ran once per layer
    per timed step."""
    from ray_tpu_torch.models._functional import adamw
    from ray_tpu_torch.ops import attention as A

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    init_state, train_step = model.make_train_step(config, adamw(1e-4),
                                                   device="cuda")
    state = init_state(key)
    tokens = torch.randint(0, config.vocab_size, (batch, seq),
                           generator=torch.Generator().manual_seed(1)).cuda()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    losses = []
    for _ in range(TRAIN_WARMUP):
        state, metrics = train_step(state, {"tokens": tokens})
        losses.append(metrics["loss"])
    torch.cuda.synchronize()

    kernels = (A.flash_forward, A.flash_dq, A.flash_dkv)
    for fn in kernels:
        fn.launches = 0
    t0 = time.perf_counter()
    for _ in range(TRAIN_STEPS):
        state, metrics = train_step(state, {"tokens": tokens})
        losses.append(metrics["loss"])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in kernels}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    del state

    losses = [float(x) for x in losses]
    check(all(math.isfinite(x) for x in losses), f"train loss {losses}")
    check(losses[-1] < losses[0], f"train loss did not fall: {losses}")
    want = TRAIN_STEPS * config.n_layers
    for name, n in launches.items():
        check(n == want, f"{name} launched {n} times for {TRAIN_STEPS} "
                         f"steps x {config.n_layers} layers")
    tokens_per_s = batch * seq * TRAIN_STEPS / dt
    n_params = model.num_params(config)
    return dict(batch=batch, seq=seq, params=n_params, setup_s=setup_s,
                warmup_steps=TRAIN_WARMUP, steps=TRAIN_STEPS,
                step_ms=dt / TRAIN_STEPS * 1e3, tokens_per_s=tokens_per_s,
                mfu=6 * n_params * tokens_per_s / PEAK_FLOPS[torch.bfloat16],
                peak_memory_gib=peak, losses=losses,
                kernel_launches=launches)


def _check_drift(label: str, losses, recorded) -> float:
    drift = max(abs(a - b) for a, b in zip(losses, recorded))
    check(drift <= LOSS_DRIFT, f"{label} losses {losses} drift {drift} from "
                               f"{recorded}")
    return drift


def phase_train(report: dict) -> None:
    from ray_tpu_torch.models import gpt

    out = _train(gpt, gpt.CONFIGS["gpt2-small"], 24, 1024, 0)
    drift = _check_drift("gpt2-small", out["losses"], F32_FLASH_LOSSES)
    for name, n in out["kernel_launches"].items():
        report[name]["launches"] = n
    emit("train", config="gpt2-small",
         gpt2_125m_train_tokens_per_sec_per_chip=out.pop("tokens_per_s"),
         f32_flash_losses=F32_FLASH_LOSSES, max_loss_diff=drift, **out)


def phase_train_llama(report: dict) -> None:
    """llama-1b at full width and depth, remat off as in the reference
    config; the weights are drawn on the card."""
    from ray_tpu_torch.models import llama

    out = _train(llama, llama.CONFIGS["llama-1b"], 4, 2048,
                 torch.Generator(device="cuda").manual_seed(0))
    drift = _check_drift("llama-1b", out["losses"], LLAMA_1B_LOSSES)
    for name, n in out["kernel_launches"].items():
        report[name]["llama_1b"]["launches"] = n
    emit("train_llama", config="llama-1b",
         llama_1b_train_tokens_per_sec_per_chip=out.pop("tokens_per_s"),
         recorded_losses=LLAMA_1B_LOSSES, max_loss_diff=drift, **out)


# Per leaf, max |g_cuda - g_cpu| / max |g_cpu|.  Both sides compute in
# f32 (TF32 off) and sum in other orders: cuBLAS and the flash kernels on
# the card, the CPU's BLAS and the plain versions on the host, over 256
# positions and a 50304-way softmax.  2e-4 leaves room for that, while a
# wrong mask, layout or missing term moves a gradient by O(1).
GRAD_TOLERANCE = 2e-4


def _train_parity(phase: str, model, config, params, tokens,
                  label: str) -> None:
    """One train step on the card and one on the CPU from the same
    weights and tokens: the losses within 1e-4 relative, every gradient
    within GRAD_TOLERANCE of its leaf's largest."""
    from ray_tpu_torch.models._functional import adamw

    out = {}
    for device in ("cuda", "cpu"):
        init_state, train_step = model.make_train_step(config, adamw(1e-4),
                                                       device=device)
        state, metrics = train_step(init_state(params=params),
                                    {"tokens": tokens})
        grads = model._map(state["params"], lambda t: t.grad.cpu())
        out[device] = (float(metrics["loss"]), grads)
        del state
    loss_rel = abs(out["cuda"][0] - out["cpu"][0]) / abs(out["cpu"][0])
    worst, worst_leaf = 0.0, None

    def compare(a, b, path):
        nonlocal worst, worst_leaf
        for key in b:
            if isinstance(b[key], dict):
                compare(a[key], b[key], f"{path}{key}/")
                continue
            rel = float((a[key] - b[key]).abs().max()
                        / b[key].abs().max().clamp_min(1e-30))
            if rel >= worst:
                worst, worst_leaf = rel, path + key

    compare(out["cuda"][1], out["cpu"][1], "")
    emit(phase, config=label, batch=list(tokens.shape),
         loss_cuda=out["cuda"][0], loss_cpu=out["cpu"][0],
         loss_rel_err=loss_rel, max_grad_rel_err=worst,
         worst_leaf=worst_leaf, grad_tolerance=GRAD_TOLERANCE)
    check(loss_rel <= 1e-4, f"{label}: train loss CUDA {out['cuda'][0]} vs "
                            f"CPU {out['cpu'][0]}")
    check(worst <= GRAD_TOLERANCE, f"{label}: gradient {worst_leaf}: CUDA "
                                   f"vs CPU relative error {worst}")


def phase_train_parity() -> None:
    from ray_tpu_torch.models import gpt

    _f32_exact()
    config = dataclasses.replace(gpt.CONFIGS["gpt2-small"], n_layers=2,
                                 dtype=torch.float32)
    params = gpt.init_params(config, torch.Generator().manual_seed(5),
                             device="cpu")
    tokens = torch.randint(0, config.vocab_size, (2, 256),
                           generator=torch.Generator().manual_seed(6))
    _train_parity("train_parity", gpt, config, params, tokens,
                  "gpt2-small widths, 2 layers, float32")


def phase_llama_parity() -> None:
    """llama-1b widths at 2 layers in f32: greedy tokens (K4 at q_per_kv
    8 in f32 on the card) and one train step (K1-K3 over the repeated kv
    heads); then llama-tiny's greedy tokens, whose head dim 16 takes the
    masked-dense decode route on the card as in the reference."""
    from ray_tpu_torch.models import llama

    _f32_exact()
    config = dataclasses.replace(llama.CONFIGS["llama-1b"], n_layers=2,
                                 dtype=torch.float32)
    params = llama.init_params(config, torch.Generator().manual_seed(7),
                               device="cpu")
    label = "llama-1b widths, 2 layers, float32"
    _greedy_parity("llama_parity", "llama", config, params, label)
    tokens = torch.randint(0, config.vocab_size, (2, 128),
                           generator=torch.Generator().manual_seed(6))
    _train_parity("llama_train_parity", llama, config, params, tokens, label)
    tiny = llama.CONFIGS["llama-tiny"]
    _greedy_parity("llama_tiny_parity", "llama", tiny,
                   llama.init_params(tiny, torch.Generator().manual_seed(8),
                                     device="cpu"),
                   "llama-tiny (head dim 16), float32")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one",
              file=sys.stderr)
        return 1
    from ray_tpu_torch.ops import _build

    smi = smi_line()
    t0 = time.perf_counter()
    built = _build.build_all()
    emit("device", nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda, kind=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(),
         built=[p.name for p in built], build_s=time.perf_counter() - t0)
    report: dict = {}
    phases = (("kernels", phase_kernels), ("flash", phase_flash),
              ("serve", phase_serve), ("train", phase_train),
              ("parity", lambda _: phase_parity()),
              ("train_parity", lambda _: phase_train_parity()),
              ("serve_llama", phase_serve_llama),
              ("train_llama", phase_train_llama),
              ("llama_parity", lambda _: phase_llama_parity()))
    for name, phase in phases:
        t0 = time.perf_counter()
        phase(report)
        emit("wall", of=name, seconds=time.perf_counter() - t0)
    print(json.dumps({"kernels": list(report.values())}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
