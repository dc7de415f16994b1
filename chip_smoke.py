#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (ray_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py                     # one card

It runs every phase, each printing one JSON line; any failure ends the
run with a nonzero exit code and no result line:

  device   the card (nvidia-smi name and power limit), torch/CUDA versions,
           then every kernel of the port built from csrc/ with nvcc.
  kernels  each kernel against its plain PyTorch version on the same
           inputs at the serving path's shapes (gpt2-small decode: 32
           lanes, 12 heads of 64, block 16, ragged contexts up to 1024;
           bf16 and f32) and a GQA shape, then timed with CUDA events
           (median over launches, L2 flushed before each) beside its
           bound, its plain version and one PyTorch library call.
  serve    the main path: InferenceEngine("gpt", "gpt2-small") at full
           width, random bf16 weights from a seed, 32 lanes, answering 24
           streamed requests (greedy and seeded, a shared prefix).  The
           kernel launch counts are set to 0 just before and read just
           after; the decode kernel must have run once per layer per
           decode step.
  parity   gpt2-small in float32: the same greedy requests through the
           engine on the card and on the CPU must give the same tokens.

Then, on lines of their own: the kernels' JSON record, the card's name
and power limit, and last {"ok": true, "device": {...}}.  Exits nonzero
without a card, and when the ray_tpu_torch package is not beside it.
"""

from __future__ import annotations

import dataclasses
import json
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


def _time_ms(fn, reps: int = 40) -> float:
    """Median device time of one call, L2 flushed before each."""
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(reps):
        flush.zero_()
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
        "gqa4-d128-bf16": dict(b=16, kh=8, q_per_kv=4, d=128, bs=16,
                               max_ctx=1024, dtype=torch.bfloat16),
        # 50 KB of shared memory: the opt-in above 48 KB.
        "gqa8-d256-f32": dict(b=4, kh=2, q_per_kv=8, d=256, bs=32,
                              max_ctx=256, dtype=torch.float32),
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
            plain_ms=_time_ms(lambda: A.paged_decode_attention_plain(**c)),
            library_ms=_time_ms(lambda: F.scaled_dot_product_attention(
                sdpa[0], sdpa[1], sdpa[2], attn_mask=sdpa[3])),
            bound_ms=bound_ms, bound_by=bound_by,
            ctx_tokens=int(c["ctx_lens"].long().sum()))
    emit("kernels", cases=results)
    main = results["gpt2-small-bf16"]
    report["paged_decode_attention"] = dict(
        name="paged_decode_attention", route="cuda",
        source="ray_tpu_torch/ops/csrc/paged_decode.cu",
        replaces="ray_tpu/ops/attention.py:291",
        max_abs_err=main["max_abs_err"], ms=main["ms"],
        plain_ms=main["plain_ms"], bound_ms=main["bound_ms"],
        bound_by=main["bound_by"], library_ms=main["library_ms"])


# ------------------------------------------------------------------ serve

def _serve_requests(rng_seed: int = 0):
    import numpy as np

    rng = np.random.default_rng(rng_seed)
    shared = rng.integers(0, 50304, 64).tolist()           # four blocks

    def req(prompt, i):
        kw = dict(max_new_tokens=int(rng.integers(32, 65)))
        if i % 2:
            kw.update(temperature=0.8, seed=1000 + i)
        if i % 7 == 3:
            kw.update(eos_id=int(rng.integers(0, 50304)))
        return prompt, kw

    first = [req(shared + rng.integers(0, 50304, 8).tolist(), 0)]
    first += [req(rng.integers(0, 50304, int(rng.integers(16, 161))).tolist(),
                  i) for i in range(1, 16)]
    second = [req(shared + rng.integers(0, 50304,
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


def phase_serve(report: dict) -> None:
    from ray_tpu_torch.inference import InferenceEngine
    from ray_tpu_torch.ops import attention as A

    n_layers = 12
    t0 = time.perf_counter()
    eng = InferenceEngine("gpt", "gpt2-small", device="cuda", seed=1234,
                          max_lanes=32, block_size=16)
    try:
        setup_s = time.perf_counter() - t0
        eng.generate(list(range(40)), max_new_tokens=4)         # warm-up
        torch.cuda.synchronize()
        before = eng.stats()
        first, second = _serve_requests()

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
        check(all(0 <= t < 50304 for t in c.tokens), "token out of range")
    check(launches == decode_steps * n_layers,
          f"decode kernel launched {launches} times for {decode_steps} "
          f"decode steps x {n_layers} layers")
    check(launches > 0, "the decode kernel never ran")
    check(hits >= 1, "no prefix-cache hit")
    generated = sum(len(c.tokens) for _, c in streams)
    ttfts = sorted(c.ttft for _, c in streams)
    decode_tokens = generated - len(streams)     # first tokens: prefill
    report["paged_decode_attention"]["launches"] = launches
    emit("serve", requests=len(streams), generated_tokens=generated,
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


# ----------------------------------------------------------------- parity

def phase_parity() -> None:
    from ray_tpu_torch.inference import InferenceEngine
    from ray_tpu_torch.models import gpt

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    config = dataclasses.replace(gpt.CONFIGS["gpt2-small"],
                                 dtype=torch.float32)
    params = gpt.init_params(config, torch.Generator().manual_seed(7),
                             device="cpu")
    prompts = [[(37 * i + 11 * j) % 50304 for j in range(n)]
               for i, n in enumerate((5, 17, 33, 48))]
    outs = {}
    for device in ("cuda", "cpu"):
        eng = InferenceEngine("gpt", config, params=params, device=device,
                              max_lanes=4, block_size=16, max_seq_len=128,
                              auto_start=False)
        handles = [eng.submit(p, max_new_tokens=16) for p in prompts]
        while eng.step():
            pass
        outs[device] = [h.tokens(timeout=60) for h in handles]
    same = outs["cuda"] == outs["cpu"]
    emit("parity", config="gpt2-small float32", requests=len(prompts),
         new_tokens=16, tokens_equal=same,
         mismatched=[i for i, (a, b) in enumerate(zip(outs["cuda"],
                                                      outs["cpu"]))
                     if a != b])
    check(same, "CUDA and CPU greedy tokens differ")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one",
              file=sys.stderr)
        return 1
    from ray_tpu_torch.ops import _build

    smi = smi_line()
    t0 = time.perf_counter()
    _build.build("paged_decode")
    emit("device", nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda, kind=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(),
         build_s=time.perf_counter() - t0)
    report: dict = {}
    phase_kernels(report)
    phase_serve(report)
    phase_parity()
    print(json.dumps({"kernels": list(report.values())}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
