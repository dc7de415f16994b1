"""The Mellum family (ray_tpu_torch/models/mellum.py) on the CPU against
the benchmark's plain reference (benchmark/references/mellum.py, loaded
by path) at the tiny preset's sizes, in float32, on weights drawn from a
seed: the whole-sequence forward; chunked prefill and decode through
`InferenceEngine("mellum", ...)` over the two pools, across the window
several times and past YaRN's original length; the dropless expert
layer; the windowed paged attention of K4 and K5 as their split
arithmetic computes it; the window pool's bound; the engine's refusals.

Tolerances (f32 on both sides, sums in other orders, the experts summed
in another order): logits within 1e-4 of the largest |logit|.  Each of
the reference's three planted faults (the window left out, plain rope on
the full layers, the top-k weights not renormalised) and its fp8 control
move the logits by far more, which the tests check too."""

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from ray_tpu_torch.inference.engine import InferenceEngine
from ray_tpu_torch.inference.kv_cache import PagedKVCache
from ray_tpu_torch.models import mellum
from ray_tpu_torch.ops import attention as A

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
SEED = 2 ** 34 + 3
TOL = 1e-4                     # of the largest |logit|


def _reference():
    spec = importlib.util.spec_from_file_location(
        "mellum_reference", ROOT / "benchmark" / "references" / "mellum.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


ref = _reference()


def _run():
    cfg = json.loads((ROOT / "benchmark" / "configs" /
                      "mellum2-12b-a2.5b-instruct.json").read_text())
    return ref.tiny_run(cfg["run"])


RUN = _run()
CONFIG = mellum.MellumConfig(**ref.program_config(RUN))


def _params():
    return ref.draw_params(RUN, SEED, "cpu")


def _tokens(n, seed=1):
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, RUN["vocab_size"], n)).long()


def _ref_logits(params, seq, precision="f32", fault=None):
    with torch.no_grad():
        return ref.logits(params, ref.hidden(params, seq, RUN, precision,
                                             fault), precision)


def _close(got, want):
    return float((got - want).abs().max()) <= TOL * float(want.abs().max())


def test_tiny_preset_is_the_reference_tiny_run():
    assert CONFIG == mellum.CONFIGS["mellum-tiny"]
    assert CONFIG.n_window_layers == 3 and CONFIG.sliding_window == 8


def test_forward_matches_the_reference():
    """Whole rows, positions 0 .. 39: five windows, past YaRN's original
    length of 16."""
    params = _params()
    seq = _tokens(40)
    want = _ref_logits(params, seq)
    with torch.no_grad():
        got = mellum.forward(params, seq[None], CONFIG)[0]
    assert _close(got, want)


@pytest.mark.parametrize("other", ["fp8", *ref.FAULTS])
def test_control_and_faults_break_the_tolerance(other):
    params = _params()
    seq = _tokens(40)
    want = _ref_logits(params, seq)
    got = (_ref_logits(params, seq, "fp8") if other == "fp8"
           else _ref_logits(params, seq, fault=other))
    assert not _close(got, want)


def test_yarn_frequencies_match_the_reference():
    """The program's YaRN inverse frequencies and factor, at the published
    widths (ramp over pairs 18..35 of 64) and the tiny preset's."""
    full = mellum.CONFIGS["mellum2-12b-a2.5b"]
    run_full = dict(RUN, head_dim=128, rope_theta=500000.0,
                    yarn_original_max_positions=8192)
    for config, run in ((full, run_full), (CONFIG, RUN)):
        freqs, factor = mellum.yarn_rope(config, "cpu")
        want, want_factor = ref.inverse_frequencies(run, ref.FULL)
        torch.testing.assert_close(freqs, want, atol=0, rtol=1e-6)
        assert factor == want_factor
    freqs, _ = mellum.yarn_rope(full, "cpu")
    theta = 500000.0 ** (-torch.arange(64, dtype=torch.float32) / 64)
    torch.testing.assert_close(freqs[:18], theta[:18], rtol=1e-6, atol=0)
    torch.testing.assert_close(freqs[36:], theta[36:] / 16, rtol=1e-6,
                               atol=0)


def _cached_logits(params, seq, chunk, block_size=4):
    """Prefill `seq` through the cached forward in chunks of `chunk`, one
    lane beside a rider, over the two pools; logits at every position."""
    cache = PagedKVCache.for_model(mellum, CONFIG, num_blocks=64,
                                   block_size=block_size, max_lanes=2,
                                   max_seq_len=128, device="cpu",
                                   prefill_chunk=chunk)
    out = []
    with torch.no_grad():
        for start in range(0, len(seq), chunk):
            n = min(chunk, len(seq) - start)
            cache.ensure_capacity(0, start + n)
            tokens = torch.zeros(2, chunk, dtype=torch.long)
            tokens[0, :n] = seq[start:start + n]
            positions = torch.zeros(2, chunk, dtype=torch.long)
            positions[0] = start + torch.arange(chunk)
            valid = torch.zeros(2, chunk, dtype=torch.bool)
            valid[0, :n] = True
            k, v = cache.pools()
            x, _, _ = mellum.forward_cached(
                params, tokens, positions, valid, k, v,
                cache.device_tables(),
                torch.tensor([start + n, 1], dtype=torch.int32), CONFIG)
            cache.seq_lens[0] += n
            out.append(mellum.lm_head(params, x[0, :n], CONFIG))
            assert cache.window.held(0) <= cache.window.lane_cap
    return torch.cat(out)


@pytest.mark.parametrize("chunk", [1, 5, 8])
def test_cached_forward_matches_the_reference(chunk):
    """Chunked prefill (chunk 1 is decode) over 45 positions: the window
    pool gives back blocks as the window passes them, and every
    position's logits equal the reference's full forward."""
    params = _params()
    seq = _tokens(45, seed=2)
    assert _close(_cached_logits(params, seq, chunk), _ref_logits(params, seq))


def test_engine_serves_what_the_reference_computes():
    """Three requests through the engine's submit/step path: prompts of
    37, 9 and 20 tokens in chunks of 6, then 24, 30 and 11 decoded
    tokens (past the YaRN original length 16 and across the window 8
    many times), greedy.  Each served token is the reference's best up
    to TOL (its gap below the best f32 logit), and every window block
    goes back to the pool."""
    params = _params()
    eng = InferenceEngine("mellum", CONFIG, params, max_lanes=2,
                          block_size=4, num_blocks=64, max_seq_len=128,
                          prefill_chunk=6, auto_start=False, device="cpu")
    prompts = [_tokens(37, 3).tolist(), _tokens(9, 4).tolist(),
               _tokens(20, 5).tolist()]
    handles = [eng.submit(p, n) for p, n in zip(prompts, (24, 30, 11))]
    w = eng.cache.window
    while eng.step():
        assert all(w.held(lane) <= w.lane_cap for lane in range(2))
    for prompt, h in zip(prompts, handles):
        served = h.tokens()
        seq = torch.tensor(prompt + served)
        want = _ref_logits(params, seq)[len(prompt) - 1:-1]
        gaps = want.amax(-1) - want.gather(-1, seq[len(prompt):, None])[:, 0]
        assert float(gaps.max()) <= TOL * float(want.abs().max()), gaps
    st = eng.stats()
    assert st["kv_window_blocks_resident"] == 0
    assert w.allocator.num_free == w.num_blocks
    assert st["kv_window_blocks_released"] > 0
    layers = CONFIG.n_layers * CONFIG.experts_per_token
    assert st["moe_routed_pairs_prefill"] == layers * (37 + 9 + 20)
    # A decode step computes the previous token: 23 + 29 + 10 of them.
    assert st["moe_routed_pairs_decode"] == layers * (23 + 29 + 10)
    assert 0 < st["moe_expert_loads_decode"] <= \
        CONFIG.n_layers * CONFIG.n_experts * st["decode_steps"]


def test_engine_reports_its_counters_to_the_observer():
    from ray_tpu_torch.util.observe import Observer

    class Counting(Observer):
        def __init__(self):
            self.values, self.gauges = {}, {}

        def inc(self, name, n=1.0):
            self.values[name] = self.values.get(name, 0.0) + n

        def set(self, name, value):
            self.gauges[name] = value

    obs = Counting()
    eng = InferenceEngine("mellum", CONFIG, _params(), max_lanes=2,
                          block_size=4, num_blocks=64, max_seq_len=128,
                          prefill_chunk=6, auto_start=False, device="cpu",
                          observer=obs)
    eng.generate(_tokens(13, 6).tolist(), 5)
    first = eng.stats()
    eng.generate(_tokens(7, 7).tolist(), 3)
    st = eng.stats()
    for kind in ("prefill", "decode"):
        for name in mellum.COUNTERS:
            key = f"{name}_{kind}"
            assert obs.values[f"inference_{key}"] == st[key] > first[key]
    assert obs.values["kv_window_blocks_released"] == \
        st["kv_window_blocks_released"] > first["kv_window_blocks_released"]
    assert obs.gauges["kv_window_blocks_resident"] == 0


def test_window_pool_bound_and_free():
    """A lane holds at most ceil((window + chunk) / block) + 1 window
    blocks at any step, the pool is max_lanes of that, and free_lane
    gives every block back."""
    cache = PagedKVCache.for_model(mellum, CONFIG, num_blocks=64,
                                   block_size=4, max_lanes=3,
                                   max_seq_len=128, device="cpu",
                                   prefill_chunk=6)
    w = cache.window
    assert w.lane_cap == -(-(8 + 6) // 4) + 1 == 5
    assert w.num_blocks == 15 and cache.k.shape[0] == 1
    assert w.k.shape[:2] == (3, 15)
    assert not cache.prefix_cache_enabled
    most = 0
    for lane, total in ((0, 70), (1, 41)):
        n = 0
        while n < total:
            step = min(6 if n < 30 else 1, total - n)
            cache.ensure_capacity(lane, n + step)
            most = max(most, w.held(lane))
            # The blocks held cover the window of the step's first query.
            held = set(np.flatnonzero(w.block_tables[lane]).tolist())
            assert held <= set(range(max(n - 7, 0) // 4,
                                     -(-(n + step) // 4)))
            cache.seq_lens[lane] += step
            n += step
    assert w.lane_cap - 1 <= most <= w.lane_cap
    before = w.released
    cache.free_lane(0)
    cache.free_lane(1)
    assert w.allocator.num_free == w.num_blocks and w.resident == 0
    assert w.released > before and not w.block_tables.any()


def test_engine_refuses_speculation_and_the_spill_tier():
    params = _params()
    with pytest.raises(ValueError, match="spec_k"):
        InferenceEngine("mellum", CONFIG, params, spec_k=2, device="cpu")
    with pytest.raises(ValueError, match="kv_tier"):
        InferenceEngine("mellum", CONFIG, params, kv_tier=True,
                        device="cpu")


# ---------------------------------------------------------- expert layer

def _layer(seed=5):
    g = torch.Generator().manual_seed(seed)
    e, d, f = CONFIG.n_experts, CONFIG.d_model, CONFIG.d_expert
    return {"router": torch.randn(d, e, generator=g) * 0.3,
            "w_gate": torch.randn(e, d, f, generator=g) * 0.2,
            "w_up": torch.randn(e, d, f, generator=g) * 0.2,
            "w_down": torch.randn(e, f, d, generator=g) * 0.2}


def _swiglu(h, p, ex):
    return (torch.nn.functional.silu(h @ p["w_gate"][ex])
            * (h @ p["w_up"][ex])) @ p["w_down"][ex]


def test_experts_drop_no_token_when_all_pick_one():
    """A router that sends every token to experts 0 and 1: no capacity,
    no token dropped, each token the weighted sum of both, the weights
    its renormalised softmax."""
    p = _layer()
    p["router"] = torch.zeros_like(p["router"])
    p["router"][:, 0], p["router"][:, 1] = 50.0, 49.0
    h = torch.randn(64, CONFIG.d_model, generator=torch.Generator()
                    .manual_seed(1)).abs() + 0.1
    got = mellum.moe(h, p, CONFIG)
    probs = torch.softmax(h @ p["router"], -1)[:, :2]
    gate = probs / probs.sum(-1, keepdim=True)
    want = gate[:, :1] * _swiglu(h, p, 0) + gate[:, 1:] * _swiglu(h, p, 1)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


def test_expert_gates_sum_to_one():
    """With every expert the same, the renormalised top-k weights sum to
    1, so the layer is that one expert."""
    p = _layer()
    for name in ("w_gate", "w_up", "w_down"):
        p[name] = p[name][:1].expand_as(p[name]).clone()
    h = torch.randn(32, CONFIG.d_model)
    torch.testing.assert_close(mellum.moe(h, p, CONFIG), _swiglu(h, p, 0),
                               atol=1e-5, rtol=1e-5)


def test_masked_slots_get_no_expert_work():
    p = _layer()
    h = torch.randn(40, CONFIG.d_model)
    valid = torch.arange(40) % 3 == 0
    counts = torch.zeros(2, dtype=torch.int64)
    got = mellum.moe(h, p, CONFIG, valid, counts)
    assert not got[~valid].any()
    torch.testing.assert_close(got[valid], mellum.moe(h[valid], p, CONFIG))
    assert int(counts[0]) == int(valid.sum()) * CONFIG.experts_per_token
    assert 0 < int(counts[1]) <= CONFIG.n_experts


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_grouped_experts_equal_the_loop(dtype):
    """The device path's arithmetic (pairs sorted by expert, offsets, one
    grouped product per projection, the tail past the last offset
    zeroed, each token's outputs summed by a batched product) against the
    plain loop, on the CPU where torch's grouped product also runs: the
    same within f32 rounding, or in bf16 an ulp of an intermediate and
    of the weights."""
    p = {k: v.to(dtype) for k, v in _layer(7).items()}
    h = torch.randn(48, CONFIG.d_model).to(dtype)
    valid = torch.arange(48) % 4 != 1
    probs = torch.softmax(h.float() @ p["router"].float(), -1)
    weight, expert = probs.topk(CONFIG.experts_per_token, -1)
    expert = torch.where(valid[:, None], expert, CONFIG.n_experts)
    got, per = mellum._grouped_experts(h, p, expert, weight,
                                       CONFIG.n_experts)
    want, per_loop = mellum._looped_experts(h, p, expert, weight,
                                            CONFIG.n_experts)
    assert torch.equal(per, per_loop)
    tol = 1e-5 if dtype == torch.float32 else 2 ** -6
    torch.testing.assert_close(got.float(), want,
                               atol=tol * float(want.abs().max()), rtol=tol)
    assert not got[~valid].any()


# ------------------------------------------------ windowed K4 and K5

def _split_attention(q, k_pool, v_pool, tables, ctx_lens, q_positions,
                     window, split_len, n_splits):
    """K4's and K5's windowed split arithmetic, written out in f32: a
    lane's splits start at its window base (its first query's first
    visible key, rounded down to a split), each split a partial (m, l,
    acc) of the keys each row sees in it, then the merge by LSE weight of
    the splits a row reaches.  Keys past the launched splits are never
    read."""
    b, t, h, d = q.shape
    _, bs, kh, _ = k_pool.shape
    width = tables.shape[1] * bs
    out = torch.zeros(b, t, h, d)
    for lane in range(b):
        ctx = torch.from_numpy(np.concatenate([
            np.arange(width), np.full(n_splits * split_len, width)]))
        base = max(int(q_positions[lane, 0]) - window + 1, 0) \
            // split_len * split_len
        keys = torch.arange(base, base + n_splits * split_len)
        inside = keys < width
        rows = tables[lane].long()[keys.clamp(max=width - 1) // bs] * bs \
            + keys % bs
        kc = k_pool.reshape(-1, kh, d)[rows].repeat_interleave(h // kh, 1)
        vc = v_pool.reshape(-1, kh, d)[rows].repeat_interleave(h // kh, 1)
        s = torch.einsum("thd,khd->thk", q[lane], kc) * d ** -0.5
        qp = q_positions[lane][:, None, None]
        lim = torch.minimum(torch.as_tensor(int(ctx_lens[lane])), qp + 1)
        vis = inside & (keys < lim) & (keys > qp - window)
        s = s.masked_fill(~vis, -float("inf")).view(t, h, n_splits,
                                                     split_len)
        m = s.amax(-1)
        pr = torch.exp(s - torch.where(m == -float("inf"), 0, m)[..., None])
        acc = torch.einsum("thsl,slhd->thsd", pr,
                           vc.view(n_splits, split_len, h, d))
        mx = m.amax(-1, keepdim=True)
        wgt = torch.exp(m - torch.where(mx == -float("inf"), 0, mx))
        l_sum = (wgt * pr.sum(-1)).sum(-1)
        out[lane] = (wgt[..., None] * acc).sum(-2) \
            / l_sum.clamp_min(1e-30)[..., None]
        del ctx
    return out


def _window_case(seed, *, b, t, kh, q_per_kv, d, bs, mb):
    rng = np.random.default_rng(seed)
    nb = b * mb + 3
    f32 = lambda *s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s).astype(np.float32))
    tables = torch.from_numpy(rng.permutation(nb)[:b * mb].reshape(
        b, mb).astype(np.int32))
    return f32(b, t, kh * q_per_kv, d), f32(nb, bs, kh, d), \
        f32(nb, bs, kh, d), tables


@pytest.mark.parametrize("window", [5, 16, 40])
def test_windowed_decode_split_matches_the_dense_reference(window):
    """K4 with a window: the query at ctx_len - 1 reads the last `window`
    positions, through ceil((window + S - 1) / S) splits from its base."""
    q, kp, vp, tables = _window_case(11, b=6, t=1, kh=2, q_per_kv=4, d=16,
                                     bs=4, mb=32)
    ctx = torch.tensor([1, window, window + 1, 37, 100, 128],
                       dtype=torch.int32)
    split_len = 16
    n = min(-(-128 // split_len), -(-(window + split_len - 1) // split_len))
    got = _split_attention(q, kp, vp, tables, ctx, (ctx - 1)[:, None].long(),
                           window, split_len, n)
    want = A.paged_attention_reference(q, kp, vp, tables, ctx,
                                       (ctx - 1)[:, None].long(),
                                       window=window)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    plain = A.paged_decode_attention(q[:, 0], kp, vp, tables, ctx,
                                     window=window)
    torch.testing.assert_close(plain, want[:, 0], atol=0, rtol=0)
    # Without the window the same lanes read more than the window.
    wide = A.paged_attention_reference(q, kp, vp, tables, ctx,
                                       (ctx - 1)[:, None].long())
    assert not torch.allclose(wide[3:], want[3:], atol=1e-3)


@pytest.mark.parametrize("window,t", [(8, 6), (20, 9), (40, 3)])
def test_windowed_prefill_split_matches_the_dense_reference(window, t):
    """K5 with a window: a lane's chunk of t queries at ascending
    positions reads from its first query's window on, through
    ceil((window + S + t - 2) / S) splits; rows past ctx_len see the
    context's end, as in the engine's last chunk."""
    q, kp, vp, tables = _window_case(12, b=5, t=t, kh=2, q_per_kv=2, d=16,
                                     bs=4, mb=32)
    ctx = torch.tensor([t, 30, 77, 128, 1], dtype=torch.int32)
    pos = (ctx.long() - t).clamp(min=0)[:, None] + torch.arange(t)
    split_len = 16
    n = A.prefill_splits(32, 4, split_len, window=window, q_len=t)
    assert n == min(8, -(-(window + split_len + t - 2) // split_len))
    got = _split_attention(q, kp, vp, tables, ctx, pos, window, split_len, n)
    want = A.paged_attention_reference(q, kp, vp, tables, ctx, pos,
                                       window=window)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    plain = A.paged_prefill_attention(q, kp, vp, tables, ctx, pos,
                                      window=window)
    torch.testing.assert_close(plain, want, atol=0, rtol=0)


def test_window_reference_is_dense_windowed_attention():
    """The masked-dense path with a window against attention over the
    contiguous context: query i sees keys i - window < j <= i."""
    q, kp, vp, tables = _window_case(13, b=1, t=20, kh=2, q_per_kv=2, d=16,
                                     bs=4, mb=8)
    ctx = torch.tensor([20], dtype=torch.int32)
    pos = torch.arange(20)[None]
    got = A.paged_attention_reference(q, kp, vp, tables, ctx, pos, window=7)
    rows = (tables[0].long()[:, None] * 4 + torch.arange(4)).reshape(-1)[:20]
    k = kp.reshape(-1, 2, 16)[rows].repeat_interleave(2, 1)
    v = vp.reshape(-1, 2, 16)[rows].repeat_interleave(2, 1)
    s = torch.einsum("thd,khd->htk", q[0], k) / 4.0
    i, j = torch.arange(20)[:, None], torch.arange(20)[None]
    s = s.masked_fill(~((j <= i) & (j > i - 7)), -float("inf"))
    want = torch.einsum("htk,khd->thd", torch.softmax(s, -1), v)
    torch.testing.assert_close(got[0], want, atol=1e-5, rtol=1e-5)


def test_windowed_split_counts():
    """K4's and K5's windowed launches count their splits from the
    window, never from ctx_lens: at Mellum's window of 1024 and its
    32768-position table, K4 runs 9 splits of 128 where it runs 256
    without the window, and K5 at its chunk of 240 runs 4 of 512 where
    it runs 64."""
    assert A.decode_splits(2048, 16) == 256
    assert A.decode_splits(2048, 16, 1024) == 9
    assert A.decode_splits(4, 16, 1024) == 1
    assert A.prefill_splits(2048, 16) == 64
    assert A.prefill_splits(2048, 16, window=1024, q_len=240) == 4
    assert A.prefill_splits(2, 16, window=1024, q_len=240) == 1


def test_window_argument_is_checked():
    q, kp, vp, tables = _window_case(14, b=1, t=1, kh=2, q_per_kv=2, d=16,
                                     bs=4, mb=8)
    ctx = torch.tensor([9], dtype=torch.int32)
    for bad in (0, -3, 2.5):
        with pytest.raises(ValueError, match="window"):
            A.paged_decode_attention(q[:, 0], kp, vp, tables, ctx,
                                     window=bad)
