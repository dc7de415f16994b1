"""Plain PyTorch reference of the Mellum 2 architecture in float32, and
the Mellum family's side of the benchmark's family contract (the module
docstring of `benchmark/harness.py`): the program's configuration
fields, the weights' layout, the CPU tests' sizes, the served tokens'
gaps, and the FLOP and byte counts that the Mellum cell's readers use.
It serves only: `train_readings` and `train_flops` raise.

The block, as the published config describes it (`model_type` mellum):
RMSNorm (eps `norm_eps`); grouped-query attention, `n_heads` query
heads of `head_dim` over `n_kv_heads` kv heads (query head h reads kv
head h // (n_heads / n_kv_heads)), no bias, softmax over q.k /
sqrt(head_dim); on a window layer query i sees key j iff i -
sliding_window < j <= i and q, k rotate by the default rope (rotate-half
pairs, frequencies theta^(-i / half)); on a full layer every j <= i and
YaRN (transformers' `_compute_yarn_parameters`, `truncate` on: theta's
frequencies below the ramp of pairs [floor(d(beta_fast)),
ceil(d(beta_slow))], theta's / factor above it, a linear blend on it,
cos and sin times the attention factor); a residual; RMSNorm; the
router [d_model -> n_experts] and its softmax, the top
`experts_per_token` weights renormalised to sum to 1
(`norm_topk_prob`), each chosen expert a SwiGLU (silu(h W_gate) * (h
W_up) W_down) of width d_expert, summed by weight; a residual; a final
RMSNorm and an untied head.  Angles are pos x inverse frequency in f32,
as transformers computes them.

Everything is computed in float32 with TF32 off, over the whole
sequence with no cache: attention in blocks of `QUERY_BLOCK` queries
over the keys they see (so a sequence of 29k positions fits on the card
beside the weights), the experts in a plain loop.  The weights are held
as drawn (bf16 for a served run: the values the program is given) and
each is taken to f32 where it is used.  It imports nothing of the
program.

`precision="fp8"` is the control: every matrix product (the four
projections, Q.K and P.V, the router, the experts' three, the head)
takes its operands rounded to float8 e4m3 under a per-tensor scale, the
rest f32.  `fault=` plants one of `FAULTS` in the forward (the window
left out on the window layers, plain rope on the full layers in place
of YaRN, the top-k weights not renormalised), for the check's proof.

Weights: every matrix and table N(0, 0.02) (the usual
initializer_range; the config gives none; `init_std` in the run block
where set), norm scales 1, in the layout of the port's Mellum family
(layers stacked, experts next).
"""

from __future__ import annotations

import math
from typing import Callable, List, Optional

import torch
import torch.nn.functional as F

from benchmark import weights
from benchmark.flops import (DTYPE_BYTES, HBM_BYTES_PER_S, PEAK_FLOPS,
                             decode_bound)
from benchmark.train_reference import configure

FP8_MAX = 448.0
WINDOW, FULL = "sliding_attention", "full_attention"
QUERY_BLOCK = 512
FAULTS = ("no_window", "plain_rope", "unnormalised")

# The CPU tests' sizes.  At these widths N(0, 0.02) leaves attention
# nearly uniform and the logits nearly flat, so that no fault moves a
# served token; N(0, 0.2) gives them the spread the published widths
# give N(0, 0.02).  And f32, so that the check reads the program's
# arithmetic and not bf16's rounding on the CPU.
TINY = dict(vocab_size=512, n_layers=4, d_model=64, n_heads=4,
            n_kv_heads=2, head_dim=16, n_experts=8, experts_per_token=2,
            d_expert=32, max_seq_len=256,
            layer_types=[WINDOW, WINDOW, WINDOW, FULL], sliding_window=8,
            rope_theta=10000.0, yarn_original_max_positions=16,
            init_std=0.2, dtype="float32")

PROGRAM_FIELDS = ("vocab_size", "n_layers", "d_model", "n_heads",
                  "n_kv_heads", "head_dim", "n_experts", "experts_per_token",
                  "d_expert", "max_seq_len", "sliding_window", "rope_theta",
                  "yarn_factor", "yarn_original_max_positions",
                  "yarn_beta_fast", "yarn_beta_slow",
                  "yarn_attention_factor", "norm_eps", "norm_topk_prob")

MATMUL_LEAVES = ("tok_embed", "blocks/wq", "blocks/wk", "blocks/wv",
                 "blocks/wo", "blocks/router", "blocks/w_gate",
                 "blocks/w_up", "blocks/w_down", "lm_head")


def program_config(run: dict, **overrides) -> dict:
    """The fields of the port's Mellum configuration for a
    configuration file's `run` block, as run."""
    return dict({k: run[k] for k in PROGRAM_FIELDS},
                layer_types=tuple(run["layer_types"]),
                dtype=getattr(torch, run["dtype"]), **overrides)


def tiny_run(run: dict) -> dict:
    """`run` at the CPU tests' sizes: one period of the layer pattern, a
    window of 8 and a YaRN original length of 16."""
    return dict(run, **TINY)


def leaf_specs(run: dict) -> weights.LeafSpecs:
    """{path: (shape, std)}, in the draw order; norm scales (std None)
    are ones."""
    n, d, h, kh, dh = (run["n_layers"], run["d_model"], run["n_heads"],
                       run["n_kv_heads"], run["head_dim"])
    e, f, std = run["n_experts"], run["d_expert"], run.get("init_std", 0.02)
    return {
        "tok_embed": ((run["vocab_size"], d), std),
        "blocks/attn_norm": ((n, d), None),
        "blocks/wq": ((n, d, h, dh), std), "blocks/wk": ((n, d, kh, dh), std),
        "blocks/wv": ((n, d, kh, dh), std), "blocks/wo": ((n, h, dh, d), std),
        "blocks/mlp_norm": ((n, d), None),
        "blocks/router": ((n, d, e), std),
        "blocks/w_gate": ((n, e, d, f), std), "blocks/w_up": ((n, e, d, f), std),
        "blocks/w_down": ((n, e, f, d), std),
        "final_norm": ((d,), None),
        "lm_head": ((d, run["vocab_size"]), std),
    }


NORMS = ("blocks/attn_norm", "blocks/mlp_norm", "final_norm")


def draw_params(run: dict, seed: int, device, matmul_dtype=torch.float32,
                keep: Optional[Callable] = None) -> dict:
    """The run's weights drawn from the seed (`weights.draw_params`):
    matrices and tables in `matmul_dtype`, norm scales f32 ones."""
    def ones(path, t):
        if path in NORMS:
            t.fill_(1.0)
        return t if keep is None else keep(path, t)
    return weights.draw_params(leaf_specs(run), MATMUL_LEAVES, seed, device,
                               matmul_dtype=matmul_dtype, keep=ones)


def train_readings(run, seed, batches, hp, device, **how):
    raise NotImplementedError("the Mellum family has no training cell")


def train_flops(run, rows, length):
    raise NotImplementedError("the Mellum family has no training cell")


# The forward.

def _fp8(x: torch.Tensor) -> torch.Tensor:
    scale = x.abs().amax().clamp_min(1e-30) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


def _mm(a, b, precision: str):
    if precision == "fp8":
        a, b = _fp8(a), _fp8(b)
    return a @ b


def _rms(x, scale, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def inverse_frequencies(run: dict, kind: str, fault=None):
    """(inverse frequencies [head_dim / 2] f32, cos/sin factor) of a
    layer of `kind`."""
    dim, theta = run["head_dim"], float(run["rope_theta"])
    pos_freqs = theta ** (torch.arange(0, dim, 2, dtype=torch.float32) / dim)
    if kind == WINDOW or fault == "plain_rope":
        return 1.0 / pos_freqs, 1.0
    factor = float(run["yarn_factor"])
    original = run["yarn_original_max_positions"]

    def correction(rotations):
        return (dim * math.log(original / (rotations * 2 * math.pi))
                / (2 * math.log(theta)))

    low = max(math.floor(correction(run["yarn_beta_fast"])), 0)
    high = min(math.ceil(correction(run["yarn_beta_slow"])), dim - 1)
    if low == high:
        high += 0.001
    ramp = ((torch.arange(dim // 2, dtype=torch.float32) - low)
            / (high - low)).clamp(0, 1)
    extrapolation = 1.0 - ramp
    inv = (1.0 / (factor * pos_freqs)) * (1 - extrapolation) \
        + (1.0 / pos_freqs) * extrapolation
    return inv, float(run["yarn_attention_factor"])


def _rotate(x, inv, factor):
    """x [L, heads, dim] at positions 0 .. L-1, rotate-half pairs."""
    l, half = x.shape[0], x.shape[-1] // 2
    ang = torch.arange(l, dtype=torch.float32, device=x.device)[:, None] \
        * inv.to(x.device)[None]
    cos = (torch.cos(ang) * factor)[:, None]
    sin = (torch.sin(ang) * factor)[:, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _attention(q, k, v, window: Optional[int], precision: str):
    """q [L, H, dh], k/v [L, KH, dh]: causal (and windowed) attention, in
    blocks of QUERY_BLOCK queries over the keys each block sees."""
    l, h, dh = q.shape
    rep = h // k.shape[1]
    out = torch.empty_like(q)
    for s in range(0, l, QUERY_BLOCK):
        e = min(s + QUERY_BLOCK, l)
        lo = 0 if window is None else max(s - window + 1, 0)
        kb = k[lo:e].repeat_interleave(rep, dim=1).transpose(0, 1)
        vb = v[lo:e].repeat_interleave(rep, dim=1).transpose(0, 1)
        qb = q[s:e].transpose(0, 1)                            # [H, q, dh]
        scores = _mm(qb, kb.transpose(-1, -2), precision) / math.sqrt(dh)
        i = torch.arange(s, e, device=q.device)[:, None]
        j = torch.arange(lo, e, device=q.device)[None]
        mask = j <= i
        if window is not None:
            mask &= j > i - window
        scores = scores.masked_fill(~mask, float("-inf"))
        out[s:e] = _mm(torch.softmax(scores, -1), vb,
                       precision).transpose(0, 1)
    return out


def _experts(h, p, run, precision, fault):
    """The routed expert layer on h [L, D], the experts in a loop."""
    probs = torch.softmax(_mm(h, p["router"].float(), precision), dim=-1)
    weight, expert = probs.topk(run["experts_per_token"], dim=-1)
    if run["norm_topk_prob"] and fault != "unnormalised":
        weight = weight / weight.sum(-1, keepdim=True)
    out = torch.zeros_like(h)
    for ex in range(run["n_experts"]):
        tok, slot = (expert == ex).nonzero(as_tuple=True)
        if tok.numel() == 0:
            continue
        x = h[tok]
        u = F.silu(_mm(x, p["w_gate"][ex].float(), precision)) \
            * _mm(x, p["w_up"][ex].float(), precision)
        y = _mm(u, p["w_down"][ex].float(), precision)
        out.index_add_(0, tok, y * weight[tok, slot, None])
    return out


def hidden(params: dict, tokens: torch.Tensor, run: dict,
           precision: str = "f32", fault=None) -> torch.Tensor:
    """tokens [L] (one sequence from position 0) -> final-normed hidden
    states [L, D] f32."""
    eps = run["norm_eps"]
    d, h, kh, dh = (run["d_model"], run["n_heads"], run["n_kv_heads"],
                    run["head_dim"])
    blocks = params["blocks"]
    x = params["tok_embed"][tokens].float()
    l = x.shape[0]
    for i, kind in enumerate(run["layer_types"]):
        p = {k: v[i] for k, v in blocks.items()}
        a = _rms(x, p["attn_norm"].float(), eps)
        q = _mm(a, p["wq"].float().reshape(d, h * dh), precision)
        k = _mm(a, p["wk"].float().reshape(d, kh * dh), precision)
        v = _mm(a, p["wv"].float().reshape(d, kh * dh), precision)
        inv, factor = inverse_frequencies(run, kind, fault)
        q = _rotate(q.view(l, h, dh), inv, factor)
        k = _rotate(k.view(l, kh, dh), inv, factor)
        window = (run["sliding_window"]
                  if kind == WINDOW and fault != "no_window" else None)
        att = _attention(q, k, v.view(l, kh, dh), window, precision)
        x = x + _mm(att.reshape(l, h * dh),
                    p["wo"].float().reshape(h * dh, d), precision)
        x = x + _experts(_rms(x, p["mlp_norm"].float(), eps), p, run,
                         precision, fault)
    return _rms(x, params["final_norm"].float(), eps)


def logits(params: dict, x: torch.Tensor, precision: str = "f32"):
    return _mm(x, params["lm_head"].float(), precision)


def served_gaps(run: dict, seed: int, sequences: List[tuple], device,
                precision: str = "f32") -> List[float]:
    """For each (prompt, served tokens): the f32 reference runs once over
    prompt + served tokens, and each served token's gap is the f32 best
    logit at its position minus the f32 logit of the token.  With
    precision "fp8" the token read is the one that the fp8 forward puts
    first at that position (the control), and with a name in `FAULTS`
    the one that the forward with that fault puts first.  Returns the
    gaps of all served positions."""
    configure()
    params = draw_params(run, seed, device, matmul_dtype=torch.bfloat16)
    gaps: List[float] = []
    with torch.no_grad():
        for prompt, served in sequences:
            seq = torch.tensor(list(prompt) + list(served), dtype=torch.int64,
                               device=device)
            n, start = len(served), len(prompt) - 1
            ref = logits(params, hidden(params, seq, run)[start:start + n])
            if precision == "f32":
                tok = torch.tensor(served, dtype=torch.int64, device=device)
            else:
                fp8 = precision == "fp8"
                low = logits(params, hidden(
                    params, seq, run, "fp8" if fp8 else "f32",
                    None if fp8 else precision)[start:start + n],
                    "fp8" if fp8 else "f32")
                tok = low.argmax(-1)
            gap = ref.amax(-1) - ref.gather(-1, tok[:, None])[:, 0]
            gaps.extend(gap.tolist())
    return gaps


# The yardstick's counts for the Mellum cell's readers.

def _attn_ctx(run: dict, kind: str, position: int) -> int:
    ctx = position + 1
    return min(ctx, run["sliding_window"]) if kind == WINDOW else ctx


def _block_flops(run: dict) -> int:
    """A token's products in one layer, attention over its context left
    out: the four projections, the router and its experts' SwiGLU."""
    d, h, kh, dh = (run["d_model"], run["n_heads"], run["n_kv_heads"],
                    run["head_dim"])
    proj = 2 * d * (h * dh + 2 * kh * dh) + 2 * h * dh * d
    return proj + 2 * d * run["n_experts"] \
        + run["experts_per_token"] * 3 * 2 * d * run["d_expert"]


def token_flops(run: dict, position: int, head: bool) -> float:
    """Forward FLOPs of one token at 0-based `position` in a served
    sequence: every layer's products, attention's Q.K and P.V over its
    position + 1 keys on a full layer and at most `sliding_window` on a
    window layer (4 x heads x head_dim a key), and the head when the
    token's logits are computed."""
    per_key = 4 * run["n_heads"] * run["head_dim"]
    attn = sum(_attn_ctx(run, kind, position) for kind in run["layer_types"])
    return float(run["n_layers"] * _block_flops(run) + per_key * attn
                 + (2 * run["d_model"] * run["vocab_size"] if head else 0))


def prompt_flops(run: dict, n: int) -> float:
    """Forward FLOPs of a prompt of n tokens, its last one sampled."""
    w = run["sliding_window"]
    per_key = 4 * run["n_heads"] * run["head_dim"]
    full_keys = n * (n + 1) // 2
    m = min(n, w)
    window_keys = m * (m + 1) // 2 + (n - m) * w
    keys = sum(full_keys if kind == FULL else window_keys
               for kind in run["layer_types"])
    return float(n * run["n_layers"] * _block_flops(run) + per_key * keys
                 + 2 * run["d_model"] * run["vocab_size"])


def expert_bound(run: dict, pairs: float, loads: float) -> float:
    """Least seconds of the expert layer's grouped products over `pairs`
    routed (token, expert) pairs and `loads` expert weight loads (an
    expert with a token in a dispatch, once a layer), on an H100 in
    bf16: each loaded expert's three matrices read once, each product's
    input read once and its output written once (gate and up: x in,
    d_expert out; down: d_expert in, x out), or 2 FLOPs per
    multiply-add of the three products, whichever is longer."""
    d, f, sz = run["d_model"], run["d_expert"], DTYPE_BYTES["bfloat16"]
    nbytes = loads * 3 * d * f * sz + pairs * 3 * (d + f) * sz
    flops = pairs * 3 * 2 * d * f
    return max(nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS["bfloat16"])


def window_decode_bound(run: dict, ctx_lens: List[int],
                        block_size: int) -> float:
    """Least seconds of the window layers' K4 calls of one decode step
    over lanes with contexts `ctx_lens`: each reads min(ctx, window)
    positions (`flops.decode_bound`), once a window layer."""
    w = run["sliding_window"]
    n_window = sum(kind == WINDOW for kind in run["layer_types"])
    return n_window * decode_bound([min(c, w) for c in ctx_lens],
                                   run["n_heads"], run["n_kv_heads"],
                                   run["head_dim"], block_size,
                                   run["dtype"])
