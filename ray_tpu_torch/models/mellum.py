"""Mellum model family: a decoder whose layers mix sliding-window and
full attention, with a routed expert layer in every block (JetBrains'
Mellum 2, `model_type` "mellum"); the forward over whole sequences and
the cached forward of the serving path.  It has no counterpart in the
JAX package and no train step.

Each block, in the idiom of models/llama.py (whose RMSNorm, projections
and rotary embedding it reuses):

- pre-RMSNorm, then grouped-query attention (`n_heads` query heads over
  `n_kv_heads` kv heads of `head_dim`, no bias).  A window layer
  ("sliding" in `layer_types`) rotates q and k by the default rope at
  `rope_theta`, and query i sees key j iff i - sliding_window < j <= i.
  A full layer sees every j <= i and rotates by YaRN (`yarn_rope`):
  frequencies blended between theta's and theta's / `yarn_factor` over
  a ramp of pairs, cos and sin multiplied by `yarn_attention_factor`.
- post-attention RMSNorm, then the expert layer (`moe`): a router
  [d_model -> n_experts] in f32, softmax, the top `experts_per_token`
  with their weights renormalised to sum to 1, each chosen expert a
  SwiGLU d_model -> d_expert -> d_model, the outputs summed by weight.
  It is dropless: there is no capacity, every token reaches its experts.
- a final RMSNorm and an untied head.

Params are a nested dict with the layers stacked on a leading dim, the
experts on the next (`w_gate/w_up [n, E, d, f]`, `w_down [n, E, f, d]`,
`router [n, d, E]`).  The serving engine holds them in bf16 and the KV
in bf16.  Every product takes bf16 operands except the router's, which
is f32; the head writes f32 logits, and the residual stream stays f32
between the products: rounding it to bf16 at its 56 adds would alone
move the served tokens about as far from an f32 forward as all the
products' rounding does, and a tenth of greedy positions have a top-2
margin under bf16's logit spacing.

The cached forward takes two kinds of KV state side by side
(inference/kv_cache.py `WindowPool`): the full layers' pool, every
position of a lane, and the window layers' pool, only the blocks the
window still shows; each is a (full, window) pair of pools and tables.
The window layers' attention passes `window` to the paged kernels (K4 at
T = 1, K5 above), which then read the window alone.

The expert layer on a CUDA tensor compacts the valid tokens on the
device and sorts their (token, expert) pairs by expert, with offsets
from a scatter-add (no host sync), then runs one grouped product per
projection (`torch._grouped_mm`, kernels named `GroupProblemShape` in
a device trace); masked slots route to no expert and cost no product.
On a CPU tensor it is a plain loop over the experts.  With `counts`, an
int64 device tensor [2], the layer adds the routed (token, expert) pairs
and the expert weight loads (experts with at least one token, once per
layer) to it, on the device.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Optional, Tuple

import torch
import torch.nn.functional as F

from ray_tpu_torch._device import DeviceLike, resolve_device
from ray_tpu_torch.models import _functional
from ray_tpu_torch.models.llama import (_attn_out, _project, _rmsnorm,
                                        _rope_rotate, _rope_tables)
from ray_tpu_torch.ops.attention import (NEG_INF, paged_attention,
                                         paged_kv_update)

WINDOW, FULL = "sliding_attention", "full_attention"

# The device counters that `forward_cached(counts=...)` adds to, in order.
COUNTERS = ("moe_routed_pairs", "moe_expert_loads")


@dataclasses.dataclass(frozen=True)
class MellumConfig:
    vocab_size: int = 98304
    n_layers: int = 28
    d_model: int = 2304
    n_heads: int = 32
    n_kv_heads: int = 4
    head_dim: int = 128
    n_experts: int = 64
    experts_per_token: int = 8
    d_expert: int = 896
    max_seq_len: int = 131072
    layer_types: Tuple[str, ...] = (WINDOW, WINDOW, WINDOW, FULL) * 7
    sliding_window: int = 1024
    rope_theta: float = 500000.0
    yarn_factor: float = 16.0
    yarn_original_max_positions: int = 8192
    yarn_beta_fast: float = 32.0
    yarn_beta_slow: float = 1.0
    yarn_attention_factor: float = 1.2772588722239782
    norm_eps: float = 1e-6
    norm_topk_prob: bool = True
    dtype: Any = torch.bfloat16   # activation dtype

    def __post_init__(self):
        object.__setattr__(self, "layer_types", tuple(self.layer_types))
        if len(self.layer_types) != self.n_layers or not set(
                self.layer_types) <= {WINDOW, FULL}:
            raise ValueError(f"layer_types must give {WINDOW!r} or {FULL!r} "
                             f"for each of {self.n_layers} layers")

    @property
    def n_window_layers(self) -> int:
        return self.layer_types.count(WINDOW)


CONFIGS = {
    # The CPU tests' size: one period of the layer pattern, a window of 8
    # and a YaRN original length of 16, so that short runs cross both.
    "mellum-tiny": MellumConfig(
        vocab_size=512, n_layers=4, d_model=64, n_heads=4, n_kv_heads=2,
        head_dim=16, n_experts=8, experts_per_token=2, d_expert=32,
        max_seq_len=256, layer_types=(WINDOW, WINDOW, WINDOW, FULL),
        sliding_window=8, rope_theta=10000.0,
        yarn_original_max_positions=16, dtype=torch.float32),
    # Mellum2-12B-A2.5B-Instruct's published config.
    "mellum2-12b-a2.5b": MellumConfig(),
}

# Leaves that the forward only uses cast to the activation dtype; the
# router is cast to f32 where it is used.
_MATMUL_KEYS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down",
                "tok_embed", "lm_head")


def param_shapes(config: MellumConfig) -> dict:
    c = config
    n, d, h, kh, dh = (c.n_layers, c.d_model, c.n_heads, c.n_kv_heads,
                       c.head_dim)
    e, f = c.n_experts, c.d_expert
    return {
        "tok_embed": (c.vocab_size, d),
        "blocks": {
            "attn_norm": (n, d),
            "wq": (n, d, h, dh), "wk": (n, d, kh, dh), "wv": (n, d, kh, dh),
            "wo": (n, h, dh, d),
            "mlp_norm": (n, d),
            "router": (n, d, e),
            "w_gate": (n, e, d, f), "w_up": (n, e, d, f),
            "w_down": (n, e, f, d),
        },
        "final_norm": (d,),
        "lm_head": (d, c.vocab_size),
    }


def param_specs(config: MellumConfig) -> dict:
    """Logical sharding spec tree, congruent with init_params output."""
    blocks = {
        "attn_norm": ("layers", "embed"),
        "wq": ("layers", "embed", "heads", "kv"),
        "wk": ("layers", "embed", "kv_heads", "kv"),
        "wv": ("layers", "embed", "kv_heads", "kv"),
        "wo": ("layers", "heads", "kv", "embed"),
        "mlp_norm": ("layers", "embed"),
        "router": ("layers", "embed", None),
        "w_gate": ("layers", "expert", "embed", "mlp"),
        "w_up": ("layers", "expert", "embed", "mlp"),
        "w_down": ("layers", "expert", "mlp", "embed"),
    }
    return {"tok_embed": ("vocab", None), "blocks": blocks,
            "final_norm": ("embed",), "lm_head": ("embed", "vocab")}


def init_params(config: MellumConfig,
                generator: Optional[torch.Generator] = None,
                device: DeviceLike = None) -> dict:
    """Random fp32 params on `device`: N(0, 0.02) for every matrix and
    table (the usual initializer_range), norm scales 1.  The draws come
    from `generator` (default: a CPU generator seeded 0) in the order of
    `param_shapes`."""
    gen = generator if generator is not None else \
        torch.Generator().manual_seed(0)
    device = resolve_device(device)

    def leaf(path, shape):
        if path.endswith("norm"):
            return torch.ones(shape, device=device)
        return torch.randn(shape, generator=gen, device=gen.device,
                           dtype=torch.float32).mul_(0.02).to(device)

    shapes = param_shapes(config)
    return {k: ({b: leaf(b, s) for b, s in v.items()}
                if isinstance(v, dict) else leaf(k, v))
            for k, v in shapes.items()}


def working_params(params: dict, config: MellumConfig,
                   device: DeviceLike = None) -> dict:
    """The serving engine's copy of `params` on `device`: the matrices
    and tables in `config.dtype` (no copy where they already are), the
    norms and the router as they are (`_functional.working_params`)."""
    return _functional.working_params(params, config.dtype, _MATMUL_KEYS,
                                      device)


@functools.lru_cache(maxsize=None)
def _yarn(theta: float, dim: int, factor: float, original: int,
          beta_fast: float, beta_slow: float, device) -> torch.Tensor:
    """YaRN's inverse frequencies [dim / 2] f32, as transformers'
    `_compute_yarn_parameters` with `truncate` on: pair i keeps theta's
    frequency below the ramp, takes it divided by `factor` above, and a
    linear blend over the ramp, whose ends are the pairs that turn
    beta_fast and beta_slow times over `original` positions (floor and
    ceil)."""
    def correction(rotations):
        return (dim * math.log(original / (rotations * 2 * math.pi))
                / (2 * math.log(theta)))

    low = max(math.floor(correction(beta_fast)), 0)
    high = min(math.ceil(correction(beta_slow)), dim - 1)
    if low == high:
        high += 0.001
    pos_freqs = theta ** (torch.arange(0, dim, 2, dtype=torch.float32) / dim)
    extrapolation = 1.0 / pos_freqs
    interpolation = 1.0 / (factor * pos_freqs)
    ramp = ((torch.arange(dim // 2, dtype=torch.float32) - low)
            / (high - low)).clamp(0, 1)
    keep = 1 - ramp
    # Held on `device` once: a copy at every forward would wait for it.
    return (interpolation * (1 - keep) + extrapolation * keep).to(device)


def yarn_rope(config: MellumConfig, device) -> Tuple[torch.Tensor, float]:
    """(inverse frequencies [head_dim / 2] f32 on `device`, attention
    factor) of the full layers' YaRN rope."""
    c = config
    freqs = _yarn(c.rope_theta, c.head_dim, c.yarn_factor,
                  c.yarn_original_max_positions, c.yarn_beta_fast,
                  c.yarn_beta_slow, torch.device(device))
    return freqs, c.yarn_attention_factor


def _rope_by_kind(config: MellumConfig, length: int, offset, device) -> dict:
    """The rope tables (cos, sin) of each kind of layer at positions
    offset .. offset + length - 1, built once for every layer: the
    default rope at theta on window layers, YaRN on full ones."""
    c = config
    half = c.head_dim // 2
    freqs, factor = yarn_rope(c, device)
    return {WINDOW: _rope_tables(length, half, c.rope_theta, offset, device),
            FULL: _rope_tables(length, half, c.rope_theta, offset, device,
                               freqs=freqs, scale=factor)}


def moe(h, p, config: MellumConfig, valid=None, counts=None):
    """The expert layer on normed tokens h [N, D]: router in f32, top-k
    of the softmax, weights renormalised (`norm_topk_prob`), SwiGLU
    experts on h in `config.dtype`, summed by weight; returns [N, D] f32.
    `valid` [N] bool (default all): other tokens route to no expert and
    come out as zeros.  No token is ever dropped.  `counts` (int64 [2] on
    h's device): adds (routed pairs, expert weight loads) in place."""
    c = config
    n, k, e = h.shape[0], c.experts_per_token, c.n_experts
    if valid is None:
        valid = torch.ones(n, dtype=torch.bool, device=h.device)
    probs = torch.softmax(h.float() @ p["router"].float(), dim=-1)
    weight, expert = probs.topk(k, dim=-1)                     # [N, k]
    if c.norm_topk_prob:
        weight = weight / weight.sum(-1, keepdim=True)
    # Invalid tokens route to expert e, which no product computes.
    expert = torch.where(valid[:, None], expert, e)
    experts = (_grouped_experts if h.device.type == "cuda"
               else _looped_experts)
    out, per_expert = experts(h.to(c.dtype), p, expert, weight, e)
    if counts is not None:
        counts += torch.stack([per_expert[:e].sum(),
                               (per_expert[:e] > 0).sum()])
    return out.float()


def _swiglu(x, w_gate, w_up, w_down):
    return (F.silu(x @ w_gate) * (x @ w_up)) @ w_down


def _looped_experts(h, p, expert, weight, e):
    """The plain version: a loop over the experts, each over the tokens
    that chose it; (f32 [N, D], tokens per expert [e + 1])."""
    out = torch.zeros(h.shape, dtype=torch.float32, device=h.device)
    per_expert = torch.bincount(expert.reshape(-1), minlength=e + 1)
    for ex in range(e):
        tok, slot = (expert == ex).nonzero(as_tuple=True)
        if tok.numel() == 0:
            continue
        y = _swiglu(h[tok], p["w_gate"][ex].to(h.dtype),
                    p["w_up"][ex].to(h.dtype), p["w_down"][ex].to(h.dtype))
        out.index_add_(0, tok, y.float() * weight[tok, slot, None])
    return out, per_expert


def _grouped_experts(h, p, expert, weight, e):
    """The device version: the (token, expert) pairs sorted by expert (the
    valid tokens' pairs first, as expert e sorts last), offsets from a
    scatter-add, one grouped product per projection over the pairs of
    the first e experts, then each token's k outputs summed by its
    weights in one batched product (the weights in h's dtype, the sums in
    f32); ([N, D] in h's dtype, tokens per expert [e + 1]).  Rows past
    the last offset are never computed (the grouped product leaves them
    unwritten) and are zeroed before the sum.  Nothing here waits for
    the device."""
    n, k = expert.shape
    flat = expert.reshape(-1)
    order = torch.argsort(flat, stable=True)
    per_expert = torch.zeros(e + 1, dtype=torch.int64,
                             device=h.device).scatter_add_(
        0, flat, torch.ones_like(flat))
    offs = per_expert[:e].cumsum(0).to(torch.int32)
    x = h[order // k]
    dtype = h.dtype
    gate = torch._grouped_mm(x, p["w_gate"].to(dtype), offs=offs)
    up = torch._grouped_mm(x, p["w_up"].to(dtype), offs=offs)
    y = torch._grouped_mm(F.silu(gate) * up, p["w_down"].to(dtype),
                          offs=offs)
    rows = torch.arange(n * k, device=h.device)
    y = torch.where((rows < offs[-1])[:, None], y, 0)
    back = torch.empty_like(order)
    back[order] = rows
    # Each token's k outputs by its weights, summed in f32 by the product.
    out = torch.bmm(weight.to(dtype)[:, None], y[back].view(n, k, -1))
    return out[:, 0], per_expert


def _block_params(params: dict, layer: int) -> dict:
    return {k: v[layer] for k, v in params["blocks"].items()}


def _dense_attention(q, k, v, window: Optional[int]):
    """Causal attention over whole rows [B, L, H, D] (kv heads repeated
    for the query heads), f32 softmax; with `window`, query i sees keys
    i - window < j <= i."""
    b, l, h, d = q.shape
    k = k.repeat_interleave(h // k.shape[2], dim=2)
    v = v.repeat_interleave(h // v.shape[2], dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / math.sqrt(d)
    i = torch.arange(l, device=q.device)
    mask = i[None, :] <= i[:, None]
    if window is not None:
        mask &= i[None, :] > i[:, None] - window
    s = s.masked_fill(~mask, NEG_INF)
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1),
                        v.float()).to(q.dtype)


def forward(params: dict, tokens: torch.Tensor, config: MellumConfig,
            position_offset=0) -> torch.Tensor:
    """tokens [B, L] -> logits [B, L, V], the whole rows at once with
    materialised masked attention (no cache, no kernel); the rows start
    at `position_offset`."""
    c = config
    x = params["tok_embed"][tokens.long()].float()
    b, l, d = x.shape
    rope = _rope_by_kind(c, l, position_offset, x.device)
    for layer, kind in enumerate(c.layer_types):
        p = _block_params(params, layer)
        h = _rmsnorm(x, p["attn_norm"], c.norm_eps).to(c.dtype)
        q = _rope_rotate(_project(h, p["wq"]), *rope[kind])
        k = _rope_rotate(_project(h, p["wk"]), *rope[kind])
        attn = _dense_attention(q, k, _project(h, p["wv"]),
                                c.sliding_window if kind == WINDOW else None)
        x = _attn_out(x, attn, p["wo"], c.dtype)
        h = _rmsnorm(x, p["mlp_norm"], c.norm_eps)
        x = x + moe(h.reshape(b * l, d), p, c).view(b, l, d)
    x = _rmsnorm(x, params["final_norm"], c.norm_eps)
    return lm_head(params, x, c)


def lm_head(params: dict, x: torch.Tensor,
            config: MellumConfig) -> torch.Tensor:
    """Project hidden states [..., D] to vocab logits [..., V] f32 (the
    untied head).  On a CUDA tensor with a bf16 head the product takes
    bf16 operands and writes f32 logits (no f32 copy of the head); else
    it is an f32 product."""
    w = params["lm_head"]
    if x.is_cuda and w.dtype != torch.float32:
        out = torch.mm(x.reshape(-1, x.shape[-1]).to(w.dtype), w,
                       out_dtype=torch.float32)
        return out.view(*x.shape[:-1], w.shape[-1])
    return x.float() @ w.float()


def forward_cached(params: dict, tokens: torch.Tensor,
                   positions: torch.Tensor, valid: torch.Tensor,
                   k_pool, v_pool, block_tables, ctx_lens: torch.Tensor,
                   config: MellumConfig, counts=None):
    """The cached trunk, the contract of llama.forward_cached with two
    kinds of state: `k_pool`, `v_pool` and `block_tables` are (full,
    window) pairs, the full layers' pools [n_full, NB, BS, KH, D] over
    every position and the window layers' [n_window, NBw, BS, KH, D]
    over the window (`PagedKVCache.pools` / `device_tables`).  K/V are
    written IN PLACE.  `counts` as in `moe`.  Returns (x [B, T, D],
    k_pool, v_pool); x is f32, the residual stream."""
    c = config
    x = params["tok_embed"][tokens.long()].float()
    b, t, d = x.shape
    # Each lane's slice rotates from its own first position.
    rope = _rope_by_kind(c, t, positions[:, 0], x.device)
    flat_valid = valid.reshape(-1)
    index = {WINDOW: 0, FULL: 0}
    for layer, kind in enumerate(c.layer_types):
        p = _block_params(params, layer)
        pool = 1 if kind == WINDOW else 0
        kp, vp = k_pool[pool][index[kind]], v_pool[pool][index[kind]]
        tables = block_tables[pool]
        index[kind] += 1
        h = _rmsnorm(x, p["attn_norm"], c.norm_eps).to(c.dtype)
        q = _rope_rotate(_project(h, p["wq"]), *rope[kind])
        k = _rope_rotate(_project(h, p["wk"]), *rope[kind])
        paged_kv_update(kp, vp, k, _project(h, p["wv"]), tables, positions,
                        valid)
        attn = paged_attention(
            q, kp, vp, tables, ctx_lens, positions,
            window=c.sliding_window if kind == WINDOW else None)
        x = _attn_out(x, attn, p["wo"], c.dtype)
        h = _rmsnorm(x, p["mlp_norm"], c.norm_eps)
        x = x + moe(h.reshape(b * t, d), p, c, flat_valid,
                    counts).view(b, t, d)
    x = _rmsnorm(x, params["final_norm"], c.norm_eps)
    return x, k_pool, v_pool
