"""Llama model family: RMSNorm, rotary embeddings, SwiGLU and
grouped-query attention; the training forward and loss, and the cached
forward of the serving path (port of ray_tpu/models/llama.py).

Plain functions on tensors, in the idiom of models/gpt.py: params are a
nested dict of fp32 tensors with the layers STACKED on a leading dim
(`wq [n, d, h, dh]`, `wk/wv [n, d, kh, dh]`, `wo [n, h, dh, d]`,
`w_gate/w_up [n, d, f]`, `w_down [n, f, d]`), cast to the activation
dtype where the forward uses them.  A Python loop over the stacked
layers takes the place of `lax.scan`.

GQA: each of the `n_kv_heads` K/V heads serves `q_per_kv` query heads,
query head `h` reading kv head `h // q_per_kv` (`jnp.repeat` is
interleaved, so `repeat_interleave`, never the tiling `repeat`).  The
training block materialises the repeat before the flash kernels (K1-K3)
and autograd sums the gradients back through it; the cached path keeps
the kv heads un-repeated in the pool and the paged attention path (K4 at
T=1) expands the groups itself.

Under a mesh of data, fsdp, seq and tensor the training forward runs
on each rank's shards as gpt.py's does (models/_functional.py): the kv
heads split over `tensor` like the query heads, so the GQA repeat runs
on the rank's own kv heads (`n_kv_heads % tensor == 0`, else the
placement raises); over a seq axis RoPE rotates at the rank's absolute
positions and the ring (`ring_attention`) carries the repeated kv
heads, as the reference's does; the loss is the vocab-parallel
`fused_cross_entropy_spmd` on the untied head.  A mesh with stage above
1 raises `NotImplementedError`.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from ray_tpu_torch._device import DeviceLike, resolve_device
from ray_tpu_torch.models import _functional
from ray_tpu_torch.models._functional import _map
from ray_tpu_torch.ops.attention import paged_attention, paged_kv_update
from ray_tpu_torch.ops.cross_entropy import (fused_cross_entropy,
                                             fused_cross_entropy_spmd)
from ray_tpu_torch.parallel import collectives
from ray_tpu_torch.parallel.sharding import tree_map, tree_shardings


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    n_layers: int = 32
    d_model: int = 4096
    n_heads: int = 32
    n_kv_heads: int = 32          # < n_heads = grouped-query attention
    d_ff: int = 11008             # SwiGLU hidden
    max_seq_len: int = 4096
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    dtype: Any = torch.bfloat16   # activation dtype (params kept fp32)
    remat: bool = False           # recompute each block in the backward

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // self.n_kv_heads


# Preset configs: the reference's names and sizes.
CONFIGS = {
    "llama-tiny": LlamaConfig(vocab_size=512, n_layers=2, d_model=64,
                              n_heads=4, n_kv_heads=2, d_ff=128,
                              max_seq_len=128, dtype=torch.float32),
    # TinyLlama-1.1B's shape.
    "llama-1b": LlamaConfig(vocab_size=32000, n_layers=22, d_model=2048,
                            n_heads=32, n_kv_heads=4, d_ff=5632,
                            max_seq_len=2048),
    "llama2-7b": LlamaConfig(remat=True),
    "llama3-8b": LlamaConfig(vocab_size=128256, n_layers=32, d_model=4096,
                             n_heads=32, n_kv_heads=8, d_ff=14336,
                             max_seq_len=8192, rope_theta=500000.0,
                             remat=True),
}

# Leaves that the forward only ever uses cast to the activation dtype.
_MATMUL_KEYS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down",
                "tok_embed", "lm_head")


def param_specs(config: LlamaConfig) -> dict:
    """Logical sharding spec tree, congruent with init_params output."""
    blocks = {
        "attn_norm": ("layers", "embed"),
        "wq": ("layers", "embed", "heads", "kv"),
        "wk": ("layers", "embed", "kv_heads", "kv"),
        "wv": ("layers", "embed", "kv_heads", "kv"),
        "wo": ("layers", "heads", "kv", "embed"),
        "mlp_norm": ("layers", "embed"),
        "w_gate": ("layers", "embed", "mlp"),
        "w_up": ("layers", "embed", "mlp"),
        "w_down": ("layers", "mlp", "embed"),
    }
    return {
        "tok_embed": ("vocab", None),
        "blocks": blocks,
        "final_norm": ("embed",),
        "lm_head": ("embed", "vocab"),
    }


def param_shapes(config: LlamaConfig) -> dict:
    """Shape tree congruent with `init_params` (and the reference's)."""
    c = config
    n, d, h, kh, dh, f = (c.n_layers, c.d_model, c.n_heads, c.n_kv_heads,
                          c.head_dim, c.d_ff)
    return {
        "tok_embed": (c.vocab_size, d),
        "blocks": {
            "attn_norm": (n, d),
            "wq": (n, d, h, dh), "wk": (n, d, kh, dh), "wv": (n, d, kh, dh),
            "wo": (n, h, dh, d),
            "mlp_norm": (n, d),
            "w_gate": (n, d, f), "w_up": (n, d, f), "w_down": (n, f, d),
        },
        "final_norm": (d,),
        "lm_head": (d, c.vocab_size),
    }


def init_params(config: LlamaConfig,
                generator: Optional[torch.Generator] = None,
                device: DeviceLike = None) -> dict:
    """Random fp32 params with the reference's shapes and scales
    (ray_tpu/models/llama.py init_params).  The draws come from
    `generator` (default: a CPU generator seeded 0), on the generator's
    own device, and differ from `jax.random`'s; to run both packages on
    the same weights use convert.params_from_numpy."""
    device = resolve_device(device)
    c = config
    n, d, h, kh, dh, f = (c.n_layers, c.d_model, c.n_heads, c.n_kv_heads,
                          c.head_dim, c.d_ff)
    gen = generator if generator is not None else torch.Generator().manual_seed(0)

    def normal(shape):
        return torch.randn(shape, generator=gen, device=gen.device,
                           dtype=torch.float32)

    def dense(shape, fan_in):
        return normal(shape) / math.sqrt(fan_in)

    blocks = {
        "attn_norm": torch.ones(n, d),
        "wq": dense((n, d, h, dh), d),
        "wk": dense((n, d, kh, dh), d),
        "wv": dense((n, d, kh, dh), d),
        "wo": dense((n, h, dh, d), h * dh) / math.sqrt(2 * n),
        "mlp_norm": torch.ones(n, d),
        "w_gate": dense((n, d, f), d),
        "w_up": dense((n, d, f), d),
        "w_down": dense((n, f, d), f) / math.sqrt(2 * n),
    }
    params = {
        "tok_embed": normal((c.vocab_size, d)) * 0.02,
        "blocks": blocks,
        "final_norm": torch.ones(d),
        "lm_head": dense((d, c.vocab_size), d),
    }
    return _map(params, lambda t: t.to(device))


def shard_params(params: dict, mesh, config: LlamaConfig, rules=None,
                 device: DeviceLike = None) -> dict:
    """This rank's shards of the global `params` as DTensors on
    `device` (default: the mesh's card), placed by `param_specs` under
    `rules`, as gpt.shard_params."""
    return tree_map(lambda t, s: s.shard(t, device), params,
                    tree_shardings(mesh, param_specs(config), rules))


def num_params(config: LlamaConfig) -> int:
    def count(tree):
        return sum(count(v) if isinstance(v, dict) else math.prod(v)
                   for v in tree.values())
    return count(param_shapes(config))


def working_params(params: dict, config: LlamaConfig,
                   device: DeviceLike = None) -> dict:
    """The serving engine's copy of `params` on `device`: the
    projections, the SwiGLU weights, the embedding and the head cast to
    `config.dtype` once, the two norm scales kept fp32
    (`_functional.working_params`)."""
    return _functional.working_params(params, config.dtype, _MATMUL_KEYS,
                                      device)


def _rmsnorm(x, scale, eps):
    x32 = x.float()
    y = x32 * torch.rsqrt(x32.square().mean(-1, keepdim=True) + eps)
    return (y * scale).to(x.dtype)


def _rope(x, theta: float, offset=0):
    """Rotary position embedding over [B, L, H, K], rotate-half pairing
    (the head dim splits into two halves treated as (real, imag)).

    `offset` is the absolute position of x's first token: a scalar shared
    by the batch, or a per-lane [B] tensor (cached decode: lanes sit at
    different depths).  The frequencies are the reference's f32
    `theta ** (-arange(half) / half)`."""
    l, half = x.shape[1], x.shape[-1] // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float32,
                                    device=x.device) / half)
    off = torch.as_tensor(offset, dtype=torch.float32, device=x.device)
    pos = off[..., None] + torch.arange(l, dtype=torch.float32,
                                        device=x.device)   # [L] or [B, L]
    ang = pos[..., None] * freqs                 # [L, half] / [B, L, half]
    if ang.dim() == 2:
        ang = ang[None]
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x32 = x.float()
    x1, x2 = x32[..., :half], x32[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def _repeat_kv(x, q_per_kv: int):
    """[B, L, KH, D] -> [B, L, KH * q_per_kv, D], kv head j serving query
    heads j * q_per_kv .. (j + 1) * q_per_kv - 1 (`jnp.repeat`)."""
    return x if q_per_kv == 1 else x.repeat_interleave(q_per_kv, dim=2)


def _project(h, w):
    """h [B, L, D] by w [D, H, K] in h's dtype ("bld,dhk->blhk")."""
    b, l, d = h.shape
    return (h @ w.reshape(d, -1).to(h.dtype)).view(b, l, *w.shape[1:])


def _attn_out(x, attn, wo, dtype):
    """x plus attn [B, L, H, K] by wo [H, K, D] ("blhk,hkd->bld")."""
    b, l, h, k = attn.shape
    return x + attn.reshape(b, l, h * k) @ wo.reshape(h * k, -1).to(dtype)


def _mlp(x, p, config: LlamaConfig, tp=None):
    """x + SwiGLU(RMSNorm(x)); under tensor parallelism `p` holds this
    rank's MLP columns and the output is summed over `tp`."""
    h = collectives.all_reduce_grad(
        _rmsnorm(x, p["mlp_norm"], config.norm_eps), tp)
    gate = F.silu(h @ p["w_gate"].to(h.dtype))
    up = h @ p["w_up"].to(h.dtype)
    return x + collectives.all_reduce_value(
        (gate * up) @ p["w_down"].to(h.dtype), tp)


def _block(x, p, config: LlamaConfig, position_offset=0,
           plan=_functional.ONE_DEVICE):
    """One training block: x [B, L, D] -> x.  Attention is `plan.attend`
    (`flash_attention`: K1 forward, K2/K3 backward, causal; or
    `ring_attention` over a seq axis) over the repeated kv heads, RoPE at
    `position_offset`, the absolute position of x's first token.  Under
    tensor parallelism (`plan.tensor`) `p` holds this rank's query and
    kv heads and MLP columns (gpt._block)."""
    c = config
    tp = plan.tensor
    h = collectives.all_reduce_grad(
        _rmsnorm(x, p["attn_norm"], c.norm_eps), tp)
    q = _rope(_project(h, p["wq"]), c.rope_theta, position_offset)
    k = _rope(_project(h, p["wk"]), c.rope_theta, position_offset)
    v = _project(h, p["wv"])
    attn = plan.attend(q, _repeat_kv(k, c.q_per_kv),
                       _repeat_kv(v, c.q_per_kv))
    b, l, nh, dh = attn.shape
    x = x + collectives.all_reduce_value(
        attn.reshape(b, l, nh * dh) @ p["wo"].reshape(nh * dh, -1).to(
            h.dtype), tp)
    return _mlp(x, p, c, tp)


def _trunk(p, tokens, config: LlamaConfig, plan, position_offset=0):
    """The stack on this rank's local params `p` and token rows."""
    c = config
    x = plan.embed(p["tok_embed"], tokens, c.dtype)
    position_offset = position_offset + plan.position_offset(
        tokens.shape[1])
    # Unbind each stacked leaf once: its backward stacks the layers'
    # gradients into one tensor, as lax.scan's does.  Indexing a layer
    # per block would instead add a zero-padded gradient of the whole
    # stack per layer (a third of llama-1b's train step on the card).
    layers = {k: v.unbind(0) for k, v in p["blocks"].items()}
    for layer in range(c.n_layers):
        lp = {k: plan.layer(v[layer], k) for k, v in layers.items()}
        if c.remat:
            x = torch.utils.checkpoint.checkpoint(
                _block, x, lp, c, position_offset, plan,
                use_reentrant=False)
        else:
            x = _block(x, lp, c, position_offset, plan)
    return _rmsnorm(x, plan.leaf(p["final_norm"], "final_norm"),
                    c.norm_eps)


def _plan(config: LlamaConfig, mesh):
    return _functional.plan_for(mesh, param_specs(config))


def forward_trunk(params: dict, tokens: torch.Tensor, config: LlamaConfig,
                  mesh=None, position_offset=0) -> torch.Tensor:
    """tokens [B, L] -> hidden states [B, L, D] (pre-head, normed);
    under a mesh, this rank's rows.

    position_offset rotates RoPE as if the tokens started at that
    absolute position (a scalar, or a per-lane [B] tensor).  With
    `config.remat` each block is recomputed in the backward
    (non-reentrant checkpoint), so its flash forward runs twice per
    step."""
    plan = _plan(config, mesh)
    return _trunk(plan.local(params), plan.rows(tokens), config, plan,
                  position_offset)


def lm_head(params: dict, x: torch.Tensor,
            config: LlamaConfig) -> torch.Tensor:
    """Project hidden states [..., D] to vocab logits [..., V] (the
    untied head)."""
    return x @ params["lm_head"].to(config.dtype)


def forward(params: dict, tokens: torch.Tensor, config: LlamaConfig,
            mesh=None, position_offset=0) -> torch.Tensor:
    """tokens [B, L] -> logits [B, L, V]; under a mesh, this rank's rows
    and vocab slice."""
    plan = _plan(config, mesh)
    p = plan.local(params)
    x = _trunk(p, plan.rows(tokens), config, plan, position_offset)
    return x @ plan.leaf(p["lm_head"], "lm_head").to(config.dtype)


def loss_fn(params: dict, batch: dict, config: LlamaConfig, mesh=None):
    """batch = {"tokens": [B, L], optional "loss_mask": [B, L]} ->
    next-token cross-entropy (f32 scalar): the model runs on the full
    length, the targets are the tokens rolled left by one and the last
    position is masked, as in gpt.loss_fn (`plan.targets`); the loss is
    the fused chunked cross-entropy on the head, which never
    materialises [B, L, V] (under a mesh the vocab-parallel one, equal
    on every rank)."""
    c = config
    _functional.check_mesh_loss(mesh, c.vocab_size, batch["tokens"].shape)
    plan = _plan(c, mesh)
    tokens = plan.rows(batch["tokens"])
    targets, valid = plan.targets(tokens)
    mask = batch.get("loss_mask")
    if mask is not None:
        valid = valid * plan.rows(mask)
    p = plan.local(params)
    x = _trunk(p, tokens, c, plan)
    head = plan.leaf(p["lm_head"], "lm_head").to(c.dtype)
    if plan is not _functional.ONE_DEVICE:
        return fused_cross_entropy_spmd(x, head, targets, valid, mesh)
    b, l, d = x.shape
    return fused_cross_entropy(x.reshape(b * l, d), head,
                               targets.reshape(-1), valid.reshape(-1))


def make_train_step(config: LlamaConfig, optimizer, mesh=None, *,
                    device: DeviceLike = None):
    """Returns (init_state, train_step), the shared functional-LM
    contract (models/_functional.py), on `device` (None -> CUDA).  Under
    a mesh the params and AdamW's moments are DTensors placed by
    `param_specs`; stage above 1 raises."""
    _plan(config, mesh)
    return _functional.make_train_step(config, optimizer,
                                       init_params=init_params,
                                       loss_fn=loss_fn, device=device,
                                       mesh=mesh, param_specs=param_specs)


def _block_cached(x, p, k_pool, v_pool, config: LlamaConfig, block_tables,
                  positions, valid, ctx_lens):
    """One Llama block over a paged KV cache.  K/V are cached with the
    kv heads un-repeated (the point of the grouped cache); the paged
    attention path expands the groups itself.  x [B, T, D]; positions
    [B, T] absolute, contiguous per lane; ctx_lens [B] = context length
    including this slice."""
    c = config
    h = _rmsnorm(x, p["attn_norm"], c.norm_eps)
    # Each lane's slice rotates from its own first position.
    q = _rope(_project(h, p["wq"]), c.rope_theta, positions[:, 0])
    k = _rope(_project(h, p["wk"]), c.rope_theta, positions[:, 0])
    v = _project(h, p["wv"])
    paged_kv_update(k_pool, v_pool, k, v, block_tables, positions, valid)
    attn = paged_attention(q, k_pool, v_pool, block_tables, ctx_lens,
                           positions)
    x = _attn_out(x, attn, p["wo"], h.dtype)
    return _mlp(x, p, c), k_pool, v_pool


def forward_cached(params: dict, tokens: torch.Tensor,
                   positions: torch.Tensor, valid: torch.Tensor,
                   k_pool: torch.Tensor, v_pool: torch.Tensor,
                   block_tables: torch.Tensor, ctx_lens: torch.Tensor,
                   config: LlamaConfig):
    """Cached (incremental) trunk, the same contract as
    gpt.forward_cached: tokens [B, T] at per-lane absolute `positions`;
    K/V written IN PLACE into the paged pools [n_layers, NB, BS, KH, D]
    (KH = n_kv_heads).  Returns (x [B, T, D], k_pool, v_pool)."""
    c = config
    x = params["tok_embed"][tokens.long()].to(c.dtype)
    blocks = params["blocks"]
    for layer in range(c.n_layers):
        p = {k: v[layer] for k, v in blocks.items()}
        x, _, _ = _block_cached(x, p, k_pool[layer], v_pool[layer], c,
                                block_tables, positions, valid, ctx_lens)
    x = _rmsnorm(x, params["final_norm"], c.norm_eps)
    return x, k_pool, v_pool
