"""Decoder-only transformer (GPT family): the training forward and loss,
and the cached forward of the serving path (port of
ray_tpu/models/gpt.py).

Plain functions on tensors, as in the reference: params are a nested
dict of tensors with the layers STACKED on a leading dim (`wq/wk/wv
[n, d, h, dh]`, `wo [n, h, dh, d]`, `w_up [n, d, f]`, `w_down [n, f, d]`),
kept in fp32, and the forward casts weights to the activation dtype
where it uses them, inside the graph, so the fp32 leaves get the
gradients.  A Python loop over the stacked layers takes the place of
`lax.scan`.

Ported: the config table, `param_specs`, `init_params`,
`shard_params`, `num_params`, `_layernorm`, the Switch MoE MLP
(`_moe_mlp`), `_block`, `forward_trunk`, `forward`, `loss_fn`,
`make_train_step`, `_block_cached`, `forward_cached` and `lm_head`.

Under a mesh of data, fsdp, expert, seq and tensor
(models/_functional.py) the training forward runs on each rank's
shards: its rows of the batch and their length slice, its heads and
MLP columns of each block (Megatron's column- then row-parallel
products, the partial outputs summed over `tensor`), each layer's
weights gathered over fsdp where used.  Attention is flash attention
(K1-K3) on the local [B / (data x fsdp), L / seq, H / tensor, D]
shard, through `ring_attention` when seq is above 1, with the position
table read at the rank's absolute offset.  The Switch MoE keeps the
reference's global semantics (capacity, queue order and aux over the
global batch's real tokens) and computes only the rank's experts'
slots, their partial outputs summed over `expert` and `tensor`.  The
loss is the vocab-parallel `fused_cross_entropy_spmd`, the pad rows of
a batch the row ranks do not divide masked: the reference's fallback's
Σ nll · valid / max(Σ valid, 1) over the global real tokens.  Stage
ranks are replicas (no leaf and no batch dim maps to `stage`, as in the
reference).
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
class GPTConfig:
    vocab_size: int = 50304          # GPT-2 vocab padded to a multiple of 128
    n_layers: int = 12
    d_model: int = 768
    n_heads: int = 12
    d_ff: int = 3072
    max_seq_len: int = 1024
    dtype: Any = torch.bfloat16      # activation dtype (params kept fp32)
    n_experts: int = 0               # 0 = dense MLP; >0 = Switch MoE
    capacity_factor: float = 1.25
    remat: bool = False              # recompute each block in the backward
    tie_embeddings: bool = True

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


# Preset configs: the reference's names and sizes.
CONFIGS = {
    "nano": GPTConfig(vocab_size=512, n_layers=2, d_model=64, n_heads=4,
                      d_ff=128, max_seq_len=128, dtype=torch.float32),
    "nano-moe": GPTConfig(vocab_size=512, n_layers=2, d_model=64, n_heads=4,
                          d_ff=128, max_seq_len=128, n_experts=4,
                          dtype=torch.float32),
    "gpt2-small": GPTConfig(),                     # 124M
    "gpt2-medium": GPTConfig(n_layers=24, d_model=1024, n_heads=16,
                             d_ff=4096),
    "gpt2-xl": GPTConfig(n_layers=48, d_model=1600, n_heads=25, d_ff=6400),
    "7b": GPTConfig(vocab_size=32000, n_layers=32, d_model=4096, n_heads=32,
                    d_ff=11008, max_seq_len=4096, remat=True),
}

# Leaves that the forward only ever uses cast to the activation dtype.
_MATMUL_KEYS = ("wq", "wk", "wv", "wo", "w_up", "w_down", "tok_embed",
                "pos_embed", "lm_head")


def param_specs(config: GPTConfig) -> dict:
    """Logical sharding spec tree, congruent with init_params output."""
    blocks = {
        "ln1_scale": ("layers", "embed"),
        "ln1_bias": ("layers", "embed"),
        "wq": ("layers", "embed", "heads", "kv"),
        "wk": ("layers", "embed", "heads", "kv"),
        "wv": ("layers", "embed", "heads", "kv"),
        "wo": ("layers", "heads", "kv", "embed"),
        "ln2_scale": ("layers", "embed"),
        "ln2_bias": ("layers", "embed"),
    }
    if config.n_experts:
        blocks.update({
            "router": ("layers", "embed", "experts"),
            "w_up": ("layers", "experts", "embed", "expert_mlp"),
            "w_down": ("layers", "experts", "expert_mlp", "embed"),
        })
    else:
        blocks.update({
            "w_up": ("layers", "embed", "mlp"),
            "w_down": ("layers", "mlp", "embed"),
        })
    specs = {
        # Table embed dims stay unsharded (vocab carries tensor+fsdp, see
        # parallel/sharding.py DEFAULT_RULES["vocab"]); pos_embed is tiny
        # and replicated.
        "tok_embed": ("vocab", None),
        "pos_embed": (None, None),
        "blocks": blocks,
        "final_ln_scale": ("embed",),
        "final_ln_bias": ("embed",),
    }
    if not config.tie_embeddings:
        specs["lm_head"] = ("embed", "vocab")
    return specs


def param_shapes(config: GPTConfig) -> dict:
    """Shape tree congruent with `init_params` (and the reference's)."""
    c = config
    n, d, h, dh, f = c.n_layers, c.d_model, c.n_heads, c.head_dim, c.d_ff
    blocks = {
        "ln1_scale": (n, d), "ln1_bias": (n, d),
        "wq": (n, d, h, dh), "wk": (n, d, h, dh), "wv": (n, d, h, dh),
        "wo": (n, h, dh, d),
        "ln2_scale": (n, d), "ln2_bias": (n, d),
    }
    if c.n_experts:
        e = c.n_experts
        blocks.update(router=(n, d, e), w_up=(n, e, d, f),
                      w_down=(n, e, f, d))
    else:
        blocks.update(w_up=(n, d, f), w_down=(n, f, d))
    shapes = {
        "tok_embed": (c.vocab_size, d),
        "pos_embed": (c.max_seq_len, d),
        "blocks": blocks,
        "final_ln_scale": (d,),
        "final_ln_bias": (d,),
    }
    if not c.tie_embeddings:
        shapes["lm_head"] = (d, c.vocab_size)
    return shapes


def init_params(config: GPTConfig, generator: Optional[torch.Generator] = None,
                device: DeviceLike = None, keep=None) -> dict:
    """Random fp32 params with the reference's shapes and scales
    (ray_tpu/models/gpt.py init_params).  The draws come from `generator`
    (default: a CPU generator seeded 0) and differ from `jax.random`'s;
    to run both packages on the same weights use convert.params_from_numpy.

    With `keep`, each leaf goes to `keep(path, leaf)` as soon as it is
    drawn (the blocks' first, then the tables, the final norm and an
    untied head), and the tree holds what it returns (`device` unused):
    a mesh rank keeps its shard and drops the whole leaf before the next
    draw (`_functional.MeshPlan.init_leaf`)."""
    c = config
    n, d, h, dh, f = c.n_layers, c.d_model, c.n_heads, c.head_dim, c.d_ff
    gen = generator if generator is not None else torch.Generator().manual_seed(0)
    if keep is None:
        device = resolve_device(device)
        put = lambda path, t: t.to(device)  # noqa: E731
    else:
        put = keep

    def normal(shape):
        return torch.randn(shape, generator=gen, device=gen.device,
                           dtype=torch.float32)

    def dense(shape, fan_in):
        return normal(shape).div_(math.sqrt(fan_in))

    def residual(shape, fan_in):
        # Residual-branch outputs scaled per GPT-2 (1/sqrt(2*n_layers)).
        return dense(shape, fan_in).div_(math.sqrt(2 * n))

    blocks = {
        "ln1_scale": put("blocks/ln1_scale", torch.ones(n, d)),
        "ln1_bias": put("blocks/ln1_bias", torch.zeros(n, d)),
        "wq": put("blocks/wq", dense((n, d, h, dh), d)),
        "wk": put("blocks/wk", dense((n, d, h, dh), d)),
        "wv": put("blocks/wv", dense((n, d, h, dh), d)),
        "wo": put("blocks/wo", residual((n, h, dh, d), h * dh)),
        "ln2_scale": put("blocks/ln2_scale", torch.ones(n, d)),
        "ln2_bias": put("blocks/ln2_bias", torch.zeros(n, d)),
    }
    if c.n_experts:
        e = c.n_experts
        blocks["router"] = put("blocks/router", dense((n, d, e), d))
        blocks["w_up"] = put("blocks/w_up", dense((n, e, d, f), d))
        blocks["w_down"] = put("blocks/w_down", residual((n, e, f, d), f))
    else:
        blocks["w_up"] = put("blocks/w_up", dense((n, d, f), d))
        blocks["w_down"] = put("blocks/w_down", residual((n, f, d), f))
    params = {
        "tok_embed": put("tok_embed",
                         normal((c.vocab_size, d)).mul_(0.02)),
        "pos_embed": put("pos_embed",
                         normal((c.max_seq_len, d)).mul_(0.01)),
        "blocks": blocks,
        "final_ln_scale": put("final_ln_scale", torch.ones(d)),
        "final_ln_bias": put("final_ln_bias", torch.zeros(d)),
    }
    if not c.tie_embeddings:
        params["lm_head"] = put("lm_head", dense((d, c.vocab_size), d))
    return params


def shard_params(params: dict, mesh, config: GPTConfig, rules=None,
                 device: DeviceLike = None) -> dict:
    """This rank's shards of the global `params` (the same on every
    rank) as DTensors on `device` (default: the mesh's card), placed by
    `param_specs` under `rules` (default `DEFAULT_RULES`).  The train
    step moves leaves placed by other rules into its own layout
    (`MeshPlan.place`)."""
    return tree_map(lambda t, s: s.shard(t, device), params,
                    tree_shardings(mesh, param_specs(config), rules))


def num_params(config: GPTConfig) -> int:
    def count(tree):
        return sum(count(v) if isinstance(v, dict) else math.prod(v)
                   for v in tree.values())
    return count(param_shapes(config))


def working_params(params: dict, config: GPTConfig,
                   device: DeviceLike = None) -> dict:
    """The serving engine's copy of `params` on `device`: matmul weights
    and the embedding tables cast to `config.dtype` once, LayerNorm
    scales and biases kept fp32 (`_functional.working_params`)."""
    return _functional.working_params(params, config.dtype, _MATMUL_KEYS,
                                      device)


def _layernorm(x, scale, bias, eps=1e-5):
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = (x32 - mu).square().mean(-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * scale + bias).to(x.dtype)


def lm_head(params: dict, x: torch.Tensor, config: GPTConfig) -> torch.Tensor:
    """Project hidden states [..., D] to vocab logits [..., V]."""
    head = (params["tok_embed"].T if config.tie_embeddings
            else params["lm_head"]).to(config.dtype)
    return x @ head


def _route(x, router, config: GPTConfig, plan=_functional.ONE_DEVICE,
           rows=None):
    """Switch top-1 routing of x [T, D] over `config.n_experts` experts,
    as the reference's `_moe_mlp` routes: f32 logits and softmax, gate =
    the largest probability, expert = its first index, each token's rank
    in its expert's queue in global token order (b * L + l).  Returns
    (probs [T, E] f32, gate [T] f32, expert [T], rank [T], cap); a token
    is kept iff 0 <= rank < cap.

    Under a mesh (`plan`, the tokens the rank's `rows` (b, l) of the
    batch) the capacity counts the global real tokens, and the queue
    order is the global one: the expert ids are gathered over the row
    axes (one int per token), ranked, and the rank's slice taken back.
    A pad row's tokens (`plan.real_rows`) hold no queue place: their
    rank is -1."""
    e = config.n_experts
    probs = torch.softmax(x.float() @ router.float(), dim=-1)
    # amax splits the gradient evenly among tied maxima, as jnp.max does.
    gate = probs.amax(-1)
    expert = probs.argmax(-1)
    ids = plan.global_rows(expert.view(rows or (1, -1)))
    cap = int(math.ceil(plan.real_tokens(ids) / e * config.capacity_factor))
    # The queue positions, scanned along tokens as the inner dim.
    onehot = F.one_hot(ids, e)                                # [B, L, E]
    real = plan.real_rows(ids)
    if real is not None:
        onehot = onehot * real[..., None]
    onehot = onehot.view(-1, e).T.contiguous()                # [E, T]
    rank = ((onehot.cumsum(1) * onehot).sum(0) - 1).view(ids.shape)
    return probs, gate, expert, plan.local_rows(rank).reshape(-1), cap


def _moe_mlp(x, router, w_up, w_down, config: GPTConfig,
             plan=_functional.ONE_DEVICE):
    """Switch-style top-1 MoE: x [B, L, D] -> (out [B, L, D], aux f32
    scalar), the function of the reference's `_moe_mlp`
    (ray_tpu/models/gpt.py), dispatched by index instead of by its
    dense one-hot einsums.

    Token t goes to slot expert * cap + rank if kept, else to a spare
    slot of its own (E * cap + t), whose row is dropped: the slots are
    distinct, so the dispatch is one `index_copy` and the combine one
    `index_select`, and the backward of each is a gather or a one-add-
    per-row scatter (deterministic, with no run of equal indices to
    serialise).  Every sum in the dense form has one non-zero term, so
    the values are the reference's.

    Under a mesh `w_up` / `w_down` hold the rank's experts (over
    `expert`) and their hidden columns (over `tensor`); x is the rank's
    rows, the same on every rank of the (expert, tensor) group.  Each
    rank routes its tokens against every expert (`plan.experts`), puts
    into slots only the tokens of its own experts, and the partial
    outputs are summed over the group (Megatron's f and g around the
    experts; the router and the gate, computed alike on every rank of
    the group, stay outside them).  The aux takes its means over the
    global real tokens."""
    b, l, d = x.shape
    t, e = b * l, config.n_experts
    xt = x.reshape(t, d)
    probs, gate, expert, rank, cap = _route(xt, plan.experts(router),
                                            config, plan, (b, l))
    n_local = w_up.shape[0]
    local = expert - plan.first_expert(n_local)
    arange = torch.arange(t, device=x.device)
    slot = torch.where((rank >= 0) & (rank < cap) & (local >= 0)
                       & (local < n_local), local * cap + rank,
                       n_local * cap + arange)
    x_in = collectives.all_reduce_grad(xt, plan.moe)
    ex_in = x_in.new_zeros(n_local * cap + t, d).index_copy(0, slot, x_in)
    hidden = F.gelu(torch.bmm(ex_in[:n_local * cap].view(n_local, cap, d),
                              w_up.to(x.dtype)), approximate="tanh")
    ex_out = torch.bmm(hidden, w_down.to(x.dtype)).view(n_local * cap, d)
    picked = torch.cat([ex_out, ex_out.new_zeros(t, d)]).index_select(
        0, slot)
    # The reference rounds gate to the activation dtype before combining.
    out = collectives.all_reduce_value(picked, plan.moe) * \
        gate.to(x.dtype)[:, None]
    # Load-balancing aux loss (Switch eq. 4): mean assignment * mean prob.
    density = plan.row_mean(F.one_hot(expert, e).float())
    aux = e * torch.sum(density * plan.row_mean(probs))
    return out.view(b, l, d), aux


def _plan(config: GPTConfig, mesh, shape):
    """The forward's plan for a global batch of `shape`
    (`_functional.batch_plan`)."""
    return _functional.batch_plan(mesh, param_specs(config), shape)


def _block(x, p, config: GPTConfig, plan=_functional.ONE_DEVICE):
    """One training block: x [B, L, D] -> (x, aux).  Attention is
    `plan.attend`: `flash_attention` (K1 forward, K2/K3 backward) with
    causal=True, or `ring_attention` over a seq axis; the MLP is dense
    (aux None), or the Switch MoE when `config.n_experts` (aux is its
    load-balancing loss).  Under tensor parallelism (`plan.tensor`, the
    tensor group) `p` holds this rank's heads and MLP columns: the normed
    input enters the column-parallel products (its gradient summed over
    the group) and the row-parallel outputs are summed over it."""
    b, l, d = x.shape
    dh = config.head_dim
    tp = plan.tensor
    h = collectives.all_reduce_grad(
        _layernorm(x, p["ln1_scale"], p["ln1_bias"]), tp)

    def heads(w):                    # "bld,dhk->blhk"
        return (h @ w.reshape(d, -1).to(h.dtype)).view(b, l, -1, dh)

    attn = plan.attend(heads(p["wq"]), heads(p["wk"]), heads(p["wv"]))
    nh = attn.shape[2]
    x = x + collectives.all_reduce_value(
        attn.reshape(b, l, nh * dh) @ p["wo"].reshape(nh * dh, d).to(
            h.dtype), tp)

    h = _layernorm(x, p["ln2_scale"], p["ln2_bias"])
    if config.n_experts:
        mlp_out, aux = _moe_mlp(h, p["router"], p["w_up"], p["w_down"],
                                config, plan)
        return x + mlp_out, aux
    h = collectives.all_reduce_grad(h, tp)
    # jax.nn.gelu's default is the tanh approximation.
    hidden = F.gelu(h @ p["w_up"].to(h.dtype), approximate="tanh")
    return x + collectives.all_reduce_value(
        hidden @ p["w_down"].to(h.dtype), tp), None


def _trunk(p, tokens, config: GPTConfig, plan, position_offset: int = 0):
    """The stack on this rank's local params `p` and token rows."""
    c = config
    l = tokens.shape[1]
    x = plan.embed(p["tok_embed"], tokens, c.dtype)
    start = position_offset + plan.position_offset(l)
    pos = p["pos_embed"][start:start + l]
    x = x + pos[None].to(c.dtype)
    # One unbind per leaf: its backward stacks the per-layer gradients
    # into one tensor, as lax.scan's does, where indexing a layer per
    # block would add a zero-padded gradient of the whole stack per layer.
    layers = {k: v.unbind(0) for k, v in p["blocks"].items()}
    auxes = []
    for layer in range(c.n_layers):
        own = {k: v[layer] for k, v in layers.items()}
        if c.remat:
            # The gathers inside the recomputed block (the module
            # docstring of models/_functional.py).
            x, aux = torch.utils.checkpoint.checkpoint(
                _gathered_block, x, own, c, plan, use_reentrant=False)
        else:
            x, aux = _block(x, _functional.gather_layer(own, plan), c,
                            plan)
        if aux is not None:
            auxes.append(aux)
    x = _layernorm(x, plan.leaf(p["final_ln_scale"], "final_ln_scale"),
                   plan.leaf(p["final_ln_bias"], "final_ln_bias"))
    aux = torch.stack(auxes).sum() if auxes else torch.zeros(
        (), dtype=torch.float32, device=x.device)
    return x, aux


def _gathered_block(x, own, config: GPTConfig, plan):
    """`_block` on the rank's own slices `own` of a layer's leaves,
    gathered over fsdp inside (`plan.layer`)."""
    return _block(x, _functional.gather_layer(own, plan), config, plan)


def forward_trunk(params: dict, tokens: torch.Tensor, config: GPTConfig,
                  mesh=None, position_offset: int = 0):
    """Transformer stack up to (excluding) the lm head.
    tokens [B, L] -> (x [B, L, D], moe_aux_loss f32 scalar summed over
    the layers, as the reference's `jnp.sum(auxes)`; 0 for a dense MLP).
    Under a mesh, x is this rank's rows.

    position_offset shifts the learned position table: a suffix call at
    absolute position p reads pos_embed[p:p+l].  With `config.remat` each
    block is recomputed in the backward (non-reentrant checkpoint), so
    its flash forward runs twice per step."""
    plan = _plan(config, mesh, tokens.shape)
    return _trunk(plan.local(params), plan.rows(tokens), config, plan,
                  position_offset)


def _head(p, config: GPTConfig, plan):
    """The lm head [D, V] (under a mesh, this tensor rank's vocab
    slice) in the activation dtype."""
    if config.tie_embeddings:
        return plan.leaf(p["tok_embed"], "tok_embed").T.to(config.dtype)
    return plan.leaf(p["lm_head"], "lm_head").to(config.dtype)


def forward(params: dict, tokens: torch.Tensor, config: GPTConfig,
            mesh=None, position_offset: int = 0):
    """tokens [B, L] -> (logits [B, L, V], moe_aux_loss scalar); under a
    mesh, this rank's rows (padded, `MeshPlan.rows`) and vocab slice of
    the logits."""
    plan = _plan(config, mesh, tokens.shape)
    p = plan.local(params)
    x, aux = _trunk(p, plan.rows(tokens), config, plan, position_offset)
    return x @ _head(p, config, plan), aux


def loss_fn(params: dict, batch: dict, config: GPTConfig, mesh=None):
    """batch = {"tokens": [B, L], optional "loss_mask": [B, L]} ->
    next-token cross-entropy (f32 scalar).

    As in the reference, the model runs on the full length and the
    targets are the tokens rolled left by one; the last position, which
    would predict the rolled-around token 0, is always masked (under
    seq the last local position of every other seq rank predicts the
    next rank's first token: `plan.targets`).  The loss is the fused
    chunked cross-entropy on the (tied) head, which never materialises
    [B, L, V], plus the reference's `0.01 * aux` (the MoE
    load-balancing loss summed over layers; 0 for a dense MLP).  Under a
    mesh it is the vocab-parallel `fused_cross_entropy_spmd` on this
    rank's rows and vocab slice, equal on every rank.  Rows that the
    row ranks do not divide are padded and their pads masked
    (`MeshPlan.rows`, `MeshPlan.targets`): the loss is the global mean
    over the real tokens, the function of the reference's fallback to
    materialised logits (`spmd_ce_applicable` false).  Under seq above
    1 an uneven batch raises ValueError, as the reference's ring does
    (`_functional.check_mesh_rows`)."""
    c = config
    plan = _plan(c, mesh, batch["tokens"].shape)
    tokens = plan.rows(batch["tokens"])
    targets, valid = plan.targets(tokens)
    mask = batch.get("loss_mask")
    if mask is not None:
        valid = valid * plan.rows(mask)
    p = plan.local(params)
    x, aux = _trunk(p, tokens, c, plan)
    head = _head(p, c, plan)
    if plan is not _functional.ONE_DEVICE:
        return fused_cross_entropy_spmd(x, head, targets, valid,
                                        mesh) + 0.01 * aux
    b, l, d = x.shape
    loss = fused_cross_entropy(x.reshape(b * l, d), head,
                               targets.reshape(-1), valid.reshape(-1))
    return loss + 0.01 * aux


def make_train_step(config: GPTConfig, optimizer, mesh=None, *,
                    device: DeviceLike = None):
    """Returns (init_state, train_step), the shared functional-LM
    contract (models/_functional.py), on `device` (None -> CUDA).  Under
    a mesh the params and AdamW's moments are DTensors placed by
    `param_specs`."""
    return _functional.make_train_step(config, optimizer,
                                       init_params=init_params,
                                       loss_fn=loss_fn, device=device,
                                       mesh=mesh, param_specs=param_specs)


def _block_cached(x, p, k_pool, v_pool, config: GPTConfig, block_tables,
                  positions, valid, ctx_lens):
    """One transformer block over a paged KV cache: new K/V are scattered
    into this layer's pool slice (in place), then attention runs over the
    block table (ops/attention.py paged path).  x [B, T, D]; positions
    [B, T] absolute; ctx_lens [B] = context length including this slice."""
    b, t, d = x.shape
    nh, dh = config.n_heads, config.head_dim
    h = _layernorm(x, p["ln1_scale"], p["ln1_bias"])

    def heads(w):                    # "bld,dhk->blhk"
        return (h @ w.reshape(d, nh * dh).to(h.dtype)).view(b, t, nh, dh)

    q, k, v = heads(p["wq"]), heads(p["wk"]), heads(p["wv"])
    paged_kv_update(k_pool, v_pool, k, v, block_tables, positions, valid)
    attn = paged_attention(q, k_pool, v_pool, block_tables, ctx_lens,
                           positions)
    x = x + attn.reshape(b, t, nh * dh) @ p["wo"].reshape(nh * dh, d).to(
        h.dtype)

    h = _layernorm(x, p["ln2_scale"], p["ln2_bias"])
    # jax.nn.gelu's default is the tanh approximation.
    hidden = F.gelu(h @ p["w_up"].to(h.dtype), approximate="tanh")
    x = x + hidden @ p["w_down"].to(h.dtype)
    return x, k_pool, v_pool


def forward_cached(params: dict, tokens: torch.Tensor,
                   positions: torch.Tensor, valid: torch.Tensor,
                   k_pool: torch.Tensor, v_pool: torch.Tensor,
                   block_tables: torch.Tensor, ctx_lens: torch.Tensor,
                   config: GPTConfig):
    """Cached (incremental) trunk for autoregressive decode/prefill.

    tokens [B, T] is a SLICE of each lane's sequence at absolute
    `positions` [B, T] (per-lane offsets); K/V for the slice are written
    IN PLACE into the paged pools [n_layers, NB, BS, H, D] and attention
    covers each lane's whole block table.  `valid` masks padding
    lanes/overhang (their cache writes are dropped).  Returns
    (x [B, T, D], k_pool, v_pool) — the pools are the tensors passed in;
    the lm head is applied by the caller on the positions it needs.

    Dense-MLP configs only (n_experts == 0), as in the reference."""
    c = config
    if c.n_experts:
        raise NotImplementedError("cached decode supports dense MLP only")
    pos = positions.clamp(0, c.max_seq_len - 1).long()
    x = params["tok_embed"][tokens.long()].to(c.dtype)
    x = x + params["pos_embed"][pos].to(c.dtype)
    blocks = params["blocks"]
    for layer in range(c.n_layers):
        p = {k: v[layer] for k, v in blocks.items()}
        x, _, _ = _block_cached(x, p, k_pool[layer], v_pool[layer], c,
                                block_tables, positions, valid, ctx_lens)
    x = _layernorm(x, params["final_ln_scale"], params["final_ln_bias"])
    return x, k_pool, v_pool
