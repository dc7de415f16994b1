"""The yardstick's arithmetic: the peaks of one NVIDIA H100 SXM, the
model FLOPs of the GPT-2 architecture, and the least time of each
kernel's work (its roofline bound) from the shapes of its call.

Peaks are NVIDIA's data sheet, dense, at the full 700 W.  A bound is
max(FLOPs / peak, bytes / bandwidth), each input read once and each
output written once, whatever the kernel reads again.  The bounds of
K1-K3 (flash forward, dq, dk/dv) and K4 (paged decode) are frozen
copies of the bring-up smoke script's `_flash_bounds` and
`_decode_bound`, written over plain numbers so that nothing here
imports the program.
"""

from __future__ import annotations

PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
HBM_BYTES_PER_S = 3.35e12
DTYPE_BYTES = {"bfloat16": 2, "float32": 4}


def matmul_params(cfg: dict) -> int:
    """Weights that enter a matrix product once per token: per layer the
    q, k, v and output projections and the two MLP matrices, and the
    head (the tied embedding, d x vocab).  The embedding lookups, the
    norms and the position table are not products."""
    d, f = cfg["d_model"], cfg["d_ff"]
    return cfg["n_layers"] * (4 * d * d + 2 * d * f) + d * cfg["vocab_size"]


def causal_pairs(length: int) -> int:
    """(query, key) pairs that causal attention computes in one row of
    `length` positions."""
    return length * (length + 1) // 2


def train_step_flops(cfg: dict, rows: int, length: int) -> float:
    """Model FLOPs of one training step on `rows` x `length` tokens:
    every matrix product from its shapes (2 per multiply-add), forward
    and backward (twice the forward), plus causal attention's two
    products (Q.K and P.V, 2 x 2 x head_dim per pair per head) forward
    and backward.  A recompute (remat) is not counted."""
    tokens = rows * length
    dense = 6 * matmul_params(cfg) * tokens
    attn = 3 * 4 * cfg["d_model"] * causal_pairs(length) * rows \
        * cfg["n_layers"]
    return float(dense + attn)


def token_flops(cfg: dict, position: int, head: bool) -> float:
    """Forward FLOPs of one token at 0-based `position` in a served
    sequence: the block products, attention over its position + 1 keys,
    and the head when the token's logits are computed."""
    d, f, n = cfg["d_model"], cfg["d_ff"], cfg["n_layers"]
    blocks = 2 * n * (4 * d * d + 2 * d * f)
    attn = 4 * d * (position + 1) * n
    return float(blocks + attn + (2 * d * cfg["vocab_size"] if head else 0))


def flash_bounds(b: int, length: int, heads: int, head_dim: int,
                 dtype: str, causal: bool = True) -> dict:
    """Least seconds of K1, K2 and K3 at one call [b, length, heads,
    head_dim] (square, causal): bytes of q, k, v, o, do, dq, dk, dv and
    the f32 LSE / delta rows, each once; 2 flops per multiply-add of
    their products over the visible pairs (K1: S and PV; K2: S, dP and
    dQ; K3: S, dP, dV and dK)."""
    sz = DTYPE_BYTES[dtype]
    pairs = b * heads * (causal_pairs(length) if causal else length * length)
    row = b * length * heads * head_dim * sz
    lens = b * heads * length * 4
    work = {"K1": (4 * row + lens, 4 * head_dim * pairs),
            "K2": (6 * row + 2 * lens, 6 * head_dim * pairs),
            "K3": (6 * row + 2 * lens, 8 * head_dim * pairs)}
    return {k: max(nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype])
            for k, (nbytes, flops) in work.items()}


def decode_bound(ctx_lens, heads: int, kv_heads: int, head_dim: int,
                 block_size: int, dtype: str) -> float:
    """Least seconds of one K4 call over lanes with context lengths
    `ctx_lens` (every lane of the call, masked ones included): each
    context position's K and V row read once, q read and the output
    written once, the table entries it reads and ctx_lens; or its QK and
    PV flops at the peak, whichever is longer."""
    sz = DTYPE_BYTES[dtype]
    total = sum(ctx_lens)
    lanes = len(ctx_lens)
    kv_bytes = total * kv_heads * head_dim * 2 * sz
    table_bytes = sum(-(-c // block_size) for c in ctx_lens) * 4 + lanes * 4
    nbytes = kv_bytes + 2 * lanes * heads * head_dim * sz + table_bytes
    flops = 4 * total * heads * head_dim
    return max(nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype])
