"""A plain PyTorch reference of the Llama architecture in float32, the
family side of the benchmark's contract for a family added as files
(`test_bench_families.py` copies it into a test root as
`references/llama_plain.py`).  It serves only: `program_config`,
`draw_params`, `served_gaps` and `tiny_run`.

The block: RMSNorm, grouped-query causal attention (each kv head
serving n_heads / n_kv_heads query heads) with rotary position
embeddings in rotate-half pairing (frequencies theta^(-i / half)), a
residual, RMSNorm, a SwiGLU MLP (silu(h W_gate) * (h W_up) W_down), a
residual; a final RMSNorm and an untied head.  No linear layer has a
bias.  Attention is materialised and masked.  It imports nothing of the
program.
"""

from __future__ import annotations

import math
from typing import Callable, List, Optional

import torch
import torch.nn.functional as F

from benchmark import weights
from benchmark.train_reference import configure

TINY = dict(vocab_size=512, n_layers=2, d_model=64, n_heads=4,
            n_kv_heads=2, d_ff=128, max_seq_len=256)

PROGRAM_FIELDS = ("vocab_size", "n_layers", "d_model", "n_heads",
                  "n_kv_heads", "d_ff", "max_seq_len", "rope_theta",
                  "norm_eps")

NORMS = ("blocks/attn_norm", "blocks/mlp_norm", "final_norm")
MATMUL_LEAVES = ("tok_embed", "blocks/wq", "blocks/wk", "blocks/wv",
                 "blocks/wo", "blocks/w_gate", "blocks/w_up",
                 "blocks/w_down", "lm_head")


def program_config(run: dict, **overrides) -> dict:
    return dict({k: run[k] for k in PROGRAM_FIELDS},
                dtype=getattr(torch, run["dtype"]), **overrides)


def tiny_run(run: dict) -> dict:
    return dict(run, **TINY)


def leaf_specs(run: dict) -> weights.LeafSpecs:
    """{path: (shape, std)}; the norm scales (std None) are ones."""
    n, d, h, kh, f = (run["n_layers"], run["d_model"], run["n_heads"],
                      run["n_kv_heads"], run["d_ff"])
    dh = d // h
    std, resid = 0.02, 0.02 / math.sqrt(2 * n)
    return {
        "blocks/attn_norm": ((n, d), None),
        "blocks/wq": ((n, d, h, dh), std), "blocks/wk": ((n, d, kh, dh), std),
        "blocks/wv": ((n, d, kh, dh), std), "blocks/wo": ((n, h, dh, d), resid),
        "blocks/mlp_norm": ((n, d), None),
        "blocks/w_gate": ((n, d, f), std), "blocks/w_up": ((n, d, f), std),
        "blocks/w_down": ((n, f, d), resid),
        "tok_embed": ((run["vocab_size"], d), std),
        "final_norm": ((d,), None),
        "lm_head": ((d, run["vocab_size"]), std),
    }


def draw_params(run: dict, seed: int, device, matmul_dtype=torch.float32,
                keep: Optional[Callable] = None) -> dict:
    def ones(path, t):
        if path in NORMS:
            t.fill_(1.0)
        return t if keep is None else keep(path, t)
    return weights.draw_params(leaf_specs(run), MATMUL_LEAVES, seed, device,
                               matmul_dtype=matmul_dtype, keep=ones)


def _rms(x, scale, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def _rope(x, theta: float):
    """x [B, L, H, K] rotated at positions 0 .. L - 1."""
    l, half = x.shape[1], x.shape[-1] // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = torch.arange(l, dtype=torch.float32, device=x.device)[:, None] \
        * freqs
    cos, sin = torch.cos(ang)[None, :, None], torch.sin(ang)[None, :, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _block(x, p: dict, run: dict):
    b, l, d = x.shape
    nh, kh = run["n_heads"], run["n_kv_heads"]
    dh = d // nh
    h = _rms(x, p["attn_norm"], run["norm_eps"])
    q = _rope((h @ p["wq"].reshape(d, -1)).view(b, l, nh, dh),
              run["rope_theta"])
    k = _rope((h @ p["wk"].reshape(d, -1)).view(b, l, kh, dh),
              run["rope_theta"])
    v = (h @ p["wv"].reshape(d, -1)).view(b, l, kh, dh)
    k = k.repeat_interleave(nh // kh, dim=2).transpose(1, 2)
    v = v.repeat_interleave(nh // kh, dim=2).transpose(1, 2)
    s = q.transpose(1, 2) @ k.transpose(-1, -2) / math.sqrt(dh)
    mask = torch.ones(l, l, dtype=torch.bool, device=x.device).tril()
    a = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1) @ v
    x = x + a.transpose(1, 2).reshape(b, l, nh * dh) @ p["wo"].reshape(
        nh * dh, d)
    h = _rms(x, p["mlp_norm"], run["norm_eps"])
    return x + (F.silu(h @ p["w_gate"]) * (h @ p["w_up"])) @ p["w_down"]


def logits(params: dict, run: dict, tokens: torch.Tensor) -> torch.Tensor:
    x = params["tok_embed"][tokens]
    for i in range(run["n_layers"]):
        x = _block(x, {k: v[i] for k, v in params["blocks"].items()}, run)
    return _rms(x, params["final_norm"], run["norm_eps"]) @ params["lm_head"]


def served_gaps(run: dict, seed: int, sequences: List[tuple], device,
                precision: str = "f32") -> List[float]:
    """Each served token's gap below the best f32 logit at its position,
    on the weights as served (matrices and tables rounded to bf16); f32
    only: this family has no control."""
    if precision != "f32":
        raise ValueError(f"no {precision} reference here")
    configure()
    params = draw_params(run, seed, device, matmul_dtype=torch.bfloat16,
                         keep=lambda path, t: t.float())
    gaps: List[float] = []
    with torch.no_grad():
        for prompt, served in sequences:
            seq = torch.tensor([list(prompt) + list(served)],
                               dtype=torch.int64, device=device)
            start, n = len(prompt) - 1, len(served)
            z = logits(params, run, seq)[0, start:start + n]
            tok = torch.tensor(served, dtype=torch.int64, device=device)
            gaps.extend((z.amax(-1) - z.gather(-1, tok[:, None])[:, 0])
                        .tolist())
    return gaps

