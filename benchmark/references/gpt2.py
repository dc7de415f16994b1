"""Plain PyTorch reference of the GPT-2 architecture, in float32, and
the GPT family's side of the benchmark's family contract (the module
docstring of `benchmark/harness.py`): the program's configuration
fields, the weights' layout, the CPU tests' sizes.

It follows the published GPT-2 block: pre-LayerNorm (eps 1e-5),
multi-head causal self-attention with a softmax over q.k / sqrt(head
dim), a residual, LayerNorm, an MLP of width d_ff with GPT-2's tanh GELU
(`gelu_new`), a residual; a final LayerNorm and a head tied to the token
table.  No linear layer has a bias (the configurations' `departures`).
Attention is materialised and masked, with no kernel, cache or batching
of the program, and TF32 is switched off, so every product runs in
float32.  It imports nothing of the program.

`precision="fp8"` is the control: every matrix product (the four
projections, the MLP's two, the head, and attention's Q.K and P.V)
takes its operands rounded to float8 e4m3 (a per-tensor scale mapping
the largest |value| to 448) in the forward; everything else stays f32.

The weights' layout is the port's GPT family's stacked one: the layers
on a leading dim, `wq/wk/wv [n, d, h, dh]`, `wo [n, h, dh, d]`, `w_up
[n, d, f]`, `w_down [n, f, d]`, a tied embedding.  The scales are
GPT-2's published init: N(0, 0.02) for every matrix and the token
table, 0.02 / sqrt(2 n) for the residual projections (wo, w_down),
N(0, 0.01) for the position table, LayerNorm scale 1 and bias 0.
"""

from __future__ import annotations

import functools
import math
from typing import Callable, Dict, List, Optional

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from benchmark import flops, train_reference, weights
from benchmark.train_reference import configure

FP8_MAX = 448.0


def _fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under a per-tensor scale, back in f32;
    the gradient passes straight through."""
    scale = x.detach().abs().amax().clamp_min(1e-30) / FP8_MAX
    q = (x.detach() / scale).to(torch.float8_e4m3fn).float() * scale
    return x + (q - x.detach())


def _mm(a, b, precision: str):
    if precision == "fp8":
        a, b = _fp8(a), _fp8(b)
    return a @ b


def _ln(x, scale, bias, eps=1e-5):
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).square().mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * scale + bias


def block(x, p: dict, precision: str = "f32"):
    """One block on x [B, L, D] f32; p holds one layer's leaves."""
    b, l, d = x.shape
    nh, dh = p["wq"].shape[1], p["wq"].shape[2]
    h = _ln(x, p["ln1_scale"], p["ln1_bias"])

    def heads(w):
        return _mm(h, w.reshape(d, nh * dh), precision).view(
            b, l, nh, dh).transpose(1, 2)                    # [B, H, L, dh]

    q, k, v = heads(p["wq"]), heads(p["wk"]), heads(p["wv"])
    s = _mm(q, k.transpose(-1, -2), precision) / math.sqrt(dh)
    mask = torch.ones(l, l, dtype=torch.bool, device=x.device).tril()
    s = s.masked_fill(~mask, float("-inf"))
    a = _mm(torch.softmax(s, dim=-1), v, precision)          # [B, H, L, dh]
    a = a.transpose(1, 2).reshape(b, l, nh * dh)
    x = x + _mm(a, p["wo"].reshape(nh * dh, d), precision)
    h = _ln(x, p["ln2_scale"], p["ln2_bias"])
    u = F.gelu(_mm(h, p["w_up"], precision), approximate="tanh")
    return x + _mm(u, p["w_down"], precision)


def _layer(params: dict, i: int) -> dict:
    """Layer i's leaves (a stacked leaf is a tensor [layers, ...] or the
    list of its layers)."""
    return {k: v[i] for k, v in params["blocks"].items()}


def hidden(params: dict, tokens: torch.Tensor, precision: str = "f32",
           checkpoint: bool = False) -> torch.Tensor:
    """tokens [B, L] -> final-normed hidden states [B, L, D] f32."""
    l = tokens.shape[1]
    x = params["tok_embed"][tokens] + params["pos_embed"][:l][None]
    for i in range(len(params["blocks"]["wq"])):
        if checkpoint:
            x = torch.utils.checkpoint.checkpoint(
                block, x, _layer(params, i), precision, use_reentrant=False)
        else:
            x = block(x, _layer(params, i), precision)
    return _ln(x, params["final_ln_scale"], params["final_ln_bias"])


def logits(params: dict, x: torch.Tensor, precision: str = "f32"):
    return _mm(x, params["tok_embed"].T, precision)


# The family contract.

TINY = dict(vocab_size=512, n_layers=2, d_model=128, n_heads=2, d_ff=256,
            max_seq_len=256)

PROGRAM_FIELDS = ("vocab_size", "n_layers", "d_model", "n_heads", "d_ff",
                  "max_seq_len")

MATMUL_LEAVES = ("tok_embed", "pos_embed", "blocks/wq", "blocks/wk",
                 "blocks/wv", "blocks/wo", "blocks/w_up", "blocks/w_down")


def program_config(run: dict, **overrides) -> dict:
    """The fields of the port's GPT configuration for a configuration
    file's `run` block, as run (the driver builds the object; nothing
    here imports the program)."""
    return dict({k: run[k] for k in PROGRAM_FIELDS},
                dtype=getattr(torch, run["dtype"]), **overrides)


def tiny_run(run: dict) -> dict:
    """`run` at the CPU tests' sizes."""
    return dict(run, **TINY)


def leaf_specs(run: dict) -> weights.LeafSpecs:
    """{path: (shape, std)}, in the draw order."""
    n, d, h, f = run["n_layers"], run["d_model"], run["n_heads"], run["d_ff"]
    dh = d // h
    resid = 0.02 / math.sqrt(2 * n)
    return {
        "blocks/ln1_scale": ((n, d), None), "blocks/ln1_bias": ((n, d), None),
        "blocks/wq": ((n, d, h, dh), 0.02), "blocks/wk": ((n, d, h, dh), 0.02),
        "blocks/wv": ((n, d, h, dh), 0.02), "blocks/wo": ((n, h, dh, d), resid),
        "blocks/ln2_scale": ((n, d), None), "blocks/ln2_bias": ((n, d), None),
        "blocks/w_up": ((n, d, f), 0.02), "blocks/w_down": ((n, f, d), resid),
        "tok_embed": ((run["vocab_size"], d), 0.02),
        "pos_embed": ((run["max_seq_len"], d), 0.01),
        "final_ln_scale": ((d,), None), "final_ln_bias": ((d,), None),
    }


def draw_params(run: dict, seed: int, device, matmul_dtype=torch.float32,
                keep: Optional[Callable] = None) -> dict:
    """The run's weights drawn from the seed (`weights.draw_params`):
    matrices and tables in `matmul_dtype`, LayerNorm leaves f32."""
    return weights.draw_params(leaf_specs(run), MATMUL_LEAVES, seed, device,
                               matmul_dtype=matmul_dtype, keep=keep)


def train_flops(run: dict, rows: int, length: int) -> float:
    """Model FLOPs of one training step (`flops.train_step_flops`)."""
    return flops.train_step_flops(run, rows, length)


def f32_params(run: dict, seed: int, device, matmul_dtype=torch.float32,
               requires_grad: bool = False) -> dict:
    """The run's weights, drawn from the seed as the benchmark hands them
    to the program (matrix leaves in `matmul_dtype`), held in f32."""
    def keep(path, t):
        return t.float().requires_grad_(requires_grad)
    return draw_params(run, seed, device, matmul_dtype=matmul_dtype,
                       keep=keep)


def _leaves(tree: dict, prefix: str = "") -> Dict[str, torch.Tensor]:
    out = {}
    for k, v in tree.items():
        path = f"{prefix}{k}"
        out.update(_leaves(v, path + "/") if isinstance(v, dict)
                   else {path: v})
    return out


def loss_and_grads(params: dict, tokens: torch.Tensor, precision: str,
                   rows_per_pass: int, n_targets: int = None) -> float:
    """Next-token cross-entropy over tokens [B, L] (the last position
    predicts nothing), summed and divided by `n_targets` (default B x
    (L - 1), the mean), its gradient accumulated into each leaf's .grad,
    `rows_per_pass` rows at a time with each block recomputed in the
    backward, so that it fits."""
    b, l = tokens.shape
    if n_targets is None:
        n_targets = b * (l - 1)
    total = 0.0
    for r in range(0, b, rows_per_pass):
        rows = tokens[r:r + rows_per_pass]
        x = hidden(params, rows, precision, checkpoint=True)
        z = logits(params, x[:, :-1], precision)
        nll = F.cross_entropy(z.reshape(-1, z.shape[-1]),
                              rows[:, 1:].reshape(-1), reduction="sum")
        (nll / n_targets).backward()
        total += float(nll.detach()) / n_targets
    return total


def train_readings(run: dict, seed: int, batches: List[torch.Tensor],
                   hp: dict, device, **how) -> dict:
    """`train_reference.readings` on this family's weights and loss: the
    plain AdamW steps from the run's weights, one on each of `batches`
    (`how`: precision, rows_per_pass, judged, keep, kept_by, parts)."""
    return train_reference.readings(
        functools.partial(draw_params, run, seed), loss_and_grads,
        batches, hp, device, **how)


def served_gaps(run: dict, seed: int, sequences: List[tuple], device,
                precision: str = "f32") -> List[float]:
    """For each (prompt, served tokens): the f32 reference runs once over
    prompt + served tokens, and each served token's gap is the f32 best
    logit at its position minus the f32 logit of the token, taken at
    every served position.  With precision "fp8" the token read is the
    one that the fp8 forward puts first at that position (the control),
    not the served one.  Returns the gaps of all served positions."""
    configure()
    params = f32_params(run, seed, device, matmul_dtype=torch.bfloat16)
    gaps: List[float] = []
    with torch.no_grad():
        for prompt, served in sequences:
            seq = torch.tensor([list(prompt) + list(served)],
                               dtype=torch.int64, device=device)
            n = len(served)
            start = len(prompt) - 1
            ref = logits(params, hidden(params, seq)[0, start:start + n])
            if precision == "f32":
                tok = torch.tensor(served, dtype=torch.int64, device=device)
            else:
                low = logits(params, hidden(params, seq, precision)[
                    0, start:start + n], precision)
                tok = low.argmax(-1)
            gap = ref.amax(-1) - ref.gather(-1, tok[:, None])[:, 0]
            gaps.extend(gap.tolist())
    return gaps
