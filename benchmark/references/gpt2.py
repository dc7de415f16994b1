"""Plain PyTorch reference of the GPT-2 architecture, in float32.

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
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from benchmark import weights

FP8_MAX = 448.0


def configure() -> None:
    """Every float32 product in float32 (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


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
    return {k: v[i] for k, v in params["blocks"].items()}


def hidden(params: dict, tokens: torch.Tensor, precision: str = "f32",
           checkpoint: bool = False) -> torch.Tensor:
    """tokens [B, L] -> final-normed hidden states [B, L, D] f32."""
    l = tokens.shape[1]
    x = params["tok_embed"][tokens] + params["pos_embed"][:l][None]
    for i in range(params["blocks"]["wq"].shape[0]):
        if checkpoint:
            x = torch.utils.checkpoint.checkpoint(
                block, x, _layer(params, i), precision, use_reentrant=False)
        else:
            x = block(x, _layer(params, i), precision)
    return _ln(x, params["final_ln_scale"], params["final_ln_bias"])


def logits(params: dict, x: torch.Tensor, precision: str = "f32"):
    return _mm(x, params["tok_embed"].T, precision)


def f32_params(cfg: dict, seed: int, device, matmul_dtype=torch.float32,
               requires_grad: bool = False) -> dict:
    """The run's weights, drawn from the seed as the benchmark hands them
    to the program (matrix leaves in `matmul_dtype`), held in f32."""
    def keep(path, t):
        return t.float().requires_grad_(requires_grad)
    return weights.draw_params(cfg, seed, device, matmul_dtype=matmul_dtype,
                               keep=keep)


def _leaves(tree: dict, prefix: str = "") -> Dict[str, torch.Tensor]:
    out = {}
    for k, v in tree.items():
        path = f"{prefix}{k}"
        out.update(_leaves(v, path + "/") if isinstance(v, dict)
                   else {path: v})
    return out


def loss_and_grads(params: dict, tokens: torch.Tensor, precision: str,
                   rows_per_pass: int) -> float:
    """Next-token cross-entropy over tokens [B, L] (the last position
    predicts nothing), the mean over B x (L - 1) targets, its gradient
    accumulated into each leaf's .grad, `rows_per_pass` rows at a time
    with each block recomputed in the backward, so that it fits."""
    b, l = tokens.shape
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


# The change after the checked steps is compared on the elements whose
# f32 first gradient is at least this share of the root mean square of
# its leaf's (of its layer's, in a stacked leaf): AdamW scales each
# element's step by that element's own gradient, so an element whose
# gradient lies at the rounding noise of a bf16 backward takes a
# full-size step whose sign the rounding decides.
CHANGE_KEEP = 0.1


def change_kept(g: torch.Tensor, stacked: bool) -> torch.Tensor:
    """The elements of a leaf whose change is compared, by its first
    gradient `g` (a stacked leaf: [layers, ...], by layer)."""
    dims = tuple(range(1 if stacked else 0, g.dim()))
    rms = g.square().mean(dim=dims, keepdim=True).sqrt() if dims else g.abs()
    return g.abs() >= CHANGE_KEEP * rms


def train_readings(cfg: dict, seed: int, batches: List[torch.Tensor],
                   hp: dict, device, precision: str = "f32",
                   rows_per_pass: int = 1, judged: dict = None,
                   keep: bool = False, kept_by: dict = None) -> dict:
    """AdamW steps from the run's weights, one on each of `batches`,
    with AdamW written out (decoupled decay, bias-corrected moments, eps
    outside the root).  Returns each step's loss, and by leaf path the
    norm of the first gradient, of the parameter's change after the
    last step, and of that change on the elements kept by
    `change_kept` ("change_kept_norms"), the elements chosen by the
    first gradients of `kept_by` (host tensors by leaf path) or, by
    default, by this side's own.  `judged` (another side's
    "first_grads" and "changes", host tensors by leaf path) adds the
    norms of their differences from these ("grad_diff_norms", and
    "change_diff_norms" on the kept elements); `keep` returns this
    side's own, copied to the host."""
    configure()
    params = f32_params(cfg, seed, device, requires_grad=True)
    flat = _leaves(params)
    m = {k: torch.zeros_like(v) for k, v in flat.items()}
    v2 = {k: torch.zeros_like(v) for k, v in flat.items()}
    kept = {}
    b1, b2, lr, eps, wd = hp["b1"], hp["b2"], hp["lr"], hp["eps"], hp["wd"]
    out = {"losses": [], "grad_norms": {}, "change_norms": {},
           "change_kept_norms": {}}
    if judged is not None:
        out.update(grad_diff_norms={}, change_diff_norms={})
    if keep:
        out.update(first_grads={}, changes={})
    for step, tokens in enumerate(batches, start=1):
        out["losses"].append(loss_and_grads(params, tokens, precision,
                                            rows_per_pass))
        with torch.no_grad():
            for k, p in flat.items():
                g = p.grad
                if step == 1:
                    out["grad_norms"][k] = float(g.norm())
                    if judged is not None:
                        out["grad_diff_norms"][k] = float(
                            (judged["first_grads"][k].to(device) - g).norm())
                    if keep:
                        out["first_grads"][k] = g.cpu()
                    by = g if kept_by is None else kept_by[k].to(device)
                    kept[k] = change_kept(by, k.startswith("blocks/"))
                    del by
                p.mul_(1 - lr * wd)
                m[k].mul_(b1).add_(g, alpha=1 - b1)
                v2[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                mhat = m[k] / (1 - b1 ** step)
                vhat = v2[k] / (1 - b2 ** step)
                p.sub_(lr * mhat / (vhat.sqrt() + eps))
                p.grad = None
    del m, v2
    with torch.no_grad():
        for k, p in flat.items():
            change = p - weights.draw_leaf(cfg, seed, k, device)
            out["change_norms"][k] = float(change.norm())
            out["change_kept_norms"][k] = float(change[kept[k]].norm())
            if judged is not None:
                out["change_diff_norms"][k] = float(
                    (judged["changes"][k].to(device) - change)[kept[k]]
                    .norm())
            if keep:
                out["changes"][k] = change.cpu()
    return out


def served_gaps(cfg: dict, seed: int, sequences: List[tuple], device,
                precision: str = "f32") -> List[float]:
    """For each (prompt, served tokens): the f32 reference runs once over
    prompt + served tokens, and each served token's gap is the f32 best
    logit at its position minus the f32 logit of the token, taken at
    every served position.  With precision "fp8" the token read is the
    one that the fp8 forward puts first at that position (the control),
    not the served one.  Returns the gaps of all served positions."""
    configure()
    params = f32_params(cfg, seed, device, matmul_dtype=torch.bfloat16)
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
