"""The arithmetic of the tensor-core flash kernels, emulated on the CPU.

For bf16 at head dim 64 and 128 the card runs K1 (forward), K2 (dq)
and K3 (dk, dv) of ray_tpu_torch/ops/csrc/flash_attention.cu on the
tensor cores: bf16 operands with f32 sums, P rounded to bf16 before P V
and before P^T dO, dS rounded to bf16 before dS K and dS^T Q, and l
summed from the f32 P, over 64-column kv tiles with an online softmax.  No CUDA kernel
runs here, so this file keeps a plain-torch emulation of that
arithmetic (it is not part of the package) and holds it to
`TENSOR_CORE_TOLERANCE` against the f32 plain versions that chip_smoke.py
compares the kernels with, and against the JAX package's flash attention
(Pallas in interpret mode).  A causal mask shifted by one position, and
a tile skipped only on late causal rows, must break the tolerance, so it
still catches a wrong mask or a lost tile where the values are small."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops import attention as jattn
from ray_tpu_torch.ops import attention as tattn

# Tiny tensors: one thread each keeps the parallel test workers from
# oversubscribing the host's cores.
torch.set_num_threads(1)

torch.backends.cuda.matmul.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

TILE = 64                      # kv columns per tile of K1 on the card
LSE_TOL = dict(atol=1e-4, rtol=1e-4)

# blocks: the JAX side's (block_q, block_k), which must tile the lengths
# so that it runs its Pallas kernels and not its bf16 XLA fallback.
CASES = {
    "causal-256-d64": dict(b=2, lq=256, lk=256, h=2, d=64, causal=True,
                           blocks=(128, 128)),
    "causal-256-d128": dict(b=1, lq=256, lk=256, h=2, d=128, causal=True,
                            blocks=(128, 128)),
    "full-100x200-d64": dict(b=2, lq=100, lk=200, h=2, d=64, causal=False,
                             blocks=(100, 200)),
}


def _inputs(seed, c):
    """q, k, v, dO as bf16 torch tensors from a numpy seed."""
    rng = np.random.default_rng(seed)
    shapes = [(c["b"], c["lq"], c["h"], c["d"]),
              (c["b"], c["lk"], c["h"], c["d"]),
              (c["b"], c["lk"], c["h"], c["d"]),
              (c["b"], c["lq"], c["h"], c["d"])]
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(
        torch.bfloat16) for s in shapes]


def _f32(x):
    return x.float().transpose(1, 2)                  # [B, H, L, D] f32


def _rnd(x):
    return x.to(torch.bfloat16).float()


def _visible(lq, lk, causal, shift, drop=None):
    """Top-left causal visibility, moved `shift` positions to the right,
    without the (q, kv) pairs that `drop` marks."""
    vis = ((torch.arange(lq)[:, None] + shift) >= torch.arange(lk)[None, :]
           if causal else torch.ones(lq, lk, dtype=torch.bool))
    return vis if drop is None else vis & ~drop


def emulated_forward(q, k, v, causal, scale, shift=0, drop=None):
    """K1 on the tensor cores: S = Q K^T from bf16 operands with f32 sums,
    an online softmax over 64-column kv tiles, l summed from the f32 P,
    and P rounded to bf16 before P V.  (O bf16 [B, L, H, D], LSE f32
    [B, H, L])."""
    s = (_f32(q) @ _f32(k).transpose(-1, -2)) * scale
    s = s.masked_fill(~_visible(q.shape[1], k.shape[1], causal, shift, drop),
                      -float("inf"))
    vf = _f32(v)
    m = torch.full(s.shape[:-1], -float("inf"))
    l = torch.zeros(s.shape[:-1])
    acc = torch.zeros(*s.shape[:-1], vf.shape[-1])
    for k0 in range(0, s.shape[-1], TILE):
        blk = s[..., k0:k0 + TILE]
        m_new = torch.maximum(m, blk.amax(-1))
        m_use = torch.where(m_new == -float("inf"), 0.0, m_new)
        alpha = torch.exp(m - m_use)
        p = torch.exp(blk - m_use[..., None])
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + _rnd(p) @ vf[..., k0:k0 + TILE, :]
        m = m_new
    l_safe = l.clamp_min(1e-30)
    out = acc / l_safe[..., None]
    return out.transpose(1, 2).to(q.dtype), m + torch.log(l_safe)


def emulated_dq(q, k, v, out, dout, lse, causal, scale, shift=0,
                drop=None):
    """K2 on the tensor cores: delta = rowsum(dO O) and P = exp(S scale -
    LSE) in f32, dP = dO V^T with f32 sums, dS = P (dP - delta) rounded to
    bf16 before dQ = bf16(dS) K * scale.  (dq bf16 [B, L, H, D], delta f32
    [B, H, L])."""
    do = _f32(dout)
    delta = (do * _f32(out)).sum(-1)
    p = torch.exp((_f32(q) @ _f32(k).transpose(-1, -2)) * scale
                  - lse[..., None])
    p = p.masked_fill(~_visible(q.shape[1], k.shape[1], causal, shift, drop),
                      0.0)
    ds = p * (do @ _f32(v).transpose(-1, -2) - delta[..., None])
    dq = (_rnd(ds) @ _f32(k)) * scale
    return dq.transpose(1, 2).to(q.dtype), delta


def emulated_dkv(q, k, v, dout, lse, delta, causal, scale, shift=0,
                 drop=None):
    """K3 on the tensor cores: P^T = exp(S^T scale - LSE) in f32, dV =
    bf16(P)^T dO, dS = P (dO V^T - delta), dK = bf16(dS)^T Q * scale.
    (dk, dv) bf16 [B, L, H, D]."""
    qf, do = _f32(q), _f32(dout)
    p = torch.exp((qf @ _f32(k).transpose(-1, -2)) * scale - lse[..., None])
    p = p.masked_fill(~_visible(q.shape[1], k.shape[1], causal, shift, drop),
                      0.0)
    dv = _rnd(p).transpose(-1, -2) @ do
    ds = p * (do @ _f32(v).transpose(-1, -2) - delta[..., None])
    dk = (_rnd(ds).transpose(-1, -2) @ qf) * scale
    return dk.transpose(1, 2).to(k.dtype), dv.transpose(1, 2).to(v.dtype)


def tc_error(got, want, what):
    """The share of tensor_core_limit that got's worst entry uses (<= 1
    passes)."""
    err = (got.float() - want.float()).abs()
    limit = tattn.tensor_core_limit(want, what)
    return float((err / limit.clamp_min(1e-30)).max())


def _plain(q, k, v, dout, causal, scale):
    """The f32 plain versions of K1, K2 and K3, chained as on the card."""
    out, lse = tattn.flash_forward_plain(q, k, v, causal, scale)
    dq, delta = tattn.flash_dq_plain(q, k, v, out, lse, dout, causal, scale)
    dk, dv = tattn.flash_dkv_plain(q, k, v, dout, lse, delta, causal, scale)
    return out, lse, dq, delta, dk, dv


@pytest.mark.parametrize("name", list(CASES))
def test_emulation_within_tolerance_of_plain_versions(name):
    c = CASES[name]
    q, k, v, do = _inputs(10, c)
    scale = c["d"] ** -0.5
    out, lse, dq, delta, dk, dv = _plain(q, k, v, do, c["causal"], scale)
    e_out, e_lse = emulated_forward(q, k, v, c["causal"], scale)
    torch.testing.assert_close(e_lse, lse, **LSE_TOL)
    e_dq, e_delta = emulated_dq(q, k, v, out, do, lse, c["causal"], scale)
    torch.testing.assert_close(e_delta, delta, **LSE_TOL)
    e_dk, e_dv = emulated_dkv(q, k, v, do, lse, delta, c["causal"], scale)
    used = {what: tc_error(got, want, what) for what, got, want in
            (("O", e_out, out), ("dq", e_dq, dq), ("dk", e_dk, dk),
             ("dv", e_dv, dv))}
    assert max(used.values()) <= 1.0, used
    # The rounding of P and dS shows: the emulation is not the plain
    # version rounded to bf16.
    assert not torch.equal(e_dv, dv)


def _jax_flash(q, k, v, g, causal, blocks):
    """The JAX package's flash attention on bf16 inputs, its Pallas
    kernels in interpret mode: O, its LSE [B, H, L] and (dq, dk, dv)
    under cotangent g."""
    args = [jnp.asarray(x.float().numpy(), jnp.bfloat16) for x in (q, k, v)]
    fn = lambda q, k, v: jattn.flash_attention(  # noqa: E731
        q, k, v, causal=causal, block_q=blocks[0], block_k=blocks[1])
    out, vjp = jax.vjp(fn, *args)
    _, lse = jattn._flash_forward_impl(*args, causal, None, *blocks, None)
    assert lse is not None          # the Pallas path, not the fallback
    back = lambda x: torch.from_numpy(  # noqa: E731
        np.array(x.astype(jnp.float32)))
    cot = jnp.asarray(g.float().numpy(), jnp.bfloat16)
    lse = back(lse).reshape(q.shape[0], q.shape[2], q.shape[1])
    return back(out), lse, [back(x) for x in vjp(cot)]


@pytest.mark.parametrize("name", list(CASES))
def test_emulation_within_tolerance_of_jax_flash(name):
    c = CASES[name]
    q, k, v, do = _inputs(11, c)
    scale = c["d"] ** -0.5
    want_out, want_lse, (want_dq, want_dk, want_dv) = _jax_flash(
        q, k, v, do, c["causal"], c["blocks"])
    # As on the card: K3 reads the delta that K2 computed from K1's own O.
    e_out, e_lse = emulated_forward(q, k, v, c["causal"], scale)
    _, delta = emulated_dq(q, k, v, e_out, do, e_lse, c["causal"], scale)
    e_dk, e_dv = emulated_dkv(q, k, v, do, e_lse, delta, c["causal"], scale)
    # K2 on the residuals (O, LSE) that JAX's forward saved, as K2 on the
    # card takes K1's.  (Through delta, K1's bf16 P moves the first causal
    # rows' dq, which sums few keys, by up to about 1.6 of the limit: the
    # forward's rounding, not K2's.)
    e_dq, _ = emulated_dq(q, k, v, want_out.to(q.dtype), do, want_lse,
                          c["causal"], scale)
    used = {what: tc_error(got, want, what) for what, got, want in
            (("O", e_out, want_out), ("dq", e_dq, want_dq),
             ("dk", e_dk, want_dk), ("dv", e_dv, want_dv))}
    assert max(used.values()) <= 1.0, used


@pytest.mark.parametrize("shift", [-1, 1])
def test_tolerance_catches_a_one_position_mask_shift(shift):
    """The kernels' causal mask moved by one position lands outside
    TENSOR_CORE_TOLERANCE on O, dq, dk and dv."""
    c = CASES["causal-256-d64"]
    q, k, v, do = _inputs(12, c)
    scale = c["d"] ** -0.5
    out, lse, dq, delta, dk, dv = _plain(q, k, v, do, True, scale)
    e_out, _ = emulated_forward(q, k, v, True, scale, shift=shift)
    e_dq, _ = emulated_dq(q, k, v, out, do, lse, True, scale, shift=shift)
    e_dk, e_dv = emulated_dkv(q, k, v, do, lse, delta, True, scale,
                              shift=shift)
    for what, got, want in (("O", e_out, out), ("dq", e_dq, dq),
                            ("dk", e_dk, dk), ("dv", e_dv, dv)):
        assert tc_error(got, want, what) > 1.0, what


# (q rows, kv rows) that a faulty kernel skips at L 1024, 64-row tiles.
LATE_FAULTS = {
    "K1-skips-kv-tile-0-for-q-tiles-8+": ((512, 1024), (0, 64)),
    "K2-skips-kv-tile-0-for-q-tiles-8+": ((512, 1024), (0, 64)),
    "K3-skips-q-tile-15-for-kv-tiles-8-14": ((960, 1024), (512, 960)),
}


@pytest.mark.parametrize("fault", list(LATE_FAULTS))
def test_tolerance_catches_a_tile_skipped_on_late_rows(fault):
    """One tile lost only on late causal rows, where the values are a
    few hundredths, breaks TENSOR_CORE_TOLERANCE on the outputs it
    reaches, while the sound emulation stays inside it."""
    c = dict(b=1, lq=1024, lk=1024, h=2, d=64, causal=True)
    q, k, v, do = _inputs(13, c)
    scale = c["d"] ** -0.5
    out, lse, dq, delta, dk, dv = _plain(q, k, v, do, True, scale)
    (q0, q1), (k0, k1) = LATE_FAULTS[fault]
    drop = torch.zeros(c["lq"], c["lk"], dtype=torch.bool)
    drop[q0:q1, k0:k1] = True
    if fault.startswith("K1"):
        runs = {"O": (out, [emulated_forward(q, k, v, True, scale,
                                             drop=d)[0]
                            for d in (None, drop)])}
    elif fault.startswith("K2"):
        runs = {"dq": (dq, [emulated_dq(q, k, v, out, do, lse, True, scale,
                                        drop=d)[0]
                            for d in (None, drop)])}
    else:
        sound, bad = (emulated_dkv(q, k, v, do, lse, delta, True, scale,
                                   drop=d) for d in (None, drop))
        runs = {"dk": (dk, [sound[0], bad[0]]),
                "dv": (dv, [sound[1], bad[1]])}
    for what, (want, (sound, bad)) in runs.items():
        assert tc_error(sound, want, what) <= 1.0, what
        assert tc_error(bad, want, what) > 1.0, what
        # Only late rows moved.
        rows = (q0, q1) if what in ("O", "dq") else (k0, k1)
        moved = (bad.float() - sound.float()).abs().amax(dim=(0, 2, 3))
        assert int(moved.nonzero().min()) >= rows[0], what
