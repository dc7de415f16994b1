"""The port's training attention (ray_tpu_torch/ops/attention.py) against
the JAX reference on the same numpy inputs: `reference_attention` with
its bottom-right causal mask and segment ids, and `flash_attention`
forward (O and LSE) and backward (dq, dk, dv under a random cotangent)
against the reference's flash attention with its Pallas kernels run in
interpret mode on the CPU, as tests/test_model_parallel.py runs them.

On CPU tensors the port runs the plain versions of K1-K3, so these tests
hold the kernels' arithmetic against the Pallas kernels'; chip_smoke.py
holds the CUDA kernels against the plain versions on the card.  f32 at
2e-5: the two sides sum in different orders."""

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

TOL = dict(atol=2e-5, rtol=2e-5)


def _inputs(seed, b, lq, h, d, lk=None):
    rng = np.random.default_rng(seed)
    lk = lq if lk is None else lk
    shapes = [(b, lq, h, d), (b, lk, h, d), (b, lk, h, d), (b, lq, h, d)]
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _t(x, grad=False):
    return torch.from_numpy(np.array(x)).requires_grad_(grad)


@pytest.mark.parametrize("causal,lk,segments", [
    (True, None, False), (False, None, False), (True, 24, False),
    (False, 24, False), (True, None, True), (False, None, True)])
def test_reference_attention_matches_reference(causal, lk, segments):
    q, k, v, _ = _inputs(0, 2, 16, 2, 8, lk)
    seg = None
    if segments:
        seg = np.repeat(np.asarray([[0, 1], [2, 2]]), 8, axis=1).astype(
            np.int32)
    want = jattn.reference_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        segment_ids=None if seg is None else jnp.asarray(seg))
    got = tattn.reference_attention(
        _t(q), _t(k), _t(v), causal=causal,
        segment_ids=None if seg is None else _t(seg))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_causal_mask_is_bottom_right_aligned():
    mask = tattn._build_mask(2, 4, True, None, "cpu")[0, 0]
    assert mask.tolist() == [[True, True, True, False],
                             [True, True, True, True]]


# The shapes of tests/test_model_parallel.py's flash tests, with their
# TPU block sizes on the reference side, plus a D 128 case.
FLASH_CASES = {
    "causal-2x256x4x64": dict(b=2, l=256, h=4, d=64, causal=True,
                              blocks=(128, 128)),
    "full-1x128x2x64": dict(b=1, l=128, h=2, d=64, causal=False,
                            blocks=(64, 64)),
    "causal-1x512x1x64": dict(b=1, l=512, h=1, d=64, causal=True,
                              blocks=(128, 64)),
    "causal-1x128x2x128": dict(b=1, l=128, h=2, d=128, causal=True,
                               blocks=(128, 128)),
}


def _jax_flash(q, k, v, g, causal, blocks):
    """The reference's flash attention (Pallas, interpret mode): O, LSE
    [B*H, L, 1] and (dq, dk, dv) under cotangent g."""
    args = [jnp.asarray(x) for x in (q, k, v)]
    fn = lambda q, k, v: jattn.flash_attention(  # noqa: E731
        q, k, v, causal=causal, block_q=blocks[0], block_k=blocks[1])
    out, vjp = jax.vjp(fn, *args)
    _, lse = jattn._flash_forward_impl(*args, causal, None, *blocks, None)
    assert lse is not None          # the Pallas path, not the fallback
    return out, lse, vjp(jnp.asarray(g))


@pytest.mark.parametrize("name", list(FLASH_CASES))
def test_flash_attention_matches_pallas(name):
    c = FLASH_CASES[name]
    q, k, v, g = _inputs(1, c["b"], c["l"], c["h"], c["d"])
    want_o, want_lse, want_grads = _jax_flash(q, k, v, g, c["causal"],
                                              c["blocks"])
    tq, tk, tv = _t(q, True), _t(k, True), _t(v, True)
    out = tattn.flash_attention(tq, tk, tv, causal=c["causal"])
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_o),
                               **TOL)
    _, lse = tattn.flash_forward(tq.detach(), tk.detach(), tv.detach(),
                                 c["causal"], c["d"] ** -0.5)
    np.testing.assert_allclose(lse.reshape(-1, c["l"], 1).numpy(),
                               np.asarray(want_lse), **TOL)
    grads = torch.autograd.grad(out, (tq, tk, tv), _t(g))
    for got, want in zip(grads, want_grads):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("d,lq,lk,causal", [
    (32, 64, 64, True),      # head dim the kernels do not take
    (64, 32, 64, True),      # causal with q_len != kv_len
])
def test_flash_attention_reference_path(d, lq, lk, causal):
    """Calls the kernels do not take go to reference_attention and its
    autograd on both sides."""
    assert not tattn._use_kernel(lq, lk, d, causal)
    q, k, v, g = _inputs(2, 2, lq, 2, d, lk)
    fn = lambda q, k, v: jattn.flash_attention(  # noqa: E731
        q, k, v, causal=causal)
    want, vjp = jax.vjp(fn, *[jnp.asarray(x) for x in (q, k, v)])
    tq, tk, tv = _t(q, True), _t(k, True), _t(v, True)
    got = tattn.flash_attention(tq, tk, tv, causal=causal)
    assert got.grad_fn.name() != "_FlashAttentionBackward"
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    grads = torch.autograd.grad(got, (tq, tk, tv), _t(g))
    for a, b in zip(grads, vjp(jnp.asarray(g))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


def test_ragged_lengths_match_reference():
    """Lengths that are no multiple of any tile (the CUDA kernels mask
    their last tile): the plain versions against the reference."""
    q, k, v, g = _inputs(3, 1, 77, 2, 64)
    tq, tk, tv = _t(q, True), _t(k, True), _t(v, True)
    want = tattn.reference_attention(tq, tk, tv, causal=True)
    got = tattn.flash_attention(tq, tk, tv, causal=True)
    torch.testing.assert_close(got, want, **TOL)
    for a, b in zip(torch.autograd.grad(got, (tq, tk, tv), _t(g)),
                    torch.autograd.grad(want, (tq, tk, tv), _t(g))):
        torch.testing.assert_close(a, b, **TOL)


def test_plain_backward_is_split_like_the_kernels():
    """flash_backward_plain = K2's plain version (dq, delta) then K3's
    (dk, dv) fed that delta; delta = rowsum(dO * O)."""
    q, k, v, g = [_t(x) for x in _inputs(4, 1, 40, 2, 64, 56)]
    out, lse = tattn.flash_forward_plain(q, k, v, False, 0.125)
    dq, delta = tattn.flash_dq_plain(q, k, v, out, lse, g, False, 0.125)
    torch.testing.assert_close(
        delta, (g * out).sum(-1).transpose(1, 2), **TOL)
    dk, dv = tattn.flash_dkv_plain(q, k, v, g, lse, delta, False, 0.125)
    for a, b in zip((dq, dk, dv), tattn.flash_backward_plain(
            q, k, v, out, lse, g, False, 0.125)):
        assert torch.equal(a, b)


def test_cpu_tensors_never_launch_kernels():
    before = (tattn.flash_forward.launches, tattn.flash_dq.launches,
              tattn.flash_dkv.launches)
    q, k, v, g = [_t(x, True) for x in _inputs(5, 1, 64, 1, 64)]
    tattn.flash_attention(q, k, v).backward(g.detach())
    assert (tattn.flash_forward.launches, tattn.flash_dq.launches,
            tattn.flash_dkv.launches) == before


def test_no_kernel_for_other_devices():
    q = torch.empty(1, 64, 1, 64, device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        tattn.flash_forward(q, q, q, True, 0.125)


@pytest.mark.parametrize("bad,match", [
    (dict(dtype=torch.float16), "dtype"),
    (dict(d=32), "no kernel for head dim"),
    (dict(lk=48), "no kernel for head dim"),      # causal, not square
    (dict(transpose=True), "contiguous"),
])
def test_kernel_argument_checks(bad, match):
    """What the CUDA wrappers refuse, checked before any launch."""
    d, lk = bad.get("d", 64), bad.get("lk", 64)
    dtype = bad.get("dtype", torch.float32)
    q = torch.zeros(1, 64, 2, d, dtype=dtype)
    k = torch.zeros(1, lk, 2, d, dtype=dtype)
    if bad.get("transpose"):
        k = torch.zeros(1, 2, lk, d, dtype=dtype).transpose(1, 2)
    with pytest.raises((TypeError, ValueError), match=match):
        tattn._check_flash_args("flash_forward", True, (q, k, k), ())
