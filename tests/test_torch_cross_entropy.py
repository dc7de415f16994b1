"""The port's fused chunked cross-entropy (ray_tpu_torch/ops/
cross_entropy.py) against the JAX reference's on the same numpy inputs:
the loss, dx and dhead, in f32 and bf16, with a mask, and with a row
count that n_chunks does not divide (one chunk then)."""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from ray_tpu.ops.cross_entropy import fused_cross_entropy as jax_ce
from ray_tpu_torch.ops import cross_entropy as tce

# Tiny tensors: one thread each keeps the parallel test workers from
# oversubscribing the host's cores.
torch.set_num_threads(1)

torch.backends.cuda.matmul.allow_tf32 = False
torch.set_float32_matmul_precision("highest")


def _case(seed, t, d=32, v=200, dtype=np.float32):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((t, d)).astype(dtype)
    head = (rng.standard_normal((d, v)) / np.sqrt(d)).astype(dtype)
    targets = rng.integers(0, v, t).astype(np.int32)
    valid = (rng.random(t) > 0.25).astype(np.float32)
    return x, head, targets, valid


def _torch(x):
    if x.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(x.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(x))


def _f32(x):
    return np.asarray(x).astype(np.float32)


def _both(x, head, targets, valid, n_chunks):
    loss_fn = lambda x, h: jax_ce(x, h, jnp.asarray(targets),  # noqa: E731
                                  jnp.asarray(valid), n_chunks)
    want, (wdx, wdh) = jax.value_and_grad(loss_fn, argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(head))
    tx = _torch(x).requires_grad_()
    th = _torch(head).requires_grad_()
    got = tce.fused_cross_entropy(tx, th, _torch(targets), _torch(valid),
                                  n_chunks)
    gdx, gdh = torch.autograd.grad(got, (tx, th))
    assert gdx.dtype == tx.dtype and gdh.dtype == th.dtype
    return ((float(want), _f32(wdx), _f32(wdh)),
            (float(got.detach()), gdx.float().numpy(), gdh.float().numpy()))


@pytest.mark.parametrize("t,n_chunks", [(24, 4), (30, 4), (24, 1)])
def test_fused_cross_entropy_f32(t, n_chunks):
    want, got = _both(*_case(0, t), n_chunks)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-6)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g, w, atol=1e-6, rtol=1e-5)


@pytest.mark.parametrize("t", [24, 30])
def test_fused_cross_entropy_bf16(t):
    """bf16 x and head.  The logits are bf16 x bf16 with f32 output on
    both sides, so the loss agrees to f32 rounding; dlogits, dx and the
    rounding of dhead are bf16 on both sides and may differ by a bf16
    ulp (2**-8 relative) where the two sums land either side of a
    rounding boundary."""
    want, got = _both(*_case(1, t, dtype=ml_dtypes.bfloat16), 4)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g, w, atol=2 ** -8 * np.abs(w).max(),
                                   rtol=2 ** -7)


def test_matches_naive_log_softmax():
    """The chunked loss and its gradients equal the naive masked mean of
    -log_softmax at the targets (what it replaces)."""
    x, head, targets, valid = map(_torch, _case(2, 32))
    x.requires_grad_()
    got = tce.fused_cross_entropy(x, head, targets, valid)
    logp = torch.log_softmax(x @ head, dim=-1)
    nll = -logp.gather(1, targets.long()[:, None])[:, 0]
    want = (nll * valid).sum() / valid.sum().clamp_min(1)
    torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(torch.autograd.grad(got, x)[0],
                               torch.autograd.grad(want, x)[0],
                               atol=1e-6, rtol=1e-5)


def test_all_masked_rows_divide_by_one():
    x, head, targets, _ = map(_torch, _case(3, 8))
    loss = tce.fused_cross_entropy(x, head, targets, torch.zeros(8))
    assert float(loss) == 0.0
