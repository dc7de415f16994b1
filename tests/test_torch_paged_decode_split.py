"""The split-context arithmetic of the decode kernel, written out on the CPU.

On the card `csrc/paged_decode.cu` cuts each lane's context into splits
of `split_len` positions (the count fixed by the table width, never by
ctx_lens): each split writes a partial (m, l, acc) over its positions,
an empty partial (m = -inf, l = 0) when it starts past the lane's
context, and a second kernel merges a lane's partials by their LSE
weights in split order, writing acc / max(l, 1e-30).  No CUDA kernel
runs here, so this file keeps that arithmetic in plain torch (it is not
part of the package) and holds it, in f32 at 1e-5, to the port's plain
version and to the JAX package's Pallas kernel (interpret mode) on nano
shapes from a numpy seed: the merge's contract.  The kernel itself is
held to the plain version on the card by chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops import attention as jattn
from ray_tpu_torch.ops import attention as tattn

# Tiny tensors: one thread each keeps the parallel test workers from
# oversubscribing the host's cores.
torch.set_num_threads(1)

TOL = dict(atol=1e-5, rtol=1e-5)
BS, MB, KH, D = 16, 16, 2, 64            # a table 256 positions wide
# A lane ending exactly on a split boundary (128, and 16), one of a
# single position, one short lane whose later splits are all empty, and
# a full table.
CTX = [128, 1, 20, 256, 16]


def _case(seed, q_per_kv):
    rng = np.random.default_rng(seed)
    b, h, nb = len(CTX), KH * q_per_kv, len(CTX) * MB + 4
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return dict(q=f32(b, h, D), k_pool=f32(nb, BS, KH, D),
                v_pool=f32(nb, BS, KH, D),
                block_tables=rng.permutation(nb)[:b * MB].reshape(
                    b, MB).astype(np.int32))


def split_decode(q, k_pool, v_pool, block_tables, ctx_lens, split_len):
    """The kernel's two passes: per split (m, l, acc), then the merge."""
    b, h, d = q.shape
    _, bs, kh, _ = k_pool.shape
    width = block_tables.shape[1] * bs
    n_splits = -(-width // split_len)
    pad = n_splits * split_len - width
    ctx = lambda pool: torch.nn.functional.pad(  # noqa: E731
        pool[block_tables.long()].reshape(b, width, kh, d).repeat_interleave(
            h // kh, dim=2), (0, 0, 0, 0, 0, pad))      # [b, S * len, h, d]
    k_ctx, v_ctx = ctx(k_pool), ctx(v_pool)
    s = torch.einsum("bhd,bphd->bhp", q * d ** -0.5, k_ctx)
    live = torch.arange(n_splits * split_len)[None] < ctx_lens[:, None]
    s = s.masked_fill(~live[:, None], -float("inf")).view(
        b, h, n_splits, split_len)
    # Pass 1: each split's partial; an empty split has m = -inf, l = 0.
    m = s.amax(-1)
    p = torch.where(m[..., None] == -float("inf"), 0.0,
                    torch.exp(s - m[..., None]))
    l = p.sum(-1)
    acc = torch.einsum("bhsp,bsphd->bhsd", p,
                       v_ctx.view(b, n_splits, split_len, h, d))
    # Pass 2: the merge, by LSE weight; no context at all writes zeros.
    m_all = m.amax(-1, keepdim=True)
    w = torch.exp(m - torch.where(m_all == -float("inf"), 0.0, m_all))
    l_all = (w * l).sum(-1, keepdim=True)
    return (w[..., None] * acc).sum(-2) / l_all.clamp_min(1e-30)


def _pallas(c, ctx_lens):
    return torch.from_numpy(np.array(jattn.paged_decode_attention(
        *(jnp.asarray(c[n]) for n in ("q", "k_pool", "v_pool",
                                      "block_tables")),
        jnp.asarray(ctx_lens), use_kernel=True, interpret=True)))


@pytest.mark.parametrize("split_len", [16, tattn.DECODE_SPLIT_LEN])
@pytest.mark.parametrize("q_per_kv", [1, 4, 8])
def test_split_merge_matches_plain_and_pallas(q_per_kv, split_len):
    c = _case(20 + q_per_kv, q_per_kv)
    ctx_lens = np.asarray(CTX, np.int32)
    args = [torch.from_numpy(c[n]) for n in ("q", "k_pool", "v_pool",
                                             "block_tables")]
    got = split_decode(*args, torch.from_numpy(ctx_lens), split_len)
    plain = tattn.paged_decode_attention_plain(*args,
                                               torch.from_numpy(ctx_lens))
    torch.testing.assert_close(got, plain, **TOL)
    torch.testing.assert_close(got, _pallas(c, ctx_lens), **TOL)


def test_split_path_writes_zeros_for_an_empty_context():
    """ctx_len = 0: every split is empty, and the merge writes zeros, as
    the Pallas kernel does (the plain version's all-masked row is a
    uniform average instead; the engine never sends 0)."""
    c = _case(30, 2)
    ctx_lens = np.asarray([0, 37, 0, 1, 256], np.int32)
    args = [torch.from_numpy(c[n]) for n in ("q", "k_pool", "v_pool",
                                             "block_tables")]
    got = split_decode(*args, torch.from_numpy(ctx_lens),
                       tattn.DECODE_SPLIT_LEN)
    assert torch.isfinite(got).all()
    assert not got[0].any() and not got[2].any()
    torch.testing.assert_close(got, _pallas(c, ctx_lens), **TOL)


def test_split_count_follows_the_table_width():
    """The kernel's split count comes from max_blocks * block_size, so
    launching needs no host sync on ctx_lens."""
    assert tattn.DECODE_SPLIT_LEN == 128
    assert tattn.decode_splits(64, 16) == 8
    assert tattn.decode_splits(MB, BS) == 2
    assert tattn.decode_splits(MB + 1, BS) == 3
    assert tattn.decode_splits(1, 1) == 1
    assert tattn.decode_splits(0, BS) == 0
