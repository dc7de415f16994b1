"""The port's paged attention (ray_tpu_torch/ops/attention.py) against the
JAX reference on the same numpy inputs: the in-place K/V scatter with its
dropped writes, the masked-dense reference, the T=1/T>1 dispatch, and
the decode kernel's plain version against the Pallas kernel (run in
interpret mode, as tests/test_inference.py runs it).  f32 throughout at
2e-5: the two sides sum in different orders."""

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


def _case(seed, *, b=3, kh=2, q_per_kv=1, d=64, bs=8, mb=4, nb=16, t=1):
    rng = np.random.default_rng(seed)
    h = kh * q_per_kv
    return dict(
        q=rng.standard_normal((b, t, h, d)).astype(np.float32),
        k_pool=rng.standard_normal((nb, bs, kh, d)).astype(np.float32),
        v_pool=rng.standard_normal((nb, bs, kh, d)).astype(np.float32),
        tables=rng.permutation(nb)[:b * mb].reshape(b, mb).astype(np.int32),
    )


def _t(x):
    return torch.from_numpy(np.array(x))


def test_paged_kv_update_matches_reference():
    rng = np.random.default_rng(0)
    nb, bs, kh, d, b, t = 6, 4, 2, 8, 3, 5
    pools = [rng.standard_normal((nb, bs, kh, d)).astype(np.float32)
             for _ in range(2)]
    new = [rng.standard_normal((b, t, kh, d)).astype(np.float32)
           for _ in range(2)]
    tables = np.asarray([[1, 2], [3, 0], [5, 4]], np.int32)
    positions = np.asarray([[0, 1, 2, 3, 4], [5, 6, 7, 8, 9],
                            [2, 3, 4, 5, 6]], np.int32)
    valid = np.ones((b, t), bool)
    valid[1, 3:] = False          # prompt overhang
    valid[2] = False              # padding lane
    want = jattn.paged_kv_update(*map(jnp.asarray, pools + new), tables,
                                 positions, valid)
    tk, tv = _t(pools[0]), _t(pools[1])
    got = tattn.paged_kv_update(tk, tv, _t(new[0]), _t(new[1]), _t(tables),
                                _t(positions).long(), _t(valid))
    assert got[0] is tk and got[1] is tv          # updated in place
    np.testing.assert_array_equal(tk.numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(want[1]))


def test_paged_kv_update_drops_out_of_range_writes():
    """Known divergence: the reference drops invalid and out-of-pool
    writes (`.at[].set(mode="drop")`), where a bare torch `index_copy_`
    would raise or write.  Invalid slots must leave the pool untouched,
    including when no slot at all is valid."""
    nb, bs, kh, d = 4, 4, 2, 8
    tables = np.asarray([[1, 2], [3, 0]], np.int32)
    positions = np.asarray([[0], [5]], np.int32)
    for valid in (np.asarray([[True], [False]]),
                  np.asarray([[False], [False]])):
        k = torch.zeros(nb, bs, kh, d)
        v = torch.zeros(nb, bs, kh, d)
        tattn.paged_kv_update(k, v, torch.ones(2, 1, kh, d),
                              torch.ones(2, 1, kh, d), _t(tables),
                              _t(positions), _t(valid))
        want = jattn.paged_kv_update(
            jnp.zeros((nb, bs, kh, d)), jnp.zeros((nb, bs, kh, d)),
            jnp.ones((2, 1, kh, d)), jnp.ones((2, 1, kh, d)), tables,
            positions, valid)
        np.testing.assert_array_equal(k.numpy(), np.asarray(want[0]))
        np.testing.assert_array_equal(v.numpy(), np.asarray(want[1]))
        assert float(k.sum()) == kh * d * int(valid.sum())
    # Negative positions land where the reference's floor-div/mod puts
    # them; a table pointing past the pool is dropped.
    k = torch.zeros(nb, bs, kh, d)
    v = torch.zeros(nb, bs, kh, d)
    bad_tables = np.asarray([[9, 9], [1, 2]], np.int32)     # 9 >= nb
    pos = np.asarray([[1], [-3]], np.int32)
    ok = np.ones((2, 1), bool)
    tattn.paged_kv_update(k, v, torch.ones(2, 1, kh, d),
                          torch.ones(2, 1, kh, d), _t(bad_tables), _t(pos),
                          _t(ok))
    want = jattn.paged_kv_update(
        jnp.zeros((nb, bs, kh, d)), jnp.zeros((nb, bs, kh, d)),
        jnp.ones((2, 1, kh, d)), jnp.ones((2, 1, kh, d)), bad_tables, pos,
        ok)
    np.testing.assert_array_equal(k.numpy(), np.asarray(want[0]))


@pytest.mark.parametrize("t", [1, 5])
@pytest.mark.parametrize("q_per_kv", [1, 4])
def test_paged_attention_matches_reference(t, q_per_kv):
    c = _case(1, q_per_kv=q_per_kv, t=t)
    ctx_lens = np.asarray([7, 17, 32], np.int32)
    q_pos = (ctx_lens[:, None] - t + np.arange(t)[None]).astype(np.int32)
    want_ref = jattn.paged_attention_reference(
        c["q"], c["k_pool"], c["v_pool"], c["tables"], ctx_lens, q_pos)
    want = jattn.paged_attention(c["q"], c["k_pool"], c["v_pool"],
                                 c["tables"], ctx_lens, q_pos)
    args = (_t(c["q"]), _t(c["k_pool"]), _t(c["v_pool"]), _t(c["tables"]),
            _t(ctx_lens), _t(q_pos))
    np.testing.assert_allclose(tattn.paged_attention_reference(*args),
                               np.asarray(want_ref), **TOL)
    np.testing.assert_allclose(tattn.paged_attention(*args),
                               np.asarray(want), **TOL)


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("q_per_kv", [1, 4, 8])
def test_decode_plain_matches_pallas_kernel(q_per_kv, d):
    c = _case(2, q_per_kv=q_per_kv, d=d)
    q = c["q"][:, 0]
    ctx_lens = np.asarray([5, 17, 32], np.int32)     # partial/multi/full
    want = jattn.paged_decode_attention(
        jnp.asarray(q), jnp.asarray(c["k_pool"]), jnp.asarray(c["v_pool"]),
        jnp.asarray(c["tables"]), jnp.asarray(ctx_lens), use_kernel=True,
        interpret=True)
    args = (_t(q), _t(c["k_pool"]), _t(c["v_pool"]), _t(c["tables"]),
            _t(ctx_lens))
    plain = tattn.paged_decode_attention_plain(*args)
    np.testing.assert_allclose(plain.numpy(), np.asarray(want), **TOL)
    # On CPU tensors the wrapper IS the plain version, and no kernel ran.
    before = tattn.paged_decode_attention.launches
    np.testing.assert_array_equal(tattn.paged_decode_attention(*args).numpy(),
                                  plain.numpy())
    assert tattn.paged_decode_attention.launches == before


def test_decode_route_follows_the_head_dim(monkeypatch):
    """Known divergence, repaired: the reference sends a T=1 call to its
    kernel only at head dims 64, 128 and 256 (`_use_paged_kernel`) and
    every other head dim to the masked-dense path at position
    ctx_len - 1.  The port routes by the same rule, so a decode step at
    head dim 16 (nano, llama-tiny) never reaches the CUDA kernel, which
    refuses it."""
    assert [d for d in (16, 32, 64, 96, 128, 256, 512)
            if tattn._use_paged_kernel(d)] == [64, 128, 256]
    assert [d for d in (16, 32, 64, 96, 128, 256, 512)
            if jattn._use_paged_kernel(d)] == [64, 128, 256]
    kernel_calls = []
    wrapper = tattn.paged_decode_attention
    monkeypatch.setattr(tattn, "paged_decode_attention",
                        lambda *a, **kw: kernel_calls.append(1) or
                        wrapper(*a, **kw))
    ctx_lens = np.asarray([5, 17, 32], np.int32)
    q_pos = np.zeros((3, 1), np.int32)    # unused by the T=1 route
    for d in (16, 64):
        c = _case(4, q_per_kv=2, d=d)
        want = jattn.paged_attention(c["q"], c["k_pool"], c["v_pool"],
                                     c["tables"], ctx_lens, q_pos)
        got = tattn.paged_attention(_t(c["q"]), _t(c["k_pool"]),
                                    _t(c["v_pool"]), _t(c["tables"]),
                                    _t(ctx_lens), _t(q_pos))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                                   rtol=1e-5)
        assert len(kernel_calls) == (d == 64), d
    # The kernel itself still refuses head dim 16.
    c = _case(4, q_per_kv=2, d=16)
    with pytest.raises(ValueError, match="head dim"):
        tattn._check_kernel_args(
            _t(c["q"][:, 0]), _t(c["k_pool"]), _t(c["v_pool"]),
            _t(c["tables"]), _t(ctx_lens))


def test_all_masked_rows_are_finite():
    """Known divergence: a lane with ctx_len = 0 is all-masked.  The
    reference's dense path (and the port's plain version) give a uniform
    average over the gathered context — finite NEG_INF, never NaN; the
    Pallas kernel (and the CUDA kernel) give zeros."""
    c = _case(3)
    q = c["q"][:, 0]
    ctx_lens = np.asarray([0, 9, 0], np.int32)
    args = (_t(q), _t(c["k_pool"]), _t(c["v_pool"]), _t(c["tables"]),
            _t(ctx_lens))
    plain = tattn.paged_decode_attention_plain(*args).numpy()
    assert np.isfinite(plain).all()
    want = jattn.paged_attention_reference(
        q[:, None], c["k_pool"], c["v_pool"], c["tables"], ctx_lens,
        (ctx_lens - 1)[:, None])[:, 0]
    np.testing.assert_allclose(plain, np.asarray(want), **TOL)
    b, mb, bs = 3, 4, 8
    v_ctx = c["v_pool"][c["tables"]].reshape(b, mb * bs, 2, 64)
    np.testing.assert_allclose(plain[0], v_ctx[0].mean(0), **TOL)
    kernel = jattn.paged_decode_attention(
        jnp.asarray(q), jnp.asarray(c["k_pool"]), jnp.asarray(c["v_pool"]),
        jnp.asarray(c["tables"]), jnp.asarray(ctx_lens), use_kernel=True,
        interpret=True)
    assert not np.asarray(kernel)[0].any()


def _kernel_args(**over):
    args = dict(q=torch.zeros(2, 4, 64), k_pool=torch.zeros(8, 16, 2, 64),
                v_pool=torch.zeros(8, 16, 2, 64),
                block_tables=torch.zeros(2, 4, dtype=torch.int32),
                ctx_lens=torch.ones(2, dtype=torch.int32))
    args.update(over)
    return args


@pytest.mark.parametrize("bad,err", [
    (dict(q=torch.zeros(2, 4, 64, dtype=torch.float16)), TypeError),
    (dict(q=torch.zeros(2, 4, 32), k_pool=torch.zeros(8, 16, 2, 32),
          v_pool=torch.zeros(8, 16, 2, 32)), ValueError),
    (dict(q=torch.zeros(2, 3, 64)), ValueError),
    (dict(block_tables=torch.zeros(2, 4, dtype=torch.int64)), TypeError),
    (dict(ctx_lens=torch.ones(3, dtype=torch.int32)), ValueError),
    (dict(q=torch.zeros(2, 64, 4).transpose(1, 2)), ValueError),
    # Contiguous, but 4 bytes off the 16-byte alignment of its loads.
    (dict(k_pool=torch.zeros(8 * 16 * 2 * 64 + 1)[1:].view(8, 16, 2, 64)),
     ValueError),
])
def test_kernel_argument_checks(bad, err):
    """What the CUDA kernel does not take is refused before any launch."""
    tattn._check_kernel_args(**_kernel_args())       # the good case passes
    with pytest.raises(err):
        tattn._check_kernel_args(**_kernel_args(**bad))


# ---------------------------------------------------------------- K5

# K5's lanes: a split boundary, a rider (ctx_len 1), a lane whose chunk
# overhangs its prompt (positions past ctx_len), a full table and a
# lane with no context (its rows see no key).
PREFILL_CTX = [256, 1, 40, 512, 0]
PREFILL_BS, PREFILL_MB = 16, 32                  # a table 512 positions wide


def _prefill_case(seed, *, t, q_per_kv, d=64, kh=2):
    b = len(PREFILL_CTX)
    c = _case(seed, b=b, kh=kh, q_per_kv=q_per_kv, d=d, bs=PREFILL_BS,
              mb=PREFILL_MB, nb=b * PREFILL_MB + 4, t=t)
    ctx = np.asarray(PREFILL_CTX, np.int32)
    pos = np.maximum(ctx[:, None] - t, 0) + np.arange(t)[None]
    pos[2] += 8                                  # overhang: rows past ctx
    args = dict(q=c["q"], k_pool=c["k_pool"], v_pool=c["v_pool"],
                block_tables=c["tables"], ctx_lens=ctx,
                q_positions=pos.astype(np.int64))
    # bf16-representable values, as the kernel's inputs are.
    return {k: _t(v).to(torch.bfloat16).float() if v.dtype == np.float32
            else _t(v) for k, v in args.items()}


def split_prefill(q, k_pool, v_pool, block_tables, ctx_lens, q_positions,
                  split_len, keep_lo=True):
    """K5's two passes written out in f32: per split, each row's partial
    over the keys below its limit min(ctx_len, width, position + 1), P V
    with P as bf16 hi + lo; then the merge of the splits each row's limit
    reaches, in split order (zeros for a row that reaches none).  With
    `keep_lo` False, P is rounded to bf16 alone."""
    b, t, h, d = q.shape
    _, bs, kh, _ = k_pool.shape
    width = block_tables.shape[1] * bs
    n_splits = tattn.prefill_splits(block_tables.shape[1], bs, split_len)
    pad = n_splits * split_len - width

    def ctx(pool):                                # [b, S * len, h, d]
        x = pool[block_tables.long()].reshape(b, width, kh, d)
        return torch.nn.functional.pad(x.repeat_interleave(h // kh, dim=2),
                                       (0, 0, 0, 0, 0, pad))

    k_ctx, v_ctx = ctx(k_pool), ctx(v_pool)
    s = torch.einsum("bthd,bphd->bthp", q, k_ctx) * (d ** -0.5 / np.log(2))
    lim = torch.minimum(ctx_lens.long().clamp(max=width)[:, None],
                        q_positions + 1).clamp(min=0)          # [b, t]
    vis = torch.arange(n_splits * split_len)[None, None] < lim[..., None]
    s = s.masked_fill(~vis[:, :, None], -float("inf")).view(
        b, t, h, n_splits, split_len)
    m = s.amax(-1)
    p = torch.exp2(s - torch.where(m == -float("inf"), 0, m)[..., None])
    hi = p.bfloat16().float()
    lo = (p - hi).bfloat16().float() if keep_lo else torch.zeros_like(p)
    v = v_ctx.view(b, n_splits, split_len, h, d)
    acc = torch.einsum("bthsl,bslhd->bthsd", hi + lo, v)
    # The merge reads split s of a row iff s * split_len < its limit.
    read = (torch.arange(n_splits) * split_len)[None, None] < lim[..., None]
    read = read[:, :, None]                                    # [b, t, 1, S]
    mx = torch.where(read, m, -float("inf")).amax(-1, keepdim=True)
    w = torch.where(read, torch.exp2(m - mx), 0)
    l_sum = (w * p.sum(-1)).sum(-1)
    return (w[..., None] * acc).sum(-2) / l_sum.clamp_min(1e-30)[..., None]


@pytest.mark.parametrize("split_len", [64, 256, tattn.PREFILL_SPLIT_LEN])
@pytest.mark.parametrize("t,q_per_kv", [(8, 1), (5, 4), (3, 8)])
def test_prefill_split_merge_matches_plain(t, q_per_kv, split_len):
    """K5's arithmetic (csrc/paged_prefill.cu, held to the plain version
    on the card by chip_smoke.py) against the plain version in f32: equal
    within f32 rounding and P's hi + lo (2**-17 of P) on every row that
    sees a key, zeros on the lane with no context.  P rounded to bf16
    alone misses the same limit: the lo term is what keeps P at f32
    accuracy."""
    c = _prefill_case(6, t=t, q_per_kv=q_per_kv)
    got = split_prefill(**c, split_len=split_len)
    want = tattn.paged_attention_reference(**c)
    seen = torch.tensor([n > 0 for n in PREFILL_CTX])
    torch.testing.assert_close(got[seen], want[seen], atol=2e-5, rtol=2e-5)
    assert not got[~seen].any()
    rough = split_prefill(**c, split_len=split_len, keep_lo=False)
    assert not torch.allclose(rough[seen], want[seen], atol=2e-5, rtol=2e-5)


def test_prefill_split_count_follows_the_table_width():
    assert tattn.PREFILL_SPLIT_LEN == 512
    assert [tattn.prefill_splits(mb, 16) for mb in (1, 32, 33, 128)] == \
        [1, 1, 2, 4]


@pytest.mark.parametrize("t,q_per_kv", [(2, 1), (5, 4), (32, 1)])
def test_prefill_wrapper_on_cpu_is_the_plain_version(t, q_per_kv):
    """On CPU tensors the wrapper IS `paged_attention_reference`, bit for
    bit in bf16, and no kernel ran."""
    c = {k: v.to(torch.bfloat16) if v.is_floating_point() else v
         for k, v in _prefill_case(7, t=t, q_per_kv=q_per_kv).items()}
    before = tattn.paged_prefill_attention.launches
    got = tattn.paged_prefill_attention(**c)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, tattn.paged_attention_reference(**c))
    assert tattn.paged_prefill_attention.launches == before


@pytest.mark.parametrize("d,dtype,kernel", [
    (64, torch.bfloat16, True), (128, torch.bfloat16, True),
    (256, torch.bfloat16, True), (64, torch.float32, False),
    (16, torch.bfloat16, False)])
def test_prefill_route_follows_dtype_and_head_dim(monkeypatch, d, dtype,
                                                  kernel):
    """A T > 1 call reaches K5's wrapper in bf16 at head dims 64, 128 and
    256, where on a CUDA tensor it launches the kernel; f32 calls and
    head dim 16 keep the masked-dense path.  The route reads the dtype
    and the shape only, never the device, so a CPU call takes the route
    a CUDA call takes (and the wrapper then runs the plain version)."""
    calls = []
    wrapper = tattn.paged_prefill_attention
    monkeypatch.setattr(tattn, "paged_prefill_attention",
                        lambda *a, **kw: calls.append(1) or wrapper(*a, **kw))
    c = {k: v.to(dtype) if v.is_floating_point() else v
         for k, v in _prefill_case(8, t=4, q_per_kv=2, d=d).items()}
    got = tattn.paged_attention(*c.values())
    assert torch.equal(got, tattn.paged_attention_reference(*c.values()))
    assert len(calls) == kernel
    assert tattn._use_prefill_kernel(c["q"]) == kernel


def _prefill_args(**over):
    bf = torch.bfloat16
    args = dict(q=torch.zeros(2, 3, 4, 64, dtype=bf),
                k_pool=torch.zeros(8, 16, 2, 64, dtype=bf),
                v_pool=torch.zeros(8, 16, 2, 64, dtype=bf),
                block_tables=torch.zeros(2, 4, dtype=torch.int32),
                ctx_lens=torch.ones(2, dtype=torch.int32),
                q_positions=torch.zeros(2, 3, dtype=torch.int64))
    args.update(over)
    return args


@pytest.mark.parametrize("bad,err", [
    (dict(q=torch.zeros(2, 3, 4, 64)), TypeError),                # f32
    (dict(q=torch.zeros(2, 3, 4, 64, dtype=torch.float16)), TypeError),
    (dict(q=torch.zeros(2, 3, 4, 32, dtype=torch.bfloat16),
          k_pool=torch.zeros(8, 16, 2, 32, dtype=torch.bfloat16),
          v_pool=torch.zeros(8, 16, 2, 32, dtype=torch.bfloat16)),
     ValueError),                                                 # head dim
    (dict(q=torch.zeros(2, 3, 3, 64, dtype=torch.bfloat16)), ValueError),
    (dict(block_tables=torch.zeros(2, 4, dtype=torch.int64)), TypeError),
    (dict(ctx_lens=torch.ones(2, dtype=torch.int64)), TypeError),
    (dict(q_positions=torch.zeros(2, 3)), TypeError),
    (dict(q_positions=torch.zeros(2, 4, dtype=torch.int64)), ValueError),
    (dict(q=torch.zeros(2, 3, 64, 4, dtype=torch.bfloat16).transpose(2, 3)),
     ValueError),                                                 # strided
    (dict(ctx_lens=torch.ones(2, dtype=torch.int32, device="meta")),
     ValueError),                                                 # device
    # Contiguous, but 2 bytes off the 16-byte alignment of its loads.
    (dict(k_pool=torch.zeros(8 * 16 * 2 * 64 + 1, dtype=torch.bfloat16)[1:]
          .view(8, 16, 2, 64)), ValueError),
])
def test_prefill_kernel_argument_checks(bad, err):
    """What K5 does not take is refused before any launch."""
    tattn._check_prefill_args(**_prefill_args())     # the good case passes
    with pytest.raises(err):
        tattn._check_prefill_args(**_prefill_args(**bad))
