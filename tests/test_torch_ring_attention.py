"""The port's ring attention (ray_tpu_torch/ops/ring_attention.py) and its
rotation (parallel/collectives.py `rotate`, `ppermute`) against the JAX
package's `ring_attention` (ray_tpu/ops/ring_attention.py), on the CPU.

JAX runs on the 8 virtual CPU devices of tests/conftest.py; the port on
one group of 8 gloo ranks spawned by `run_ranks` for the module (bounded
by RANK_TIMEOUT_S; the reference's side is computed while it runs), rank
r standing where JAX's device r stands.  Held, f32:

- the plain block functions (`_block_attend`, `_merge`) against the
  reference's, with and without a mask, a fully masked row included;
- at tests/test_model_parallel.py:60's shape on MeshConfig(data=2,
  seq=4), causal and not: the kernel ring (K1-K3 per block, here their
  plain versions) and the plain ring, values and the gradients of
  sum(out * dout) against the reference's ring and `jax.grad` of it,
  within 2e-5;
- on a mesh whose seq axis is 1 the ring is flash attention;
- seq rank r attends r + 1 blocks under a causal mask, n without one
  (the launch rule chip_smoke.py holds K1-K3 to).
"""

import concurrent.futures
import functools
import importlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.parallel import MeshConfig as JMeshConfig
from ray_tpu.parallel import create_mesh as jcreate_mesh
from ray_tpu_torch.parallel import rank_bodies
from ray_tpu_torch.parallel.launch import run_ranks

# ray_tpu.ops exports the function under the module's name.
jring = importlib.import_module("ray_tpu.ops.ring_attention")
tring = importlib.import_module("ray_tpu_torch.ops.ring_attention")

torch.set_num_threads(1)

RANK_TIMEOUT_S = 240
RING = dict(data=2, seq=4)
NO_RING = dict(data=8)
SHAPE = (2, 64, 2, 16)      # tests/test_model_parallel.py:60
TOL = 2e-5


@functools.cache
def _inputs(batch: int = SHAPE[0]):
    rng = np.random.default_rng(11)
    return tuple(rng.standard_normal((batch,) + SHAPE[1:]).astype(
        np.float32) for _ in range(4))


@functools.cache
def _reference(causal: bool):
    """The reference ring's output and the gradients of sum(out * dout)
    on data2/seq4."""
    q, k, v, dout = _inputs()
    mesh = jcreate_mesh(JMeshConfig(**RING), devices=jax.devices()[:8])

    def f(q, k, v):
        return jring.ring_attention(q, k, v, mesh=mesh, causal=causal)

    out, vjp = jax.vjp(jax.jit(f), q, k, v)
    return tuple(np.asarray(t) for t in (out,) + vjp(jnp.asarray(dout)))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    q, k, v, dout = _inputs()
    calls = [("ring", (RING, q, k, v, dout, True)),
             ("ring", (RING, q, k, v, dout, False)),
             ("ring", (NO_RING,) + _inputs(8) + (True,))]
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        running = pool.submit(
            run_ranks, rank_bodies.sequence, 8, args=(calls,), device="cpu",
            init_dir=str(tmp_path_factory.mktemp("ring")),
            timeout_s=RANK_TIMEOUT_S)
        for causal in (True, False):        # JAX's side meanwhile
            _reference(causal)
        out = running.result()
    return types.SimpleNamespace(causal=[r[0] for r in out],
                                 full=[r[1] for r in out],
                                 no_ring=[r[2] for r in out])


def _slices(index):
    return tuple(slice(a, b) for a, b in index)


@pytest.mark.parametrize("masked", ["causal", "none", "row_fully_masked"])
@pytest.mark.parametrize("scale", [0.25, 1.0])
def test_block_attend_matches_the_reference(masked, scale):
    rng = np.random.default_rng(3)
    q, k, v = (rng.standard_normal((2, 8, 3, 16)).astype(np.float32)
               for _ in range(3))
    mask = None
    if masked == "causal":
        mask = np.tril(np.ones((8, 8), bool))
    elif masked == "row_fully_masked":
        mask = np.tril(np.ones((8, 8), bool), -1)
    want = jring._block_attend(q, k, v, scale,
                               None if mask is None else jnp.asarray(mask))
    got = tring._block_attend(*map(torch.from_numpy, (q, k, v)), scale,
                              None if mask is None
                              else torch.from_numpy(mask))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=TOL,
                                   atol=TOL)


def test_merge_matches_the_reference():
    rng = np.random.default_rng(4)
    m1, m2 = (rng.standard_normal((2, 3, 8)).astype(np.float32) * 4
              for _ in range(2))
    m2[0, 0, :] = -1e30              # a skipped (future) block's state
    l1, l2 = (rng.uniform(0.5, 3, (2, 3, 8)).astype(np.float32)
              for _ in range(2))
    l2[0, 0, :] = 0.0
    a1, a2 = (rng.standard_normal((2, 8, 3, 16)).astype(np.float32)
              for _ in range(2))
    a2[0, :, 0] = 0.0
    want = jring._merge(m1, l1, a1, m2, l2, a2)
    got = tring._merge(*map(torch.from_numpy, (m1, l1, a1, m2, l2, a2)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=TOL,
                                   atol=TOL)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("path", ["kernel", "plain"])
def test_ring_matches_the_reference_ring(ranks, causal, path):
    want = _reference(causal)
    runs = ranks.causal if causal else ranks.full
    for out in runs:
        index = _slices(out["index"])
        for name, got, w in zip(("out", "dq", "dk", "dv"), out[path], want):
            np.testing.assert_allclose(got, w[index], atol=TOL, rtol=TOL,
                                       err_msg=name)


def test_every_position_is_held_by_one_rank(ranks):
    """data2 x seq4: each rank holds one row's quarter of the length."""
    seen = np.zeros(SHAPE, int)
    for out in ranks.causal:
        seen[_slices(out["index"])] += 1
        assert out["index"][:2] in ([[0, 1], [0, 16]], [[0, 1], [16, 32]],
                                    [[0, 1], [32, 48]], [[0, 1], [48, 64]],
                                    [[1, 2], [0, 16]], [[1, 2], [16, 32]],
                                    [[1, 2], [32, 48]], [[1, 2], [48, 64]])
    assert (seen == 1).all()


def test_a_seq_axis_of_one_is_flash_attention(ranks):
    from ray_tpu_torch.ops.attention import flash_attention

    q, k, v, dout = _inputs(8)
    qkv = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    o = flash_attention(*qkv, causal=True)
    want = [o.detach().numpy()] + [g.numpy() for g in torch.autograd.grad(
        o, qkv, torch.from_numpy(dout))]
    for out in ranks.no_ring:
        index = _slices(out["index"])
        for path in ("kernel", "plain"):
            for got, w in zip(out[path], want):
                np.testing.assert_allclose(got, w[index], atol=TOL,
                                           rtol=TOL)


@pytest.mark.parametrize("n", [2, 4, 8])
def test_rank_r_attends_r_plus_one_blocks_under_a_causal_mask(n):
    for r in range(n):
        causal = tring._attended(r, n, True)
        assert len(causal) == r + 1
        assert causal[0] == (0, True)
        assert all(not c for _, c in causal[1:])
        # The blocks it attends are those of slots r, r - 1, ..., 0.
        assert sorted((r - i) % n for i, _ in causal) == list(range(r + 1))
        assert tring._attended(r, n, False) == [(i, False)
                                                for i in range(n)]
