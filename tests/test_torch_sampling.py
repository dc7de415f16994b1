"""The port's in-step sampling against jax.random, stage by stage: the
key layout, threefry bits, uniform, gumbel and categorical must be
token-exact (bit-exact for bits/uniform) for any (seed, counter, vocab),
or seeded generation diverges from the reference engine."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu_torch.inference import sampling

# Tiny tensors: one thread each keeps the parallel test workers from
# oversubscribing the host's cores.
torch.set_num_threads(1)

# (seed, counter, vocab): vocab 512 (nano), 50304 (gpt2-small), an odd
# size, and seeds above 2**31 (the engine masks request seeds to uint32).
CASES = [(0, 0, 512), (7, 3, 512), (123456, 41, 50304),
         (2**32 - 1, 2**31 - 1, 50304), (2**31 + 5, 9, 1001)]


def _jax_key(seed, counter):
    return jax.random.fold_in(jax.random.key(np.uint32(seed)),
                              np.int32(counter))


def _torch_key(seed, counter):
    return sampling.fold_in(sampling.key(torch.tensor([seed])),
                            torch.tensor([counter]))


def test_seeded_sampling_key_layout():
    """Known divergence risk: key(seed) is the uint32 pair (0, seed) and
    fold_in hashes the count pair (0, data) — pinned against the raw key
    data JAX holds."""
    for seed, counter, _ in CASES:
        base = jax.random.key_data(jax.random.key(np.uint32(seed)))
        k1, k2 = sampling.key(torch.tensor([seed]))
        assert [int(k1[0]), int(k2[0])] == np.asarray(base).tolist()
        folded = np.asarray(jax.random.key_data(_jax_key(seed, counter)))
        t1, t2 = _torch_key(seed, counter)
        assert [int(t1[0]), int(t2[0])] == folded.tolist()


@pytest.mark.parametrize("seed,counter,vocab", CASES)
def test_random_bits_match_jax(seed, counter, vocab):
    want = np.asarray(jax.random.bits(_jax_key(seed, counter), (vocab,),
                                      jnp.uint32)).astype(np.int64)
    got = sampling.random_bits(_torch_key(seed, counter), vocab)[0].numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed,counter,vocab", CASES)
def test_uniform_matches_jax(seed, counter, vocab):
    want = np.asarray(jax.random.uniform(_jax_key(seed, counter), (vocab,)))
    got = sampling.uniform(_torch_key(seed, counter), vocab)[0].numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed,counter,vocab", CASES)
def test_gumbel_matches_jax(seed, counter, vocab):
    # log() may differ in the last ulp between XLA:CPU and torch; the
    # noise only has to rank the same, which the categorical test pins.
    want = np.asarray(jax.random.gumbel(_jax_key(seed, counter), (vocab,)))
    got = sampling.gumbel(_torch_key(seed, counter), vocab)[0].numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("seed,counter,vocab", CASES)
def test_categorical_matches_jax(seed, counter, vocab):
    rng = np.random.default_rng(seed % 1000 + vocab)
    for temp in (0.7, 1.0, 1.5):
        logits = rng.standard_normal(vocab).astype(np.float32) * 3
        z = logits / np.float32(max(temp, 1e-6))
        want = int(jax.random.categorical(_jax_key(seed, counter),
                                          jnp.asarray(z)))
        got = sampling.sample(torch.from_numpy(logits)[None],
                              torch.tensor([temp], dtype=torch.float32),
                              torch.tensor([seed]),
                              torch.tensor([counter]))
        assert int(got[0]) == want


def test_batched_sample_matches_per_lane_draws():
    """The engine draws all lanes at once; each row must equal the
    reference's per-lane vmap draw."""
    rng = np.random.default_rng(5)
    b, vocab = 6, 512
    logits = rng.standard_normal((b, vocab)).astype(np.float32) * 2
    temps = np.asarray([0.5, 1.0, 2.0, 0.8, 1.2, 0.3], np.float32)
    seeds = rng.integers(0, 2**32, b, dtype=np.uint64).astype(np.uint32)
    counters = rng.integers(0, 1000, b).astype(np.int32)

    def draw(row, temp, seed, counter):
        key = jax.random.fold_in(jax.random.key(seed), counter)
        return jax.random.categorical(key, row / jnp.maximum(temp, 1e-6))

    want = np.asarray(jax.vmap(draw)(jnp.asarray(logits), jnp.asarray(temps),
                                     jnp.asarray(seeds),
                                     jnp.asarray(counters)))
    got = sampling.sample(torch.from_numpy(logits), torch.from_numpy(temps),
                          torch.from_numpy(seeds.astype(np.int64)),
                          torch.from_numpy(counters.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy(), want)
