"""The yardstick's counts against hand counts at small shapes."""

import math

import pytest

from benchmark import flops

CFG = dict(vocab_size=10, n_layers=2, d_model=4, n_heads=2, d_ff=8)


def test_matmul_params():
    # per layer q, k, v, o: 4 x 4 x 4 = 64; up and down 2 x 4 x 8 = 64;
    # two layers 256; head 4 x 10 = 40.
    assert flops.matmul_params(CFG) == 296


def test_train_step_flops():
    rows, length = 3, 5
    dense = 6 * 296 * rows * length
    # causal pairs of a 5-row: 15; forward 2 products x 2 flops x d per
    # pair over heads (d = heads x head_dim) = 4 x 4 x 15 per layer a row.
    attn = 3 * 4 * 4 * 15 * rows * 2
    assert flops.train_step_flops(CFG, rows, length) == dense + attn


def test_token_flops():
    blocks = 2 * 2 * (4 * 16 + 2 * 32)
    assert flops.token_flops(CFG, 0, head=False) == blocks + 4 * 4 * 1 * 2
    assert flops.token_flops(CFG, 6, head=True) == \
        blocks + 4 * 4 * 7 * 2 + 2 * 4 * 10


def test_flash_bounds_by_hand():
    b, l, h, d = 1, 4, 1, 2
    got = flops.flash_bounds(b, l, h, d, "bfloat16")
    row = b * l * h * d * 2
    lens = b * h * l * 4
    pairs = 10                       # 4 x 5 / 2
    want = {"K1": max((4 * row + lens) / 3.35e12, 4 * d * pairs / 989e12),
            "K2": max((6 * row + 2 * lens) / 3.35e12,
                      6 * d * pairs / 989e12),
            "K3": max((6 * row + 2 * lens) / 3.35e12,
                      8 * d * pairs / 989e12)}
    assert got == pytest.approx(want, rel=1e-12)


def test_flash_bounds_compute_bound_at_train_shape():
    got = flops.flash_bounds(8, 1024, 25, 64, "bfloat16")
    pairs = 8 * 25 * 1024 * 1025 // 2
    assert got["K3"] == pytest.approx(8 * 64 * pairs / 989e12)


def test_decode_bound_by_hand():
    ctx = [3, 17, 1]
    got = flops.decode_bound(ctx, heads=2, kv_heads=2, head_dim=4,
                             block_size=16, dtype="bfloat16")
    kv = 21 * 2 * 4 * 2 * 2
    tables = (1 + 2 + 1) * 4 + 3 * 4
    q_out = 2 * 3 * 2 * 4 * 2
    assert got == pytest.approx(max((kv + tables + q_out) / 3.35e12,
                                    4 * 21 * 2 * 4 / 989e12))
    # Calls add up: two calls' bounds are the bound of their lanes
    # together while both are bound by bytes.
    a = flops.decode_bound([100, 7], 32, 32, 128, 16, "bfloat16")
    b = flops.decode_bound([5], 32, 32, 128, 16, "bfloat16")
    assert a + b == pytest.approx(flops.decode_bound(
        [100, 7, 5], 32, 32, 128, 16, "bfloat16"))


def test_causal_pairs():
    assert flops.causal_pairs(1) == 1
    assert flops.causal_pairs(4) == 10
    assert math.isclose(flops.causal_pairs(2048), 2048 * 2049 / 2)
