"""The request generator: determined by the seed, the same lengths for
every seed in every whole block."""

import collections
import json

import numpy as np
import pytest

from benchmark import requests, weights
from conftest import ROOT

MIX = json.loads((ROOT / "benchmark/traffic/serve-longprompt.json")
                 .read_text())


def test_same_seed_same_requests():
    a = requests.requests(MIX, 2 ** 31 + 7, 50257, 200)
    b = requests.requests(MIX, 2 ** 31 + 7, 50257, 200)
    assert all(np.array_equal(x.prompt, y.prompt) and x[1:] == y[1:]
               for x, y in zip(a, b))


def test_seeds_share_lengths_per_block():
    block = MIX["block"]
    a = requests.requests(MIX, 1, 50257, 3 * block)
    b = requests.requests(MIX, 2 ** 33 + 1, 50257, 3 * block)

    def lengths(reqs):
        return collections.Counter((len(r.prompt), r.max_new, r.gap_s)
                                   for r in reqs)

    for i in range(3):
        part = slice(i * block, (i + 1) * block)
        assert lengths(a[part]) == lengths(b[part])
    assert [len(r.prompt) for r in a] != [len(r.prompt) for r in b]
    assert not np.array_equal(a[0].prompt[:16], b[0].prompt[:16])
    span = sum(r.gap_s for r in a[:block])
    assert span == pytest.approx(MIX["block_seconds"])


def test_lengths_within_the_mix():
    for p, n, gap in requests.requests(MIX, 5, 50257, MIX["block"]):
        assert gap > 0
        assert MIX["prompt_len"]["min"] <= len(p) <= MIX["prompt_len"]["max"]
        assert MIX["output_len"]["min"] <= n <= MIX["output_len"]["max"]
        assert p.min() >= 0 and p.max() < 50257
        assert p.dtype == np.int64


def test_weights_and_batches_from_the_seed():
    from benchmark.references import gpt2

    cfg = dict(vocab_size=64, n_layers=2, d_model=16, n_heads=2, d_ff=32,
               max_seq_len=32)
    a = gpt2.draw_params(cfg, 2 ** 40 + 3, "cpu")
    b = gpt2.draw_params(cfg, 2 ** 40 + 3, "cpu")
    c = gpt2.draw_params(cfg, 2 ** 40 + 4, "cpu")
    assert a["blocks"]["wq"].equal(b["blocks"]["wq"])
    assert not a["blocks"]["wq"].equal(c["blocks"]["wq"])
    assert weights.draw_leaf(gpt2.leaf_specs(cfg), 2 ** 40 + 3, "tok_embed",
                             "cpu").equal(a["tok_embed"])
    t1 = weights.token_batch(9, 1, 2, 8, 60, "cpu")
    assert t1.equal(weights.token_batch(9, 1, 2, 8, 60, "cpu"))
    assert not t1.equal(weights.token_batch(9, 2, 2, 8, 60, "cpu"))
    assert int(t1.max()) < 60
