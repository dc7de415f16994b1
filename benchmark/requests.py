"""The one request generator: a serving mix's parameters -> the ordered
list of requests that its clients send.

Sizes and arrival gaps do not depend on the run's seed.  One block of
`block` requests is drawn once from `size_seed`: each prompt and output
length lognormal about its median, rounded and clipped to [min, max],
and each gap to the next arrival exponential, the block's gaps scaled
to sum to `block_seconds` (so the rate is block / block_seconds
requests a second).  The
request list is that block again and again, each copy in an order drawn
from the run's seed.  So any whole number of blocks holds the same
lengths and spans the same seconds for every seed, and seeds change the
order and the prompt ids (uniform over the published vocabulary) only.
"""

from __future__ import annotations

from typing import List, NamedTuple

import numpy as np

from benchmark.weights import derive_seed


class Request(NamedTuple):
    prompt: np.ndarray            # int64 ids
    max_new: int
    gap_s: float                  # seconds to the next arrival


def _lengths(rng, spec: dict, n: int) -> np.ndarray:
    draw = rng.lognormal(np.log(spec["median"]), spec["sigma"], n)
    return np.clip(np.rint(draw), spec["min"], spec["max"]).astype(np.int64)


def size_block(mix: dict) -> List[tuple]:
    """The mix's block of (prompt length, output length, gap seconds)."""
    rng = np.random.default_rng(mix["size_seed"])
    n = mix["block"]
    prompts = _lengths(rng, mix["prompt_len"], n)
    outputs = _lengths(rng, mix["output_len"], n)
    gaps = rng.exponential(1.0, n)
    gaps *= mix["block_seconds"] / gaps.sum()
    return list(zip(prompts.tolist(), outputs.tolist(), gaps.tolist()))


def requests(mix: dict, seed: int, vocab: int, n: int) -> List[Request]:
    """The first `n` requests of the mix under `seed`."""
    block = size_block(mix)
    rng = np.random.default_rng(derive_seed(seed, "requests"))
    out: List[Request] = []
    while len(out) < n:
        for i in rng.permutation(len(block)):
            prompt_len, out_len, gap = block[i]
            out.append(Request(rng.integers(0, vocab, prompt_len,
                                            dtype=np.int64), out_len, gap))
    return out[:n]
