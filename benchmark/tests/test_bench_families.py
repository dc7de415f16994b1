"""A model family added as files alone, and the GPT cells unchanged to the
bit by the family contract (`benchmark/harness.py`)."""

import hashlib
import json
import shutil

import torch

from benchmark import controls, harness
from benchmark.drivers import train
from conftest import ROOT, make_tiny_root

HERE = ROOT / "benchmark" / "tests"
GOLDEN_SEED = 2 ** 33 + 77


def test_a_family_added_as_files(tmp_path):
    """A Llama configuration (4 query heads over 2 kv heads), its plain
    reference and a serve cell, added as files to a copy of the tiny
    root, run `correct` through `run_cell` with no edit of a file of the
    harness."""
    from benchmark.run import run_cell

    root = make_tiny_root(tmp_path / "copy")
    bench_dir = root / "benchmark"
    shutil.copy(HERE / "llama_reference.py",
                bench_dir / "references" / "llama_plain.py")
    cfg = {"name": "llama-gqa", "source": "a test's own",
           "run": {"family": "llama", "reference": "llama_plain",
                   "vocab_size": 4096, "n_layers": 32, "d_model": 4096,
                   "n_heads": 32, "n_kv_heads": 8, "d_ff": 14336,
                   "max_seq_len": 8192, "rope_theta": 500000.0,
                   "norm_eps": 1e-5, "dtype": "float32"}}
    ref = harness.reference({"config": cfg, "root": root})
    cfg["run"] = ref.tiny_run(cfg["run"])
    cfg["vocab_published"] = cfg["run"]["vocab_size"] - 12
    (bench_dir / "configs" / "llama-gqa.json").write_text(json.dumps(cfg))
    (bench_dir / "limits" / "llama-gqa.serve-longprompt.json").write_text(
        json.dumps({"served_gap": 1e-3}))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "llama-gqa", "source": "a test's own",
                             "file": "benchmark/configs/llama-gqa.json",
                             "reduced": [], "why": "a family as files"})
    cell = "llama-gqa.serve-longprompt"
    bench["workloads"].append({"name": cell, "config": "llama-gqa",
                               "traffic": "serve-longprompt", "chips": 1,
                               "why": "a family added as files"})
    for m in bench["end_to_end"]:
        if "cerebras-gpt-6.7b.serve-longprompt" in m.get("workloads", []):
            m["workloads"].append(cell)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    result, checks = run_cell(cell, 2 ** 32 + 41, 1.0, False, device="cpu",
                              root=root)
    assert result["correct"], checks
    assert {"ttft_p95_ms", "tbt_p95_ms", "setup_s"} == set(result["metrics"])
    assert harness.reference(harness.load_cell(cell, root)) is ref


def _hexes(x):
    if isinstance(x, dict):
        return {k: _hexes(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_hexes(v) for v in x]
    return x.hex() if isinstance(x, float) else x


def _digest(t: torch.Tensor) -> str:
    return hashlib.sha256(t.contiguous().view(torch.uint8).numpy()
                          .tobytes()).hexdigest()


def test_gpt_cells_bit_for_bit(tiny_root):
    """On a tiny seed, the GPT cells' weights (f32 and bf16), served gaps
    (f32 and the fp8 control), the train cell's readings with its
    controls and faults, and the program's and the reference's own
    readings equal, to the bit, the values that the harness gave before
    the family contract (`golden_gpt.json`)."""
    golden = json.loads((HERE / "golden_gpt.json").read_text())
    spec = harness.load_cell("cerebras-gpt-6.7b.serve-longprompt", tiny_root)
    ref, run = harness.reference(spec), spec["config"]["run"]
    for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        flat = {}
        ref.draw_params(run, GOLDEN_SEED, "cpu", matmul_dtype=dtype,
                        keep=lambda path, t: flat.setdefault(path, t))
        assert {k: _digest(t) for k, t in flat.items()} == \
            golden[f"weights_{name}"], name
    seqs = [(list(range(3, 40)), [5, 9, 11, 400, 2]),
            (list(range(100, 117)), [7] * 9)]
    assert {p: _hexes(ref.served_gaps(run, GOLDEN_SEED, seqs, "cpu", p))
            for p in ("f32", "fp8")} == golden["served_gaps"]

    got = controls.readings("gpt2-xl.train-1k", GOLDEN_SEED, True,
                            device="cpu", root=tiny_root)
    assert _hexes(got) == golden["train"]
    setup = train.Setup(harness.load_cell("gpt2-xl.train-1k", tiny_root),
                        GOLDEN_SEED, "cpu")
    setup.close()
    assert _hexes(setup.reference()) == golden["train_reference"]
    assert _hexes({k: setup.readings[k] for k in (
        "losses", "grad_norms", "change_norms")}) == golden["train_program"]
