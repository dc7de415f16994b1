"""The expert layer's share of its roofline in the Mellum serving cell:
the bound of its grouped products in the traced window over their
device seconds (torch's grouped product: the GroupProblemShape GEMM and
its prepare_grouped_gemm_data kernel).  The bound is taken per dispatch
kind, prefill and decode, from the engine's device counters over the
traced part (routed token-expert pairs, expert weight loads):
max(bytes / 3.35 TB/s, FLOPs / 989 TFLOP/s) of each kind's sums (the
reference's `expert_bound`), the kinds added.  Nothing to read where the
engine has no such counters."""

from pathlib import Path

from benchmark import harness
from benchmark.drivers.serve import stats_delta

ROOT = Path(__file__).resolve().parents[2]
KERNELS = ("GroupProblemShape", "prepare_grouped_gemm_data")


def read(ctx):
    tr = ctx.get("trace")
    if ctx["kind"] != "serve" or tr is None:
        return None
    if "moe_routed_pairs_decode" not in ctx["marks"]["t0"][1]:
        return None
    seconds = tr.seconds(*KERNELS)
    if not seconds:
        return None
    cfg = ctx["cfg"]
    ref = harness.reference({"config": {"run": cfg}, "root": ROOT})
    bound = sum(ref.expert_bound(cfg,
                                 stats_delta(ctx, f"moe_routed_pairs_{kind}"),
                                 stats_delta(ctx, f"moe_expert_loads_{kind}"))
                for kind in ("prefill", "decode"))
    return 100 * bound / seconds
