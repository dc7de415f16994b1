"""K1-K3's share of their roofline in training: the sum of each launch's
bound (flops.flash_bounds at the cell's call shape, the rank's rows)
over the sum of their device seconds, in the traced window (rank 0's
card under a mesh).  Kernels counted, by name: flash_fwd_kernel and
flash_fwd_mma_kernel (K1), flash_dq_kernel and flash_dq_mma_kernel (K2),
flash_dkv_kernel and flash_dkv_mma_kernel (K3)."""

from benchmark.flops import flash_bounds

KERNELS = {"K1": "flash_fwd", "K2": "flash_dq", "K3": "flash_dkv"}


def read(ctx):
    tr = ctx.get("trace")
    if ctx["kind"] != "train" or tr is None:
        return None
    bounds = flash_bounds(*ctx["flash_call"])
    bound = seconds = 0.0
    for k, name in KERNELS.items():
        launches = tr.kernels(name)
        bound += len(launches) * bounds[k]
        seconds += sum(e - s for s, e, _ in launches)
    return 100 * bound / seconds if seconds else None
