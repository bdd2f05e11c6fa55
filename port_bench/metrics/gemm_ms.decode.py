"""Device time a decode step in matrix-product kernels (cuBLAS's gemm,
nvjet, cutlass and sm90_xmma kernels), over the profiled steps."""

GEMM = ("gemm", "nvjet", "cutlass", "sm90_xmma")


def read(rec):
    dec = rec["profile"]["decode"]
    ns = sum(d for name, _, d in dec["kernels"]
             if any(g in name.lower() for g in GEMM))
    return ns / 1e6 / dec["steps"] if ns else None
