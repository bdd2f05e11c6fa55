"""The window's decode steps' model FLOPs over their time, as a share of
the H100's bf16 peak."""
from port_bench.arith import BF16_FLOPS_PER_S, decode_step_flops


def read(rec):
    if not rec["itl_s"]:
        return None
    b = rec["traffic"]["batch"]
    flops = sum(decode_step_flops(rec["model"], [live] * b)
                for live in rec["live"])
    return 100 * flops / sum(rec["itl_s"]) / BF16_FLOPS_PER_S
