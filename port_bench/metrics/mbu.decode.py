"""The window's decode steps' necessary bytes (weights, live K/V read, new
K/V written) over their time, as a share of the H100's HBM rate."""
from port_bench.arith import HBM_BYTES_PER_S, decode_step_bytes


def read(rec):
    if not rec["itl_s"]:
        return None
    b = rec["traffic"]["batch"]
    nbytes = sum(decode_step_bytes(rec["model"], [live] * b)
                 for live in rec["live"])
    return 100 * nbytes / sum(rec["itl_s"]) / HBM_BYTES_PER_S
