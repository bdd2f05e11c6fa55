"""The window's prefills' model FLOPs over their time, as a share of the
H100's bf16 peak."""
from port_bench.arith import BF16_FLOPS_PER_S, prefill_flops


def read(rec):
    tr = rec["traffic"]
    flops = len(rec["prefill_s"]) * prefill_flops(
        rec["model"], tr["batch"], tr["prompt_tokens"])
    return 100 * flops / sum(rec["prefill_s"]) / BF16_FLOPS_PER_S
