"""The paged-attention kernel's share of its bound over the profiled
decode steps: the bound of both tiers' launches of every layer at each
step's live tokens, over the kernel's measured time."""
from port_bench.arith import paged_bound


def read(rec):
    dec, m = rec["profile"]["decode"], rec["model"]
    ns = sum(d for name, _, d in dec["kernels"] if "paged_attention" in name)
    if not ns:
        return None
    b = rec["traffic"]["batch"]
    bound_ms = sum(m["layers"] * paged_bound(
        b, m["heads"], m["kv_heads"], m["head_dim"], b * live)["bound_ms"]
        for live in dec["live"])
    return 100 * bound_ms / (ns / 1e6)
