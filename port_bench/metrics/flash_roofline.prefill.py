"""The flash-attention kernel's share of its bound over the profiled
prefill: every layer's causal launch at the prompt's shape, over the
kernel's measured time."""
from port_bench.arith import flash_bound

FLASH = ("tc::kernel<", "f32::kernel<")  # flash_attention.cu's kernels


def read(rec):
    pre, m, tr = rec["profile"]["prefill"], rec["model"], rec["traffic"]
    ns = sum(d for name, _, d in pre["kernels"]
             if any(f in name for f in FLASH))
    if not ns:
        return None
    bound_ms = m["layers"] * flash_bound(
        tr["batch"], m["heads"], m["kv_heads"], tr["prompt_tokens"],
        m["head_dim"])["bound_ms"]
    return 100 * bound_ms / (ns / 1e6)
