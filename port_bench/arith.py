"""The benchmark's own measurement arithmetic: the H100's published peaks,
the kernels' bounds and the model's operations and bytes, computed from
shapes and lengths alone.

``visible_pairs``, ``flash_bound`` and ``paged_bound`` are frozen copies of
the arithmetic of ``chip_smoke.py``'s ``_visible_pairs``, ``_flash_bound``
and ``_paged_bound``, taking shapes instead of captured tensors. The model
counts follow the work, whatever implements it: a token uses its top-k
experts and no capacity padding, attention counts the visible (query, key)
pairs, and the prefill unembeds its last position only.
"""
from __future__ import annotations

# H100 SXM, NVIDIA data sheet, dense rates at 700 W.
BF16_FLOPS_PER_S = 989e12
F32_FLOPS_PER_S = 67e12
HBM_BYTES_PER_S = 3.35e12


def largest(terms: dict) -> dict:
    """The bound: the larger term, and which kind it is."""
    top = max(terms, key=terms.get)
    return dict(bound_ms=terms[top],
                bound_by="bytes" if "bytes" in top else "operations",
                bound_terms=terms)


def visible_pairs(sq: int, skv: int, causal: bool = True, window=None,
                  prefix_len: int = 0) -> int:
    """(query, key) pairs the mask lets through, for one head: all of them
    without ``causal``; else key j for query i where i - window < j <= i,
    or j < prefix_len."""
    if not causal:
        return sq * skv
    w = window or skv
    return sum(min(i + 1, w) + max(0, min(prefix_len, i + 1 - w))
               + max(0, prefix_len - (i + 1)) for i in range(sq))


def flash_bound(b: int, h: int, kv: int, s: int, hd: int, elt: int = 2,
                window=None, causal: bool = True, prefix_len: int = 0
                ) -> dict:
    """One GQA attention launch, q ``[b, h, s, hd]`` over k, v ``[b, kv, s,
    hd]``: 4 flops a visible pair and head dim (QK^T and PV) at the bf16
    tensor-core rate; q, k, v read once and the output written once."""
    pairs = visible_pairs(s, s, causal, window, prefix_len)
    flops = 4 * b * h * pairs * hd
    nbytes = elt * (2 * b * h * s * hd + 2 * b * kv * s * hd)
    return dict(largest(dict(bytes_ms=1e3 * nbytes / HBM_BYTES_PER_S,
                             ops_ms=1e3 * flops / BF16_FLOPS_PER_S)),
                flops=flops, bytes=nbytes)


def paged_bound(b: int, h: int, kv: int, hd: int, live_tokens: int,
                elt: int = 2, calls: int = 2) -> dict:
    """Decode attention over both tiers of one layer: every live K and V
    row read once (``live_tokens`` summed over the sequences, each page
    from one tier), and for each of the ``calls`` tier launches its f32
    query read and its f32 partials (accumulator, max, sum) written, at
    HBM's rate; 4 flops a live token, head dim and query head at the f32
    rate (the bf16 pools, as the kernel reads them)."""
    nbytes = live_tokens * 2 * kv * hd * elt \
        + calls * (4 * b * h * hd + 4 * (b * h * hd + 2 * b * h))
    flops = 4 * live_tokens * hd * h
    return dict(largest(dict(bytes_ms=1e3 * nbytes / HBM_BYTES_PER_S,
                             ops_ms=1e3 * flops / F32_FLOPS_PER_S)),
                bytes=nbytes, flops=flops)


def attn_params(m: dict) -> int:
    """The projections of one attention layer: q, k, v and o."""
    d, h, kv, hd = m["d"], m["heads"], m["kv_heads"], m["head_dim"]
    return d * h * hd + 2 * d * kv * hd + h * hd * d


def ffn_params(m: dict, experts: int) -> int:
    """One FFN layer's SwiGLU weights over ``experts`` experts (1 for a
    dense FFN), with the router where the model has experts."""
    gated = 3 * m["d"] * m["d_ff"]
    if not m.get("experts"):
        return gated
    return experts * gated + m["d"] * m["experts"]


def decode_step_flops(m: dict, live: list) -> int:
    """Model FLOPs of one decode step of ``len(live)`` sequences, each
    attending over ``live[i]`` tokens: 2 a parameter a token uses (the
    top-k experts), 4 a visible pair, head dim and query head, and the
    unembedding of each new token."""
    b = len(live)
    per_tok = m["layers"] * (attn_params(m)
                             + ffn_params(m, m.get("top_k", 1)))
    attn = 4 * sum(live) * m["head_dim"] * m["heads"] * m["layers"]
    return 2 * b * per_tok + attn + 2 * b * m["vocab"] * m["d"]


def prefill_flops(m: dict, b: int, s: int) -> int:
    """Model FLOPs of a prefill of ``b`` prompts of ``s`` tokens: every
    token through every layer (the top-k experts), causal attention's
    visible pairs, and the unembedding of each prompt's last position."""
    per_tok = m["layers"] * (attn_params(m)
                             + ffn_params(m, m.get("top_k", 1)))
    attn = 4 * b * m["heads"] * m["head_dim"] * visible_pairs(s, s) \
        * m["layers"]
    return 2 * b * s * per_tok + attn + 2 * b * m["vocab"] * m["d"]


def decode_step_bytes(m: dict, live: list, elt: int = 2) -> int:
    """Bytes one decode step must move: every weight it uses read once (of
    an expert layer the experts that ``len(live)`` tokens' top-k can reach,
    at most all of them), the live K/V read once, each new token's K and V
    written once, and each new token's embedding row."""
    b = len(live)
    experts = min(m.get("experts") or 1, b * m.get("top_k", 1))
    weights = m["layers"] * (attn_params(m) + ffn_params(m, experts)
                             + 2 * m["d"]) + m["vocab"] * m["d"] + m["d"]
    kv_row = 2 * m["kv_heads"] * m["head_dim"] * m["layers"]
    return elt * (weights + sum(live) * kv_row + b * kv_row + b * m["d"])
