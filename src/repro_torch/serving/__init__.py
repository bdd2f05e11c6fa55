"""Paged two-tier KV serving: the pools, the tier movement and the
prefill / decode steps."""
