"""The program's own page reads over the window: tier 1's share of
``t1_reads + t2_reads`` (``serving/kvpool.py``'s counters)."""


def read(rec):
    c = rec["counters"]
    total = c["t1_reads"] + c["t2_reads"]
    return 100 * c["t1_reads"] / total if total else None
