"""The share of the expert GEMMs' capacity-padded rows that hold a real
token in the profiled prefill: the program's counters ``moe.kept`` (the
(token, k) slots that fit their expert's capacity) over ``moe.slots``
(experts x capacity), summed over the layers under its ``engine.prefill``
span (``repro_torch.obs.snapshot()``). The counters are the process's
totals, counted only while a profiler runs; a run profiles only its
traced stretch, so they are that stretch's. ``None`` for a model without
experts, or a program without the counters."""


def read(rec):
    if not rec["model"]["experts"]:
        return None
    try:
        from repro_torch import obs
    except ImportError:
        return None
    counts = obs.snapshot().get("engine.prefill", {})
    if not counts.get("moe.slots"):
        return None
    return 100 * counts.get("moe.kept", 0) / counts["moe.slots"]
