"""Device-idle time a decode step while the host is inside the program's
``model.layers`` span (``repro_torch.obs``: the decode step's layer loop,
which enqueues the model's kernels): the spans' union within the
profiled decode phase, less the device's busy intervals there, over the
profiled steps. ``None`` where the program has no such span, or the run
no device trace (off the card)."""
from port_bench.trace import union


def read(rec):
    dec = rec["profile"]["decode"]
    spans = [(s, s + d) for name, s, d in dec["host"]
             if name == "model.layers"]
    if not dec["device"] or not spans:
        return None
    idle = 0
    for a, b in union(spans, dec["lo"], dec["hi"]):
        idle += b - a - sum(y - x for x, y in union(dec["busy"], a, b))
    return idle / 1e6 / dec["steps"]
