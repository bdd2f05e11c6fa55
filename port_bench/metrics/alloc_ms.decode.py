"""Host time a decode step in the program's tier metadata
(``kvpool.alloc_step``: allocation, OL eviction and the learner): the
summed length of the program's ``kv.alloc`` spans (``repro_torch.obs``)
in the profiled decode steps, over those steps. ``None`` where the
program has no such span, or the run no device trace (off the card)."""


def read(rec):
    dec = rec["profile"]["decode"]
    ns = sum(d for name, _, d in dec["host"] if name == "kv.alloc")
    if not dec["device"] or not ns:
        return None
    return ns / 1e6 / dec["steps"]
