"""``itl_p95_ms``, read per layer in a cell whose decode is host-bound: the
95th percentile, over every decode step of the window, of the time from one
step's tokens reaching the host to the next step's. Its runs spread with
the host's speed too widely for a bound end to end."""
import numpy as np


def read(rec):
    if not rec["itl_s"]:
        return None
    return 1e3 * float(np.percentile(rec["itl_s"], 95))
