"""The 95th percentile, over every decode step of the window, of the time
from one step's tokens reaching the host to the next step's."""
import numpy as np


def read(rec):
    if not rec["itl_s"]:
        return None
    return 1e3 * float(np.percentile(rec["itl_s"], 95))
