"""The share of a decode step in which no operation runs on the device:
the union of device intervals a profiled step, against the window's mean
step time (untraced: the profiler's own host cost lengthens the traced
steps of a host-bound decode)."""


def read(rec):
    dec = rec["profile"]["decode"]
    if not dec["device"] or not rec["itl_s"]:
        return None
    step_s = sum(rec["itl_s"]) / len(rec["itl_s"])
    return 100 * (1 - dec["busy_s"] / dec["steps"] / step_s)
