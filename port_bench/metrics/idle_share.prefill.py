"""The share of the profiled prefill, from its call to its first token on
the host, in which no operation runs on the device."""


def read(rec):
    pre = rec["profile"]["prefill"]
    if not pre["device"]:
        return None
    return 100 * (1 - pre["busy_s"] / ((pre["hi"] - pre["lo"]) / 1e9))
