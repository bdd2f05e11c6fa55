"""CUDA kernels launched a decode step, over the profiled steps."""


def read(rec):
    dec = rec["profile"]["decode"]
    if not dec["kernels"]:
        return None
    return len(dec["kernels"]) / dec["steps"]
