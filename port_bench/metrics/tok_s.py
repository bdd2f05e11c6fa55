"""Tokens generated in the window (each prefill's first token included)
over the window's measured time."""


def read(rec):
    return rec["tokens"] / rec["window_s"]
