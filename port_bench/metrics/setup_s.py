"""From the process's start to the window's: the card's initialization,
the weights drawn on the card, the program's kernels loaded (built, in a
checkout's first run) and one warm-up round at the cell's shapes."""


def read(rec):
    return rec["setup_s"]
