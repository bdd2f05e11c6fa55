"""``tok_s``, read per layer in a cell whose decode is host-bound: tokens
generated in the window (each prefill's first token included) over the
window's measured time. Its runs spread with the host's speed too widely
for a bound end to end."""


def read(rec):
    return rec["tokens"] / rec["window_s"]
