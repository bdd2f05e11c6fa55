"""Prompt tokens prefilled in the window over the time those prefills took,
each from its call to its first token on the host."""


def read(rec):
    return rec["prefill_tokens"] / sum(rec["prefill_s"])
