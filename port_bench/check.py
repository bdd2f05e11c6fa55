"""Whether what the timed window served is right: the plain reference run
over a sample of the requests it finished, each prompt with its served
tokens, and at every served position the gap by which the served token's
logit lies below the reference's best (0 where the served token is the
reference's argmax). Greedy tokens only, which is what the window serves.

The sample is drawn from the seed: one finished round, and of it one
request from each of ``sample_requests`` equal slices of the batch, or the
whole batch where a block of the model couples the batch's requests (an
expert layer's capacity counts over the tokens routed together).

The reference runs after the window, on the same device and the same
parameter tensors, which it converts a layer at a time.
"""
from __future__ import annotations

import numpy as np
import torch

from port_bench.reference import common as ref


def sample(cell: dict, rounds: list, seed: int) -> tuple:
    """The round and the requests of it that the check reads."""
    rng = np.random.default_rng([seed, 7])
    r = int(rng.integers(len(rounds)))
    batch = rounds[r]["served"].shape[0]
    couples = any(getattr(mod, "COUPLES_BATCH", False)
                  for mod in ref.blocks(cell["config_data"]))
    n = batch if couples else cell["check"]["sample_requests"]
    edges = np.linspace(0, batch, n + 1).astype(int)
    idx = [int(rng.integers(a, b)) for a, b in zip(edges[:-1], edges[1:])]
    return r, idx


def inputs(rounds: list, r: int, idx: list, device) -> tuple:
    """``(tokens [N, S + new - 1], served [N, new], groups)``: each
    sampled prompt followed by its served tokens but the last, and the
    position ranges the program ran together (the prefill, then one
    position a decode step)."""
    prompts = rounds[r]["prompts"][idx]
    served = rounds[r]["served"][idx]
    s, new = prompts.shape[1], served.shape[1]
    tokens = np.concatenate([prompts, served[:, :-1]], axis=1)
    groups = [(0, s)] + [(s + j, s + j + 1) for j in range(new - 1)]
    return (torch.as_tensor(tokens, device=device),
            torch.as_tensor(served.astype(np.int64), device=device), groups)


def gaps(logits: torch.Tensor, served: torch.Tensor) -> torch.Tensor:
    """``[N, new]`` f32: each served token's logit below the row's best;
    +inf for a token outside the vocabulary."""
    vocab = logits.shape[-1]
    ok = (served >= 0) & (served < vocab)
    got = logits.gather(-1, served.clamp(0, vocab - 1)[..., None])[..., 0]
    return torch.where(ok, logits.amax(-1) - got, torch.inf)


def judge(cell: dict, params: dict, rounds: list, seed: int, device
          ) -> tuple:
    """The numbers a cell may compare (the widest gap, the mean gap over
    every sampled position), and of them those that judge a request alone
    for each sampled request."""
    r, idx = sample(cell, rounds, seed)
    tokens, served, groups = inputs(rounds, r, idx, device)
    s = rounds[r]["prompts"].shape[1]
    logits = ref.forward_logits(cell["config_data"], params, tokens, s - 1,
                                groups)
    g = gaps(logits, served).double().cpu()
    del logits
    numbers = dict(logit_gap_max=float(g.max()),
                   logit_gap_mean=float(g.mean()))
    return numbers, dict(logit_gap_max=g.amax(1).tolist())
