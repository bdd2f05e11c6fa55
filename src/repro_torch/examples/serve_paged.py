"""Serve a small MoE model with batched requests through the paged
two-tier KV cache: prefill -> decode, with the OL eviction learner and
IO-thread-style page promotion running between steps (paper fig. 2).

  PYTHONPATH=src python -m repro_torch.examples.serve_paged

Reduced mixtral-8x22b (sliding-window attention, so decode reads only
the pages of the window; top-2 of 4 experts): 4 requests of 32 tokens, 32
new tokens each, tier 1 at 0.4 of the pages, promotion every 4 steps.
Runs on the card by default (the flash, paged-attention and page-copy
kernels), on the CPU with ``--device cpu`` (their plain versions).
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.configs.archs import ARCHS
from repro_torch.launch import serve
from repro_torch.models.params import init_params

B, S0, N_NEW = 4, 32, 32


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    dev = ap.parse_args(argv).device

    cfg = ARCHS["mixtral-8x22b"].reduced()  # SWA + MoE: windowed reads
    params = init_params(cfg, 0, dev)
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab, (B, S0)).astype(np.int32)
    print(f"prefill {B} requests x {S0} tokens ...")
    serve.reset_launch_counts()
    res = serve.serve(cfg, params, prompts, new=N_NEW, hbm_fraction=0.4,
                      promote_every=4, n_promote=2, max_seq=128)
    kv = res.state.kv
    t1, t2 = int(kv.t1_reads[0]), int(kv.t2_reads[0])
    print(f"generated {N_NEW} tokens/request")
    print(f"tier-1 hit rate: {t1}/{t1 + t2} = "
          f"{100 * t1 / max(t1 + t2, 1):.1f}%; evictions "
          f"{int(kv.evictions[0])}, write-backs {int(kv.writebacks[0])}")
    print(f"OL weights (lru/lfu/random): "
          f"{np.round(kv.ols.weights.numpy(), 3).tolist()}")
    print(f"sequences now at length {kv.lengths.tolist()}")
    print(f"kernel launches: {serve.launch_counts()}")
    print("serve_paged OK")
    return dict(tokens=res.tokens, logprobs=res.logprobs,
                t1_reads=t1, t2_reads=t2, lengths=kv.lengths.tolist())


if __name__ == "__main__":
    main()
