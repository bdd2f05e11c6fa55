"""Quickstart: the paper's pieces in one run.

  PYTHONPATH=src python -m repro_torch.examples.quickstart

1. Runs the two-tier store on Poisson + IRM traffic and shows the OL
   weight-sharing policy tracking the best expert (Tables V/VI).
2. Analyzes a two-tier configuration with the queuing network (§V).
3. Takes one training step of a reduced LM.
4. Decodes a few tokens through the paged two-tier KV cache.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs.archs import ARCHS
from repro_torch.core.queuing import TwoTierModel
from repro_torch.core.traffic import irm_stream, poisson_stream
from repro_torch.device import resolve_device, to_device
from repro_torch.models.params import init_params
from repro_torch.serving.engine import (ServeConfig, init_decode_state,
                                        make_decode_step)
from repro_torch.storage.tiered_store import StoreConfig, run_stream
from repro_torch.training.compression import init_error_feedback
from repro_torch.training.optimizer import adamw_init
from repro_torch.training.train_step import (TrainHyper, TrainState,
                                             make_train_step)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    dev = resolve_device(ap.parse_args(argv).device)

    print("=== 1. OL cache replacement (paper Tables V/VI) ===")
    for kind, gen in (("poisson", poisson_stream), ("irm", irm_stream)):
        pages, writes = gen(2000, 256, seed=1)
        row = {}
        for pol in ("lru", "lfu", "ws"):
            st = run_stream(StoreConfig(n_lines=64, policy=pol), pages,
                            writes, device=dev)
            row[pol] = int(st.misses)
        print(f"  {kind:8s} misses: lru={row['lru']} lfu={row['lfu']} "
              f"ws={row['ws']}  (WS tracks the best expert)")

    print("\n=== 2. Queuing network (§V worked example) ===")
    m = TwoTierModel(lam=100, mu1=1000, mu2=33, p12=0.2, k=1)
    s = m.analyze().summary()
    print(f"  lam_eff={s['lam_eff']:.1f} rho1={s['rho1']:.4f} "
          f"rho2={s['rho2']:.3f} equilibrium={bool(s['equilibrium'])}")

    print("\n=== 3. One train step (reduced stablelm-3b) ===")
    cfg = ARCHS["stablelm-3b"].reduced()
    params = init_params(cfg, 0, dev)
    state = TrainState(params, adamw_init(params, cfg.opt_state_dtype),
                       init_error_feedback(params))
    step = make_train_step(cfg, hyper=TrainHyper())
    rng = np.random.default_rng(0)
    batch = {k: to_device(torch.as_tensor(
        rng.integers(0, cfg.vocab, (2, 64)), dtype=torch.int32), dev)
        for k in ("tokens", "labels")}
    state, metrics = step(state, batch)
    print(f"  loss={float(metrics['loss']):.4f} "
          f"grad_norm={float(metrics['grad_norm']):.3f}")

    print("\n=== 4. Paged two-tier decode (tier-1 evictions live) ===")
    sc = ServeConfig(max_seq=64, batch_local=2, hbm_fraction=0.5)
    dstate = init_decode_state(cfg, sc, device=dev)
    dstep = make_decode_step(cfg, sc)
    tok = torch.as_tensor(rng.integers(0, cfg.vocab, (2,)),
                          dtype=torch.int32)
    for _ in range(24):
        dstate, (tok, lp) = dstep(state.params, dstate, tok)
    kv = dstate.kv
    print(f"  decoded 24 tokens; tier-1 page reads={int(kv.t1_reads[0])} "
          f"tier-2 (miss) reads={int(kv.t2_reads[0])}")
    print(f"  OL expert weights (lru/lfu/random): "
          f"{np.round(kv.ols.weights.numpy(), 3)}")
    print("\nquickstart OK")


if __name__ == "__main__":
    main()
