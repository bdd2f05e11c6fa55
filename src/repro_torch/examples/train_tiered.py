"""End-to-end training driver: a small LM (stablelm-3b's blocks at a
narrow width) trained through the tiered data pipeline with two-tier
checkpointing.

Default is a fast run; for the ~100M-parameter, 200-step run:

  PYTHONPATH=src python -m repro_torch.examples.train_tiered --full

Token shards go to ``data/shards`` and snapshots to ``ckpt/fast`` (every
10 steps) and ``ckpt/durable`` (every 50), relative to the working
directory; a second run resumes from the newest snapshot.
"""
from __future__ import annotations

import argparse

from repro_torch.launch.train import run_training
from repro_torch.training.checkpoint import CheckpointConfig


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true",
                    help="~100M params, 200 steps")
    ap.add_argument("--steps", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    if args.full:
        d_model, steps, batch, seq = 640, args.steps or 200, 8, 256
    else:
        d_model, steps, batch, seq = 128, args.steps or 30, 4, 64

    ck = CheckpointConfig(dir_tier1="ckpt/fast", dir_tier2="ckpt/durable",
                          tier1_every=10, tier2_every=50)
    out = run_training(
        arch="stablelm-3b", reduced=True, steps=steps, batch=batch, seq=seq,
        d_model_override=d_model, ckpt=ck, resume=True, lr=1e-3,
        device=args.device,
    )
    print(f"\nparams={out['n_params']/1e6:.1f}M "
          f"final_loss={out['final_loss']:.4f} "
          f"steps/s={out['steps_per_s']:.2f} "
          f"data-cache hits={out['cache_hits']} "
          f"misses={out['cache_misses']}")
    print("train_tiered OK")
    return out


if __name__ == "__main__":
    main()
