"""Training launcher: the two-tier data-shard cache -> the train step ->
two-tier checkpoints, with failure injection and restart.

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
        --steps 200 --batch 8 --seq 128
    PYTHONPATH=src python -m repro_torch.launch.train --full \\
        --steps 12 --batch 2 --seq 4096 --lr 3e-4

Runs on the card by default (``--device cpu`` for the plain path). The
weights are random, drawn from a seed (no download); the token shards are
generated from a seed into ``data/shards``. Without ``--full`` the
architecture's reduced variant trains; ``--full`` trains it at its
published width (stablelm-3b: 2.8 B parameters, bf16, f32 AdamW moments
and error feedback, remat), and ``--layers`` cuts its depth. The token
families train here (dense, MoE, mamba2, recurrentgemma); the data cache
yields tokens and labels only, as the reference's does, so whisper-tiny
(stub ``frames``) and paligemma-3b (``prefix_embeds``) are refused: they
train through :func:`repro_torch.training.train_step.make_train_step`
with a batch that carries them.

Fault tolerance, as the reference's (``repro.launch.train``):

- a step whose gradient norm is not finite leaves the state unchanged;
- tier-1 / tier-2 checkpoints and a restore of the newest valid one;
- ``--kill-at N`` returns after step N, as a failed worker would stop,
  and a relaunch resumes from the newest checkpoint.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch.configs.archs import get_config
from repro_torch.device import resolve_device, to_device
from repro_torch.models.params import init_params
from repro_torch.storage.datacache import (DataCache, DataCacheConfig,
                                           ShardedTokenStore)
from repro_torch.training.checkpoint import (CheckpointConfig,
                                             restore_checkpoint,
                                             save_checkpoint)
from repro_torch.training.compression import init_error_feedback
from repro_torch.training.optimizer import AdamWConfig, adamw_init
from repro_torch.training.train_step import (TrainHyper, TrainState,
                                             make_train_step)
from repro_torch.training.tree import leaves

__all__ = ["run_training", "main"]


def run_training(
    *,
    arch: str = "stablelm-3b",
    reduced: bool = True,
    steps: int = 100,
    batch: int = 8,
    seq: int = 128,
    lr: float = 3e-4,
    data_dir: str = "data/shards",
    ckpt: CheckpointConfig = CheckpointConfig(),
    kill_at: int = -1,
    resume: bool = True,
    log_every: int = 10,
    d_model_override: int = 0,
    layers: int = 0,
    device=None,
) -> dict:
    """Train ``steps`` steps (from the newest checkpoint with ``resume``)
    on ``device`` (``None`` = the card), the parameters drawn from seed 0.
    ``layers`` cuts the depth (0 keeps it).

    Returns the reference's dict: ``losses``, ``final_loss``,
    ``steps_per_s``, ``n_params``, ``cache_hits``, ``cache_misses``, or
    ``killed_at``, ``losses`` and ``n_params`` on a kill; and besides,
    ``grad_norms``, the MoE's ``aux_losses`` and ``dropped`` (zeros for
    the other models), and ``step_s`` (each step's wall time, the batch's
    assembly and copy included, the checkpoints not), ``save_s`` and
    ``restore_s`` (the checkpoints' wall time), and the final ``state``.
    """
    cfg = get_config(arch)
    extras = [k for k, needed in (("frames", cfg.enc_dec),
                                  ("prefix_embeds", bool(cfg.vlm_prefix)))
              if needed]
    if extras:
        raise ValueError(
            f"{arch} trains on a batch with {' and '.join(extras)} besides "
            "tokens and labels, which the data-shard cache does not hold: "
            "train it through make_train_step with stub embeddings")
    dev = resolve_device(device)
    if reduced:
        cfg = cfg.reduced()
    if d_model_override:
        cfg = dataclasses.replace(
            cfg, d_model=d_model_override,
            n_heads=max(4, d_model_override // 64), head_dim=64,
            n_kv_heads=max(1, min(cfg.n_kv_heads, 4)),
            d_ff=d_model_override * 3 if cfg.d_ff else 0,
        )
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=layers)

    params = init_params(cfg, 0, dev)
    n_params = sum(p.numel() for p in leaves(params))
    state = TrainState(
        params=params,
        opt=adamw_init(params, cfg.opt_state_dtype),
        err_fb=init_error_feedback(params),
    )
    start, restore_s = 0, 0.0
    if resume:
        t0 = time.perf_counter()
        try:
            state, start = restore_checkpoint(state, ckpt)
            restore_s = time.perf_counter() - t0
            print(f"[restore] resumed from step {start}")
        except FileNotFoundError:
            pass

    hyper = TrainHyper(adamw=AdamWConfig(lr=lr, warmup_steps=20,
                                         decay_steps=max(steps, 100)))
    step_fn = make_train_step(cfg, hyper=hyper)

    store = ShardedTokenStore(data_dir, n_shards=16,
                              shard_tokens=batch * (seq + 1) * 4,
                              vocab=cfg.vocab)
    cache = DataCache(store, DataCacheConfig(cache_shards=4))

    losses, gnorms, aux, dropped, step_s = [], [], [], [], []
    save_s = 0.0
    t_run = time.perf_counter()
    for step in range(start, steps):
        t0 = time.perf_counter()
        b = {k: to_device(torch.from_numpy(v), dev)
             for k, v in cache.batch(step, batch, seq).items()}
        state, metrics = step_fn(state, b)
        losses.append(float(metrics["loss"]))
        gnorms.append(float(metrics["grad_norm"]))
        aux.append(float(metrics["aux_loss"]))
        dropped.append(float(metrics["dropped"]))
        step_s.append(time.perf_counter() - t0)
        if step % log_every == 0 or step == steps - 1:
            print(f"step {step:5d} loss {losses[-1]:.4f} "
                  f"gnorm {gnorms[-1]:.3f} "
                  f"cache hit% {100*cache.hits/max(cache.hits+cache.misses,1):.0f}")
        t0 = time.perf_counter()
        if save_checkpoint(state, step + 1, ckpt):
            save_s += time.perf_counter() - t0
        if kill_at == step:
            print(f"[fault-injection] simulated failure at step {step}")
            return {"killed_at": step, "losses": losses,
                    "n_params": n_params, "grad_norms": gnorms,
                    "aux_losses": aux, "dropped": dropped, "step_s": step_s, "save_s": save_s,
                    "restore_s": restore_s, "state": state}
    return {
        "losses": losses,
        "final_loss": losses[-1] if losses else float("nan"),
        "steps_per_s": (steps - start) / max(time.perf_counter() - t_run,
                                             1e-9),
        "n_params": n_params,
        "cache_hits": cache.hits,
        "cache_misses": cache.misses,
        "grad_norms": gnorms,
        "aux_losses": aux,
        "dropped": dropped,
        "step_s": step_s,
        "save_s": save_s,
        "restore_s": restore_s,
        "state": state,
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm-3b")
    ap.add_argument("--full", action="store_true",
                    help="use the full config (default reduced)")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the depth to this many layers (0 keeps it)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--kill-at", type=int, default=-1)
    ap.add_argument("--d-model", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    out = run_training(arch=args.arch, reduced=not args.full,
                       steps=args.steps, batch=args.batch, seq=args.seq,
                       lr=args.lr, kill_at=args.kill_at,
                       d_model_override=args.d_model, layers=args.layers,
                       device=args.device)
    print({k: v for k, v in out.items()
           if k not in ("losses", "grad_norms", "aux_losses", "dropped",
                        "step_s", "state")})


if __name__ == "__main__":
    main()
