"""Serving launcher: batched requests through the paged two-tier engine.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch mistral-nemo-12b \\
        --full --requests 8 --prompt 3072 --new 258 --hbm-fraction 0.5

Runs on the card by default (``--device cpu`` for the plain path). The
weights are random, drawn from a seed (no download). Prints the prefill
and decode times, the tier-1 / tier-2 page reads, evictions and
write-backs, the OL learner's weights and the kernels' launch counts: the
paper's fig. 2 pipeline end to end. Without ``--full`` the architecture's
reduced variant runs. ``--arch mamba2-370m`` (no attention, so no KV
pools) and ``--arch recurrentgemma-9b`` (RG-LRU blocks and sliding-window
attention) run their scans through the SSD and RG-LRU kernels.
``--arch whisper-tiny`` (an encoder-decoder: each request brings
``enc_seq`` stub frame embeddings, encoded once at prefill and attended
to by every decoder layer), ``--arch paligemma-3b`` (each request's
``vlm_prefix`` stub patch embeddings form a bidirectional prefix before
the prompt) and ``--arch mixtral-8x22b`` (top-2 of 8 experts behind
sliding-window attention) serve the other families; the stub embeddings
are drawn from the same seeded generator as the prompts
(:func:`make_extras`). ``--int8-kv`` keeps the KV pools in int8 with an
f32 scale a (token, k/v), read by the paged-attention kernel's int8
variant.
"""
from __future__ import annotations

import argparse
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.configs.archs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import page_gather as pg
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels import rglru_scan as rs
from repro_torch.kernels import ssd_scan as ss
from repro_torch.models.params import init_params
from repro_torch.serving import kvpool as kvp
from repro_torch.serving.engine import (DecodeState, ServeConfig,
                                        make_decode_step, make_kv_spec,
                                        make_prefill_step)

__all__ = ["build", "make_extras", "serve", "ServeResult", "launch_counts",
           "reset_launch_counts", "main"]


class ServeResult(NamedTuple):
    tokens: np.ndarray    # int32 [B, new]: the prefill's token, then decode's
    logprobs: np.ndarray  # f32 [B, new]
    state: DecodeState
    prefill_s: float
    decode_s: float


def build(arch: str, *, full: bool = False, seed: int = 0,
          device=None) -> tuple[ModelConfig, dict]:
    """The configuration and random parameters (``seed``) on ``device``
    (``None`` = the card)."""
    cfg = get_config(arch)
    if not full:
        cfg = cfg.reduced()
    return cfg, init_params(cfg, seed, device)


def make_extras(cfg: ModelConfig, n: int, rng: np.random.Generator,
                device=None) -> dict:
    """The per-request inputs that are not tokens, as the reference's
    launcher makes them: whisper's stub frame embeddings ``frames [n,
    enc_seq, d]`` and a VLM's stub patch embeddings ``prefix_embeds [n,
    vlm_prefix, d]``, each ``normal x 0.02`` from ``rng`` (frames first),
    in the parameters' dtype on ``device``; ``{}`` for other models."""
    dtype = getattr(torch, cfg.param_dtype)
    out = {}
    for name, n_pos, on in (("frames", cfg.enc_seq, cfg.enc_dec),
                            ("prefix_embeds", cfg.vlm_prefix,
                             bool(cfg.vlm_prefix))):
        if on:
            x = rng.normal(size=(n, n_pos, cfg.d_model)) * 0.02
            out[name] = torch.as_tensor(x).to(device=device, dtype=dtype)
    return out


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def serve(cfg: ModelConfig, params: dict, prompts, *, new: int,
          hbm_fraction: float = 0.5, promote_every: int = 4,
          n_promote: int = 2, forced: Optional[torch.Tensor] = None,
          max_seq: Optional[int] = None,
          kv_dtype: str = "auto",
          extras: Optional[dict] = None) -> ServeResult:
    """Prefill ``prompts`` ``[B, S]`` (with ``extras``: whisper's
    ``frames``, a VLM's ``prefix_embeds``, see :func:`make_extras`), then
    ``new - 1`` decode steps, greedy (or fed ``forced [B, new - 1]``
    instead of the generated tokens: teacher forcing), promoting pages
    every ``promote_every`` steps, on the parameters' device. The pools
    hold ``max_seq`` tokens a sequence (default: a VLM's prefix, the
    prompt and ``new``, up to whole pages) in ``kv_dtype`` (``"auto"``:
    the parameters' dtype; or ``"int8"``)."""
    dev = params["embed"].device
    prompts = torch.as_tensor(prompts)
    B, S = prompts.shape
    extras = extras or {}
    if max_seq is None:
        n = S + new + (extras["prefix_embeds"].shape[1]
                       if "prefix_embeds" in extras else 0)
        max_seq = -(-n // cfg.page_size) * cfg.page_size
    sc = ServeConfig(max_seq=max_seq, batch_local=B, page_axes=(),
                     hbm_fraction=hbm_fraction, n_promote=n_promote,
                     kv_dtype=kv_dtype)
    spec = make_kv_spec(cfg, sc)
    prefill = make_prefill_step(cfg, sc)
    decode = make_decode_step(cfg, sc)

    _sync(dev)
    t0 = time.perf_counter()
    state, (tok, lp) = prefill(params, prompts, extras)
    _sync(dev)
    prefill_s = time.perf_counter() - t0

    toks, lps = [tok], [lp]
    t0 = time.perf_counter()
    for t in range(new - 1):
        state, (tok, lp) = decode(params, state,
                                  tok if forced is None else forced[:, t])
        toks.append(tok)
        lps.append(lp)
        if state.kv is not None and t % promote_every == promote_every - 1:
            state = state._replace(kv=kvp.promote_pages(state.kv, spec,
                                                        sc.n_promote))
    _sync(dev)
    decode_s = time.perf_counter() - t0
    return ServeResult(
        tokens=torch.stack(toks, 1).cpu().numpy(),
        logprobs=torch.stack(lps, 1).float().cpu().numpy(), state=state,
        prefill_s=prefill_s, decode_s=decode_s)


def launch_counts() -> dict:
    return dict(flash_attention=fa.flash_attention_launch_count(),
                paged_attention=pa.paged_attention_launch_count(),
                page_copy=pg.page_copy_launch_count(),
                ssd_scan=ss.ssd_scan_launch_count(),
                rglru_scan=rs.rglru_scan_launch_count())


def reset_launch_counts() -> None:
    fa.reset_flash_attention_launch_count()
    pa.reset_paged_attention_launch_count()
    pg.reset_page_copy_launch_count()
    ss.reset_ssd_scan_launch_count()
    rs.reset_rglru_scan_launch_count()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mistral-nemo-12b")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt", type=int, default=32)
    ap.add_argument("--new", type=int, default=32)
    ap.add_argument("--hbm-fraction", type=float, default=0.5)
    ap.add_argument("--int8-kv", action="store_true")
    ap.add_argument("--promote-every", type=int, default=4)
    ap.add_argument("--full", action="store_true",
                    help="use the full config (default reduced)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    cfg, params = build(args.arch, full=args.full, device=args.device)
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab, (args.requests, args.prompt))
    extras = make_extras(cfg, args.requests, rng, params["embed"].device)
    reset_launch_counts()
    res = serve(cfg, params, prompts.astype(np.int32), new=args.new,
                hbm_fraction=args.hbm_fraction,
                promote_every=args.promote_every,
                kv_dtype="int8" if args.int8_kv else "auto", extras=extras)
    kv = res.state.kv
    steps = args.new - 1
    shapes = "".join(f"{k}={list(v.shape[1:])} " for k, v in extras.items())
    print(f"arch={cfg.name} requests={args.requests} prompt={args.prompt} "
          f"new={args.new} {shapes}"
          f"kv={'int8' if args.int8_kv else cfg.param_dtype} device="
          f"{params['embed'].device}")
    print(f"prefill {res.prefill_s:.3f}s; decode {res.decode_s:.3f}s "
          f"({args.requests * steps / max(res.decode_s, 1e-9):.1f} tok/s, "
          f"{1e3 * res.decode_s / max(steps, 1):.2f} ms/step)")
    if kv is None:
        print("no attention layers: no KV pools, no tier traffic")
    else:
        t1, t2 = int(kv.t1_reads[0]), int(kv.t2_reads[0])
        print(f"tier-1 page reads {t1}, tier-2 (miss) {t2} -> hit rate "
              f"{100 * t1 / max(t1 + t2, 1):.1f}%; evictions "
              f"{int(kv.evictions[0])}, write-backs "
              f"{int(kv.writebacks[0])}")
        print(f"OL weights (lru/lfu/random): {kv.ols.weights.tolist()}")
    print(f"kernel launches: {launch_counts()}")
    print(f"first generations: {res.tokens[:2, :8].tolist()}")


if __name__ == "__main__":
    main()
