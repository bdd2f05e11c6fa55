"""Model trunk on one card: attention, RG-LRU and SSD blocks.

A model is a cycled ``block_pattern`` whose parameters are stacked per
pattern position (``[reps, ...]``) plus an unstacked tail, with an
embedding and an unembedding. An attention block is pre-norm
self-attention (RoPE, GQA; sliding-window for ``attn_swa`` /
``attn_local``) and a SwiGLU FFN; an RG-LRU block is the pre-norm Griffin
recurrent block and a SwiGLU FFN; an SSD block is the pre-norm Mamba-2
block alone. The prefill runs its attention through the flash kernel
(:mod:`repro_torch.kernels.flash_attention`) and its scans through the
SSD and RG-LRU kernels (the kernels on the card, their plain versions on
the CPU); :func:`fwd_hidden`, the independent full forward that decode is
checked against, runs the plain
:func:`~repro_torch.models.attention.blockwise_attention`, as the
reference's does. :func:`fwd_train` is the training loss on
:func:`fwd_hidden`, each block under ``torch.utils.checkpoint`` when the
configuration asks for remat (the reference's ``jax.checkpoint`` of each
superblock); the reference's training forward reaches no Pallas kernel,
and neither does the port's.

The reference's MoE, encoder and VLM-prefix blocks are not ported yet
(ROADMAP module item 4); :func:`repro_torch.models.params.block_defs` raises
for them.
"""
from __future__ import annotations

from typing import Callable, Iterator, NamedTuple, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig, SSMConfig
from repro_torch.kernels import flash_attention as fa
from repro_torch.models import params as pm
from repro_torch.models.attention import blockwise_attention
from repro_torch.models.layers import (apply_rope, dense, embed, mlp_swiglu,
                                       rms_norm, rope_tables, unembed_loss)
from repro_torch.models.rglru import recurrent_block
from repro_torch.models.ssd import ssd_block

__all__ = ["Layer", "layers", "apply_block", "fwd_hidden", "fwd_train",
           "Metrics"]

_F32 = torch.float32


class Metrics(NamedTuple):
    loss: torch.Tensor
    aux_loss: torch.Tensor
    dropped: torch.Tensor


class Layer(NamedTuple):
    kind: str
    p: dict                 # the layer's parameters
    li: Optional[int]       # attention layer index in the pools (else None)
    pos: int                # pattern position (stacked) or tail index
    rep: Optional[int]      # repeat of the pattern; None in the tail


def layers(params: dict, cfg: ModelConfig) -> Iterator[Layer]:
    """Every layer in order: the stacked superblocks, then the tail. A
    stacked leaf is unbound once, so that under autograd its gradient is
    one stack of the layers' gradients (indexing it layer by layer would
    add a zero-filled gradient of the whole stack for every layer)."""
    attn_pp = tuple(i for i, k in enumerate(cfg.block_pattern)
                    if k.startswith("attn"))
    reps, tail = pm.model_layout(cfg)
    unbound = [{k: w.unbind(0) for k, w in blk.items()}
               for blk in params["blocks"]]
    for r in range(reps):
        for i, kind in enumerate(cfg.block_pattern):
            p = {k: w[r] for k, w in unbound[i].items()}
            li = (r * len(attn_pp) + attn_pp.index(i)
                  if kind.startswith("attn") else None)
            yield Layer(kind, p, li, i, r)
    for i, kind in enumerate(tail):
        li = (reps * len(attn_pp) + sum(1 for k in tail[:i]
                                        if k.startswith("attn"))
              if kind.startswith("attn") else None)
        yield Layer(kind, params["tail"][i], li, i, None)


def _flash(q, k, v, *, causal: bool, window: Optional[int]):
    """The flash-attention wrapper on the model's ``[B, S, H, hd]`` layout
    (transposed views, no copies)."""
    o = fa.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                           v.transpose(1, 2), causal=causal, window=window)
    return o.transpose(1, 2)


def _self_attention(x, p, cfg: ModelConfig, rope, *, kind: str,
                    attend: Callable):
    B, S, _ = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    h = rms_norm(x, p["norm"], cfg.norm_eps)
    q = dense(h, p["wq"]).reshape(B, S, H, hd)
    k = dense(h, p["wk"]).reshape(B, S, KV, hd)
    v = dense(h, p["wv"]).reshape(B, S, KV, hd)
    q = apply_rope(q, rope)
    k = apply_rope(k, rope)
    window = cfg.window if kind in ("attn_swa", "attn_local") else None
    o = attend(q, k, v, causal=True, window=window)
    return dense(o.reshape(B, S, H * hd), p["wo"]), (k, v)


def _ffn(x, p, cfg: ModelConfig):
    h = rms_norm(x, p["norm2"], cfg.norm_eps)
    return mlp_swiglu(h, p["w_gate"], p["w_up"], p["w_down"])


def apply_block(kind: str, x, p: dict, cfg: ModelConfig, rope, *,
                attend: Callable = _flash, capture: bool = False):
    """One block over a sequence (``rope``: the positions' :func:`~
    repro_torch.models.layers.rope_tables`). Returns ``(x, extras)``: the
    new residual stream, and for an attention block its RoPE'd keys and
    values ``[B, S, KV, hd]`` (the paged pools' layout), for a recurrent
    block its decode state with ``capture`` (else None)."""
    if kind.startswith("attn"):
        delta, kv = _self_attention(x, p, cfg, rope, kind=kind,
                                    attend=attend)
        x = x + delta
        return x + _ffn(x, p, cfg), kv
    h = rms_norm(x, p["norm"], cfg.norm_eps)
    if kind == "rglru":
        delta, state = recurrent_block(h, p, capture=capture)
        x = x + delta
        return x + _ffn(x, p, cfg), state
    if kind == "ssd":
        delta, state = ssd_block(h, p, cfg.ssm or SSMConfig(),
                                 capture=capture)
        return x + delta, state
    raise ValueError(kind)


def _remat_block(kind: str, x, p: dict, cfg: ModelConfig, rope):
    return apply_block(kind, x, p, cfg, rope, attend=blockwise_attention)[0]


def fwd_hidden(params: dict, tokens: torch.Tensor,
               cfg: ModelConfig) -> torch.Tensor:
    """Token ids ``[B, S]`` -> final (normed) hidden states ``[B, S, d]``,
    with blockwise attention. Under autograd with ``cfg.remat``, each block
    keeps only its input and recomputes the rest in the backward pass."""
    tokens = torch.as_tensor(tokens).to(params["embed"].device)
    x = embed(tokens, params["embed"])
    rope = rope_tables(torch.arange(x.shape[1], device=x.device)[None, :],
                       cfg.head_dim, cfg.rope_theta)
    remat = cfg.remat and torch.is_grad_enabled()
    for layer in layers(params, cfg):
        if remat:
            x = checkpoint(_remat_block, layer.kind, x, layer.p, cfg, rope,
                           use_reentrant=False)
        else:
            x, _ = apply_block(layer.kind, x, layer.p, cfg, rope,
                               attend=blockwise_attention)
    return rms_norm(x, params["final_norm"], cfg.norm_eps)


def fwd_train(params: dict, batch: dict, cfg: ModelConfig, *,
              aux_weight: float = 0.01) -> tuple[torch.Tensor, Metrics]:
    """Next-token loss of ``batch`` (``tokens`` and ``labels``, ``[B, S]``)
    and its metrics. The unembedding is ``unembed``, or ``embed`` when
    tied; dense models have no auxiliary loss and drop no token. Only
    attention blocks train here: the SSD and RG-LRU scans have no gradient
    yet."""
    kinds = set(cfg.layer_kinds())
    if not all(k.startswith("attn") for k in kinds):
        raise NotImplementedError(
            f"training {cfg.name}: the {sorted(kinds)} blocks' scans have no "
            "gradient yet (ROADMAP module item 5)")
    x = fwd_hidden(params, batch["tokens"], cfg)
    key = ("embed" if cfg.tie_embeddings or "unembed" not in params
           else "unembed")
    labels = torch.as_tensor(batch["labels"]).to(x.device)
    loss = unembed_loss(x, params[key], labels)
    aux = torch.zeros((), dtype=_F32, device=x.device)
    dropped = torch.zeros((), dtype=_F32, device=x.device)
    loss = loss + aux_weight * aux
    return loss, Metrics(loss=loss, aux_loss=aux, dropped=dropped)
