"""Model trunk on one card: attention, RG-LRU and SSD blocks, whisper's
encoder and paligemma's prefix.

A model is a cycled ``block_pattern`` whose parameters are stacked per
pattern position (``[reps, ...]``) plus an unstacked tail, with an
embedding and an unembedding. An attention block is pre-norm
self-attention (RoPE, GQA; sliding-window for ``attn_swa`` /
``attn_local``; prefix-LM over a VLM's patch embeddings), for whisper's
decoder a pre-norm cross-attention over the encoder's output, and an FFN:
SwiGLU, the top-k MoE of :mod:`repro_torch.models.moe`, or whisper's gelu
MLP with biases. Whisper's positions are absolute (sinusoids added to
the embeddings, no RoPE), and its encoder (:func:`encode_frames`) runs
full attention over stub frame embeddings. An RG-LRU block is the
pre-norm Griffin recurrent block and an FFN; an SSD block is the pre-norm
Mamba-2 block alone. The prefill runs its attention through the flash kernel
(:mod:`repro_torch.kernels.flash_attention`) and its scans through the
SSD and RG-LRU kernels (the kernels on the card, their plain versions on
the CPU); :func:`fwd_hidden`, the training forward and the independent
full forward that decode is checked against, runs the reference's own
training forms under autograd: the plain
:func:`~repro_torch.models.attention.blockwise_attention`, the chunked SSD
scan :func:`~repro_torch.models.ssd.ssd_chunked` and the associative
RG-LRU scan :func:`~repro_torch.models.rglru.rglru_scan`. So training
reaches no hand kernel, as the reference's reaches no Pallas kernel (the
kernels have no backward; their dispatchers refuse autograd).
:func:`fwd_train` is the training loss on :func:`fwd_hidden`, each block
under ``torch.utils.checkpoint`` when the configuration asks for remat
(the reference's ``jax.checkpoint`` of each superblock), with the MoE's
auxiliary loss, whisper's stub frames and a VLM's patch embeddings from
the batch.

The blocks run under a mesh as the reference's do (an
:class:`~repro_torch.distributed.axes.Axes` ``ax``, :data:`SINGLE` by
default): each layer's FSDP-sharded weights are all-gathered over the
data axis before the layer runs (ZeRO-3; the prefill in :func:`layers`,
training inside the block that remat recomputes); attention takes this
rank's query heads over the KV heads their groups need
(:func:`_local_kv_slice`) and sums ``wo``'s partial products over the
model axis; the FFNs and the recurrent blocks take theirs likewise.
Training runs the same way, with the gradient reductions that the
collectives' backwards and the entry markers place
(:mod:`repro_torch.distributed.axes`).
"""
from __future__ import annotations

from typing import Callable, Iterator, NamedTuple, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig, SSMConfig
from repro_torch.distributed.axes import SINGLE, Axes
from repro_torch.kernels import flash_attention as fa
from repro_torch.models import moe
from repro_torch.models import params as pm
from repro_torch.models.attention import blockwise_attention
from repro_torch.models.layers import (apply_rope, dense, embed, mlp_gelu,
                                       mlp_swiglu, rms_norm, rope_tables,
                                       sinusoidal_positions, tp_out,
                                       unembed_loss)
from repro_torch.models.rglru import recurrent_block, rglru_scan
from repro_torch.models.ssd import ssd_block, ssd_chunked

__all__ = ["Layer", "layers", "ffn", "cross_kv", "apply_block",
           "encode_frames", "positions_in", "fwd_hidden", "fwd_train",
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


def _fetch(ax: Axes, p: dict, fdims: Optional[dict]) -> dict:
    """A layer's weights with its FSDP-sharded leaves all-gathered over
    the data axis (the identity without one)."""
    if ax.data is None or fdims is None:
        return p
    return {k: ax.fsdp_gather(w, fdims[k]) for k, w in p.items()}


def layers(params: dict, cfg: ModelConfig, ax: Axes = SINGLE,
           fdims: Optional[dict] = None) -> Iterator[Layer]:
    """Every layer in order: the stacked superblocks, then the tail. A
    stacked leaf is unbound once, so that under autograd its gradient is
    one stack of the layers' gradients (indexing it layer by layer would
    add a zero-filled gradient of the whole stack for every layer). Under
    a data axis each layer's FSDP-sharded weights (``fdims``,
    :func:`~repro_torch.models.params.fsdp_dims`) are gathered as the
    layer comes up."""
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
            yield Layer(kind, _fetch(ax, p, fdims and fdims["blocks"][i]),
                        li, i, r)
    for i, kind in enumerate(tail):
        li = (reps * len(attn_pp) + sum(1 for k in tail[:i]
                                        if k.startswith("attn"))
              if kind.startswith("attn") else None)
        yield Layer(kind, _fetch(ax, params["tail"][i],
                                 fdims and fdims["tail"][i]), li, i, None)


def _flash(q, k, v, **kw):
    """The flash-attention wrapper on the model's ``[B, S, H, hd]`` layout
    (transposed views, no copies)."""
    o = fa.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                           v.transpose(1, 2), **kw)
    return o.transpose(1, 2)


def _heads_in(h, cfg: ModelConfig, ax: Axes):
    """``h`` as the split query projection consumes it: entered over the
    model axis where the heads are split (:meth:`Axes.enter`)."""
    if ax.tp_degree(cfg.n_heads) > 1:
        return ax.enter(h, (ax.model,))
    return h


def _qkv(h, p, cfg: ModelConfig, ax: Axes = SINGLE):
    """The projections ``q [B, S, H_local, hd]`` (this rank's query heads)
    and ``k, v [B, S, KV, hd]`` (every KV head)."""
    B, S, _ = h.shape
    KV, hd = cfg.n_kv_heads, cfg.head_dim
    return (dense(_heads_in(h, cfg, ax), p["wq"]).reshape(B, S, -1, hd),
            dense(h, p["wk"]).reshape(B, S, KV, hd),
            dense(h, p["wv"]).reshape(B, S, KV, hd))


def _local_kv_slice(k, v, cfg: ModelConfig, ax: Axes):
    """The KV heads ``[..., KV, hd]`` (replicated over the model axis)
    that this rank's query heads attend to: with TP over the heads, the
    groups of its ``H / tp`` heads (k and v entered over the axis, so
    their gradients are summed over the ranks' slices)."""
    H, KV = cfg.n_heads, cfg.n_kv_heads
    tp_h = ax.tp_degree(H)
    if tp_h == 1:
        return k, v
    k, v = ax.enter(k, (ax.model,)), ax.enter(v, (ax.model,))
    h_local = H // tp_h
    count = max(1, (h_local * KV) // H)
    start = (ax.index(ax.model) * h_local * KV) // H
    return k[:, :, start:start + count], v[:, :, start:start + count]


def _attn_out(o, w, cfg: ModelConfig, ax: Axes):
    """Attention's output projection of ``o [B, S, H_local, hd]``: a TP
    partial sum over the model axis where the heads are split."""
    B, S = o.shape[:2]
    if ax.tp_degree(cfg.n_heads) > 1:
        return tp_out(o.reshape(B, S, -1), w, ax)
    return dense(o.reshape(B, S, -1), w)


def _self_attention(x, p, cfg: ModelConfig, rope, *, kind: str,
                    attend: Callable, prefix_len: int = 0,
                    ax: Axes = SINGLE):
    h = rms_norm(x, p["norm"], cfg.norm_eps)
    q, k, v = _qkv(h, p, cfg, ax)
    if cfg.family != "audio":  # whisper's positions are absolute
        q = apply_rope(q, rope)
        k = apply_rope(k, rope)
    window = cfg.window if kind in ("attn_swa", "attn_local") else None
    o = attend(q, *_local_kv_slice(k, v, cfg, ax), causal=True,
               window=window, prefix_len=prefix_len)
    return _attn_out(o, p["wo"], cfg, ax), (k, v)


def cross_kv(enc_out, p, cfg: ModelConfig):
    """A decoder layer's cross-attention keys and values ``[B, T_enc, KV,
    hd]`` from the encoder's output: the decode state it keeps."""
    B, T, _ = enc_out.shape
    shape = (B, T, cfg.n_kv_heads, cfg.head_dim)
    return (dense(enc_out, p["xwk"]).reshape(shape),
            dense(enc_out, p["xwv"]).reshape(shape))


def _cross_attention(x, enc_out, p, cfg: ModelConfig, attend: Callable,
                     ax: Axes = SINGLE):
    """Whisper's cross-attention: full attention of the decoder's queries
    over the encoder's output."""
    B, S, _ = x.shape
    h = rms_norm(x, p["xnorm"], cfg.norm_eps)
    q = dense(_heads_in(h, cfg, ax), p["xwq"]).reshape(B, S, -1,
                                                        cfg.head_dim)
    k, v = _local_kv_slice(*cross_kv(enc_out, p, cfg), cfg, ax)
    o = attend(q, k, v, causal=False)
    return _attn_out(o, p["xwo"], cfg, ax)


def _ffn(x, p, cfg: ModelConfig, ax: Axes = SINGLE):
    """The pre-norm FFN of an attention or RG-LRU block over ``x [..., d]``:
    the MoE, whisper's gelu MLP, or SwiGLU. Returns ``(delta, aux_loss,
    dropped)``, the last two f32 scalars for the MoE and None otherwise
    (the reference's zeros)."""
    h = rms_norm(x, p["norm2"], cfg.norm_eps)
    if cfg.moe is not None:
        out = moe.moe_swiglu(h.reshape(-1, h.shape[-1]), p["w_router"],
                             p["w_gate"], p["w_up"], p["w_down"], cfg.moe,
                             ax=ax)
        return out.y.reshape(h.shape), out.aux_loss, out.dropped
    if cfg.family == "audio":
        return (mlp_gelu(h, p["w1"], p["b1"], p["w2"], p["b2"], ax), None,
                None)
    return mlp_swiglu(h, p["w_gate"], p["w_up"], p["w_down"], ax), None, None


def ffn(x, p, cfg: ModelConfig, ax: Axes = SINGLE):
    """The FFN's ``delta`` alone (the decode step's)."""
    return _ffn(x, p, cfg, ax)[0]


def _block(kind: str, x, p: dict, cfg: ModelConfig, rope, *,
           attend: Callable = _flash, ssd_scan: Optional[Callable] = None,
           rglru_scan: Optional[Callable] = None, capture: bool = False,
           prefix_len: int = 0, enc_out=None, ax: Axes = SINGLE):
    """One block over a sequence, as the reference's ``apply_block``
    (``rope``: the positions' :func:`~repro_torch.models.layers.
    rope_tables`, unused for whisper; ``prefix_len``: the bidirectional
    prefix of a VLM; ``enc_out``: the encoder's output, attended to by a
    decoder layer's cross-attention; ``attend``, ``ssd_scan`` and
    ``rglru_scan``: the attention and the scans, by default the kernels'
    dispatchers, looked up at the call). Returns ``(x, aux_loss, dropped, extras)``: the new
    residual stream, the MoE's auxiliary loss and dropped fraction (None
    without MoE), and for an attention block its RoPE'd keys and values
    ``[B, S, KV, hd]`` (the paged pools' layout), for a recurrent block
    its decode state with ``capture`` (else None)."""
    if kind.startswith("attn"):
        delta, kv = _self_attention(x, p, cfg, rope, kind=kind,
                                    attend=attend, prefix_len=prefix_len,
                                    ax=ax)
        x = x + delta
        if enc_out is not None and "xwq" in p:
            x = x + _cross_attention(x, enc_out, p, cfg, attend, ax)
        delta, aux, dropped = _ffn(x, p, cfg, ax)
        return x + delta, aux, dropped, kv
    h = rms_norm(x, p["norm"], cfg.norm_eps)
    if kind == "rglru":
        delta, state = recurrent_block(h, p, capture=capture,
                                       scan=rglru_scan, ax=ax)
        x = x + delta
        delta, aux, dropped = _ffn(x, p, cfg, ax)
        return x + delta, aux, dropped, state
    if kind == "ssd":
        delta, state = ssd_block(h, p, cfg.ssm or SSMConfig(),
                                 capture=capture, scan=ssd_scan, ax=ax)
        return x + delta, None, None, state
    raise ValueError(kind)


def apply_block(kind: str, x, p: dict, cfg: ModelConfig, rope, *,
                capture: bool = False, prefix_len: int = 0, enc_out=None,
                ax: Axes = SINGLE):
    """The prefill's block, through the kernels: ``(x, extras)`` of
    :func:`_block`."""
    x, _, _, extras = _block(kind, x, p, cfg, rope, capture=capture,
                             prefix_len=prefix_len, enc_out=enc_out, ax=ax)
    return x, extras


def _remat_block(kind: str, x, p: dict, cfg: ModelConfig, rope,
                 prefix_len: int = 0, enc_out=None, ax: Axes = SINGLE,
                 fdims: Optional[dict] = None):
    """A block of :func:`fwd_hidden`, through the training forms: ``(x,
    aux_loss, dropped)`` of :func:`_block`. The layer's FSDP-sharded
    weights are gathered here, inside the block that remat recomputes,
    so that the backward gathers them again (as the reference's
    ``jax.checkpoint`` of its superblock does) and every rank issues the
    same collectives in the same order."""
    return _block(kind, x, _fetch(ax, p, fdims), cfg, rope,
                  attend=blockwise_attention, ssd_scan=ssd_chunked,
                  rglru_scan=rglru_scan, prefix_len=prefix_len,
                  enc_out=enc_out, ax=ax)[:3]


def encode_frames(frames, params: dict, cfg: ModelConfig, *,
                  attend: Callable = _flash, ax: Axes = SINGLE,
                  fdims: Optional[dict] = None):
    """Whisper's encoder over stub frame embeddings ``[B, T_enc, d]``:
    sinusoidal positions, then each encoder layer's pre-norm full
    self-attention and gelu MLP, then the final norm."""
    T = frames.shape[1]
    pos = torch.arange(T, device=frames.device)
    x = frames + sinusoidal_positions(pos, cfg.d_model)[None].to(frames.dtype)
    enc = params["enc_blocks"][0]
    for i in range(cfg.n_enc_layers):
        p = _fetch(ax, {k: w[i] for k, w in enc.items()},
                   fdims and fdims["enc_blocks"][0])
        h = rms_norm(x, p["norm"], cfg.norm_eps)
        q, k, v = _qkv(h, p, cfg, ax)
        o = attend(q, *_local_kv_slice(k, v, cfg, ax), causal=False)
        x = x + _attn_out(o, p["wo"], cfg, ax)
        x = x + ffn(x, p, cfg, ax)
    return rms_norm(x, params["enc_final_norm"], cfg.norm_eps)


def positions_in(x, cfg: ModelConfig, *, prefix_embeds=None):
    """The input sequence of the decoder stack: the embeddings ``x [B, S,
    d]`` after a VLM's prefix embeddings ``[B, P, d]`` (prefix-LM over
    both), with whisper's sinusoidal positions added. Returns ``(x,
    prefix_len, rope)``; ``rope`` is None for whisper."""
    prefix_len = 0
    if prefix_embeds is not None:
        prefix_len = prefix_embeds.shape[1]
        x = torch.cat([prefix_embeds.to(x.device, x.dtype), x], dim=1)
    pos = torch.arange(x.shape[1], device=x.device)
    if cfg.family == "audio":
        return (x + sinusoidal_positions(pos, cfg.d_model)[None].to(x.dtype),
                prefix_len, None)
    return x, prefix_len, rope_tables(pos[None, :], cfg.head_dim,
                                      cfg.rope_theta)


def fwd_hidden(params: dict, tokens: torch.Tensor, cfg: ModelConfig,
               ax: Axes = SINGLE, *, prefix_embeds=None, frames=None,
               fdims: Optional[dict] = None,
               ms: Optional[pm.MeshSizes] = None
               ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Token ids ``[B, S]`` (after ``prefix_embeds [B, P, d]`` for a VLM;
    attending to the encoded ``frames [B, T_enc, d]`` for whisper) ->
    ``(x, aux_loss, dropped)``: the final (normed) hidden states ``[B, P +
    S, d]``, and the MoE's auxiliary loss and dropped-slot fraction summed
    over the layers (f32 zeros without MoE), with the training forms of
    attention and the scans. Under autograd with ``cfg.remat``, each block
    keeps only its input and recomputes the rest in the backward pass.

    Under a mesh (``ax``, with ``params`` this rank's block and ``ms`` the
    mesh's sizes) each layer's FSDP-sharded weights are gathered over the
    data axis inside its block, the embedding's on its dim 1 before the
    lookup, and the blocks run TP over the model axis."""
    ms = ms or pm.MeshSizes()
    if fdims is None and ax.data is not None:
        fdims = pm.fsdp_dims(cfg, ms)
    dev = params["embed"].device
    tokens = torch.as_tensor(tokens).to(dev)
    emb = _gathered(ax, params, "embed", fdims)
    x, prefix_len, rope = positions_in(embed(tokens, emb, ax), cfg,
                                       prefix_embeds=prefix_embeds)
    enc_out = None
    if cfg.enc_dec:
        if frames is None:
            raise ValueError("whisper needs stub frame embeddings (frames)")
        enc_out = encode_frames(torch.as_tensor(frames).to(dev), params, cfg,
                                attend=blockwise_attention, ax=ax,
                                fdims=fdims)
    aux = torch.zeros((), dtype=_F32, device=dev)
    dropped = torch.zeros((), dtype=_F32, device=dev)
    remat = cfg.remat and torch.is_grad_enabled()
    for layer in layers(params, cfg):
        fd = fdims and (fdims["blocks"] if layer.rep is not None
                        else fdims["tail"])[layer.pos]
        args = (layer.kind, x, layer.p, cfg, rope, prefix_len, enc_out, ax,
                fd)
        x, a, dr = (checkpoint(_remat_block, *args, use_reentrant=False)
                    if remat else _remat_block(*args))
        if a is not None:
            aux, dropped = aux + a, dropped + dr
    return rms_norm(x, params["final_norm"], cfg.norm_eps), aux, dropped


def _gathered(ax: Axes, params: dict, key: str, fdims: Optional[dict]):
    """An embedding table with its FSDP-sharded dim gathered over the
    data axis."""
    return ax.fsdp_gather(params[key], fdims and fdims[key])


def fwd_train(params: dict, batch: dict, cfg: ModelConfig,
              ax: Axes = SINGLE, *, ms: Optional[pm.MeshSizes] = None,
              aux_weight: float = 0.01) -> tuple[torch.Tensor, Metrics]:
    """Next-token loss of ``batch`` and its metrics, as the reference's
    ``fwd_train``: ``tokens`` and ``labels`` ``[B, S]``, and whisper's stub
    ``frames [B, T_enc, d]`` or a VLM's ``prefix_embeds [B, P, d]``, whose
    positions are dropped before the loss. The unembedding is
    ``unembed``, or ``embed`` when tied; the loss adds ``aux_weight`` times
    the MoE's auxiliary loss (0 for the other models).

    Under a mesh the batch is this rank's rows, the unembedding is
    gathered over the data axis on its dim 1 and sharded over the
    vocabulary on the model axis, and the loss is the mean over the data
    axis (the pod axis is the train step's to reduce)."""
    ms = ms or pm.MeshSizes()
    fdims = pm.fsdp_dims(cfg, ms) if ax.data is not None else None
    prefix = batch.get("prefix_embeds")
    x, aux, dropped = fwd_hidden(params, batch["tokens"], cfg, ax,
                                 prefix_embeds=prefix,
                                 frames=batch.get("frames"), fdims=fdims,
                                 ms=ms)
    if cfg.vlm_prefix:
        x = x[:, prefix.shape[1]:]
    key = ("embed" if cfg.tie_embeddings or "unembed" not in params
           else "unembed")
    labels = torch.as_tensor(batch["labels"]).to(x.device)
    loss = unembed_loss(x, _gathered(ax, params, key, fdims), labels,
                        ax) + aux_weight * aux
    loss = ax.pmean(loss, ax.data)
    return loss, Metrics(loss=loss, aux_loss=aux, dropped=dropped)
