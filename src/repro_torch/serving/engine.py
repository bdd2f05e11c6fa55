"""Serving engine: prefill + paged two-tier decode on one card.

The decode step is the paper's fig. 2 "client thread": it serves the
batch against the tier-1 cache and forwards page misses to tier 2 in line;
:func:`repro_torch.serving.kvpool.promote_pages` is the "IO thread", run
between steps; the OL learner adjusts the eviction weights every epoch as
in §III-A.

On the card each step launches, per attention layer, the paged-attention
kernel twice (tier 1 over the resident pages, tier 2 over the pages that
are not resident) and merges the two partials with
:func:`~repro_torch.models.attention.combine_partials`; the prefill runs
the flash kernel once per layer and moves its pages with the page-copy
kernel, which also writes dirty evicted pages back once a step. The
reference reads both tiers in one pass (``read_pages`` +
``attention_partial``); the split sums in another order, so the two agree
to a tolerance, not bit for bit.

Models with RG-LRU or SSD blocks carry each recurrent layer's state
(:class:`DecodeState`): the prefill captures it, decode steps it. A model
without attention (mamba2) has no pools at all (``kv=None``). Where every
attention block is sliding-window, decode reads only the pages of the
window, and the paged kernel masks the tokens before it.

With ``kv_dtype="int8"`` the pools hold int8 codes and f32 scales a
(token, k/v) (:mod:`repro_torch.serving.kvpool`): each token's K and V
are quantized as they are written, the prefill's pages as they are
copied, and the paged-attention kernel dequantizes as it reads, to the
reference's ``bf16(f32(q) * sc)``. The prefill's own attention runs on
the K/V before they are quantized, as the reference's does.

Whisper (an encoder-decoder) runs its encoder once at prefill over the
request's stub frame embeddings (``extras["frames"]``) and keeps each
decoder layer's cross-attention keys and values ``[B, T_enc, KV, hd]``
in the decode state (``rec``'s ``ck`` / ``cv``); a decode step attends to
them in plain PyTorch, as the reference does outside any Pallas kernel,
and adds the sinusoid of the token's position (whisper has no RoPE).
Paligemma's stub patch embeddings (``extras["prefix_embeds"]``) go before
the prompt as a bidirectional prefix: the prefill's flash launches mask
prefix-LM, and the pools, positions and lengths span prefix and text.
An MoE model's FFN is :func:`repro_torch.models.moe.moe_swiglu` at
prefill and decode.

Page shards (``ServeConfig.page_axes``). Under a mesh of ranks
(:mod:`repro_torch.launch.spmd`) each sequence's pages are spread over the
ranks of the page axes by ``mapping`` (:mod:`repro_torch.core.mapping`);
each rank keeps tier 1 and tier 2 for the pages it owns and runs its own
learner, and the batch is split over the other batch axes. A decode step
gathers the full query over the model axis, runs the two tier launches
over the rank's owned pages only, merges its two tiers, and combines the
ranks' partials (:func:`~repro_torch.models.attention.combine_shards`);
then it keeps its own heads and sums ``wo``'s partial products over the
model axis. The weights are TP-sharded over the model axis and
FSDP-sharded over the data axis, gathered a layer at a time. The port's
default is ``page_axes=()`` (one card; every one-card caller relies on
it), where the reference's is ``("model",)``; with an
:class:`~repro_torch.distributed.axes.Axes` of no axes both mean one page
shard.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import obs
from repro_torch.configs.base import ModelConfig, SSMConfig
from repro_torch.core import online_learning as ol
from repro_torch.core.mapping import page_to_shard
from repro_torch.device import resolve_device, to_device
from repro_torch.distributed.axes import SINGLE, Axes
from repro_torch.kernels import paged_attention as pa
from repro_torch.models import params as pm
from repro_torch.models.attention import (Partial, attention_partial,
                                          combine_partials, combine_shards,
                                          merge_partials)
from repro_torch.models.layers import (apply_rope, dense, embed, rms_norm,
                                       rope_tables, sinusoidal_positions,
                                       tp_out, unembed_greedy)
from repro_torch.models.rglru import recurrent_block_step
from repro_torch.models.ssd import ssd_block_step
from repro_torch.models.transformer import (_local_kv_slice, apply_block,
                                            cross_kv, encode_frames, ffn,
                                            layers, positions_in)
from repro_torch.serving import kvpool as kvp
from repro_torch.serving.kvpool import KVSpec, PagedKV

__all__ = ["ServeConfig", "DecodeState", "make_kv_spec", "init_decode_state",
           "make_decode_step", "make_prefill_step", "page_shard_index",
           "page_shards", "check_supported"]

_PAGE_AXES = ("pod", "data", "model")


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    max_seq: int
    batch_local: int
    # Mesh axes that shard the pages; () = one page shard (the reference's
    # default is ("model",); the port keeps () for its one-card callers).
    page_axes: tuple[str, ...] = ()
    mapping: str = "block_cyclic"
    hbm_fraction: float = 0.5   # tier-1 capacity as fraction of owned pages
    n_promote: int = 2
    kv_dtype: str = "auto"      # "auto" (= param dtype) or "int8"


class DecodeState(NamedTuple):
    """Decode state: the paged pools (None for attention-free models) and
    the recurrent blocks' states, in the reference's layout: ``rec`` one
    dict per pattern position with each leaf stacked ``[reps, ...]``
    (``{}`` for attention), ``rec_tail`` one dict per tail layer. The
    decode step updates the states in place."""
    kv: Optional[PagedKV]
    rec: list
    rec_tail: list


def check_supported(cfg: ModelConfig, sc: ServeConfig) -> None:
    """Raise ``ValueError`` for page axes that are not mesh axes. (Every
    configuration serves, on one card or sharded; sharded training is what
    waits, :func:`repro_torch.launch.spmd.build_train_step`.)"""
    bad = [a for a in sc.page_axes if a not in _PAGE_AXES]
    if bad:
        raise ValueError(f"page_axes {bad} are not among {_PAGE_AXES}")


def page_shard_index(ax: Axes, page_axes: tuple[str, ...]) -> int:
    """This rank's flat index within the page-shard group (``page_axes``
    in the given order, each resolved through ``ax``; 0 without a mesh)."""
    me = 0
    for name in page_axes:
        actual = getattr(ax, name)
        me = me * ax.size(actual) + ax.index(actual)
    return me


def page_shards(ax: Axes, page_axes: tuple[str, ...]) -> int:
    """The page-shard group's size: the product of the page axes'."""
    n = 1
    for name in page_axes:
        n *= ax.size(getattr(ax, name))
    return n


def _page_names(ax: Axes, page_axes: tuple[str, ...]) -> tuple:
    """The mesh axes the decode step combines its partials over."""
    return tuple(getattr(ax, n) for n in _PAGE_AXES
                 if n in page_axes and getattr(ax, n) is not None)


def _needs_kv(cfg: ModelConfig) -> bool:
    return any(k.startswith("attn") for k in cfg.layer_kinds())


def make_kv_spec(cfg: ModelConfig, sc: ServeConfig, n_shards: int = 1
                 ) -> KVSpec:
    """Static pool geometry for an (arch, serve shape) cell on one page
    shard of ``n_shards``: tier 1 holds ``hbm_fraction`` of ``owned =
    ceil(pages / n_shards) + 1`` slots, as the reference sizes it. Tier 2
    holds ``owned + 1`` slots as the reference's does, or one more than
    the most pages a shard owns under ``mapping`` where that is more: the
    reference's count can fall short of an uneven mapping's load, and
    its scatters then drop pages without a word (ROADMAP faults item
    (m)). Models whose attention is all sliding-window (alone or beside
    recurrent blocks) read only the pages of the window: ``read_pages``
    = ceil(window / page) + 1, as the reference sets it."""
    attn_pp = kvp.n_attn_layers(cfg)
    reps, tail = pm.model_layout(cfg)
    n_attn = reps * len(attn_pp) + sum(1 for k in tail
                                       if k.startswith("attn"))
    n_pages = -(-sc.max_seq // cfg.page_size)
    total = sc.batch_local * n_pages
    owned = -(-total // n_shards) + 1
    load = np.bincount(page_to_shard(np.arange(total), n_shards, total,
                                     sc.mapping), minlength=n_shards)
    read_pages = window = 0
    if all(k in ("attn_swa", "attn_local", "rglru", "ssd")
           for k in cfg.block_pattern) and attn_pp:
        read_pages = -(-cfg.window // cfg.page_size) + 1
        window = cfg.window
    return KVSpec(
        b_local=sc.batch_local, n_pages=n_pages, page_size=cfg.page_size,
        n_kv=cfg.n_kv_heads, head_dim=cfg.head_dim,
        layers_per_slot=max(n_attn, 1),
        hbm_slots=max(2, int(owned * sc.hbm_fraction)),
        t2_slots=max(owned, int(load.max())) + 1,
        n_shards=n_shards, mapping=sc.mapping,
        read_pages=read_pages, window=window,
        dtype=cfg.param_dtype if sc.kv_dtype == "auto" else sc.kv_dtype)


def _rec_state_one(kind: str, cfg: ModelConfig, B: int, device) -> dict:
    """A zero decode state of one recurrent layer; of an attention layer
    of an encoder-decoder its cross-attention keys and values, else {}."""
    dt = getattr(torch, cfg.param_dtype)

    def z(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=device)
    if kind == "rglru":
        w = cfg.d_model
        return {"h": z((B, w), torch.float32), "conv": z((B, 3, w), dt)}
    if kind == "ssd":
        s = cfg.ssm or SSMConfig()
        di = s.expand * cfg.d_model
        return {"h": z((B, di // s.head_dim, s.state_dim, s.head_dim),
                       torch.float32),
                "conv": z((B, s.conv_width - 1, di + 2 * s.state_dim), dt)}
    if kind.startswith("attn") and cfg.enc_dec:
        sh = (B, cfg.enc_seq, cfg.n_kv_heads, cfg.head_dim)
        return {"ck": z(sh, dt), "cv": z(sh, dt)}
    return {}


def init_decode_state(cfg: ModelConfig, sc: ServeConfig, seed: int = 0, *,
                      device=None) -> DecodeState:
    """Empty pools and zero recurrent states on ``device`` (``None`` = the
    card), on one card (a sharded prefill builds its own state)."""
    check_supported(cfg, sc)
    device = resolve_device(device)
    reps, tail = pm.model_layout(cfg)
    B = sc.batch_local
    kv = (kvp.init_paged_kv(make_kv_spec(cfg, sc), seed, device=device)
          if _needs_kv(cfg) else None)
    rec = [{k: v.expand((reps,) + v.shape).clone()
            for k, v in _rec_state_one(kind, cfg, B, device).items()}
           for kind in cfg.block_pattern]
    rec_tail = [_rec_state_one(kind, cfg, B, device) for kind in tail]
    return DecodeState(kv=kv, rec=rec, rec_tail=rec_tail)


def _layer_state(state: DecodeState, layer) -> dict:
    """The decode state of one recurrent layer (views into ``state``)."""
    if layer.rep is None:
        return state.rec_tail[layer.pos]
    return {k: v[layer.rep] for k, v in state.rec[layer.pos].items()}


def _unembedding_key(params: dict, cfg: ModelConfig) -> str:
    tied = cfg.tie_embeddings or "unembed" not in params
    return "embed" if tied else "unembed"


def _gathered(params: dict, key: str, ax: Axes, fdims) -> torch.Tensor:
    """A top-level leaf, its FSDP dim gathered over the data axis."""
    w = params[key]
    return w if fdims is None else ax.fsdp_gather(w, fdims[key])


def _heads_out(o, w, cfg: ModelConfig, ax: Axes):
    """The output projection of ``o [B, H_local, hd]`` (f32), cast to the
    weights' dtype first: a TP partial sum where the heads are split."""
    o = o.to(w.dtype).reshape(o.shape[0], -1)
    if ax.tp_degree(cfg.n_heads) > 1:
        return tp_out(o, w, ax)
    return dense(o, w)


def _decode_attention(x, p, cfg: ModelConfig, pools, index, tables, li,
                      rope, window: int, ax: Axes = SINGLE, names=()):
    """One attention block at decode time over both tiers of this rank's
    pages, combined over the page axes ``names``."""
    B, _ = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    tp_h = ax.tp_degree(H)
    h = rms_norm(x, p["norm"], cfg.norm_eps)
    q = dense(h, p["wq"]).reshape(B, H // tp_h, hd)
    k_new = dense(h, p["wk"]).reshape(B, KV, hd)
    v_new = dense(h, p["wv"]).reshape(B, KV, hd)
    if rope is not None:  # None: whisper's absolute positions
        q = apply_rope(q[:, None], rope)[:, 0]
        k_new = apply_rope(k_new[:, None], rope)[:, 0]
    if tp_h > 1:  # every page shard attends with every query head
        q = ax.all_gather(q.reshape(B, -1), ax.model, axis=1).reshape(
            B, H, hd)
    scales = pools[2:] or (None, None)
    kvp.write_token_kv(pools[0], (k_new, v_new), index, li, scales[0])
    slot1, slot2, live = tables
    part1, part2 = (
        Partial(*pa.paged_attention(
            q, pool[:, li], slot, live, window,
            scale=None if sc is None else sc[:, li]))
        for pool, sc, slot in zip(pools[:2], scales, (slot1, slot2)))
    if names:
        o = combine_shards(merge_partials([part1, part2]), ax, names)
    else:
        o = combine_partials([part1, part2])       # [B, H, hd] f32
    if tp_h > 1:  # this rank's heads
        h_local = H // tp_h
        start = ax.index(ax.model) * h_local
        o = o[:, start:start + h_local]
    return _heads_out(o, p["wo"], cfg, ax)


def _decode_cross_attention(x, p, cfg: ModelConfig, ck, cv,
                            ax: Axes = SINGLE):
    """Whisper's cross-attention at decode time over the layer's stored
    keys and values ``[B, T_enc, KV, hd]``, in plain PyTorch (the
    reference's ``attention_partial``, outside any Pallas kernel), with
    this rank's query heads over the KV heads their groups need."""
    B, _ = x.shape
    h = rms_norm(x, p["xnorm"], cfg.norm_eps)
    q = dense(h, p["xwq"]).reshape(B, -1, cfg.head_dim)
    ck, cv = _local_kv_slice(ck, cv, cfg, ax)
    valid = torch.ones(ck.shape[:2], dtype=torch.bool, device=ck.device)
    part = attention_partial(q, ck, cv, valid)
    o = part.acc / torch.clamp(part.l, min=1e-30)[..., None]
    return _heads_out(o.reshape(B, q.shape[1], -1), p["xwo"], cfg, ax)


def _decode_tables(kv: PagedKV, spec: KVSpec, dev) -> tuple:
    """The two tier launches' page tables and live counts, on ``dev``:
    tier 1 reads the resident pages, tier 2 the owned pages that are not
    resident (an unowned page is -1 in both), both only inside the read
    window ``[lo, lo + read_pages)`` (every page without one) and both
    counting the token just written."""
    slot1, nonres = kv.page_slot, kv.page_slot < 0
    if spec.read_pages > 0:
        lo = kvp.read_window_start(kv.lengths, spec)[:, None]
        p = torch.arange(spec.n_pages)[None, :]
        in_win = (p >= lo) & (p < lo + spec.read_pages)
        slot1 = torch.where(in_win, slot1, -1)
        nonres &= in_win
    slot2 = torch.where(nonres, kv.t2_slot, -1)
    return tuple(to_device(t, dev) for t in (slot1, slot2, kv.lengths + 1))


def make_decode_step(cfg: ModelConfig, sc: ServeConfig, ax: Axes = SINGLE,
                     ms: pm.MeshSizes = pm.MeshSizes()):
    """The decode step ``(params, DecodeState, tokens [B]) -> (DecodeState,
    (next_tokens [B] int32, logprobs [B] f32))``, on the parameters'
    device; under a mesh (``ax``, ``ms``) this rank's step over its
    parameter shard, batch shard and page shard. The pools and the
    recurrent states are updated in place."""
    check_supported(cfg, sc)
    spec = make_kv_spec(cfg, sc, page_shards(ax, sc.page_axes))
    me = page_shard_index(ax, sc.page_axes)
    names = _page_names(ax, sc.page_axes)
    fdims = pm.fsdp_dims(cfg, ms) if ax.data is not None else None
    ssm = cfg.ssm or SSMConfig()
    cfg_ol = ol.OLConfig()
    # The learner's beta ** losses table, as wide as an epoch's most
    # mispredictions: every expert can mispredict once per missed page.
    pw = ol.pow_table(cfg_ol.beta,
                      cfg_ol.epoch_width * spec.total_pages)

    def step(params, state: DecodeState, tokens):
        with obs.span("engine.decode_step"):
            return _step(params, state, tokens)

    def _step(params, state: DecodeState, tokens):
        dev = params["embed"].device
        kv = state.kv
        if kv is not None:
            with obs.span("kv.alloc"):
                kv, plan = kvp.alloc_step(kv, spec, cfg_ol, pw, me)
            pools = kvp.pools_of(kv, spec)
            kvp.write_back_evicted(pools, plan)
            index = kvp.token_index(plan, kv.lengths, spec, dev)
            tables = _decode_tables(kv, spec, dev)
            pos = to_device(kv.lengths, dev)
            rope = (None if cfg.family == "audio" else
                    rope_tables(pos[:, None], cfg.head_dim, cfg.rope_theta))
        x = embed(to_device(torch.as_tensor(tokens), dev),
                  _gathered(params, "embed", ax, fdims), ax)
        if cfg.family == "audio":
            x = x + sinusoidal_positions(pos, cfg.d_model).to(x.dtype)
        with obs.span("model.layers"):
            for layer in layers(params, cfg, ax, fdims):
                p = layer.p
                if layer.kind.startswith("attn"):
                    x = x + _decode_attention(x, p, cfg, pools, index, tables,
                                              layer.li, rope, spec.window, ax,
                                              names)
                    if cfg.enc_dec:
                        st = _layer_state(state, layer)
                        x = x + _decode_cross_attention(x, p, cfg, st["ck"],
                                                        st["cv"], ax)
                    x = x + ffn(x, p, cfg, ax)
                    continue
                st = _layer_state(state, layer)
                h = rms_norm(x, p["norm"], cfg.norm_eps)
                if layer.kind == "rglru":
                    out, new = recurrent_block_step(h, st, p, ax)
                    x = x + out
                    x = x + ffn(x, p, cfg, ax)
                else:
                    out, new = ssd_block_step(h, st, p, ssm, ax)
                    x = x + out
                for k, v in new.items():
                    st[k].copy_(v)
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        ue = _gathered(params, _unembedding_key(params, cfg), ax, fdims)
        tok, logprob = unembed_greedy(x, ue, ax)
        if kv is not None:
            kv = kv._replace(lengths=kv.lengths + 1, t=kv.t + 1)
        return state._replace(kv=kv), (tok, logprob)

    return step


def make_prefill_step(cfg: ModelConfig, sc: ServeConfig, ax: Axes = SINGLE,
                      ms: pm.MeshSizes = pm.MeshSizes()):
    """The prefill ``(params, tokens [B, S], extras=None) -> (DecodeState,
    (first_token, logprob))``: a full forward over the prompt that fills
    both pools and sets the tier-1 residency (the newest pages resident),
    and captures each recurrent layer's decode state. ``extras`` holds
    whisper's stub frame embeddings (``"frames" [B, T_enc, d]``: the
    encoder runs once, and each decoder layer's cross-attention keys and
    values are kept) or a VLM's patch embeddings (``"prefix_embeds" [B,
    P, d]``: a bidirectional prefix before the prompt, in the pools).
    Under a mesh (``ax``, ``ms``) this is the rank's prefill of its batch
    shard with its parameter shard, writing the pages it owns."""
    check_supported(cfg, sc)
    spec = make_kv_spec(cfg, sc, page_shards(ax, sc.page_axes))
    me = page_shard_index(ax, sc.page_axes)
    fdims = pm.fsdp_dims(cfg, ms) if ax.data is not None else None
    reps, tail = pm.model_layout(cfg)
    needs_kv = _needs_kv(cfg)

    def step(params, tokens, extras=None):
        with obs.span("engine.prefill"):
            return _step(params, tokens, extras)

    def _step(params, tokens, extras=None):
        extras = extras or {}
        dev = params["embed"].device
        tokens = torch.as_tensor(tokens).to(dev)
        prefix = extras.get("prefix_embeds") if cfg.vlm_prefix else None
        x, prefix_len, rope = positions_in(
            embed(tokens, _gathered(params, "embed", ax, fdims), ax), cfg,
            prefix_embeds=prefix)
        B, S = x.shape[:2]
        enc_out = None
        if cfg.enc_dec:
            enc_out = encode_frames(torch.as_tensor(extras["frames"]).to(dev),
                                    params, cfg, ax=ax, fdims=fdims)
        kv = index = None
        pad_s = (-S) % spec.page_size
        if needs_kv:
            kv = kvp.init_paged_kv(spec, device=dev, me=me)
            kv = kvp.prefill_residency(kv, spec,
                                       torch.full((B,), S, dtype=torch.int32))
            # Every layer's page-copy indices, on the card once a prefill.
            index = kvp.prefill_index(kv, (S + pad_s) // spec.page_size, dev)
        states = [[None] * reps for _ in cfg.block_pattern]
        rec_tail = []
        for layer in layers(params, cfg, ax, fdims):
            x, ex = apply_block(layer.kind, x, layer.p, cfg, rope,
                                capture=True, prefix_len=prefix_len,
                                enc_out=enc_out, ax=ax)
            st = {}
            if layer.kind.startswith("attn"):
                k, v = ex
                if pad_s:
                    k = F.pad(k, (0, 0, 0, 0, 0, pad_s))
                    v = F.pad(v, (0, 0, 0, 0, 0, pad_s))
                kvp.prefill_write(kvp.pools_of(kv, spec), kv, spec,
                                  layer.li, k, v, index)
                if enc_out is not None:
                    st = dict(zip(("ck", "cv"),
                                  cross_kv(enc_out, layer.p, cfg)))
            else:
                st = ex
            if layer.rep is None:
                rec_tail.append(st)
            else:
                states[layer.pos][layer.rep] = st
        rec = [{k: torch.stack([s[k] for s in reps_st])
                for k in reps_st[0]} if reps_st else {}
               for reps_st in states]
        x = rms_norm(x[:, -1], params["final_norm"], cfg.norm_eps)
        ue = _gathered(params, _unembedding_key(params, cfg), ax, fdims)
        tok, logprob = unembed_greedy(x, ue, ax)
        return DecodeState(kv=kv, rec=rec, rec_tail=rec_tail), (tok, logprob)

    return step
