"""Declarative parameter definitions: shapes and init, for one card.

Every leaf is described by a :class:`ParamDef` (its per-layer shape and
how it is initialized). Stacked-layer leaves get a leading layer dim. The
parameter tree has the reference's structure: ``embed``, ``final_norm``,
``blocks`` (one dict per pattern position, each leaf stacked
``[reps, ...]``), ``tail`` (unstacked), unless tied ``unembed``, and for
an encoder-decoder (whisper) ``enc_blocks`` (one dict, each leaf stacked
``[n_enc_layers, ...]``) and ``enc_final_norm``. An attention block of
whisper's decoder also holds its cross-attention (``xwq xwk xwv xwo
xnorm``); whisper's FFN is a gelu MLP with biases (``w1 b1 w2 b2``), an
MoE model's an expert bank behind a router (``w_router`` ``[d, E]``,
``w_gate`` / ``w_up`` ``[E, d, f]``, ``w_down`` ``[E, f, d]``).

The reference's mesh and FSDP machinery (``MeshSizes``, ``fsdp_dims``,
partition specs) has no counterpart here: the port serves on one card.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ModelConfig, SSMConfig
from repro_torch.device import resolve_device

__all__ = ["ParamDef", "pad_vocab", "block_defs", "model_layout",
           "build_defs", "init_params"]


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: tuple[int, ...]  # per-layer (unstacked) shape
    init: str = "normal"    # normal | zeros | ones | lambda
    scale: float = 0.02


def pad_vocab(v: int, multiple: int = 256) -> int:
    return -(-v // multiple) * multiple


def _attn_defs(cfg: ModelConfig, cross: bool = False) -> dict:
    d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    pre = "x" if cross else ""
    return {
        f"{pre}wq": ParamDef((d, H * hd), scale=d ** -0.5),
        f"{pre}wk": ParamDef((d, KV * hd), scale=d ** -0.5),
        f"{pre}wv": ParamDef((d, KV * hd), scale=d ** -0.5),
        f"{pre}wo": ParamDef((H * hd, d), scale=(H * hd) ** -0.5),
        f"{pre}norm": ParamDef((d,), init="zeros"),
    }


def _mlp_defs(cfg: ModelConfig) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    if cfg.family == "audio":  # whisper: a gelu MLP with biases
        return {
            "w1": ParamDef((d, f), scale=d ** -0.5),
            "b1": ParamDef((f,), init="zeros"),
            "w2": ParamDef((f, d), scale=f ** -0.5),
            "b2": ParamDef((d,), init="zeros"),
            "norm2": ParamDef((d,), init="zeros"),
        }
    if cfg.moe is not None:
        E = cfg.moe.n_experts
        return {
            "w_router": ParamDef((d, E), scale=d ** -0.5),
            "w_gate": ParamDef((E, d, f), scale=d ** -0.5),
            "w_up": ParamDef((E, d, f), scale=d ** -0.5),
            "w_down": ParamDef((E, f, d), scale=f ** -0.5),
            "norm2": ParamDef((d,), init="zeros"),
        }
    return {
        "w_gate": ParamDef((d, f), scale=d ** -0.5),
        "w_up": ParamDef((d, f), scale=d ** -0.5),
        "w_down": ParamDef((f, d), scale=f ** -0.5),
        "norm2": ParamDef((d,), init="zeros"),
    }


def _rglru_defs(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    w = d  # lru width = d_model
    return {
        "w1": ParamDef((d, w), scale=d ** -0.5),
        "w2": ParamDef((d, w), scale=d ** -0.5),
        "w_out": ParamDef((w, d), scale=w ** -0.5),
        "conv": ParamDef((4, w), scale=0.1),
        "w_a": ParamDef((w,), scale=0.5),
        "b_a": ParamDef((w,), init="zeros"),
        "w_x": ParamDef((w,), scale=0.5),
        "b_x": ParamDef((w,), init="zeros"),
        "lam": ParamDef((w,), init="lambda"),
        "norm": ParamDef((d,), init="zeros"),
    }


def _ssd_defs(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    s = cfg.ssm or SSMConfig()
    di = s.expand * d
    H = di // s.head_dim
    N = s.state_dim
    return {
        "w_z": ParamDef((d, di), scale=d ** -0.5),
        "w_x": ParamDef((d, di), scale=d ** -0.5),
        "w_bc": ParamDef((d, 2 * N), scale=d ** -0.5),
        "w_dt": ParamDef((d, H), scale=d ** -0.5),
        "conv_x": ParamDef((s.conv_width, di), scale=0.1),
        "conv_b": ParamDef((s.conv_width, N), scale=0.1),
        "conv_c": ParamDef((s.conv_width, N), scale=0.1),
        "A_log": ParamDef((H,), init="ones"),
        "dt_bias": ParamDef((H,), init="zeros"),
        "D": ParamDef((H,), init="ones"),
        "norm_g": ParamDef((di,), init="zeros"),
        "w_out": ParamDef((di, d), scale=di ** -0.5),
        "norm": ParamDef((d,), init="zeros"),
    }


def block_defs(kind: str, cfg: ModelConfig, *, decoder: bool = False
               ) -> dict:
    """Parameter defs for one block of the given kind: attention (with
    the cross-attention of an encoder-decoder's ``decoder``) and RG-LRU
    blocks with their FFN, SSD blocks without one."""
    if kind.startswith("attn"):
        cross = _attn_defs(cfg, cross=True) if decoder and cfg.enc_dec else {}
        return {**_attn_defs(cfg), **cross, **_mlp_defs(cfg)}
    if kind == "rglru":
        return {**_rglru_defs(cfg), **_mlp_defs(cfg)}
    if kind == "ssd":
        return _ssd_defs(cfg)
    raise ValueError(kind)


def model_layout(cfg: ModelConfig) -> tuple[int, tuple[str, ...]]:
    """(n_superblock_repeats, tail_kinds)."""
    p = len(cfg.block_pattern)
    reps = cfg.n_layers // p
    tail = cfg.layer_kinds()[reps * p:]
    return reps, tail


def build_defs(cfg: ModelConfig) -> dict:
    """Full nested ParamDef tree (mirrors the params tree structure)."""
    _, tail = model_layout(cfg)
    vp = pad_vocab(cfg.vocab)
    tree: dict = {
        "embed": ParamDef((vp, cfg.d_model)),
        "final_norm": ParamDef((cfg.d_model,), init="zeros"),
        "blocks": [block_defs(k, cfg, decoder=True)
                   for k in cfg.block_pattern],
        "tail": [block_defs(k, cfg, decoder=True) for k in tail],
    }
    if not cfg.tie_embeddings:
        tree["unembed"] = ParamDef((vp, cfg.d_model))
    if cfg.enc_dec:
        tree["enc_blocks"] = [block_defs("attn_full", cfg)]
        tree["enc_final_norm"] = ParamDef((cfg.d_model,), init="zeros")
    return tree


def _draw(d: ParamDef, gen: torch.Generator, device) -> torch.Tensor:
    """One layer's f32 draw: normal x scale, or the RG-LRU's Lambda, with
    ``a = exp(-8 softplus(Lambda))`` uniform in [0.9, 0.999]."""
    if d.init == "lambda":
        u = torch.rand(d.shape, generator=gen, dtype=torch.float32,
                       device=device) * (0.999 - 0.9) + 0.9
        x = -torch.log(u) / 8.0
        return torch.log(torch.expm1(torch.clamp(x, min=1e-8)))
    return torch.randn(d.shape, generator=gen, dtype=torch.float32,
                       device=device) * d.scale


def _leaf_init(d: ParamDef, shape, dtype, gen: torch.Generator,
               device) -> torch.Tensor:
    if d.init == "zeros":
        return torch.zeros(shape, dtype=dtype, device=device)
    if d.init == "ones":
        return torch.ones(shape, dtype=dtype, device=device)
    out = torch.empty(shape, dtype=dtype, device=device)
    # One stacked layer at a time, so the f32 draw stays one layer large.
    rows = out.reshape((-1,) + d.shape) if len(shape) > len(d.shape) else (
        out[None])
    for row in rows:
        row.copy_(_draw(d, gen, device))
    return out


def init_params(cfg: ModelConfig, seed: int = 0, device=None) -> dict:
    """Random parameters: normal x scale per leaf (zeros for the norms,
    ones for the SSD's ``A_log`` and ``D``, the RG-LRU's ``Lambda`` as the
    reference draws it), in ``cfg.param_dtype``, drawn from a
    ``torch.Generator`` seeded with ``seed`` on ``device`` (``None`` = the
    card). The draws are not JAX's: the same seed gives other numbers than
    ``repro.models.params.init_params`` (carry the reference's parameters
    over with :func:`repro_torch.convert.params_from_numpy` where both must
    compute the same model)."""
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    dtype = getattr(torch, cfg.param_dtype)
    reps, _ = model_layout(cfg)
    defs = build_defs(cfg)

    def leaf(d: ParamDef, n_stack: int = 0):
        shape = ((n_stack,) if n_stack else ()) + d.shape
        return _leaf_init(d, shape, dtype, gen, device)

    stacks = {"blocks": reps, "enc_blocks": cfg.n_enc_layers}
    out = {k: leaf(d) for k, d in defs.items()
           if k not in ("blocks", "tail", "enc_blocks")}
    for name, n in stacks.items():
        if name in defs:
            out[name] = [{k: leaf(d, n) for k, d in blk.items()}
                         for blk in defs[name]]
    out["tail"] = [{k: leaf(d) for k, d in blk.items()}
                   for blk in defs["tail"]]
    return out
